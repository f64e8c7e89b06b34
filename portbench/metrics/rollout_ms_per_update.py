"""The learner's rollout, in ms per train step: the mean of the program's
``split["rollout_s"]`` (PPOLearner.train_step's, which waits for the device
before and after) over the calls timed after the window. None without
them."""


def read(r):
    spans = [s["rollout_s"] for s in getattr(r, "splits", ()) if "rollout_s" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
