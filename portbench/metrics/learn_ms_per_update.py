"""The learner's GAE and minibatch updates, in ms per train step: the mean
of the program's ``split["update_s"]`` over the calls timed after the
window. None without them."""


def read(r):
    spans = [s["update_s"] for s in getattr(r, "splits", ()) if "update_s" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
