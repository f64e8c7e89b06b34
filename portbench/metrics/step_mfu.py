"""The whole train step's share of the card's peak, in %: the model FLOPs of
the traced block's calls (roofline.train_step_flops: the rollout's forward,
the last value and the update) over the seconds in which the device ran an
operation in that block (the trace's busy time, trace.py) and the dense
peak of the configuration's compute precision. None without a trace or a
model."""


def read(r):
    flops = getattr(r, "profiled_flops", None)
    if not flops or r.profile is None or r.profile["busy_s"] <= 0:
        return None
    return 100.0 * flops / r.profile["busy_s"] / r.peak_flops
