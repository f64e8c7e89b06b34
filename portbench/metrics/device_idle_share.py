"""The share of the traced block's wall time in which no device operation
ran, in %. The profiler stretches the host's gaps, so this reads above the
unprofiled window's idle share. None without a trace."""


def read(r):
    p = r.profile
    if p is None or not p["device_ops"] or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
