"""Device ms per step in the traced block: the summed durations of its
device operations over its steps. None without a trace."""


def read(r):
    if r.profile is None or not r.profile["device_ops"]:
        return None
    return 1e3 * r.profile["device_s"] / r.profile["steps"]
