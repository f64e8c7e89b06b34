"""Device operations (kernels, copies, fills) per step in the traced block
(torch.profiler's CUDA records). None without a trace."""


def read(r):
    if r.profile is None or not r.profile["device_ops"]:
        return None
    return r.profile["device_ops"] / r.profile["steps"]
