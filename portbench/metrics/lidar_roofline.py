"""The lidar's share of its roofline, in %: its least time on a window
step's poses, with the obstacles that step scanned (the egos and the NPC
slots of the width the program stepped at; run.py), the work counted by
the reference's march (roofline.py), over the device time of one call of
the program's ``ops.lidar_cuda.lidar_scan`` on the same operands
(trace.py). None where nothing was timed."""


def read(r):
    if r.lidar is None or r.lidar["device_ms"] <= 0:
        return None
    return 100.0 * r.lidar["bound_ms"] / r.lidar["device_ms"]
