"""The card's published peaks and the least time of the lidar march.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full 700 W power
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores.

The lidar's work, as counted for the port's kernel table: each marched
sample takes about 20 float32 operations (the sample's position, the screen
test, the road test) and each ray tests each obstacle's box once (4
compares) to cull it; each input is read once and each distance written
once. The least time is the larger of the bytes over the bandwidth and the
operations over the float32 peak. The samples a ray marches (up to and
including its first event) are counted by the reference's march
(reference/lidar.py) on the same operands.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
RAYS = 96


def lidar_bound_s(B: int, N: int, M: int, samples: int) -> tuple:
    """``(seconds, "bytes" | "operations")``: the least time of one lidar
    call of B envs, N scanning cars and M obstacles that marches
    ``samples`` samples in all, and what bounds it."""
    ops = samples * 20.0 + B * N * RAYS * M * 4.0
    nbytes = 3 * B * N * 4 + 3 * B * M * 4 + B * M + B * N * RAYS * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lidar_samples(operands, num_lanes: int, chunk: int = 256) -> int:
    """The samples the lidar marches in all on ``operands`` (sx, sy, sh, ox,
    oy, oh, om; see reference/lidar.py), counted by the reference's march in
    blocks of ``chunk`` envs on the operands' device. The ray directions of
    the count come from torch's sin and cos, which differ from glibc's by an
    ulp on some angles: that moves a ray's first event only where a sample
    lies within an ulp of a pixel's or a box's edge."""
    from .reference import libm
    from .reference.lidar import lidar_scan_ref

    total = 0
    with libm.using("torch"):
        for i in range(0, operands[0].shape[0], chunk):
            part = [t[i:i + chunk].contiguous() for t in operands]
            _, samples = lidar_scan_ref(*part, num_lanes, return_samples=True)
            total += int(samples.sum())
    return total
