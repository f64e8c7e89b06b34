"""The card's published peaks, the least time of the lidar march and a
model's share of the peak.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full 700 W power
limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores,
989.4 TFLOP/s dense on the tensor cores in bfloat16 and float16.

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


# dense peak of the products by the compute precision a configuration states
# (float32: with TF32 off, outside the tensor cores)
PEAK_FLOPS_PER_S = {"bfloat16": 989.4e12, "float16": 989.4e12, "float32": F32_OPS_PER_S}


def update_flops(forward_flops: float, rows: int, rollout_len: int, epochs: int) -> float:
    """The model FLOPs of one PPO train step's update: for each epoch a
    forward of ``forward_flops`` per sample and a backward (twice the
    forward) over the whole trajectory of ``rows`` (envs x agents) at each
    of ``rollout_len`` steps."""
    return forward_flops * rows * 3 * epochs * rollout_len


def train_step_flops(forward_flops: float, rows: int, rollout_len: int, epochs: int) -> float:
    """The model FLOPs of one PPO train step: the rollout's forward for each
    row at every rollout step and once more for the last value, and the
    update (``update_flops``)."""
    return forward_flops * rows * (rollout_len + 1) \
        + update_flops(forward_flops, rows, rollout_len, epochs)
