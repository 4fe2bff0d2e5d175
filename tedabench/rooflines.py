"""A kernel's share of its roofline, from the traced window.

The least time a launch needs is the larger of its bytes over the
chip's memory rate and its operations over the chip's float32 rate
(peaks.json, the published figures); the counts come from the shapes,
in `roofline/<kernel>.py`, and never from an implementation's
instructions.  The share is that least time over the kernel's mean
profiled device time per launch, in percent.
"""
from __future__ import annotations

__all__ = ["least_s", "share"]


def least_s(nbytes: float, ops: float, peaks: dict) -> float:
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["f32_ops_per_s"])


def share(ctx, kernel: str):
    tr, peaks = ctx["trace"], ctx["peaks"]
    if tr is None or not peaks:
        return None
    count = ctx["load"]("roofline", kernel)
    durs = [b - a for n, a, b, _ in tr.ops if count.KERNEL in n]
    if not durs:
        return None
    per_launch_s = sum(durs) / len(durs) / 1e9
    nbytes, ops = count.work(ctx["traffic"]["t"], ctx["config"]["channels"])
    return 100.0 * least_s(nbytes, ops, peaks) / per_launch_s
