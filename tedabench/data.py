"""DAMADICS-style actuator fleet streams, made on the device from a seed.

A PyTorch rewrite of the port's host generator
(`src/repro_torch/data/damadics.py`, which builds one 2-channel
actuator stream in numpy): the same nominal flow and valve-position
signals (a slow process trend, a faster ripple, measurement noise) and
the same four artificial faults of the DAMADICS benchmark (f16 supply
pressure drop, f17 pressure change, f18 partly opened bypass valve,
f19 flow sensor stuck with a noise burst), drawn for a whole fleet at
once.  Every number of the signals and the faults comes from the
configuration file (`signals`, `faults`), so a deployment with other
levels is a new file.

Channel 2a carries actuator a's flow, channel 2a + 1 its valve
position.  Each actuator gets its own trend and ripple phases and one
fault window of a seeded kind, start and length inside the ring's
period.  The ring is `ring` consecutive (T, C) chunks of one stream
period; a channel's stream is that period repeated.  With the period
one whole stream, as the benchmark's traffic has it, each actuator
has one fault a stream, as the source's 60,000-sample streams (Table
2) have one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["torch_seed", "make_ring", "to_words", "sample_channels",
           "ring_vlens", "FAULT_KINDS"]

FAULT_KINDS = ("f16", "f17", "f18", "f19")


def torch_seed(seed: int) -> int:
    """Any whole number as a seed that torch's generators accept."""
    return int(seed) % (1 << 63)


def _gen(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(int(seed) * 7919 + salt))
    return g


# rows made at a time: the same data for any chunk length
BLOCK_ROWS = 1024


def make_ring(signals: dict, faults: dict, channels: int, t_len: int,
              ring: int, seed: int, device, words=None) -> torch.Tensor:
    """The (ring, T, C) stream period for `channels` channels (two per
    actuator), made on `device` from `seed`: float32, or with `words`
    = (WL, FL) int32 Q words.  Made `BLOCK_ROWS` rows at a time, so
    that the temporaries stay small and every chunk length sees the
    same samples."""
    if channels % 2:
        raise ValueError(f"channels must be even (flow, valve per "
                         f"actuator), got {channels}")
    n_act, period = channels // 2, ring * t_len
    g = _gen(seed, 1, device)
    f32 = torch.float32
    phase = torch.rand((2, n_act), generator=g, device=device) * (2 * math.pi)
    fl, va = signals["flow"], signals["valve"]

    # one fault window per actuator and period: kind, length, start,
    # drawn apart from the signals, so that the nominal samples are the
    # same with faults or without
    kinds = [k for k in FAULT_KINDS if k in faults["kinds"]]
    if kinds:
        gf = _gen(seed, 4, device)
        lo, hi = faults["length"]
        hi = min(hi, period)
        kind = torch.randint(len(kinds), (n_act,), generator=gf,
                             device=device)
        length = torch.randint(lo, hi + 1, (n_act,), generator=gf,
                               device=device)
        start = (torch.rand(n_act, generator=gf, device=device)
                 * (period - length + 1).to(f32)).long().clamp_max(
                     period - 1)
        flow0 = torch.zeros(n_act, dtype=f32, device=device)

    out = torch.empty((period, channels), device=device,
                      dtype=f32 if words is None else torch.int32)
    for r0 in range(0, period, BLOCK_ROWS):
        r1 = min(period, r0 + BLOCK_ROWS)
        t = torch.arange(r0, r1, dtype=f32, device=device)[:, None]
        trend = 2 * math.pi * t / signals["trend_period"] + phase[0]
        ripple = 2 * math.pi * t / signals["ripple_period"] + phase[1]
        noise = torch.randn((2, r1 - r0, n_act), generator=g,
                            device=device)
        flow = (fl["level"] + fl["trend"] * torch.sin(trend)
                + fl["ripple"] * torch.sin(ripple) + fl["noise"] * noise[0])
        valve = (va["level"] + va["trend"] * torch.sin(trend + va["phase"])
                 + va["noise"] * noise[1])
        del trend, ripple, noise
        if kinds:
            flow, valve = _faults(faults, kinds, flow, valve, t, kind,
                                  length, start, flow0, r0, gf)
        block = torch.stack([flow, valve], dim=-1).reshape(r1 - r0,
                                                           channels)
        out[r0:r1] = block if words is None else to_words(block, *words)
    return out.reshape(ring, t_len, channels)


def _faults(faults, kinds, flow, valve, t, kind, length, start, flow0,
            r0, g):
    """The fault windows' rows r0.. of one block.  `flow0` keeps each
    actuator's flow at its window's start, where f19 sticks; the block
    that holds the start fills it in, before any fault moves it."""
    f32 = torch.float32
    here = (start >= r0) & (start < r0 + flow.shape[0])
    at = (start - r0).clamp(0, flow.shape[0] - 1)
    flow0.copy_(torch.where(here, flow.gather(0, at[None, :])[0], flow0))
    rel = t - start.to(f32)
    inside = (rel >= 0) & (rel < length.to(f32))
    burst = torch.randn(flow.shape, generator=g, device=flow.device)
    for i, name in enumerate(kinds):
        p = faults[name]
        on = inside & (kind == i)
        if name == "f16":  # ramped level drop on both signals
            ramp = (rel / (length // 8).clamp_min(1).to(f32)).clamp(0, 1)
            flow = torch.where(on, flow + p["flow"] * ramp, flow)
            valve = torch.where(on, valve + p["valve"] * ramp, valve)
        elif name == "f17":  # sustained offsets
            flow = torch.where(on, flow + p["flow"], flow)
            valve = torch.where(on, valve + p["valve"], valve)
        elif name == "f18":  # step on the flow
            flow = torch.where(on, flow + p["flow"], flow)
        else:  # f19: flow stuck at its value at the start, with a burst
            flow = torch.where(on, flow0 + p["burst"] * burst, flow)
    return flow, valve


def to_words(x: torch.Tensor, word_len: int, frac_len: int
             ) -> torch.Tensor:
    """Float samples as Q(word_len, frac_len) words: round to nearest
    (ties to even), saturate to the symmetric range, int32."""
    qmax = (1 << (word_len - 1)) - 1
    v = torch.round(x.to(torch.float64) * float(1 << frac_len))
    return v.clamp(-qmax, qmax).to(torch.int32)


def sample_channels(seed: int, channels: int, n: int) -> np.ndarray:
    """`n` distinct channels drawn from the seed, ascending."""
    rng = np.random.default_rng([torch_seed(seed), 2])
    n = min(int(n), channels)
    return np.sort(rng.choice(channels, size=n, replace=False))


def ring_vlens(spec, channels: int, t_len: int, ring: int, seed: int,
               device):
    """Per-channel valid lengths for each ring chunk, or None.

    `spec` is the traffic's `valid_lens`: None (every row valid) or
    {"low": a, "high": b}, fractions of T between which each channel's
    valid length is drawn uniformly, once per ring chunk."""
    if spec is None:
        return None
    g = _gen(seed, 3, device)
    lo = int(round(spec["low"] * t_len))
    hi = int(round(spec["high"] * t_len))
    return torch.randint(lo, hi + 1, (ring, channels), generator=g,
                         device=device, dtype=torch.int32)
