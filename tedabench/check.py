"""How `correct` is decided: the window's outputs against the reference.

Every stream of a cell restarts at the same call of the ring, so every
stream of the window sees the same samples, and the reference works one
stream out once.  Three comparisons, all after the window has closed:

1. The last call of the window, every channel: the reference runs the
   call's chunk from the program's own state before the call, and its
   ecc and flags, the state it leaves and each channel's flag count are
   held against the program's outputs, the program's state after the
   call and the summary the host read.
2. The sampled channels (drawn from the seed) from the start of a
   stream: the reference follows them from the zero state through one
   whole stream, so the state the program carried from call to call is
   checked too.  At the last call's place in its stream, its ecc, flags
   and state are held against the program's.
3. The summary the host read for every call of the window, at the
   sampled channels, against the reference's flag count at that call's
   place in its stream.

The numbers and their limits are the reference module's (`Gaps`), the
limits the configuration's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Capture", "decide"]

# bytes of (T, channels) float64 or int64 arrays one step block may hold
BLOCK_BYTES = 24 << 30


class Capture:
    """What a window leaves for the comparison.

    ring      (R, T, C) chunks handed to the program, on the device
    vlens     (R, C) int32 valid lengths, or None
    cps       calls per stream: the program is reset before call i when
              i % cps == 0
    sampled   (S,) sampled channels
    summaries (n, S) the host's flag count of every call at `sampled`
    last      the window's last call: {"index", "pre": (k, mean, var),
              "ecc", "outlier", "post": (k, mean, var), "summary": (C,)}
    """

    def __init__(self, ring, vlens, cps, sampled, summaries, last):
        self.ring, self.vlens, self.cps = ring, vlens, int(cps)
        self.sampled = np.asarray(sampled)
        self.summaries = np.asarray(summaries)
        self.last = last


def decide(ref, cap: Capture, m: float, limits: dict, fmt=None):
    """The readings [(name, value, limit), ...] and whether every value
    lies within its limit."""
    kw = {} if fmt is None else {"fmt": tuple(fmt)}
    gaps = ref.Gaps(limits)
    last = cap.last
    n_ring, t_len, c = cap.ring.shape
    slot = last["index"] % n_ring
    x = cap.ring[slot]
    vl = None if cap.vlens is None else cap.vlens[slot]
    pre, post = last["pre"], last["post"]
    summary = torch.as_tensor(np.asarray(last["summary"]))

    # 1. the last call, every channel, from the program's state
    block = max(1, min(c, BLOCK_BYTES // max(1, t_len * 8 * 16)))
    for c0 in range(0, c, block):
        cs = slice(c0, min(c, c0 + block))
        st0 = ref.from_program(*(v[cs] for v in pre))
        out, st1 = ref.scan(x[:, cs], st0, m,
                            None if vl is None else vl[cs], **kw)
        gaps.outputs(last["ecc"][:, cs], last["outlier"][:, cs], out)
        gaps.state(*(v[cs] for v in post), st1)
        gaps.counts(summary[cs], out["flag"].sum(0).cpu(),
                    ref.slack(out, gaps.band).cpu())
        del out, st0, st1

    # 2. the sampled channels through one whole stream
    idx = torch.as_tensor(cap.sampled, dtype=torch.long, device=x.device)
    place = last["index"] % cap.cps
    st = ref.state0(len(idx), x.device)
    want, allow = [], []
    for j in range(cap.cps):
        vs = None if cap.vlens is None else cap.vlens[j % n_ring][idx]
        out, st = ref.scan(cap.ring[j % n_ring][:, idx], st, m, vs, **kw)
        want.append(out["flag"].sum(0).cpu())
        allow.append(ref.slack(out, gaps.band).cpu())
        if j == place:
            gaps.outputs(last["ecc"][:, idx], last["outlier"][:, idx], out)
            gaps.state(*(v[idx] for v in post), st)

    # 3. every call's summary at the sampled channels
    n = len(cap.summaries)
    if n:
        at = torch.as_tensor(np.arange(n) % cap.cps)
        gaps.counts(torch.as_tensor(cap.summaries), torch.stack(want)[at],
                    torch.stack(allow)[at])
    readings = gaps.readings()
    ok = all(v <= lim for _, v, lim in readings)
    return ok, readings
