"""Algorithm 1 (TEDA) in float64, the float configurations' reference.

Frozen copy.  The equations are those of the port's float64 oracle
`src/repro_torch/kernels/ref.py::teda_ref` (eqs (1)-(6) of da Silva et
al., arXiv:2003.03837, as the JAX package states them): for each
channel and sample k = 1, 2, ...

    mean_k = sum_k / k                      sum_k = sum_{k-1} + x_k
    d2_k   = (x_k - mean_k)^2               (0 at k = 1)
    var_k  = (k - 1)/k var_{k-1} + d2_k/k,  i.e. k var_k = S_k = S_{k-1} + d2_k
    ecc_k  = 1/k + d2_k / (k var_k)         (1/k where var_k = 0)
    flag_k = ecc_k/2 > (m^2 + 1)/(2k) and k >= 2

computed here from cumulative sums along time, in float64, with a
per-channel valid length (rows at or past it leave the state as it is
and never flag).  It is frozen in the benchmark so that the yardstick
stays fixed while the program changes: it imports nothing of the
program and nothing of the JAX package.

`control_scan` is the control of `correct`: the same recursion, row by
row as the program's kernel runs it, computed in bfloat16 (the nearest
precision below the configuration's float32).  It has to fail.

States are dicts of (C,) tensors {"k", "s", "S"} (float64): the count,
the running sum and k times the variance.
"""
from __future__ import annotations

import torch

__all__ = ["state0", "from_program", "scan", "slack", "Gaps",
           "control_scan", "control_state0", "control_to_program"]

F64 = torch.float64
# float32's unit in the last place, relative, at the top of a binade
F32_ULP = 2.0 ** -23


def state0(n: int, device) -> dict:
    z = torch.zeros(n, dtype=F64, device=device)
    return {"k": z, "s": z, "S": z}


def from_program(k, mean, var) -> dict:
    """The program's (k, mean, var) state as the reference's."""
    k, mean, var = (v.to(F64) for v in (k, mean, var))
    return {"k": k, "s": mean * k, "S": var * k}


def _valid(t_len, vlen, c, device):
    rows = torch.arange(t_len, device=device)[:, None]
    if vlen is None:
        return torch.ones((t_len, c), dtype=torch.bool, device=device)
    return rows < vlen.to(device)[None, :]


def scan(x, st: dict, m: float, vlen=None):
    """One (T, C) chunk from state `st`.  Returns ({"ecc", "flag",
    "margin", "valid", "resolved"}, state'): `margin` is |ecc/2 - thr|
    / thr, the sample's distance from its threshold relative to the
    threshold; `resolved` marks the valid samples whose standard
    deviation so far exceeds one float32 unit of their mean.  Below
    that float32 cannot resolve a deviation from the mean, and the ecc
    is not defined to any precision there: at k = 2 it is 3/2 for any
    deviation and 1/2 for none."""
    x = x.to(F64)
    t_len, c = x.shape
    valid = _valid(t_len, vlen, c, x.device)
    vf = valid.to(F64)
    k = st["k"][None, :] + torch.cumsum(vf, 0)
    s = st["s"][None, :] + torch.cumsum(torch.where(valid, x, 0.0), 0)
    mean = s / k.clamp_min(1.0)
    d2 = torch.where(valid & (k > 1.0), (x - mean) ** 2, 0.0)
    big_s = st["S"][None, :] + torch.cumsum(d2, 0)
    var = big_s / k.clamp_min(1.0)
    safe = var > 0.0
    kk = k.clamp_min(1.0)
    ecc = 1.0 / kk + torch.where(safe, d2 / (kk * torch.where(safe, var,
                                                               1.0)), 0.0)
    thr = (m * m + 1.0) / (2.0 * kk)
    flag = valid & (ecc / 2.0 > thr) & (k >= 2.0)
    margin = (ecc / 2.0 - thr).abs() / thr
    resolved = valid & (var > (F32_ULP * mean) ** 2)
    new = {"k": k[-1], "s": s[-1], "S": big_s[-1]} if t_len else dict(st)
    return {"ecc": ecc, "flag": flag, "margin": margin, "valid": valid,
            "resolved": resolved}, new


def slack(out: dict, band: float) -> torch.Tensor:
    """Per channel, the valid samples whose flag float32 may decide
    either way: those within `band` (relative) of their threshold."""
    return (out["valid"] & (out["margin"] <= band)).sum(0)


class Gaps:
    """The numbers compared for a float configuration, each beside its
    limit (the configuration's `limits`):

    ecc_rel_gap      widest |ecc - ecc_ref| / ecc_ref over the resolved
                     samples (`scan`); flags are held on every one
    state_rel_gap    widest relative gap of the carried mean and var
    k_off            channels whose carried count differs (exact)
    flag_margin      widest distance from its threshold, relative to the
                     threshold (the reference's `margin`), of a sample
                     whose flag differs from the reference's; inf for a
                     flag past a valid length, 0 where none differ
    summary_off_band per (call, channel), the amount by which the
                     host's flag count differs from the reference's
                     beyond the samples within flag_margin's limit of
                     their threshold, summed
    """

    def __init__(self, limits: dict):
        self.limits = limits
        self.band = float(limits["flag_margin"])
        self.v = {"ecc_rel_gap": 0.0, "state_rel_gap": 0.0, "k_off": 0,
                  "flag_margin": 0.0, "summary_off_band": 0}

    def _max(self, name, value):
        value = float(value)
        if value != value:  # NaN
            value = float("inf")
        self.v[name] = max(self.v[name], value)

    def outputs(self, ecc, flag, out: dict):
        v = out["valid"]
        flag = flag.to(torch.bool)
        # no flag past a channel's valid length
        if bool((flag & ~v).any()):
            self._max("flag_margin", float("inf"))
        if not bool(v.any()):
            return
        r = out["resolved"]
        if bool(r.any()):
            ref = out["ecc"]
            gap = ((ecc.to(F64) - ref).abs() / ref)[r]
            self._max("ecc_rel_gap",
                      gap.nan_to_num(nan=float("inf")).max())
        differ = (flag != out["flag"]) & v
        if bool(differ.any()):
            self._max("flag_margin", out["margin"][differ].max())

    def state(self, k, mean, var, st: dict):
        kr = st["k"]
        self.v["k_off"] += int((k.to(F64) != kr).sum())
        live = kr > 0
        if not bool(live.any()):
            return
        mr = st["s"] / kr.clamp_min(1.0)
        vr = st["S"] / kr.clamp_min(1.0)
        gm = ((mean.to(F64) - mr).abs() / mr.abs().clamp_min(1e-300))[live]
        both = live & (vr > 0)
        gv = ((var.to(F64) - vr).abs() / vr.clamp_min(1e-300))[both]
        for g in (gm, gv):
            if g.numel():
                self._max("state_rel_gap",
                          g.nan_to_num(nan=float("inf")).max())

    def counts(self, got, want, allowed):
        extra = ((got.to(torch.int64) - want.to(torch.int64)).abs()
                 - allowed.to(torch.int64)).clamp_min(0)
        self.v["summary_off_band"] += int(extra.sum())

    def readings(self):
        return [(n, self.v[n], float(self.limits[n])) for n in self.v]


# ------------------------------------------------------------- control
BF16 = torch.bfloat16


def control_state0(n: int, device) -> dict:
    z = torch.zeros(n, dtype=BF16, device=device)
    return {"k": z, "s": z, "var": z}


def control_scan(x, st: dict, m: float, vlen=None):
    """The program's row recursion in bfloat16.  Returns ({"ecc",
    "outlier"}, state') in the program's domain (float32 outputs)."""
    t_len, c = x.shape
    valid = _valid(t_len, vlen, c, x.device)
    xb = x.to(BF16)
    k0, s, var = st["k"], st["s"], st["var"]
    one = torch.ones((), dtype=BF16, device=x.device)
    msq1 = torch.tensor(m * m + 1.0, dtype=BF16, device=x.device)
    ecc = torch.empty((t_len, c), dtype=torch.float32, device=x.device)
    flag = torch.empty((t_len, c), dtype=torch.bool, device=x.device)
    for t in range(t_len):
        v = valid[t]
        k = k0 + torch.tensor(float(t + 1), dtype=BF16, device=x.device)
        s = torch.where(v, s + xb[t], s)
        mean = s / k
        first = k <= one
        d2 = torch.where(first | ~v, 0.0, (xb[t] - mean) * (xb[t] - mean)
                         ).to(BF16)
        a = torch.where(v, torch.where(first, 0.0, (k - one) / k), 1.0
                        ).to(BF16)
        var = a * var + d2 / k
        e = one / k + torch.where(var > 0, d2 / (k * var), 0.0).to(BF16)
        ecc[t] = e.float()
        flag[t] = v & (e / 2 > msq1 / (2 * k)) & (k >= 2)
    n_valid = valid.sum(0).to(BF16)
    return {"ecc": ecc, "outlier": flag}, {"k": k0 + n_valid, "s": s,
                                           "var": var}


def control_to_program(st: dict):
    """The control's state as the program's (k, mean, var) float32."""
    k = st["k"].float()
    return k, st["s"].float() / k.clamp_min(1.0), st["var"].float()
