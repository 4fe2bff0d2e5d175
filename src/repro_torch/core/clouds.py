"""TEDA data clouds — the evolving classifier built on the paper's core.

The TEDA papers the reproduction builds on ([4] Costa et al.
"Unsupervised classification of data streams based on typicality and
eccentricity data analytics", [15] TEDAClass) extend the detector into
an autonomous classifier: samples are grouped into *data clouds*, each
carrying the same O(1) recursive state (k, mu, var) as a single TEDA
stream.  Per sample:

  * compute the sample's normalized eccentricity w.r.t. every cloud
    (eq (5) using that cloud's statistics, sample tentatively included);
  * join every cloud where the sample is typical (zeta <= (m^2+1)/(2k),
    the complement of the paper's outlier rule) — soft labeling;
  * if eccentric to all clouds, found a new cloud at the sample.

Fixed capacity: clouds live in padded tensors with an active mask and
every step is branch-free tensor work, so a step reads nothing back to
the host.  Clouds update sequentially per sample, the online semantics
of [4].
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["CloudState", "clouds_init", "clouds_step", "clouds_run"]


class CloudState(NamedTuple):
    k: torch.Tensor       # (C,) samples absorbed per cloud (0 = inactive)
    mean: torch.Tensor    # (C, N)
    var: torch.Tensor     # (C,)
    n_active: torch.Tensor  # () int32


def clouds_init(capacity: int, n_features: int, device=None) -> CloudState:
    """Fresh clouds on `device` (the card unless the caller names
    another; raises without CUDA)."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)
    return CloudState(
        k=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        mean=torch.zeros((capacity, n_features), dtype=torch.float32,
                         device=dev),
        var=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        n_active=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _tentative(state: CloudState, x: torch.Tensor):
    """Eq (2)/(3)/(1)/(5) with x tentatively added to every cloud."""
    k1 = state.k + 1.0
    mean1 = (state.k[:, None] * state.mean + x[None]) / k1[:, None]
    d2 = torch.sum((x[None] - mean1) ** 2, dim=-1)
    var1 = (k1 - 1.0) / k1 * state.var + d2 / k1
    safe = var1 > 1e-12
    ecc = 1.0 / k1 + torch.where(
        safe, d2 / (k1 * torch.where(safe, var1, 1.0)), 0.0)
    zeta = ecc / 2.0
    return k1, mean1, var1, zeta


def clouds_step(state: CloudState, x: torch.Tensor, m: float = 3.0
                ) -> Tuple[CloudState, torch.Tensor]:
    """Absorb one sample x (N,).  Returns (state, membership (C,) bool).

    A cloud accepts the sample when it is NOT eccentric there (the
    complement of eq (6)).  New clouds spawn in the first inactive slot;
    at capacity the sample joins its least-eccentric cloud.  A cloud
    younger than m^2 samples cannot reject (the detectability bound of
    the streaming regime the classifier targets).
    """
    cap = state.k.shape[0]
    idx = torch.arange(cap, device=state.k.device)
    active = state.k > 0.0
    k1, mean1, var1, zeta = _tentative(state, x)
    thr = (m * m + 1.0) / (2.0 * k1)
    join = active & (zeta <= thr)

    any_join = join.any()
    slot = torch.argmin(active.to(torch.int8))  # first inactive slot
    has_room = ~active[slot]
    fallback = torch.argmin(torch.where(active, zeta, torch.inf))

    spawn = ~any_join & has_room
    adopt = ~any_join & ~has_room
    join = join | (adopt & (idx == fallback))

    # update joined clouds recursively; spawn a fresh cloud at x
    new_k = torch.where(join, k1, state.k)
    new_mean = torch.where(join[:, None], mean1, state.mean)
    new_var = torch.where(join, var1, state.var)
    born = spawn & (idx == slot)
    new_k = torch.where(born, 1.0, new_k)
    new_mean = torch.where(born[:, None], x[None], new_mean)
    new_var = torch.where(born, 0.0, new_var)

    membership = join | born
    n_active = (new_k > 0).sum().to(torch.int32)
    return CloudState(k=new_k, mean=new_mean, var=new_var,
                      n_active=n_active), membership


def clouds_run(x: torch.Tensor, capacity: int = 16, m: float = 3.0
               ) -> Tuple[CloudState, torch.Tensor]:
    """Stream x (T, N) through the evolving classifier, on x's device.

    Returns (final state, memberships (T, C) bool — soft labels)."""
    x = x.float()
    state = clouds_init(capacity, x.shape[-1], device=x.device)
    members = []
    for xi in x:
        state, mem = clouds_step(state, xi, m)
        members.append(mem)
    if not members:
        return state, torch.zeros((0, capacity), dtype=torch.bool,
                                  device=x.device)
    return state, torch.stack(members)
