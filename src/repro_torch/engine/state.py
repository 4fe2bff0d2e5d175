"""Packed per-stream engine state + the functional core.

`EngineState` packs the O(1) TEDA state of C independent univariate
streams as per-channel `k` / mean / var vectors plus an `active`
occupancy mask, so every slot is ragged: its own stream position,
recyclable for a new tenant mid-flight via `engine_attach` /
`engine_detach` / `engine_reset`.  The functions return new states and
never update a tensor in place.  The backend registry and the stateful
`StreamEngine` live one level up.

The "ensemble" backend carries its detectors' state in the extra
`aux` block; every function here moves that block as raw 32-bit words
(`torch.where` on int32 views), so int32 Q payloads whose bits alias a
float NaN pass through unchanged.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.teda import TedaOutput, TedaState, teda_step
from repro_torch.kernels.ragged import mask_ragged_rows

__all__ = ["EngineState", "engine_init", "engine_process", "engine_step",
           "engine_reset", "engine_attach", "engine_detach", "slot_mask",
           "engine_state_from_numpy"]


class EngineState(NamedTuple):
    """Packed per-stream state: C independent univariate TEDA modules.

    k:      (C,) — samples absorbed per slot.
    mean:   (C,) — recursive mean, eq (2).
    var:    (C,) — recursive variance, eq (3).
    active: (C,) bool — slot occupancy; inactive slots never advance.
    aux:    (R, C) float32 detector-state rows, or None.  The "ensemble"
            backend packs its `StateSpec` block here (R =
            backend.aux_rows); `mean`/`var` are then derived mirrors of
            its rows.  The TEDA backends carry no aux.

    dtype is float32, or int32 Q-values under the "cuda-q" backend.
    """

    k: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    active: torch.Tensor
    aux: Optional[torch.Tensor] = None


def _select_bits(mask, new, old):
    """torch.where over the aux block's raw 32-bit words: per-channel
    `mask` (C,) picks `new`'s column, else `old`'s, bit for bit."""
    return torch.where(mask[None, :], new.view(torch.int32),
                       old.view(torch.int32)).view(torch.float32)


def engine_init(capacity: int, dtype=torch.float32, active: bool = True,
                device=None, aux_rows: int = 0) -> EngineState:
    """Fresh packed state for `capacity` slots (Algorithm 1 init).
    `aux_rows` > 0 allocates the detector-state block (the ensemble
    backend's `backend.aux_rows`)."""
    def zeros():
        return torch.zeros(capacity, dtype=dtype, device=device)

    aux = (torch.zeros((aux_rows, capacity), dtype=torch.float32,
                       device=device) if aux_rows else None)
    return EngineState(k=zeros(), mean=zeros(), var=zeros(),
                       active=torch.full((capacity,), bool(active),
                                         device=device), aux=aux)


def engine_state_from_numpy(k, mean, var, active, *, dtype, device,
                            aux=None) -> EngineState:
    """An `EngineState` from host arrays — e.g. the fields of the JAX
    package's `EngineState` — to hand a live stream over mid-flight.
    Values are taken as they are: int32 Q bits are not converted.  `aux`
    (the ensemble's block) is taken as raw 32-bit words: pass it as its
    int32 view (`np.asarray(aux).view(np.int32)`) so that Q payloads
    whose bits alias a float NaN survive the hand-off; a float32 array
    is viewed the same way."""
    def vec(v, dt):
        return torch.as_tensor(np.array(v), device=device).to(dt)

    if aux is not None:
        words = np.ascontiguousarray(aux)
        if words.dtype not in (np.int32, np.float32):
            raise TypeError(f"aux must be int32 or float32 words, got "
                            f"{words.dtype}")
        aux = torch.as_tensor(words.view(np.int32).copy(),
                              device=device).view(torch.float32)
    return EngineState(k=vec(k, dtype), mean=vec(mean, dtype),
                       var=vec(var, dtype), active=vec(active, torch.bool),
                       aux=aux)


def slot_mask(slots, capacity: int, device=None) -> torch.Tensor:
    """Normalize a slot selector to a (C,) bool mask on `device`.

    `slots` may be None (all slots), a bool mask, or integer indices.
    Indices are bounds-checked: a bad slot raises instead of becoming a
    silent no-op.
    """
    if slots is None:
        return torch.ones(capacity, dtype=torch.bool, device=device)
    if isinstance(slots, torch.Tensor):
        slots = slots.cpu().numpy()
    idx = np.asarray(slots)
    if idx.dtype == bool:
        return torch.as_tensor(idx.reshape(capacity), device=device)
    idx = idx.astype(np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= capacity):
        raise IndexError(
            f"slot indices {np.unique(idx).tolist()} out of range for "
            f"capacity {capacity}")
    mask = np.zeros(capacity, bool)
    mask[idx] = True
    return torch.as_tensor(mask, device=device)


def engine_reset(state: EngineState, slots=None) -> EngineState:
    """Zero the TEDA state of the selected slots (k=mean=var=0), keeping
    occupancy — the mid-flight recycle for a new tenant on a live slot."""
    m = slot_mask(slots, state.k.shape[0], state.k.device)

    def zero(v):
        return torch.where(m, torch.zeros((), dtype=v.dtype,
                                          device=v.device), v)

    aux = state.aux
    if aux is not None:
        aux = _select_bits(m, torch.zeros_like(aux), aux)
    return EngineState(k=zero(state.k), mean=zero(state.mean),
                       var=zero(state.var), active=state.active, aux=aux)


def engine_attach(state: EngineState, slots) -> EngineState:
    """Activate (and zero) the selected slots for new streams."""
    m = slot_mask(slots, state.k.shape[0], state.k.device)
    state = engine_reset(state, m)
    return state._replace(active=state.active | m)


def engine_detach(state: EngineState, slots) -> EngineState:
    """Deactivate the selected slots; their state is cleared and they
    stop advancing (and flagging) until re-attached."""
    m = slot_mask(slots, state.k.shape[0], state.k.device)
    state = engine_reset(state, m)
    return state._replace(active=state.active & ~m)


def engine_process(state: EngineState, x: torch.Tensor, backend, m=None,
                   valid_lens=None, sel=None,
                   thr=None) -> Tuple[EngineState, dict]:
    """Advance the packed state through one (T, C) chunk.

    `backend` follows the `engine.backends.Backend` contract.  Inactive
    slots are frozen and never flag.  `m` optionally overrides the
    backend's threshold — a scalar or per-slot (C,) vector.

    `valid_lens` (per-slot (C,) int vector) makes the call ragged: slot
    c retires exactly valid_lens[c] leading rows (0..T), slots with
    vlen=0 keep their packed state bit for bit, and no slot flags past
    its valid length.  The caller folds occupancy into the vector
    (inactive slot => vlen 0).  `None` is the uniform path: every active
    slot retires all T rows.

    Returns (state', {"ecc": (T, C), "outlier": (T, C) bool}) — `ecc`
    is in the backend's native domain (Q int32 for "cuda-q").

    Aux-carrying backends (`backend.aux_rows > 0`, the ensemble) take
    the per-slot `sel` selection weights (K, C) and `thr` vote
    thresholds (C,) and return a 7-tuple: `ecc` is then the detector
    bitmask, `outlier` the fused vote, and the dict grows "scores", the
    (K, T, C) per-member score streams; the aux block freezes with the
    same masks as k/mean/var.
    """
    if getattr(backend, "aux_rows", 0):
        return _engine_process_aux(state, x, backend, m, valid_lens, sel,
                                   thr)
    if valid_lens is None:
        kf, mf, vf, ecc, outlier = backend.process(x, state.k, state.mean,
                                                   state.var, m=m)
        act = state.active
        new = EngineState(
            k=torch.where(act, kf.to(state.k.dtype), state.k),
            mean=torch.where(act, mf, state.mean),
            var=torch.where(act, vf, state.var),
            active=act)
        return new, {"ecc": ecc, "outlier": outlier & act[None, :]}

    vl = torch.as_tensor(valid_lens, device=state.k.device).to(torch.int32)
    kf, mf, vf, ecc, outlier = backend.process(
        x, state.k, state.mean, state.var, m=m, valid_lens=vl)
    adv = vl > 0  # fully-suspended slots: exact engine-level freeze
    new = EngineState(
        k=torch.where(adv, kf.to(state.k.dtype), state.k),
        mean=torch.where(adv, mf, state.mean),
        var=torch.where(adv, vf, state.var),
        active=state.active)
    return new, {"ecc": ecc,
                 "outlier": mask_ragged_rows(outlier, vl, x.shape[0])}


def _engine_process_aux(state: EngineState, x, backend, m, valid_lens,
                        sel, thr) -> Tuple[EngineState, dict]:
    """The aux-carrying (ensemble) leg of `engine_process`.

    The ensemble kernel already zeroes bits, votes and scores at rows
    >= vlen, so the ragged leg returns them as they are, with no
    (T, C) or (K, T, C) re-mask; the uniform leg gates on `active`.
    """
    if valid_lens is None:
        kf, mf, vf, auxf, bits, vote, scores = backend.process(
            x, state.k, state.mean, state.var, aux=state.aux, m=m,
            sel=sel, thr=thr)
        act = state.active
        new = EngineState(
            k=torch.where(act, kf.to(state.k.dtype), state.k),
            mean=torch.where(act, mf, state.mean),
            var=torch.where(act, vf, state.var),
            active=act, aux=_select_bits(act, auxf, state.aux))
        return new, {"ecc": torch.where(act[None, :], bits, 0),
                     "outlier": vote & act[None, :],
                     "scores": torch.where(act[None, None, :], scores,
                                           0.0)}

    vl = torch.as_tensor(valid_lens, device=state.k.device).to(torch.int32)
    kf, mf, vf, auxf, bits, vote, scores = backend.process(
        x, state.k, state.mean, state.var, aux=state.aux, m=m,
        valid_lens=vl, sel=sel, thr=thr)
    adv = vl > 0
    new = EngineState(
        k=torch.where(adv, kf.to(state.k.dtype), state.k),
        mean=torch.where(adv, mf, state.mean),
        var=torch.where(adv, vf, state.var),
        active=state.active, aux=_select_bits(adv, auxf, state.aux))
    return new, {"ecc": bits, "outlier": vote, "scores": scores}


def engine_step(state: EngineState, x: torch.Tensor, m=3.0
                ) -> Tuple[EngineState, TedaOutput]:
    """Single-sample path: one packed update for x (C,), float state
    only (the Q datapath goes through `engine_process`)."""
    if not torch.is_floating_point(state.k):
        raise TypeError(
            "engine_step is float-state only; Q-format (int32) state "
            "advances through engine_process with the 'cuda-q' backend")
    ts, out = teda_step(
        TedaState(k=state.k, mean=state.mean[:, None], var=state.var),
        x[:, None], m)
    act = state.active
    new = EngineState(k=torch.where(act, ts.k, state.k),
                      mean=torch.where(act, ts.mean[:, 0], state.mean),
                      var=torch.where(act, ts.var, state.var),
                      active=act)
    return new, out._replace(outlier=out.outlier & act)
