"""Stateful multi-stream TEDA engine with ragged multi-tenant slots.

`StreamEngine` owns packed per-stream state (`engine/state.py`) and
processes arbitrary-length (T, C) chunks as they arrive, carrying exact
state across calls for every backend in the registry
(`engine/backends.py`).  Every slot has its own `k` and its own outlier
threshold `m`; an `active` mask gates state advancement, and `attach` /
`detach` / `reset` recycle a slot for a new tenant mid-flight without
touching neighbours.  `process` takes per-call raggedness controls:
`valid_lens` gives every slot its own retired-sample count for the call,
and the `active` participation mask is the vlen=0 special case.

The engine runs on the CUDA device unless the caller asks for the CPU
(`device="cpu"`, where the kernel backends run their plain versions);
it never moves to the CPU on its own.  Not ported from the reference:
the `mesh=` channel fan-out and the detector-ensemble legs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.teda import TedaState
from repro_torch.engine.backends import get_backend
from repro_torch.engine.state import (EngineState, engine_attach,
                                      engine_detach, engine_init,
                                      engine_process, engine_reset,
                                      engine_state_from_numpy, slot_mask)
from repro_torch.obs import NULL_TRACER, MetricsRegistry, auto_name

__all__ = ["StreamEngine", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another.
    Raises when CUDA was asked for (or implied) and is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev


class StreamEngine:
    """Stateful multi-stream TEDA detector over `capacity` slots.

    >>> eng = StreamEngine(capacity=256, backend="cuda", m=3.0)
    >>> verdicts = eng.process(chunk)          # chunk: (T, 256)
    >>> eng.reset([7])                         # recycle slot 7 mid-flight
    >>> eng.detach([3]); eng.attach([3], m=2.5)  # slot 3: new tenant

    Chunks may have any length T >= 1; state is carried exactly across
    calls (bit for bit on the Q path).
    """

    def __init__(self, capacity: int, backend: str = "scan", *,
                 device=None, m: float = 3.0, fmt=None, block_t: int = 256,
                 block_c: Optional[int] = None, lane_pad: int = 128,
                 auto_attach: bool = True, registry=None, tracer=None,
                 name: Optional[str] = None, **backend_opts):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.default_m = float(m)
        # observability: process-call / samples-retired / program-shape
        # counters, labelled by engine instance
        self.registry = (MetricsRegistry() if registry is None
                         else registry)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.name = auto_name("engine") if name is None else str(name)
        lbl = {"engine": self.name}
        self._c_calls = self.registry.counter(
            "engine_process_calls_total",
            "process() chunk calls", ("engine",)).labels(**lbl)
        self._c_samples = self.registry.counter(
            "engine_samples_retired_total",
            "samples retired across all slots (per the caller's "
            "valid_lens)", ("engine",)).labels(**lbl)
        self._c_programs = self.registry.counter(
            "engine_programs_compiled_total",
            "distinct (capacity, T) program shapes executed",
            ("engine",)).labels(**lbl)
        # host mirror of the active mask, keyed by the identity of
        # state.active (replaced only by the slot admin calls): the
        # per-call metrics never fetch from the device
        self._active_cache = (None, None)
        self.backend = get_backend(backend, m=m, fmt=fmt, block_t=block_t,
                                   block_c=block_c, lane_pad=lane_pad,
                                   **backend_opts)
        self.state = engine_init(self.capacity, self.backend.state_dtype,
                                 active=auto_attach, device=self.device)
        # per-slot outlier sensitivity, eq (6) m — float even on the Q
        # path (the backend quantizes m^2+1 itself)
        self._m = np.full((self.capacity,), self.default_m, np.float32)
        # chunk lengths this engine has executed: the reference's
        # per-(capacity, T) program-shape record
        self._t_shapes: set = set()

    # ------------------------------------------------------ slot admin
    def _active_mask_host(self) -> np.ndarray:
        arr = self.state.active
        if self._active_cache[0] is not arr:
            self._active_cache = (arr, arr.cpu().numpy())
        return self._active_cache[1]

    def attach(self, slots=None, n: Optional[int] = None, *,
               m: Optional[float] = None):
        """Activate slots for new streams; returns the slot indices.

        With `slots=None`, grabs the first `n` free slots (all free
        slots when `n` is also None).  Attaching an occupied slot, or
        asking for slots on a full engine, raises with the occupancy.
        `m` sets the new tenants' outlier sensitivity.
        """
        occupied = self._active_mask_host()
        n_act, cap = int(occupied.sum()), self.capacity
        if slots is None:
            free = np.flatnonzero(~occupied)
            if n is None and not len(free):
                raise ValueError(
                    f"no free slots: engine full ({n_act}/{cap} active)")
            if n is not None and len(free) < n:
                raise ValueError(
                    f"wanted {n} free slots, have {len(free)} "
                    f"({n_act}/{cap} active)")
            idx = free if n is None else free[:n]
        else:
            idx = np.atleast_1d(np.asarray(slots))
            if idx.size and (idx.min() < 0 or idx.max() >= cap):
                raise IndexError(
                    f"slot indices {np.unique(idx).tolist()} out of range "
                    f"for capacity {cap}")
            busy = np.unique(idx[occupied[idx]]) if idx.size else idx
            if busy.size:
                raise ValueError(
                    f"slots {busy.tolist()} already attached "
                    f"({n_act}/{cap} active); detach or reset them first")
        self.state = engine_attach(self.state, idx)
        self._m[idx] = self.default_m if m is None else float(m)
        return idx

    def detach(self, slots):
        self.state = engine_detach(self.state, slots)
        # recycled slots revert to the default sensitivity
        self._m[slot_mask(slots, self.capacity).numpy()] = self.default_m

    def reset(self, slots=None):
        self.state = engine_reset(self.state, slots)

    def set_m(self, slots, m) -> None:
        """Retune the outlier sensitivity of the selected slots.

        With integer `slots`, a vector `m` is matched positionally;
        `slots` may also be None (all) or a bool mask.
        """
        m = np.asarray(m, np.float32)
        if slots is None:
            self._m[:] = m
            return
        slots = np.asarray(slots)
        if slots.dtype == bool:
            self._m[slots.reshape(self.capacity)] = m
            return
        idx = np.atleast_1d(slots).astype(int)
        if idx.size and (idx.min() < 0 or idx.max() >= self.capacity):
            raise IndexError(
                f"slot indices {np.unique(idx).tolist()} out of range "
                f"for capacity {self.capacity}")
        self._m[idx] = m

    def load_state(self, arrays, m=None) -> None:
        """Take over packed state from host arrays.

        `arrays` is (k, mean, var, active) — e.g. the fields of the JAX
        package's `EngineState` as numpy arrays — in the backend's state
        dtype (int32 Q bits are taken unchanged); `m` optionally sets
        the per-slot sensitivity.  A live stream can so move to this
        engine mid-flight and continue where it was.
        """
        k, mean, var, active = arrays
        st = engine_state_from_numpy(k, mean, var, active,
                                     dtype=self.backend.state_dtype,
                                     device=self.device)
        if st.k.shape != (self.capacity,):
            raise ValueError(
                f"state must be ({self.capacity},) per field, got "
                f"{tuple(st.k.shape)}")
        self.state = st
        if m is not None:
            self.set_m(None, m)

    # ------------------------------------------------------ processing
    def _account(self, t_len: int, vc, had_vlens: bool, active) -> None:
        """Update the obs instruments for one `process` call.  `vc` is
        the host copy of valid_lens (None when the caller passed a
        device tensor: the retired count is then skipped)."""
        t_key = int(t_len)
        if t_key not in self._t_shapes:
            self._t_shapes.add(t_key)
            self._c_programs.inc()
            if self.tracer.enabled:
                self.tracer.instant("engine.compile", engine=self.name,
                                    capacity=self.capacity, t=t_key)
        self._c_calls.inc()
        if had_vlens and vc is None:
            return
        amask = self._active_mask_host()
        if active is not None:
            amask = amask & slot_mask(active, self.capacity).numpy()
        if not had_vlens:
            retired = t_key * int(amask.sum())
        elif vc.ndim == 0:
            retired = int(vc) * int(amask.sum())
        else:
            retired = int(vc[amask].sum())
        if retired:
            self._c_samples.inc(retired)

    def process(self, x, active=None, valid_lens=None) -> dict:
        """Feed one (T, capacity) chunk; returns per-sample verdicts.

        `valid_lens` makes the call ragged: a scalar or per-slot
        (capacity,) int vector; slot c retires exactly valid_lens[c]
        leading rows (0..T) — its state freezes after its own prefix and
        it never flags beyond it.  A host value (int, list, numpy) is
        bounds-checked on the host before upload; a device tensor is
        clamped to [0, T] without a device-to-host copy.

        `active` restricts the call to a subset of slots (bool mask or
        indices) — vlen=0 for everyone else.  Detached slots are always
        held at vlen=0.

        The call does not synchronize: the returned tensors are on the
        engine's device and the kernels may still be running.
        """
        x = torch.as_tensor(x, device=self.device)
        if x.ndim != 2 or x.shape[1] != self.capacity:
            raise ValueError(
                f"chunk must be (T, {self.capacity}), got "
                f"{tuple(x.shape)}")
        t_len = x.shape[0]
        st = self.state
        part = st.active if active is None else (
            st.active & slot_mask(active, self.capacity, self.device))
        vc = None
        if valid_lens is None:
            vl = torch.full((self.capacity,), t_len, dtype=torch.int32,
                            device=self.device)
        else:
            if isinstance(valid_lens, torch.Tensor) \
                    and valid_lens.device.type != "cpu":
                vl = valid_lens.to(torch.int32).clamp(0, t_len)
            else:
                vc = np.asarray(valid_lens.cpu() if isinstance(
                    valid_lens, torch.Tensor) else valid_lens)
                if vc.size and (vc.min() < 0 or vc.max() > t_len):
                    raise ValueError(
                        f"valid_lens must lie in [0, T={t_len}], got "
                        f"[{vc.min()}, {vc.max()}]")
                vl = torch.as_tensor(vc.astype(np.int32),
                                     device=self.device)
            if vl.ndim == 0:
                vl = vl.expand(self.capacity)
            elif vl.shape != (self.capacity,):
                raise ValueError(
                    f"valid_lens must be scalar or ({self.capacity},), "
                    f"got {tuple(vl.shape)}")
        vl = torch.where(part, vl, 0)
        # uniform sensitivity passes a host scalar (filled in on the
        # device); only a mixed batch uploads the per-slot vector.  The
        # Q backend's quantize_m yields integer numpy values, which the
        # kernels take as the pre-quantized msq1 constant.
        mv = self._m
        if (mv == mv[0]).all():
            mv = mv[0]
        m_arg = self.backend.quantize_m(mv)
        self._account(t_len, vc, valid_lens is not None, active)
        new, outs = engine_process(
            EngineState(k=st.k, mean=st.mean, var=st.var, active=vl > 0),
            x, self.backend, m=m_arg, valid_lens=vl)
        self.state = EngineState(k=new.k, mean=new.mean, var=new.var,
                                 active=st.active)
        return {"ecc": outs["ecc"], "outlier": outs["outlier"]}

    # ------------------------------------------------------- introspection
    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active_mask_host())

    @property
    def samples_seen(self) -> np.ndarray:
        """Per-slot sample counts (the per-channel k)."""
        return self.state.k.cpu().numpy()

    @property
    def slot_m(self) -> np.ndarray:
        """Per-slot outlier sensitivity (eq (6) m), a (capacity,) copy."""
        return self._m.copy()

    @property
    def program_shapes(self) -> list:
        """Sorted chunk lengths T this engine has executed."""
        return sorted(self._t_shapes)

    def teda_state(self) -> TedaState:
        """The packed state in the `core` TedaState layout."""
        return TedaState(k=self.state.k, mean=self.state.mean[:, None],
                         var=self.state.var)
