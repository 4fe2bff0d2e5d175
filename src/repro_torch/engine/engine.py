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

Under the "ensemble" backend the engine also carries the detectors'
packed aux block and, per slot, the members' selection weights and the
vote threshold (`attach(detectors=, vote=)`, `set_detectors`); the
(K, C) weight and (C,) threshold rows stay on the device and are
uploaded again only when a slot call changes them.

The engine runs on the CUDA device unless the caller asks for the CPU
(`device="cpu"`, where the kernel backends run their plain versions);
it never moves to the CPU on its own.

With `devices=[d0, d1, ...]` (the port's counterpart of the reference's
`mesh=`), the slots split into D contiguous channel groups, one per
device: each group's state lives on its device, and `process` runs one
backend call per group on that device's current stream
(`sharding.rules.make_channel_fanout`) and gathers the (T, C) outputs on
`devices[0]`.  Channels are independent, so the split needs no
collectives and changes no bit of any result.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.teda import TedaState
from repro_torch.detectors import vote_threshold
from repro_torch.engine.backends import get_backend
from repro_torch.engine.state import (EngineState, engine_attach,
                                      engine_detach, engine_init,
                                      engine_process, engine_reset,
                                      engine_state_from_numpy, slot_mask)
from repro_torch.obs import NULL_TRACER, MetricsRegistry, auto_name
from repro_torch.sharding.rules import group_size, make_channel_fanout

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


def _words(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit state tensor as its int32 words (int32 stays as it is)."""
    return v.view(torch.int32)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality with a bare "cuda" read as the current card."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


class StreamEngine:
    """Stateful multi-stream TEDA detector over `capacity` slots.

    >>> eng = StreamEngine(capacity=256, backend="cuda", m=3.0)
    >>> verdicts = eng.process(chunk)          # chunk: (T, 256)
    >>> eng.reset([7])                         # recycle slot 7 mid-flight
    >>> eng.detach([3]); eng.attach([3], m=2.5)  # slot 3: new tenant

    Chunks may have any length T >= 1; state is carried exactly across
    calls (bit for bit on the Q path).  `devices=` splits the channels
    over several devices (see the module docs); `device` must then be
    None or `devices[0]`.
    """

    def __init__(self, capacity: int, backend: str = "scan", *,
                 device=None, devices=None, m: float = 3.0, fmt=None,
                 block_t: int = 256, block_c: Optional[int] = None,
                 lane_pad: int = 128, auto_attach: bool = True,
                 registry=None, tracer=None, name: Optional[str] = None,
                 **backend_opts):
        self.capacity = int(capacity)
        if devices is None:
            self.devices = [resolve_device(device)]
        else:
            self.devices = [resolve_device(d) for d in devices]
            group_size(self.capacity, len(self.devices))
            if device is not None and not _same_device(
                    resolve_device(device), self.devices[0]):
                raise ValueError(
                    f"device={device!r} conflicts with devices[0]="
                    f"{self.devices[0]}")
        self.device = self.devices[0]
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
        # aux-carrying backends (the detector ensemble) grow the packed
        # state by backend.aux_rows rows per slot and take per-slot
        # member weights and vote thresholds on each call
        n_aux = int(getattr(self.backend, "aux_rows", 0) or 0)
        self._ensemble = n_aux > 0
        n_dev = len(self.devices)
        if self._ensemble and devices is not None:
            raise ValueError(
                "devices= fan-out is not supported with the ensemble "
                "backend (the aux state axis is not sharded)")
        # the packed state, one EngineState per channel group (a single
        # group without `devices=`), each on its group's device
        self._per = self.capacity // n_dev
        self._parts = [engine_init(self._per, self.backend.state_dtype,
                                   active=auto_attach, device=d,
                                   aux_rows=n_aux) for d in self.devices]
        self._fanout = (make_channel_fanout(self._core, self.devices)
                        if n_dev > 1 else None)
        if self._ensemble:
            self._det_names = tuple(self.backend.detectors)
            self._det_w = np.broadcast_to(
                np.asarray(self.backend.weights, np.float32)[:, None],
                (len(self._det_names), self.capacity)).copy()
            self._det_thr = np.full((self.capacity,),
                                    self.backend.default_threshold,
                                    np.float32)
            # device copies of (_det_w, _det_thr); None once a slot call
            # changed the host rows
            self._det_dev = None
        # per-slot outlier sensitivity, eq (6) m — float even on the Q
        # path (the backend quantizes m^2+1 itself)
        self._m = np.full((self.capacity,), self.default_m, np.float32)
        # chunk lengths this engine has executed: the reference's
        # per-(capacity, T) program-shape record
        self._t_shapes: set = set()

    # --------------------------------------------------------- state
    @property
    def state(self) -> EngineState:
        """The packed state over all `capacity` slots.  With `devices=`
        it is gathered on `devices[0]` (a copy: assign to `state` to
        change it, which splits it back over the groups)."""
        if len(self._parts) == 1:
            return self._parts[0]
        home = self.device
        return EngineState(*(
            torch.cat([getattr(p, f).to(home) for p in self._parts])
            for f in ("k", "mean", "var", "active")), aux=None)

    @state.setter
    def state(self, st: EngineState) -> None:
        if len(self._parts) == 1:
            self._parts = [st]
            return
        per = self._per
        self._parts = [EngineState(*(
            getattr(st, f)[g * per:(g + 1) * per].to(d)
            for f in ("k", "mean", "var", "active")), aux=None)
            for g, d in enumerate(self.devices)]

    def _slot_words(self, slot: int) -> np.ndarray:
        """One slot's packed state as int32 words, fetched with a single
        device-to-host copy of that slot alone: [k, mean, var] and then
        its aux column (the Q path's int32 values and the float path's
        float32 bits alike; aux payloads that alias NaN patterns stay
        as they are)."""
        g, j = divmod(int(slot), self._per)
        st = self._parts[g]
        cols = [_words(st.k)[j:j + 1], _words(st.mean)[j:j + 1],
                _words(st.var)[j:j + 1]]
        if st.aux is not None:
            cols.append(_words(st.aux)[:, j])
        return torch.cat(cols).cpu().numpy()

    def _put_slot_words(self, slot: int, words: np.ndarray) -> None:
        """Write `_slot_words` output into `slot`, word for word, on the
        slot's device (new tensors: the state never changes in place)."""
        g, j = divmod(int(slot), self._per)
        st = self._parts[g]
        w = torch.as_tensor(np.asarray(words, np.int32), device=st.k.device)

        def put(v, row):
            out = v.clone()
            _words(out)[..., j] = row
            return out

        self._parts[g] = EngineState(
            k=put(st.k, w[0]), mean=put(st.mean, w[1]),
            var=put(st.var, w[2]), active=st.active,
            aux=None if st.aux is None else put(st.aux, w[3:]))

    # ------------------------------------------------------ slot admin
    def _active_mask_host(self) -> np.ndarray:
        key = tuple(p.active for p in self._parts)
        cached = self._active_cache[0]
        if cached is None or any(a is not b for a, b in zip(cached, key)):
            self._active_cache = (key, np.concatenate(
                [a.cpu().numpy() for a in key]))
        return self._active_cache[1]

    def attach(self, slots=None, n: Optional[int] = None, *,
               m: Optional[float] = None, detectors=None, vote=None):
        """Activate slots for new streams; returns the slot indices.

        With `slots=None`, grabs the first `n` free slots (all free
        slots when `n` is also None).  Attaching an occupied slot, or
        asking for slots on a full engine, raises with the occupancy.
        `m` sets the new tenants' outlier sensitivity.  Under the
        ensemble backend, `detectors` selects the members these tenants
        run (default: all) and `vote` their vote mode or fraction
        (default: the backend's) — see `set_detectors`; both raise on
        another backend.
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
        if detectors is not None or vote is not None:
            self.set_detectors(idx, detectors=detectors, vote=vote)
        elif self._ensemble:
            self._reset_detectors(slot_mask(idx, self.capacity).numpy())
        return idx

    def detach(self, slots):
        self.state = engine_detach(self.state, slots)
        # recycled slots revert to the default sensitivity and detectors
        mask = slot_mask(slots, self.capacity).numpy()
        self._m[mask] = self.default_m
        if self._ensemble:
            self._reset_detectors(mask)

    def _reset_detectors(self, mask: np.ndarray) -> None:
        self._det_w[:, mask] = np.asarray(
            self.backend.weights, np.float32)[:, None]
        self._det_thr[mask] = self.backend.default_threshold
        self._det_dev = None

    def _require_ensemble(self, what: str) -> None:
        if not self._ensemble:
            raise ValueError(
                f"backend {self.backend.name!r} has no detector ensemble; "
                f"{what} needs backend='ensemble'")

    def set_detectors(self, slots=None, *, detectors=None,
                      vote=None) -> None:
        """Re-select the members and vote mode of live slots.

        `detectors` is a subset of the backend's members (None keeps all
        of them); unselected members get weight 0 on those slots — their
        state still advances, but they contribute neither flags nor vote
        weight, so a masked slot is exactly a smaller ensemble.  `vote`
        is "any" / "majority" / "all" or a weight fraction in (0, 1];
        None keeps the backend's mode, over the selected weights.
        """
        self._require_ensemble("per-slot detectors")
        mask = slot_mask(slots, self.capacity).numpy()
        if detectors is None:
            w = np.asarray(self.backend.weights, np.float32)
        else:
            chosen = ((detectors,) if isinstance(detectors, str)
                      else tuple(detectors))
            unknown = [d for d in chosen if d not in self._det_names]
            if unknown or not chosen:
                raise ValueError(
                    f"detectors must be a non-empty subset of this "
                    f"ensemble's members {list(self._det_names)}, got "
                    f"{detectors!r}")
            w = np.asarray(
                [self.backend.weights[d] if name in chosen else 0.0
                 for d, name in enumerate(self._det_names)], np.float32)
        thr = vote_threshold(self.backend.vote if vote is None else vote,
                             w)
        self._det_w[:, mask] = w[:, None]
        self._det_thr[mask] = thr
        self._det_dev = None

    def detector_config(self, slot: int) -> dict:
        """The live member selection of one slot: {"detectors": the
        selected member names, "weights": (K,) per-member weights,
        "threshold": the vote-weight threshold}."""
        self._require_ensemble("a detector config")
        w = self._det_w[:, slot]
        return {"detectors": tuple(n for d, n in enumerate(self._det_names)
                                   if w[d] > 0),
                "weights": w.copy(),
                "threshold": float(self._det_thr[slot])}

    def _detector_rows(self):
        """The (K, C) weight and (C,) threshold rows on the device,
        uploaded only after a slot call changed them."""
        if self._det_dev is None:
            self._det_dev = (
                torch.as_tensor(self._det_w, device=self.device),
                torch.as_tensor(self._det_thr, device=self.device))
        return self._det_dev

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

    def load_state(self, arrays, m=None, *, weights=None,
                   thresholds=None) -> None:
        """Take over packed state from host arrays.

        `arrays` is (k, mean, var, active), plus the aux block under the
        ensemble backend — e.g. the fields of the JAX package's
        `EngineState` as numpy arrays — in the backend's state dtype
        (int32 Q bits are taken unchanged; pass aux as its int32 view,
        see `engine_state_from_numpy`).  `m` optionally sets the
        per-slot sensitivity; under the ensemble backend `weights`
        (K, C) and `thresholds` (C,) set the per-slot member weights and
        vote thresholds.  A live stream can so move to this engine
        mid-flight and continue where it was.
        """
        k, mean, var, active, *aux = arrays
        if len(aux) != int(self._ensemble):
            raise ValueError(
                "arrays must be (k, mean, var, active)"
                + (", aux)" if self._ensemble else ")")
                + f" for backend {self.backend.name!r}")
        st = engine_state_from_numpy(k, mean, var, active,
                                     dtype=self.backend.state_dtype,
                                     device=self.device,
                                     aux=aux[0] if aux else None)
        if st.k.shape != (self.capacity,):
            raise ValueError(
                f"state must be ({self.capacity},) per field, got "
                f"{tuple(st.k.shape)}")
        if st.aux is not None:
            self.backend.state_spec.validate_aux(st.aux, self.capacity)
        if weights is not None or thresholds is not None:
            self._require_ensemble("detector weights")
            w = np.asarray(self._det_w if weights is None else weights,
                           np.float32)
            thr = np.asarray(self._det_thr if thresholds is None
                             else thresholds, np.float32)
            if w.shape != self._det_w.shape or thr.shape != (self.capacity,):
                raise ValueError(
                    f"weights must be {self._det_w.shape} and thresholds "
                    f"({self.capacity},)")
            self._det_w, self._det_thr = w.copy(), thr.copy()
            self._det_dev = None
        self.state = st
        if m is not None:
            self.set_m(None, m)

    # ------------------------------------------------------ processing
    def _account(self, t_len: int, vc, had_vlens: bool, amask) -> None:
        """Update the obs instruments for one `process` call.  `vc` is
        the host copy of valid_lens (None when the caller passed a
        device tensor: the retired count is then skipped); `amask` the
        host mask of the call's `active` subset, or None."""
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
        part = self._active_mask_host()
        if amask is not None:
            part = part & amask
        if not had_vlens:
            retired = t_key * int(part.sum())
        elif vc.ndim == 0:
            retired = int(vc) * int(part.sum())
        else:
            retired = int(vc[part].sum())
        if retired:
            self._c_samples.inc(retired)

    def process(self, x, active=None, valid_lens=None) -> dict:
        """Feed one (T, capacity) chunk; returns per-sample verdicts:
        {"ecc", "outlier"}, and under the ensemble backend {"ecc",
        "outlier", "det_flags", "scores"} — "ecc" and "det_flags" are
        the same (T, C) int32 detector bitmask, "outlier" the fused
        vote, "scores" the (K, T, C) per-member score streams.

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
        split = self._fanout is not None
        if not (split and isinstance(x, np.ndarray)):
            # a split engine uploads each group's columns to its own
            # device straight from host memory
            x = torch.as_tensor(x, device=self.device)
        if x.ndim != 2 or x.shape[1] != self.capacity:
            raise ValueError(
                f"chunk must be (T, {self.capacity}), got "
                f"{tuple(x.shape)}")
        t_len = x.shape[0]
        amask = (None if active is None
                 else slot_mask(active, self.capacity).numpy())
        vc = vl = None
        if valid_lens is not None:
            if isinstance(valid_lens, torch.Tensor) \
                    and valid_lens.device.type != "cpu":
                vl = valid_lens.to(torch.int32).clamp(0, t_len)
                if vl.ndim == 0:
                    vl = vl.expand(self.capacity)
            else:
                vc = np.asarray(valid_lens.cpu() if isinstance(
                    valid_lens, torch.Tensor) else valid_lens)
                if vc.size and (vc.min() < 0 or vc.max() > t_len):
                    raise ValueError(
                        f"valid_lens must lie in [0, T={t_len}], got "
                        f"[{vc.min()}, {vc.max()}]")
                vl = (np.full((self.capacity,), int(vc), np.int32)
                      if vc.ndim == 0 else vc.astype(np.int32))
            if vl.shape != (self.capacity,):
                raise ValueError(
                    f"valid_lens must be scalar or ({self.capacity},), "
                    f"got {tuple(vl.shape)}")
        # uniform sensitivity passes a host scalar (filled in on the
        # device); only a mixed batch uploads the per-slot vector.  The
        # Q backend's quantize_m yields integer numpy values, which the
        # kernels take as the pre-quantized msq1 constant.
        mv = self._m
        if (mv == mv[0]).all():
            mv = mv[0]
        m_arg = self.backend.quantize_m(mv)
        self._account(t_len, vc, valid_lens is not None, amask)
        sel = thr = None
        if self._ensemble:
            sel, thr = self._detector_rows()
        if split:
            self._parts, outs = self._fanout(x, self._parts, amask, vl,
                                             m_arg)
        else:
            new, outs = self._core(x, self._parts[0], amask, vl, m_arg,
                                   sel, thr)
            self._parts = [new]
        if self._ensemble:
            return {"ecc": outs["ecc"], "outlier": outs["outlier"],
                    "det_flags": outs["ecc"], "scores": outs["scores"]}
        return {"ecc": outs["ecc"], "outlier": outs["outlier"]}

    def _core(self, x, st: EngineState, amask, vl, m_arg, sel=None,
              thr=None):
        """One backend call over one channel group, on its state's
        device: fold occupancy and the `active` subset into the per-slot
        valid lengths, advance the state.  Returns (state', outputs)."""
        dev = st.k.device
        x = torch.as_tensor(x, device=dev)
        t_len, cap = x.shape
        part = st.active if amask is None else (
            st.active & torch.as_tensor(amask, device=dev))
        if vl is None:
            vl = torch.full((cap,), t_len, dtype=torch.int32, device=dev)
        else:
            vl = torch.as_tensor(vl, device=dev)
        vl = torch.where(part, vl, 0)
        new, outs = engine_process(
            EngineState(k=st.k, mean=st.mean, var=st.var, active=vl > 0,
                        aux=st.aux),
            x, self.backend, m=m_arg, valid_lens=vl, sel=sel, thr=thr)
        return new._replace(active=st.active), outs

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
