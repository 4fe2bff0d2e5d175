"""Declarative per-member detector-state layout (`StateSpec`).

A `StateSpec` is an ordered tuple of named `Region`s, each a contiguous
strip of per-channel rows inside the packed `EngineState.aux` block:

  * `rows` — the region's row count.
  * `tag`  — the element type of the payload: "f32" rows hold plain
    float32 values; "i32" rows hold int32 payloads stored bit for bit in
    the float32 aux tensor (`i32_to_f32_bits` / `f32_to_i32_bits`, both
    `Tensor.view`, never a value conversion).  Every layer that moves
    aux columns does so as raw element bits, so opaque regions ride
    along unchanged, NaN-aliasing Q payloads included.

`ensemble_spec(detectors, window)` builds the layout for one ensemble:
the shared moment fabric first (rows [0, 2W]: W rows of running-sum
prefix tail, W of the sum-of-squares twin, one TEDA variance row), then
one opaque region group per non-moment member in detector order.  The
layout is the JAX package's, row for row, so an aux block crosses
between the two packages as it is.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

__all__ = ["Region", "StateSpec", "ensemble_spec", "member_regions",
           "MEMBERS", "MOMENT_MEMBERS", "HST_LEAVES", "HST_RANGE",
           "check_detectors", "check_fmt", "f32_to_i32_bits",
           "i32_to_f32_bits"]

#: canonical member order: index d is bit d of the fused kernel's
#: detector bitmask and member d's code in `csrc/ensemble_scan.cu`'s
#: `enum Member`
MEMBERS = ("teda", "rde", "zscore", "hst", "teda-q")

#: members whose state is the shared moment fabric (prefix-sum tails and
#: the TEDA variance recursion): they own no opaque region
MOMENT_MEMBERS = ("teda", "rde", "zscore")

#: half-space-tree histogram resolution: leaves per channel (a depth-3
#: balanced tree over a static input range), and that range
HST_LEAVES = 8
HST_RANGE = (-4.0, 4.0)


class Region(NamedTuple):
    """One named contiguous strip of per-channel aux rows."""

    name: str
    rows: int
    tag: str = "f32"


class StateSpec(NamedTuple):
    """Ordered, hashable layout of one ensemble's packed aux block."""

    regions: Tuple[Region, ...]

    @property
    def rows(self) -> int:
        """Total per-channel aux rows."""
        return sum(r.rows for r in self.regions)

    def offset(self, name: str) -> int:
        """Start row of region `name` (raises KeyError when absent)."""
        off = 0
        for r in self.regions:
            if r.name == name:
                return off
            off += r.rows
        raise KeyError(f"no region {name!r} in {self.names()}")

    def region(self, name: str) -> Region:
        for r in self.regions:
            if r.name == name:
                return r
        raise KeyError(f"no region {name!r} in {self.names()}")

    def slc(self, name: str) -> slice:
        """Row slice of region `name` inside the aux block."""
        off = self.offset(name)
        return slice(off, off + self.region(name).rows)

    def names(self) -> Tuple[str, ...]:
        return tuple(r.name for r in self.regions)

    def has(self, name: str) -> bool:
        return any(r.name == name for r in self.regions)

    def init_aux(self, c: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
        """Fresh packed aux block for C channels: all zeros, which is the
        zero payload for both f32 and i32 regions."""
        return torch.zeros((self.rows, c), dtype=dtype, device=device)

    def validate_aux(self, aux, c: int) -> None:
        """Raise unless `aux` has this layout's (rows, C) shape."""
        shape = tuple(aux.shape)
        if shape != (self.rows, c):
            raise ValueError(
                f"state.aux must be ({self.rows}, {c}) for layout "
                f"{self.names()}, got {shape}")


def f32_to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret f32 aux rows as their int32 payload (no conversion)."""
    return x.view(torch.int32)


def i32_to_f32_bits(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret an int32 payload as raw f32 aux rows (no conversion)."""
    return x.to(torch.int32).view(torch.float32)


def _moment_regions(window: int) -> Tuple[Region, ...]:
    """The shared fabric: W rows of running-sum prefix tail, W rows of
    the sum-of-squares twin, one TEDA variance carry row."""
    w = int(window)
    if w < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return (Region("moment:s", w), Region("moment:s2", w),
            Region("moment:var", 1))


def _hst_regions(window: int) -> Tuple[Region, ...]:
    """Half-space-tree member: the reference and filling leaf-mass
    tables plus the phase counter, exact small integers in f32 rows."""
    return (Region("hst:ref", HST_LEAVES), Region("hst:cur", HST_LEAVES),
            Region("hst:phase", 1))


def _teda_q_regions(window: int) -> Tuple[Region, ...]:
    """Q-format TEDA member: the MEAN and VARIANCE int32 Q registers."""
    return (Region("teda-q:mean", 1, "i32"), Region("teda-q:var", 1, "i32"))


#: per-member opaque-region builders; moment members are absent
MEMBER_REGIONS: Dict[str, Callable[[int], Tuple[Region, ...]]] = {
    "hst": _hst_regions,
    "teda-q": _teda_q_regions,
}


def member_regions(name: str, window: int) -> Tuple[Region, ...]:
    """Opaque regions member `name` owns (empty for moment members)."""
    if name in MOMENT_MEMBERS:
        return ()
    try:
        return MEMBER_REGIONS[name](window)
    except KeyError:
        raise KeyError(f"unknown ensemble member {name!r}") from None


def check_detectors(detectors) -> Tuple[str, ...]:
    """The member tuple, or ValueError unless it is a non-empty unique
    subset of `MEMBERS`."""
    detectors = tuple(detectors)
    unknown = [d for d in detectors if d not in MEMBERS]
    if unknown or not detectors or len(set(detectors)) != len(detectors):
        raise ValueError(
            f"detectors must be a non-empty unique subset of "
            f"{sorted(MEMBERS)}, got {detectors!r}")
    return detectors


def check_fmt(detectors, fmt):
    """The teda-q member's QFormat (validated), None without that
    member; ValueError when the member is present without one."""
    if "teda-q" not in detectors:
        return None
    if fmt is None:
        raise ValueError(
            "the teda-q ensemble member needs fmt=QFormat(...) — the "
            "Q datapath's word/fraction lengths are part of the "
            "detector's definition")
    fmt.validate()
    return fmt


def ensemble_spec(detectors, window: int) -> StateSpec:
    """The packed aux layout of one ensemble: the moment fabric in rows
    [0, 2W] (always, even with no moment member), then each non-moment
    member's regions in detector order."""
    regions = list(_moment_regions(window))
    for name in detectors:
        regions.extend(member_regions(name, window))
    return StateSpec(regions=tuple(regions))
