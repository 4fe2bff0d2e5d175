"""Sharding rules: a spec for every tensor of the system, and the channel
fan-out of the stream engine.

The model side follows the JAX package's `sharding/rules.py` rule for
rule (its docstring has the strategy, DESIGN.md §5):

  * batch/tokens         -> data-parallel over ("pod", "data")
  * 2D weights           -> FSDP on the input dim over "data", TP on the
                            output dim over "model" (down-projections
                            transpose this so the contracting dim stays
                            on "model")
  * embedding (vocab, d) -> vocab over "model", d over "data"
  * MoE expert stacks    -> expert-parallel over "model" when n_experts
                            divides the axis, else TP over d_ff
  * KV caches            -> batch over data when divisible, else sequence
                            over "data" (context parallelism, long_500k);
                            head_dim over "model" when divisible
  * tiny arrays (norms, biases, gates) -> replicated

A spec is a tuple with one entry per tensor dim: None, an axis name or a
tuple of axis names (the reference's `PartitionSpec`; `placements`
turns it into DTensor placements).  The rules take the reference's tree
paths and stacked shapes: the reference stacks each group's blocks on a
leading (n_groups,) axis and the encoder-decoder's layers on (L,), where
the port keeps one module per layer.  `params_shardings` maps each of the
port's parameter names to that path and stacked shape (the mapping of
`models/convert.py`), applies the rule and drops the stack entry, so a
per-layer leaf gets the reference's rule for its stacked leaf.  The same
holds for decode caches (`state_cache_shardings`).  All rules are
advisory in the reference (GSPMD propagates them); here they are the
placements of the arguments, and the model's sharded paths
(`sharding/hints.py`: the products, attention, the decode, the
embedding and the CE) lay the step's work out from them as GSPMD does.

The fan-out splits `StreamEngine`'s chunk processing over a list of
devices, the reference's `shard_map` over a mesh axis.  Channels are
independent TEDA modules (the paper's replicated-module scaling), so
the split needs no collectives: each device runs the same function on
its contiguous slice of channels, on its device's current stream under
`torch.cuda.device(d)`.  A device may appear more than once in the list:
the CPU tests run `["cpu", "cpu"]`, and a one-card machine runs
`["cuda:0", "cuda:0"]`.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["REPLICATE_BELOW", "RULE_FLAGS", "dp_axes", "param_spec",
           "param_path", "params_shardings", "batch_spec", "cache_spec",
           "state_cache_shardings", "placements", "group_size",
           "make_channel_fanout"]

REPLICATE_BELOW = 1 << 16  # arrays smaller than 64k entries: replicate

_DOWN_PROJ_NAMES = ("wo", "wdown", "wout")

# Experiment toggles for the hillclimb (`launch/hillclimb.py
# --rule-flag`).  Defaults = production baseline.
RULE_FLAGS = {
    "moe_prefer_tp": False,   # True: shard expert ff dim instead of EP
    "embed_data_shard": True,  # False: replicate embed d over data
    # True: parameter/optimizer FSDP spans the pod axis too (ZeRO-3
    # across pods; the production choice for >=100B-param models whose
    # state cannot replicate per pod)
    "fsdp_over_pod": False,
}

Spec = Tuple  # one entry per tensor dim: None, an axis, or a tuple of axes


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis(mesh, name: str) -> int:
    return dict(mesh.shape)[name]


def _div(n: int, k: int) -> bool:
    return n % k == 0 and n >= k


def _axes(names: Tuple[str, ...]):
    """A spec entry over `names`: a lone name as itself (a
    `PartitionSpec` reads ("data",) as "data")."""
    return names[0] if len(names) == 1 else names


def _pad(spec, ndim: int) -> Spec:
    """A spec with exactly `ndim` entries (trailing ones None)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def param_spec(mesh, path: str, shape: Tuple[int, ...]) -> Spec:
    """The reference's rule for one parameter leaf, keyed on its tree
    path ("blocks_0/attn/wq/w") and its shape, stacked where the path is
    a stack ("blocks_<j>", "enc_blocks", "dec_blocks")."""
    dsz, msz = _axis(mesh, "data"), _axis(mesh, "model")
    fsdp: object = "data"
    if RULE_FLAGS["fsdp_over_pod"] and "pod" in mesh.axis_names:
        fsdp = ("pod", "data")
        dsz = dsz * _axis(mesh, "pod")
    size = math.prod(shape) if shape else 1
    if size < REPLICATE_BELOW or not shape:
        return ()
    parts = path.replace(".", "/").split("/")
    name = parts[-1]
    if name in ("w", "b") and len(parts) >= 2:  # dense leaf: use its module
        name = parts[-2]
    stacked = "blocks_" in path or "_blocks" in path  # leading groups dim
    off = 1 if stacked else 0
    dims = shape[off:]
    lead = (None,) * off

    # embedding / unembedding tables
    if "table" in name or "embed" in path:
        d_ax = fsdp if (RULE_FLAGS["embed_data_shard"]
                        and _div(dims[1], dsz)) else None
        return lead + ("model" if _div(dims[0], msz) else None, d_ax)

    # expert-stacked weights (E, din, dout)
    if "moe" in path and len(dims) == 3:
        # the ff dim: 2 for wi / wg, 1 for wo
        ff_dim = 2 if name in ("wi", "wg") else 1
        spec: list = [None] * 3
        if _div(dims[0], msz) and not RULE_FLAGS["moe_prefer_tp"]:
            # EP on E; FSDP on the ff dim so (E, C, ff) dispatch
            # intermediates shard over data
            spec[0] = "model"
            if _div(dims[ff_dim], dsz):
                spec[ff_dim] = fsdp
            return lead + tuple(spec)
        # fall back to TP over the ff dim
        if _div(dims[ff_dim], msz):
            spec[ff_dim] = "model"
        other = 1 if ff_dim == 2 else 2
        if _div(dims[other], dsz):
            spec[other] = fsdp
        return lead + tuple(spec)

    if len(dims) == 2:
        din, dout = dims
        if name in _DOWN_PROJ_NAMES:  # contracting dim on model
            return lead + ("model" if _div(din, msz) else None,
                           fsdp if _div(dout, dsz) else None)
        return lead + (fsdp if _div(din, dsz) else None,
                       "model" if _div(dout, msz) else None)

    if len(dims) == 1:
        return lead + ("model" if _div(dims[0], msz) else None,)
    # conv kernels / recurrent blocks etc.: the largest dim on model
    spec = [None] * len(dims)
    big = int(np.argmax(dims))
    if _div(dims[big], msz):
        spec[big] = "model"
    return lead + tuple(spec)


def param_path(model, name: str) -> Tuple[str, int]:
    """The reference's tree path of the port's parameter `name` and the
    length of the stack it is one slice of (0 for an unstacked leaf):
    "blocks.<g * per + j>.<rest>" is slice g of "blocks_<j>/<rest>"
    (n_groups slices), "enc_blocks.<l>.<rest>" slice l of
    "enc_blocks/<rest>" (enc_layers), the rest ("embed/table",
    zamba2's "shared/...") unstacked."""
    parts = name.split(".")
    if parts[0] == "blocks":
        from repro_torch.models.transformer import block_layout
        grp, n_groups = block_layout(model.cfg)
        j = int(parts[1]) % len(grp)
        return "/".join([f"blocks_{j}"] + parts[2:]), n_groups
    if parts[0] in ("enc_blocks", "dec_blocks"):
        return "/".join([parts[0]] + parts[2:]), len(model[parts[0]])
    return "/".join(parts), 0


def _unstacked(mesh, rule, path: str, shape, stack: int) -> Spec:
    """`rule(mesh, path, stacked shape)` with the stack entry dropped,
    padded to the leaf's ndim."""
    if not stack:
        return _pad(rule(mesh, path, tuple(shape)), len(shape))
    full = _pad(rule(mesh, path, (stack,) + tuple(shape)), len(shape) + 1)
    return full[1:]


def params_shardings(mesh, model) -> Dict[str, Spec]:
    """{parameter name: spec} for a whole `LM` or `EncDec`."""
    out = {}
    for name, p in model.named_parameters():
        path, stack = param_path(model, name)
        out[name] = _unstacked(mesh, param_spec, path, p.shape, stack)
    return out


def batch_spec(mesh, batch_size: int, kind: str = "train") -> Spec:
    """Spec for (B, S) token batches / (B,) decode tokens."""
    axes = dp_axes(mesh)
    total = math.prod(_axis(mesh, a) for a in axes)
    if _div(batch_size, total):
        return (_axes(axes),) if kind == "decode" else (_axes(axes), None)
    if "data" in axes and _div(batch_size, _axis(mesh, "data")):
        return ("data",) if kind == "decode" else ("data", None)
    return () if kind == "decode" else (None, None)


def cache_spec(mesh, shape: Tuple[int, ...], batch_axis: int = 1,
               seq_axis: int = 2, head_dim_axis: int = -1) -> Spec:
    """The reference's KV-cache spec for its stacked (groups, B, S, kv,
    hd) cache; the port's per-layer (B, S, kv, hd) cache takes
    `batch_axis=0, seq_axis=1` (or `state_cache_shardings`)."""
    dsz, msz = _axis(mesh, "data"), _axis(mesh, "model")
    axes = dp_axes(mesh)
    total = math.prod(_axis(mesh, a) for a in axes)
    spec: list = [None] * len(shape)
    b = shape[batch_axis]
    if _div(b, total):
        spec[batch_axis] = _axes(axes)
    elif _div(b, dsz):
        spec[batch_axis] = "data"
    elif _div(shape[seq_axis], dsz):  # tiny batch: context-parallel
        spec[seq_axis] = "data"
    hd = shape[head_dim_axis]
    if _div(hd, msz):
        spec[head_dim_axis] = "model"
    elif _div(shape[-2], msz):  # else try kv-heads
        spec[-2] = "model"
    return tuple(spec)


def _stacked_state_spec(mesh, _path, shape) -> Spec:
    """The reference's rule for one stacked decode-cache leaf (G, B,
    ...): 5 or more dims are an attention cache; a recurrent state has
    its batch over dp and its biggest trailing dim over model."""
    if len(shape) >= 5:
        return cache_spec(mesh, shape)
    dsz, msz = _axis(mesh, "data"), _axis(mesh, "model")
    axes = dp_axes(mesh)
    total = math.prod(_axis(mesh, a) for a in axes)
    spec: list = [None] * len(shape)
    if len(shape) >= 2:
        if _div(shape[1], total):
            spec[1] = _axes(axes)
        elif _div(shape[1], dsz):
            spec[1] = "data"
    trail = list(range(2, len(shape)))
    if trail:
        big = max(trail, key=lambda i: shape[i])
        if _div(shape[big], msz):
            spec[big] = "model"
    return tuple(spec)


def state_cache_shardings(mesh, caches):
    """Specs for the port's decode caches: a list of one cache
    NamedTuple per layer (`init_cache`) or the encoder-decoder's
    {"self": [...], "cross": [...]} (`init_encdec_cache`).  Each leaf
    gets the reference's rule for its stacked leaf (the leading axis
    the reference stacks layers on) with the stack entry dropped."""
    if isinstance(caches, dict):
        return {k: state_cache_shardings(mesh, v) for k, v in caches.items()}
    n = len(caches)
    return [type(c)(*(_unstacked(mesh, _stacked_state_spec, "", t.shape, n)
                      for t in c)) for c in caches]


def placements(mesh, spec: Spec) -> list:
    """DTensor placements of `spec` on `mesh` (a `launch/mesh.py::Mesh`
    or a `DeviceMesh`; one per mesh axis, in the mesh's order):
    `Shard(d)` on each axis named at tensor dim d, `Replicate()` on the
    others and on an axis of size 1 (which holds the whole dim either
    way; DTensor would ask a view of a dim split over it to follow the
    split).  A tuple entry ("pod", "data") shards
    dim d over both axes, the first outermost, as a `PartitionSpec`
    does (DTensor splits a dim over mesh axes in mesh order, so the
    tuple must follow it)."""
    from torch.distributed.tensor import Replicate, Shard

    axes = tuple(getattr(mesh, "axis_names", None)
                 or mesh.mesh_dim_names)  # a Mesh or a DeviceMesh
    sizes = (tuple(mesh.shape.values()) if isinstance(mesh.shape, dict)
             else tuple(mesh.shape))
    out = [Replicate() for _ in axes]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axes.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{axes}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


# ------------------------------------------------------ channel fan-out
def group_size(capacity: int, n_groups: int) -> int:
    """Channels per group of an even split; raises when `capacity` does
    not divide into `n_groups` groups."""
    if n_groups < 1:
        raise ValueError(f"need at least one device, got {n_groups}")
    if capacity % n_groups:
        raise ValueError(
            f"capacity {capacity} not divisible by the device split "
            f"({n_groups} shards)")
    return capacity // n_groups


def _on(dev: torch.device):
    """The context that makes `dev` the current CUDA device (a no-op for
    other devices); it restores the caller's device on exit."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _part(v, g: int, lo: int, hi: int, c: int, dev: torch.device):
    """Group g's share of one argument: lists are already split (entry
    g, on its device); arrays whose last axis has `c` entries are sliced
    to [lo, hi) on that axis and moved to `dev`; anything else (None,
    scalars, 0-d values) passes unchanged."""
    if isinstance(v, (list, tuple)):
        return v[g]
    if isinstance(v, np.ndarray) and v.ndim and v.shape[-1] == c:
        return torch.as_tensor(np.ascontiguousarray(v[..., lo:hi]),
                               device=dev)
    if isinstance(v, torch.Tensor) and v.ndim and v.shape[-1] == c:
        return v[..., lo:hi].to(dev)
    return v


def make_channel_fanout(fn: Callable, devices: Sequence) -> Callable:
    """Split `fn` over contiguous channel groups, one per device.

    `fn(*args) -> (carry, out)`: the first argument is the (T, C) chunk
    with C independent channels on its last axis; the others are (C,)
    rows (state, valid lengths, per-channel m), per-group lists, or
    values every group shares.  Each group g of C / D channels calls
    `fn` on its slices, moved to `devices[g]`.  The fanned function
    returns `(carries, out)`: `carries` lists the groups' carries (each
    left on its own device) and `out`, a dict of arrays with the channel
    axis last, holds each entry concatenated over the groups on
    `devices[0]`.  C must divide by D (`group_size`).
    """
    devs: List[torch.device] = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_channel_fanout needs at least one device")

    def fanned(x, *rows):
        c = x.shape[-1]
        per = group_size(c, len(devs))
        carries, outs = [], []
        for g, dev in enumerate(devs):
            lo, hi = g * per, (g + 1) * per
            with _on(dev):
                carry, out = fn(*(_part(v, g, lo, hi, c, dev)
                                  for v in (x,) + rows))
            carries.append(carry)
            outs.append(out)
        home = devs[0]
        gathered = {key: torch.cat([o[key].to(home) for o in outs], dim=-1)
                    for key in outs[0]}
        return carries, gathered

    return fanned
