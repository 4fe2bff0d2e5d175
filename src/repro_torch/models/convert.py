"""Carry parameters and decode caches between the reference's trees and
the port's modules.

The reference keeps a parameter tree of arrays with each group's blocks
stacked on a leading (n_groups,) axis under "blocks_<j>", and the
encoder-decoder's layers on a leading (L,) axis under "enc_blocks" and
"dec_blocks"; the port keeps one module per layer (`LM.blocks[g *
len(group) + j]`, `EncDec.enc_blocks[l]`, `EncDec.dec_blocks[l]`).
zamba2's shared block is one unstacked subtree, "shared/...", on both
sides (the port's `LM.shared`; the "shared" entries of `LM.blocks` hold
no parameters).  Both store dense weights as (d_in, d_out) and expert
weights as (E, d_in, d_out), so nothing is transposed: the leaves are
copied, unstacked on the way in and stacked on the way out.  Beside
`engine/state.py::engine_state_from_numpy`, this is how a model trained
or initialised by the reference is handed to the port, and how the
tests load one set of weights into both.

Decode caches cross the same way: the reference's {"cache_<j>":
Cache(leaf (n_groups, B, ...), ...)} (a `KVCache` for "attn", "moe" and
"shared" blocks, an `SSMCache`, `MLSTMCache` or `SLSTMCache` for the
recurrent ones) against the port's list of one cache per layer; the
encoder-decoder's {"self": KVCache((L, B, S, KV, D), ...), "cross": ...}
against {"self": [KVCache] * L, "cross": [KVCache] * L}.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import LM, block_layout
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache
from repro_torch.tree import tree_paths

__all__ = ["lm_params_from_numpy", "lm_params_to_numpy",
           "lm_cache_from_numpy", "lm_cache_to_numpy",
           "encdec_params_from_numpy", "encdec_params_to_numpy",
           "encdec_cache_from_numpy", "encdec_cache_to_numpy"]

_CACHE_OF = {"attn": KVCache, "moe": KVCache, "shared": KVCache,
             "ssm": SSMCache, "mlstm": MLSTMCache, "slstm": SLSTMCache}
_ENCDEC_STACKS = ("enc_blocks", "dec_blocks")


# ----------------------------------------------------------- parameters
def _load_tree(model, tree, unstack: Callable[[tuple], Optional[List[str]]]):
    """Copy the leaves of `tree` into `model`.  `unstack(path)` names the
    module parameter of each index of a stacked leaf's leading axis, or
    is None for a leaf that maps to one parameter."""
    seen = set()
    with torch.no_grad():
        for path, leaf in tree_paths(tree):
            arr = np.asarray(leaf)
            names = unstack(path)
            if names is None:
                names, parts = [".".join(path)], [arr]
            elif arr.shape[0] != len(names):
                raise ValueError(f"{'/'.join(path)}: leading axis "
                                 f"{arr.shape[0]}, not {len(names)}")
            else:
                parts = list(arr)
            for name, part in zip(names, parts):
                _load(model, name, part)
                seen.add(name)
    missing = [n for n, _ in model.named_parameters() if n not in seen]
    if missing:
        raise KeyError(f"tree lacks {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    return model


def _load(model, name: str, arr: np.ndarray):
    p = model.get_parameter(name)
    if tuple(p.shape) != arr.shape:
        raise ValueError(f"{name}: tree shape {arr.shape}, module shape "
                         f"{tuple(p.shape)}")
    p.copy_(torch.as_tensor(np.array(arr)))


def _to_tree(model, stack_of: Callable[[list], Optional[tuple]]):
    """The nested dict of numpy arrays of the module's parameters.
    `stack_of(name parts)` gives (tree path, index, count) for a
    parameter that is one slice of a stacked leaf, else None."""
    out: Dict[str, Any] = {}
    stacks: Dict[tuple, list] = {}
    for name, p in model.named_parameters():
        arr = p.detach().cpu().numpy()
        parts = name.split(".")
        where = stack_of(parts)
        if where is None:
            _insert(out, parts, arr)
        else:
            path, i, n = where
            stacks.setdefault(path, [None] * n)[i] = arr
    for path, arrs in stacks.items():
        _insert(out, list(path), np.stack(arrs))
    return out


def _insert(tree: Dict[str, Any], path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _groups(model: LM):
    _, n_groups = block_layout(model.cfg)
    return n_groups, len(model.blocks) // max(n_groups, 1)


def lm_params_from_numpy(tree, cfg: ModelConfig, device=None) -> LM:
    """An `LM` on `device` (the card unless the caller names another)
    holding the reference-layout tree `tree` (nested dicts of arrays)."""
    from repro_torch.engine.engine import resolve_device
    model = LM(cfg, device=resolve_device(device))
    n_groups, per = _groups(model)

    def unstack(path):
        if not path[0].startswith("blocks_"):
            return None
        j, rest = int(path[0][len("blocks_"):]), ".".join(path[1:])
        return [f"blocks.{g * per + j}.{rest}" for g in range(n_groups)]

    return _load_tree(model, tree, unstack)


def lm_params_to_numpy(model: LM) -> Dict[str, Any]:
    """The reference-layout tree (nested dicts of numpy arrays, blocks
    stacked per group, the shared block once) of the module's
    parameters."""
    n_groups, per = _groups(model)

    def stack_of(parts):
        if parts[0] != "blocks":
            return None
        g, j = divmod(int(parts[1]), per)
        return (f"blocks_{j}",) + tuple(parts[2:]), g, n_groups

    return _to_tree(model, stack_of)


def encdec_params_from_numpy(tree, cfg: ModelConfig,
                             device=None) -> EncDec:
    """An `EncDec` on `device` (the card unless the caller names
    another) holding the reference's `init_encdec_params` tree."""
    from repro_torch.engine.engine import resolve_device
    model = EncDec(cfg, device=resolve_device(device))
    sizes = {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.dec_layers}

    def unstack(path):
        if path[0] not in sizes:
            return None
        rest = ".".join(path[1:])
        return [f"{path[0]}.{i}.{rest}" for i in range(sizes[path[0]])]

    return _load_tree(model, tree, unstack)


def encdec_params_to_numpy(model: EncDec) -> Dict[str, Any]:
    """The reference-layout tree of an `EncDec` (layers stacked on a
    leading (L,) axis)."""
    sizes = {"enc_blocks": model.cfg.enc_layers,
             "dec_blocks": model.cfg.dec_layers}

    def stack_of(parts):
        if parts[0] not in sizes:
            return None
        return (parts[0],) + tuple(parts[2:]), int(parts[1]), \
            sizes[parts[0]]

    return _to_tree(model, stack_of)


# --------------------------------------------------------------- caches
def _tensor(arr, n: int, i: int, dev) -> torch.Tensor:
    """Slice i of a stacked cache leaf with leading axis n, as a tensor
    on `dev` (bfloat16 stays bfloat16)."""
    arr = np.asarray(arr)
    if arr.shape[0] != n:
        raise ValueError(f"cache leading axis {arr.shape[0]}, not {n}")
    part = np.array(arr[i])  # a writable copy
    if part.dtype.name == "bfloat16":  # numpy's extension type: raw words
        t = torch.from_numpy(part.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(part)
    return t.to(dev)


def _host(t) -> np.ndarray:
    """bfloat16 comes back as float32 (exact: numpy has no bfloat16)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _unstack_cache(typ, stacked, n: int, dev) -> list:
    if len(stacked) != len(typ._fields):
        raise ValueError(f"{typ.__name__} has {len(typ._fields)} fields, "
                         f"the tree {len(stacked)}")
    return [typ(*(_tensor(a, n, i, dev) for a in stacked))
            for i in range(n)]


def _stack_cache(caches) -> tuple:
    typ = type(caches[0])
    return typ(*(np.stack([_host(c[f]) for c in caches])
                 for f in range(len(typ._fields))))


def lm_cache_from_numpy(tree, cfg: ModelConfig, device=None) -> list:
    """The port's per-layer caches on `device` (the card unless the
    caller names another) holding the reference-layout cache tree
    `tree` ({"cache_<j>": a cache NamedTuple of (n_groups, B, ...)
    arrays, float32 or bfloat16, as `np.asarray` gives them})."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)
    grp, n_groups = block_layout(cfg)
    if sorted(tree) != sorted(f"cache_{j}" for j in range(len(grp))):
        raise KeyError(f"cache tree has {sorted(tree)}, the layout "
                       f"{len(grp)} block(s) per group")
    per_j = [_unstack_cache(_CACHE_OF[bd.kind], tree[f"cache_{j}"],
                            n_groups, dev) for j, bd in enumerate(grp)]
    return [per_j[j][g] for g in range(n_groups) for j in range(len(grp))]


def lm_cache_to_numpy(caches, cfg: ModelConfig) -> Dict[str, Any]:
    """The reference-layout cache tree of the port's per-layer caches:
    {"cache_<j>": the cache NamedTuple of numpy arrays stacked per
    group}.  bfloat16 comes back as float32."""
    grp, n_groups = block_layout(cfg)
    per = len(grp)
    if len(caches) != per * n_groups:
        raise ValueError(f"{len(caches)} caches for {per * n_groups} "
                         "layers")
    return {f"cache_{j}": _stack_cache([caches[g * per + j]
                                        for g in range(n_groups)])
            for j in range(per)}


def encdec_cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's {"self": [KVCache], "cross": [KVCache]} on `device`
    (the card unless the caller names another) holding the reference's
    {"self": KVCache((L, B, S, KV, D), ...), "cross": ...}."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)
    if sorted(tree) != ["cross", "self"]:
        raise KeyError(f"encoder-decoder cache tree has {sorted(tree)}")
    return {k: _unstack_cache(KVCache, tree[k], cfg.dec_layers, dev)
            for k in ("self", "cross")}


def encdec_cache_to_numpy(caches, cfg: ModelConfig) -> Dict[str, Any]:
    """The reference layout of the port's encoder-decoder caches:
    {"self": KVCache, "cross": KVCache} of (L, B, S, KV, D) arrays."""
    for k in ("self", "cross"):
        if len(caches[k]) != cfg.dec_layers:
            raise ValueError(f"{len(caches[k])} {k} caches for "
                             f"{cfg.dec_layers} decoder layers")
    return {k: _stack_cache(caches[k]) for k in ("self", "cross")}
