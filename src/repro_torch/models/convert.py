"""Carry LM parameters between the reference's tree and the port's module.

The reference keeps a parameter tree of arrays with each group's blocks
stacked on a leading (n_groups,) axis under "blocks_<j>"; the port keeps
one module per layer (`LM.blocks[g * len(group) + j]`).  Both store
dense weights as (d_in, d_out), so nothing is transposed: the leaves are
copied, unstacked on the way in and stacked on the way out.  Beside
`engine/state.py::engine_state_from_numpy`, this is how a model trained
or initialised by the reference is handed to the port, and how the
tests load one set of weights into both.

Decode caches cross the same way: the reference's
{"cache_<j>": KVCache(k=(n_groups, B, S, KV, D), v=...)} against the
port's list of one `KVCache` per layer.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM, block_layout
from repro_torch.tree import tree_paths

__all__ = ["lm_params_from_numpy", "lm_params_to_numpy",
           "lm_cache_from_numpy", "lm_cache_to_numpy"]


def lm_params_from_numpy(tree, cfg: ModelConfig, device=None) -> LM:
    """An `LM` on `device` (the card unless the caller names another)
    holding the reference-layout tree `tree` (nested dicts of arrays)."""
    from repro_torch.engine.engine import resolve_device
    model = LM(cfg, device=resolve_device(device))
    _, n_groups = block_layout(cfg)
    per = len(model.blocks) // max(n_groups, 1)
    seen = set()
    with torch.no_grad():
        for path, leaf in tree_paths(tree):
            arr = np.asarray(leaf)
            if path[0].startswith("blocks_"):
                j = int(path[0][len("blocks_"):])
                rest = ".".join(path[1:])
                if arr.shape[0] != n_groups:
                    raise ValueError(f"{'/'.join(path)}: leading axis "
                                     f"{arr.shape[0]}, not {n_groups}")
                for g in range(n_groups):
                    name = f"blocks.{g * per + j}.{rest}"
                    _load(model, name, arr[g])
                    seen.add(name)
            else:
                name = ".".join(path)
                _load(model, name, arr)
                seen.add(name)
    missing = [n for n, _ in model.named_parameters() if n not in seen]
    if missing:
        raise KeyError(f"tree lacks {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    return model


def _load(model: LM, name: str, arr: np.ndarray):
    p = model.get_parameter(name)
    if tuple(p.shape) != arr.shape:
        raise ValueError(f"{name}: tree shape {arr.shape}, module shape "
                         f"{tuple(p.shape)}")
    p.copy_(torch.as_tensor(np.array(arr)))


def lm_params_to_numpy(model: LM) -> Dict[str, Any]:
    """The reference-layout tree (nested dicts of numpy arrays, blocks
    stacked per group) of the module's parameters."""
    _, n_groups = block_layout(model.cfg)
    per = len(model.blocks) // max(n_groups, 1)
    out: Dict[str, Any] = {}
    stacks: Dict[tuple, list] = {}
    for name, p in model.named_parameters():
        arr = p.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "blocks":
            g, j = divmod(int(parts[1]), per)
            stacks.setdefault((f"blocks_{j}",) + tuple(parts[2:]),
                              [None] * n_groups)[g] = arr
        else:
            _insert(out, parts, arr)
    for path, arrs in stacks.items():
        _insert(out, list(path), np.stack(arrs))
    return out


def _insert(tree: Dict[str, Any], path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def lm_cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's per-layer caches on `device` (the card unless the
    caller names another) holding the reference-layout cache tree `tree`
    ({"cache_<j>": (k, v)} of (n_groups, B, S, KV, D) arrays, float32 or
    bfloat16, as `np.asarray` gives them)."""
    from repro_torch.engine.engine import resolve_device
    dev = resolve_device(device)
    grp, n_groups = block_layout(cfg)
    if sorted(tree) != sorted(f"cache_{j}" for j in range(len(grp))):
        raise KeyError(f"cache tree has {sorted(tree)}, the layout "
                       f"{len(grp)} block(s) per group")
    caches = []
    for g in range(n_groups):
        for j in range(len(grp)):
            k, v = tree[f"cache_{j}"]
            caches.append(KVCache(k=_tensor(k, n_groups, g, dev),
                                  v=_tensor(v, n_groups, g, dev)))
    return caches


def _tensor(arr, n_groups: int, g: int, dev) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.shape[0] != n_groups:
        raise ValueError(f"cache leading axis {arr.shape[0]}, not "
                         f"{n_groups}")
    part = np.array(arr[g])  # a writable copy
    if part.dtype.name == "bfloat16":  # numpy's extension type: raw words
        t = torch.from_numpy(part.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(part)
    return t.to(dev)


def lm_cache_to_numpy(caches, cfg: ModelConfig) -> Dict[str, Any]:
    """The reference-layout cache tree of the port's per-layer caches:
    {"cache_<j>": KVCache(k, v)} of numpy arrays stacked per group.
    bfloat16 comes back as float32 (exact: numpy has no bfloat16)."""
    grp, n_groups = block_layout(cfg)
    per = len(grp)
    if len(caches) != per * n_groups:
        raise ValueError(f"{len(caches)} caches for {per * n_groups} "
                         "layers")

    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return {f"cache_{j}": KVCache(
        k=np.stack([host(caches[g * per + j].k) for g in range(n_groups)]),
        v=np.stack([host(caches[g * per + j].v) for g in range(n_groups)]))
        for j in range(per)}
