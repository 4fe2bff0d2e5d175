"""Minimal pytree helpers for the training state.

The training state is a nest of dicts, lists, tuples and NamedTuples
with tensors (or other values) at the leaves: the parameter dict, the
optimizer's `OptState` and the guard's `GuardState`.  These helpers walk
it in a fixed order (dict insertion order, then positions and fields),
which is what the optimizer, `apply_guard` and the checkpoint's flat
key list rely on.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_paths"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and of the same-shaped `rest`),
    rebuilding the nest.  None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in walk order; NamedTuple steps are field
    names, dict steps keys, list and tuple steps positions."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_paths(v, prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]
