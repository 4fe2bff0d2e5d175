"""Activation-sharding hints (Megatron-style sequence parallelism).

The port's counterpart of the JAX package's `sharding/hints.py`.  DTensor
propagates the parameters' placements through the step the way GSPMD
propagates shardings, and the residual stream (B, S, D) can end up
batch-only sharded, replicated across the `model` axis.  The hint is a
redistribution of the residual between blocks (`DTensor.redistribute`
where the reference calls `with_sharding_constraint`): batch over the
data-parallel axes, and with sequence parallelism the sequence over
"model".

Model code stays mesh-agnostic: it calls `maybe_shard(x, "residual")`,
a no-op unless the caller installed a context with
`activation_hints(mesh, sp=...)` (a contextvar) and x is a DTensor.

The model's sharded work is laid out here as GSPMD lays out the
reference's, on local shards with each redistribution explicit, so that
DTensor's own strategy choices (which replicated attention on every
"model" rank and reduced activations over "data") decide nothing:
`matmul` (the dense products: FSDP weights gathered where used,
tensor-parallel splits kept), `HeadSplit` / `RowSplit` (attention over
its heads, or over its query rows where the heads do not split),
`CacheSplit` (the one-token decode on the KV cache's own split),
`lookup` and `vocab_parallel_ce` (the embedding and the CE over a
vocab-split table and logits).  `ViewResharding` is the last resort for
a view DTensor refuses, and records each use.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.rules import Spec, dp_axes, placements

__all__ = ["activation_hints", "sp_enabled", "residual_spec", "maybe_shard",
           "lookup", "write_slot", "matmul", "summed",
           "rows_reshape", "batch_split", "UnitSplit", "unit_split_of",
           "ExpertSplit", "HeadSplit",
           "head_split", "RowSplit", "row_split", "CacheSplit",
           "cache_split", "vocab_split", "vocab_parallel_ce",
           "ViewResharding"]

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_hints", default=None)


class _Hints:
    def __init__(self, mesh, sp: bool):
        self.mesh, self.sp = mesh, sp


@contextlib.contextmanager
def activation_hints(mesh, sp: bool = True):
    """Install residual hints for `mesh` (a `launch/mesh.py::Mesh`)."""
    tok = _CTX.set(_Hints(mesh, sp))
    try:
        yield
    finally:
        _CTX.reset(tok)


def sp_enabled() -> bool:
    h = _CTX.get()
    return bool(h and h.sp)


def residual_spec(mesh, shape, sp: bool) -> Spec:
    """The reference's residual spec for a (B, S, D) activation: batch
    over the dp axes when they divide it (else over "data", else
    replicated); with `sp`, the sequence over "model" when it divides
    into more than one piece."""
    b, s, _ = shape
    sizes = dict(mesh.shape)
    msz = sizes.get("model", 1)
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    if dp_total > 1 and b % dp_total == 0:
        bspec = dp[0] if len(dp) == 1 else dp
    elif b % sizes.get("data", 1) == 0 and sizes.get("data", 1) > 1:
        bspec = "data"
    else:
        bspec = None
    if sp and s % msz == 0 and s > msz:
        return (bspec, "model", None)
    return (bspec, None, None)


def maybe_shard(x, kind: str = "residual"):
    """Redistribute x to the spec for `kind` when hints are active and x
    is a DTensor; otherwise return x as it is."""
    from torch.distributed.tensor import DTensor

    h: Optional[_Hints] = _CTX.get()
    if h is None or not isinstance(x, DTensor):
        return x
    if kind == "residual" and x.ndim == 3:
        spec = residual_spec(h.mesh, tuple(x.shape), h.sp)
        return x.redistribute(x.device_mesh, placements(h.mesh, spec))
    return x


def lookup(table, ids, dtype=None):
    """`F.embedding(ids, table).to(dtype)` (`dtype` None: the table's).
    A DTensor table split along its rows
    (the vocab) is looked up shard by shard, as GSPMD splits a gather:
    each rank reads the ids that fall in its rows (zeros for the
    others) and the partial rows are summed over the vocab split, in
    `dtype` (one nonzero term: the sum is exact).  The table's
    columns are gathered first, so the rows come out split as the ids
    are.  (DTensor's own lookup over vocab-split rows leaves a masked
    partial sum whose mask dies at its first reduction and whose
    backward DTensor cannot redistribute.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.nn import functional as F

    dtype = dtype or table.dtype
    if not isinstance(table, DTensor):
        return F.embedding(ids, table).to(dtype)
    mesh, tp = table.device_mesh, table.placements
    vocab = [p.is_shard(0) for p in tp]
    if not any(vocab):
        return F.embedding(ids, table.redistribute(mesh, [
            Replicate() if p.is_shard() else p for p in tp])).to(dtype)
    table = table.redistribute(mesh, [
        Shard(0) if v else Replicate() for v in vocab])
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids = ids.redistribute(mesh, [
        Replicate() if v or not p.is_shard() else p
        for v, p in zip(vocab, ids.placements)])
    (rows, _), (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    local = ids.to_local() - lo
    hit = (local >= 0) & (local < rows)
    # the table's gradient: summed over the axes that split the ids
    grad = [Shard(0) if v else Partial() if p.is_shard() else Replicate()
            for v, p in zip(vocab, ids.placements)]
    out = F.embedding(torch.where(hit, local, 0),
                      table.to_local(grad_placements=grad))
    out = (out * hit[..., None].to(out.dtype)).to(dtype)
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(
        out, mesh, [Partial() if v else p for v, p in zip(
            vocab, ids.placements)], run_check=False, shape=shape,
        stride=_stride(shape))
    return out.redistribute(mesh, [Replicate() if v else p for v, p in
                                   zip(vocab, out.placements)])


def _stride(shape) -> tuple:
    """The strides of a contiguous tensor of `shape`."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _view_shape(old, new) -> torch.Size:
    """The shape a view of a tensor of shape `old` to `new` has (`new`
    may hold one -1), worked out without making a tensor (one made
    under an op counter would count as live bytes)."""
    new = list(new)
    if -1 in new:
        known = math.prod(n for n in new if n != -1)
        new[new.index(-1)] = math.prod(old) // known if known else 0
    return torch.Size(new)


def _mesh_axis(t, name: str):
    """The index of mesh axis `name` of DTensor `t` when it splits into
    more than one piece, else None."""
    names = t.device_mesh.mesh_dim_names or ()
    if name not in names:
        return None
    i = names.index(name)
    return i if t.device_mesh.size(i) > 1 else None


def _is_dp(t, i: int) -> bool:
    names = t.device_mesh.mesh_dim_names or ()
    return i < len(names) and names[i] in ("pod", "data")


def matmul(x, w):
    """`x @ w` for x (..., d_in) and w (d_in, d_out), one of them a
    DTensor, placed as GSPMD places the product and computed on the
    local shards, so that neither the product nor its backward is left
    to DTensor's choice of strategy.  Per mesh axis:

    - w split on d_in (the contraction): kept where x is split on its
      last dim (the product is a partial sum over the axis), or where
      x is whole on a non-data axis (x is then split there, a local
      slice: the Megatron row-parallel product); gathered where x is
      split on a leading dim (FSDP: the weight is gathered where it is
      used, the activations keep their batch split);
    - w split on d_out: kept where x is whole (the output is split on
      its last dim: column-parallel; x's gradient is a partial sum
      over the axis); gathered where x is split on a leading dim; x
      gathered where it is split on its last dim;
    - w whole: x split on a leading dim keeps the split (w's gradient
      is a partial sum over the axis); x split on its last dim splits
      w's d_in there (a local slice).

    A pending sum of x is reduced first.  A plain operand is read as
    replicated.  Returns a DTensor; its pending sums are left to the
    caller (`summed`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    last = x.ndim - 1
    xp = [Replicate() if p.is_partial() else p for p in x.placements]
    wp = [Replicate() if p.is_partial() else p for p in w.placements]
    yp, xg, wg = [], [], []
    for i in range(mesh.ndim):
        a, b = xp[i], wp[i]
        if b.is_shard(0) and not a.is_shard(last):
            if a.is_replicate() and not _is_dp(w, i):
                a = Shard(last)
            else:
                b = Replicate()
        elif b.is_shard(1) and a.is_shard():
            if a.is_shard(last):
                a = Replicate()
            else:
                b = Replicate()
        elif b.is_replicate() and a.is_shard(last):
            b = Shard(0)
        xp[i], wp[i] = a, b
        if b.is_shard(0):  # a is Shard(last)
            yp.append(Partial())
            xg.append(a)
            wg.append(b)
        elif b.is_shard(1):  # a is whole
            yp.append(Shard(last))
            xg.append(Partial())
            wg.append(b)
        else:  # b is whole; a whole or split on a leading dim
            yp.append(a)
            xg.append(a)
            wg.append(Partial() if a.is_shard() else b)
    xl = x.redistribute(mesh, xp).to_local(grad_placements=xg)
    wl = w.redistribute(mesh, wp).to_local(grad_placements=wg)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    return DTensor.from_local(xl @ wl, mesh, yp, run_check=False,
                              shape=shape, stride=_stride(shape))


def summed(y):
    """A DTensor's pending sums reduced (an all-reduce), in its own
    dtype: a row-parallel product's output before anything else reads
    it, as GSPMD reduces a dot's partial sums."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(y, DTensor) or not any(
            p.is_partial() for p in y.placements):
        return y
    return y.redistribute(y.device_mesh, [
        Replicate() if p.is_partial() else p for p in y.placements])


def rows_reshape(x, shape):
    """`x.reshape(shape)` taken on the local shard for a DTensor x split
    on its leading dim alone (or whole), when the old and the new
    leading dim both split evenly: each rank's block of the flat array
    is then whole rows of both shapes, and the split stays on the
    leading dim.  DTensor's own view rule mis-sizes such a view when a
    gradient arrives split over two axes (a local (256, 4096) shard of
    (65536, 4096) read as (1, 4096, 4096)).  Anything else goes to
    `reshape` as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not all(
            p.is_replicate() or p.is_shard(0) for p in x.placements):
        return x.reshape(shape)
    shape = _view_shape(x.shape, shape)
    n = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                  if p.is_shard(0))
    if x.shape[0] % n or shape[0] % n:
        return x.reshape(shape)
    out = x.to_local().reshape((shape[0] // n,) + tuple(shape[1:]))
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=_stride(shape))


class HeadSplit:
    """Attention's heads split over the "model" axis, the layout GSPMD
    gives the reference's attention: each rank holds `n` whole query
    heads and the KV heads they read, `kv` (a slice of
    the KV heads: `n // g` of them when a rank holds whole groups of g,
    else the one its heads share).  q and the output (B, S, h * hd) are
    split on their last dim over "model", K and V (B, Sk, kvh * hd)
    gathered over it (their gradient a partial sum over it, reduced
    back onto their split); every other axis keeps the batch split of q
    (or replicates).  The caller computes on the local tensors
    (`local`) and wraps its output back (`wrap`)."""

    def __init__(self, q, mi: int, n_heads: int, n_kv: int):
        from torch.distributed.tensor import Partial, Replicate, Shard

        self.mesh = q.device_mesh
        batch = [Shard(0) if p.is_shard(0) and i != mi else Replicate()
                 for i, p in enumerate(q.placements)]
        self.q_place = batch[:mi] + [Shard(2)] + batch[mi + 1:]
        self.kv_place = batch
        self.kv_grad = batch[:mi] + [Partial()] + batch[mi + 1:]
        msz = self.mesh.size(mi)
        g = n_heads // n_kv
        self.n = n_heads // msz
        lo = self.mesh.get_local_rank(mi) * self.n  # the first local head
        self.kv = slice(lo // g, (lo + self.n - 1) // g + 1)

    def local(self, t, kv: bool = False):
        """This rank's share of q (kv False) or of K or V (kv True)."""
        if kv:
            return t.redistribute(self.mesh, self.kv_place).to_local(
                grad_placements=self.kv_grad)
        return t.redistribute(self.mesh, self.q_place).to_local()

    def wrap(self, out, shape):
        """The local output (B_l, S, n * hd) as the DTensor (B, S, h *
        hd) split like q."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(out, self.mesh, self.q_place,
                                  run_check=False, shape=shape,
                                  stride=_stride(shape))


def head_split(q, n_heads: int, n_kv: int) -> Optional[HeadSplit]:
    """The `HeadSplit` of a DTensor q on a mesh whose "model" axis has
    more than one rank, when the heads split evenly over it in whole
    heads, each rank's heads in whole KV groups or within one; else
    None (q is then computed on as it is)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return None
    mi = _mesh_axis(q, "model")
    if mi is None:
        return None
    msz = q.device_mesh.size(mi)
    g = n_heads // max(n_kv, 1)
    if n_heads % msz or n_kv * g != n_heads:
        return None
    n = n_heads // msz
    if n % g and g % n:
        return None
    return HeadSplit(q, mi, n_heads, n_kv)


class RowSplit:
    """Attention's queries split over the "model" axis where its heads
    do not split evenly over it: each rank of the axis attends with
    two blocks of S / (2 m) query rows, block r and block 2m - 1 - r
    (m ranks; the pair balances causal work), over every head, with q,
    K and V gathered whole over the axis (`local`: their gradients
    partial sums over it).  The output projection runs on the rank's
    rows with its weight gathered (`weight`), and the rows go back as a
    partial sum over the axis, reduced (`wrap`).  Every other axis
    keeps the batch split of q (or replicates)."""

    def __init__(self, q, mi: int, seq: int):
        from torch.distributed.tensor import Partial, Replicate, Shard

        self.mesh, self.mi = q.device_mesh, mi
        self.batch = [Shard(0) if p.is_shard(0) and i != mi else Replicate()
                      for i, p in enumerate(q.placements)]
        self.grad = self.batch[:mi] + [Partial()] + self.batch[mi + 1:]
        m = self.mesh.size(mi)
        r = self.mesh.get_local_rank(mi)
        n = seq // (2 * m)
        self.blocks = ((r * n, (r + 1) * n),
                       ((2 * m - 1 - r) * n, (2 * m - r) * n))

    def local(self, t):
        """t whole over the axis, batch split."""
        return t.redistribute(self.mesh, self.batch).to_local(
            grad_placements=self.grad)

    def weight(self, w):
        """A weight whole on this rank (its gradient a partial sum over
        the axis and over the batch's split)."""
        from torch.distributed.tensor import Partial, Replicate

        whole = [Replicate()] * self.mesh.ndim
        return w.redistribute(self.mesh, whole).to_local(grad_placements=[
            Partial() if b.is_shard() or i == self.mi else b
            for i, b in enumerate(self.batch)])

    def wrap(self, rows, shape):
        """The blocks' local rows (B_l, S / (2 m), ...) each, in
        `blocks` order, as the (B, S, ...) DTensor they sum to."""
        from torch.distributed.tensor import DTensor, Partial

        (a0, a1), (b0, b1) = self.blocks

        def gap(n):
            return rows[0].new_zeros((rows[0].shape[0], n)
                                     + tuple(rows[0].shape[2:]))

        full = torch.cat([gap(a0), rows[0], gap(b0 - a1), rows[1],
                          gap(shape[1] - b1)], dim=1)
        place = self.batch[:self.mi] + [Partial()] + self.batch[self.mi + 1:]
        return summed(DTensor.from_local(
            full, self.mesh, place, run_check=False, shape=shape,
            stride=_stride(shape)))


def row_split(q, seq: int, q_chunk: int) -> Optional[RowSplit]:
    """The `RowSplit` of a DTensor q (B, S, h * hd) on a mesh whose
    "model" axis has more than one rank, when S splits into 2 m blocks
    that divide into query chunks of min(q_chunk, block); else None."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return None
    mi = _mesh_axis(q, "model")
    if mi is None:
        return None
    m = q.device_mesh.size(mi)
    n = seq // (2 * m)
    if n == 0 or seq % (2 * m) or n % min(q_chunk, n):
        return None
    return RowSplit(q, mi, seq)


class CacheSplit:
    """The one-token decode over a DTensor KV cache (B, S, KV, D), on
    the cache's own split (the reference's rule: batch over the data
    axes, the sequence over "data" for a tiny batch, D or else KV over
    "model").  q, K and V of the new token are gathered whole on each
    rank, batch split as the cache's batch (`local`); the scores are
    taken on the local cache, a partial sum where D is split, summed
    and gathered along S (`scores`); the weighted sum over the local
    slots is a partial sum where S is split (`values`).  The (B, 1,
    h * hd) output is batch split as the cache (`wrap`)."""

    def __init__(self, cache):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        self.mesh = cache.device_mesh
        pl = cache.placements
        self.batch = [Shard(0) if p.is_shard(0) else Replicate()
                      for p in pl]
        shape, off = compute_local_shape_and_global_offset(
            cache.shape, self.mesh, pl)
        self.s, self.kv, self.d = (slice(off[i], off[i] + shape[i])
                                   for i in (1, 2, 3))
        # scores (B, KV, G, S) and the output (B, KV, G, D) by the
        # cache's split of each dim
        to_scores = {0: Shard(0), 1: Shard(3), 2: Shard(1), 3: Partial()}
        to_out = {0: Shard(0), 1: Partial(), 2: Shard(1), 3: Shard(3)}
        self.scores_place = [to_scores[p.dim] if p.is_shard() else
                             Replicate() for p in pl]
        self.scores_whole = [p if p.is_shard(0) or p.is_shard(1) else
                             Replicate() for p in self.scores_place]
        self.out_place = [to_out[p.dim] if p.is_shard() else Replicate()
                          for p in pl]

    def local(self, t):
        """The whole of t on each rank but its batch split."""
        return t.redistribute(self.mesh, self.batch).to_local()

    def _dt(self, local, place, shape):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, place, run_check=False,
                                  shape=shape, stride=_stride(shape))

    def scores(self, local, shape):
        """Local scores (B_l, KV_l, G, S_l) -> (B_l, KV_l, G, S): summed
        over a split D, gathered over a split S."""
        return self._dt(local, self.scores_place, shape).redistribute(
            self.mesh, self.scores_whole).to_local()

    def values(self, local, shape):
        """The local weighted sum (B_l, KV_l, G, D_l) -> (B_l, KV, G, D):
        summed over a split S, gathered over a split KV and D."""
        return self._dt(local, self.out_place, shape).redistribute(
            self.mesh, self.batch).to_local()

    def wrap(self, local, shape):
        return self._dt(local, self.batch, shape)


def cache_split(cache) -> Optional[CacheSplit]:
    """The `CacheSplit` of a DTensor cache on a mesh whose "model" axis
    has more than one rank, else None."""
    from torch.distributed.tensor import DTensor

    if not isinstance(cache, DTensor) or _mesh_axis(cache, "model") is None:
        return None
    return CacheSplit(cache)


def batch_split(x):
    """A DTensor x with its batch (dim 0) split kept on every axis but
    "model" and every other split or pending sum gathered (a sequence
    split over "model" included, as Megatron gathers it before its
    MLP); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mi = _mesh_axis(x, "model")
    return x.redistribute(x.device_mesh, [
        Shard(0) if p.is_shard(0) and i != mi else Replicate()
        for i, p in enumerate(x.placements)])


class UnitSplit:
    """Recurrent work whose heads do not split over "model" (xLSTM's 4
    heads over 16 ranks), split there by (batch row, head) units: each
    unit's recurrence is independent of the others', so each rank of
    "model" runs its share of the units of its batch rows on plain
    local tensors, and nothing is exchanged inside the loop.  `rows`
    and `heads` index this rank's units (batch row, head); where the
    units do not fill the axis, f ranks share each unit and each
    contributes 1 / f (`scale`).

    - `gather`: a DTensor activation or state whole over every axis but
      its batch split, local (its gradient a partial sum over "model");
    - `weight`: a weight whole, local (its gradient a partial sum over
      the batch split and "model");
    - `wrap`: a local (B_l, ...) tensor holding this rank's units (zeros
      elsewhere) as the DTensor it sums to over "model", still pending;
    - `write`: such a tensor into a DTensor state of any split, in place.
    """

    def __init__(self, x, n_heads: int):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        self.mesh = mesh = x.device_mesh
        mi = _mesh_axis(x, "model")
        self.batch = [Shard(0) if p.is_shard(0) and i != mi else Replicate()
                      for i, p in enumerate(x.placements)]
        self.pending = [Partial() if i == mi else p
                        for i, p in enumerate(self.batch)]
        self.weight_grad = [Partial() if i == mi or p.is_shard() else p
                            for i, p in enumerate(self.batch)]
        rows = compute_local_shape_and_global_offset(
            x.shape, mesh, self.batch)[0][0]
        n = rows * n_heads
        m = mesh.size(mi) if mi is not None else 1
        r = mesh.get_local_rank(mi) if mi is not None else 0
        if n % m == 0:
            per, first, self.scale = n // m, r * (n // m), 1.0
        elif m % n == 0:
            per, first, self.scale = 1, r * n // m, n / m
        else:
            per, first, self.scale = n, 0, 1.0 / m
            _record_fallback("xlstm.UnitSplit", x, "*")
        dev = x.to_local().device
        u = torch.arange(first, first + per, device=dev)
        self.rows, self.heads = u // n_heads, u % n_heads

    def gather(self, t):
        return t.redistribute(self.mesh, self.batch).to_local(
            grad_placements=self.pending)

    def weight(self, w):
        from torch.distributed.tensor import Replicate

        return w.redistribute(self.mesh, [Replicate()] * self.mesh.ndim
                              ).to_local(grad_placements=self.weight_grad)

    def wrap(self, local, shape):
        from torch.distributed.tensor import DTensor

        if self.scale != 1.0:
            local = local * self.scale
        return DTensor.from_local(local, self.mesh, self.pending,
                                  run_check=False, shape=shape,
                                  stride=_stride(shape))

    def write(self, dst, local):
        src = self.wrap(local, dst.shape).redistribute(self.mesh,
                                                       dst.placements)
        dst.to_local().copy_(src.to_local())


def unit_split_of(x, n_heads: int) -> Optional[UnitSplit]:
    """The `UnitSplit` of a DTensor x, else None."""
    from torch.distributed.tensor import DTensor

    return UnitSplit(x, n_heads) if isinstance(x, DTensor) else None


class ExpertSplit:
    """The MoE's dispatch on local shards, as GSPMD splits the
    reference's.  The tokens xf (T, d) come split on their rows over
    the data-parallel axes (the "token axes") and whole over "model";
    they are routed in blocks of `block` tokens, each block's routes
    over all of its tokens, as the reference's capacity is.

    - A rank whose tokens are whole blocks routes them alone.  A block
      whose tokens lie on the ranks of the innermost token axes (the
      "gather axes"; or on f consecutive ranks of the innermost one,
      split for it into (n / f, f) on a derived mesh, `_split_axis`) is
      gathered there, its router logits (T_b, E) float32 and its
      tokens, and each of those ranks builds an even share of every
      expert's capacity slots (`slots`; a share may run past the
      capacity: padding, zero).  Anything else gathers every token on
      every rank, each taking a share of every block's slots, and is
      recorded as a view fallback.
    - Over "model" the experts split as the expert weights are: on E
      (expert-parallel) or on d_ff (tensor-parallel); either way each
      rank's output is a partial sum.  The weights' other splits (FSDP)
      are gathered where they are used (`weight`), their gradients a
      partial sum over the token axes, reduced back onto their split.
    - `output` sums the ranks' (rows, d) contributions onto the tokens'
      own split; `mean` gives an aux value's mean over every block."""

    def __init__(self, xf, wi, block: int, n_experts: int):
        from torch.distributed.tensor import DTensor

        self.experts = slice(0, n_experts)
        self.home = self.mesh = mesh = xf.device_mesh
        self.inner = None  # the home axis split for the derived mesh
        tok = [i for i, p in enumerate(xf.placements)
               if p.is_shard(0) and mesh.size(i) > 1]
        rows = xf.shape[0]
        for i in tok:
            rows //= mesh.size(i)
        # the gather axes: none where the local rows are whole blocks,
        # else the innermost token axes that hold one block between them
        self.gather = None
        for j in range(len(tok) + 1):
            n = rows
            for i in tok[j:]:
                n *= mesh.size(i)
            if n % block == 0 and (n == block or j == len(tok)):
                self.gather = tok[j:]
                break
        f = block // rows
        if (self.gather is None and tok and block % rows == 0
                and mesh.size(tok[-1]) % f == 0):
            self.inner = tok[-1]
            self.mesh = mesh = _split_axis(mesh, self.inner, f)
            tok = tok + [self.inner + 1]
            self.gather = [self.inner + 1]
        if self.gather is None:
            self.gather = tok
            _record_fallback("moe.ExpertSplit", xf, "*")
        self.tok = tok
        self.mi = _mesh_axis(self._moved(xf), "model")
        self.n_gather, self.index = 1, 0
        for i in self.gather:
            self.n_gather *= mesh.size(i)
            self.index = self.index * mesh.size(i) + mesh.get_local_rank(i)
        self.n_blocks = rows * self.n_gather // block
        self.share = self.n_blocks * block / xf.shape[0]
        wp = (self._moved(wi).placements[self.mi] if self.mi is not None
              and isinstance(wi, DTensor) else None)
        self.split = bool(wp and wp.is_shard())
        if wp is not None and wp.is_shard(0):  # expert-parallel
            n = n_experts // mesh.size(self.mi)
            lo = mesh.get_local_rank(self.mi) * n
            self.experts = slice(lo, lo + n)

    def _moved(self, t, home: bool = False):
        """A DTensor of the home mesh on the derived one (`home`: back),
        the same local tensor: the split axis's placement is both of
        its parts'."""
        from torch.distributed.tensor import DTensor

        if self.inner is None:
            return t
        i, pl = self.inner, list(t.placements)
        pl = pl[:i] + pl[i + 1:] if home else pl[:i + 1] + pl[i:]
        return DTensor.from_local(
            t.to_local(), self.home if home else self.mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    def _place(self, gather, tok, model, other="R"):
        from torch.distributed.tensor import Partial, Replicate, Shard

        kinds = {"P": Partial(), "R": Replicate(), "S": Shard(0)}
        return [kinds[gather if i in self.gather else tok if i in self.tok
                      else model if i == self.mi else other]
                for i in range(self.mesh.ndim)]

    def rows(self, t):
        """A (T, ...) DTensor's rows of this rank's blocks, local, whole
        over "model" (their gradient a partial sum over the gather axes
        and, when the experts split, over "model")."""
        return self._moved(t).redistribute(
            self.mesh, self._place("R", "S", "R")).to_local(
                grad_placements=self._place(
                    "P", "S", "P" if self.split else "R"))

    def weight(self, w):
        """An expert weight (E, d_in, d_out), local: its "model" split
        kept, every other split gathered."""
        from torch.distributed.tensor import Partial, Replicate

        w = self._moved(w)
        keep = [p if i == self.mi else Replicate()
                for i, p in enumerate(w.placements)]
        grad = [p if i == self.mi else Partial() if i in self.tok
                else Replicate() for i, p in enumerate(keep)]
        return w.redistribute(self.mesh, keep).to_local(grad_placements=grad)

    def slots(self, cap: int) -> slice:
        """This rank's share of each expert's `cap` slots."""
        n = -(-cap // self.n_gather)
        return slice(self.index * n, (self.index + 1) * n)

    def output(self, contrib, shape):
        """The rows' contributions (float32, local) summed over the
        ranks: the (T, d) DTensor split as the tokens."""
        from torch.distributed.tensor import DTensor

        out = DTensor.from_local(
            contrib, self.mesh, self._place(
                "P", "S", "P" if self.split else "R"),
            run_check=False, shape=shape, stride=_stride(shape))
        return self._moved(out.redistribute(
            self.mesh, self._place("S", "S", "R")), home=True)

    def mean(self, v, same: bool = False):
        """The mean over every block of an aux value, from this rank's
        blocks' values `v` (stacked), replicated.  With `same` v is
        equal on every rank of a block; else each of them computed it
        from the gathered logits, whose gradient they share."""
        from torch.distributed.tensor import DTensor, Replicate

        n = 1 if same else self.n_gather * (
            self.mesh.size(self.mi) if self.split else 1)
        part = "R" if same else "P"
        place = self._place(part, "P", part if self.split else "R")
        return self._moved(DTensor.from_local(
            v.mean() * self.share / n, self.mesh, place, run_check=False,
            shape=(), stride=()).redistribute(
                self.mesh, [Replicate()] * self.mesh.ndim), home=True)


def _split_axis(mesh, axis: int, f: int):
    """`mesh` with axis `axis` of n ranks split into (n / f, f): the
    same ranks, the inner f consecutive ones of the axis a new axis of
    the axis's name (the outer one gets "_blocks"); made once per mesh
    and kept on it (every rank makes its groups in the same order)."""
    from torch.distributed.device_mesh import DeviceMesh

    made = mesh.__dict__.setdefault("_split_axes", {})
    if (axis, f) not in made:
        names = list(mesh.mesh_dim_names)
        shape = list(mesh.mesh.shape)
        made[axis, f] = DeviceMesh(
            mesh.device_type, mesh.mesh.reshape(
                shape[:axis] + [shape[axis] // f, f] + shape[axis + 1:]),
            mesh_dim_names=tuple(names[:axis] + [names[axis] + "_blocks"]
                                 + names[axis:]))
    return made[axis, f]


def vocab_split(logits) -> bool:
    """Whether `logits` is a DTensor split on its last dim (the vocab)
    over an axis of more than one rank."""
    from torch.distributed.tensor import DTensor

    return isinstance(logits, DTensor) and any(
        p.is_shard(logits.ndim - 1) and logits.device_mesh.size(i) > 1
        for i, p in enumerate(logits.placements))


def vocab_parallel_ce(logits, tgt):
    """Per-token logsumexp(logits) - logits[tgt] of vocab-split logits
    (..., V), without gathering them: on each rank the max, the sum of
    exponentials and the gold logit (zero off its rows) over its vocab
    shard, then a max and two sums over the vocab split (all-reduces of
    (...)-shaped tensors).  The max is a constant of the gradient.
    Returns a (...) float32 DTensor split as tgt's leading dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [p.is_shard(last) for p in logits.placements]
    lead = [Shard(p.dim) if p.is_shard() and p.dim < last and not v
            else Replicate() for v, p in zip(vocab, logits.placements)]
    logits = logits.redistribute(mesh, [Shard(last) if v else p for v, p in
                                        zip(vocab, lead)])
    if not isinstance(tgt, DTensor):
        tgt = DTensor.from_local(tgt, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    tgt = tgt.redistribute(mesh, lead)
    rows, lo = (t[last] for t in compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements))
    lg = logits.to_local().float()
    t = tgt.to_local() - lo
    shape = tuple(tgt.shape)

    def over_vocab(local, op):
        part = DTensor.from_local(
            local, mesh, [op if v else p for v, p in zip(vocab, lead)],
            run_check=False, shape=shape, stride=_stride(shape))
        return part.redistribute(mesh, lead).to_local()

    m = over_vocab(lg.detach().amax(dim=-1), Partial("max"))
    se = over_vocab(torch.exp(lg - m[..., None]).sum(dim=-1), Partial())
    hit = (t >= 0) & (t < rows)
    gold = lg.gather(-1, torch.where(hit, t, 0)[..., None])[..., 0]
    gold = over_vocab(torch.where(hit, gold, 0.0), Partial())
    return DTensor.from_local(m + torch.log(se) - gold, mesh, lead,
                              run_check=False, shape=shape,
                              stride=_stride(shape))


_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default}


def _touched(old, new) -> range:
    """The dims of shape `old` that a view to `new` splits or merges:
    those between the longest common prefix and suffix."""
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while (hi < min(len(old), len(new)) - lo
           and old[len(old) - 1 - hi] == new[len(new) - 1 - hi]):
        hi += 1
    return range(lo, len(old) - hi)


def write_slot(cache, slot, value):
    """`cache[:, slot] = value` in place: `cache` (B, S, ...), `slot` a
    1-element index tensor, `value` (B, 1, ...).  A DTensor cache is
    written shard by shard (DTensor has no sharding rule for
    `index_copy_` in every torch release): `value` is placed as the
    cache is, and a cache split along S writes the slot in the shard
    that holds it (a select over its positions, no host sync)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot, value)
        return
    place = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, cache.device_mesh,
                                   [Replicate()] * len(place),
                                   run_check=False)
    v = value.redistribute(cache.device_mesh, place).to_local()
    local = cache.to_local()
    if not any(p.is_shard(1) for p in cache.placements):
        local.index_copy_(1, slot, v)
        return
    _, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    where = torch.arange(local.shape[1], device=local.device) + offset[1]
    hit = (where == slot).reshape((1, -1) + (1,) * (local.ndim - 2))
    local.copy_(torch.where(hit, v, local))


# DTensor's refusals of a view its shards cannot follow ("Cannot
# unflatten unevenly sharded tensor", "Attempted to flatten multiple
# dimensions ... without redistribution", "Attempted to split the
# sharded dimension ...": the wording differs between torch releases)
_VIEW_REFUSALS = ("unevenly sharded", "without redistribution",
                  "redistribute the tensor")


def _refused(e: RuntimeError) -> bool:
    return any(m in str(e) for m in _VIEW_REFUSALS)


def _record_fallback(what: str, x, dims):
    """Note a layout that falls back to gathering `x` in the innermost
    active `ViewResharding`'s record (a warning where none is active)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, ViewResharding):
            mode.record.append((what, tuple(x.shape),
                                tuple(map(str, x.placements)), dims))
            return
    import warnings
    warnings.warn(f"{what}: {tuple(x.shape)} {x.placements} gathered on "
                  f"every rank")


def _replicated(x, dims=None):
    """x with its shards on `dims` (every dim when None), and then its
    pending sums, replicated."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if (p.is_shard() and (dims is None or p.dim in dims))
        or (dims is None and p.is_partial()) else p for p in x.placements])


class ViewResharding(TorchDispatchMode):
    """A last resort for views of a DTensor that its shards cannot
    follow (the reference's GSPMD reshards them; DTensor refuses:
    "Cannot unflatten unevenly sharded tensor", e.g. 8 KV heads x 64
    split from a dim of 512 over 16 shards, or a flatten across a
    sharded dim): they are retried with the split or merged dims
    replicated, and each retry is recorded in `record` (op, the
    DTensor's global shape, its placements, the dims replicated; "*"
    where a composite op's arguments were replicated whole).  The model's
    own sharded paths (`matmul`, `HeadSplit`, `RowSplit`, `CacheSplit`,
    `lookup`, `vocab_parallel_ce`) lay their tensors out so that none
    is needed.  A composite op whose decomposition meets such a view
    inside DTensor (an einsum's reshapes) is decomposed here, so that
    its views are retried the same way (without a decomposition its
    DTensor arguments are replicated).  A dispatch mode, so that it
    also holds in the backward's recomputation of a checkpointed
    block."""

    def __init__(self, record: Optional[list] = None):
        super().__init__()
        self.record = [] if record is None else record

    def _note(self, func, x, dims):
        self.record.append((str(func), tuple(x.shape),
                            tuple(map(str, x.placements)), dims))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if not _refused(e):
                raise
        if func in _VIEWS and isinstance(args[0], DTensor):
            x = args[0]
            new = _view_shape(x.shape, args[1])
            dims = _touched(tuple(x.shape), tuple(new))
            self._note(func, x, tuple(dims))
            return func(_replicated(x, dims), *args[1:], **kwargs)
        # a composite op: its decomposition's views pass through a mode
        # of their own; without one, its arguments are replicated
        with ViewResharding(self.record):
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        for a in args:
            if isinstance(a, DTensor):
                self._note(func, a, "*")
        args = [_replicated(a) if isinstance(a, DTensor) else a
                for a in args]
        return func(*args, **kwargs)
