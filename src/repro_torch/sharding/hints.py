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
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.rules import Spec, dp_axes, placements

__all__ = ["activation_hints", "sp_enabled", "residual_spec", "maybe_shard",
           "lookup", "write_slot", "matmul", "summed", "elementwise",
           "placed_as",
           "rows_reshape",
           "HeadSplit",
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


def elementwise(fn, x):
    """`fn(x)` for an elementwise `fn`, on a DTensor's local shard (its
    placements kept, a pending sum reduced first): for ops DTensor has
    no sharding rule for in some releases (`log_sigmoid_backward`)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x)
    x = summed(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def placed_as(y, x):
    """y redistributed to x's placements when both are DTensors (a
    block's output back on its input's layout, where DTensor's
    propagation left it elsewhere); else y as it is."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(y, DTensor) and isinstance(x, DTensor)):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def rows_reshape(x, shape):
    """`x.reshape(shape)` taken on the local shard for a DTensor x split
    on its leading dim alone (or whole), when the old and the new
    leading dim both split evenly: each rank's block of the flat array
    is then whole rows of both shapes, and the split stays on the
    leading dim.  DTensor's own view rule mis-sizes such a view when a
    gradient arrives split over two axes (a local (256, 4096) shard of
    (65536, 4096) read as (1, 4096, 4096)).  Anything else goes to
    `reshape` as it is."""
    import math

    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not all(
            p.is_replicate() or p.is_shard(0) for p in x.placements):
        return x.reshape(shape)
    shape = torch.empty(x.shape, device="meta").reshape(shape).shape
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
            new = torch.empty(x.shape, device="meta").view(args[1]).shape
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
