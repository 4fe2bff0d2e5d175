"""The two-level (sqrt) layer remat of `cfg.outer_scan` in the port's
`lm_backbone`, on the CPU.

The reference (`src/repro/models/transformer.py::lm_backbone`) runs the
groups as `outer_scan` outer steps of `n_groups / outer_scan` groups
when `scan_layers` is on, `outer_scan` divides the groups and is below
their count, each outer step a `nothing_saveable` checkpoint under
`remat`.  The port nests one non-reentrant `torch.utils.checkpoint` per
outer step around the per-group checkpoints.  Held here:

(a) dense (llama3.2-1b, gemma2-2b's local/global pair), MoE
    (mixtral-8x7b), hybrid (zamba2-2.7b: the shared block and the
    embedding read in every group) and xLSTM (xlstm-350m: an mLSTM run
    with its sLSTM per group), reduced to 4 groups with `outer_scan=2`
    in float32 compute: under "nothing" the loss and every gradient
    leaf against the JAX package's `lm_loss` (loss rtol 1e-4 / atol
    1e-5, leaves rtol 1e-3 / atol 1e-5, `tests/test_torch_remat.py`'s
    tolerances); under "nothing", "dots" and "everything" bit-equal to
    the port's flat loop (`outer_scan=0`).  zamba2 runs one SSD chunk
    (ROADMAP.md queue 3, item 15).
(b) Where the reference runs its flat scan (`outer_scan` not dividing
    the groups, `outer_scan` at or past their count, `scan_layers`
    off, `remat` off), so does the port: the forward products that the
    backward runs are the flat loop's, counted by a dispatch mode.
(c) What the recompute costs: under "nothing" the backward re-runs
    `n_groups + (n_groups - go)` group forwards against the flat
    loop's `n_groups` (an outer step's recompute stops once it holds
    its last group's input, before that group's first product).
(d) What is held: a "dots" step of 8 groups at `outer_scan=4` keeps
    at most 4 + 2 groups' worth of live bytes where the flat loop
    keeps 8, measured as `LocalOpCounter`'s live-bytes peak of a meta
    trace.  A flat step's peak is E + n G (E the embedding and read-out's
    share, G one group's saved bytes), so two flat traces (8 and 4
    groups) give G and E, and the two-level step must peak at most at
    E + (4 + 2) G.
(e) A train cell built by `launch/specs.py::build_cell` on a fake
    8-rank group, traced on meta by `launch/dryrun.py::_trace`
    (DTensor parameters, `maybe_shard` at each group's entry): no view
    resharded, flops above the flat cell's by the forward of
    `n_groups - go` groups within 5% (one group's forward is the flat
    "nothing" cell's flops over the "everything" cell's, divided by
    the groups), and fewer temp bytes.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_config as jget
from repro.models import init_lm_params as jinit
from repro.models import lm_loss as jloss
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch.cost_analysis import LocalOpCounter
from repro_torch.launch.dryrun import _trace
from repro_torch.launch.mesh import Mesh, fake_group
from repro_torch.launch.specs import build_cell, on_dtensors
from repro_torch.models import (init_lm_params, lm_loss,
                                lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models.transformer import (LM, block_layout, lm_backbone,
                                            outer_steps)

torch.set_num_threads(2)
GO = 2
# arch -> n_layers for 4 groups; 16 tokens, so zamba2 runs one SSD
# chunk (its reduced ssm_chunk is 32)
ARCHS = {"llama3.2-1b": 4, "gemma2-2b": 8, "mixtral-8x7b": 4,
         "zamba2-2.7b": 8, "xlstm-350m": 8}
SEQ = 16
# held against the JAX package (gemma2's pair only against the flat loop)
REF_ARCHS = ("llama3.2-1b", "mixtral-8x7b", "zamba2-2.7b", "xlstm-350m")
POLICIES = ("nothing", "dots", "everything")
PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _over(arch, **kw):
    over = dict(compute_dtype="float32", remat=True, remat_policy="nothing",
                n_layers=ARCHS[arch], outer_scan=GO)
    over.update(kw)
    return over


def _tokens(cfg, s, b=2, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)


class _Count(TorchDispatchMode):
    """aten.mm / aten.bmm calls, the backward's counted apart."""

    def __init__(self):
        super().__init__()
        self.backward = False
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            key = (self.backward, func.__name__.split(".")[0])
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _run(tc, toks, tree, count=False):
    """Loss, gradients (in parameter order), the model and the product
    counts of one step of the port from `tree`."""
    model = lm_params_from_numpy(tree, tc, device="cpu")
    mode = _Count()
    with mode if count else contextlib.nullcontext():
        loss, _ = lm_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
        mode.backward = True
        loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    return loss.detach(), grads, model, mode.counts


_TREES = {}


def _tree(arch):
    """The reference's parameters for `arch` (numpy), drawn once."""
    if arch not in _TREES:
        jc = jget(arch).reduced(**_over(arch))
        _TREES[arch] = jinit(jax.random.PRNGKey(0), jc)
    return _TREES[arch]


def _same(a, b):
    (la, ga), (lb, gb) = a[:2], b[:2]
    assert torch.equal(la, lb), (float(la), float(lb))
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_outer_steps_conditions():
    cfg = get_config("llama3.2-1b").reduced(n_layers=4, remat=True,
                                             outer_scan=2)
    assert outer_steps(cfg, 4) == 2
    for over in (dict(outer_scan=0), dict(outer_scan=3),
                 dict(outer_scan=4), dict(outer_scan=8),
                 dict(scan_layers=False), dict(remat=False)):
        assert outer_steps(dataclasses.replace(cfg, **over), 4) == 0, over
    with torch.no_grad():
        assert outer_steps(cfg, 4) == 0
    # "everything" keeps the outer level: the test reads `remat` only
    assert outer_steps(dataclasses.replace(
        cfg, remat_policy="everything"), 4) == 2


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_outer_matches_the_reference(arch):
    """(a) under "nothing": the JAX package's loss and gradients at the
    same config."""
    tc = get_config(arch).reduced(**_over(arch))
    _, n_groups = block_layout(tc)
    assert n_groups == 4 and outer_steps(tc, n_groups) == GO
    toks = _tokens(tc, SEQ)
    jp = _tree(arch)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    outer = _run(tc, toks, tree)
    jc = jget(arch).reduced(**_over(arch))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jc), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    loss, grads, model, _ = outer
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
    tmap = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                lm_params_to_numpy(model))[0]}
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jg))[0]
    assert len(jflat) == len(tmap)
    for path, a in jflat:
        np.testing.assert_allclose(tmap[jax.tree_util.keystr(path)], a,
                                   rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_outer_bit_equal_to_flat(arch, policy):
    """(a) under every policy: bit-equal to the flat loop."""
    tc = get_config(arch).reduced(**_over(arch, remat_policy=policy))
    toks = _tokens(tc, SEQ)
    tree = jax.tree_util.tree_map(np.asarray, _tree(arch))
    _same(_run(tc, toks, tree),
          _run(dataclasses.replace(tc, outer_scan=0), toks, tree))


def _llama(**kw):
    over = dict(compute_dtype="float32", remat=True, remat_policy="nothing",
                n_layers=4, outer_scan=GO)
    over.update(kw)
    tc = get_config("llama3.2-1b").reduced(**over)
    tree = lm_params_to_numpy(init_lm_params(0, tc, device="cpu"))
    return tc, _tokens(tc, SEQ), tree


@pytest.mark.parametrize("over", [
    dict(outer_scan=3), dict(outer_scan=4), dict(outer_scan=8),
    dict(scan_layers=False), dict(remat=False)],
    ids=["not-dividing", "equal", "past", "no-scan-layers", "no-remat"])
def test_fallbacks_run_the_flat_loop(over):
    """(b) the products each backward runs are the flat loop's (and so
    are the loss and gradients)."""
    tc, toks, tree = _llama(**over)
    got = _run(tc, toks, tree, count=True)
    flat = _run(dataclasses.replace(tc, outer_scan=0), toks, tree,
                count=True)
    assert got[3] == flat[3]
    _same(got, flat)
    # the same config with a dividing outer_scan would recompute more
    if over.get("remat", True) and over.get("scan_layers", True):
        two = _run(dataclasses.replace(tc, outer_scan=GO), toks, tree,
                   count=True)
        assert two[3][(True, "mm")] > flat[3][(True, "mm")]


def test_recompute_count():
    """(c) under "nothing" with 4 groups in 2 outer steps the backward
    re-runs 2 groups' forward products more than the flat loop does."""
    tc, toks, tree = _llama()
    counts = {name: _run(dataclasses.replace(tc, **over), toks, tree,
                         count=True)[3]
              for name, over in (("outer", {}), ("flat", dict(outer_scan=0)),
                                 ("plain", dict(remat=False)))}
    half, _, half_tree = _llama(remat=False, n_layers=2)
    counts["half"] = _run(half, toks, half_tree, count=True)[3]
    n_groups, go = 4, GO
    for op in ("mm", "bmm"):
        fwd = {k: c[(False, op)] for k, c in counts.items()}
        assert fwd["outer"] == fwd["flat"] == fwd["plain"]
        # one group's forward products
        per_group = (fwd["plain"] - fwd["half"]) // 2
        bwd = {k: c[(True, op)] for k, c in counts.items()}
        # each group's own recompute, which stops before a last product
        # whose output nothing in the group saves (the MLP's down
        # projection: 6 of 7 mm, every bmm)
        redo, rest = divmod(bwd["flat"] - bwd["plain"], n_groups)
        assert rest == 0 and per_group - 1 <= redo <= per_group
        # each outer step's recompute runs its first gi - 1 groups whole
        # and stops before its last group's first product
        assert bwd["outer"] - bwd["flat"] == (n_groups - go) * per_group


def _meta_peak(n_layers, outer_scan):
    """`LocalOpCounter`'s live-bytes peak of one "dots" step (loss and
    backward) of llama3.2-1b reduced to `n_layers` groups, on meta, each
    parameter's gradient dropped once it is accumulated (so the peak is
    what the step holds beyond its parameters and gradients)."""
    cfg = get_config("llama3.2-1b").reduced(
        remat=True, remat_policy="dots", n_layers=n_layers,
        outer_scan=outer_scan, d_model=256, d_ff=1024)
    model = LM(cfg, device="meta")
    for p in model.parameters():
        p.register_post_accumulate_grad_hook(
            lambda p: setattr(p, "grad", None))
    toks = torch.zeros((2, 65), dtype=torch.long, device="meta")
    with LocalOpCounter() as ops:
        loss, _ = lm_loss(model, {"tokens": toks}, cfg)
        loss.backward()
        del loss
    return ops.peak_bytes


def test_dots_step_holds_six_groups_of_eight():
    """(d) E + n G for the flat loop; at most E + (4 + 2) G nested."""
    flat8, flat4 = _meta_peak(8, 0), _meta_peak(4, 0)
    g = (flat8 - flat4) / 4  # one group's saved bytes
    e = flat4 - 4 * g  # the embedding and read-out's share
    assert g > 0 and e >= 0
    outer = _meta_peak(8, 4)
    assert outer <= e + (4 + 2) * g, (outer, e, g)
    assert outer < flat8


def test_flat_forward_frees_each_residual(monkeypatch):
    """Without autograd the flat loop holds one residual at a time: at
    every group's entry the live bytes are the same (a residual held
    past its reader, such as the embedding's output, would add one
    (B, S, d) tensor per group entered after it)."""
    from repro_torch.models import transformer

    cfg = get_config("llama3.2-1b").reduced(remat=True, n_layers=4,
                                             outer_scan=GO)
    model = LM(cfg, device="meta")
    toks = torch.zeros((2, 64), dtype=torch.long, device="meta")
    entries = []
    body = transformer._group_body

    def counted(x, *args):
        entries.append(ops.live_bytes)
        return body(x, *args)

    monkeypatch.setattr(transformer, "_group_body", counted)
    with torch.no_grad(), LocalOpCounter() as ops:
        lm_backbone(model, toks, cfg)
    residual = 2 * 64 * cfg.d_model * cfg.cdtype.itemsize
    assert len(entries) == 4
    assert max(entries) - min(entries) < residual, entries


def _forward_flops(cfg, cell):
    """Flops of `lm_backbone`'s forward (autograd on) on a cell's
    parameters and tokens."""
    fwd = on_dtensors(lambda model, batch: lm_backbone(
        model, batch["tokens"][:, :-1], cfg))
    with LocalOpCounter() as ops:
        fwd(cell.args[0], cell.args[3])
    assert fwd.fallbacks == []
    return ops.flops


def test_train_cell_on_a_fake_group():
    """(e) the nested checkpoint on DTensor parameters: the flops of
    `n_groups - go` more group forwards under "nothing", fewer temp
    bytes under "dots"."""
    n_groups, go = 4, GO
    mesh = Mesh((4, 2), ("data", "model"))
    sp = ShapeSpec("mini_train", 64, 8, "train")
    # d_model 512: every stacked weight splits at 2 and 4 groups alike
    # (the rules replicate leaves under 64k entries)
    base = get_config("llama3.2-1b").reduced(remat=True, n_layers=n_groups,
                                             d_model=512)
    runs = {}
    with fake_group(8):
        dmesh = mesh.device_mesh("cpu")

        def cell(**over):
            cfg = dataclasses.replace(base, **over)
            return cfg, build_cell("llama3.2-1b", sp, mesh, cfg, dmesh=dmesh)

        for name, over in (("flat", {}), ("outer", dict(outer_scan=go)),
                           ("flat dots", dict(remat_policy="dots")),
                           ("outer dots", dict(remat_policy="dots",
                                               outer_scan=go))):
            cells = cell(**over)
            runs[name] = _trace(cells[1], contextlib.nullcontext())
            assert runs[name]["fallbacks"] == [], name
            if name == "flat":
                flat = cells
        # one group's forward: the backbone's at 4 groups less at 2
        fwd = [_forward_flops(*flat), _forward_flops(*cell(n_layers=2))]
    group_fwd = (fwd[0] - fwd[1]) / (n_groups - 2)
    assert group_fwd > 0
    extra = runs["outer"]["flops"] - runs["flat"]["flops"]
    want = (n_groups - go) * group_fwd
    assert abs(extra - want) <= 0.05 * want, (extra, want)
    assert runs["outer dots"]["temp"] < runs["flat dots"]["temp"]
