"""`remat_policy="dots"` in the port against "nothing" and the JAX
package's "dots", on the CPU.

The reference checkpoints each layer group with
`checkpoint_dots_with_no_batch_dims`; the port with
`torch.utils.checkpoint`'s selective contexts, saving the outputs of
`mm` and `addmm` (the dense layers' products, no batch dims) and
recomputing the rest.  Held: loss and gradients bit-equal to the port's
"nothing" (the same arithmetic, recomputed or saved); against the JAX
package's "dots" in float32 compute, loss rtol 1e-4 / atol 1e-5 and
every gradient leaf rtol 1e-3 / atol 1e-5 (`tests/test_torch_models.py`'s
tolerances); and what is saved: the backward of "dots" runs no forward
`mm` again (as many as without remat), but recomputes every `bmm`
(attention's batched products, as many as under "nothing").
"""
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
from repro_torch.models import (lm_loss, lm_params_from_numpy,
                                lm_params_to_numpy)
from repro_torch.models.transformer import DOTS, remat_context

torch.set_num_threads(2)
# zamba2 at B = 2 x T = 32, one SSD chunk: the reference's multi-chunk
# SSD mixes batch rows (ROADMAP.md queue 3, item 15)
ARCHS = {"llama3.2-1b": 64, "zamba2-2.7b": 32}


def _tokens(cfg, b=2, s=64, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)


def _cfgs(arch, policy):
    over = dict(compute_dtype="float32", remat=True, remat_policy=policy)
    return jget(arch).reduced(**over), get_config(arch).reduced(**over)


class _Count(TorchDispatchMode):
    """aten.mm / aten.bmm calls, counted apart for the backward."""

    def __init__(self):
        super().__init__()
        self.backward = False
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            key = (self.backward, func.__name__.split(".")[0])
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _run(tc, toks, tree, count=False):
    model = lm_params_from_numpy(tree, tc, device="cpu")
    mode = _Count()
    with _maybe(mode, count):
        loss, _ = lm_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
        mode.backward = True
        loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    return loss.detach(), grads, model, mode.counts


def _maybe(mode, on):
    import contextlib
    return mode if on else contextlib.nullcontext()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dots_equals_nothing_and_the_reference(arch):
    jc, tc = _cfgs(arch, "dots")
    toks = _tokens(tc, s=ARCHS[arch])
    jp = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    loss, grads, model, _ = _run(tc, toks, tree)
    nloss, ngrads, _, _ = _run(dataclasses.replace(tc, remat_policy="nothing"),
                               toks, tree)
    assert torch.equal(loss, nloss)
    for a, b in zip(grads, ngrads):
        assert torch.equal(a, b)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jc), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.copy_(g)
    tg = lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jg))[0]
    tmap = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tg)[0]}
    assert len(jflat) == len(tmap)
    for path, a in jflat:
        np.testing.assert_allclose(tmap[jax.tree_util.keystr(path)], a,
                                   rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_dots_saves_the_no_batch_dim_products():
    _, tc = _cfgs("llama3.2-1b", "dots")
    toks = _tokens(tc)
    from repro_torch.models import init_lm_params
    tree = lm_params_to_numpy(init_lm_params(0, tc, device="cpu"))
    counts = {pol: _run(dataclasses.replace(tc, remat_policy=pol), toks,
                        tree, count=True)[3]
              for pol in ("dots", "nothing", "everything")}
    dots, nothing, plain = (counts[p] for p in ("dots", "nothing",
                                                "everything"))
    # forward products are the same under every policy
    for op in ("mm", "bmm"):
        assert dots[(False, op)] == nothing[(False, op)] == plain[(False, op)]
    # "nothing" recomputes the forward mm in the backward; "dots" does not
    assert nothing[(True, "mm")] > plain[(True, "mm")]
    assert dots[(True, "mm")] == plain[(True, "mm")]
    # attention's bmm are recomputed under both checkpoint policies
    assert dots[(True, "bmm")] == nothing[(True, "bmm")] \
        > plain[(True, "bmm")]


def test_remat_context_policies():
    assert torch.ops.aten.mm.default in DOTS
    assert torch.ops.aten.bmm.default not in DOTS
    assert callable(remat_context("dots")) \
        and callable(remat_context("nothing"))
    with pytest.raises(ValueError, match="remat_policy"):
        remat_context("sometimes")
