"""The port's MoE layer (`models/moe.py`) against the JAX package's, on
the CPU.

One reference parameter tree (the JAX `moe_init`) is copied into the
port's module, and both sides see the same numpy inputs: mixtral-8x7b
`reduced()` (4 experts, top-2) and dbrx-132b `reduced(n_experts=8,
top_k=4)`, whose top-4 combine depends on the order of its adds.  Every
comparison first asserts that both sides chose the same experts
(`choice`) and kept the same assignments (`keep`).  Float32 compute:
outputs and the three aux values rtol 1e-4 / atol 1e-5, every gradient
leaf rtol 1e-3 / atol 1e-5; bfloat16 compute: rtol 2e-2 / atol 2e-2 *
max|ref|.  The reference's zeroed slot cap - 1 of an overflowing expert
is held exactly (ROADMAP.md queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models.moe import moe as jmoe
from repro.models.moe import moe_init as jmoe_init
from repro_torch.configs import get_config
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import moe, moe_init
from repro_torch.tree import tree_paths

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
ARCHS = {"mixtral": ("mixtral-8x7b", {}),
         "dbrx": ("dbrx-132b", dict(n_experts=8, top_k=4))}


def _cfgs(arch, **over):
    name, base = ARCHS[arch]
    return (jget(name).reduced(**base, **over),
            get_config(name).reduced(**base, **over))


def _into(module, tree):
    """Copy a reference parameter tree into a port module."""
    with torch.no_grad():
        for path, leaf in tree_paths(tree):
            module.get_parameter(".".join(path)).copy_(
                torch.from_numpy(np.array(leaf)))
    return module


def _pair(arch, seed=0, **over):
    jc, tc = _cfgs(arch, **over)
    jp = jmoe_init(jax.random.PRNGKey(seed), jc)
    tp = _into(moe_init(None, tc, device="cpu"),
               jax.tree_util.tree_map(np.asarray, jp))
    return jc, tc, jp, tp


def _jroute(jp, xf, jc):
    """The reference's routing (`models/moe.py:67-89`): choice and keep
    in its sorted order."""
    t = xf.shape[0]
    e, k = jc.n_experts, jc.top_k
    cap = max(8, min(int(t * k * jc.capacity_factor / e + 0.999), t))
    logits = xf.astype(jnp.float32) @ jp["router"]["w"].astype(jnp.float32)
    _, choice = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    se = jnp.sort(choice.reshape(-1), stable=True)
    counts = jnp.bincount(se, length=e)
    pos = jnp.arange(t * k) - (jnp.cumsum(counts) - counts)[se]
    return np.asarray(choice), np.asarray(pos < cap)


def _same_routes(jp, tp, x, jc, tc, chunk=None):
    """Both sides' choice and keep, block by block."""
    d = x.shape[-1]
    xs = x.reshape(-1, chunk or x.shape[0] * x.shape[1], d)
    for xi in xs:
        jchoice, jkeep = _jroute(jp, jnp.asarray(xi), jc)
        r = moe_mod._route(torch.from_numpy(np.asarray(xi, np.float32)),
                           tp.router.w, tc)
        np.testing.assert_array_equal(r.choice.numpy(), jchoice)
        np.testing.assert_array_equal(r.keep.numpy(), jkeep)


def _x(tc, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, s, tc.d_model)).astype(np.float32)


def _run_both(jp, tp, x, jc, tc, w):
    """Outputs, aux and gradients of sum(y * w) + the aux values on
    both sides.  Returns (jy, jaux, jgrads, ty, taux, tgrads)."""
    cd = jc.cdtype

    def jfn(p, x):
        y, aux = jmoe(p, x.astype(cd), jc)
        return (jnp.sum(y.astype(jnp.float32) * w)
                + aux["load_balance"] + aux["router_z"]), (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = moe(tp, xt.to(tc.cdtype), tc)
    (torch.sum(ty.float() * torch.from_numpy(w)) + taux["load_balance"]
     + taux["router_z"]).backward()
    tgrads = {n: p.grad.numpy() for n, p in tp.named_parameters()}
    tgrads["x"] = xt.grad.numpy()
    jgrads = {".".join(path): np.asarray(a, np.float32)
              for path, a in tree_paths(jax.tree_util.tree_map(
                  np.asarray, jg[0]))}
    jgrads["x"] = np.asarray(jg[1])
    return (np.asarray(jy, np.float32), jaux, jgrads,
            ty.detach().float().numpy(), taux, tgrads)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_f32_matches_reference(arch):
    jc, tc, jp, tp = _pair(arch, compute_dtype="float32")
    x = _x(tc)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    _same_routes(jp, tp, x, jc, tc)
    jy, jaux, jg, ty, taux, tg = _run_both(jp, tp, x, jc, tc, w)
    np.testing.assert_allclose(ty, jy, **F32)
    for k in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(taux[k].detach()),
                                   float(jaux[k]), **F32, err_msg=k)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **GRAD, err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_bf16_matches_reference(arch):
    jc, tc, jp, tp = _pair(arch, seed=3)
    x = np.asarray(jnp.asarray(_x(tc, seed=4), jnp.bfloat16), np.float32)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    _same_routes(jp, tp, x, jc, tc)
    jy, jaux, jg, ty, taux, tg = _run_both(jp, tp, x, jc, tc, w)
    np.testing.assert_allclose(ty, jy, rtol=2e-2,
                               atol=2e-2 * np.abs(jy).max())
    for k in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=2e-2, err_msg=k)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=2e-2,
                                   atol=2e-2 * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_overflow_zeroes_the_last_kept_slot_on_both_sides():
    """Every token routed to experts 0 and 1: T = 64, cap = 40, 48 of
    128 assignments dropped.  Token 39 sits in slot cap - 1 of both
    experts, which the reference zeroes: its output and its gradient
    are exactly 0 on both sides, token 38's are not."""
    jc, tc, jp, tp = _pair("mixtral", compute_dtype="float32")
    router = np.zeros((tc.d_model, tc.n_experts), np.float32)
    router[0, :2] = (2.0, 1.0)
    jp = dict(jp, router={"w": jnp.asarray(router)})
    with torch.no_grad():
        tp.router.w.copy_(torch.from_numpy(router))
    x = _x(tc, b=1, s=64, seed=6)
    x[..., 0] = 10.0
    w = np.ones(x.shape, np.float32)
    _same_routes(jp, tp, x, jc, tc)
    jy, jaux, jg, ty, taux, tg = _run_both(jp, tp, x, jc, tc, w)
    assert float(jaux["dropped_frac"]) == float(taux["dropped_frac"]) \
        == 0.375
    for y in (jy, ty):
        assert not y[0, 39].any() and y[0, 38].all()
    np.testing.assert_allclose(ty, jy, **F32)
    # the expert path alone (aux off): token 39's input gradient is 0
    for side in ("jax", "torch"):
        if side == "jax":
            g = jax.grad(lambda x: jnp.sum(jmoe(jp, x, jc)[0]))(
                jnp.asarray(x))
            g = np.asarray(g)
        else:
            xt = torch.from_numpy(x).requires_grad_(True)
            moe(tp, xt, tc)[0].sum().backward()
            g = xt.grad.numpy()
        assert not g[0, 39].any() and g[0, 38].any(), side


def test_block_wise_dispatch_matches_reference():
    """moe_chunk 32 over 64 tokens: two blocks, aux the mean over them."""
    jc, tc, jp, tp = _pair("dbrx", compute_dtype="float32", moe_chunk=32)
    x = _x(tc, seed=7)
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    _same_routes(jp, tp, x, jc, tc, chunk=32)
    jy, jaux, jg, ty, taux, tg = _run_both(jp, tp, x, jc, tc, w)
    np.testing.assert_allclose(ty, jy, **F32)
    for k in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(taux[k].detach()),
                                   float(jaux[k]), **F32)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **GRAD, err_msg=k)


def test_top_k_ties_break_to_the_lower_index():
    """A zero router gives every expert the same probability: both sides
    choose experts 0 .. k-1 for every token."""
    jc, tc, jp, tp = _pair("dbrx", compute_dtype="float32")
    zero = np.zeros((tc.d_model, tc.n_experts), np.float32)
    jp = dict(jp, router={"w": jnp.asarray(zero)})
    with torch.no_grad():
        tp.router.w.zero_()
    x = _x(tc, b=1, s=16, seed=9)
    _same_routes(jp, tp, x, jc, tc)
    r = moe_mod._route(torch.from_numpy(x[0]), tp.router.w, tc)
    assert (r.choice.numpy() == np.arange(tc.top_k)).all()
