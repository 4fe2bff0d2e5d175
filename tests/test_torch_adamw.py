"""The port's AdamW against the JAX package's `optim.adamw`, on the CPU.

The same numpy params, grads and moments go through one `update` on
each side: skip False agrees at rtol 1e-6, skip True leaves params,
moments and count bit for bit as they were (NaN grads included).  The
schedule agrees at rtol 1e-6 over steps 0..300 (with an atol of 1e-6
of the peak lr: where the cosine reaches min_lr_frac = 0, 1 + cos cancels
and the two float32 cosines differ in the last bits of a near-zero lr).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

CFG = dict(lr=1e-3, warmup_steps=10, total_steps=200, clip_norm=1.0)


def _trees(seed=0, nan=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: np.abs(0.01 * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    if nan:
        g["a"][0, 0] = np.nan
    return p, g, m, v


def _both(skip, clip=1.0, count=4, nan=False):
    p, g, m, v = _trees(nan=nan)
    cfg = dict(CFG, clip_norm=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jst = jadamw.OptState(m={k: jnp.asarray(a) for k, a in m.items()},
                          v={k: jnp.asarray(a) for k, a in v.items()},
                          count=jnp.asarray(count, jnp.int32))
    jp, js, jm = jadamw.update({k: jnp.asarray(a) for k, a in g.items()},
                               jst, {k: jnp.asarray(a) for k, a in p.items()},
                               jcfg, skip=jnp.asarray(skip))
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    tst = adamw.OptState(m={k: torch.from_numpy(a.copy())
                            for k, a in m.items()},
                         v={k: torch.from_numpy(a.copy())
                            for k, a in v.items()},
                         count=torch.tensor(count, dtype=torch.int32))
    out_p, ts, tm = adamw.update({k: torch.from_numpy(a)
                                  for k, a in g.items()}, tst, tp, tcfg,
                                 skip=torch.tensor(skip))
    return (p, m, v), (jp, js, jm), (out_p, ts, tm)


@pytest.mark.parametrize("clip", [1.0, None])
def test_update_matches_reference(clip):
    _, (jp, js, jm), (tp, ts, tm) = _both(False, clip=clip)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                   rtol=1e-6, atol=1e-10)
    assert int(ts.count) == int(js.count) == 5
    for k in ("grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("nan", [False, True])
def test_skip_leaves_everything_bit_identical(nan):
    (p, m, v), (jp, js, _), (tp, ts, tm) = _both(True, nan=nan)
    for k in p:
        for before, after in ((p, tp), (m, ts.m), (v, ts.v)):
            np.testing.assert_array_equal(after[k].numpy().view(np.int32),
                                          before[k].view(np.int32))
        np.testing.assert_array_equal(np.asarray(jp[k]), p[k])
    assert int(ts.count) == int(js.count) == 4
    assert float(tm["skipped"]) == 1.0


def test_schedule_matches_reference():
    for cfg in (CFG, dict(CFG, warmup_steps=0, min_lr_frac=0.0),
                dict(CFG, total_steps=50)):
        jc, tc = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
        steps = np.arange(301, dtype=np.int32)
        ref = np.asarray(jax.vmap(lambda s: jadamw.schedule(jc, s))(
            jnp.asarray(steps)))
        out = adamw.schedule(tc, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * tc.lr)


def test_bf16_moments_and_global_norm():
    p, g, _, _ = _trees(1)
    cfg = adamw.AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16")
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    st = adamw.init(tp, cfg)
    assert st.m["a"].dtype == torch.bfloat16 and st.count.dtype == torch.int32
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jst = jadamw.init(jp, jcfg)
    tg = {k: torch.from_numpy(a) for k, a in g.items()}
    jg = {k: jnp.asarray(a) for k, a in g.items()}
    np.testing.assert_allclose(float(adamw.global_norm(tg)),
                               float(jadamw.global_norm(jg)), rtol=1e-6)
    tp, st, _ = adamw.update(tg, st, tp, cfg)
    jp, jst, _ = jadamw.update(jg, jst, jp, jcfg)
    for k in p:
        np.testing.assert_array_equal(
            st.m[k].float().numpy(),
            np.asarray(jst.m[k].astype(jnp.float32)))
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
