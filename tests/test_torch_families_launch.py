"""The launchers on the port's other model families against the JAX
package's, on the CPU: `serve_prompts` on zamba2-2.7b `reduced()`
against the reference's `serve` on its weights and prompts (f32, batch
2, prompt 8, gen 8): tokens, flagged requests and ticks equal, telemetry
rtol 1e-4 / atol 1e-5, the "cuda-q" monitor bit for bit with
"pallas-q" on the reference's telemetry; `make_train_step` on a
seamless-m4t-medium `reduced()` batch with `src_emb`; `train()` on the
CPU for xlstm and zamba2, and on seamless, where it fails as the
reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.guard import GuardConfig as JGuardConfig
from repro.core.guard import guard_init as jguard_init
from repro.fixedpoint import QFormat as JQ
from repro.launch.batching import BatchingScheduler as JSched
from repro.launch.batching import Request as JRequest
from repro.launch.serve import _monitor_buckets as j_buckets
from repro.launch.serve import _telemetry as j_telemetry
from repro.launch.serve import serve as j_serve
from repro.launch.specs import make_train_step as jmake_train_step
from repro.models import init_cache as jinit_cache
from repro.models import init_encdec_params as jinit_encdec
from repro.models import init_lm_params as jinit
from repro.models import lm_decode_step as jdecode
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.core import GuardConfig, guard_init
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.launch.serve import (close_monitor, monitor_tick,
                                      open_monitor, serve_prompts)
from repro_torch.launch.specs import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import (encdec_params_from_numpy,
                                encdec_params_to_numpy,
                                lm_params_from_numpy)
from repro_torch.optim import adamw

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)


def _reference_monitor(hist, rows, backend, fmt=None, m=3.5):
    batch = hist.shape[1]
    sched = JSched(backend, buckets=j_buckets(batch * 2), chunk_t=16, m=m,
                   fmt=fmt, queue_limit=batch * 2, collect=True)
    for b in range(batch):
        for c in range(2):
            assert sched.submit(JRequest(f"req{b}/ch{c}", hist[:, b, c],
                                         m=m))
    for tel in rows:
        for b in range(batch):
            for c in range(2):
                sched.feed(f"req{b}/ch{c}", tel[b, c:c + 1])
        sched.step()
    for b in range(batch):
        for c in range(2):
            sched.close(f"req{b}/ch{c}")
    sched.drain()
    return sched


def test_zamba2_serve_matches_reference():
    """The reference's `serve` on zamba2 `reduced()` (f32, batch 2,
    prompt 8, gen 8, seed 0, "pallas-q") against the port's
    `serve_prompts` on its weights and prompts ("cuda-q")."""
    b, p, gen, seed = 2, 8, 8, 0
    over = dict(compute_dtype="float32")
    jc = jget("zamba2-2.7b").reduced(**over)
    tc = get_config("zamba2-2.7b").reduced(**over)
    key = jax.random.PRNGKey(seed)
    params = jinit(key, jc)
    prompts = np.asarray(jax.random.randint(key, (b, p), 0, jc.vocab))
    # the reference's loop replayed: its telemetry rows
    caches = jinit_cache(jc, b, p + gen, dtype=jnp.float32)
    step = jax.jit(lambda pr, t, pos, c: jdecode(pr, t, pos, c, jc))
    hist, rows, tok = [], [], jnp.asarray(prompts[:, -1])
    for i in range(p - 1):
        lg, caches = step(params, jnp.asarray(prompts[:, i]), jnp.int32(i),
                          caches)
        hist.append(np.stack([np.asarray(a) for a in j_telemetry(lg)], -1))
    for i in range(gen):
        lg, caches = step(params, tok, jnp.int32(p - 1 + i), caches)
        tok = jnp.argmax(lg, axis=-1)
        rows.append(np.stack([np.asarray(a) for a in j_telemetry(lg)], -1))
    hist, rows = np.stack(hist), np.stack(rows)
    ref = j_serve(jc, b, p, gen, seed=seed, backend="pallas-q",
                  fmt=JQ(32, 20))
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 tc, device="cpu")
    res = serve_prompts(model, prompts, tc, gen, seed=seed,
                        backend="cuda-q", fmt=TQ(32, 20))
    np.testing.assert_array_equal(res["tokens"], np.asarray(ref["tokens"]))
    assert res["flagged_requests"] == ref["flagged_requests"]
    assert res["monitor"]["ticks"] == ref["monitor"]["ticks"] == gen + 1
    got_hist, got_rows = res["telemetry"]
    np.testing.assert_allclose(got_hist, hist, **F32)
    np.testing.assert_allclose(got_rows, rows, **F32)
    # the monitors on the reference's rows, bit for bit
    jsched = _reference_monitor(hist, rows, "pallas-q", JQ(32, 20))
    tsched = open_monitor(hist, backend="cuda-q", m=3.5, chunk_t=16,
                          fmt=TQ(32, 20), device="cpu")
    for tel in rows:
        monitor_tick(tsched, tel)
    close_monitor(tsched, b, gen)
    for i in range(b):
        for c in range(2):
            rid = f"req{i}/ch{c}"
            np.testing.assert_array_equal(tsched.results(rid)["ecc"],
                                          jsched.results(rid)["ecc"])
            np.testing.assert_array_equal(tsched.results(rid)["outlier"],
                                          jsched.results(rid)["outlier"])


def test_encdec_train_step_matches_reference():
    """`make_train_step` on seamless `reduced()` with a `src_emb` batch,
    4 guarded steps on both sides: loss, grad norm, lr and the skip
    verdict per step (rtol 1e-4), and the final parameters at rtol 1e-3
    / atol 3e-5, a tenth of the peak lr: AdamW moves a parameter whose
    gradient is near zero by up to lr either way, so the last bits of
    such a gradient show at that scale."""
    over = dict(compute_dtype="float32")
    jc = jget("seamless-m4t-medium").reduced(**over)
    tc = get_config("seamless-m4t-medium").reduced(**over)
    jp = jinit_encdec(jax.random.PRNGKey(1), jc)
    model = encdec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     tc, device="cpu")
    guard, opt = dict(m=3.0, warmup_steps=2), dict(warmup_steps=2,
                                                   total_steps=4)
    jstep = jax.jit(jmake_train_step(jc, jadamw.AdamWConfig(**opt),
                                     accum_steps=2,
                                     guard_cfg=JGuardConfig(**guard)))
    tstep = make_train_step(tc, adamw.AdamWConfig(**opt), accum_steps=2,
                            guard_cfg=GuardConfig(**guard))
    jo, jg = jadamw.init(jp), jguard_init(JGuardConfig(**guard))
    to = adamw.init(dict(model.named_parameters()))
    tg = guard_init(GuardConfig(**guard), device="cpu")
    rng = np.random.default_rng(5)
    for i in range(4):
        batch = {"src_emb": rng.normal(size=(4, 32, tc.d_model)).astype(
                     np.float32),
                 "tokens": rng.integers(0, tc.vocab, size=(4, 33)).astype(
                     np.int32)}
        jp, jo, jg, jm = jstep(jp, jo, jg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        model, to, tg, tm = tstep(model, to, tg, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["skipped"]) == float(jm["skipped"]), i
        for k in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {i}")
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jp)),
            jax.tree_util.tree_leaves(encdec_params_to_numpy(model))):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=3e-5)


def test_train_runs_the_new_families():
    """`train()` on the CPU: a few finite guarded steps for xlstm and
    zamba2; on seamless it fails at the first step as the reference's
    does (`TokenStream` yields no `src_emb`)."""
    for name in ("xlstm-350m", "zamba2-2.7b"):
        cfg = get_config(name).reduced()
        model, hist, summary = train(cfg, steps=3, batch=2, seq=32,
                                     ckpt_dir=None, device="cpu",
                                     log_every=100)
        assert len(hist) == 3 and summary["skipped"] == 0
        assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                   for h in hist)
    with pytest.raises(KeyError, match="src_emb"):
        train(get_config("seamless-m4t-medium").reduced(), steps=1,
              batch=2, seq=16, ckpt_dir=None, device="cpu")
