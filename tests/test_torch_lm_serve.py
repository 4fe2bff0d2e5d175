"""The port's LM serving slice (`repro_torch.launch.serve`: `_telemetry`,
`_monitor_buckets`, the monitor, `serve_prompts` / `serve`, the CLI's
`--mode lm`) against the JAX package's, on the CPU.

The whole slice runs the reference's `serve` on a float32 reduced
llama3.2-1b (batch 2, prompt 8, gen 8, seed 0) and hands the port's
`serve_prompts` that seed's JAX weights and prompts: equal tokens,
flagged requests and monitor ticks.  The monitor alone, fed the
reference's telemetry rows: "cuda-q" (the plain Q scan on the CPU)
against "pallas-q" bit for bit; "cuda" against "pallas" with ecc within
rtol 5e-4 / atol 1e-5 and flags equal outside a 1e-4 band around the
threshold.  Sampling has no reference counterpart (the port draws from
a `torch.Generator`), so it is checked on its own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget
from repro.fixedpoint import QFormat as JQ
from repro.launch.batching import BatchingScheduler as JSched
from repro.launch.batching import Request as JRequest
from repro.launch.serve import _monitor_buckets as j_buckets
from repro.launch.serve import _telemetry as j_telemetry
from repro.launch.serve import serve as j_serve
from repro.models import init_cache as jinit_cache
from repro.models import init_lm_params as jinit
from repro.models import lm_decode_step as jdecode
from repro_torch.configs import get_config
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.launch.serve import (_monitor_buckets, _sample, _telemetry,
                                      close_monitor, main, monitor_tick,
                                      open_monitor, serve, serve_prompts)
from repro_torch.models import lm_params_from_numpy

torch.set_num_threads(2)

B, P, GEN, SEED, M = 2, 8, 8, 0, 3.5
RTOL, ATOL, BAND = 5e-4, 1e-5, 1e-4


def _cfgs():
    over = dict(compute_dtype="float32")
    return (jget("llama3.2-1b").reduced(**over),
            get_config("llama3.2-1b").reduced(**over))


def _reference_rows(jc):
    """The reference's serve loop replayed step by step (its weights,
    prompts and greedy decode): the logits of every decode step, the
    prompt telemetry (P - 1, B, 2) and the decode rows (GEN, B, 2)."""
    key = jax.random.PRNGKey(SEED)
    params = jinit(key, jc)
    prompts = jax.random.randint(key, (B, P), 0, jc.vocab)
    caches = jinit_cache(jc, B, P + GEN, dtype=jnp.float32)
    step = jax.jit(lambda p, t, pos, c: jdecode(p, t, pos, c, jc))
    hist, rows, logits_all, toks = [], [], [], []
    for i in range(P - 1):
        lg, caches = step(params, prompts[:, i], jnp.int32(i), caches)
        hist.append(np.stack([np.asarray(a) for a in j_telemetry(lg)], -1))
    tok = prompts[:, -1]
    for i in range(GEN):
        lg, caches = step(params, tok, jnp.int32(P - 1 + i), caches)
        tok = jnp.argmax(lg, axis=-1)
        logits_all.append(np.asarray(lg))
        toks.append(np.asarray(tok))
        rows.append(np.stack([np.asarray(a) for a in j_telemetry(lg)], -1))
    return (params, np.asarray(prompts), np.stack(logits_all),
            np.stack(toks, axis=1), np.stack(hist), np.stack(rows))


@pytest.fixture(scope="module")
def ref_run():
    jc, tc = _cfgs()
    return (jc, tc) + _reference_rows(jc)


def _reference_monitor(hist, rows, backend, fmt=None):
    """The reference's monitor (as its `serve` builds and feeds it) over
    given telemetry rows."""
    batch = hist.shape[1]
    sched = JSched(backend, buckets=j_buckets(batch * 2), chunk_t=16, m=M,
                   fmt=fmt, queue_limit=batch * 2, collect=True)
    for b in range(batch):
        for c in range(2):
            assert sched.submit(JRequest(f"req{b}/ch{c}", hist[:, b, c],
                                         m=M))
    for tel in rows:
        for b in range(batch):
            for c in range(2):
                sched.feed(f"req{b}/ch{c}", tel[b, c:c + 1])
        sched.step()
    for b in range(batch):
        for c in range(2):
            sched.close(f"req{b}/ch{c}")
    sched.drain()
    gen = rows.shape[0]
    flagged = [b for b in range(batch)
               if any(sched.results(f"req{b}/ch{c}")["outlier"][-gen:].any()
                      for c in range(2))]
    return sched, flagged


def _port_monitor(hist, rows, backend, fmt=None):
    sched = open_monitor(hist, backend=backend, m=M, chunk_t=16, fmt=fmt,
                         device="cpu")
    for tel in rows:
        monitor_tick(sched, tel)
    return sched, close_monitor(sched, hist.shape[1], rows.shape[0])


def test_telemetry_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 512)) * 4).astype(np.float32)
    logits[:, -7:] = -1e30  # masked vocabulary padding
    logits[1] = 0.0  # flat: entropy log(505)
    ent, mx = _telemetry(torch.from_numpy(logits))
    jent, jmx = j_telemetry(jnp.asarray(logits))
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    assert ent.dtype == mx.dtype == torch.float32


@pytest.mark.parametrize("n", [0, 1, 8, 9, 16, 17, 100, 1024])
def test_monitor_buckets_match_reference(n):
    assert _monitor_buckets(n) == j_buckets(n)


def test_whole_slice_matches_reference(ref_run):
    jc, tc, params, prompts, logits, toks, hist, rows = ref_run
    # token equality is a real check only where the greedy choice is
    # clear of the logits' tolerance (rtol 1e-4 / atol 1e-5)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tol = 2 * (1e-5 + 1e-4 * np.abs(top2[..., 1]))
    assert (top2[..., 1] - top2[..., 0] > tol).all()
    ref = j_serve(jc, B, P, GEN, m=M, seed=SEED)
    np.testing.assert_array_equal(np.asarray(ref["tokens"]), toks)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 tc, device="cpu")
    res = serve_prompts(model, prompts, tc, GEN, m=M, seed=SEED)
    np.testing.assert_array_equal(res["tokens"], toks)
    assert res["flagged_requests"] == ref["flagged_requests"]
    assert res["monitor"]["ticks"] == ref["monitor"]["ticks"]
    assert res["monitor"]["completed"] == ref["monitor"]["completed"] == 4
    got_hist, got_rows = res["telemetry"]
    np.testing.assert_allclose(got_hist, hist, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_rows, rows, rtol=1e-4, atol=1e-5)
    assert res["prefill_tok_s"] > 0 and res["decode_tok_s"] > 0


def _spiked(rows, spike):
    """The reference's rows as they are, or with request 1's entropy
    collapsing at the last decode step (a degenerate generation to
    flag; with m = 3.5 a single sample can trip only from k = 14 on)."""
    rows = rows.copy()
    if spike:
        rows[-1, 1, 0] -= 40.0
    return rows


@pytest.mark.parametrize("spike", [False, True])
def test_monitor_q_path_bit_exact(ref_run, spike):
    *_, hist, rows = ref_run
    rows = _spiked(rows, spike)
    jsched, jflag = _reference_monitor(hist, rows, "pallas-q", JQ(32, 20))
    tsched, tflag = _port_monitor(hist, rows, "cuda-q", TQ(32, 20))
    assert tflag == jflag == ([1] if spike else [])
    assert tsched.stats()["ticks"] == jsched.stats()["ticks"]
    for b in range(B):
        for c in range(2):
            rid = f"req{b}/ch{c}"
            rt, rj = tsched.results(rid), jsched.results(rid)
            assert rt["ecc"].shape == (P - 1 + GEN,)
            np.testing.assert_array_equal(rt["ecc"], rj["ecc"], rid)
            np.testing.assert_array_equal(rt["outlier"], rj["outlier"], rid)


@pytest.mark.parametrize("spike", [False, True])
def test_monitor_float_path_within_band(ref_run, spike):
    *_, hist, rows = ref_run
    rows = _spiked(rows, spike)
    jsched, jflag = _reference_monitor(hist, rows, "pallas")
    tsched, tflag = _port_monitor(hist, rows, "cuda")
    assert jflag == ([1] if spike else [])
    for b in range(B):
        for c in range(2):
            rid = f"req{b}/ch{c}"
            rt, rj = tsched.results(rid), jsched.results(rid)
            np.testing.assert_allclose(rt["ecc"], rj["ecc"], rtol=RTOL,
                                       atol=ATOL, err_msg=rid)
            k = np.arange(1, rj["ecc"].shape[0] + 1)
            thr = (M * M + 1.0) / (2.0 * k)
            band = np.abs(rj["ecc"] * 0.5 - thr) <= BAND * thr
            diff = rt["outlier"] != rj["outlier"]
            assert not (diff & ~band).any(), rid


def test_sample_draws_the_peak_and_repeats_per_seed():
    logits = torch.zeros((3, 64))
    logits[torch.arange(3), torch.tensor([5, 17, 63])] = 80.0
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        assert _sample(logits, gen).tolist() == [5, 17, 63]
    flat = torch.zeros((4, 1000))
    draws = [_sample(flat, torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert len(set(draws[0].tolist())) > 1


def test_sampled_serve_repeats_per_seed():
    _, tc = _cfgs()
    runs = [serve(tc, B, 4, 6, seed=s, greedy=False, device="cpu")
            for s in (3, 3)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    assert runs[0]["tokens"].shape == (B, 6)
    assert runs[0]["monitor"]["ticks"] == runs[1]["monitor"]["ticks"]


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(_cfgs()[1], 1, 2, 1)


def test_cli_lm_mode(capsys):
    main(["--mode", "lm", "--device", "cpu", "--arch", "llama3.2-1b",
          "--batch", "2", "--prompt-len", "6", "--gen", "5",
          "--backend", "cuda-q"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) == 4
    assert "tok/s" in lines[0] and "on cpu" in lines[0]
    assert lines[1].startswith("[serve] TEDA-flagged requests:")
    assert lines[2].startswith("[serve] monitor: ")
    assert lines[3].startswith("[serve] sample continuation (req 0):")
