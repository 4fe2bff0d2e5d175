"""Serving gateway: continuous-batching TEDA detection + LM monitoring.

Two entry points, both driven by the `launch/batching.py` scheduler
(admission queue, chunked prefill, per-request telemetry, backpressure
when every capacity bucket is full).  Both run on the CUDA device
unless the caller passes `device="cpu"` (then the kernel backends run
their plain versions).

  * `serve_streams` — the generic detection gateway: tenant streams
    (history + live samples, per-tenant sensitivity `m`) arrive on a
    schedule, attach to engine slots, and are served continuously.

        PYTHONPATH=src python -m repro_torch.launch.serve --mode streams \\
            --requests 16 --history 256 --live 32 --backend cuda-q
        PYTHONPATH=src python -m repro_torch.launch.serve --mode streams \\
            --backend cuda-q --shards 4 --rebalance-every 4

    `shards=K` (`--shards`) serves over a sharded pool: K shards with
    consistent-hash routing and, with `rebalance_every=N`
    (`--rebalance-every`), live migration every N ticks.

  * `serve` — the LM demo: teacher-forces a prompt batch through the
    decode path, then decodes while per-request telemetry (logit
    entropy, max-logit) streams through the detection gateway:
    prompt-phase telemetry replays as chunked prefill (the monitor
    warms up on the tenant's own history), and decode-phase telemetry
    rides the per-tick trickle, one fused TEDA call per tick.  Flagged
    requests surface the way a production gateway would quarantine
    degenerate generations.

        PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
            --scale tiny --batch 4 --prompt-len 32 --gen 32 --device cpu
        PYTHONPATH=src python -m repro_torch.launch.serve \\
            --arch llama3.2-1b --scale full --backend cuda
        PYTHONPATH=src python -m repro_torch.launch.serve \\
            --arch zamba2-2.7b --scale tiny --device cpu --backend cuda-q

    Every decoder family serves (dense, MoE, the Mamba2 hybrid, xLSTM:
    `init_cache` gives each block kind its cache); the encoder-decoder
    is refused, as in the reference.

The telemetry is computed on the device inside the decode step; the
loop hands the host-side scheduler one small (B, 2) array per
generated token, its one device round trip per token.
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.batching import BatchingScheduler, Request

__all__ = ["serve_streams", "make_decode_step", "serve", "serve_prompts",
           "open_monitor", "monitor_tick", "close_monitor"]

N_CHANNELS = 2  # per-request telemetry: (entropy, max-logit)


# --------------------------------------------------------------- gateway
def serve_streams(streams: Sequence[tuple],
                  *, backend: str = "scan",
                  buckets: Tuple[int, ...] = (8, 16, 32, 64),
                  chunk_t: int = 32, m: float = 3.0, fmt=None,
                  queue_limit: int = 64,
                  arrivals_per_tick=None,
                  feed_per_tick: int = 1, collect: bool = False,
                  measure_latency: bool = True,
                  max_ticks: int = 1_000_000,
                  registry=None, tracer=None, on_event=None,
                  **engine_opts) -> dict:
    """Serve tenant streams through the continuous-batching scheduler.

    `streams` is a sequence of (rid, history, live, m) or
    (rid, history, live, m, priority) tuples — history replays as
    chunked prefill on admission, live samples are fed `feed_per_tick`
    per tick (the decode trickle), `m` is the tenant's sensitivity
    (None: the gateway default), `priority` its admission class (see
    `BatchingScheduler(class_weights=)`; weights pass through
    `engine_opts`, e.g. `class_weights={"latency": 4, "bulk": 1}`).
    Under `backend="ensemble"` a tuple may extend to
    (rid, history, live, m, priority, detectors, vote) — the tenant's
    detector subset and vote mode, threaded to its slot at admission.
    `arrivals_per_tick` models offered load (None: everything offered
    up front); arrivals the admission queue rejects are re-offered
    next tick, counted in `rejected_submits` — the backpressure
    measure.

    With `measure_latency=False` the scheduler runs its async
    double-buffered loop (host bookkeeping overlapped with device
    compute); True keeps the synchronous loop so per-chunk wall times
    are honest latencies.  `pipeline_depth` (via `engine_opts`) keeps
    up to that many fused calls in flight with slot fencing —
    gateway results stay bit-exact with depth 1, but
    `measure_latency=True` overrides it back to the synchronous loop,
    so depth and honest per-call latencies are mutually exclusive
    knobs.  `device` (also via `engine_opts`) picks the engines'
    device: CUDA when absent.  `shards=K` with `rebalance_every=N` (and
    `shard_devices`, via `engine_opts`) serves over a K-shard pool; the
    result then carries `shards`, `migrations` and the final
    `imbalance`, and each request its `shard` and `migrations`.

    Observability (`repro_torch.obs`): `registry`/`tracer` pass through
    to the scheduler (and down to pool + engines); `on_event` is a
    callback receiving each streamed `Event` (admitted /
    chunk_retired / done / evicted) as it retires — the push side of
    `BatchingScheduler.subscribe()`.

    Returns sustained rates, latency percentiles, queue-wait stats,
    per-priority-class telemetry, per-request telemetry, and a
    `metrics` registry snapshot.
    """
    class _Rec:
        __slots__ = ("req", "live", "fed", "closed")

        def __init__(self, rid, history, live, m_req,
                     priority="default", detectors=None, vote=None):
            self.req = Request(rid, np.asarray(history, np.float32),
                               priority=priority,
                               detectors=(None if detectors is None
                                          else tuple(detectors)),
                               vote=vote)
            self.req.m = m_req
            self.live = np.asarray(live, np.float32).reshape(-1)
            self.fed = 0
            self.closed = False

    recs = {s[0]: _Rec(*s) for s in streams}
    if len(recs) != len(streams):
        raise ValueError("duplicate request ids in streams")
    # retention must cover the whole run: every request's telemetry is
    # read back after the drain, so none may be evicted mid-run
    engine_opts["keep_finished"] = max(
        engine_opts.get("keep_finished", 1024), len(recs))
    sched = BatchingScheduler(
        backend, buckets=buckets, chunk_t=chunk_t, m=m, fmt=fmt,
        queue_limit=queue_limit, collect=collect,
        measure_latency=measure_latency, registry=registry,
        tracer=tracer, **engine_opts)
    if on_event is not None:
        sched.events.attach(on_event)
    waiting = deque(recs.values())
    total_samples = sum(len(r.req.history) + len(r.live)
                        for r in recs.values())

    t0 = time.perf_counter()
    while sched.completed < len(recs):
        if sched.tick_no >= max_ticks:
            raise RuntimeError(f"serve_streams exceeded {max_ticks} ticks")
        budget = len(waiting) if arrivals_per_tick is None \
            else arrivals_per_tick
        while waiting and budget > 0:
            rec = waiting[0]
            if not sched.submit(rec.req):
                break  # queue full: re-offer this arrival next tick
            waiting.popleft()
            budget -= 1
            if not len(rec.live):
                sched.close(rec.req.rid)
                rec.closed = True
        for rec in recs.values():
            if rec.closed or rec.req.rid not in sched.stats_by_rid:
                continue
            take = min(feed_per_tick, len(rec.live) - rec.fed)
            if take:
                sched.feed(rec.req.rid, rec.live[rec.fed:rec.fed + take])
                rec.fed += take
            if rec.fed == len(rec.live):
                sched.close(rec.req.rid)
                rec.closed = True
        sched.step()
    wall = time.perf_counter() - t0

    agg = sched.stats()
    waits = [sched.telemetry(rid).queue_wait_ticks for rid in recs]
    per_request = {
        rid: {"samples": st.samples, "flags": st.flags,
              "queue_wait_ticks": st.queue_wait_ticks,
              "prefill_chunks": st.prefill_chunks,
              "decode_steps": st.decode_steps, "slot": st.slot,
              "shard": st.shard, "migrations": st.migrations,
              "priority": st.priority,
              "det_flags": dict(st.det_flags),
              # ensemble backend only: per-detector mean score over the
              # request's retired samples (the kernel's float score
              # streams, threaded engine -> pool -> scheduler events)
              "det_scores": {d: s / max(st.samples, 1)
                             for d, s in st.det_scores.items()}}
        for rid, st in ((rid, sched.telemetry(rid)) for rid in recs)}
    return {
        "backend": backend, "chunk_t": chunk_t,
        "requests": len(recs), "samples": total_samples,
        "wall_s": wall, "ticks": agg["ticks"],
        "requests_per_s": len(recs) / wall,
        "samples_per_s": total_samples / wall,
        "rejected_submits": agg["rejected_submits"],
        "chunk_latency": agg["chunk_latency"],
        "short_ticks": agg["short_ticks"],
        "programs": agg["programs"],
        "classes": agg["classes"],
        "queue_wait_ticks_p50": float(np.percentile(waits, 50)),
        "queue_wait_ticks_p95": float(np.percentile(waits, 95)),
        "flagged": sorted(rid for rid in recs
                          if sched.telemetry(rid).flags),
        "pool": agg["pool"],
        # sharded gateway only (shards > 1 via engine_opts)
        **{k: agg[k] for k in ("shards", "migrations", "imbalance")
           if k in agg},
        "per_request": per_request,
        "metrics": sched.registry.snapshot(),
        "_scheduler": sched,  # for tests and chip_smoke.py
    }


# --------------------------------------------------------------- LM demo
def make_decode_step(cfg, greedy: bool):
    """The decode step with the telemetry computed on the device.

    `step(params, tok, pos, caches, sampler)` returns (next token,
    caches, entropy, max-logit), the last two (B,) rows for the monitor,
    with no host round trip.  Greedy decoding takes the first maximal
    logit (as `jnp.argmax` does).  Sampling draws Gumbel noise from
    `sampler`, a `torch.Generator` on the model's device: the reference's
    `jax.random.categorical(fold_in(key, pos))` stream cannot be
    reproduced, so sampled tokens differ from the reference's.
    """
    from repro_torch.models import lm_decode_step

    def step(params, tok, pos, caches,
             sampler: Optional[torch.Generator]):
        logits, caches = lm_decode_step(params, tok, pos, caches, cfg)
        ent, mx = _telemetry(logits)
        nxt = (torch.argmax(logits, dim=-1) if greedy
               else _sample(logits, sampler))
        return nxt, caches, ent, mx

    return step


def _sample(logits, gen: Optional[torch.Generator]):
    """One draw per row from softmax(logits), by Gumbel-max:
    argmax(logits + G) with G = -log(E), E ~ Exp(1) from `gen`, all on
    the device (`torch.multinomial` would read its input back to check
    it)."""
    noise = torch.empty_like(logits).exponential_(generator=gen)
    noise.clamp_(min=torch.finfo(noise.dtype).tiny)
    return torch.argmax(logits - noise.log(), dim=-1)


def _telemetry(logits):
    """(B, V) float32 logits -> (log-softmax entropy (B,), max (B,))."""
    logp = torch.log_softmax(logits, dim=-1)
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    return ent, torch.amax(logits, dim=-1)


def _monitor_buckets(n_slots: int) -> Tuple[int, ...]:
    """Bucket ladder reaching at least n_slots (powers of two from 8)."""
    ladder = [8]
    while ladder[-1] < n_slots:
        ladder.append(ladder[-1] * 2)
    return tuple(ladder)


def _rid(b: int, c: int) -> str:
    return f"req{b}/ch{c}"


def open_monitor(hist: np.ndarray, *, backend: str = "scan",
                 m: float = 3.5, chunk_t: int = 16, fmt=None,
                 device=None) -> BatchingScheduler:
    """The LM monitor: one detection request per request x channel,
    admitted with its prompt telemetry `hist` (P, B, 2) as history, the
    queue sized to the request set."""
    batch = hist.shape[1]
    sched = BatchingScheduler(
        backend, buckets=_monitor_buckets(batch * N_CHANNELS),
        chunk_t=chunk_t, m=m, fmt=fmt, queue_limit=batch * N_CHANNELS,
        collect=True, device=device)
    for b in range(batch):
        for c in range(N_CHANNELS):
            if not sched.submit(Request(_rid(b, c), hist[:, b, c], m=m)):
                raise RuntimeError("the monitor queue is sized to the "
                                   "request set, yet refused a request")
    return sched


def monitor_tick(sched: BatchingScheduler, tel: np.ndarray) -> None:
    """Feed each request x channel its sample of one token's telemetry
    `tel` (B, 2), then run one scheduler tick."""
    for b in range(tel.shape[0]):
        for c in range(N_CHANNELS):
            sched.feed(_rid(b, c), tel[b, c:c + 1])
    sched.step()


def close_monitor(sched: BatchingScheduler, batch: int,
                  gen: int) -> list:
    """Close every member, drain, and return the requests flagged on
    their decode-phase verdicts (any channel): the prompt is the
    tenant's own baseline, not the generation under scrutiny."""
    for b in range(batch):
        for c in range(N_CHANNELS):
            sched.close(_rid(b, c))
    sched.drain()
    return [b for b in range(batch)
            if any(sched.results(_rid(b, c))["outlier"][-gen:].any()
                   for c in range(N_CHANNELS))]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_prompts(params, prompts, cfg, gen: int, *, m: float = 3.5,
                  seed: int = 0, greedy: bool = True,
                  backend: str = "scan", chunk_t: int = 16,
                  fmt=None) -> dict:
    """`serve`'s work on a given model and prompt batch (B, P), on the
    model's device.  The decode loop runs under inference mode and
    writes the cache in place; the only device round trip per token is
    the (B, 2) telemetry fetch that feeds the monitor."""
    from repro_torch.models import init_cache, lm_decode_step

    if cfg.family == "encdec":
        raise ValueError("serve targets decoder-only LMs")
    dev = next(params.parameters()).device
    if not isinstance(prompts, torch.Tensor):  # numpy: a writable copy
        prompts = torch.from_numpy(np.array(prompts))
    prompts = prompts.to(dev)
    batch, prompt_len = prompts.shape
    caches = init_cache(cfg, batch, prompt_len + gen, dtype=torch.float32,
                        device=dev)
    step = make_decode_step(cfg, greedy)
    sampler = None if greedy else torch.Generator(device=dev).manual_seed(seed)

    with torch.inference_mode():
        # prefill by teacher-forcing the prompt through the decode path,
        # banking per-token telemetry: it becomes the monitor's chunked-
        # prefill history
        _sync(dev)
        t0 = time.perf_counter()
        prompt_tel = []
        for i in range(prompt_len - 1):
            logits, caches = lm_decode_step(params, prompts[:, i], i,
                                            caches, cfg)
            prompt_tel.append(torch.stack(_telemetry(logits), dim=-1))
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        # (prompt_len - 1, B, 2) on the host, one request x channel
        # stream each (empty for prompt_len == 1: the monitor starts
        # cold)
        hist = (torch.stack(prompt_tel).cpu().numpy() if prompt_tel
                else np.zeros((0, batch, N_CHANNELS), np.float32))

        sched = open_monitor(hist, backend=backend, m=m, chunk_t=chunk_t,
                             fmt=fmt, device=dev)
        outs, rows = [], []
        tok = prompts[:, -1]
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(gen):
            tok, caches, ent, mx = step(params, tok, prompt_len - 1 + i,
                                        caches, sampler)
            outs.append(tok)
            tel = torch.stack([ent, mx], dim=-1).cpu().numpy()  # (B, 2)
            rows.append(tel)
            monitor_tick(sched, tel)
        flagged = close_monitor(sched, batch, gen)
        toks_out = (torch.stack(outs, dim=1).cpu().numpy() if outs
                    else np.zeros((batch, 0), np.int64))
        decode_s = time.perf_counter() - t0

    return {
        "tokens": toks_out,
        "flagged_requests": flagged,
        "prefill_tok_s": batch * (prompt_len - 1) / prefill_s,
        "decode_tok_s": batch * gen / decode_s,
        "monitor": sched.stats(),
        # for tests and chip_smoke.py: the monitor's input rows
        # (prompt history, decode rows) and the scheduler
        "telemetry": (hist, np.asarray(rows, np.float32).reshape(
            gen, batch, N_CHANNELS)),
        "_scheduler": sched,
    }


def serve(cfg, batch: int, prompt_len: int, gen: int, m: float = 3.5,
          seed: int = 0, greedy: bool = True, backend: str = "scan",
          chunk_t: int = 16, fmt=None, device=None) -> dict:
    """The LM demo on `device` (the card unless the caller names
    another): random weights and prompts drawn from `seed` on CPU
    generators (the same tokens on any device), then `serve_prompts`.
    Returns tokens (B, gen), flagged_requests, prefill_tok_s,
    decode_tok_s and the monitor's stats."""
    from repro_torch.engine.engine import resolve_device
    from repro_torch.models import init_lm_params

    if cfg.family == "encdec":
        raise ValueError("serve targets decoder-only LMs")
    dev = resolve_device(device)
    params = init_lm_params(seed, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed))
    return serve_prompts(params, prompts, cfg, gen, m=m, seed=seed,
                         greedy=greedy, backend=backend, chunk_t=chunk_t,
                         fmt=fmt)


# ------------------------------------------------------------------- CLI
def _demo_streams(n: int, history: int, live: int, seed: int = 0):
    """Synthetic tenant mix: drifting means, one loud anomaly burst,
    every fourth tenant in the latency class (the rest are bulk)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = rng.normal(loc=i * 0.1, size=(history,)).astype(np.float32)
        lv = rng.normal(loc=i * 0.1, size=(live,)).astype(np.float32)
        if live and i % 3 == 0:
            lv[live // 2] += 15.0  # anomaly burst mid-stream
        cls = "latency" if i % 4 == 0 else "bulk"
        out.append((f"tenant-{i}", h, lv, 2.0 + (i % 3), cls))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=["lm", "streams"])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--backend", default="scan")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and engines (default: "
                         "cuda; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--chunk-t", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--history", type=int, default=256)
    ap.add_argument("--live", type=int, default=32)
    ap.add_argument("--arrivals-per-tick", type=int, default=None)
    ap.add_argument("--decode-t", type=int, default=1,
                    help="short call length for decode-only ticks")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="in-flight fused calls (>1 runs the async "
                         "loop: latency measurement switches off)")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the pool (consistent-hash routing + "
                         "live migration)")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="run the occupancy rebalancer every N ticks "
                         "(0: never; sharded gateway only)")
    args = ap.parse_args(argv)

    fmt = None
    if args.backend == "cuda-q":
        from repro_torch.fixedpoint import QFormat
        fmt = QFormat(32, 20)  # the README's Q11.20 reference format

    if args.mode == "lm":
        from repro_torch.configs import get_config
        cfg = get_config(args.arch)
        if args.scale == "tiny":
            cfg = cfg.reduced()
        res = serve(cfg, args.batch, args.prompt_len, args.gen,
                    backend=args.backend, chunk_t=args.chunk_t, fmt=fmt,
                    device=args.device)
        dev = res["_scheduler"].pool.engine.device
        print(f"[serve] prefill {res['prefill_tok_s']:.1f} tok/s, "
              f"decode {res['decode_tok_s']:.1f} tok/s on {dev}")
        print(f"[serve] TEDA-flagged requests: {res['flagged_requests']}")
        print(f"[serve] monitor: {res['monitor']['ticks']} ticks, "
              f"pool {res['monitor']['pool']}")
        print(f"[serve] sample continuation (req 0): "
              f"{res['tokens'][0][:16].tolist()}")
        return

    res = serve_streams(
        _demo_streams(args.requests, args.history, args.live),
        backend=args.backend, chunk_t=args.chunk_t, fmt=fmt,
        device=args.device, decode_t=args.decode_t,
        pipeline_depth=args.pipeline_depth,
        shards=args.shards, rebalance_every=args.rebalance_every,
        # depth > 1 only pipelines in the async loop
        measure_latency=args.pipeline_depth <= 1,
        class_weights={"latency": 4.0, "bulk": 1.0},
        arrivals_per_tick=args.arrivals_per_tick)
    lat = res["chunk_latency"]
    dev = res["_scheduler"].pool.engine.device
    print(f"[serve] {res['requests']} requests, "
          f"{res['samples']} samples in {res['wall_s']:.2f}s "
          f"({res['requests_per_s']:.1f} req/s, "
          f"{res['samples_per_s']:.0f} samples/s) on {dev}")
    print(f"[serve] chunk latency p50 {lat.get('p50_ms', 0):.2f}ms "
          f"p95 {lat.get('p95_ms', 0):.2f}ms, "
          f"queue wait p95 {res['queue_wait_ticks_p95']:.0f} ticks, "
          f"{res['rejected_submits']} backpressured submits, "
          f"{res['short_ticks']} decode-short ticks")
    for cls, c in sorted(res["classes"].items()):
        print(f"[serve]   class {cls}: {c['completed']} done, "
              f"queue wait p95 "
              f"{c.get('queue_wait_ticks_p95', 0):.0f} ticks")
    if args.shards > 1:
        print(f"[serve] {res['shards']} shards, "
              f"{res['migrations']} migrations, "
              f"final imbalance {res['imbalance']}")
    print(f"[serve] flagged tenants: {res['flagged']}")


if __name__ == "__main__":
    main()
