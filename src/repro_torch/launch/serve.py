"""Serving gateway: continuous-batching TEDA detection.

`serve_streams` is the detection gateway, driven by the
`launch/batching.py` scheduler (admission queue, chunked prefill,
per-request telemetry, backpressure when every capacity bucket is
full): tenant streams (history + live samples, per-tenant sensitivity
`m`) arrive on a schedule, attach to engine slots, and are served
continuously.  It runs on the CUDA device unless the caller passes
`device="cpu"` (then the kernel backends run their plain versions).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode streams \\
        --requests 16 --history 256 --live 32 --backend cuda-q
    PYTHONPATH=src python -m repro_torch.launch.serve --mode streams \\
        --backend cuda-q --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --mode streams \\
        --backend cuda-q --shards 4 --rebalance-every 4

`shards=K` (`--shards`) serves over a sharded pool: K shards with
consistent-hash routing and, with `rebalance_every=N`
(`--rebalance-every`), live migration every N ticks.

Not ported from the reference: the LM monitor demo `serve` (`--mode
lm`), which needs the LM substrate (ROADMAP.md section 1, item 6).
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from typing import Sequence, Tuple

import numpy as np

from repro_torch.launch.batching import BatchingScheduler, Request

__all__ = ["serve_streams"]


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
    ap.add_argument("--mode", default="streams", choices=["lm", "streams"])
    ap.add_argument("--backend", default="scan")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
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

    if args.mode == "lm":
        sys.exit("serve: --mode lm (the LM monitor demo) is not ported "
                 "yet; it waits for the LM substrate, ROADMAP.md "
                 "section 1, item 6")
    fmt = None
    if args.backend == "cuda-q":
        from repro_torch.fixedpoint import QFormat
        fmt = QFormat(32, 20)  # the README's Q11.20 reference format

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
