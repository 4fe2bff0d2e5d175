"""Continuous-batching request scheduler: an engine slot *is* the
request lifecycle.

The paper's FPGA keeps detection at line rate because the pipeline
never drains between streams; the software analogue is continuous
batching: requests attach to a `SlotPool` slot on arrival, replay
their history through the engine in fixed-size chunks (chunked
prefill — the chunk shape is constant however long the history),
interleave with the decode-phase trickle of live samples every tick,
and detach/recycle the slot on completion.

ONE (chunk_t, C) call shape per capacity bucket serves every tenant
mix: each tick makes a single fused engine call in which slot c
retires `min(pending_c, chunk_t)` samples via the engine's per-slot
`valid_lens` vector — a prefill-heavy slot rides the full chunk, a
decode-phase slot retires its one live sample, and a slot with nothing
pending is suspended at vlen=0 (frozen state, no flags, no detach) —
all in the same call.

Four scheduler-level optimisations ride on that fused call:

  * **Async double-buffered tick loop** — `step()` dispatches the
    fused call and returns without fetching its outputs (the kernels
    run on the engine's CUDA stream while the host goes on); a
    `torch.cuda.Event` recorded right after the dispatch says when
    they have landed.  The next tick's host bookkeeping
    (admission, `take`, vlens assembly) overlaps with the in-flight
    device compute, and the *previous* tick's outputs are fetched only
    then — or earlier, when `results()`/`telemetry()` consume them or
    a request completes.  Bit-exact with the synchronous loop: the
    engine-call sequence depends only on host-side counters, never on
    fetched verdicts (`tests/test_torch_batching.py`).
    `measure_latency=True` keeps the fully synchronous loop (the
    dispatch event is synchronized after every call) so per-call wall
    times stay honest.

  * **Deep dispatch pipeline** — `pipeline_depth=d` keeps up to `d`
    fused calls dispatched-but-unfetched at once.  Slots touched by a
    still-in-flight call are *fenced* from re-dispatch (each slot sits
    in at most one in-flight call, so its chunks are fetched in
    dispatch order no matter when each call retires), which makes
    retirement safely out-of-order: any in-flight call whose outputs
    have already landed retires immediately, and the oldest call is
    force-retired when the pipeline is full — or when every ready slot
    is fenced, so a tick with work always dispatches.  Gateway-visible
    results are bit-exact with depth 1 (chunk-exactness makes the
    per-slot sample stream independent of how ticks partition it).
    Depth beyond 1 pays off under staggered load — admission waves and
    decode trickles touching disjoint slot sets — where successive
    calls genuinely overlap on device; under uniform load every ready
    slot is fenced by the previous call and the loop degrades
    gracefully to the depth-1 double buffer.  `measure_latency=True`
    overrides the pipeline (every call blocks at dispatch), keeping
    wall times honest.

  * **Adaptive chunk_t** — when every ready slot is in decode phase
    (pending <= `decode_t`, default 1), the tick rides a short cached
    (decode_t, C) program instead of the full (chunk_t, C) one:
    decode-only ticks stop paying a chunk_t-deep call to retire one
    sample per slot.  Both shapes are recorded per capacity bucket
    (keyed on (capacity, t) — see `SlotPool.stats()["programs"]`), so
    after warmup no tick adds a new shape.

  * **Priority classes / weighted admission** — `Request(priority=)`
    names an admission class; `class_weights` gives each class a
    weighted-deficit share of slot acquisitions, so a burst of bulk
    prefills cannot starve latency-class tenants.  Per-class
    queue-wait/latency telemetry is in `stats()["classes"]`.

Ragged interleaved execution is bit-exact with running each request
alone — per-slot valid-length masking inside the kernels plus slot
independence, verified end-to-end by tests/test_torch_batching.py on
the Q path.

Admission is a bounded queue: `submit` returns False when the queue is
full (caller backpressure), and requests wait in their class queue
while every bucket of the pool is occupied (`PoolFull` backpressure
inside the scheduler).  Per-request telemetry (queue wait, per-call
(wall, retired) latency pairs, flag counts) is kept for the serving
benchmark and the gateway in `launch/serve.py`.

On the CPU (`device="cpu"`) the kernel backends run their plain
versions and a call's outputs have landed when `process` returns.  Not
ported from the reference: `shards > 1` (the sharded pool).
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine import PoolFull, SlotPool
from repro_torch.obs import (EventBus, LATENCY_MS_BUCKETS, MetricsRegistry,
                             NULL_TRACER, TICK_BUCKETS, auto_name)

__all__ = ["Request", "RequestStats", "BatchingScheduler",
           "EvictedRequest"]

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"


class EvictedRequest(KeyError):
    """The request completed but its record aged out of the
    `keep_finished` retention window — distinct from a rid that was
    never submitted, so callers can tell "gone" from "wrong"."""


@dataclass
class Request:
    """One tenant stream: a history to replay + live samples to come.

    `m` is this tenant's outlier sensitivity (None: scheduler default).
    `closed` requests complete once their pending samples drain; open
    requests keep their slot and wait for `feed`.  `priority` names
    the admission class (see `BatchingScheduler(class_weights=)`).

    Under the ensemble backend, `detectors` selects this tenant's
    detector subset and `vote` its vote mode / threshold fraction
    (None: the backend's defaults) — threaded to the slot at admission
    (`SlotPool.acquire` -> `StreamEngine.attach`).
    """

    rid: str
    history: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.float32))
    m: Optional[float] = None
    closed: bool = False
    priority: str = "default"
    detectors: Optional[Tuple[str, ...]] = None
    vote: Optional[object] = None


@dataclass
class RequestStats:
    """Per-request telemetry, filled in as the lifecycle advances.

    `chunk_latency_s` holds (wall_s, retired_this_call) pairs: the
    fused call's wall time is shared by every member slot, so honest
    percentiles weight each observation by the samples that request
    actually retired in the call, instead of attributing the whole
    wall to a slot that retired one sample.
    """

    rid: str
    submitted_tick: int
    priority: str = "default"
    admitted_tick: Optional[int] = None
    done_tick: Optional[int] = None
    slot: Optional[int] = None
    # sharded scheduling only (not ported: always None and 0 here): the
    # current shard and how many times the rebalancer moved this stream
    shard: Optional[int] = None
    migrations: int = 0
    samples: int = 0
    flags: int = 0
    prefill_chunks: int = 0
    decode_steps: int = 0
    chunk_latency_s: List[Tuple[float, int]] = field(default_factory=list)
    # ensemble backend only: per-detector flag counts ({name: count},
    # selection-masked — an unselected detector never appears)
    det_flags: Dict[str, int] = field(default_factory=dict)
    # ensemble backend only: per-detector score-stream sums over every
    # retired sample ({name: float} — the kernel's float score streams,
    # NOT selection-gated; divide by `samples` for the running mean)
    det_scores: Dict[str, float] = field(default_factory=dict)

    @property
    def queue_wait_ticks(self) -> Optional[int]:
        if self.admitted_tick is None:
            return None
        return self.admitted_tick - self.submitted_tick


class _Run:
    """Internal per-request runtime record (admitted requests only)."""

    __slots__ = ("req", "slot", "pending", "cursor", "phase",
                 "stats", "ecc_parts", "outlier_parts", "hist_len",
                 "consumed", "inflight")

    def __init__(self, req: Request, slot: int, stats: RequestStats):
        self.req = req
        self.slot = slot
        self.pending = np.asarray(req.history, np.float32).reshape(-1)
        self.cursor = 0
        # the replayed prefix: everything backlogged at admission is
        # prefill; samples fed after admission are the decode trickle
        self.hist_len = self.pending.shape[0]
        self.consumed = 0
        self.phase = PREFILL if self.avail else DECODE
        self.stats = stats
        self.ecc_parts: List[np.ndarray] = []
        self.outlier_parts: List[np.ndarray] = []
        self.inflight = 0  # dispatched calls not yet host-fetched

    @property
    def avail(self) -> int:
        return self.pending.shape[0] - self.cursor

    def push(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        # drop the consumed prefix before growing, keeping push O(new)
        if self.cursor:
            self.pending = self.pending[self.cursor:]
            self.cursor = 0
        self.pending = np.concatenate([self.pending, samples])

    def take(self, n: int) -> np.ndarray:
        out = self.pending[self.cursor:self.cursor + n]
        self.cursor += n
        self.consumed += n
        if self.phase == PREFILL and self.consumed >= self.hist_len:
            self.phase = DECODE  # history cursor passed the prefix
        return out


class _InFlight:
    """One dispatched-but-unfetched fused call (its outputs are device
    tensors the kernels may still be writing; fetching them is the sync
    point)."""

    __slots__ = ("out", "members", "t_len", "tick", "t0", "sync_wall",
                 "done")

    def __init__(self, out, members, t_len, tick, t0, sync_wall, done):
        self.out = out              # {"ecc", "outlier"} device tensors
        self.members = members      # [(run, col, n)] at dispatch time
        self.t_len = t_len
        self.tick = tick
        self.t0 = t0
        self.sync_wall = sync_wall  # honest wall when measured sync
        # torch.cuda.Event recorded on the engine's stream right after
        # the dispatch; None on the CPU, where outputs land at return
        self.done = done


def _host_ready(inf: _InFlight) -> bool:
    """True when a dispatched call's outputs have already landed (its
    fetch would not block): the dispatch event's `query()`, and True on
    the CPU.  The depth bound still forces retirement, so this is an
    optimization, never a liveness requirement."""
    return inf.done is None or inf.done.query()


class BatchingScheduler:
    """Continuous batching of TEDA detection requests over a SlotPool.

    >>> sched = BatchingScheduler("cuda", chunk_t=64,
    ...                           class_weights={"latency": 4, "bulk": 1})
    >>> sched.submit(Request("tenant-a", history, m=2.5,
    ...                      priority="latency"))
    >>> sched.feed("tenant-a", live_chunk); sched.step()
    >>> sched.close("tenant-a"); sched.drain()
    >>> sched.results("tenant-a")["outlier"]

    One `step()` = admit what the deficit-weighted class queues allow,
    one fused ragged engine call retiring min(pending, t) samples per
    slot on the adaptive (t, C) program, retire the *previous* tick's
    host-fetched outputs, complete what finished.  All engine options
    (`device`, `fmt`, ...) pass through to the pool; `shards` must be 1
    (the sharded pool is not ported).
    """

    def __init__(self, backend: str = "scan", *,
                 buckets: Tuple[int, ...] = (8, 16, 32, 64),
                 chunk_t: int = 32, decode_t: int = 1, m: float = 3.0,
                 queue_limit: int = 64, collect: bool = True,
                 measure_latency: bool = False,
                 pipeline_depth: int = 1,
                 keep_finished: int = 1024,
                 call_log_len: int = 4096,
                 latency_log_len: int = 4096,
                 class_weights: Optional[Dict[str, float]] = None,
                 shards: int = 1,
                 registry=None, tracer=None,
                 name: Optional[str] = None,
                 **engine_opts):
        if chunk_t < 2:
            raise ValueError("chunk_t must be >= 2")
        if not 1 <= decode_t <= chunk_t:
            raise ValueError(
                f"decode_t must lie in [1, chunk_t={chunk_t}], "
                f"got {decode_t}")
        if int(shards) < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if int(shards) > 1:
            raise NotImplementedError(
                f"shards={shards}: the sharded pool (consistent-hash "
                "routing, live migration) is not ported yet; it is "
                "ROADMAP.md section 1, item 4")
        # observability (repro_torch.obs): the scheduler's counters
        # live in registry instruments — `stats()` reads them back, the
        # tracer records tick spans, the event bus streams verdicts at
        # retirement (`subscribe()`)
        self.registry = (MetricsRegistry() if registry is None
                         else registry)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.name = auto_name("sched") if name is None else str(name)
        self.events = EventBus()
        self._init_instruments()
        self.pool = SlotPool(backend, buckets=buckets, m=m,
                             registry=self.registry, tracer=self.tracer,
                             name=f"{self.name}/pool", **engine_opts)
        # detector-ensemble serving: when the backend carries a
        # detector axis, verdict columns come back as per-detector flag
        # bitmasks ("ecc" stream) and the scheduler accounts flags per
        # detector at retirement
        be = self.pool.engine.backend
        self._cuda = self.pool.device.type == "cuda"
        self._ensemble = bool(getattr(be, "aux_rows", 0))
        self._det_names: Tuple[str, ...] = tuple(
            getattr(be, "detectors", ()) or ())
        self.chunk_t = int(chunk_t)
        self.decode_t = int(decode_t)
        self.queue_limit = int(queue_limit)
        self.collect = collect
        # measure_latency=True keeps the synchronous loop (sync after
        # every fused call) so per-call wall times are honest device
        # latencies; False runs the async double-buffered loop
        self.measure_latency = measure_latency
        # pipeline_depth > 1 keeps several fused calls in flight with
        # slot fencing + out-of-order retirement (see module docs);
        # depth 1 is the double buffer, bit-for-bit
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        # retention caps: a forever-running gateway must not accumulate
        # per-request records without bound.  The oldest finished
        # requests (results + telemetry; their rid becomes reusable)
        # and engine-call log entries are evicted past these limits.
        self.keep_finished = int(keep_finished)
        self.latency_log_len = int(latency_log_len)
        if class_weights is not None and any(
                w <= 0 for w in class_weights.values()):
            raise ValueError(
                f"class weights must be positive: {class_weights}")
        self._weights: Dict[str, float] = dict(class_weights or {})
        self._ctor_classes = frozenset(self._weights)
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self.runs: Dict[str, _Run] = {}     # admitted, not yet done
        self._finished: Dict[str, _Run] = {}
        self._evicted: deque = deque(maxlen=max(4096, self.keep_finished))
        # rid -> live entries in the ring (a rid can re-enter after a
        # resubmit cycle, so membership is refcounted, not a set)
        self._evicted_counts: Dict[str, int] = {}
        self.stats_by_rid: Dict[str, RequestStats] = {}
        self.call_log: deque = deque(maxlen=int(call_log_len))
        self._inflight: deque = deque()   # dispatched, not host-fetched
        self._deferred_flagged: List[str] = []

    def _init_instruments(self) -> None:
        """Create the scheduler's registry instruments (the counters
        `tick_no`/`completed`/`rejected`/`short_ticks` read back as
        properties, plus the running latency/wait histograms that make
        `stats()` an O(1) snapshot)."""
        reg, lbl = self.registry, {"sched": self.name}
        self._c_ticks = reg.counter(
            "sched_ticks_total", "scheduler ticks",
            ("sched",)).labels(**lbl)
        self._c_short = reg.counter(
            "sched_short_ticks_total",
            "ticks that rode the short (decode_t, C) program",
            ("sched",)).labels(**lbl)
        self._c_completed = reg.counter(
            "sched_completed_total", "requests completed",
            ("sched",)).labels(**lbl)
        self._c_rejected = reg.counter(
            "sched_rejected_submits_total",
            "submits rejected by the bounded admission queue",
            ("sched",)).labels(**lbl)
        self._c_submitted = reg.counter(
            "sched_submitted_total", "requests accepted into a queue",
            ("sched",)).labels(**lbl)
        self._c_calls = reg.counter(
            "sched_calls_total", "fused engine calls dispatched",
            ("sched",)).labels(**lbl)
        self._c_samples = reg.counter(
            "sched_samples_retired_total",
            "samples retired across all requests",
            ("sched",)).labels(**lbl)
        self._c_flags = reg.counter(
            "sched_flags_total", "outlier verdicts raised",
            ("sched",)).labels(**lbl)
        self._g_inflight = reg.gauge(
            "sched_inflight_calls",
            "dispatched fused calls not yet host-fetched",
            ("sched",)).labels(**lbl)
        self._h_wall = reg.histogram(
            "sched_call_wall_ms",
            "fused-call wall time, weighted by samples retired",
            ("sched",), buckets=LATENCY_MS_BUCKETS).labels(**lbl)
        # per-class families: children created lazily per priority
        self._f_queued = reg.gauge(
            "sched_class_queued", "requests waiting for admission",
            ("sched", "class"))
        self._f_running = reg.gauge(
            "sched_class_running", "admitted, not yet completed",
            ("sched", "class"))
        self._f_cls_done = reg.counter(
            "sched_class_completed_total", "completions per class",
            ("sched", "class"))
        self._f_wait = reg.histogram(
            "sched_queue_wait_ticks", "submit-to-admission wait",
            ("sched", "class"), buckets=TICK_BUCKETS)
        self._f_latency = reg.histogram(
            "sched_request_latency_ticks", "submit-to-done latency",
            ("sched", "class"), buckets=TICK_BUCKETS)
        self._classes: Dict[str, dict] = {}
        # per-detector flag counts under the ensemble backend; children
        # created lazily per member detector at first flag
        self._f_det_flags = reg.counter(
            "sched_detector_flags_total",
            "per-detector flags raised (ensemble backend, "
            "selection-masked)", ("sched", "detector"))
        self._det_counters: Dict[str, object] = {}

    def _det_counter(self, detector: str):
        c = self._det_counters.get(detector)
        if c is None:
            c = self._f_det_flags.labels(sched=self.name,
                                         detector=detector)
            self._det_counters[detector] = c
        return c

    def _cls(self, cls: str) -> dict:
        """The cached per-class instrument children for one priority."""
        ch = self._classes.get(cls)
        if ch is None:
            lbl = {"sched": self.name, "class": cls}
            ch = {"queued": self._f_queued.labels(**lbl),
                  "running": self._f_running.labels(**lbl),
                  "completed": self._f_cls_done.labels(**lbl),
                  "wait": self._f_wait.labels(**lbl),
                  "latency": self._f_latency.labels(**lbl)}
            self._classes[cls] = ch
        return ch

    # ------------------------------------------- registry-backed counts
    @property
    def tick_no(self) -> int:
        return int(self._c_ticks.value)

    @property
    def completed(self) -> int:
        return int(self._c_completed.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def short_ticks(self) -> int:
        """Ticks that rode the (decode_t, C) program."""
        return int(self._c_short.value)

    def subscribe(self, maxlen: int = 4096):
        """A `Subscription` streaming this scheduler's events
        (admitted / chunk_retired / done / evicted) as they flush —
        verdicts at retirement, not completion.  See `repro.obs.events`."""
        return self.events.subscribe(maxlen=maxlen)

    # --------------------------------------------------------- intake
    @property
    def queue(self) -> List[Request]:
        """Queued-for-admission requests across every class (FIFO
        within a class; class interleaving is decided at admission)."""
        return [req for q in self._queues.values() for req in q]

    @property
    def queued_total(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, req: Request) -> bool:
        """Queue a request for admission; False = queue full (caller
        backpressure — retry later or shed load)."""
        if req.rid in self.stats_by_rid:
            raise ValueError(f"duplicate request id {req.rid!r}")
        if self.queued_total >= self.queue_limit:
            self._c_rejected.inc()
            return False
        # rid is reusable post-evict (stale ring entries age out inert)
        self._evicted_counts.pop(req.rid, None)
        if req.priority not in self._weights:
            # unknown classes admit at unit weight (documented) rather
            # than rejecting: the weights dict is a tuning knob
            self._weights[req.priority] = 1.0
        self.stats_by_rid[req.rid] = RequestStats(
            rid=req.rid, submitted_tick=self.tick_no,
            priority=req.priority)
        self._queues.setdefault(req.priority, deque()).append(req)
        self._c_submitted.inc()
        self._cls(req.priority)["queued"].inc()
        return True

    def feed(self, rid: str, samples) -> None:
        """Append live (decode-phase) samples to a request's stream."""
        run = self.runs.get(rid)
        if run is not None:
            if run.req.closed:
                raise ValueError(f"request {rid!r} is closed")
            run.push(samples)
            return
        for req in self.queue:  # not yet admitted: samples are backlog
            if req.rid == rid:
                if req.closed:
                    raise ValueError(f"request {rid!r} is closed")
                req.history = np.concatenate(
                    [np.asarray(req.history, np.float32).reshape(-1),
                     np.asarray(samples, np.float32).reshape(-1)])
                return
        raise KeyError(f"unknown or finished request {rid!r}")

    def close(self, rid: str) -> None:
        """No more live samples: the request completes once drained."""
        run = self.runs.get(rid)
        if run is not None:
            run.req.closed = True
            return
        for req in self.queue:
            if req.rid == rid:
                req.closed = True
                return
        raise KeyError(f"unknown or finished request {rid!r}")

    # --------------------------------------------------------- the tick
    def _admit(self, events: dict) -> None:
        """Weighted-deficit round robin across the class queues.

        Every pass tops each backlogged class's deficit up by its
        weight; a class admits heads while its deficit covers the unit
        cost.  Drained classes are pruned entirely (no deficit
        hoarding, and per-class state stays bounded by the *backlogged*
        class count, not every priority string ever seen — ctor-declared
        weights are the one retained configuration), `PoolFull` ends
        the round — leftover deficits carry to the next tick, so a
        class starved by backpressure catches up first.
        """
        while True:
            for c in [c for c, q in self._queues.items() if not q]:
                del self._queues[c]
                self._deficit.pop(c, None)
                if c not in self._ctor_classes:
                    self._weights.pop(c, None)
            backlogged = list(self._queues)
            if not backlogged:
                return
            # top every backlogged class up *before* admitting, so a
            # round cut short by PoolFull credits all of them equally
            for cls in backlogged:
                self._deficit[cls] = (self._deficit.get(cls, 0.0)
                                      + self._weights[cls])
            for cls in backlogged:
                q = self._queues[cls]
                while q and self._deficit[cls] >= 1.0:
                    req = q[0]
                    try:
                        slot = int(self.pool.acquire(
                            1, m=req.m, detectors=req.detectors,
                            vote=req.vote)[0])
                    except PoolFull:
                        return  # whole pool full: round over
                    q.popleft()
                    self._deficit[cls] -= 1.0
                    st = self.stats_by_rid[req.rid]
                    st.admitted_tick = self.tick_no
                    st.slot = slot
                    self.runs[req.rid] = _Run(req, slot, st)
                    events["admitted"].append(req.rid)
                    ch = self._cls(req.priority)
                    ch["queued"].dec()
                    ch["running"].inc()
                    ch["wait"].observe(st.queue_wait_ticks)
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "admit", tick=self.tick_no, rid=req.rid,
                            slot=slot, cls=req.priority)
                    self.events.publish(
                        "admitted", self.tick_no, req.rid, slot=slot,
                        priority=req.priority)

    def _dispatch(self, members: List[_Run]) -> None:
        """One fused ragged (t, C) engine call: slot c retires
        min(pending_c, t) samples via the per-slot valid-length vector;
        everyone else is suspended at vlen=0.  Decode-only ticks (every
        member's pending <= decode_t) ride the short (decode_t, C) call
        instead of the full chunk."""
        cap = self.pool.capacity
        t_len = self.chunk_t
        if all(r.avail <= self.decode_t for r in members):
            t_len = self.decode_t
            self._c_short.inc()
        x = np.zeros((t_len, cap), np.float32)
        vlens = np.zeros((cap,), np.int32)
        mem = []
        for run in members:
            n = min(run.avail, t_len)
            x[:n, run.slot] = run.take(n)
            vlens[run.slot] = n
            run.inflight += 1
            mem.append((run, run.slot, n))
        self._c_calls.inc()
        span = (self.tracer.span(
                    "dispatch", device=True, tick=self.tick_no,
                    t=t_len, slots=len(mem),
                    samples=int(sum(n for _, _, n in mem)))
                if self.tracer.enabled else None)
        if span is not None:
            span.__enter__()
        t0 = time.perf_counter()
        out = self.pool.process(x, valid_lens=vlens)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.pool.device))
        sync_wall = None
        if self.measure_latency:
            if done is not None:
                done.synchronize()
            sync_wall = time.perf_counter() - t0
        if span is not None:
            span.__exit__(None, None, None)
        self._inflight.append(_InFlight(
            out, mem, t_len, self.tick_no, t0, sync_wall, done))
        self._g_inflight.set(len(self._inflight))

    def _retire(self, inf: _InFlight, events: Optional[dict]) -> None:
        """Fetch one in-flight call's outputs to host and account them.

        The `.cpu()` fetch is the sync point; in the async loop it
        lands one tick after dispatch, overlapped with the next call's
        device compute.  With `events=None` (a flush outside `step`),
        flagged rids are deferred into the next tick's events.
        Every member's verdict streams on the event bus here — this is
        the retirement moment, the earliest a verdict exists on host.
        """
        # the ensemble backend's "ecc" stream is the per-detector flag
        # bitmask — fetched even with collect=False, it feeds the
        # per-detector counters below
        want_ecc = self.collect or self._ensemble
        if self.tracer.enabled:
            with self.tracer.span("retire", tick=self.tick_no,
                                  dispatch_tick=inf.tick, t=inf.t_len,
                                  slots=len(inf.members)):
                outlier, ecc, scores = self._fetch(inf, want_ecc)
        else:
            outlier, ecc, scores = self._fetch(inf, want_ecc)
        wall = (inf.sync_wall if inf.sync_wall is not None
                else time.perf_counter() - inf.t0)
        retired = int(sum(n for _, _, n in inf.members))
        self.call_log.append({
            "kind": "fused", "t": inf.t_len, "slots": len(inf.members),
            "retired": retired,
            "wall_s": wall, "sync": inf.sync_wall is not None})
        # running latency instrument: each call weighted by the samples
        # it retired (stats() reads percentiles back O(1) — the old
        # per-call re-sort of the whole log is gone)
        self._h_wall.observe(wall * 1e3, weight=max(retired, 1))
        self._c_samples.inc(retired)
        stream = self.events.active
        flagged = (events["flagged"] if events is not None
                   else self._deferred_flagged)
        for run, slot, n in inf.members:
            st = run.stats
            st.samples += n
            if len(st.chunk_latency_s) < self.latency_log_len:
                st.chunk_latency_s.append((wall, n))
            col = outlier[:n, slot]
            nf = int(col.sum())
            st.flags += nf
            if nf:
                flagged.append(run.req.rid)
                self._c_flags.inc(nf)
            det_counts = None
            det_sums = None
            if self._ensemble:
                # bit d of the "ecc" bitmask column is detectors[d]
                col_bits = ecc[:n, slot].astype(np.int64)
                det_counts = {}
                for d, det in enumerate(self._det_names):
                    c = int(((col_bits >> d) & 1).sum())
                    if c:
                        det_counts[det] = c
                        self._det_counter(det).inc(c)
                        st.det_flags[det] = st.det_flags.get(det, 0) + c
                if scores is not None and n:
                    # row d of the score block is detectors[d]'s float
                    # score stream over this slot's retired prefix
                    det_sums = {}
                    for d, det in enumerate(self._det_names):
                        s = float(scores[d, :n, slot].sum())
                        det_sums[det] = s
                        st.det_scores[det] = (
                            st.det_scores.get(det, 0.0) + s)
            if n > 1:
                st.prefill_chunks += 1  # a multi-sample (chunked) ride
            else:
                st.decode_steps += 1    # the 1-sample decode trickle
            if self.collect:
                run.ecc_parts.append(ecc[:n, slot].copy())
                run.outlier_parts.append(col.copy())
            if stream:
                data = {"slot": slot, "n": n, "flags": nf,
                        "dispatch_tick": inf.tick,
                        "outlier": col.copy()}
                if self.collect:
                    data["ecc"] = ecc[:n, slot].copy()
                if det_counts is not None:
                    data["det_flags"] = det_counts
                    data["detectors"] = self._det_names
                if det_sums is not None:
                    data["det_scores"] = det_sums
                self.events.publish("chunk_retired", self.tick_no,
                                    run.req.rid, **data)
            run.inflight -= 1
        self._g_inflight.set(len(self._inflight))

    def _fetch(self, inf: _InFlight, want_ecc: bool):
        """One call's (outlier, ecc or None, scores or None) on the
        host.  The ensemble's per-detector (K, T, C) float score
        streams ride the same fetch — per-request sums feed
        RequestStats / chunk_retired telemetry."""
        out = inf.out
        outlier = out["outlier"].cpu().numpy()
        ecc = out["ecc"].cpu().numpy() if want_ecc else None
        scores = (out["scores"].cpu().numpy()
                  if self._ensemble and "scores" in out else None)
        return outlier, ecc, scores

    def _flush(self, events: Optional[dict] = None) -> None:
        """Retire every in-flight call (the consume-side sync)."""
        if not self._inflight:
            return
        if self.tracer.enabled:
            with self.tracer.span("flush", tick=self.tick_no,
                                  calls=len(self._inflight)):
                while self._inflight:
                    self._retire(self._inflight.popleft(), events)
            return
        while self._inflight:
            self._retire(self._inflight.popleft(), events)

    def step(self) -> dict:
        """One scheduler tick; returns {admitted, flagged, completed}.

        In the async loop, `flagged` events surface on the tick whose
        retirement fetched them — one tick after dispatch.
        """
        self._c_ticks.inc()
        events: dict = {"admitted": [], "flagged": [], "completed": []}
        if self._deferred_flagged:
            events["flagged"].extend(self._deferred_flagged)
            self._deferred_flagged.clear()
        # host bookkeeping first: admission + take + vlens assembly all
        # overlap with the previous tick's in-flight device compute
        self._admit(events)
        ready = [r for r in self.runs.values() if r.avail > 0]
        deep = self.pipeline_depth > 1 and not self.measure_latency
        if deep and ready:
            # fence: a slot in a still-in-flight call cannot join a new
            # one (its chunks must be fetched in dispatch order).  When
            # every ready slot is fenced, force-retire oldest calls
            # until one frees up — a tick with work always dispatches.
            def _free():
                fenced = {slot for i in self._inflight
                          for _, slot, _ in i.members}
                return [r for r in ready if r.slot not in fenced]
            free = _free()
            while not free and self._inflight:
                self._retire(self._inflight.popleft(), events)
                free = _free()
            if free:
                self._dispatch(free)
        elif ready:
            self._dispatch(ready)
        if deep:
            # out-of-order retirement: calls whose outputs already
            # landed on host retire now, whatever their dispatch order
            # (fencing makes per-slot order immune to it); then the
            # oldest calls retire until the pipeline fits its depth
            for inf in [i for i in self._inflight if _host_ready(i)]:
                self._inflight.remove(inf)
                self._retire(inf, events)
            while len(self._inflight) > self.pipeline_depth:
                self._retire(self._inflight.popleft(), events)
        else:
            # retire everything dispatched *before* this tick; this
            # tick's call stays in flight across the tick boundary (the
            # double buffer) unless the loop is synchronous
            while self._inflight and (
                    self.measure_latency
                    or self._inflight[0].tick < self.tick_no):
                self._retire(self._inflight.popleft(), events)

        done = [rid for rid, r in self.runs.items()
                if r.req.closed and r.avail == 0]
        if any(self.runs[rid].inflight for rid in done):
            # completion consumes results: sync the tail call now so
            # done_tick/telemetry are final the tick the stream drains
            self._flush(events)
        for rid in done:
            run = self.runs.pop(rid)
            run.phase = DONE
            st = run.stats
            st.done_tick = self.tick_no
            self.pool.release([run.slot])
            self._c_completed.inc()
            ch = self._cls(st.priority)
            ch["running"].dec()
            ch["completed"].inc()
            ch["latency"].observe(st.done_tick - st.submitted_tick)
            events["completed"].append(rid)
            self.events.publish("done", self.tick_no, rid,
                                slot=run.slot, samples=st.samples,
                                flags=st.flags, priority=st.priority)
            self._finished[rid] = run
            while len(self._finished) > self.keep_finished:
                old = next(iter(self._finished))  # oldest completion
                del self._finished[old]
                self.stats_by_rid.pop(old, None)
                self._note_evicted(old)
                self.events.publish("evicted", self.tick_no, old)
        return events

    def _note_evicted(self, rid: str) -> None:
        if len(self._evicted) == self._evicted.maxlen:
            old = self._evicted.popleft()
            n = self._evicted_counts.get(old, 0) - 1
            if n <= 0:
                self._evicted_counts.pop(old, None)
            else:
                self._evicted_counts[old] = n
        self._evicted.append(rid)
        self._evicted_counts[rid] = self._evicted_counts.get(rid, 0) + 1

    def drain(self, max_ticks: int = 100_000) -> int:
        """Tick until every submitted request has completed; returns
        the number of ticks it took.  Raises immediately — naming the
        rids — when progress is impossible because requests are still
        open (no pending samples, not closed): they hold their slots
        waiting for `feed`, and only `close()` lets them finish."""
        start = self.tick_no
        while self.queued_total or self.runs:
            can_admit = bool(self.queued_total) and (
                self.pool.occupancy < self.pool.max_capacity)
            has_work = (self._inflight
                        or any(r.avail > 0 for r in self.runs.values()))
            completing = any(r.req.closed and r.avail == 0
                             for r in self.runs.values())
            if not (can_admit or has_work or completing):
                open_rids = sorted(rid for rid, r in self.runs.items()
                                   if not r.req.closed)
                raise RuntimeError(
                    f"drain stalled: requests {open_rids} are open with "
                    "no pending samples — they wait on feed() forever; "
                    "close() them (or feed more data) before drain()")
            if self.tick_no - start >= max_ticks:
                raise RuntimeError(
                    f"drain exceeded {max_ticks} ticks with "
                    f"{self.queued_total} queued / {len(self.runs)} "
                    "running requests")
            self.step()
        self._flush()
        return self.tick_no - start

    # --------------------------------------------------------- results
    def _missing(self, rid: str) -> KeyError:
        if rid in self._evicted_counts:
            return EvictedRequest(
                f"request {rid!r} completed and was evicted "
                f"(keep_finished={self.keep_finished}); raise the "
                "retention cap to keep results longer")
        return KeyError(f"unknown request {rid!r}")

    def results(self, rid: str) -> dict:
        """Per-sample verdicts of a request, in stream order.  Syncs
        the async loop: any of the request's in-flight samples are
        fetched before returning."""
        run = self.runs.get(rid) or self._finished.get(rid)
        if run is None:
            raise self._missing(rid)
        if not self.collect:
            raise RuntimeError("scheduler built with collect=False")
        if run.inflight:
            self._flush()  # consume-side sync point
        cat = (lambda parts, dt: np.concatenate(parts)
               if parts else np.zeros((0,), dt))
        return {"ecc": cat(run.ecc_parts, np.float32),
                "outlier": cat(run.outlier_parts, bool)}

    def telemetry(self, rid: str) -> RequestStats:
        """The request's `RequestStats` (sample/flag counts final only
        after its in-flight calls retire — synced here)."""
        st = self.stats_by_rid.get(rid)
        if st is None:
            raise self._missing(rid)
        run = self.runs.get(rid)
        if run is not None and run.inflight:
            self._flush()  # consume-side sync point
        return st

    def request_phase(self, rid: str) -> str:
        """Lifecycle phase of a request: queued/prefill/decode/done."""
        run = self.runs.get(rid)
        if run is not None:
            return run.phase
        if rid in self._finished:
            return DONE
        if rid in self.stats_by_rid:
            return QUEUED
        raise self._missing(rid)

    def stats(self) -> dict:
        """Aggregate scheduler telemetry (the serving-bench payload),
        read back from the obs registry in O(instruments) — nothing is
        re-sorted or re-scanned per call.

        `chunk_latency` percentiles come from the running weighted
        wall-time histogram (each fused call weighted by the samples
        it retired, estimated at bucket edges); `classes` carries
        per-priority-class state counts plus queue-wait and
        completion-latency percentiles over *every* request the class
        ever saw (retention eviction no longer shifts them);
        `programs` lists the (capacity, t) program cache — its size
        going flat after warmup is the no-recompile guarantee of the
        adaptive path.
        """
        lat = {}
        if self._h_wall.count:
            lat = {"calls": len(self.call_log),
                   "p50_ms": self._h_wall.quantile(0.5),
                   "p95_ms": self._h_wall.quantile(0.95)}
        classes: Dict[str, dict] = {}
        for cls, ch in self._classes.items():
            c = {"queued": int(ch["queued"].value),
                 "running": int(ch["running"].value),
                 "completed": int(ch["completed"].value)}
            for key, h in (("queue_wait_ticks", ch["wait"]),
                           ("latency_ticks", ch["latency"])):
                if h.count:
                    c[f"{key}_p50"] = h.quantile(0.5)
                    c[f"{key}_p95"] = h.quantile(0.95)
            classes[cls] = c
        out = {"ticks": self.tick_no, "completed": self.completed,
               "running": len(self.runs), "queued": self.queued_total,
               "rejected_submits": self.rejected,
               "inflight_calls": len(self._inflight),
               "pipeline_depth": self.pipeline_depth,
               "short_ticks": self.short_ticks,
               "chunk_latency": lat, "classes": classes,
               "programs": self.pool.programs(),
               "pool": self.pool.stats()}
        if self._ensemble:
            out["detector_flags"] = {
                d: int(c.value) for d, c in self._det_counters.items()}
        return out
