"""The benchmark's window over `repro_torch.engine.StreamEngine`.

A cell names a configuration (`configs/<name>.json`: the deployment,
the engine's arguments, the data's signals and faults, the reference
and its limits) and a traffic mix (`traffic/<name>.json`: chunk
length, calls in flight, ring of distinct chunks, stream length,
valid lengths).  Metrics are files too: `metrics/<name>.py` reads one
per-layer metric from what the window recorded, `roofline/<kernel>.py`
counts a kernel's bytes and operations from shapes.  The harness finds
each by its name and needs no edit for a new one.

The window is a closed loop.  The caller hands the next (T, C) chunk of
the ring to `process` as soon as fewer than `depth` calls are in
flight; a call is done when its verdict summary, each channel's count
of flagged samples, is in pinned host memory (reduced and copied on a
stream of the harness's own, read one call later).  The engine is
reset before the first call of every stream (`stream_len` samples).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from tedabench import data
from tedabench.check import Capture, decide
from tedabench.trace import WINDOW, read_profile

__all__ = ["ROOT", "BENCH", "load_json", "load_module", "cell_spec",
           "Cell", "run_cell", "make_engine"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_SECONDS = 1.0   # the traced window, after the timed one
TRACE_WARM_S = 0.25   # profiled but not read: the profiler settles


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """tedabench/<kind>/<name>.py, loaded by its path (names may hold
    dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"tedabench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics, cell: str):
    return [m for m in metrics if cell in m.get("workloads", [cell])]


class Cell:
    """One workload of BENCHMARK.json with its files read."""

    def __init__(self, name, config, traffic, end_to_end, per_layer,
                 chips=1):
        self.name, self.config, self.traffic = name, config, traffic
        self.end_to_end, self.per_layer = end_to_end, per_layer
        self.chips = int(chips)


def cell_spec(bench: dict, name: str) -> Cell:
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name, load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]),
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name), w.get("chips", 1))


def make_engine(config: dict, device):
    """The system under test, as the configuration states it."""
    from repro_torch.engine import StreamEngine
    opts = dict(config["engine"])
    backend = opts.pop("backend")
    fmt = opts.pop("fmt", None)
    if fmt is not None:
        from repro_torch.fixedpoint import QFormat
        opts["fmt"] = QFormat(*fmt)
    return StreamEngine(config["channels"], backend, device=device, **opts)


def flag_counts(outlier: torch.Tensor) -> torch.Tensor:
    """Each channel's count of flagged samples, (C,) int32, reading the
    (T, C) flags once.  A plain `sum(0, dtype=int32)` first casts the
    whole (T, C) block to int32 (four more bytes a sample written and
    read); here the flags are summed as int64 words of 8 channels over
    blocks of at most 64 rows, where no byte lane can carry into the
    next, and the (T / 64, C) block counts are summed after."""
    t_len, c = outlier.shape
    rows = 64
    while rows > 1 and t_len % rows:
        rows //= 2
    if rows < 2 or c % 8 or not outlier.is_contiguous():
        return outlier.sum(0, dtype=torch.int32)
    words = outlier.view(torch.uint8).view(torch.int64)
    lanes = words.view(t_len // rows, rows, c // 8).sum(1)
    return lanes.view(torch.uint8).view(t_len // rows, c).sum(
        0, dtype=torch.int32)


class _Summaries:
    """Each call's (C,) flag counts, reduced and copied to pinned host
    memory on a stream of their own, in `n` slots."""

    def __init__(self, device, c: int, n: int):
        self.cuda = device.type == "cuda"
        self.buf = [torch.zeros(c, dtype=torch.int32, pin_memory=self.cuda)
                    for _ in range(n)]
        self.np = [b.numpy() for b in self.buf]
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event() for _ in range(n)]
            self.done = [torch.cuda.Event() for _ in range(n)]

    def start(self, slot: int, outlier: torch.Tensor) -> None:
        if not self.cuda:
            self.buf[slot].copy_(flag_counts(outlier))
            return
        self.ready[slot].record()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.ready[slot])
            self.buf[slot].copy_(flag_counts(outlier), non_blocking=True)
            self.done[slot].record(self.stream)

    def wait(self, slot: int) -> None:
        if self.cuda:
            self.done[slot].synchronize()


class _Loop:
    """The closed loop over one engine and one ring of chunks."""

    def __init__(self, eng, ring, vlens, depth, cps, sampled, per_call):
        self.eng, self.ring, self.vlens = eng, ring, vlens
        self.depth, self.cps = int(depth), int(cps)
        self.sampled = np.asarray(sampled)
        self.per_call = per_call  # samples retired by each ring slot
        self.summ = _Summaries(ring.device, ring.shape[2], self.depth + 1)
        self.span = _no_span
        self.inflight = collections.deque()
        self.clear()

    def clear(self):
        self.n = 0           # calls issued
        self.done = 0        # calls whose summary reached the host
        self.samples = 0
        self.host_s = []     # host seconds of each call into the engine
        self.lat_s = []      # hand-over to summary on the host
        self.rows = []       # sampled summaries of every call
        self.last = None

    def issue(self):
        i = self.n
        t_hand = time.perf_counter()
        with self.span("make"):
            slot = i % len(self.ring)
            x = self.ring[slot]
            vl = None if self.vlens is None else self.vlens[slot]
        with self.span("process"):
            t0 = time.perf_counter()
            if i % self.cps == 0:
                self.eng.reset()
            pre = self.eng.state
            out = self.eng.process(x, valid_lens=vl)
            self.host_s.append(time.perf_counter() - t0)
        buf = i % (self.depth + 1)
        with self.span("summary"):
            self.summ.start(buf, out["outlier"])
        self.inflight.append((t_hand, i, buf, pre, out))
        self.n += 1

    def complete(self):
        with self.span("wait"):
            t_hand, i, buf, pre, out = self.inflight.popleft()
            self.summ.wait(buf)
        self.lat_s.append(time.perf_counter() - t_hand)
        self.rows.append(self.summ.np[buf][self.sampled])
        self.samples += self.per_call[i % len(self.ring)]
        self.done += 1
        self.last = (i, buf, pre, out)

    def run_until(self, deadline: float):
        while time.perf_counter() < deadline:
            if len(self.inflight) >= self.depth:
                self.complete()
            self.issue()

    def calls(self, n: int):
        for _ in range(n):
            if len(self.inflight) >= self.depth:
                self.complete()
            self.issue()

    def drain(self):
        while self.inflight:
            self.complete()

    def capture(self) -> Capture:
        i, buf, pre, out = self.last
        st = self.eng.state
        last = {"index": i, "pre": (pre.k, pre.mean, pre.var),
                "ecc": out["ecc"], "outlier": out["outlier"],
                "post": (st.k, st.mean, st.var),
                "summary": self.summ.np[buf].copy()}
        return Capture(self.ring, self.vlens, self.cps, self.sampled,
                       np.stack(self.rows) if self.rows else
                       np.zeros((0, len(self.sampled)), np.int32), last)


@contextlib.contextmanager
def _no_span(name):
    yield


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _inputs(cell: Cell, seed: int, device):
    cfg, tr = cell.config, cell.traffic
    c, t_len, n_ring = cfg["channels"], tr["t"], tr["ring"]
    if tr["stream_len"] % (n_ring * t_len):
        raise ValueError("stream_len must be a whole number of ring "
                         "periods (ring x t)")
    if cfg["input"] == "qwords":
        words = tuple(cfg["engine"]["fmt"][:2])
    elif cfg["input"] == "float32":
        words = None
    else:
        raise ValueError(f"unknown input {cfg['input']!r}")
    ring = data.make_ring(cfg["signals"], cfg["faults"], c, t_len, n_ring,
                          seed, device, words=words)
    vlens = data.ring_vlens(tr.get("valid_lens"), c, t_len, n_ring, seed,
                            device)
    per_call = ([t_len * c] * n_ring if vlens is None
                else [int(v) for v in vlens.sum(1).tolist()])
    sampled = data.sample_channels(seed, c, tr["sample_channels"])
    return ring, vlens, per_call, sampled


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process=None, engine_factory=make_engine, log=print,
             calls=None, warm=True):
    """Set up, warm up, run the window (and with `trace` a traced
    window after it), check the outputs.  Returns the result dict of
    the last line; `t_process` is the time the process started (set-up
    counts from it).  `calls` runs that many calls in place of
    `seconds`; `warm=False` skips the warm-up (the control's readings,
    which time nothing)."""
    t_setup0 = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    marks = [("start", time.perf_counter())]
    ring, vlens, per_call, sampled = _inputs(cell, seed, device)
    _sync(device)
    marks.append(("ring", time.perf_counter()))
    eng = engine_factory(cfg, device)
    marks.append(("engine", time.perf_counter()))
    cps = tr["stream_len"] // tr["t"]
    loop = _Loop(eng, ring, vlens, tr["depth"], cps, sampled, per_call)
    if warm:  # every ring slot, a stream's reset, the summary path
        loop.calls(cps + len(ring) + tr["depth"])
        loop.drain()
    _sync(device)
    loop.clear()
    # what set-up made stays: later collections need not walk it
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_setup0
    marks.append(("warm-up", t0))
    log("[setup] " + "; ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
        + f"; before run_cell {marks[0][1] - t_setup0:.3f} s")
    if calls is None:
        loop.run_until(t0 + seconds)
    else:
        loop.calls(calls)
    loop.drain()
    window_s = time.perf_counter() - t0
    host_ms, lat_ms = (np.percentile(np.asarray(v) * 1e3, (50, 95))
                       if v else (np.nan, np.nan)
                       for v in (loop.host_s, loop.lat_s))
    log(f"[window] {loop.done} calls in {window_s:.3f} s; host ms per "
        f"call p50 {host_ms[0]:.4f} p95 {host_ms[1]:.4f}; hand-over to "
        f"summary ms p50 {lat_ms[0]:.4f} p95 {lat_ms[1]:.4f}; set-up "
        f"{setup_s:.3f} s")
    timed = {"samples": loop.samples, "window_s": window_s,
             "host_s": list(loop.host_s), "lat_s": list(loop.lat_s)}
    prof = None
    if trace:
        prof = _traced(loop, device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    attempted = loop.n
    cap = loop.capture()
    ref = load_module("reference", cfg["reference"])
    del eng, loop
    t_check = time.perf_counter()
    ok, readings = decide(ref, cap, cfg["engine"].get("m", 3.0),
                          cfg["limits"], fmt=cfg["engine"].get("fmt"))
    log(f"[check] {time.perf_counter() - t_check:.3f} s")
    ctx = {"timed": timed, "trace": prof,
           "setup_s": setup_s, "config": cfg, "traffic": tr,
           "peaks": _peaks(device), "load": load_module}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = _device(device, memory_peak)
    if prof is not None:
        dev["busy_s"] = prof.busy_s()
        dev["window_s"] = prof.window_s
    result = {"correct": bool(ok), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof.device_ops(),
                               "idle_gaps": prof.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in readings}
    return result


def _traced(loop: _Loop, device):
    """A short profiled window after the timed one, the loop carried on
    as it stands."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    loop.span = torch.profiler.record_function
    with torch.profiler.profile(activities=acts) as prof:
        loop.run_until(time.perf_counter() + TRACE_WARM_S)
        loop.drain()
        with torch.profiler.record_function(WINDOW):
            loop.run_until(time.perf_counter() + TRACE_SECONDS)
            loop.drain()
        _sync(device)
    loop.span = _no_span
    return read_profile(prof)


def _read_metric(name: str, ctx):
    return load_module("metrics", name).read(ctx)


def _peaks(device) -> dict:
    table = json.loads((BENCH / "peaks.json").read_text())
    if device.type != "cuda":
        return {}
    kind = torch.cuda.get_device_name(device)
    for key, row in table.items():
        if key in kind:
            return row
    return {}


def _device(device, memory_peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory_peak)}
