"""Reading a profiler window: device operations, busy time, idle gaps.

The events come from the profiler's raw list
(`prof.profiler.kineto_results.events()`), as `chip_smoke.py::_device_rows`
reads them: the host-side event tree that `key_averages()` builds costs
seconds per window and is not needed.  Device events and the harness's
host spans (`torch.profiler.record_function`) share one clock.
"""
from __future__ import annotations

__all__ = ["Trace", "read_profile", "union", "SPANS"]

# the harness's host spans around its calls into the program
SPANS = ("make", "process", "summary", "wait")
WINDOW = "window"


class Trace:
    """One traced window.

    ops    [(name, start_ns, end_ns, stream)] device operations
           (kernels, copies, fills), clipped to the window
    spans  [(name, start_ns, end_ns)] the harness's host spans
    window (start_ns, end_ns)
    """

    def __init__(self, ops, spans, window):
        self.ops, self.spans, self.window = ops, spans, window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def calls(self) -> int:
        """Calls into the engine that the window holds."""
        return sum(1 for n, *_ in self.spans if n == "process")

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.ops)) / 1e9

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most
        time, summed by name."""
        acc = {}
        for name, a, b, _ in self.ops:
            acc[name] = acc.get(name, 0) + (b - a)
        rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:200], ns / 1e9] for name, ns in rows]

    def idle_gaps(self, top: int = 10):
        """[[host span, seconds]] of the longest gaps with no device
        operation, each named by the span the host spent most of it in
        ("harness" where it was in none)."""
        w0, w1 = self.window
        gaps, at = [], w0
        for a, b in union(self.ops):
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if w1 > at:
            gaps.append((at, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            best, name = 0, "harness"
            for n, s0, s1 in self.spans:
                ov = min(b, s1) - max(a, s0)
                if ov > best:
                    best, name = ov, n
            out.append([name, (b - a) / 1e9])
        return out


def union(ops):
    """The merged [start, end) intervals that device operations cover."""
    merged = []
    for a, b in sorted((o[1], o[2]) for o in ops):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_profile(prof) -> Trace:
    """The Trace of a profiler run whose traced part the harness wrapped
    in a `window` span."""
    ops, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        dev = str(ev.device_type())
        if dev.endswith("CUDA"):
            if ev.is_user_annotation() or name.startswith("ProfilerStep"):
                continue
            ops.append((name, ev.start_ns(), ev.end_ns(),
                        ev.device_resource_id()))
        elif name == WINDOW:
            window = (ev.start_ns(), ev.end_ns())
        elif name in SPANS:
            spans.append((name, ev.start_ns(), ev.end_ns()))
    if window is None:
        raise RuntimeError("the profile holds no window span")
    w0, w1 = window
    ops = [(n, max(a, w0), min(b, w1), s) for n, a, b, s in ops
           if b > w0 and a < w1]
    spans = [(n, a, b) for n, a, b in spans if w0 <= a < w1]
    return Trace(ops, spans, window)
