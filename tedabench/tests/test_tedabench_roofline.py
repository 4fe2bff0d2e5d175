"""The roofline counts from shapes, and a share from a traced window."""
import pytest

from tedabench.harness import load_json, load_module
from tedabench.rooflines import least_s, share
from tedabench.trace import Trace

PEAKS = {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


@pytest.mark.parametrize("kernel", ["teda_scan", "teda_q_scan"])
def test_counts_from_shapes(kernel):
    count = load_module("roofline", kernel)
    t, c = 4096, 65536
    nbytes, ops = count.work(t, c)
    assert nbytes == t * c * 9 + c * 32
    assert ops == t * c * 19
    # bytes bound this contract: 2.416 GB at 3.35 TB/s
    assert least_s(nbytes, ops, PEAKS) == pytest.approx(nbytes / 3.35e12)
    assert least_s(nbytes, ops, PEAKS) * 1e3 == pytest.approx(0.7213,
                                                              rel=1e-3)


def test_share_from_trace():
    ms = 1_000_000
    ops = [("void (anonymous namespace)::teda_scan_kernel<false>(...)",
            0, 2 * ms, 7),
           ("void (anonymous namespace)::teda_scan_kernel<false>(...)",
            3 * ms, 5 * ms, 7),
           ("elementwise", 5 * ms, 6 * ms, 7)]
    tr = Trace(ops, [("process", 0, ms)], (0, 10 * ms))
    ctx = {"trace": tr, "peaks": PEAKS, "load": load_module,
           "traffic": {"t": 4096},
           "config": load_json("configs", "damadics-fleet-f32")}
    nbytes, _ = load_module("roofline", "teda_scan").work(4096, 65536)
    assert share(ctx, "teda_scan") == pytest.approx(
        100 * nbytes / 3.35e12 / 2e-3)
    assert share(ctx, "teda_q_scan") is None  # no launch, no number
    ctx["trace"] = None
    assert share(ctx, "teda_scan") is None
