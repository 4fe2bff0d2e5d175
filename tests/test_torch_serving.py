"""The port's serving gateway (`repro_torch.launch.serve`) against the
JAX package's, on the CPU.

The same tenant streams go through both `serve_streams`: on the Q path
("cuda-q" against "pallas-q") every per-request verdict, telemetry row,
flag list and aggregate (ticks, classes, program shapes, pool) is
equal; "cuda" against "pallas" holds rtol 5e-4 / atol 1e-5 with equal
flags; under "ensemble" with per-tenant member subsets the bitmasks,
votes and per-detector flag counts are equal and the per-detector mean
scores within 5e-3 (the reference's tolerance for moment scores).  The
port's async and depth-4 loops equal its sync loop bit for bit.  Also
the CLI, priority classes, duplicate rids and the retention sizing.
"""
import numpy as np
import pytest

from repro.fixedpoint import QFormat as JQ
from repro.launch.serve import _demo_streams as j_demo_streams
from repro.launch.serve import serve_streams as j_serve_streams
from repro_torch.fixedpoint import QFormat as TQ
from repro_torch.launch.serve import _demo_streams, main, serve_streams

SPEC = (32, 20)
RTOL, ATOL = 5e-4, 1e-5
GATE = dict(buckets=(2, 4), chunk_t=8, arrivals_per_tick=2,
            class_weights={"latency": 4.0, "bulk": 1.0}, collect=True)
ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")
# every per-request field but the float score means
FIELDS = ("samples", "flags", "queue_wait_ticks", "prefill_chunks",
          "decode_steps", "slot", "shard", "migrations", "priority",
          "det_flags")
AGGREGATE = ("requests", "samples", "ticks", "rejected_submits",
             "short_ticks", "programs", "classes", "queue_wait_ticks_p50",
             "queue_wait_ticks_p95", "flagged", "pool")


def _streams(n, history, live, seed=0, priority=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = rng.normal(size=(history,)).astype(np.float32)
        lv = rng.normal(size=(live,)).astype(np.float32)
        s = (f"t{i}", h, lv, None)
        if priority is not None:
            s = s + (priority(i),)
        out.append(s)
    return out


def _same_gateway(port, ref, exact=True, score_tol=None):
    for key in AGGREGATE:
        assert port[key] == ref[key], key
    ps, js = port["_scheduler"], ref["_scheduler"]
    for rid, row in port["per_request"].items():
        jrow = ref["per_request"][rid]
        assert {k: row[k] for k in FIELDS} == {k: jrow[k] for k in FIELDS}
        assert sorted(row["det_scores"]) == sorted(jrow["det_scores"])
        for d, s in row["det_scores"].items():
            assert s == pytest.approx(jrow["det_scores"][d], rel=score_tol,
                                      abs=score_tol)
        rp, rj = ps.results(rid), js.results(rid)
        np.testing.assert_array_equal(rp["outlier"], rj["outlier"], rid)
        if exact:
            np.testing.assert_array_equal(rp["ecc"], rj["ecc"], rid)
        else:
            np.testing.assert_allclose(rp["ecc"], rj["ecc"], rtol=RTOL,
                                       atol=ATOL, err_msg=rid)


def test_demo_streams_equal_the_reference():
    streams = _demo_streams(5, 8, 4)
    ref = j_demo_streams(5, 8, 4)
    assert len(streams) == 5
    rid, h, lv, m, cls = streams[0]
    assert h.shape == (8,) and lv.shape == (4,) and cls == "latency"
    assert streams[1][4] == "bulk"
    for s, j in zip(streams, ref):
        assert s[0] == j[0] and s[3:] == j[3:]
        np.testing.assert_array_equal(s[1], j[1])
        np.testing.assert_array_equal(s[2], j[2])


def test_q_gateway_matches_jax_and_its_own_sync_loop():
    """cuda-q == pallas-q through the whole gateway (async loops on both
    sides), and the port's async and depth-4 loops == its sync loop."""
    streams = _demo_streams(8, 24, 6)
    kw = dict(fmt=TQ(*SPEC), device="cpu", **GATE)
    port = serve_streams(streams, backend="cuda-q", measure_latency=False,
                         **kw)
    ref = j_serve_streams(streams, backend="pallas-q", fmt=JQ(*SPEC),
                          measure_latency=False, **GATE)
    _same_gateway(port, ref)
    assert port["pool"]["resizes"] >= 1 and port["flagged"]
    sync = serve_streams(streams, backend="cuda-q", measure_latency=True,
                         **kw)
    deep = serve_streams(streams, backend="cuda-q", measure_latency=False,
                         pipeline_depth=4, **kw)
    for other in (sync, deep):
        assert other["flagged"] == port["flagged"]
        for rid, row in port["per_request"].items():
            assert (row["samples"], row["flags"]) == (
                other["per_request"][rid]["samples"],
                other["per_request"][rid]["flags"])
            a = port["_scheduler"].results(rid)
            b = other["_scheduler"].results(rid)
            np.testing.assert_array_equal(a["ecc"], b["ecc"], rid)
            np.testing.assert_array_equal(a["outlier"], b["outlier"], rid)


def test_float_gateway_matches_jax():
    streams = _demo_streams(6, 20, 6, seed=1)
    port = serve_streams(streams, backend="cuda", device="cpu",
                         measure_latency=False, **GATE)
    ref = j_serve_streams(streams, backend="pallas", measure_latency=False,
                          **GATE)
    _same_gateway(port, ref, exact=False)


def test_ensemble_gateway_matches_jax_per_tenant_members():
    """7-tuple streams select each tenant's members and vote: bitmasks,
    votes and per-detector flag counts equal the reference's, mean
    scores within 5e-3."""
    subsets = [(ALL5, "majority"), (("rde",), "any"),
               (("hst", "teda-q"), "all"), (("zscore", "teda"), 0.5)]
    streams = [s + subsets[i % 4] for i, s in
               enumerate(_demo_streams(6, 20, 6, seed=2))]
    kw = dict(detectors=ALL5, window=4, measure_latency=False, **GATE)
    port = serve_streams(streams, backend="ensemble", device="cpu",
                         fmt=TQ(*SPEC), **kw)
    ref = j_serve_streams(streams, backend="ensemble", fmt=JQ(*SPEC), **kw)
    _same_gateway(port, ref, score_tol=5e-3)
    det = port["_scheduler"].stats()["detector_flags"]
    assert det == ref["_scheduler"].stats()["detector_flags"]
    assert sum(det.values()) > 0
    assert set(port["per_request"]["tenant-1"]["det_flags"]) <= {"rde"}
    assert set(port["per_request"]["tenant-1"]["det_scores"]) == set(ALL5)


def test_serve_streams_priority_classes_and_telemetry():
    res = serve_streams(
        _streams(6, 12, 4, priority=lambda i: "latency" if i % 2
                 else "bulk"),
        backend="scan", device="cpu", buckets=(2, 4), chunk_t=8,
        class_weights={"latency": 4.0, "bulk": 1.0}, arrivals_per_tick=3)
    assert res["requests"] == 6 and res["samples"] == 6 * 16
    assert set(res["classes"]) == {"latency", "bulk"}
    for cls in ("latency", "bulk"):
        assert res["classes"][cls]["completed"] == 3
        assert "queue_wait_ticks_p95" in res["classes"][cls]
    prios = {rid: pr["priority"] for rid, pr in res["per_request"].items()}
    assert prios["t1"] == "latency" and prios["t0"] == "bulk"
    assert res["short_ticks"] > 0
    assert all(len(key) == 2 for key in res["programs"])


def test_serve_streams_async_matches_sync_flags():
    streams = _streams(4, 10, 6, seed=3)
    streams = [(rid, h, lv * 4.0, 2.0) for rid, h, lv, _ in streams]
    kw = dict(backend="scan", device="cpu", buckets=(2, 4), chunk_t=8,
              collect=False)
    sync = serve_streams(streams, measure_latency=True, **kw)
    asyn = serve_streams(streams, measure_latency=False, **kw)
    assert sync["flagged"] == asyn["flagged"]
    for rid in sync["per_request"]:
        ps, pa = sync["per_request"][rid], asyn["per_request"][rid]
        assert (ps["samples"], ps["flags"]) == (pa["samples"], pa["flags"])


def test_serve_streams_rejects_duplicate_rids():
    s = _streams(1, 4, 0)
    with pytest.raises(ValueError, match="duplicate"):
        serve_streams(s + s, backend="scan", device="cpu", buckets=(2,))


def test_serve_streams_outlives_retention_cap():
    """The gateway sizes keep_finished to the run, so every request's
    telemetry is read back after the drain."""
    streams = [(f"s{i}", np.zeros((3,), np.float32),
                np.zeros((0,), np.float32), None) for i in range(12)]
    res = serve_streams(streams, backend="scan", device="cpu",
                        buckets=(2, 4), chunk_t=2, keep_finished=4)
    assert res["requests"] == 12 and res["samples"] == 36
    assert len(res["per_request"]) == 12


def test_cli_streams_mode_and_lm_mode(capsys):
    main(["--mode", "streams", "--requests", "4", "--history", "16",
          "--live", "4", "--backend", "cuda-q", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve]" in out and "decode-short ticks" in out
    assert "class latency" in out and "class bulk" in out
    assert "on cpu" in out
    main(["--mode", "lm", "--device", "cpu", "--scale", "tiny",
          "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) == 4 and "decode" in lines[0] and "on cpu" in lines[0]
    assert lines[3].startswith("[serve] sample continuation (req 0):")
