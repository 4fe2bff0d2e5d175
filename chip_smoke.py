#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the TEDA engine on one GPU and check it.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ensemble-times [--src DIR]
    python3 chip_smoke.py --teda-times [--src DIR]

Run from the repository root on a machine with a CUDA device and the
CUDA toolkit.  The phases, each of which raises on failure:

  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — the CUDA kernels compiled from `src/repro_torch/csrc/`
               with nvcc for sm_90a (`-Xptxas -v` output printed, and
               each kernel's static SASS instruction count and loop
               bodies from cuobjdump where the toolkit has it);
     divider — the Q divider every Q kernel inlines (`q_fast_div_mag`,
               launched alone through `csrc/qdiv_probe.cu`) against the
               plain `fast_div_mag` on the card, bit-exact, over edge
               sets, remainders at 0, 1, d - 1 and half-way, and 10^7
               random pairs per format and shift;
  3. kernels — each kernel against its plain PyTorch version on the card
               at C = 65,536 channels x T = 512 rows, from a carried
               state (k0 up to ~10^4) with a ragged vlen and a mixed
               per-channel m, for both output contracts, bit-exact (the
               float kernel's outputs as int32 words, finals included).
               The float kernel also at the edges of its staged tiles:
               T in {0, 1, S - 1, S, S + 1, 2S + 1, 37} (S = STAGE_ROWS)
               x C in {1, 127, 129, 1000} and C = 1000 with x's base off
               16-byte alignment, vlen 0, T and ragged, NaN and +-inf
               samples, from a warm carried state.  The ensemble
               kernel (K = 5 members, W = 8, QFormat(32, 20)) from a
               warm carried state with ragged vlen, mixed m,
               per-channel member selections and vote thresholds and
               NaN samples: bits, vote, k, all five
               score streams and the aux block as int32 words
               bit-exact, the scores' largest difference printed; the
               same at C = 1,000 (not a multiple of the block) x T = 37
               (a partial tile) and at W = 300 (the block halved), with
               and without teda-q (the block with and without its Q
               warps).  Kernel and plain times from CUDA events (the
               float kernel's and the ensemble's with ragged and with
               uniform vlen), device time from the profiler beside them;
  4. engine  — StreamEngine(4096, "cuda"), (4096, "cuda-q") and
               (4096, "ensemble") on the card against the same engines
               on the CPU through uneven chunks, ragged calls, per-slot
               m, member selection and slot churn; the ensemble's TEDA
               lane against the "cuda" engine on the same stream;
  5. stream  — the main path: StreamEngine(65536, backend) for "cuda",
               "cuda-q" and "ensemble" over 8 device-resident chunks of
               T = 512, samples/s, and each kernel's launch count (one
               per process call), read right after its own path;
  6. serve   — the gateway: `serve_streams` on the card for "cuda-q"
               (16,384 tenants, buckets 1024/4096/16384, 2,048 arrivals
               per tick, at depth 1 and at `pipeline_depth=4`), "cuda"
               and "ensemble" (4,096 tenants each), 480 history + 32
               live samples per tenant, chunk_t 32, against the port's
               CPU gateway on the same streams ("cuda-q" and "ensemble"
               bit for bit, "cuda" flags outside the 1e-4 band); ticks,
               resizes, (capacity, T) shapes, samples/s, per-call wall
               p50/p99 from a synchronous run and kernel launches per
               tick (counted over the depth-1 run, one per fused call);
               then where the time goes: one more depth-1 run under
               torch.profiler (device busy share) and a TickTracer
               (host time in the dispatch and retire spans), and a probe
               timing `SlotPool.acquire` / `release` alone.

The last three lines are the kernels' JSON record (`launches` from
phase 5, `launches_serve` from phase 6), the card's name and
power limit as nvidia-smi prints them, and {"ok": true, "device": ...}.
It exits non-zero without a result when CUDA is unavailable or the
package is not beside it.

`--ensemble-times` runs only phases 1 and 2 and then times the
ensemble kernel alone on the main path's inputs for several member
sets (`ensemble_times`), for the package of the tree at DIR (default:
this one): run it on a `git archive` of another commit to compare
kernels in one call.  `--teda-times` does the same for the float
kernel (`teda_times`): profiled device time per launch with uniform,
ragged and zero vlen, in both contracts.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
C_WIDE, T_CHUNK, N_CHUNKS = 65_536, 512, 8
C_ENGINE = 4096
T_WARM = 10_240
RTOL, ATOL, BAND = 5e-4, 1e-5, 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# the f32 rate outside the tensor cores; the published table has no
# int32 rate, so the Q kernel's integer operations are counted against
# it too (an optimistic, hence lower, bound: an SM has 64 INT32 lanes
# against 128 FP32 lanes, about 16.7e12 int32 operations/s)
ALU_OPS_PER_S = 67e12
# an SM issues one warp instruction per clock in each of its four
# sub-partitions and has 64 INT32 lanes: 132 SMs at the 1.98 GHz boost
# clock
INSTR_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- timing
def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of `fn()` over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ bounds
def float_ops_per_sample():
    # k: 2 adds; sum add; mean div; diff; square; a: sub + div; var:
    # mul + add; d2/k div; 1/k div; k*var mul; d2/(k var) div; ecc add;
    # zeta mul; 2k mul; threshold div; two compares
    return 19


def q_recip_ops_per_sample():
    # the Q row as `q_teda_tile` runs it since the reciprocal divider,
    # counted by hand from csrc/qformat.cuh (about +-20%): two
    # reciprocals (I2F.F64, DRCP's ~8-instruction sequence, DMUL: ~11
    # each) and the halved one for 2k (~5); six dividers (~20 each: the
    # 64-bit shift, U64->F64, DMUL, the saturation compare, F2I, the
    # remainder multiply-subtract, one correction step, the rounding and
    # the qmax select) with their sign and magnitude handling (~6 each);
    # three saturating multiplies (~22 each); three saturating adds and
    # one subtract (~7 each); counter, guards, flag, load and stores
    # (~15)
    return 2 * 11 + 5 + 6 * (20 + 6) + 3 * 22 + 4 * 7 + 15


def ensemble_ops_per_sample():
    # the teda-q lane (above, plus ~8 for the quantizer and the score),
    # the moment fabric (sums, mean, deviation: ~6), teda (the float
    # scan's 19), rde (~9), zscore (~12), hst (8 leaves x 3 + ~8) and
    # the vote over 5 members (~20)
    return q_recip_ops_per_sample() + 8 + 6 + 19 + 9 + 12 + 32 + 20


def bound_ms(t_len, c, in_row_bytes, out_row_bytes, n_carry_rows,
             ops_per_sample):
    """The least time for one call: bytes (each input read once, each
    output written once) over HBM rate vs operations over the ALU rate.
    Returns (ms, "bytes" | "operations")."""
    nbytes = t_len * c * (in_row_bytes + out_row_bytes) + n_carry_rows * 4 * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = t_len * c * ops_per_sample / ALU_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# ------------------------------------------------------------ phases
def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"python {sys.version.split()[0]}")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    info = _build.build(force=True)
    _build.library()
    ptxas = [ln for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log(f"[build] nvcc sm_90a -> {info['path']} in {info['seconds']:.2f} s")
    for ln in ptxas:
        log(f"[build]   {ln.strip()}")
    log_sass("build", _build.LIB_PATH)
    return info["seconds"]


def log_sass(tag, path):
    """Each kernel's static SASS instruction count and loop bodies."""
    from repro_torch.kernels import _build
    if not hasattr(_build, "sass_stats"):  # an older tree's build module
        log(f"[{tag}] sass: the package has no sass_stats (not measured)")
        return
    stats = _build.sass_stats(path)
    if not stats:
        log(f"[{tag}] sass: cuobjdump not found (not measured)")
    for name, st in stats.items():
        log(f"[{tag}] sass {name}: {st['instructions']} instructions, "
            f"loop bodies {st['loops']}")


def phase_divider(seed):
    """The kernels' divider alone against fast_div_mag, bit-exact."""
    from repro_torch.kernels import qdiv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    rng = np.random.default_rng(seed + 5)
    n_rand, total = 10_000_000, 0
    t0 = time.perf_counter()
    for wl, fl in ((32, 16), (32, 20), (32, 30), (16, 8)):
        qmax = (1 << (wl - 1)) - 1
        edges = torch.tensor([0, 1, 2, qmax, qmax + 1, 2**31 - 1, 2**31],
                             device=dev)
        en, ed = (a.reshape(-1) for a in torch.meshgrid(edges, edges,
                                                          indexing="ij"))
        for shift in sorted({0, fl}):
            def mags():  # log-uniform magnitudes in [0, 2^31]
                v = torch.randint(0, 2**31 + 1, (n_rand,), generator=gen,
                                  device=dev)
                return v >> torch.randint(0, 32, (n_rand,), generator=gen,
                                          device=dev)
            hn, hd = qdiv.half_way_pairs(rng, shift, 1000)
            rn, rd = qdiv.remainder_edge_pairs(rng, shift, 1000)
            n = torch.cat([en, torch.from_numpy(np.concatenate([hn, rn]))
                           .to(dev), mags()])
            d = torch.cat([ed, torch.from_numpy(np.concatenate([hd, rd]))
                           .to(dev), mags()])
            for rounding in ("round", "trunc"):
                got = qdiv.div_mag_call(n, d, shift, rounding, qmax)
                want = qdiv.fast_div_mag(n, d, shift, rounding, qmax)
                bad = int((got != want).sum())
                check(bad == 0, f"divider Q{wl}.{fl} shift {shift} "
                      f"{rounding}: {bad} quotients differ from "
                      "fast_div_mag")
                total += n.numel()
    torch.cuda.synchronize()
    log(f"[divider] q_fast_div_mag on the card equals fast_div_mag in "
        f"{total} quotients (Q32.16, Q32.20, Q32.30, Q16.8; shift 0 and "
        f"FL; both roundings; edges, remainder edges, random) in "
        f"{time.perf_counter() - t0:.1f} s")


def _stream_inputs(rng, c, t_len):
    """Per-channel level and scale, and a (T, C) stream with spikes."""
    mu = rng.normal(0.0, 2.0, size=c).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    x = mu + sigma * rng.standard_normal((t_len, c), dtype=np.float32)
    spikes = rng.random((t_len, c)) < 0.002
    x[spikes] += 12.0 * np.broadcast_to(sigma, x.shape)[spikes]
    return mu, sigma, x


def _ragged_vlen(rng, c, t_len):
    vl = rng.integers(0, t_len + 1, size=c)
    vl[rng.random(c) < 0.125] = 0
    vl[rng.random(c) < 0.125] = t_len
    return vl.astype(np.int32)


def _band_mismatch(ecc, m_row, k_rows, flag_a, flag_b):
    """(mismatches inside the threshold band, mismatches outside)."""
    thr = (m_row * m_row + 1.0) / (2.0 * k_rows)
    band = (ecc * 0.5 - thr).abs() <= BAND * thr
    diff = flag_a != flag_b
    return int((diff & band).sum()), int((diff & ~band).sum())


def _close(name, a, b, where=None):
    """Max |a - b| after checking allclose(rtol, atol)."""
    a, b = a.double(), b.double()
    err = (a - b).abs()
    ok = err <= ATOL + RTOL * b.abs()
    if where is not None:
        ok, err = ok | ~where, torch.where(where, err, 0.0)
    check(bool(ok.all()), f"{name}: kernel and plain differ beyond "
          f"rtol {RTOL} / atol {ATOL} (max abs err {float(err.max())})")
    return float(err.max())


FLOAT_OUTS = ("mean", "var", "ecc", "outlier", "fk", "fsum", "fvar")


def _float_equal(tag, kern, plain):
    """Every output of the float kernel equals the plain version's bit
    for bit: floats as int32 words (NaN payloads included), flags by
    value, None (the verdict contract's mean and var) on both sides.
    Returns the float outputs' largest difference (0.0 when equal)."""
    err = 0.0
    for name, a, b in zip(FLOAT_OUTS, kern, plain):
        if a is None or b is None:
            check(a is None and b is None, f"float {tag} {name}: None on "
                  "one side only")
            continue
        same = a.shape == b.shape and (
            torch.equal(_words(a), _words(b)) if a.dtype == torch.float32
            else torch.equal(a, b))
        check(same, f"float {tag} {name}: kernel and plain differ")
        if a.dtype == torch.float32:
            err = max(err, _score_diff(a, b))
    return err


def _float_edges(rng, dev):
    """The float kernel against its plain version, bit for bit, at the
    edges of its staged tiles: T around STAGE_ROWS, C off the block
    width and off 16-byte pieces, x's base off 16-byte alignment, vlen 0,
    T and ragged, NaN and +-inf samples, from a warm carried state."""
    from repro_torch.kernels import teda_scan as fk

    S = fk.STAGE_ROWS
    t_lens = (0, 1, S - 1, S, S + 1, 2 * S + 1, 37)
    widths = ((1, False), (127, False), (129, False), (1000, False),
              (1000, True))
    n_calls = 0
    for c, offset in widths:
        # warm carry: the plain version over 48 rows with ragged vlen,
        # some channels left fresh (vlen 0)
        _, _, warm = _stream_inputs(rng, c, 48)
        m = torch.from_numpy(rng.choice(np.array([2.0, 3.0, 4.5],
                                                 np.float32), size=c)).to(dev)
        zeros = torch.zeros(c, device=dev)
        *_, k0, sum0, var0 = fk.teda_scan_plain(
            torch.from_numpy(warm).to(dev), m,
            torch.from_numpy(_ragged_vlen(rng, c, 48)).to(dev), zeros,
            zeros, zeros)
        for t_len in t_lens:
            _, _, x_np = _stream_inputs(rng, c, t_len)
            u = rng.random(x_np.shape)
            x_np[u < 0.003] = np.nan
            x_np[(u >= 0.003) & (u < 0.005)] = np.inf
            x_np[(u >= 0.005) & (u < 0.007)] = -np.inf
            x = torch.from_numpy(x_np).to(dev)
            if offset:  # contiguous, 4 bytes past 16-byte alignment
                x = torch.empty(t_len * c + 1, device=dev)[1:].view(
                    t_len, c).copy_(x)
            for mode in ("0", "T", "ragged"):
                vl = (_ragged_vlen(rng, c, t_len) if mode == "ragged" else
                      np.full(c, 0 if mode == "0" else t_len, np.int32))
                args = (x, m, torch.from_numpy(vl).to(dev), k0, sum0, var0)
                for full in (False, True):
                    _float_equal(
                        f"T={t_len} C={c}{' offset' if offset else ''} "
                        f"vlen {mode} {'full' if full else 'verdict'}",
                        fk.teda_scan_call(*args, full=full),
                        fk.teda_scan_plain(*args, full=full))
                    n_calls += 1
    log(f"[kernels] teda_scan bit-exact with the plain version in "
        f"{n_calls} edge calls: T in {t_lens} x C in "
        f"{[c for c, _ in widths]} (the second 1000 off 16-byte "
        "alignment) x vlen 0, T, ragged x both contracts, NaN and +-inf "
        "samples, warm carries")


def phase_kernels(seed):
    from repro_torch.fixedpoint import QFormat, msq1_const
    from repro_torch.kernels import teda_q_scan as qk
    from repro_torch.kernels import teda_scan as fk

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    rng = np.random.default_rng(seed)
    mu, sigma, x_np = _stream_inputs(rng, c, t_len)
    m_np = rng.choice(np.array([2.0, 3.0, 4.5], np.float32), size=c)
    vl_np = _ragged_vlen(rng, c, t_len)
    fmt = QFormat(32, 20)  # the repo's bench format

    # carried state: a warm-up stream of up to T_WARM rows per channel
    gen = torch.Generator(device=dev).manual_seed(seed)
    mu_d = torch.from_numpy(mu).to(dev)
    sig_d = torch.from_numpy(sigma).to(dev)
    warm = mu_d + sig_d * torch.randn((T_WARM, c), generator=gen,
                                      device=dev)
    vl_warm = torch.randint(0, T_WARM + 1, (c,), generator=gen, device=dev,
                            dtype=torch.int32)
    zeros = torch.zeros(c, device=dev)
    m3 = torch.full((c,), 3.0, device=dev)
    *_, k0, sum0, var0 = fk.teda_scan_call(warm, m3, vl_warm, zeros, zeros,
                                           zeros)
    zq = torch.zeros(c, dtype=torch.int32, device=dev)
    *_, qk0, qmean0, qvar0 = qk.teda_q_scan_call(
        fmt.quantize(warm), torch.full((c,), 10 << 20, dtype=torch.int32,
                                       device=dev),
        vl_warm, zq, zq, zq, fmt=fmt)
    del warm
    log(f"[kernels] carried state: k0 in [{int(k0.min())}, "
        f"{int(k0.max())}], {int((k0 == 0).sum())} fresh channels")

    x = torch.from_numpy(x_np).to(dev)
    xq = fmt.quantize(x)
    m = torch.from_numpy(m_np).to(dev)
    msq1 = msq1_const(fmt, m_np).to(dev)  # exact float64 quantization
    vl = torch.from_numpy(vl_np).to(dev)
    valid = (torch.arange(t_len, device=dev)[:, None] < vl[None, :])
    log(f"[kernels] C={c} T={t_len}: vlen 0 on {int((vl == 0).sum())}, "
        f"T on {int((vl == t_len).sum())} channels; m in "
        f"{{2.0, 3.0, 4.5}}; {int(valid.sum())} valid samples")

    f_args = (x, m, vl, k0, sum0, var0)
    q_args = (xq, msq1, vl, qk0, qmean0, qvar0)
    records = {}

    # ---- float kernel vs plain, both contracts: bit-exact
    f_err = 0.0
    for full in (False, True):
        kern = fk.teda_scan_call(*f_args, full=full)
        plain = fk.teda_scan_plain(*f_args, full=full)
        torch.cuda.synchronize()
        tag = "full" if full else "verdict"
        f_err = max(f_err, _float_equal(f"C={c} T={t_len} {tag}", kern,
                                        plain))
        log(f"[kernels] teda_scan {tag}: every output bit-exact, finals "
            f"included ({int(kern[3].sum())} flags)")
    _float_edges(rng, dev)

    # ---- Q kernel vs plain, both contracts: bit-exact
    for full in (False, True):
        kern = qk.teda_q_scan_call(*q_args, fmt=fmt, full=full)
        plain = qk.teda_q_scan_plain(*q_args, fmt=fmt, full=full)
        torch.cuda.synchronize()
        tag = "full" if full else "verdict"
        names = ("mean", "var", "ecc", "outlier", "fk", "fmean", "fvar")
        for name, a, b in zip(names, kern, plain):
            if a is None:
                continue
            if name == "ecc":
                same = bool(((a == b) | ~valid).all())
            else:
                same = torch.equal(a, b.to(a.dtype))
            check(same, f"Q {tag} {name}: kernel and plain differ")
        log(f"[kernels] teda_q_scan {tag}: bit-exact "
            f"({int(kern[3].sum())} flags)")

    # ---- times: kernel (>= 20 launches after warm-up) and plain; the
    # float kernel by events and by the profiler's device time, with
    # phase 3's ragged vlen and with vlen = T (the main path's)
    uni = (x, m, torch.full_like(vl, t_len), k0, sum0, var0)
    for full in (False, True):
        for inputs, a in (("ragged", f_args), ("uniform", uni)):
            ev = cuda_ms(lambda: fk.teda_scan_call(*a, full=full), reps=50)
            dv = profiled_device_ms(lambda: fk.teda_scan_call(*a, full=full),
                                    10, "teda_scan")
            log(f"[kernels] teda_scan {'full' if full else 'verdict'} "
                f"{inputs} vlen: {ev:.4f} ms by events, "
                f"{'not measured' if dv is None else f'{dv:.4f} ms'} "
                "device time (profiler)")
            if not full and inputs == "uniform":
                f_ms, f_how = (ev, "events") if dv is None else (dv,
                                                                 "profiler")
    f_plain_ms = cuda_ms(lambda: fk.teda_scan_plain(*f_args), reps=2,
                         warmup=1)
    q_ms = cuda_ms(lambda: qk.teda_q_scan_call(*q_args, fmt=fmt), reps=20)
    q_full_ms = cuda_ms(lambda: qk.teda_q_scan_call(*q_args, fmt=fmt,
                                                    full=True), reps=20)
    q_plain_ms = cuda_ms(lambda: qk.teda_q_scan_plain(*q_args, fmt=fmt),
                         reps=2, warmup=1)
    # verdict contract: x in (4 B), ecc (4 B) + flag (1 B) out per
    # sample; m/vlen/k0/carry rows in and the three finals out
    f_bound = bound_ms(t_len, c, 4, 5, 5 + 3, float_ops_per_sample())
    q_bound = bound_ms(t_len, c, 4, 5, 5 + 3, q_recip_ops_per_sample())
    log(f"[kernels] teda_scan verdict {f_ms:.4f} ms per launch (uniform vlen, "
        f"{f_how}), plain {f_plain_ms:.2f} ms, bound {f_bound[0]:.4f} ms "
        f"({f_bound[1]})")
    log(f"[kernels] teda_q_scan verdict {q_ms:.4f} ms (full "
        f"{q_full_ms:.4f} ms), plain {q_plain_ms:.2f} ms, bound "
        f"{q_bound[0]:.4f} ms ({q_bound[1]})")
    ops = t_len * c * q_recip_ops_per_sample()
    log(f"[kernels] teda_q_scan by its own count, {q_recip_ops_per_sample()}"
        f" operations per sample: {ops / INSTR_PER_S * 1e3:.4f} ms at the "
        f"issue rate, {ops / INT32_OPS_PER_S * 1e3:.4f} ms at the INT32 "
        f"rate")
    records["teda_scan"] = {
        "name": "teda_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/teda_scan.cu",
        "replaces": "src/repro/kernels/teda_scan.py:118",
        "max_abs_err": f_err, "ms": f_ms, "plain_ms": f_plain_ms,
        "bound_ms": f_bound[0], "bound_by": f_bound[1],
        "library_ms": None}
    records["teda_q_scan"] = {
        "name": "teda_q_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/teda_q_scan.cu",
        "replaces": "src/repro/kernels/teda_q_scan.py:78",
        "max_abs_err": 0.0, "ms": q_ms, "plain_ms": q_plain_ms,
        "bound_ms": q_bound[0], "bound_by": q_bound[1],
        "library_ms": None}
    return records


ALL5 = ("teda", "rde", "zscore", "hst", "teda-q")
WINDOW = 8  # the repo's DEFAULT_WINDOW


def _words(v):
    return v.view(torch.int32)


def _score_diff(a, b):
    """Largest |a - b| of two float score streams: a NaN on both sides
    counts 0, a NaN on one side only counts inf."""
    both = a.isnan() & b.isnan()
    err = torch.where(both, 0.0, (a - b).abs()).nan_to_num(nan=float("inf"))
    return float(err.max()) if err.numel() else 0.0


def profiled_device_ms(fn, reps, name):
    """Device milliseconds per call of the kernels whose name contains
    `name`, from a torch.profiler window over `reps` calls of `fn`, or
    None when the profiler saw no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if str(ev.device_type).endswith("CUDA") and name in ev.key)
    return us / reps / 1e3 if us > 0 else None


def _ensemble_inputs(rng, c, t_len, dev):
    """The phase-3 ensemble inputs: a spiked stream with NaN samples,
    ragged vlen (0 and T included), m in {2, 3, 4.5, 4.003289222717285},
    member selections (some channels single-member, some with a member
    unselected) and thresholds from the "any", "majority" and "all"
    modes."""
    from repro_torch.detectors import vote_threshold

    _, _, x = _stream_inputs(rng, c, t_len)
    x[rng.random((t_len, c)) < 1e-4] = np.nan
    m = rng.choice(np.array([2.0, 3.0, 4.5, 4.003289222717285],
                            np.float32), size=c)
    vl = _ragged_vlen(rng, c, t_len)
    sel = np.ones((len(ALL5), c), np.float32)
    kind = rng.integers(0, 4, size=c)
    single = kind == 1
    sel[:, single] = 0.0
    sel[rng.integers(0, len(ALL5), size=int(single.sum())),
        np.flatnonzero(single)] = 1.0
    drop = kind == 2
    sel[rng.integers(0, len(ALL5), size=int(drop.sum())),
        np.flatnonzero(drop)] = 0.0
    sel[1, kind == 3] = 0.5  # a non-unit weight
    modes = rng.choice(np.array(["any", "majority", "all"]), size=c)
    thr = np.array([vote_threshold(str(mode), sel[:, i])
                    for i, mode in enumerate(modes)], np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return put(x), put(vl), put(m), put(thr), put(sel)


def _ensemble_equal(tag, kern, plain, detectors):
    """Every output of the kernel equals the plain version's, aux and
    scores as int32 words; returns the scores' largest difference."""
    for name, a, b in zip(("bits", "vote", "fk", "aux"), kern, plain):
        if name == "aux":
            a, b = _words(a), _words(b)
        check(torch.equal(a, b), f"ensemble {tag} {name}: kernel and plain "
              "differ")
    score_err = 0.0
    for d, name in enumerate(detectors):
        a, b = kern[4][d], plain[4][d]
        err = _score_diff(a, b)
        score_err = max(score_err, err)
        check(torch.equal(_words(a), _words(b)),
              f"ensemble {tag} {name} scores: kernel and plain differ "
              f"(largest difference {err!r})")
    return score_err


def _ensemble_edges(rng, dev, fmt):
    """The kernel against the plain version where a block has
    out-of-range channels (C = 1,000), a partial tile (T = 37, 21), a
    halved block (W = 300: the zscore ring outgrows 227 KB at 128
    channels), with its Q warps (teda-q alone, all five) and without
    them."""
    from repro_torch.detectors.spec import ensemble_spec
    from repro_torch.kernels import ensemble_scan as ek

    floats = ("teda", "rde", "zscore", "hst")
    cases = [(1000, 37, 8, ALL5), (300, 21, 300, ALL5),
             (1000, 37, 8, ("teda-q",)), (1000, 37, 8, ("rde", "hst")),
             (1000, 37, 8, floats), (300, 21, 300, floats)]
    for c, t_len, w, dets in cases:
        spec = ensemble_spec(dets, w)
        kw = dict(detectors=dets, window=w, fmt=fmt if "teda-q" in dets
                  else None)
        x, vl, m, thr, sel = _ensemble_inputs(rng, c, 3 * t_len, dev)
        pick = [ALL5.index(d) for d in dets]
        sel = sel[pick].contiguous()
        zeros = torch.zeros(c, device=dev)
        warm = ek.ensemble_scan_plain(x, vl, zeros, m, thr, sel,
                                      spec.init_aux(c, device=dev), **kw)
        x, vl, _, _, _ = _ensemble_inputs(rng, c, t_len, dev)
        args = (x, vl, warm[2], m, thr, sel, warm[3])
        plain = ek.ensemble_scan_plain(*args, **kw)
        _ensemble_equal(f"C={c} T={t_len} W={w} {dets}",
                        ek.ensemble_scan_call(*args, **kw), plain, dets)
    log(f"[kernels] ensemble_scan bit-exact with the plain version at "
        f"(C, T, W, members) = "
        f"{[(c, t, w, len(d)) for c, t, w, d in cases]}")


def phase_ensemble_kernel(seed):
    """The ensemble kernel against its plain version at full width."""
    from repro_torch.detectors.spec import ensemble_spec
    from repro_torch.fixedpoint import QFormat
    from repro_torch.kernels import ensemble_scan as ek

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    fmt = QFormat(32, 20)
    rng = np.random.default_rng(seed + 10)
    spec = ensemble_spec(ALL5, WINDOW)
    kw = dict(detectors=ALL5, window=WINDOW, fmt=fmt)
    # warm carried state: one 1,024-row chunk with its own ragged vlen
    wx, wvl, m, thr, sel = _ensemble_inputs(rng, c, 2 * t_len, dev)
    zeros = torch.zeros(c, device=dev)
    warm = ek.ensemble_scan_call(wx, wvl, zeros, m, thr, sel,
                                 spec.init_aux(c, device=dev), **kw)
    k0, aux0 = warm[2], warm[3]
    del wx, warm
    x, vl, _, _, _ = _ensemble_inputs(rng, c, t_len, dev)
    args = (x, vl, k0, m, thr, sel, aux0)
    log(f"[kernels] ensemble_scan C={c} T={t_len} K={len(ALL5)} "
        f"W={WINDOW} {fmt}: k0 in [{int(k0.min())}, {int(k0.max())}], "
        f"vlen 0 on {int((vl == 0).sum())}, T on "
        f"{int((vl == t_len).sum())} channels, {int(x.isnan().sum())} NaN "
        f"samples, {int((sel > 0).sum(0).eq(1).sum())} single-member "
        f"channels")

    kern = ek.ensemble_scan_call(*args, **kw)
    plain = ek.ensemble_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    score_err = _ensemble_equal("C=65536", kern, plain, ALL5)
    bits = kern[0]
    log(f"[kernels] ensemble_scan: bits, vote, "
        f"k, all five score streams and aux words bit-exact; scores' "
        f"largest difference {score_err!r}; {int(bits.ne(0).sum())} "
        f"flagged samples, {int(kern[1].sum())} votes, per member "
        f"{[int(((bits >> d) & 1).sum()) for d in range(len(ALL5))]}")
    _ensemble_edges(rng, dev, fmt)

    # ragged and uniform vlen on the same inputs, in one call on one card
    uni = (x, torch.full_like(vl, t_len)) + args[2:]
    times = {inputs: cuda_ms(lambda: ek.ensemble_scan_call(*a, **kw),
                             reps=20)
             for inputs, a in (("ragged", args), ("uniform", uni))}
    ms = times["ragged"]
    dev_ms = profiled_device_ms(lambda: ek.ensemble_scan_call(*args, **kw),
                                5, "ensemble_scan")
    plain_ms = cuda_ms(lambda: ek.ensemble_scan_plain(*args, **kw), reps=2,
                       warmup=1)
    log("[kernels] ensemble_scan by events (ms per launch): " + ", ".join(
        f"{i} {v:.4f}" for i, v in times.items()))
    # x in; bits (4 B), vote (1 B) and K scores out per sample; the aux
    # block in and out, the sel rows and the k0/m/thr/vlen/fk rows
    bound = bound_ms(t_len, c, 4, 4 + 1 + 4 * len(ALL5),
                     2 * spec.rows + len(ALL5) + 5,
                     ensemble_ops_per_sample())
    log(f"[kernels] ensemble_scan {ms:.4f} ms by events, "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
        f"device time (profiler), plain {plain_ms:.2f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    return {"ensemble_scan": {
        "name": "ensemble_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ensemble_scan.cu",
        "replaces": "src/repro/kernels/ensemble_scan.py:183",
        "max_abs_err": score_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}}


def _spiked_chunks(gen, c, t_len, n):
    """The main path's stream: n chunks (T, C) of per-channel level and
    scale with 0.2% spikes of 12 sigma, made on the card from `gen`."""
    dev = torch.device("cuda")
    mu = torch.randn(c, generator=gen, device=dev) * 2.0
    sigma = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
    chunks = []
    for _ in range(n):
        ch = mu + sigma * torch.randn((t_len, c), generator=gen, device=dev)
        spikes = torch.rand((t_len, c), generator=gen, device=dev) < 0.002
        chunks.append(torch.where(spikes, ch + 12.0 * sigma, ch))
    return chunks


def teda_times(seed, smi, reps=20):
    """teda_scan alone on the main path's inputs: C = 65,536, T = 512,
    phase 5's spiked stream, m = 3, from the state one chunk leaves,
    with vlen uniform (= T, the main path's), ragged (phase 3's draw, 0
    and T included) and zero (every row idle), in both contracts.  Per
    line: device time per launch from the profiler over `reps` launches,
    and milliseconds per launch by CUDA events over as many."""
    from repro_torch.kernels import teda_scan as fk

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    chunks = _spiked_chunks(torch.Generator(device=dev).manual_seed(seed + 2),
                            c, t_len, 2)
    m = torch.full((c,), 3.0, device=dev)
    zeros = torch.zeros(c, device=dev)
    uni = torch.full((c,), t_len, dtype=torch.int32, device=dev)
    *_, k0, sum0, var0 = fk.teda_scan_call(chunks[0], m, uni, zeros, zeros,
                                           zeros)
    vlens = {"uniform": uni, "ragged": torch.from_numpy(_ragged_vlen(
        np.random.default_rng(seed), c, t_len)).to(dev),
        "zero": torch.zeros_like(uni)}
    log(f"[times] teda_scan from {fk.__file__} on {smi}")
    for full in (False, True):
        for name, vl in vlens.items():
            args = (chunks[1], m, vl, k0, sum0, var0)
            ev = cuda_ms(lambda: fk.teda_scan_call(*args, full=full),
                         reps=reps)
            dv = profiled_device_ms(
                lambda: fk.teda_scan_call(*args, full=full), reps,
                "teda_scan")
            log(f"[times] teda_scan {'full' if full else 'verdict'} vlen "
                f"{name}: "
                f"{'not measured' if dv is None else f'{dv:.4f} ms'} "
                f"device time per launch (profiler), {ev:.4f} ms by events")


MEMBER_SETS = (ALL5, ("teda", "rde", "zscore", "hst"), ("teda",),
               ("rde", "zscore"), ("hst",), ("teda-q",))


def ensemble_times(seed, smi, reps=20):
    """ensemble_scan alone on the main path's inputs, for each member set
    of MEMBER_SETS: C = 65,536, T = 512, phase 5's spiked stream (no
    NaN), uniform vlen = T, every member selected, majority vote, m = 3,
    from the state one chunk leaves.  Milliseconds per launch by CUDA
    events over `reps` launches, one line per set.  A package whose
    wrapper still takes `fused=` (an earlier tree's one-thread-per-channel
    design, kept beside the Q warps for measurement) is timed both ways;
    the package beside this script has one design per member set."""
    import inspect

    from repro_torch.detectors import vote_threshold
    from repro_torch.detectors.spec import ensemble_spec
    from repro_torch.fixedpoint import QFormat
    from repro_torch.kernels import ensemble_scan as ek

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    chunks = _spiked_chunks(torch.Generator(device=dev).manual_seed(seed + 4),
                            c, t_len, 2)
    vl = torch.full((c,), t_len, dtype=torch.int32, device=dev)
    m = torch.full((c,), 3.0, device=dev)
    designs = [("one design", {})]
    if "fused" in inspect.signature(ek.ensemble_scan_call).parameters:
        designs = [("split", {"fused": False}), ("fused", {"fused": True})]
    log(f"[times] ensemble_scan from {ek.__file__} on {smi}")
    for dets in MEMBER_SETS:
        k = len(dets)
        kw = dict(detectors=dets, window=WINDOW,
                  fmt=QFormat(32, 20) if "teda-q" in dets else None)
        sel = torch.ones((k, c), device=dev)
        thr = torch.full((c,), vote_threshold("majority", np.ones(k)),
                         device=dev)
        warm = ek.ensemble_scan_call(
            chunks[0], vl, torch.zeros(c, device=dev), m, thr, sel,
            ensemble_spec(dets, WINDOW).init_aux(c, device=dev), **kw)
        args = (chunks[1], vl, warm[2], m, thr, sel, warm[3])
        for design, extra in designs:
            ms = cuda_ms(lambda: ek.ensemble_scan_call(*args, **kw, **extra),
                         reps=reps)
            log(f"[times] {'+'.join(dets)} ({design}): {ms:.4f} ms per "
                "launch")


def _engine_compare(tag, q, gpu_out, cpu_out, gpu_eng, cpu_eng, vl,
                    m_rows):
    t_len = gpu_out["ecc"].shape[0]
    valid = np.arange(t_len)[:, None] < vl[None, :]
    ge, ce = gpu_out["ecc"].cpu(), cpu_out["ecc"]
    go, co = gpu_out["outlier"].cpu(), cpu_out["outlier"]
    if q:
        check(bool(((ge == ce).numpy() | ~valid).all()),
              f"engine {tag}: Q ecc differs at valid rows")
        check(torch.equal(go, co), f"engine {tag}: Q flags differ")
        for f in ("k", "mean", "var", "active"):
            check(torch.equal(getattr(gpu_eng.state, f).cpu(),
                              getattr(cpu_eng.state, f)),
                  f"engine {tag}: Q state {f} differs")
        return
    _close(f"engine {tag} ecc", ge, ce, torch.from_numpy(valid))
    k_rows = (cpu_eng.state.k[None, :] - torch.from_numpy(vl)[None, :]
              + torch.arange(1, t_len + 1)[:, None])
    _, n_out = _band_mismatch(ce, m_rows, k_rows, go, co)
    check(n_out == 0, f"engine {tag}: {n_out} flag mismatches outside "
          "the threshold band")
    check(torch.equal(gpu_eng.state.k.cpu(), cpu_eng.state.k),
          f"engine {tag}: k differs")
    for f in ("mean", "var"):
        _close(f"engine {tag} {f}", getattr(gpu_eng.state, f).cpu(),
               getattr(cpu_eng.state, f))


def phase_engine(seed):
    from repro_torch.engine import StreamEngine
    from repro_torch.fixedpoint import QFormat

    c = C_ENGINE
    for backend in ("cuda", "cuda-q"):
        q = backend == "cuda-q"
        kw = {"fmt": QFormat(32, 20)} if q else {}
        gpu = StreamEngine(c, backend, **kw)
        cpu = StreamEngine(c, backend, device="cpu", **kw)
        check(gpu.device.type == "cuda", "engine default device is not CUDA")
        rng = np.random.default_rng(seed + 1)
        steps = [("uniform T=37", 37, None, None),
                 ("per-slot m T=128 ragged", 128, "ragged", None),
                 ("churn T=5", 5, None, None),
                 ("active subset T=300", 300, None, "subset")]
        for tag, t_len, ragged, act in steps:
            _, _, x = _stream_inputs(rng, c, t_len)
            if tag.startswith("per-slot"):
                slots = rng.choice(c, size=c // 8, replace=False)
                ms = rng.choice([1.5, 2.0, 4.0], size=c // 8)
                for eng in (gpu, cpu):
                    eng.set_m(slots, ms)
            if tag.startswith("churn"):
                for eng in (gpu, cpu):
                    eng.detach([5, 6, 7, c - 1])
                    eng.reset([8, 9])
                    eng.attach([5, c - 1], m=4.0)
            vl = (_ragged_vlen(rng, c, t_len) if ragged
                  else np.full(c, t_len, np.int32))
            active = (np.flatnonzero(rng.random(c) < 0.7) if act else None)
            go = gpu.process(x, active=active,
                             valid_lens=vl if ragged else None)
            co = cpu.process(x, active=active,
                             valid_lens=vl if ragged else None)
            part = cpu._active_mask_host().copy()
            if active is not None:
                amask = np.zeros(c, bool)
                amask[active] = True
                part &= amask
            eff = np.where(part, vl, 0)
            m_rows = torch.from_numpy(cpu.slot_m)[None, :]
            _engine_compare(f"{backend} {tag}", q, go, co, gpu, cpu, eff,
                            m_rows)
        log(f"[engine] {backend}: GPU engine equals the CPU engine "
            f"({'bit-exact' if q else 'within tolerance'}) over "
            f"{len(steps)} calls with ragged, per-slot m, churn, subset")


def _ensemble_compare(tag, go, co, gpu, cpu):
    """GPU ensemble engine against the CPU one, everything bit-exact
    (the scores' largest difference returned)."""
    for key in ("det_flags", "outlier"):
        check(torch.equal(go[key].cpu(), co[key]),
              f"ensemble engine {tag}: {key} differs")
    err = 0.0
    for d, name in enumerate(gpu.backend.detectors):
        a, b = go["scores"][d].cpu(), co["scores"][d]
        e = _score_diff(a, b)
        err = max(err, e)
        check(torch.equal(_words(a), _words(b)),
              f"ensemble engine {tag}: {name} scores differ (largest "
              f"difference {e!r})")
    for f in ("k", "active"):
        check(torch.equal(getattr(gpu.state, f).cpu(),
                          getattr(cpu.state, f)),
              f"ensemble engine {tag}: state {f} differs")
    check(torch.equal(_words(gpu.state.aux.cpu()), _words(cpu.state.aux)),
          f"ensemble engine {tag}: aux words differ")
    return err


def phase_ensemble_engine(seed):
    from repro_torch.engine import StreamEngine
    from repro_torch.fixedpoint import QFormat
    from repro_torch.kernels import ensemble_scan as ek
    from repro_torch.kernels import teda_scan as fk

    c = C_ENGINE
    kw = dict(detectors=ALL5, window=WINDOW, fmt=QFormat(32, 20))
    gpu = StreamEngine(c, "ensemble", **kw)
    cpu = StreamEngine(c, "ensemble", device="cpu", **kw)
    check(gpu.device.type == "cuda", "ensemble engine default device is "
          "not CUDA")
    rng = np.random.default_rng(seed + 3)
    steps = ("uniform T=37", "ragged T=128", "rde-only slots T=64",
             "vote all, churn T=5", "active subset T=100")
    err = 0.0
    for tag in steps:
        t_len = int(tag.split("T=")[1])
        _, _, x = _stream_inputs(rng, c, t_len)
        vl, active = None, None
        for eng in (gpu, cpu):
            if tag.startswith("rde"):
                eng.detach([11, 12])
                eng.attach([11, 12], detectors=("rde",))
                eng.set_m([11, 13], [2.0, 2.0])
            if tag.startswith("vote"):
                eng.set_detectors(np.arange(0, c, 3), vote="all")
                eng.detach([5, 6, c - 1])
                eng.reset([8, 9])
                eng.attach([5], m=2.5)
        if tag.startswith("ragged"):
            vl = _ragged_vlen(rng, c, t_len)
        if tag.startswith("active"):
            active = np.flatnonzero(rng.random(c) < 0.7)
        n = ek.launches
        go = gpu.process(x, active=active, valid_lens=vl)
        check(ek.launches == n + 1, "ensemble engine: not one kernel "
              "launch per process call")
        co = cpu.process(x, active=active, valid_lens=vl)
        err = max(err, _ensemble_compare(tag, go, co, gpu, cpu))
    log(f"[engine] ensemble: GPU engine equals the CPU engine over "
        f"{len(steps)} calls (uniform, ragged, rde-only slots, vote all, "
        f"churn, subset): bits, votes, all scores, k and aux words "
        f"bit-exact, scores' largest difference {err!r}")

    # the TEDA lane against the "cuda" engine, and against the float
    # kernel from the lane's own carried (k, S, var)
    ens = StreamEngine(c, "ensemble", detectors=("teda",), window=WINDOW)
    cud = StreamEngine(c, "cuda")
    w = WINDOW
    for i in range(3):
        _, _, x = _stream_inputs(rng, c, 64)
        xd = torch.from_numpy(x).cuda()
        st = ens.state
        lane = fk.teda_scan_call(xd, torch.full((c,), 3.0, device="cuda"),
                                 torch.full((c,), 64, dtype=torch.int32,
                                            device="cuda"),
                                 st.k, st.aux[w - 1], st.aux[2 * w])
        oe, oc = ens.process(xd), cud.process(xd)
        check(torch.equal(oe["outlier"], oc["outlier"]),
              "ensemble teda lane: flags differ from the cuda engine")
        check(torch.equal(oe["scores"][0], lane[2]) and torch.equal(
            oe["det_flags"] == 1, lane[3]), "ensemble teda lane: ecc or "
            "flags differ from teda_scan on the same carries")
        check(torch.equal(ens.state.aux[w - 1], lane[5])
              and torch.equal(ens.state.aux[2 * w], lane[6]),
              "ensemble teda lane: carries differ from teda_scan")
        if i == 0:
            check(torch.equal(oe["scores"][0], oc["ecc"]),
                  "ensemble teda lane: first-chunk ecc differs from the "
                  "cuda engine")
    log("[engine] ensemble teda lane: flags equal to the cuda engine over "
        "3 chunks (first chunk's ecc bit-identical); ecc, flags and "
        "carries bit-identical to teda_scan from the lane's own carries")


def phase_stream(seed, smi):
    from repro_torch.engine import StreamEngine
    from repro_torch.fixedpoint import QFormat
    from repro_torch.kernels import teda_q_scan as qk
    from repro_torch.kernels import teda_scan as fk
    from repro_torch.kernels.ref import teda_ref

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    fmt = QFormat(32, 20)
    chunks = _spiked_chunks(torch.Generator(device=dev).manual_seed(seed + 2),
                            c, t_len, N_CHUNKS)
    q_chunks = [fmt.quantize(ch) for ch in chunks]
    engines = {"cuda": StreamEngine(c, "cuda"),
               "cuda-q": StreamEngine(c, "cuda-q", fmt=fmt)}
    feeds = {"cuda": chunks, "cuda-q": q_chunks}
    # one untimed pass per engine first, holding its outputs as the
    # timed pass does, so that lazy module loading and the caching
    # allocator's first device allocations stay out of the timing
    for backend, eng in engines.items():
        held = [eng.process(ch) for ch in feeds[backend]]
        torch.cuda.synchronize()
        del held
        eng.reset()

    fk.launches = 0
    qk.launches = 0
    results = {}
    for backend, eng in engines.items():
        outs = []
        t0 = time.perf_counter()
        for ch in feeds[backend]:
            outs.append(eng.process(ch))
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[backend] = (wall, enqueue, outs)
    launches = {"teda_scan": fk.launches, "teda_q_scan": qk.launches}

    n_samples = N_CHUNKS * t_len * c
    for backend, (wall, enqueue, outs) in results.items():
        eng = engines[backend]
        for o in outs:
            check(tuple(o["ecc"].shape) == (t_len, c)
                  and tuple(o["outlier"].shape) == (t_len, c),
                  f"stream {backend}: output shape")
        if backend == "cuda":
            check(bool(torch.stack([o["ecc"] for o in outs]).isfinite()
                       .all()), "stream cuda: non-finite ecc")
        check(bool((eng.state.k == N_CHUNKS * t_len).all()),
              f"stream {backend}: k is not {N_CHUNKS * t_len} everywhere")
        flags = sum(int(o["outlier"].sum()) for o in outs)
        check(flags > 0, f"stream {backend}: no flags on a spiked stream")
        log(f"[stream] {backend}: {n_samples / wall:.6e} samples/s "
            f"({N_CHUNKS} x ({t_len}, {c}) in {wall * 1e3:.3f} ms, "
            f"{wall * 1e3 / N_CHUNKS:.3f} ms per call, host enqueue "
            f"{enqueue * 1e3:.3f} ms, {flags} flags) on {smi}")
    check(launches["teda_scan"] == N_CHUNKS,
          f"teda_scan launched {launches['teda_scan']} times for "
          f"{N_CHUNKS} process calls")
    check(launches["teda_q_scan"] == N_CHUNKS,
          f"teda_q_scan launched {launches['teda_q_scan']} times for "
          f"{N_CHUNKS} process calls")
    log(f"[stream] launches during the main path: {launches}")
    for backend, eng in engines.items():
        profile_window(backend, eng, feeds[backend][:6])

    # the first chunk of 64 channels against the float64 oracle
    x0 = chunks[0][:, :64].cpu().numpy()
    ref = teda_ref(x0, 3.0)
    got = results["cuda"][2][0]
    _close("stream cuda vs teda_ref ecc",
           got["ecc"][:, :64].cpu(), torch.from_numpy(ref["ecc"]))
    k_rows = torch.arange(1, t_len + 1, dtype=torch.float64)[:, None]
    _, n_out = _band_mismatch(torch.from_numpy(ref["ecc"]), 3.0, k_rows,
                              got["outlier"][:, :64].cpu(),
                              torch.from_numpy(ref["outlier"]))
    check(n_out == 0, f"stream cuda: {n_out} flags differ from teda_ref "
          "outside the threshold band")
    log("[stream] cuda first chunk (64 channels) agrees with teda_ref")
    return launches


def phase_ensemble_stream(seed, smi):
    """The "ensemble" main path at full width: returns its launches."""
    from repro_torch.detectors.ensemble import ensemble_ref
    from repro_torch.engine import StreamEngine
    from repro_torch.fixedpoint import QFormat
    from repro_torch.kernels import ensemble_scan as ek

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    fmt = QFormat(32, 20)
    chunks = _spiked_chunks(torch.Generator(device=dev).manual_seed(seed + 4),
                            c, t_len, N_CHUNKS)
    eng = StreamEngine(c, "ensemble", detectors=ALL5, window=WINDOW,
                       fmt=fmt, vote="majority")
    held = [eng.process(ch) for ch in chunks]  # untimed pass
    torch.cuda.synchronize()
    del held
    eng.reset()

    ek.launches = 0
    outs = []
    t0 = time.perf_counter()
    for ch in chunks:
        outs.append(eng.process(ch))
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ek.launches
    check(launches == N_CHUNKS, f"ensemble_scan launched {launches} times "
          f"for {N_CHUNKS} process calls")

    n_samples = N_CHUNKS * t_len * c
    for o in outs:
        check(tuple(o["det_flags"].shape) == (t_len, c)
              and tuple(o["outlier"].shape) == (t_len, c)
              and tuple(o["scores"].shape) == (len(ALL5), t_len, c),
              "stream ensemble: output shape")
    check(bool(torch.stack([o["scores"] for o in outs]).isfinite().all()),
          "stream ensemble: non-finite scores")
    check(bool((eng.state.k == N_CHUNKS * t_len).all()),
          f"stream ensemble: k is not {N_CHUNKS * t_len} everywhere")
    per = [sum(int(((o["det_flags"] >> d) & 1).sum()) for o in outs)
           for d in range(len(ALL5))]
    votes = sum(int(o["outlier"].sum()) for o in outs)
    check(all(per[d] > 0 for d in (0, 1, 3, 4)) and votes > 0,
          f"stream ensemble: too few flags on a spiked stream ({per})")
    log(f"[stream] ensemble: {n_samples / wall:.6e} samples/s "
        f"({N_CHUNKS} x ({t_len}, {c}), K={len(ALL5)}, in "
        f"{wall * 1e3:.3f} ms, {wall * 1e3 / N_CHUNKS:.3f} ms per call, "
        f"host enqueue {enqueue * 1e3:.3f} ms, flags per member {per}, "
        f"{votes} votes) on {smi}")
    log(f"[stream] launches during the ensemble main path: "
        f"{{'ensemble_scan': {launches}}}")
    profile_window("ensemble", eng, chunks[:6])

    # the first 128 rows of 64 channels against the oracle composition:
    # rde, hst and teda-q exact (their oracles run the kernel's operations
    # in the kernel's order); teda and zscore flags equal outside a 1e-4
    # band around their thresholds, scores within 5e-3; the vote equal
    # wherever the bits are
    rows, cols = 128, 64
    x0 = chunks[0][:rows, :cols].cpu()
    ref = ensemble_ref(x0, 3.0, detectors=ALL5, window=WINDOW, fmt=fmt)
    got = outs[0]
    bits = got["det_flags"][:rows, :cols].cpu()
    k = torch.arange(1, rows + 1, dtype=torch.float32)[:, None]
    for d, name in enumerate(ALL5):
        mine = ((bits >> d) & 1).bool()
        want = ref["per_detector"][name]
        score = got["scores"][d, :rows, :cols].cpu()
        rscore = ref["per_score"][name]
        if name in ("teda", "zscore"):
            val, thr = ((rscore * 0.5, 10.0 / (2.0 * k)) if name == "teda"
                        else (rscore, torch.full_like(rscore, 9.0)))
            band = (val - thr).abs() <= BAND * thr
            check(not bool(((mine != want) & ~band).any()),
                  f"stream ensemble: {name} flags differ from the oracle "
                  "outside the threshold band")
            check(torch.allclose(score, rscore, rtol=5e-3, atol=5e-3),
                  f"stream ensemble: {name} scores differ from the oracle")
        else:
            check(torch.equal(mine, want) and torch.equal(
                _words(score), _words(rscore)),
                f"stream ensemble: {name} flags or scores differ from the "
                "oracle")
    same = bits == ref["det_flags"]
    check(torch.equal(got["outlier"][:rows, :cols].cpu()[same],
                      ref["vote"][same]),
          "stream ensemble: vote differs from the oracle's")
    log(f"[stream] ensemble first chunk ({rows} rows x {cols} channels) "
        "agrees with the oracle composition ensemble_ref")
    return {"ensemble_scan": launches}


# the serving phase: tenants, history, live, chunk_t, buckets, arrivals
SERVE_LOADS = {
    "cuda-q": (16_384, 480, 32, 32, (1024, 4096, 16_384), 2048),
    "cuda": (4096, 480, 32, 32, (256, 1024, 4096), 512),
    "ensemble": (4096, 480, 32, 32, (256, 1024, 4096), 512),
}


def _engine_opts(backend):
    from repro_torch.fixedpoint import QFormat

    opts = {}
    if backend != "cuda":
        opts["fmt"] = QFormat(32, 20)
    if backend == "ensemble":
        opts.update(detectors=ALL5, window=WINDOW)
    return opts


def _serve(backend, streams, device, **kw):
    """One `serve_streams` run at `backend`'s serving load, with the
    launch counts of the three kernels it may reach over the run."""
    from repro_torch.kernels import ensemble_scan as ek
    from repro_torch.kernels import teda_q_scan as qk
    from repro_torch.kernels import teda_scan as fk
    from repro_torch.launch.serve import serve_streams

    _, _, _, chunk_t, buckets, arrivals = SERVE_LOADS[backend]
    opts = dict(backend=backend, device=device, chunk_t=chunk_t,
                buckets=buckets, arrivals_per_tick=arrivals,
                queue_limit=2 * arrivals,
                class_weights={"latency": 4.0, "bulk": 1.0},
                **_engine_opts(backend))
    opts.update(kw)
    mods = {"teda_scan": fk, "teda_q_scan": qk, "ensemble_scan": ek}
    for mod in mods.values():
        mod.launches = 0
    res = serve_streams(streams, **opts)
    return res, {name: mod.launches for name, mod in mods.items()}


def _serve_profiled(backend, streams):
    """The depth-1 async gateway once more, under torch.profiler (device
    activity only) and a TickTracer: (result, device microseconds,
    host microseconds per span name)."""
    from repro_torch.obs import TickTracer

    tracer = TickTracer(capacity=1 << 17)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        res, _ = _serve(backend, streams, "cuda", measure_latency=False,
                        tracer=tracer)
        torch.cuda.synchronize()
    dev_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if str(ev.device_type).endswith("CUDA"))
    spans = {}
    for ev in tracer.events():
        if ev["ph"] == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
    return res, dev_us, spans


def _pool_probe(backend, capacity, n=512):
    """Milliseconds per `SlotPool.acquire(1)` and per `release` of one
    slot at `capacity` slots with no resize (each reads the active mask
    back to the host: one device sync)."""
    from repro_torch.engine import SlotPool

    pool = SlotPool(backend, buckets=(capacity,), **_engine_opts(backend))
    pool.acquire(capacity // 2)
    n = min(n, capacity // 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [int(pool.acquire(1)[0]) for _ in range(n)]
    t1 = time.perf_counter()
    for slot in slots:
        pool.release([slot])
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n


def _serve_same(tag, backend, a, b, m_of):
    """Per-request verdicts of two gateway runs: the Q path bit for bit;
    "cuda" flags equal outside the 1e-4 band around the threshold (from
    `a`'s ecc); "ensemble" bitmask and vote bit for bit."""
    check(a["flagged"] == b["flagged"] or backend == "cuda",
          f"serve {tag}: flagged tenants differ")
    sa, sb = a["_scheduler"], b["_scheduler"]
    n_out = 0
    for rid, row in a["per_request"].items():
        other = b["per_request"][rid]
        check(row["samples"] == other["samples"],
              f"serve {tag}: {rid} samples differ")
        ra, rb = sa.results(rid), sb.results(rid)
        if backend == "cuda":
            ecc = torch.from_numpy(ra["ecc"]).double()[:, None]
            k = torch.arange(1, ecc.shape[0] + 1,
                             dtype=torch.float64)[:, None]
            _, bad = _band_mismatch(ecc, m_of[rid], k,
                                    torch.from_numpy(ra["outlier"])[:, None],
                                    torch.from_numpy(rb["outlier"])[:, None])
            n_out += bad
            continue
        check(row["flags"] == other["flags"]
              and row["det_flags"] == other["det_flags"],
              f"serve {tag}: {rid} flag counts differ")
        check(np.array_equal(ra["outlier"], rb["outlier"])
              and np.array_equal(ra["ecc"], rb["ecc"]),
              f"serve {tag}: {rid} verdicts differ")
    check(n_out == 0, f"serve {tag}: {n_out} flags differ outside the "
          "threshold band")


def phase_serve(seed, smi):
    """The gateway main path, `serve_streams` on the card, per backend:
    the GPU gateway against the port's own CPU gateway on the same
    streams, the async loop at depth 1 (and for "cuda-q" at depth 4),
    then a synchronous run for per-call wall times and a profiled run
    with the pool probe for where the time goes.  Returns each kernel's
    launches during its backend's depth-1 run."""
    from repro_torch.launch.serve import _demo_streams

    launches = {}
    for backend, (n, hist, live, _, buckets, _) in SERVE_LOADS.items():
        streams = _demo_streams(n, hist, live, seed=seed)
        m_of = {s[0]: s[3] for s in streams}
        total = n * (hist + live)
        cpu, _ = _serve(backend, streams, "cpu", collect=True,
                        measure_latency=False)
        gpu, used = _serve(backend, streams, "cuda", collect=True,
                           measure_latency=False)
        sched = gpu["_scheduler"]
        calls = int(sched._c_calls.value)
        kname = {"cuda": "teda_scan", "cuda-q": "teda_q_scan",
                 "ensemble": "ensemble_scan"}[backend]
        check(used[kname] == calls and calls > 0
              and sum(used.values()) == calls,
              f"serve {backend}: {used} kernel launches for {calls} fused "
              "calls")
        launches[kname] = used[kname]
        check(gpu["requests"] == n == sched.completed
              and gpu["samples"] == total,
              f"serve {backend}: {sched.completed}/{n} requests completed")
        check(gpu["pool"]["resizes"] >= 2
              and gpu["pool"]["bucket"] == buckets[0]
              and max(c for c, _ in gpu["programs"]) == buckets[-1],
              f"serve {backend}: the pool did not grow through the ladder "
              f"and shrink back ({gpu['pool']})")
        check(bool(gpu["flagged"]), f"serve {backend}: no tenant flagged")
        _serve_same(f"{backend} gpu vs cpu", backend, cpu, gpu, m_of)
        runs = [("depth 1", gpu)]
        if backend == "cuda-q":
            deep, used4 = _serve(backend, streams, "cuda", collect=True,
                                 measure_latency=False, pipeline_depth=4)
            check(used4[kname] == int(deep["_scheduler"]._c_calls.value),
                  f"serve {backend} depth 4: {used4} launches")
            _serve_same(f"{backend} depth 4 vs depth 1", backend, gpu, deep,
                        m_of)
            runs.append(("depth 4", deep))
        sync, _ = _serve(backend, streams, "cuda", measure_latency=True)
        walls = np.array([c["wall_s"] for c in sync["_scheduler"].call_log])
        check(sync["flagged"] == gpu["flagged"] or backend == "cuda",
              f"serve {backend}: the synchronous run flagged other tenants")
        for tag, res in runs:
            log(f"[serve] {backend} {tag}: {n} tenants x ({hist} history + "
                f"{live} live), chunk_t {SERVE_LOADS[backend][3]}, buckets "
                f"{buckets}: {res['ticks']} ticks, {res['requests']} "
                f"completed, {res['pool']['resizes']} resizes, programs "
                f"{res['programs']}, {res['samples_per_s']:.6e} samples/s "
                f"({res['wall_s']:.3f} s), {len(res['flagged'])} tenants "
                f"flagged, {res['short_ticks']} short ticks on {smi}")
        log(f"[serve] {backend}: {used[kname]} {kname} launches in "
            f"{gpu['ticks']} ticks ({used[kname] / gpu['ticks']:.3f} per "
            f"tick); synchronous run: per-call wall p50 "
            f"{np.percentile(walls, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(walls, 99) * 1e3:.3f} ms over {len(walls)} "
            f"calls, {sync['samples_per_s']:.6e} samples/s; CPU gateway "
            f"{cpu['samples_per_s']:.6e} samples/s (plain versions)")
        prof, dev_us, spans = _serve_profiled(backend, streams)
        acq_ms, rel_ms = _pool_probe(backend, buckets[-1])
        wall_us = prof["wall_s"] * 1e6
        if dev_us > 0:
            busy = (f"device busy {dev_us / 1e3:.3f} ms = "
                    f"{100.0 * dev_us / wall_us:.2f}% of the wall")
        else:
            busy = "device busy not measured (the profiler saw no device time)"
        dispatch_s = spans.get("dispatch", 0.0) / 1e6
        retire_s = spans.get("retire", 0.0) / 1e6
        pool_s = n * (acq_ms + rel_ms) / 1e3
        log(f"[serve] {backend} where the time goes (depth 1 again, "
            f"profiled): wall {prof['wall_s']:.3f} s, {busy}; host in "
            f"dispatch spans {dispatch_s:.3f} s (the engine call: x and "
            f"vlens upload, enqueue), in retire spans {retire_s:.3f} s "
            f"(the .cpu() fetches); pool probe at {buckets[-1]} slots: "
            f"acquire {acq_ms:.4f} ms, release {rel_ms:.4f} ms per tenant, "
            f"x {n} tenants = {pool_s:.3f} s; the rest by subtraction "
            f"{prof['wall_s'] - dispatch_s - retire_s - pool_s:.3f} s (feed "
            f"loop, per-member take and accounting loops, admission)")
        log(f"[serve] {backend}: GPU gateway equals the CPU gateway"
            + (" and the depth-4 pipeline" if len(runs) > 1 else "")
            + (" (flags outside the 1e-4 band)" if backend == "cuda"
               else " bit for bit"))
    return launches


def profile_window(backend, eng, feed, warmup=2):
    """Where an engine call's time goes: torch.profiler over the
    `process` calls of `feed` but the first `warmup`, which the profiler
    traces and drops so that its own start-up falls outside the window.
    Prints the device's busy share of that one window (wall clock from
    the first recorded call to the end of the last one's device work)
    and the device time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_active = len(feed) - warmup
    sched = torch.profiler.schedule(wait=0, warmup=warmup, active=n_active,
                                    repeat=1)
    traced = []  # the recorded cycle's events, handed over as it ends
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=acts, schedule=sched,
            on_trace_ready=lambda p: traced.append(p.key_averages())) \
            as prof:
        for i, ch in enumerate(feed):
            eng.process(ch)
            # the device is idle as recording starts and when it stops
            if i in (warmup - 1, len(feed) - 1):
                torch.cuda.synchronize()
            if i == len(feed) - 1:
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
            if i == warmup - 1:
                t0 = time.perf_counter()
    check(len(traced) == 1, f"profile {backend}: the profiler recorded "
          f"{len(traced)} cycles, not 1")
    rows = []
    for ev in traced[0]:
        # the device's own events (kernels, copies, fills), not the
        # host ops that launched them nor the step annotations
        if str(ev.device_type).endswith("CUDA") \
                and ev.self_device_time_total > 0 \
                and not ev.key.startswith("ProfilerStep"):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {backend}: the profiler saw no device time "
            "(not measured)")
        return
    log(f"[profile] {backend}: {n_active} calls after {warmup} dropped, "
        f"in {wall_us:.1f} us (profiled), device busy {busy:.1f} us = "
        f"{100.0 * busy / wall_us:.1f}% of the window")
    for dev_us, key, count in rows[:6]:
        log(f"[profile]   {dev_us:10.1f} us  x{count:<4d} {key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ensemble-times", action="store_true",
                    help="time the ensemble kernel alone per member set")
    ap.add_argument("--teda-times", action="store_true",
                    help="time the float kernel alone, uniform, ragged and "
                    "zero vlen")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="the tree whose package the --*-times modes run")
    args = ap.parse_args(argv)
    times = args.ensemble_times or args.teda_times

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    src = (args.src if times else ROOT).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    if times:
        if args.ensemble_times:
            ensemble_times(args.seed, smi)
        if args.teda_times:
            teda_times(args.seed, smi)
        return 0
    phase_divider(args.seed)
    records = phase_kernels(args.seed)
    records.update(phase_ensemble_kernel(args.seed))
    torch.cuda.empty_cache()
    phase_engine(args.seed)
    phase_ensemble_engine(args.seed)
    launches = phase_stream(args.seed, smi)
    launches.update(phase_ensemble_stream(args.seed, smi))
    served = phase_serve(args.seed, smi)
    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec["launches_serve"] = served[name]
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_serve", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
