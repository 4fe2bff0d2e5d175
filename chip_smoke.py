#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the TEDA system on one GPU and check it.

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
               timing `SlotPool.acquire` / `release` alone;
  7. fleet   — the sharded gateway: `serve_streams(shards=K,
               rebalance_every=4)` on the card for "cuda-q" (phase 6's
               16,384 tenants over 4 shards, per-shard buckets
               1024/4096/8192), "ensemble" and "cuda" (4,096 tenants over
               2 shards, 256/1024/4096), against phase 6's single-pool
               GPU run ("cuda-q" and "ensemble" bit for bit, "cuda" ecc
               bit for bit and flags outside the band), with live
               migrations (> 0); samples/s, ticks, launches per tick (one
               per shard call), migrations, final imbalance, resizes per
               shard, and a probe timing one migration; then the channel
               split: StreamEngine(65536, "cuda" / "cuda-q",
               devices=[cuda:0, cuda:0]) (and [cuda:0, cuda:1] with a
               second card) over phase 5's chunks, bit-exact with the
               unsplit engine, two launches per call, the current device
               unchanged;
  8. train   — the TEDA-guarded training loop, which launches none of
               the three TEDA kernels (the guard runs the plain
               single-sample step; checked by the launch counts): (a)
               llama3.2-1b `reduced()`, batch 4 x seq 64, 12 guarded
               steps through `make_train_step` from one parameter tree
               on the card and on the CPU: equal skip verdicts, count
               and skipped, losses within rtol 2e-2; (b) llama3.2-1b at
               its full width (16 x 2048, vocab 128256) through
               `train()`, batch 8 x seq 128, 24 guarded steps with a
               corrupt batch every 10: finite losses and grad norms,
               the loss falling, the card's skip verdicts equal to the
               guard replayed on the CPU over the same telemetry (each
               corrupt step's zeta printed beside its threshold), ms
               per step, tokens/s, peak memory and a profiled window of
               4 steps (device busy share, top device ops), and the
               masked update at full width (skip True leaves every
               parameter, moment and the count bit for bit); (c) the
               "small" scale (8 x 512, vocab 32768), batch 8 x seq 128:
               12 steps straight against 6 steps, a save and a resume
               to 12 under deterministic algorithms: restored tensors
               bit-equal to the saved ones, the same token batches,
               losses bit-equal; save and restore times;
  9. lm      — LM serving with the TEDA monitor: (a) llama3.2-1b
               `reduced()` (batch 4, prompt 16, gen 16) and gemma2-2b
               `reduced()` (batch 2, prompt 48, gen 32: past its 64-slot
               ring) in float32 compute through `serve_prompts` from one
               tree and prompt set on the card ("cuda-q" and "cuda") and
               on the CPU: equal tokens, telemetry within rtol 1e-4, the
               card's "cuda-q" monitor bit for bit with the CPU monitor
               replaying the card's rows, "cuda" flags equal outside the
               band; (b) llama3.2-1b at its full width through `serve()`,
               batch 8, prompt 128, gen 128, once with "cuda" and once
               with "cuda-q": prefill and decode tokens/s, ms per decode
               step, one launch of the backend's kernel per decode tick
               (counted by the kernel modules), none of the others, peak
               memory; `lm_prefill`'s own tokens/s; a profiled window of
               8 decode steps run as `serve` runs them (device busy
               share, top device ops); (c) decode against `lm_forward`
               at full width in float32 compute, rtol 1e-3 / atol 1e-3,
               argmax equal.

  10. families — the other model families: (a) mixtral-8x7b,
               dbrx-132b (8 experts, top-4), zamba2-2.7b and xlstm-350m
               `reduced()` in float32 compute, 6 guarded steps through
               `make_train_step` from one tree on the card and on the
               CPU (losses within rtol 1e-3, equal skip verdicts, every
               MoE route equal) and `serve_prompts` (batch 2, prompt
               16, gen 16) as phase 9 (a); seamless-m4t-medium
               `encdec_loss` and 8 greedy `encdec_decode_step`s, card
               against CPU; (b) zamba2-2.7b at its published width and
               depth (54 Mamba2 layers x 2560, the shared block every 6)
               through `train()`, batch 8 x seq 256 (two SSD chunks per
               sequence), 12 guarded steps with a corrupt batch every
               10: finite losses, the card's skip verdicts against the
               guard replayed on the CPU, ms per step, tokens/s, peak
               memory, a profiled window of 2 steps; then
               `serve_prompts` on the trained model, batch 8, prompt
               128, gen 128, for "cuda" and "cuda-q" (one launch of the
               backend's kernel per decode tick, none of the others), a
               profiled window of 8 decode steps and `lm_prefill`'s
               tokens/s; (c) mixtral-8x7b at its published width with
               its depth cut to 2 layers (32 do not fit one card):
               `train()` batch 8 x seq 128, 8 steps (ms per step, peak
               memory, each step's dropped_frac per layer, the remat
               recompute's routes equal to the forward's) and
               `serve_prompts` batch 8, prompt 128, gen 32 with "cuda";
               (d) decode against forward at full width in float32
               compute, rtol 1e-3 / atol 1e-3, argmax equal: xlstm-350m,
               zamba2-2.7b, mixtral at 2 layers with capacity_factor 4,
               and seamless (`encdec_decode_step` against
               `decode_train`).

  11. distributed — the time-sharded TEDA scan across shards, which
               launches none of the three TEDA kernels (checked by the
               launch counts): (a) `distributed_teda` over
               [cuda:0] * 4 (and cuda:0-3 with four cards) on one
               (2^24, 4) float32 stream from the seed with bursts, m =
               3, against the single-device `teda_scan` on the card
               (rtol 5e-4 / atol 1e-5, flags equal outside the 1e-4 band,
               final k exact), the four shards' final states bit-equal,
               3 counted gathers of 72 B (ring model); ms per pass by
               CUDA events beside the 37 B-per-row byte bound and
               `teda_scan`'s ms, peak memory; the first 2^20 rows
               against the port's CPU form; (b) `distributed_teda_group`
               over NCCL with min(cards, 4) ranks, one child process per
               card, each rank bit-equal to the `DeviceAxis` form at the
               same D; (c) the GPipe stage loop: the JAX package's test's
               four affine stages over 6 microbatches, exact, and
               llama3.2-1b's 16 blocks at full width (random weights
               from the seed) as 4 stages of 4 over 8 microbatches of
               (1, 128) hidden states, bit-equal to the blocks applied
               microbatch by microbatch, in 11 ticks; (d)
               `teda_dryrun.run` for the 256- and 512-device meshes at T
               = 2^24, N = 4 (3 gathers, 360 B and 744 B), the roofline
               terms, and the card's peak memory for one shard's block
               of the single mesh.

  12. sharded — the model side of multi-device (DTensor placements by
               the sharding rules), which launches none of the three
               TEDA kernels: (a) phase 8 (b)'s training (its schedule,
               guard and batches) for 8 steps through `train(...,
               mesh=make_host_mesh())` over a one-rank NCCL group: ms
               per step, tokens/s and peak memory beside phase 8's, the
               first 4 losses against phase 8's (rtol 2e-2); (b)
               llama3.2-1b at full width, the train (8 x 128), prefill
               (8 x 128) and decode (batch 8, a 256-slot cache) cells
               on that mesh against the unsharded functions on the same
               weights and inputs: loss and grad norm rtol 1e-3,
               parameters rtol 1e-3 / atol 1e-5, logits and caches
               within 2e-2 (bf16 compute), one call each timed; (c) the
               production dry run of llama3.2-1b's train_4k,
               prefill_32k and decode_32k, mixtral-8x7b's train_4k and
               prefill_32k, dbrx-132b's train_4k and xlstm-350m's
               train_4k on the 16 x 16 mesh (child processes on the
               CPU, a fake 256-rank group, meta):
               per-device flops, bytes, collective bytes and roofline
               terms reckoned with H100 constants, trace seconds, each
               count over the JAX package's (`DRY_REF`): at most 1.25 x
               its flops and 1.5 x its collective bytes, and no view
               resharded (`ViewResharding`); (d)
               one device's share of decode_32k allocated on the card
               under a fake 256-rank group (local shapes real, values
               meaningless): its argument bytes equal to (c)'s, its
               peak memory; (e) with two or four cards, the reduced
               train cell over NCCL ranks on a (2, 1) or (2, 2) mesh
               against the unsharded step, else "not measured".

The last three lines are the kernels' JSON record (`launches` from
phase 5, `launches_serve` from phase 6, `launches_fleet` from phase 7's
gateway runs, `launches_lm` from phase 9 (b), `launches_families` from
phase 10 (b), `launches_distributed` from phase 11, `launches_sharded`
from phase 12), the card's name and power limit as nvidia-smi prints
them, and {"ok": true, "device": ...}.
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
import contextlib
import hashlib
import json
import os
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
def timed(phase, *args, **kw):
    """`phase(*args, **kw)`, with its wall seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args, **kw)
    log(f"[time] {phase.__name__} took {time.perf_counter() - t0:.1f} s")
    return out


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
    "cuda-q": (4096, 480, 32, 32, (256, 1024, 4096), 512),
    "cuda": (4096, 480, 32, 32, (256, 1024, 4096), 512),
    "ensemble": (4096, 480, 32, 32, (256, 1024, 4096), 512),
}
KERNEL_OF = {"cuda": "teda_scan", "cuda-q": "teda_q_scan",
             "ensemble": "ensemble_scan"}


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
    t0 = time.perf_counter()
    res = serve_streams(streams, **opts)
    res["total_s"] = time.perf_counter() - t0  # set-up included
    return res, {name: mod.launches for name, mod in mods.items()}


def _serve_profiled(backend, streams):
    """The depth-1 async gateway on the card, collecting verdicts, under
    torch.profiler (device activity only) and a TickTracer: (result,
    kernel launches, device microseconds, host microseconds per span
    name)."""
    from repro_torch.obs import TickTracer

    tracer = TickTracer(capacity=1 << 17)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        res, used = _serve(backend, streams, "cuda", collect=True,
                           measure_latency=False, tracer=tracer)
        torch.cuda.synchronize()
    dev_us = sum(us for us, _, _ in _device_rows(prof))
    spans = {}
    for ev in tracer.events():
        if ev["ph"] == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
    return res, used, dev_us, spans


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
    streams, the async loop at depth 1 under the profiler (with the pool
    probe: where the time goes) and for "cuda-q" at depth 4, then a
    synchronous run for per-call wall times.  Returns each kernel's
    launches during its backend's depth-1 run, and each backend's
    depth-1 GPU run (phase 7's single-pool reference)."""
    from repro_torch.launch.serve import _demo_streams

    launches, singles = {}, {}
    for backend, (n, hist, live, _, buckets, _) in SERVE_LOADS.items():
        t_backend = time.perf_counter()
        streams = _demo_streams(n, hist, live, seed=seed)
        m_of = {s[0]: s[3] for s in streams}
        total = n * (hist + live)
        cpu, _ = _serve(backend, streams, "cpu", collect=True,
                        measure_latency=False)
        gpu, used, dev_us, spans = _serve_profiled(backend, streams)
        sched = gpu["_scheduler"]
        calls = int(sched._c_calls.value)
        kname = KERNEL_OF[backend]
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
        singles[backend] = gpu
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
        acq_ms, rel_ms = _pool_probe(backend, buckets[-1])
        wall_us = gpu["wall_s"] * 1e6
        if dev_us > 0:
            busy = (f"device busy {dev_us / 1e3:.3f} ms = "
                    f"{100.0 * dev_us / wall_us:.2f}% of the wall")
        else:
            busy = "device busy not measured (the profiler saw no device time)"
        dispatch_s = spans.get("dispatch", 0.0) / 1e6
        retire_s = spans.get("retire", 0.0) / 1e6
        pool_s = n * (acq_ms + rel_ms) / 1e3
        log(f"[serve] {backend} where the time goes (the depth-1 run, "
            f"profiled): wall {gpu['wall_s']:.3f} s, {busy}; host in "
            f"dispatch spans {dispatch_s:.3f} s (the engine call: x and "
            f"vlens upload, enqueue), in retire spans {retire_s:.3f} s "
            f"(the .cpu() fetches); pool probe at {buckets[-1]} slots: "
            f"acquire {acq_ms:.4f} ms, release {rel_ms:.4f} ms per tenant, "
            f"x {n} tenants = {pool_s:.3f} s; the rest by subtraction "
            f"{gpu['wall_s'] - dispatch_s - retire_s - pool_s:.3f} s (feed "
            f"loop, per-member take and accounting loops, admission)")
        log(f"[serve] {backend}: GPU gateway equals the CPU gateway"
            + (" and the depth-4 pipeline" if len(runs) > 1 else "")
            + (" (flags outside the 1e-4 band)" if backend == "cuda"
               else " bit for bit"))
        log(f"[time] serve {backend}: CPU gateway {cpu['total_s']:.1f} s, "
            + ", ".join(f"{tag} {res['total_s']:.1f} s" for tag, res in runs)
            + f", synchronous {sync['total_s']:.1f} s (set-up included); "
            f"{time.perf_counter() - t_backend:.1f} s in all")
    return launches, singles

# the fleet phase: shards and per-shard buckets; tenants, history, live,
# chunk_t and arrivals per tick are phase 6's (SERVE_LOADS)
FLEET_LOADS = {
    "cuda-q": (4, (256, 1024, 2048)),
    "ensemble": (2, (256, 1024, 4096)),
    "cuda": (2, (256, 1024, 4096)),
}
REBALANCE_EVERY = 4


def _migrate_probe(backend, n=256):
    """Milliseconds per `ShardedPool.migrate` of one warm stream between
    two shards of 4,096 slots with no resize, and per one-slot state
    fetch alone (`_slot_words`, the device-to-host copy inside it)."""
    from repro_torch.engine import ShardedPool

    pool = ShardedPool(backend, shards=2, buckets=(4096,),
                       **_engine_opts(backend))
    rids = [f"p{i}" for i in range(2 * n)]
    for rid in rids:
        pool.acquire(rid, shard=0)
    x = torch.randn((32, 4096), device="cuda")
    eng = pool.pools[0].engine
    eng.process(_engine_input(backend, x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for slot in range(n):
        eng._slot_words(slot)
    t1 = time.perf_counter()
    for rid in rids[:n]:
        pool.migrate(rid, 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(pool.occupancies() == [n, n] and pool.migrations == n,
          f"migrate probe {backend}: {pool.occupancies()}")
    return (t2 - t1) * 1e3 / n, (t1 - t0) * 1e3 / n


def _engine_input(backend, x):
    """The engine's input for `backend`: Q int32 on the Q path."""
    if backend != "cuda-q":
        return x
    from repro_torch.fixedpoint import QFormat
    return QFormat(32, 20).quantize(x)


def phase_fleet(seed, smi, singles):
    """Phase 7: the sharded gateway on the card, `serve_streams(shards=K,
    rebalance_every=4)` per backend over phase 6's tenants, against
    phase 6's single-pool GPU run of the same streams ("cuda-q" and
    "ensemble" bit for bit, "cuda" ecc bit for bit and flags outside the
    band), with migrations > 0; then the engine's channel split.  Returns
    each kernel's launches during its backend's fleet run."""
    from repro_torch.launch.serve import _demo_streams

    launches = {}
    for backend, (shards, buckets) in FLEET_LOADS.items():
        n, hist, live, _, _, _ = SERVE_LOADS[backend]
        streams = _demo_streams(n, hist, live, seed=seed)
        m_of = {s[0]: s[3] for s in streams}
        single = singles[backend]
        res, used = _serve(backend, streams, "cuda", collect=True,
                           measure_latency=False, shards=shards,
                           rebalance_every=REBALANCE_EVERY, buckets=buckets)
        sched = res["_scheduler"]
        calls, ticks = int(sched._c_calls.value), res["ticks"]
        kname = KERNEL_OF[backend]
        check(used[kname] == calls and sum(used.values()) == calls
              and 0 < calls <= shards * ticks,
              f"fleet {backend}: {used} kernel launches for {calls} fused "
              f"calls in {ticks} ticks over {shards} shards")
        launches[kname] = used[kname]
        check(res["requests"] == n == sched.completed
              and res["shards"] == shards,
              f"fleet {backend}: {sched.completed}/{n} requests completed")
        check(res["migrations"] > 0, f"fleet {backend}: no migration")
        check(sum(p["migrations"] for p in res["per_request"].values())
              == res["migrations"],
              f"fleet {backend}: per-request migrations do not add up")
        _serve_same(f"fleet {backend} vs single pool", backend, single, res,
                    m_of)
        if backend == "cuda":
            for rid in m_of:
                check(np.array_equal(
                    single["_scheduler"].results(rid)["ecc"].view(np.int32),
                    sched.results(rid)["ecc"].view(np.int32)),
                    f"fleet cuda: {rid} ecc differs from the single pool")
        per_shard = [p["resizes"] for p in res["pool"]["per_shard"]]
        log(f"[fleet] {backend} over {shards} shards: {n} tenants x ({hist} "
            f"history + {live} live), per-shard buckets {buckets}, "
            f"rebalance every {REBALANCE_EVERY} ticks: {ticks} ticks, "
            f"{res['samples_per_s']:.6e} samples/s ({res['wall_s']:.3f} s; "
            f"single pool {single['samples_per_s']:.6e}, ratio "
            f"{res['samples_per_s'] / single['samples_per_s']:.3f}), "
            f"{used[kname]} {kname} launches = {used[kname] / ticks:.3f} per "
            f"tick, {res['migrations']} migrations, final imbalance "
            f"{res['imbalance']}, resizes per shard {per_shard}, "
            f"{len(res['flagged'])} tenants flagged on {smi}")
        log(f"[fleet] {backend}: the {shards}-shard gateway equals the "
            "single pool" + (" (ecc bit for bit, flags outside the 1e-4 "
                             "band)" if backend == "cuda" else " bit for bit"))
        del res, sched
        mig_ms, fetch_ms = _migrate_probe(backend)
        log(f"[fleet] {backend} migrate probe (2 shards x 4,096 slots): "
            f"{mig_ms:.4f} ms per migrate, of which the one-slot state "
            f"fetch alone {fetch_ms:.4f} ms")
    phase_split(seed, smi)
    return launches


def phase_split(seed, smi):
    """Phase 7(d): StreamEngine(65536, backend, devices=[cuda:0, cuda:0])
    (and [cuda:0, cuda:1] when a second card is present) for "cuda" and
    "cuda-q" over phase 5's 8 chunks against the unsplit engine: every
    output and the final state bit for bit, exactly two kernel launches
    per `process`, and the caller's current device unchanged."""
    from repro_torch.engine import StreamEngine
    from repro_torch.fixedpoint import QFormat
    from repro_torch.kernels import teda_q_scan as qk
    from repro_torch.kernels import teda_scan as fk

    dev = torch.device("cuda")
    c, t_len = C_WIDE, T_CHUNK
    chunks = _spiked_chunks(torch.Generator(device=dev).manual_seed(seed + 2),
                            c, t_len, N_CHUNKS)
    layouts = [["cuda:0", "cuda:0"]]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        layouts.append(["cuda:0", "cuda:1"])
    else:
        log("[split] one card: the split runs its two groups on cuda:0")
    for backend, mod in (("cuda", fk), ("cuda-q", qk)):
        opts = {"fmt": QFormat(32, 20)} if backend == "cuda-q" else {}
        feed = [_engine_input(backend, ch) for ch in chunks]
        for devs in layouts:
            one = StreamEngine(c, backend, **opts)
            two = StreamEngine(c, backend, devices=devs, **opts)
            before = torch.cuda.current_device()
            walls = {"single": 0.0, "split": 0.0}
            for i, ch in enumerate(feed):
                torch.cuda.synchronize()
                n0, t0 = mod.launches, time.perf_counter()
                a = one.process(ch)
                torch.cuda.synchronize()
                n1, t1 = mod.launches, time.perf_counter()
                b = two.process(ch)
                torch.cuda.synchronize()
                n2, t2 = mod.launches, time.perf_counter()
                walls["single"] += t1 - t0
                walls["split"] += t2 - t1
                check(n1 - n0 == 1 and n2 - n1 == 2,
                      f"split {backend} {devs}: {n2 - n1} launches for one "
                      f"split process call (2 wanted), {n1 - n0} unsplit")
                check(torch.cuda.current_device() == before,
                      f"split {backend} {devs}: the current device moved "
                      f"from {before} to {torch.cuda.current_device()}")
                check(b["ecc"].device == a["ecc"].device
                      and torch.equal(_words(a["ecc"]), _words(b["ecc"]))
                      and torch.equal(a["outlier"], b["outlier"]),
                      f"split {backend} {devs}: chunk {i} outputs differ")
            for f in ("k", "mean", "var", "active"):
                va, vb = getattr(one.state, f), getattr(two.state, f)
                same = (torch.equal(va, vb) if f == "active"
                        else torch.equal(_words(va), _words(vb)))
                check(same, f"split {backend} {devs}: final {f} differs")
            n_s = N_CHUNKS * t_len * c
            log(f"[split] {backend} devices={devs}: {N_CHUNKS} chunks of "
                f"({t_len}, {c}) bit-exact with the unsplit engine, final "
                f"state included; 2 launches per process; current device "
                f"{before} unchanged; synchronous wall per call "
                f"{walls['split'] * 1e3 / N_CHUNKS:.3f} ms split, "
                f"{walls['single'] * 1e3 / N_CHUNKS:.3f} ms unsplit "
                f"({n_s / walls['split']:.6e} / "
                f"{n_s / walls['single']:.6e} samples/s) on {smi}")
            del one, two
    if n_cards > 1:
        _fleet_over_cards(seed, smi, 4 if n_cards >= 4 else 2)


def _fleet_over_cards(seed, smi, n_cards):
    """With several cards: a 2-shard "cuda-q" gateway whose shards take
    n_cards / 2 cards each (`shard_devices`, each shard's engines split
    over their cards) against the single pool on cuda:0, over 2,048
    tenants, bit for bit, with the current device unchanged."""
    from repro_torch.launch.serve import _demo_streams

    streams = _demo_streams(2048, 480, 32, seed=seed)
    load = dict(collect=True, measure_latency=False, arrivals_per_tick=512,
                queue_limit=1024, buckets=(256, 1024, 2048))
    before = torch.cuda.current_device()
    single, _ = _serve("cuda-q", streams, "cuda", **load)
    cards = [f"cuda:{i}" for i in range(n_cards)]
    fleet, used = _serve("cuda-q", streams, None, shards=2,
                         rebalance_every=REBALANCE_EVERY,
                         shard_devices=cards, **load)
    _serve_same(f"fleet over {cards}", "cuda-q", single, fleet,
                {s[0]: s[3] for s in streams})
    check(torch.cuda.current_device() == before,
          f"fleet over {cards}: the current device moved")
    log(f"[split] cuda-q 2-shard gateway over {cards} ({n_cards // 2} cards "
        f"per shard): 2048 tenants bit for bit with the single pool on "
        f"cuda:0, {fleet['migrations']} migrations, {used['teda_q_scan']} "
        f"launches in {fleet['ticks']} ticks, {fleet['samples_per_s']:.6e} "
        f"samples/s (single {single['samples_per_s']:.6e}) on {smi}")


# ------------------------------------------------------------ training
# phase 8: (a) the card against the CPU at the reduced width, (b)
# llama3.2-1b at its full published width at `train.py`'s default batch
# and sequence, (c) crash and resume at `train.py`'s "small" scale
TRAIN_ARCH = "llama3.2-1b"
TRAIN_CMP = dict(batch=4, seq=64, steps=12, corrupt_every=5)
# a guard sharp enough to flag the corrupt batch at step 4 (f32 compute)
TRAIN_TRIP = dict(batch=4, seq=32, steps=6, corrupt_every=4)
TRAIN_FULL = dict(batch=8, seq=128, steps=24, corrupt_every=10)
TRAIN_RESUME = dict(batch=8, seq=128, steps=12, cut=6)
TRAIN_RTOL = 2e-2  # bf16 compute on two devices
PROFILED = 4  # steps in (b)'s profiled window, after one warmup step


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield value
    finally:
        setattr(module, name, old)


def _digest_stream(draws):
    """A TokenStream that logs (step, token digest) for every batch the
    training loop draws."""
    from repro_torch.data import TokenStream

    class Recording(TokenStream):
        def batch_at(self, step):
            batch = super().batch_at(step)
            digest = hashlib.sha1(batch["tokens"].tobytes()).hexdigest()
            draws.append((step, digest))
            return batch

    return Recording


def _state_words(model, opt):
    """A copy of every parameter and moment as raw bytes on the host,
    and the step count."""
    from repro_torch.tree import tree_leaves

    leaves = list(model.parameters()) + tree_leaves(opt.m) \
        + tree_leaves(opt.v)
    return [_bytes(t).clone() for t in leaves], int(opt.count)


def _guarded_steps(tree, cfg, dev, gcfg, opt_cfg, run):
    """`run["steps"]` guarded steps through `make_train_step` from the
    parameter tree `tree`, on `dev`, over `run`'s batches: (history,
    count, skipped, kept), where kept lists the skipped steps that left
    the parameters, m, v and the count bit for bit as they were."""
    from repro_torch.core import guard_init
    from repro_torch.data import TokenStream
    from repro_torch.launch.specs import make_train_step
    from repro_torch.models import lm_params_from_numpy
    from repro_torch.optim import adamw

    model = lm_params_from_numpy(tree, cfg, dev)
    opt = adamw.init(dict(model.named_parameters()))
    gs = guard_init(gcfg, dev)
    step_fn = make_train_step(cfg, opt_cfg, guard_cfg=gcfg)
    stream = TokenStream(cfg.vocab, run["batch"], run["seq"],
                         corrupt_every=run["corrupt_every"])
    hist, kept = [], []
    for step in range(run["steps"]):
        toks = torch.from_numpy(stream.batch_at(step)["tokens"]).to(dev)
        before = _state_words(model, opt)
        model, opt, gs, m = step_fn(model, opt, gs, {"tokens": toks})
        hist.append({k: float(v) for k, v in m.items()})
        after = _state_words(model, opt)
        if hist[-1]["skipped"] and before[1] == after[1] and all(
                torch.equal(a, b) for a, b in zip(before[0], after[0])):
            kept.append(step)
    return hist, int(opt.count), int(gs.skipped), kept


@contextlib.contextmanager
def _route_log():
    """Every MoE routing (`models/moe.py::_route`) made inside, in call
    order, as its `Route` of device tensors."""
    from repro_torch.models import moe as moe_mod

    log, real = [], moe_mod._route

    def route(xf, w, cfg):
        r = real(xf, w, cfg)
        log.append(r)
        return r

    with _patched(moe_mod, "_route", route):
        yield log


def _same_routes(a, b):
    return len(a) == len(b) and all(
        torch.equal(x.choice.cpu(), y.choice.cpu())
        and torch.equal(x.keep.cpu(), y.keep.cpu()) for x, y in zip(a, b))


def _card_vs_cpu(tag, tree, cfg, dev, gcfg, run, rtol=TRAIN_RTOL,
                 what="train"):
    """One guarded run on the card and on the CPU from the same tree:
    the skip verdicts, (count, skipped), the kept state and every MoE
    route (choice and keep) must agree, the losses within `rtol`.
    Returns (skipped steps, count, skipped, the largest relative loss
    difference, the MoE routings compared)."""
    from repro_torch.optim import adamw

    n = run["steps"]
    opt_cfg = adamw.AdamWConfig(warmup_steps=n // 4 + 1, total_steps=n)
    with _route_log() as gpu_routes:
        gpu = _guarded_steps(tree, cfg, dev, gcfg, opt_cfg, run)
    with _route_log() as cpu_routes:
        cpu = _guarded_steps(tree, cfg, torch.device("cpu"), gcfg, opt_cfg,
                             run)
    skips = [[i for i, h in enumerate(r[0]) if h["skipped"]]
             for r in (gpu, cpu)]
    check(skips[0] == skips[1], f"{what} {tag}: skipped steps differ, card "
          f"{skips[0]} vs CPU {skips[1]}")
    check(gpu[1:3] == cpu[1:3], f"{what} {tag}: (count, skipped) card "
          f"{gpu[1:3]} vs CPU {cpu[1:3]}")
    check(gpu[3] == skips[0] and cpu[3] == skips[1],
          f"{what} {tag}: skipped steps {skips[0]}, but only {gpu[3]} on "
          f"the card and {cpu[3]} on the CPU left the parameters, m, v "
          f"and the count as they were")
    check(_same_routes(gpu_routes, cpu_routes), f"{what} {tag}: the MoE "
          f"routes differ between the card and the CPU")
    rel = max(abs(g["loss"] - c["loss"]) / abs(c["loss"])
              for g, c in zip(gpu[0], cpu[0]))
    check(rel <= rtol, f"{what} {tag}: loss differs by {rel:.3e} "
          f"relative (> {rtol})")
    return skips[0], gpu[1], gpu[2], rel, len(gpu_routes)


def _train_card_vs_cpu(seed, smi, dev):
    """(a): the same tree and batches on the card and on the CPU, under
    the issue's guard (which stays quiet on these batches) and under a
    sharp one that flags the corrupt batch at step 4."""
    from repro_torch.configs import get_config
    from repro_torch.core import GuardConfig
    from repro_torch.models import init_lm_params, lm_params_to_numpy

    for tag, over, gcfg, run in (
            ("(a)", {}, GuardConfig(m=3.0, warmup_steps=4), TRAIN_CMP),
            ("(a trip)", dict(compute_dtype="float32"),
             GuardConfig(m=2.0, warmup_steps=2), TRAIN_TRIP)):
        cfg = get_config(TRAIN_ARCH).reduced(**over)
        tree = lm_params_to_numpy(init_lm_params(seed, cfg, device="cpu"))
        skips, count, skipped, rel, _ = _card_vs_cpu(tag, tree, cfg, dev,
                                                     gcfg, run)
        log(f"[train] {tag} {cfg.name} reduced ({cfg.compute_dtype}), "
            f"{run['steps']} steps, batch {run['batch']} x seq "
            f"{run['seq']}, corrupt every {run['corrupt_every']}, guard "
            f"m {gcfg.m} warmup {gcfg.warmup_steps}: card = CPU on every "
            f"skip verdict (skipped steps {skips}, each leaving the "
            f"parameters, m, v and the count bit for bit), (count, "
            f"skipped) ({count}, {skipped}), loss within {rel:.3e} "
            f"relative; on {smi}")
    check(skips == [TRAIN_TRIP["corrupt_every"]],
          f"train (a trip): skipped steps {skips}, not the corrupt step "
          f"[{TRAIN_TRIP['corrupt_every']}]")


def _device_rows(prof):
    """(device us, name, count) per name of the device's own events
    (kernels, copies, fills; not the host ops that launched them nor the
    step annotations), largest first.  Read from the profiler's raw
    events: the host-side event tree that `key_averages()` builds takes
    tens of seconds for the ~10^5 events of a serving run."""
    acc = {}
    for ev in prof.profiler.kineto_results.events():
        if not str(ev.device_type()).endswith("CUDA") \
                or ev.is_user_annotation() \
                or ev.name().startswith("ProfilerStep"):
            continue
        us, count = acc.get(ev.name(), (0.0, 0))
        acc[ev.name()] = (us + ev.duration_ns() / 1e3, count + 1)
    return sorted(((us, name, count) for name, (us, count) in acc.items()),
                  reverse=True)


def _train_full(smi, dev):
    """(b): llama3.2-1b at its full width, 24 guarded steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import GuardConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.models import param_count, vocab_padded

    cfg = get_config(TRAIN_ARCH)
    b, s, n = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    every = TRAIN_FULL["corrupt_every"]
    gcfg = GuardConfig(m=3.0, warmup_steps=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, hist, summary = train_mod.train(
        cfg, n, b, s, None, device=dev, log_every=4, guard_cfg=gcfg,
        corrupt_every=every)
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    timed(_profile_window, model, cfg, b, s, dev, gcfg, smi)
    _masked_update(model, cfg, b, s, dev, smi)
    del model
    torch.cuda.empty_cache()

    check(len(hist) == n, f"train (b): {len(hist)} steps, not {n}")
    corrupt, skipped = _report_training(
        "[train] (b)", cfg, b, s, hist, summary, gcfg, every, t_train,
        peak, n_params, smi)
    clean = [h["loss"] for i, h in enumerate(hist)
             if i not in corrupt and i not in skipped]
    check(np.mean(clean[-3:]) < np.mean(clean[:3]),
          f"train (b): loss did not fall: first 3 clean {clean[:3]}, "
          f"last 3 {clean[-3:]}")
    # param_count leaves out the final norm and the vocabulary padding
    expect = param_count(cfg) + cfg.d_model \
        + (vocab_padded(cfg) - cfg.vocab) * cfg.d_model
    check(n_params == expect, f"train (b): {n_params} parameters, not "
          f"{expect}")
    med = float(np.median(summary["step_s"][2:])) * 1e3
    return {"ms": med, "tokens_s": b * s / med * 1e3, "peak": peak,
            "losses": [h["loss"] for h in hist]}


def _report_training(label, cfg, b, s, hist, summary, gcfg, every,
                     t_train, peak, n_params, smi):
    """Print a `train()` run (ms per step from its straggler detector,
    tokens/s, peak memory, losses, grad norms, the guard at each corrupt
    step) and check it: finite losses, finite grad norms on every step
    the guard kept, the guard's skip count, and the card's skip verdicts
    equal to the guard replayed on the CPU over the same telemetry.
    Returns (corrupt, skipped)."""
    n = len(hist)
    corrupt = [i for i in range(1, n) if every and i % every == 0]
    skipped = [i for i, h in enumerate(hist) if h["skipped"]]
    replay = _guard_replay(hist, gcfg)
    # each step as train()'s straggler detector timed it: from the
    # batch's upload to the host readback of the step's metrics
    step_ms = [t * 1e3 for t in summary["step_s"]]
    steady = step_ms[2:]
    med = float(np.median(steady))
    log(f"{label} {cfg.name} ({cfg.n_layers} layers x {cfg.d_model}, "
        f"vocab {cfg.vocab}, {n_params} parameters), batch {b} x seq {s}, "
        f"{n} guarded steps in {t_train:.2f} s (set-up included): "
        f"{med:.3f} ms per step (median of {len(steady)} steps), "
        f"{b * s / med * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} B); on {smi}")
    for name, vals, fmt in (("ms per step", step_ms, "{:.1f}"),
                            ("losses", [h["loss"] for h in hist], "{!r}"),
                            ("grad norms", [h["grad_norm"] for h in hist],
                             "{!r}")):
        log(f"{label} {name}: {' '.join(map(fmt.format, vals))}")
    log(f"{label} corrupt steps {corrupt}, skipped steps {skipped}, "
        f"straggler trips {summary['straggler_trips']}")
    for i in corrupt:
        _, zeta, thr = replay[i]
        log(f"{label} guard at corrupt step {i}: zeta (loss, grad norm) = "
            f"({zeta[0]:.4f}, {zeta[1]:.4f}) against the threshold "
            f"{thr[0]:.4f}")
    # a non-finite grad norm is the guard's to skip (it always flags
    # one), and a skipped step leaves the weights as they were
    bad = [i for i, h in enumerate(hist) if not np.isfinite(h["loss"]) or (
        not np.isfinite(h["grad_norm"]) and i not in skipped)]
    check(not bad, f"{label}: non-finite loss, or a non-finite grad norm "
          f"on a step the guard kept, at {bad}")
    check(summary["skipped"] == len(skipped),
          f"{label}: guard counted {summary['skipped']} skips, the "
          f"history {len(skipped)}")
    check([r[0] for r in replay] == [h["skipped"] == 1.0 for h in hist],
          f"{label}: the card's skips {skipped} differ from the CPU "
          f"guard's on the same telemetry "
          f"{[i for i, r in enumerate(replay) if r[0]]}")
    return corrupt, skipped


def _masked_update(model, cfg, b, s, dev, smi):
    """The guard's masked update at full width: one batch's gradient,
    then `adamw.update` with skip True (every parameter, moment and the
    count stay bit for bit as they were) and with skip False (they
    move).  Host-clock times of the forward + backward and
    of each update, each closed by a synchronize."""
    from repro_torch.data import TokenStream
    from repro_torch.models import lm_loss
    from repro_torch.optim import adamw

    params = dict(model.named_parameters())
    toks = TokenStream(cfg.vocab, b, s).batch_at(0)["tokens"]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init(params)
    t = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.zero_grad(set_to_none=True)
    loss, _ = lm_loss(model, batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    t["forward + backward"] = time.perf_counter() - t0
    grads = {n: p.grad for n, p in params.items()}
    before = [p.detach().clone() for p in params.values()]
    for skip in (True, False):
        t0 = time.perf_counter()
        _, state, _ = adamw.update(grads, state, params, opt_cfg,
                                   skip=torch.tensor(skip, device=dev))
        torch.cuda.synchronize()
        t[f"update skip={skip}"] = time.perf_counter() - t0
        same = [torch.equal(a.view(torch.int32), p.view(torch.int32))
                for a, p in zip(before, params.values())]
        moved = sum(int(torch.count_nonzero(m)) > 0 for m in state.m.values())
        if skip:
            check(all(same) and moved == 0 and int(state.count) == 0,
                  "train (b): a skipped update changed the parameters, "
                  "the moments or the count")
        else:
            check(not all(same) and moved > 0 and int(state.count) == 1,
                  "train (b): an update with skip False changed nothing")
    model.zero_grad(set_to_none=True)
    log(f"[train] (b) masked update at full width: skip True left "
        f"all {len(before)} parameter leaves, m, v and count bit for bit, "
        f"skip False moved them; host clock, synchronized: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in t.items())
        + f"; on {smi}")


def _guard_replay(hist, gcfg):
    """The guard once more, on the CPU, over the telemetry the card's
    guard saw (each step's loss and grad norm, float32 as read back):
    (skip, zeta per channel, threshold per channel) per step."""
    from repro_torch.core import guard_init, guard_step

    gs = guard_init(gcfg, device="cpu")
    out = []
    for h in hist:
        gs, v = guard_step(gs, torch.tensor([h["loss"], h["grad_norm"]],
                                            dtype=torch.float32), gcfg)
        out.append((bool(v.skip), v.per_channel.zeta.tolist(),
                    v.per_channel.threshold.tolist()))
    return out


def _profile_window(model, cfg, b, s, dev, gcfg, smi, n_steps=PROFILED,
                    label="[train] (b)"):
    """(b)'s profiled window: `n_steps` steps of the trained model
    through the step function `train()` runs, each closed as there by
    the host readback of its metrics, after one warmup step that the
    profiler traces and drops.  Prints the device busy share of the
    window and the top device ops.  Fresh optimizer and guard state
    (train() keeps its own): the guard is warming up and every step
    updates."""
    from repro_torch.core import guard_init
    from repro_torch.data import TokenStream
    from repro_torch.launch.specs import make_train_step
    from repro_torch.optim import adamw

    n = TRAIN_FULL["steps"]
    step_fn = make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=n // 4 + 1, total_steps=n), guard_cfg=gcfg)
    opt = adamw.init(dict(model.named_parameters()))
    gs = guard_init(gcfg, dev)
    stream = TokenStream(cfg.vocab, b, s)
    traced = []
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=n_steps,
                                    repeat=1)
    with torch.profiler.profile(
            activities=acts, schedule=sched,
            on_trace_ready=lambda p: traced.append(_device_rows(p))) \
            as prof:
        for step in range(1 + n_steps):
            if step == 1:
                t0 = time.perf_counter()
            toks = torch.from_numpy(stream.batch_at(step)["tokens"])
            model, opt, gs, m = step_fn(model, opt, gs,
                                        {"tokens": toks.to(dev)})
            torch.stack([v.float() for v in m.values()]).cpu()
            if step == n_steps:  # before the trace is handed over
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    del opt, gs
    check(len(traced) == 1, f"{label}: the profiler recorded "
          f"{len(traced)} windows, not 1")
    rows = traced[0]
    if not rows:
        log(f"{label} profile: the profiler saw no device time "
            "(not measured)")
        return
    busy = sum(r[0] for r in rows)
    log(f"{label} profile: {n_steps} steps in {wall_us / 1e3:.1f} ms "
        f"(profiled, {wall_us / 1e3 / n_steps:.1f} ms per step), device "
        f"busy {busy / 1e3:.1f} ms = {100.0 * busy / wall_us:.1f}% of the "
        f"window; on {smi}")
    for dev_us, key, count in rows[:12]:
        log(f"{label}   {dev_us / 1e3:9.2f} ms  x{count:<5d} {key[:90]}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _bytes(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()


def _train_resume(smi, dev):
    """(c): 12 steps straight against 6 steps, a save, and a resume to
    12, at `train.py`'s "small" scale."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    cfg = train_mod.scaled_config(TRAIN_ARCH, "small")
    b, s, n, cut = (TRAIN_RESUME[k] for k in ("batch", "seq", "steps",
                                              "cut"))
    opt = adamw.AdamWConfig(warmup_steps=n // 4 + 1, total_steps=n)
    saved, restored, times = {}, [], {}

    class Spy(CheckpointManager):
        def save(self, step, state, extra=None):
            saved[step] = [t.detach().clone() for t in tree_leaves(state)]
            t0 = time.perf_counter()
            super().save(step, state, extra)
            t1 = time.perf_counter()
            self.wait()
            times["save"] = (t1 - t0, time.perf_counter() - t0)

        def restore(self, template, step=None, device=None):
            t0 = time.perf_counter()
            tree, meta = super().restore(template, step, device)
            _sync(dev)
            times["restore"] = time.perf_counter() - t0
            # cloned: training goes on to update the restored moments
            restored.append((meta["step"], [t.clone() for t in
                                            tree_leaves(tree)]))
            return tree, meta

    ckpt = ROOT / "build" / "train_resume_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, steps, where, resume in (
                ("straight", n, None, False), ("cut", cut, ckpt, False),
                ("resumed", n, ckpt, True)):
            draws = []
            with _patched(train_mod, "TokenStream",
                          _digest_stream(draws)), \
                    _patched(train_mod, "CheckpointManager", Spy):
                _, hist, _ = train_mod.train(
                    cfg, steps, b, s, where and str(where), resume=resume,
                    device=dev, opt_cfg=opt, log_every=100)
            runs[name] = (hist, draws)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)

    check(len(restored) == 1 and restored[0][0] == cut,
          f"train (c): restores {[r[0] for r in restored]}, not [{cut}]")
    leaves = restored[0][1]
    check(len(leaves) == len(saved[cut]), "train (c): leaf count differs")
    for i, (a, r) in enumerate(zip(saved[cut], leaves)):
        check(a.dtype == r.dtype and a.shape == r.shape
              and r.device.type == dev.type
              and torch.equal(_bytes(a), _bytes(r)),
              f"train (c): restored leaf {i} differs from the saved one")
    straight, cut_run, resumed = (runs[k] for k in ("straight", "cut",
                                                    "resumed"))
    check([d[0] for d in resumed[1]] == list(range(cut, n)),
          f"train (c): the resumed run drew steps "
          f"{[d[0] for d in resumed[1]]}")
    check([d[1] for d in cut_run[1] + resumed[1]]
          == [d[1] for d in straight[1]],
          "train (c): the cut and resumed runs drew other batches than "
          "the straight run")
    a_loss = [h["loss"] for h in resumed[0]]
    b_loss = [h["loss"] for h in straight[0][cut:]]
    check(a_loss == b_loss, f"train (c): resumed losses {a_loss} are not "
          f"bit-equal to the straight run's {b_loss}")
    check(all(x == y for x, y in zip(cut_run[0], straight[0][:cut])),
          "train (c): the first 6 steps differ from the straight run")
    n_bytes = sum(t.numel() * t.element_size() for t in saved[cut])
    log(f"[train] (c) {cfg.name} small ({cfg.n_layers} x {cfg.d_model}, "
        f"vocab {cfg.vocab}), batch {b} x seq {s}: {cut} steps, save, "
        f"resume to {n}: {len(leaves)} restored leaves bit-equal to the "
        f"saved ones, the same {n} token batches, losses of steps "
        f"{cut}-{n - 1} bit-equal to the straight run's (deterministic "
        f"algorithms on); save {n_bytes / 2**20:.1f} MiB: snapshot "
        f"{times['save'][0]:.3f} s, written {times['save'][1]:.3f} s; "
        f"restore {times['restore']:.3f} s; on {smi}")


def phase_train(seed, smi):
    """Phase 8: the TEDA-guarded training loop.  The guard runs the
    plain single-sample TEDA step, so no TEDA kernel may launch here.
    Returns (b)'s ms per step, tokens/s, peak memory and losses (phase
    12 (a) runs the same training on a mesh beside them)."""
    from repro_torch.kernels import ensemble_scan as ek
    from repro_torch.kernels import teda_q_scan as qk
    from repro_torch.kernels import teda_scan as fk

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    mods = (fk, qk, ek)
    for mod in mods:
        mod.launches = 0
    timed(_train_card_vs_cpu, seed, smi, dev)
    full = timed(_train_full, smi, dev)
    timed(_train_resume, smi, dev)
    counts = [mod.launches for mod in mods]
    check(counts == [0, 0, 0], f"train: TEDA kernels launched {counts} "
          "times on the training path")
    log(f"[train] no TEDA kernel launched on the training path; phase 8 "
        f"took {time.perf_counter() - t0:.1f} s")
    return full


# ---------------------------------------------------------- LM serving
# phase 9: (a) the card against the CPU at the reduced width, (b)
# llama3.2-1b at its full published width through `serve()`, (c) decode
# against forward at full width in float32 compute
LM_ARCH = "llama3.2-1b"
# (arch, overrides, batch, prompt_len, gen): gemma2's 80 positions pass
# its window
LM_CMP = (("llama3.2-1b", {}, 4, 16, 16), ("gemma2-2b", {}, 2, 48, 32))
LM_FULL = dict(batch=8, prompt_len=64, gen=32)
LM_PROFILED = 8  # decode steps in (b)'s profiled window, after 2 dropped
LM_CHECK = dict(batch=2, seq=32)  # (c)
LM_TEL_RTOL, LM_TEL_ATOL = 1e-4, 1e-5


def _kernel_mods():
    from repro_torch.kernels import ensemble_scan as ek
    from repro_torch.kernels import teda_q_scan as qk
    from repro_torch.kernels import teda_scan as fk

    return {"teda_scan": fk, "teda_q_scan": qk, "ensemble_scan": ek}


def _lm_fmt(backend):
    from repro_torch.fixedpoint import QFormat

    return QFormat(32, 20) if backend == "cuda-q" else None


def _lm_replay(res, backend):
    """The CPU monitor over the telemetry rows a card run fed its own:
    the scheduler, after the drain."""
    from repro_torch.launch.serve import (close_monitor, monitor_tick,
                                          open_monitor)

    hist, rows = res["telemetry"]
    sched = open_monitor(hist, backend=backend, m=3.5, chunk_t=16,
                         fmt=_lm_fmt(backend), device="cpu")
    for tel in rows:
        monitor_tick(sched, tel)
    close_monitor(sched, hist.shape[1], rows.shape[0])
    return sched


def _lm_monitor_same(tag, backend, card, replay, batch):
    """The card's monitor against the CPU replay of its rows: "cuda-q"
    ecc and flags bit for bit; "cuda" ecc within rtol 5e-4 / atol 1e-5,
    flags equal outside the 1e-4 band.  Returns the flags counted."""
    sc = card["_scheduler"]
    n_flags = 0
    for b in range(batch):
        for c in range(2):
            rid = f"req{b}/ch{c}"
            ra, rb = sc.results(rid), replay.results(rid)
            n_flags += int(ra["outlier"].sum())
            if backend == "cuda-q":
                check(np.array_equal(ra["ecc"].view(np.int32),
                                     rb["ecc"].view(np.int32))
                      and np.array_equal(ra["outlier"], rb["outlier"]),
                      f"lm {tag}: {rid} card and CPU Q monitors differ")
                continue
            ecc = torch.from_numpy(rb["ecc"]).double()
            _close(f"lm {tag} {rid} ecc", torch.from_numpy(ra["ecc"]), ecc)
            k = torch.arange(1, ecc.shape[0] + 1, dtype=torch.float64)
            _, bad = _band_mismatch(ecc, 3.5, k,
                                    torch.from_numpy(ra["outlier"]),
                                    torch.from_numpy(rb["outlier"]))
            check(bad == 0, f"lm {tag}: {rid} {bad} flags differ outside "
                  "the threshold band")
    check(sc.tick_no == replay.tick_no, f"lm {tag}: {sc.tick_no} ticks on "
          f"the card, {replay.tick_no} in the replay")
    return n_flags


def _lm_card_vs_cpu(seed, smi, dev, cases=LM_CMP, label="lm"):
    """(a): one parameter tree and prompt set through `serve_prompts` on
    the card ("cuda-q" and "cuda") and on the CPU ("cuda-q", plain),
    float32 compute, for each (arch, overrides, batch, prompt_len, gen)
    of `cases`."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import (init_lm_params, lm_params_from_numpy,
                                    lm_params_to_numpy)

    for arch, over, b, p, gen in cases:
        cfg = get_config(arch).reduced(compute_dtype="float32", **over)
        tree = lm_params_to_numpy(init_lm_params(seed, cfg, device="cpu"))
        prompts = torch.randint(0, cfg.vocab, (b, p), generator=torch.
                                Generator().manual_seed(seed))
        runs = {}
        for where, backend in (("cpu", "cuda-q"), ("card", "cuda-q"),
                               ("card", "cuda")):
            d = torch.device("cpu") if where == "cpu" else dev
            model = lm_params_from_numpy(tree, cfg, d)
            runs[where, backend] = serve_prompts(
                model, prompts, cfg, gen, backend=backend,
                fmt=_lm_fmt(backend))
        cpu, card = runs["cpu", "cuda-q"], runs["card", "cuda-q"]
        tag = f"(a) {arch}"
        for r in runs.values():
            check(np.array_equal(r["tokens"], cpu["tokens"]),
                  f"{label} {tag}: card tokens differ from the CPU's")
        tel_err = 0.0
        for r in (card, runs["card", "cuda"]):
            for a, c in zip(r["telemetry"], cpu["telemetry"]):
                a, c = torch.from_numpy(a).double(), torch.from_numpy(c)
                err = (a - c.double()).abs()
                check(bool((err <= LM_TEL_ATOL + LM_TEL_RTOL
                            * c.double().abs()).all()),
                      f"{label} {tag}: telemetry differs beyond rtol "
                      f"{LM_TEL_RTOL} (max abs err {float(err.max())})")
                tel_err = max(tel_err, float(err.max()))
        flags = {}
        for backend in ("cuda-q", "cuda"):
            flags[backend] = _lm_monitor_same(
                tag, backend, runs["card", backend],
                _lm_replay(runs["card", backend], backend), b)
        check(card["flagged_requests"] == cpu["flagged_requests"],
              f"{label} {tag}: flagged requests {card['flagged_requests']} on "
              f"the card, {cpu['flagged_requests']} on the CPU")
        log(f"[{label}] {tag} reduced (f32), batch {b}, prompt {p}, gen {gen} "
            f"(max_seq {p + gen}, window {cfg.window}): tokens equal on "
            f"the card ('cuda-q', 'cuda') and the CPU, telemetry within "
            f"{tel_err:.3e} abs; the card's 'cuda-q' monitor = the CPU's "
            f"replaying its rows bit for bit ({flags['cuda-q']} flags), "
            f"'cuda' flags equal outside the band ({flags['cuda']} "
            f"flags); flagged requests {card['flagged_requests']}; on "
            f"{smi}")


def _serve_both(label, cfg, b, p, gen, run, smi, backends=("cuda",
                                                            "cuda-q")):
    """`run(backend)` (a `serve` or `serve_prompts` result) once per TEDA
    backend, with the kernels' launch counts set to 0 before the runs
    and read after each: exactly `gen` launches of the backend's own
    kernel in `gen` + 1 ticks, none of the others, tokens in range and
    equal across the runs, finite telemetry.  Returns (the launches per
    kernel over the runs, the runs)."""
    mods = _kernel_mods()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    runs, counts = {}, {}
    for backend in backends:
        before = {n: mod.launches for n, mod in mods.items()}
        t0 = time.perf_counter()
        runs[backend] = res = run(backend)
        wall = time.perf_counter() - t0
        counts[backend] = {n: mod.launches - before[n]
                           for n, mod in mods.items()}
        sched = res["_scheduler"]
        ticks, calls = sched.tick_no, int(sched._c_calls.value)
        own = counts[backend][KERNEL_OF[backend]]
        others = {n: c for n, c in counts[backend].items()
                  if n != KERNEL_OF[backend]}
        check(own == calls == gen and ticks == gen + 1,
              f"{label} {backend}: {own} launches, {calls} fused calls in "
              f"{ticks} ticks for {gen} decode ticks")
        check(not any(others.values()), f"{label} {backend}: other "
              f"kernels launched {others}")
        check(res["tokens"].shape == (b, gen)
              and ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all(),
              f"{label} {backend}: tokens out of range")
        tel = np.concatenate([t.reshape(-1, b, 2)
                              for t in res["telemetry"]])
        check(np.isfinite(tel).all(), f"{label} {backend}: non-finite "
              "telemetry")
        ms_step = b * 1e3 / res["decode_tok_s"]
        log(f"{label} {cfg.name} ({cfg.n_layers} layers x {cfg.d_model}, "
            f"vocab {cfg.vocab}), batch {b}, prompt {p}, gen {gen}, "
            f"backend {backend!r}: prefill (teacher-forced decode) "
            f"{res['prefill_tok_s']:.1f} tok/s, decode "
            f"{res['decode_tok_s']:.1f} tok/s = {ms_step:.3f} ms per "
            f"decode step of {b} tokens ({ms_step / b:.3f} ms per token); "
            f"monitor: {own} {KERNEL_OF[backend]} launches in {gen} "
            f"decode ticks = {own / gen:.3f} per tick (+1 drain tick "
            f"that only retires, {ticks} ticks), flagged requests "
            f"{res['flagged_requests']}; wall {wall:.2f} s; on {smi}")
    peak = torch.cuda.max_memory_allocated()
    first = runs[backends[0]]["tokens"]
    check(all(np.array_equal(r["tokens"], first) for r in runs.values()),
          f"{label}: the runs decoded different tokens")
    log(f"{label} peak memory {peak / 2**30:.3f} GiB ({peak} B) over the "
        f"serving runs; sample continuation (req 0): "
        f"{first[0][:12].tolist()}; on {smi}")
    return {n: sum(c[n] for c in counts.values()) for n in mods}, runs


def _lm_full(seed, smi, dev):
    """(b): `serve()` at llama3.2-1b's full width, once per TEDA
    backend (weights drawn on the CPU in each run)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(LM_ARCH)
    b, p, gen = (LM_FULL[k] for k in ("batch", "prompt_len", "gen"))
    torch.cuda.empty_cache()
    launches, _ = _serve_both(
        "[lm] (b)", cfg, b, p, gen,
        lambda backend: serve(cfg, b, p, gen, seed=seed, backend=backend,
                              fmt=_lm_fmt(backend), device=dev), smi)
    return launches


def _prefill_rate(label, model, cfg, prompts, smi, reps=5):
    """`lm_prefill`'s own tokens/s at the prompt batch's shape."""
    from repro_torch.models import lm_prefill

    b, p = prompts.shape
    lm_prefill(model, prompts, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        logits = lm_prefill(model, prompts, cfg)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) / reps
    check(logits.shape == (b, cfg.vocab)
          and bool(torch.isfinite(logits).all()), f"{label}: lm_prefill "
          "logits not finite or of the wrong shape")
    log(f"{label} lm_prefill (the full backbone over the prompt, "
        f"{cfg.compute_dtype} compute, read-out on the last position) "
        f"batch {b} x {p}: {t_pre * 1e3:.3f} ms per call (mean of {reps}, "
        f"synchronized), {b * p / t_pre:.1f} tok/s; on {smi}")


def _decode_profile(label, model, cfg, prompts, smi):
    """A profiled window of `LM_PROFILED` decode steps run as
    `serve_prompts` runs them (step, one (B, 2) fetch, one "cuda"
    monitor tick), after 2 steps the profiler traces and drops."""
    from repro_torch.launch.serve import (close_monitor, make_decode_step,
                                          monitor_tick, open_monitor)
    from repro_torch.models import init_cache

    b, p = prompts.shape
    dev = prompts.device
    step = make_decode_step(cfg, greedy=True)
    caches = init_cache(cfg, b, p + LM_PROFILED + 2, dtype=torch.float32,
                        device=dev)
    sched = open_monitor(np.zeros((0, b, 2), np.float32), backend="cuda",
                         m=3.5, chunk_t=16, device=dev)
    traced = []
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sch = torch.profiler.schedule(wait=0, warmup=2, active=LM_PROFILED,
                                  repeat=1)
    tok = prompts[:, 0]
    with torch.inference_mode(), torch.profiler.profile(
            activities=acts, schedule=sch,
            on_trace_ready=lambda pr: traced.append(_device_rows(pr))) \
            as prof:
        for i in range(2 + LM_PROFILED):
            if i == 2:
                t0 = time.perf_counter()
            tok, caches, ent, mx = step(model, tok, i, caches, None)
            monitor_tick(sched, torch.stack([ent, mx], -1).cpu().numpy())
            if i == 1 + LM_PROFILED:
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    close_monitor(sched, b, 2 + LM_PROFILED)
    check(len(traced) == 1, f"{label}: the profiler recorded "
          f"{len(traced)} windows, not 1")
    rows = traced[0]
    if not rows:
        log(f"{label} profile: the profiler saw no device time "
            "(not measured)")
        return
    busy = sum(r[0] for r in rows)
    log(f"{label} profile: {LM_PROFILED} decode steps (with their fetch "
        f"and 'cuda' monitor tick) in {wall_us / 1e3:.1f} ms (profiled, "
        f"{wall_us / 1e3 / LM_PROFILED:.2f} ms per step), device busy "
        f"{busy / 1e3:.2f} ms = {100.0 * busy / wall_us:.1f}% of the "
        f"window; on {smi}")
    for dev_us, key, count in rows[:12]:
        log(f"{label}   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def _close_logits(label, dec, full, smi, what):
    """Decode logits against the forward's: rtol 1e-3 / atol 1e-3,
    argmax equal at every position."""
    err = (dec.double() - full.double()).abs()
    ok = err <= 1e-3 + 1e-3 * full.double().abs()
    same = bool(torch.equal(dec.argmax(-1), full.argmax(-1)))
    log(f"{label} {what}: largest difference {float(err.max()):.3e} "
        f"(rtol 1e-3 / atol 1e-3: {'held' if bool(ok.all()) else 'FAILED'}"
        f"), argmax {'equal' if same else 'DIFFERENT'} at every position; "
        f"on {smi}")
    check(bool(ok.all()), f"{label}: decode and forward logits differ "
          "beyond rtol 1e-3 / atol 1e-3")
    check(same, f"{label}: decode and forward argmax differ")


def _decode_vs_forward(label, model, cfg, toks, smi):
    """Decoding the tokens step by step against `lm_forward` on them."""
    from repro_torch.models import init_cache, lm_decode_step, lm_forward

    cb, cs = toks.shape
    with torch.inference_mode():
        full, _ = lm_forward(model, toks, cfg)
        caches = init_cache(cfg, cb, cs, dtype=torch.float32,
                            device=toks.device)
        outs = []
        for t in range(cs):
            lg, caches = lm_decode_step(model, toks[:, t], t, caches, cfg)
            outs.append(lg)
    _close_logits(label, torch.stack(outs, dim=1), full, smi,
                  f"{cfg.name} full width, {cfg.compute_dtype} compute, "
                  f"batch {cb} x {cs}: decode step by step against "
                  f"lm_forward")


def _lm_profile_and_prefill(seed, smi, dev):
    """(b)'s device view: `lm_prefill`'s tokens/s and a profiled decode
    window at (b)'s shapes; then (c): decode against forward at full
    width in float32 compute."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params

    cfg = get_config(LM_ARCH)
    b, p = LM_FULL["batch"], LM_FULL["prompt_len"]
    model = init_lm_params(seed, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=torch.
                            Generator().manual_seed(seed)).to(dev)
    timed(_prefill_rate, "[lm] (b)", model, cfg, prompts, smi)
    timed(_decode_profile, "[lm] (b)", model, cfg, prompts, smi)
    # (c) float32 compute: the same weights read with another cfg
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    timed(_decode_vs_forward, "[lm] (c)", model, cfg32,
          prompts[:LM_CHECK["batch"], :LM_CHECK["seq"]], smi)


def phase_lm(seed, smi):
    """Phase 9: LM serving with the TEDA monitor.  Returns the kernels'
    launches over (b)'s two `serve()` runs."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    timed(_lm_card_vs_cpu, seed, smi, dev)
    launches = timed(_lm_full, seed, smi, dev)
    timed(_lm_profile_and_prefill, seed, smi, dev)
    torch.cuda.empty_cache()
    log(f"[lm] phase 9 took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------ families
# phase 10: (a) the card against the CPU at the reduced widths, (b)
# zamba2-2.7b at its published width and depth, (c) mixtral-8x7b at its
# published width with its depth cut, (d) decode against forward at full
# width in float32 compute
FAM_CMP = (("mixtral-8x7b", {}), ("dbrx-132b", dict(n_experts=8, top_k=4)),
           ("zamba2-2.7b", {}), ("xlstm-350m", {}))
FAM_TRAIN_CMP = dict(batch=2, seq=64, steps=6, corrupt_every=4)
FAM_GUARD = dict(m=2.0, warmup_steps=2)
FAM_SERVE_CMP = dict(batch=2, prompt_len=16, gen=16)
FAM_RTOL = 1e-3  # f32 compute on two devices
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_CMP = dict(batch=2, src=32, tgt=32, steps=8)
ZAMBA_ARCH = "zamba2-2.7b"
# the reference's `init_lm_params` tree of the published config, counted
ZAMBA_PARAMS = 2_353_576_608
# 8 x 256: each sequence is two 128-row SSD chunks, so the carry runs
ZAMBA_TRAIN = dict(batch=8, seq=256, steps=12, corrupt_every=10)
ZAMBA_PROFILED = 2
ZAMBA_SERVE = dict(batch=8, prompt_len=32, gen=16)
MIXTRAL_ARCH = "mixtral-8x7b"
# 32 layers hold 46.7e9 parameters (~187 GB in f32): one card holds 2
# with their gradients and AdamW moments (~48.5 GB)
MIXTRAL_LAYERS = 2
MIXTRAL_TRAIN = dict(batch=8, seq=128, steps=8)
MIXTRAL_SERVE = dict(batch=8, prompt_len=128, gen=32)
FAM_CHECK = dict(batch=2, seq=32)  # (d)


def _fam_card_vs_cpu(seed, smi, dev):
    """(a): guarded steps and `serve_prompts` on the card and on the CPU
    from one tree per family (f32 compute), and the encoder-decoder's
    loss and decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import GuardConfig
    from repro_torch.models import init_lm_params, lm_params_to_numpy

    gcfg = GuardConfig(**FAM_GUARD)
    run = FAM_TRAIN_CMP
    for arch, over in FAM_CMP:
        cfg = get_config(arch).reduced(compute_dtype="float32", **over)
        tree = lm_params_to_numpy(init_lm_params(seed, cfg, device="cpu"))
        skips, count, skipped, rel, n_routes = _card_vs_cpu(
            f"(a) {arch}", tree, cfg, dev, gcfg, run, rtol=FAM_RTOL,
            what="families")
        if cfg.family == "moe":
            check(n_routes == run["steps"] * cfg.n_layers,
                  f"families (a) {arch}: {n_routes} routings, not "
                  f"{run['steps'] * cfg.n_layers}")
        log(f"[families] (a) {arch} reduced (f32), {run['steps']} guarded "
            f"steps, batch {run['batch']} x seq {run['seq']}, corrupt "
            f"every {run['corrupt_every']}, guard m {gcfg.m} warmup "
            f"{gcfg.warmup_steps}: card = CPU on every skip verdict "
            f"(skipped steps {skips}), (count, skipped) ({count}, "
            f"{skipped}), {n_routes} MoE routings equal (choice and keep), "
            f"loss within {rel:.3e} relative; on {smi}")
    b, p, gen = (FAM_SERVE_CMP[k] for k in ("batch", "prompt_len", "gen"))
    _lm_card_vs_cpu(seed, smi, dev, label="families",
                    cases=tuple((arch, over, b, p, gen)
                                for arch, over in FAM_CMP))
    _encdec_card_vs_cpu(seed, smi, dev)


def _encdec_card_vs_cpu(seed, smi, dev):
    """(a) seamless: `encdec_loss` and greedy `encdec_decode_step`s from
    one tree and batch on the card and on the CPU, f32 compute."""
    from repro_torch.configs import get_config
    from repro_torch.models import (build_cross_cache, encdec_decode_step,
                                    encdec_loss, encdec_params_from_numpy,
                                    encdec_params_to_numpy, encode,
                                    init_encdec_cache, init_encdec_params)

    cfg = get_config(ENCDEC_ARCH).reduced(compute_dtype="float32")
    tree = encdec_params_to_numpy(init_encdec_params(seed, cfg,
                                                     device="cpu"))
    b, ss, st, n = (ENCDEC_CMP[k] for k in ("batch", "src", "tgt", "steps"))
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, ss, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(b, st + 1))
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = encdec_params_from_numpy(tree, cfg, d)
        batch = {"src_emb": torch.from_numpy(src).to(d),
                 "tokens": torch.from_numpy(toks).to(d)}
        with torch.inference_mode():
            loss, _ = encdec_loss(model, batch, cfg)
            caches = init_encdec_cache(cfg, b, n, ss, dtype=torch.float32,
                                       device=d)
            caches["cross"] = build_cross_cache(
                model, encode(model, batch["src_emb"], cfg), cfg,
                dtype=torch.float32)
            tok, logits = batch["tokens"][:, 0], []
            for i in range(n):
                lg, caches = encdec_decode_step(model, tok, i, caches, cfg)
                tok = lg.argmax(-1)
                logits.append(lg[:, :cfg.vocab].cpu())
        out[where] = (float(loss), torch.stack(logits, dim=1))
    (lc, gc), (lp, gp) = out["card"], out["cpu"]
    rel = abs(lc - lp) / abs(lp)
    check(rel <= FAM_RTOL, f"families (a) {ENCDEC_ARCH}: encdec_loss "
          f"differs by {rel:.3e} relative")
    err = (gc.double() - gp.double()).abs()
    check(bool((err <= 1e-3 + 1e-3 * gp.double().abs()).all())
          and torch.equal(gc.argmax(-1), gp.argmax(-1)),
          f"families (a) {ENCDEC_ARCH}: decode logits differ (max abs "
          f"err {float(err.max()):.3e}) or the greedy tokens do")
    log(f"[families] (a) {ENCDEC_ARCH} reduced (f32), source {b} x {ss}, "
        f"target {st}: encdec_loss card {lc!r} vs CPU {lp!r} ({rel:.3e} "
        f"relative); {n} greedy encdec_decode_steps: tokens equal, logits "
        f"within {float(err.max()):.3e} abs; on {smi}")


def _zamba2_full(seed, smi, dev):
    """(b): zamba2-2.7b at its published width and depth through
    `train()`, then `serve_prompts` on the trained model for "cuda" and
    "cuda-q", a profiled decode window, `lm_prefill`'s tokens/s and (d)
    decode against forward in f32.  Returns the kernels' launches over
    the two serving runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import GuardConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import serve_prompts

    cfg = get_config(ZAMBA_ARCH)
    label = "[families] (b)"
    b, s, n, every = (ZAMBA_TRAIN[k] for k in ("batch", "seq", "steps",
                                               "corrupt_every"))
    gcfg = GuardConfig(m=3.0, warmup_steps=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, hist, summary = train_mod.train(
        cfg, n, b, s, None, device=dev, log_every=4, guard_cfg=gcfg,
        corrupt_every=every)
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    check(len(hist) == n, f"{label}: {len(hist)} steps, not {n}")
    check(n_params == ZAMBA_PARAMS, f"{label}: {n_params} parameters, not "
          f"the published config's {ZAMBA_PARAMS}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"{label}: non-finite parameters after training")
    _report_training(label, cfg, b, s, hist, summary, gcfg, every, t_train,
                     peak, n_params, smi)
    timed(_profile_window, model, cfg, b, s, dev, gcfg, smi,
          n_steps=ZAMBA_PROFILED, label=label)
    torch.cuda.empty_cache()

    bs, p, gen = (ZAMBA_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    prompts = torch.randint(0, cfg.vocab, (bs, p), generator=torch.
                            Generator().manual_seed(seed)).to(dev)
    launches, _ = timed(
        _serve_both, label, cfg, bs, p, gen,
        lambda backend: serve_prompts(model, prompts, cfg, gen,
                                      backend=backend,
                                      fmt=_lm_fmt(backend)), smi)
    timed(_decode_profile, label, model, cfg, prompts, smi)
    timed(_prefill_rate, label, model, cfg, prompts, smi)
    timed(_decode_vs_forward, "[families] (d)", model,
          dataclasses.replace(cfg, compute_dtype="float32"),
          prompts[:FAM_CHECK["batch"], :FAM_CHECK["seq"]], smi)
    return launches


def _mixtral_full(seed, smi, dev):
    """(c): mixtral-8x7b at its published width, depth cut to
    `MIXTRAL_LAYERS`, through `train()` (each step's dropped_frac per
    layer from the routes), `serve_prompts` on the trained model with
    "cuda", and (d) decode against forward in f32 with capacity_factor
    4 (no assignment dropped on either path)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import serve_prompts

    full = get_config(MIXTRAL_ARCH)
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    label = "[families] (c)"
    b, s, n = (MIXTRAL_TRAIN[k] for k in ("batch", "seq", "steps"))
    log(f"{label} {cfg.name}: depth cut from {full.n_layers} to "
        f"{cfg.n_layers} layers (the full depth's f32 state does not fit "
        f"one card); width as published")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _route_log() as routes:
        model, hist, summary = train_mod.train(cfg, n, b, s, None,
                                               device=dev, log_every=4)
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    # per step: each layer's routing, then (under remat) the backward's
    # recompute, in reverse layer order
    fwd = cfg.n_layers
    per = fwd * (2 if cfg.remat else 1)
    check(len(routes) == n * per, f"{label}: {len(routes)} routings in {n} "
          f"steps, not {n * per}")
    steps = [routes[i * per:(i + 1) * per] for i in range(n)]
    check(not cfg.remat or all(_same_routes(st[:fwd], st[fwd:][::-1])
                               for st in steps),
          f"{label}: the remat recompute routed differently")
    dropped = [[float(1.0 - r.keep.float().mean()) for r in st[:fwd]]
               for st in steps]
    del routes
    _report_training(label, cfg, b, s, hist, summary, train_mod.GUARD_CFG,
                     0, t_train, peak, n_params, smi)
    log(f"{label} dropped_frac per step (one value per layer): "
        + " ".join("(" + ", ".join(f"{x:.4f}" for x in row) + ")"
                   for row in dropped))
    torch.cuda.empty_cache()

    bs, p, gen = (MIXTRAL_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    prompts = torch.randint(0, cfg.vocab, (bs, p), generator=torch.
                            Generator().manual_seed(seed)).to(dev)
    _serve_both(label, cfg, bs, p, gen,
                lambda backend: serve_prompts(model, prompts, cfg, gen,
                                              backend=backend), smi,
                backends=("cuda",))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                capacity_factor=4.0)
    timed(_decode_vs_forward, "[families] (d)", model, cfg32,
          prompts[:FAM_CHECK["batch"], :FAM_CHECK["seq"]], smi)


def _fam_decode_checks(seed, smi, dev):
    """(d) for xlstm-350m (24 blocks, 18 mLSTM + 6 sLSTM) and
    seamless-m4t-medium (`encdec_decode_step` against `decode_train`),
    each at its published width, f32 compute."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (build_cross_cache, decode_train,
                                    encdec_decode_step, encode,
                                    init_encdec_cache, init_encdec_params,
                                    init_lm_params)

    cb, cs = FAM_CHECK["batch"], FAM_CHECK["seq"]
    gen = torch.Generator().manual_seed(seed)
    cfg = dataclasses.replace(get_config("xlstm-350m"),
                              compute_dtype="float32")
    model = init_lm_params(seed, cfg, device=dev)
    toks = torch.randint(0, cfg.vocab, (cb, cs), generator=gen).to(dev)
    timed(_decode_vs_forward, "[families] (d)", model, cfg, toks, smi)
    del model

    cfg = dataclasses.replace(get_config(ENCDEC_ARCH),
                              compute_dtype="float32")
    model = init_encdec_params(seed, cfg, device=dev)
    src = torch.randn((cb, cs, cfg.d_model), generator=gen).to(dev)
    toks = torch.randint(0, cfg.vocab, (cb, cs), generator=gen).to(dev)
    with torch.inference_mode():
        enc = encode(model, src, cfg)
        full = decode_train(model, enc, toks, cfg)
        caches = init_encdec_cache(cfg, cb, cs, cs, dtype=torch.float32,
                                   device=dev)
        caches["cross"] = build_cross_cache(model, enc, cfg,
                                            dtype=torch.float32)
        outs = []
        for t in range(cs):
            lg, caches = encdec_decode_step(model, toks[:, t], t, caches,
                                            cfg)
            outs.append(lg)
    _close_logits("[families] (d)", torch.stack(outs, dim=1), full, smi,
                  f"{cfg.name} full width ({cfg.enc_layers} + "
                  f"{cfg.dec_layers} layers x {cfg.d_model}, vocab "
                  f"{cfg.vocab}), f32 compute, source {cb} x {cs}: "
                  f"encdec_decode_step against decode_train")


def phase_families(seed, smi):
    """Phase 10: the other model families, training and decode.
    Returns the kernels' launches over (b)'s two serving runs."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    timed(_fam_card_vs_cpu, seed, smi, dev)
    launches = timed(_zamba2_full, seed, smi, dev)
    torch.cuda.empty_cache()
    timed(_mixtral_full, seed, smi, dev)
    torch.cuda.empty_cache()
    timed(_fam_decode_checks, seed, smi, dev)
    torch.cuda.empty_cache()
    log(f"[families] phase 10 took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------- distributed
# phase 11: (a) one stream over 4 shards, (b) the process-group form,
# (c) the GPipe stage loop, (d) the TEDA dry run
DIST_T, DIST_N, DIST_D, DIST_M = 1 << 24, 4, 4, 3.0
DIST_CPU_T = 1 << 20  # the rows (a) also scans on the CPU
DIST_BURSTS = ((700_000, 20), (4_194_300, 40), (9_000_000, 25),
               (16_000_000, 30))  # (first row, rows) shifted by +6
DIST_ROW_BYTES = DIST_N * 4 + 5 * 4 + 1  # x; five f32 fields, the flag
DIST_REPS = 1
PIPE_ARCH, PIPE_STAGES, PIPE_MB, PIPE_SEQ = "llama3.2-1b", 4, 8, 128
GROUP_TIMEOUT_S = 300


def _dist_stream(seed, dev, t_len=DIST_T):
    """(T, N) float32 N(0, 1) from a generator on `dev` seeded with
    `seed` (the same values on any card of one model), with bursts."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((t_len, DIST_N), generator=gen, device=dev)
    for row, n in DIST_BURSTS:
        if row + n <= t_len:
            x[row:row + n] += 6.0
    return x


def _dist_same(tag, out, fin, want, wfin):
    """`out` / `fin` against `want` / `wfin`: fields within rtol 5e-4 /
    atol 1e-5, flags equal outside the 1e-4 band, k exact; returns the
    fields' largest difference and the flags counted."""
    err = 0.0
    for f in ("ecc", "typ", "zeta", "threshold", "k"):
        a, b = getattr(out, f).double().cpu(), getattr(want, f).double().cpu()
        diff = (a - b).abs()
        check(bool((diff <= ATOL + RTOL * b.abs()).all()),
              f"dist {tag} {f}: beyond rtol {RTOL} / atol {ATOL} (max abs "
              f"err {float(diff.max())})")
        err = max(err, float(diff.max()))
    check(torch.equal(out.k.cpu(), want.k.cpu()), f"dist {tag}: k differs")
    _, bad = _band_mismatch(want.ecc.double().cpu(), DIST_M,
                            want.k.double().cpu(), out.outlier.cpu(),
                            want.outlier.cpu())
    check(bad == 0, f"dist {tag}: {bad} flags differ outside the band")
    check(torch.equal(fin.k.cpu(), wfin.k.cpu())
          and float(fin.k) == float(out.k.shape[0]),
          f"dist {tag}: final k {float(fin.k)} for {out.k.shape[0]} rows")
    for f in ("mean", "var"):
        a, b = getattr(fin, f).double().cpu(), getattr(wfin, f).double().cpu()
        check(bool(((a - b).abs() <= ATOL + RTOL * b.abs()).all()),
              f"dist {tag}: final {f} {a.tolist()} against {b.tolist()}")
    return err, int(out.outlier.sum())


def _bits(v):
    """A tensor as words of its width (float32, bfloat16), to compare
    bit for bit; other dtypes as they are."""
    if v.dtype == torch.float32:
        return v.view(torch.int32)
    if v.dtype == torch.bfloat16:
        return v.contiguous().view(torch.int16)
    return v


def _finals_bitequal(tag, finals):
    words = [[_bits(v.cpu()) for v in fin] for fin in finals]
    check(all(all(torch.equal(a, b) for a, b in zip(words[0], w))
              for w in words), f"dist {tag}: the shards' finals differ")


def _dist_stream_phase(seed, smi, dev):
    """(a): `distributed_teda` over 4 shards on one card (and on four
    cards where present) against the single-device `teda_scan`, and
    its first 2^20 rows against the CPU form."""
    from repro_torch.core import teda_scan
    from repro_torch.core.distributed import make_distributed_teda
    from repro_torch.launch.cost_analysis import collective_stats

    x = _dist_stream(seed, dev)
    torch.cuda.synchronize()
    sfin, sout = teda_scan(x, DIST_M)
    n_flags = int(sout.outlier.sum())
    check(n_flags > 0, "dist (a): the bursts raised no flag")
    # each timed function has just run once: no further warmup
    scan_ms = cuda_ms(lambda: teda_scan(x, DIST_M), DIST_REPS, warmup=0)
    cumsum_ms = cuda_ms(lambda: torch.cumsum(x, 0), DIST_REPS, warmup=0)
    bound = DIST_T * DIST_ROW_BYTES / HBM_BYTES_PER_S * 1e3
    want_bytes = (DIST_D - 1) / DIST_D * (DIST_D * DIST_N * 4 + 2 * DIST_D * 4)
    layouts = [("1 card", [dev] * DIST_D)]
    if torch.cuda.device_count() >= DIST_D:
        layouts.append((f"{DIST_D} cards", [torch.device("cuda", i)
                                            for i in range(DIST_D)]))
    for label, devs in layouts:
        fn = make_distributed_teda(devs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fin, out = fn(x, DIST_M)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        stats = collective_stats(fn.axis)
        check(stats == {"all-gather": want_bytes, "total_bytes": want_bytes,
                        "all-gather_count": 3},
              f"dist (a) {label}: counted collectives {stats}")
        err, flags = _dist_same(f"(a) {label}", out, fin, sout, sfin)
        _finals_bitequal(f"(a) {label}", fn.finals)
        ms = cuda_ms(lambda: fn(x, DIST_M), DIST_REPS, warmup=0)
        log(f"[dist] (a) {label}: distributed_teda T = {DIST_T:,} x N = "
            f"{DIST_N} over {DIST_D} shards: {ms:.3f} ms per pass "
            f"({DIST_T / ms * 1e3:.6e} samples/s), byte bound "
            f"{bound:.4f} ms ({DIST_ROW_BYTES} B per row at 3.35 TB/s; "
            f"{ms / bound:.1f}x), single-device teda_scan {scan_ms:.3f} ms "
            f"({scan_ms / ms:.2f}x the sharded pass); torch.cumsum over "
            f"(T, N) alone {cumsum_ms:.3f} ms; peak "
            f"{peak:,} B on {dev}; gathers {stats['all-gather_count']}, "
            f"{stats['all-gather']} B (ring model); max abs err against "
            f"teda_scan {err:.3e}; {flags} flags ({n_flags} single); "
            f"finals bit-equal over {DIST_D} shards; {smi}")
    cpu_fn = make_distributed_teda(["cpu"] * DIST_D)
    cfin, cout = cpu_fn(x[:DIST_CPU_T].cpu(), DIST_M)
    gfin, gout = make_distributed_teda([dev] * DIST_D)(x[:DIST_CPU_T],
                                                      DIST_M)
    err, _ = _dist_same("(a) card vs CPU", gout, gfin, cout, cfin)
    log(f"[dist] (a) the first {DIST_CPU_T:,} rows over {DIST_D} shards: "
        f"card = CPU within rtol {RTOL} / atol {ATOL} (max abs err "
        f"{err:.3e}), flags equal outside the band")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_rank(rank, world, port, seed):
    """One rank of (b): `distributed_teda_group` over NCCL on cuda:rank,
    bit for bit the `DeviceAxis` form's block at the same D."""
    import torch.distributed as dist

    from repro_torch.core.distributed import (distributed_teda_group,
                                              make_distributed_teda)

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        x = _dist_stream(seed, dev)
        t = DIST_T // world
        block = x[rank * t:(rank + 1) * t]
        fin, out = distributed_teda_group(block, DIST_M)
        ms = cuda_ms(lambda: distributed_teda_group(block, DIST_M),
                     DIST_REPS, warmup=0)
        ref = make_distributed_teda([dev] * world)
        _, rout = ref(x, DIST_M)
        for f, a, b in zip(out._fields, out, rout):
            check(torch.equal(_bits(a), _bits(b[rank * t:(rank + 1) * t])),
                  f"dist (b) rank {rank}: {f} differs from the DeviceAxis "
                  "form")
        for a, b in zip(fin, ref.finals[rank]):
            check(torch.equal(_bits(a), _bits(b)),
                  f"dist (b) rank {rank}: the final state differs")
        log(f"[dist] (b) rank {rank} of {world} (nccl, {dev}): "
            f"distributed_teda_group over {t:,} rows bit-equal to the "
            f"DeviceAxis form at D = {world}; {ms:.3f} ms per pass")
    finally:
        dist.destroy_process_group()


def _dist_group_phase(seed):
    """(b): min(cards, 4) ranks, one per card, each a child process that
    imports this script and runs `_group_rank`."""
    world = min(torch.cuda.device_count(), DIST_D)
    port = _free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
            "chip_smoke._group_rank(*map(int, sys.argv[3:]))")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(ROOT / "src"),
         str(r), str(world), str(port), str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for ln in text.strip().splitlines()[-40:]:
            log(f"[dist]   rank {r}| {ln}")
        check(p.returncode == 0, f"dist (b): rank {r} exited "
              f"{p.returncode}")
    log(f"[dist] (b) {world} rank(s) passed in "
        f"{time.perf_counter() - t0:.1f} s (a one-card machine runs one "
        "rank: the code path, not the traffic)")


def _pipe_blocks(cfg, dev, seed):
    """`cfg`'s blocks, random N(0, 0.02) weights from a generator on the
    card (`init_lm_params` draws on the CPU, slow at full width)."""
    from repro_torch.models.transformer import Block, block_layout

    grp, n_groups = block_layout(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = [Block(None, grp[j], cfg, dev)
              for _ in range(n_groups) for j in range(len(grp))]
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                p.normal_(0.0, 0.02, generator=gen)
    return blocks


def _dist_pipeline_phase(seed, smi, dev):
    """(c): the reference test's affine stages, then llama3.2-1b's 16
    blocks at full width as 4 stages of 4 over 8 microbatches."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch.cost_analysis import collective_stats
    from repro_torch.models.transformer import _group_body
    from repro_torch.sharding.pipeline import make_pipelined

    affine = make_pipelined([dev] * 4, lambda w, x: x * w[0], 4)
    x = torch.arange(24.0, device=dev).reshape(6, 4)
    out = affine(torch.tensor([[2.0], [0.5], [3.0], [1.0]]), x)
    check(torch.equal(out, x * 3.0), "dist (c): the affine pipeline differs")

    cfg = get_config(PIPE_ARCH)
    blocks = _pipe_blocks(cfg, dev, seed)
    per = len(blocks) // PIPE_STAGES
    stages = [blocks[s * per:(s + 1) * per] for s in range(PIPE_STAGES)]

    def stage(blks, h):
        return _group_body(h, blks, cfg, None, None)[0]

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((PIPE_MB, 1, PIPE_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(cfg.cdtype)
    layouts = [("1 card", [dev] * PIPE_STAGES, stages)]
    if torch.cuda.device_count() >= PIPE_STAGES:
        cards = [torch.device("cuda", s) for s in range(PIPE_STAGES)]
        layouts.append((f"{PIPE_STAGES} cards", cards,
                        [[copy.deepcopy(b).to(cards[s]) for b in stages[s]]
                         for s in range(PIPE_STAGES)]))
    with torch.no_grad():
        def straight():
            outs = []
            for mb in x:
                for blks in stages:
                    mb = stage(blks, mb)
                outs.append(mb)
            return torch.stack(outs)

        want = straight()
        seq_ms = cuda_ms(straight, DIST_REPS, warmup=1)
        for label, devs, params in layouts:
            run = make_pipelined(devs, stage, PIPE_STAGES)
            got = run(params, x)
            stats = collective_stats(run.axis)
            ticks = stats["collective-permute_count"]
            check(ticks == PIPE_MB + PIPE_STAGES - 1,
                  f"dist (c) {label}: {ticks} ticks")
            check(bool(torch.isfinite(got.float()).all())
                  and torch.equal(_bits(got), _bits(want)),
                  f"dist (c) {label}: the pipeline differs from the blocks "
                  "applied microbatch by microbatch")
            ms = cuda_ms(lambda: run(params, x), DIST_REPS, warmup=1)
            log(f"[dist] (c) {label}: {PIPE_ARCH} full width, "
                f"{len(blocks)} blocks as {PIPE_STAGES} stages over "
                f"{PIPE_MB} microbatches of (1, {PIPE_SEQ}, {cfg.d_model}) "
                f"{cfg.cdtype}: bit-equal in {ticks} ticks, {ms:.3f} ms "
                f"(straight {seq_ms:.3f} ms), {stats['collective-permute']}"
                f" B handed off; {smi}")


def _dist_dryrun_phase(seed, smi, dev):
    """(d): `teda_dryrun.run` for both meshes at T = 2^24, N = 4, and the
    card's peak memory for one shard's block of the single mesh."""
    from repro_torch.core.distributed import shard_scan
    from repro_torch.launch import teda_dryrun
    from repro_torch.sharding.collectives import TraceAxis

    for multi, total in ((False, 360.0), (True, 744.0)):
        r = teda_dryrun.run(multi, DIST_T, DIST_N)
        c = r["collectives"]
        check(c == {"all-gather": total, "total_bytes": total,
                    "all-gather_count": 3},
              f"dist (d) {r['mesh']}: collectives {c}")
        log(f"[dist] (d) {r['mesh']} mesh, {r['devices']} devices: "
            f"t_per_device {r['t_per_device']:,} (the reference's figure), "
            f"flops {r['flops_per_device']:.6e}, bytes "
            f"{r['bytes_per_device']:.6e} per device (the port's count), "
            f"all-gather {c['all-gather']} B in {c['all-gather_count']}, "
            f"roofline {json.dumps(r['roofline'])}, temp_bytes "
            f"{r['temp_bytes']}")
    group = 16
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = torch.randn((DIST_T // group, DIST_N), generator=gen, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res = shard_scan([block], DIST_M, TraceAxis(group))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del res
    log(f"[dist] (d) one shard's block of the single mesh ({DIST_T // group:,}"
        f" x {DIST_N}) on the card: max_memory_allocated {peak:,} B, "
        f"{peak - base:,} B above its inputs; {smi}")


def phase_distributed(seed, smi):
    """Phase 11: the time-sharded TEDA scan, the process-group form, the
    pipeline and the dry run.  No TEDA kernel may launch.  Returns the
    kernels' launches (all 0)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    mods = _kernel_mods()
    for mod in mods.values():
        mod.launches = 0
    timed(_dist_stream_phase, seed, smi, dev)
    torch.cuda.empty_cache()
    timed(_dist_group_phase, seed)
    timed(_dist_pipeline_phase, seed, smi, dev)
    torch.cuda.empty_cache()
    timed(_dist_dryrun_phase, seed, smi, dev)
    torch.cuda.empty_cache()
    launches = {name: mod.launches for name, mod in mods.items()}
    check(not any(launches.values()), f"dist: TEDA kernels launched "
          f"{launches} on the distributed paths")
    log(f"[dist] no TEDA kernel launched; phase 11 took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------ the model on a mesh
# phase 12: (a) phase 8's full-width training on a (1, 1) mesh, (b) the
# train / prefill / decode cells on that mesh against the unsharded port
# functions, (c) the production dry run (child processes on the CPU),
# (d) one device's share of decode_32k on the card under a fake group,
# (e) NCCL ranks on two or four cards
SHARD_ARCH = "llama3.2-1b"
SHARD_STEPS = 8  # (a): ms per step is the median of steps 2-7
SHARD_LOSSES = 4  # (a): the first losses held against phase 8's
SHARD_CELLS = (("train", 128, 8), ("prefill", 128, 8), ("decode", 256, 8))
SHARD_DRY = (("llama3_2_1b", "train_4k"), ("llama3_2_1b", "prefill_32k"),
             ("llama3_2_1b", "decode_32k"), ("mixtral_8x7b", "train_4k"),
             ("mixtral_8x7b", "prefill_32k"), ("dbrx_132b", "train_4k"),
             ("xlstm_350m", "train_4k"))
# the first step's full lr; eps 1e-3 keeps its update linear in a
# near-zero gradient (tests/test_torch_cells.py)
SHARD_OPT = dict(warmup_steps=1, total_steps=10, eps=1e-3)
SHARD_RTOL, SHARD_ATOL = 1e-3, 1e-5  # (b): bf16 compute, one card
SHARD_LOGIT_TOL = 2e-2  # (b): prefill / decode logits, bf16 compute
DRY_TIMEOUT_S = 600
# (c): the JAX package's per-device counts of the same cells (flops,
# bytes, collective bytes, temp bytes), read on the CPU with JAX 0.9.0
# from `run_cell(arch, shape, "single")` of `repro.launch.dryrun` (no fit
# overrides; tests/test_torch_dryrun_parity{,_moe,_xlstm}.py read them
# live); the port may reach at most DRY_BOUNDS times the flops and the
# collective bytes, with no `ViewResharding` retry
DRY_REF = {
    ("llama3_2_1b", "train_4k"): (5.0970537230336e13, 6.927610478592e12,
                                  6.39496069121e11, 4.590853512e9),
    ("llama3_2_1b", "prefill_32k"): (1.7259914395648e13, 9.722669056e11,
                                     1.91057124096e11, 9.139667968e9),
    ("llama3_2_1b", "decode_32k"): (1.03866198016e11, 2.04167702528e11,
                                    2.5691875328e10, 2.003830352e9),
    ("mixtral_8x7b", "train_4k"): (1.042104311611392e15,
                                   3.6418615820288e13, 4.480740793944e12,
                                   8.645339624e9),
    ("mixtral_8x7b", "prefill_32k"): (1.4361804210176e14,
                                      2.192835444736e12, 2.62501454592e11,
                                      5.6174946e9),
    ("dbrx_132b", "train_4k"): (2.835354553942016e15, 1.1061408825344e14,
                                2.1054368628519e13, 1.0849602152e10),
    ("xlstm_350m", "train_4k"): (1.8285885652992e13, 4.016090906624e12,
                                 4.16860942414e11, 2.140220796e10),
}
DRY_BOUNDS = {"flops": 1.25, "collective": 1.5}


def _sharded_train(smi, dev, unsharded):
    """(a): phase 8 (b)'s training (its schedule, guard and batches) for
    SHARD_STEPS steps through `train(..., mesh=make_host_mesh())`."""
    from repro_torch.configs import get_config
    from repro_torch.core import GuardConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw

    cfg = get_config(SHARD_ARCH)
    b, s, n = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    opt = adamw.AdamWConfig(warmup_steps=min(100, n // 4 + 1),
                            total_steps=n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, hist, summary = train_mod.train(
        cfg, SHARD_STEPS, b, s, None, device=dev, log_every=4,
        guard_cfg=GuardConfig(m=3.0, warmup_steps=8),
        corrupt_every=TRAIN_FULL["corrupt_every"], opt_cfg=opt,
        mesh=make_host_mesh())
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    med = float(np.median(summary["step_s"][2:])) * 1e3
    losses = [h["loss"] for h in hist]
    ref = unsharded["losses"][:SHARD_LOSSES]
    diff = max(abs(a - r) for a, r in zip(losses, ref))
    check(all(np.isfinite(v) for v in losses), f"shard (a): losses {losses}")
    check(np.allclose(losses[:SHARD_LOSSES], ref, rtol=TRAIN_RTOL),
          f"shard (a): losses {losses[:SHARD_LOSSES]} against phase 8's "
          f"{ref} (rtol {TRAIN_RTOL})")
    log(f"[shard] (a) {cfg.name} full width through train(mesh=(1, 1) "
        f"over a one-rank NCCL group), batch {b} x seq {s}, {SHARD_STEPS} "
        f"steps in {t_train:.2f} s (set-up included): {med:.3f} ms per "
        f"step (median of {SHARD_STEPS - 2}), {b * s / med * 1e3:.1f} "
        f"tokens/s, peak {peak / 2**30:.3f} GiB ({peak} B); unsharded "
        f"(phase 8 (b), this run): {unsharded['ms']:.3f} ms per step, "
        f"{unsharded['tokens_s']:.1f} tokens/s, peak "
        f"{unsharded['peak'] / 2**30:.3f} GiB; {smi}")
    log(f"[shard] (a) first {SHARD_LOSSES} losses {losses[:SHARD_LOSSES]} "
        f"against phase 8's {ref}: largest difference {diff:.3e} (rtol "
        f"{TRAIN_RTOL}); ms per step "
        f"{' '.join(f'{t * 1e3:.1f}' for t in summary['step_s'])}")


def _timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _local(t):
    """A (1, 1) mesh's DTensor as its local tensor (the whole tensor)."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _sharded_cells(seed, smi, dev):
    """(b): llama3.2-1b at full width, the train, prefill and decode
    cells on a (1, 1) mesh against the unsharded functions on the same
    weights and inputs, one call each."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.guard import guard_init
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    from repro_torch.launch.specs import (GUARD_CFG, build_cell,
                                          distribute_model, make_train_step)
    from repro_torch.models import (init_cache, init_lm_params,
                                    lm_decode_step, lm_prefill)
    from repro_torch.optim import adamw

    cfg = get_config(SHARD_ARCH)
    mesh = make_host_mesh()
    opt = adamw.AdamWConfig(**SHARD_OPT)
    cells = {kind: ShapeSpec(f"shard_{kind}", s, b, kind)
             for kind, s, b in SHARD_CELLS}
    with one_rank_group("cuda"):
        dmesh = mesh.device_mesh("cuda")
        model = init_lm_params(seed, cfg, dev)
        ref = copy.deepcopy(model)
        before = copy.deepcopy(ref)
        cell = build_cell(SHARD_ARCH, cells["train"], mesh, cfg,
                          opt_cfg=opt, params=model, seed=seed, dmesh=dmesh)
        batch = {n: _local(v).clone() for n, v in cell.args[3].items()}
        out, ms = _timed_ms(lambda: cell.fn(*cell.args))
        rout, rms = _timed_ms(lambda: make_train_step(cfg, opt)(
            ref, adamw.init(dict(ref.named_parameters())),
            guard_init(GUARD_CFG, dev), batch))
        met = {k: float(_local(out[3][k])) for k in ("loss", "grad_norm")}
        rmet = {k: float(rout[3][k]) for k in ("loss", "grad_norm")}
        check(all(np.isclose(met[k], rmet[k], rtol=SHARD_RTOL)
                  for k in met), f"shard (b) train: {met} against {rmet}")
        worst = step = 0.0
        for (n, p), q, p0 in zip(model.named_parameters(),
                                 ref.parameters(), before.parameters()):
            a = _local(p.detach())
            check(torch.allclose(a, q.detach(), rtol=SHARD_RTOL,
                                 atol=SHARD_ATOL),
                  f"shard (b) train: {n} differs after the step")
            worst = max(worst, float((a - q.detach()).abs().max()))
            step = max(step, float((q.detach() - p0.detach()).abs().max()))
        del out, rout, before, cell
        distribute_model(model, None, local=True)
        del model
        torch.cuda.empty_cache()
        log(f"[shard] (b) train cell {cells['train'].global_batch} x "
            f"{cells['train'].seq_len}: loss {met['loss']!r} / "
            f"{rmet['loss']!r}, grad norm {met['grad_norm']!r} / "
            f"{rmet['grad_norm']!r} (sharded / unsharded, rtol "
            f"{SHARD_RTOL}); parameters after the step within rtol "
            f"{SHARD_RTOL} / atol {SHARD_ATOL} (largest difference "
            f"{worst:.3e}, largest update {step:.3e}); one call each: "
            f"{ms:.3f} ms sharded, {rms:.3f} ms unsharded; {smi}")

        # prefill and decode: the cell on `ref`, then the unsharded
        # function on the same storage
        cell = build_cell(SHARD_ARCH, cells["prefill"], mesh, cfg,
                          params=ref, seed=seed + 1, dmesh=dmesh)
        logits, ms = _timed_ms(lambda: cell.fn(*cell.args))
        tokens = _local(cell.args[1]).clone()
        distribute_model(ref, None, local=True)
        want, rms = _timed_ms(lambda: lm_prefill(ref, tokens, cfg))
        err = float((_local(logits) - want).detach().abs().max())
        check(torch.allclose(_local(logits), want, rtol=SHARD_LOGIT_TOL,
                             atol=SHARD_LOGIT_TOL),
              f"shard (b) prefill: logits differ by {err}")
        log(f"[shard] (b) prefill cell {cells['prefill'].global_batch} x "
            f"{cells['prefill'].seq_len}: logits within {SHARD_LOGIT_TOL} "
            f"(largest difference {err:.3e}); one call each: {ms:.3f} ms "
            f"sharded, {rms:.3f} ms unsharded (lm_prefill); {smi}")
        del cell, logits, want

        sp = cells["decode"]
        cell = build_cell(SHARD_ARCH, sp, mesh, cfg, params=ref,
                          seed=seed + 2, dmesh=dmesh)
        (logits, caches), ms = _timed_ms(lambda: cell.fn(*cell.args))
        token = _local(cell.args[1]).clone()
        distribute_model(ref, None, local=True)
        rc = init_cache(cfg, sp.global_batch, sp.seq_len,
                        dtype=getattr(torch, cfg.kv_dtype), device=dev)
        (want, rc), rms = _timed_ms(
            lambda: lm_decode_step(ref, token, 0, rc, cfg))
        err = float((_local(logits) - want).detach().abs().max())
        cerr = max(float((_local(t).float() - r.float()).detach().abs()
                         .max())
                   for c, cr in zip(caches, rc) for t, r in zip(c, cr))
        check(torch.allclose(_local(logits), want, rtol=SHARD_LOGIT_TOL,
                             atol=SHARD_LOGIT_TOL),
              f"shard (b) decode: logits differ by {err}")
        check(all(torch.allclose(_local(t).float(), r.float(),
                                 rtol=SHARD_LOGIT_TOL, atol=SHARD_LOGIT_TOL)
                  for c, cr in zip(caches, rc) for t, r in zip(c, cr)),
              f"shard (b) decode: caches differ by {cerr}")
        log(f"[shard] (b) decode cell batch {sp.global_batch}, "
            f"{sp.seq_len}-slot {cfg.kv_dtype} cache: logits and caches "
            f"within {SHARD_LOGIT_TOL} (largest differences {err:.3e}, "
            f"{cerr:.3e}); one call each: {ms:.3f} ms sharded, "
            f"{rms:.3f} ms unsharded (lm_decode_step); {smi}")
        del cell, logits, caches, want, rc, ref
    torch.cuda.empty_cache()


_DRY_CHILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
              "from repro_torch.launch.dryrun import run_cell; "
              "print(json.dumps(run_cell(sys.argv[2], sys.argv[3], "
              "'single')))")


def _dry_children():
    """(c): one child process per cell, on the CPU (no card visible)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return {cell: subprocess.Popen(
        [sys.executable, "-c", _DRY_CHILD, str(ROOT / "src"), *cell],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell in SHARD_DRY}


def _stop_children(procs):
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _dry_results(procs):
    """(c)'s results, printed: per-device counts and roofline terms,
    reckoned from shapes with H100 constants (not measured), each count
    against the JAX package's (`DRY_REF`); fails where the flops or the
    collective bytes exceed `DRY_BOUNDS` or a view was resharded."""
    out = {}
    for (arch, shape), p in procs.items():
        text, err = p.communicate(timeout=DRY_TIMEOUT_S)
        check(p.returncode == 0, f"shard (c) {arch} {shape}: exited "
              f"{p.returncode}: {err[-2000:]}")
        r = json.loads(text.strip().splitlines()[-1])
        out[arch, shape] = r
        t, m = r["roofline"], r["memory"]
        cal = r["calibration"]
        got = (r["flops_per_device"], r["bytes_per_device"],
               r["collective_bytes_per_device"], m["temp_bytes"])
        ratio = dict(zip(("flops", "bytes", "collective", "temp"),
                         (a / b for a, b in zip(got, DRY_REF[arch, shape]))))
        log(f"[shard] (c) {arch} {shape}, port / JAX package per "
            f"device (torch {torch.__version__}): flops "
            f"{ratio['flops']:.4f}, bytes {ratio['bytes']:.4f}, collective "
            f"bytes {ratio['collective']:.4f}, temp bytes "
            f"{ratio['temp']:.4f}; views resharded "
            f"{cal['view_fallbacks']} {cal['view_fallback_ops'][:3]}")
        for key, bound in DRY_BOUNDS.items():
            check(ratio[key] <= bound, f"shard (c) {arch} {shape}: {key} "
                  f"{ratio[key]:.4f} x the JAX package's (bound {bound})")
        check(cal["view_fallbacks"] == 0, f"shard (c) {arch} {shape}: "
              f"{cal['view_fallbacks']} views resharded: "
              f"{cal['view_fallback_ops'][:5]}")
        log(f"[shard] (c) {arch} {shape} on the 16 x 16 mesh (a fake "
            f"256-rank group, meta; reckoned with H100 constants, not "
            f"measured): flops {r['flops_per_device']:.6e}, bytes "
            f"{r['bytes_per_device']:.6e}, collective bytes "
            f"{r['collective_bytes_per_device']:.6e} per device; compute "
            f"{t['compute_s']:.6f} s, memory {t['memory_s']:.6f} s, "
            f"collective {t['collective_s']:.6f} s, bound "
            f"{t['bottleneck']}; argument {m['argument_bytes']} B, temp "
            f"{m['temp_bytes']:.6e} B; accum {r['accum_steps']}, useful "
            f"flop ratio {r['useful_flop_ratio']:.4f}; build "
            f"{r['lower_s']} s, traces {r['compile_s']} s")
    return out


def _shard_share(dev, smi):
    """(d): one device's share of decode_32k on the 16 x 16 mesh, its
    shards allocated on the card under a fake 256-rank group (the
    collectives move nothing, so the values mean nothing)."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.launch.specs import build_cell

    sp = next(x for x in SHAPES if x.name == "decode_32k")
    mesh = make_production_mesh()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with fake_group(mesh.size):
        cell = build_cell("llama3_2_1b", sp, mesh, device=dev,
                          shards_only=True)
        args = local_bytes(*cell.args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (logits, _), ms = _timed_ms(lambda: cell.fn(*cell.args))
        peak = torch.cuda.max_memory_allocated()
        shape = tuple(_local(logits).shape)
        del cell, logits
    torch.cuda.empty_cache()
    log(f"[shard] (d) one device's share of {SHARD_ARCH} decode_32k (the "
        f"16 x 16 mesh, a fake group: local shapes real, values "
        f"meaningless): arguments {args} B on the card, peak {peak} B "
        f"({peak - base} B above them), local logits {shape}, one call "
        f"{ms:.3f} ms; {smi}")
    return {"argument_bytes": args, "peak": peak, "above": peak - base}


def _shard_rank(rank, world, port, seed):
    """(e), one rank: the reduced llama3.2-1b train cell in float32 on a
    (2, world / 2) mesh over NCCL against the unsharded step."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.guard import guard_init
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import (GUARD_CFG, build_cell,
                                          make_train_step)
    from repro_torch.models import init_lm_params
    from repro_torch.optim import adamw

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = Mesh((2, world // 2), ("data", "model"))
        cfg = get_config(SHARD_ARCH).reduced(compute_dtype="float32")
        opt = adamw.AdamWConfig(**SHARD_OPT)
        cell = build_cell(SHARD_ARCH, ShapeSpec("t", 64, 8, "train"), mesh,
                          cfg, opt_cfg=opt, device=dev, seed=seed)
        batch = {n: full(v).clone() for n, v in cell.args[3].items()}
        ref = init_lm_params(seed, cfg, dev)
        _, _, _, rmet = make_train_step(cfg, opt)(
            ref, adamw.init(dict(ref.named_parameters())),
            guard_init(GUARD_CFG, dev), batch)
        model, _, _, met = cell.fn(*cell.args)
        for k in ("loss", "grad_norm"):
            check(np.isclose(float(full(met[k])), float(rmet[k]),
                             rtol=1e-4), f"shard (e) rank {rank}: {k}")
        for (n, p), q in zip(model.named_parameters(), ref.parameters()):
            check(torch.allclose(full(p.detach()), q.detach(), rtol=1e-3,
                                 atol=1e-6),
                  f"shard (e) rank {rank}: {n} differs after the step")
        log(f"[shard] (e) rank {rank} of {world} (nccl, {dev}, mesh "
            f"{tuple(mesh.shape.values())}): the train cell equals the "
            "unsharded step (metrics rtol 1e-4, parameters rtol 1e-3 / "
            "atol 1e-6)")
    finally:
        dist.destroy_process_group()


def _shard_ranks(seed):
    """(e): the train cell over NCCL ranks, one child process per card,
    on two cards ((2, 1)) or four ((2, 2))."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[shard] (e) not measured: {n} card(s)")
        return
    world = 4 if n >= 4 else 2
    port = _free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
            "chip_smoke._shard_rank(*map(int, sys.argv[3:]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(ROOT / "src"),
         str(r), str(world), str(port), str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for ln in text.strip().splitlines()[-20:]:
            log(f"[shard]   rank {r}| {ln}")
        check(p.returncode == 0, f"shard (e): rank {r} exited "
              f"{p.returncode}")


def phase_sharded(seed, smi, unsharded, procs):
    """Phase 12: the model side of multi-device (DTensor placements by
    the sharding rules), with (c)'s dry-run children `procs` started
    before phase 11 so that their traces overlap it.  No TEDA kernel may
    launch.  Returns the kernels' launches (all 0)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    mods = _kernel_mods()
    for mod in mods.values():
        mod.launches = 0
    timed(_sharded_train, smi, dev, unsharded)
    timed(_sharded_cells, seed, smi, dev)
    share = timed(_shard_share, dev, smi)
    dry = timed(_dry_results, procs)
    dec = dry["llama3_2_1b", "decode_32k"]
    want = dec["memory"]["argument_bytes"]
    check(share["argument_bytes"] == want, f"shard (d): {share} argument "
          f"bytes on the card, the dry run's {want}")
    log(f"[shard] (d) against (c): arguments {share['argument_bytes']} B "
        f"= the dry run's argument_bytes; peak {share['peak']} B on the "
        f"card against the dry run's reckoned temp_bytes "
        f"{dec['memory']['temp_bytes']:.6e} B; {smi}")
    timed(_shard_ranks, seed)
    launches = {name: mod.launches for name, mod in mods.items()}
    check(not any(launches.values()), f"shard: TEDA kernels launched "
          f"{launches} on the sharded paths")
    log(f"[shard] no TEDA kernel launched; phase 12 took "
        f"{time.perf_counter() - t0:.1f} s")
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
            on_trace_ready=lambda p: traced.append(_device_rows(p))) \
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
    rows = traced[0]
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
    # phase 8's resume check runs under deterministic algorithms, which
    # need cuBLAS's fixed workspace from the first cuBLAS call on
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    timed(phase_divider, args.seed)
    records = timed(phase_kernels, args.seed)
    records.update(timed(phase_ensemble_kernel, args.seed))
    torch.cuda.empty_cache()
    timed(phase_engine, args.seed)
    timed(phase_ensemble_engine, args.seed)
    launches = timed(phase_stream, args.seed, smi)
    launches.update(timed(phase_ensemble_stream, args.seed, smi))
    served, singles = timed(phase_serve, args.seed, smi)
    fleet = timed(phase_fleet, args.seed, smi, singles)
    del singles
    unsharded = timed(phase_train, args.seed, smi)
    lm = timed(phase_lm, args.seed, smi)
    families = timed(phase_families, args.seed, smi)
    procs = _dry_children()
    try:
        distributed = timed(phase_distributed, args.seed, smi)
        sharded = timed(phase_sharded, args.seed, smi, unsharded, procs)
    finally:
        _stop_children(procs)
    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec["launches_serve"] = served[name]
        rec["launches_fleet"] = fleet[name]
        rec["launches_lm"] = lm[name]
        rec["launches_families"] = families[name]
        rec["launches_distributed"] = distributed[name]
        rec["launches_sharded"] = sharded[name]
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_serve", "launches_fleet", "launches_lm",
            "launches_families", "launches_distributed",
            "launches_sharded", "max_abs_err",
            "ms",
            "plain_ms", "bound_ms",
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
