"""The frozen references: hand-computed rows, chunking, raggedness, the
Q datapath bit for bit against the port's oracle, and the controls."""
import numpy as np
import pytest
import torch

from repro_torch.fixedpoint import QFormat, teda_q_scan_chan
from repro_torch.kernels.ref import teda_ref
from tedabench.harness import load_module

F = load_module("reference", "teda_f64")
Q = load_module("reference", "teda_q")
FMT = (32, 20, "trunc")


def test_float_hand_rows():
    x = torch.tensor([[1.0], [2.0], [3.0]] + [[1.0], [2.0]] * 8
                     + [[30.0]], dtype=torch.float64)
    out, st = F.scan(x, F.state0(1, "cpu"), 3.0)
    # k=1: ecc 1; k=2: mean 1.5, var 0.125, ecc 1/2 + 0.25/0.25;
    # k=3: mean 2, var 1.25/3, ecc 1/3 + 1/(3 * 1.25/3)
    assert out["ecc"][:3, 0].tolist() == pytest.approx([1.0, 1.5,
                                                        1 / 3 + 0.8])
    # the 30 at k = 20 lies far past (m^2 + 1)/(2k) = 0.25; nothing
    # before it does
    assert out["flag"][:, 0].tolist() == [False] * 19 + [True]
    assert float(st["k"][0]) == 20.0 and float(st["s"][0]) == 60.0


def test_float_matches_float64_oracle_and_chunks():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((300, 7), generator=g, dtype=torch.float64)
    whole, st_w = F.scan(x, F.state0(7, "cpu"), 2.5)
    want = teda_ref(x.numpy(), 2.5)
    np.testing.assert_allclose(whole["ecc"].numpy(), want["ecc"],
                               rtol=1e-12)
    assert np.array_equal(whole["flag"].numpy(), want["outlier"])
    st = F.state0(7, "cpu")
    parts = []
    for a, b in ((0, 1), (1, 64), (64, 300)):
        out, st = F.scan(x[a:b], st, 2.5)
        parts.append(out["ecc"])
    np.testing.assert_allclose(torch.cat(parts).numpy(),
                               whole["ecc"].numpy(), rtol=1e-12)
    for key in ("k", "s", "S"):
        np.testing.assert_allclose(st[key].numpy(), st_w[key].numpy(),
                                   rtol=1e-12)


@pytest.mark.parametrize("ref,kw", [(F, {}), (Q, {"fmt": FMT})])
def test_ragged_rows_freeze(ref, kw):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((40, 6), generator=g) * 2 + 1
    if kw:
        x = torch.round(x * (1 << 20)).to(torch.int32)
    vl = torch.tensor([0, 1, 5, 39, 40, 20], dtype=torch.int32)
    out, st = ref.scan(x, ref.state0(6, "cpu"), 3.0, vl, **kw)
    assert not bool((out["flag"] & ~out["valid"]).any())
    assert st["k"].tolist() == vl.tolist()
    # the state equals a run over the valid prefix alone
    for c, n in enumerate(vl.tolist()):
        _, one = ref.scan(x[:n, c:c + 1], ref.state0(1, "cpu"), 3.0, **kw)
        for key in st:
            assert st[key][c].item() == one[key][0].item()


@pytest.mark.parametrize("t_len,c,seed", [(64, 5, 0), (257, 3, 1)])
def test_q_bit_for_bit_with_oracle(t_len, c, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((t_len, c), generator=g) * 0.3 + 0.8
    x[t_len // 2] += 5.0  # an outlier row
    fmt = QFormat(*FMT)
    words = fmt.quantize(x)
    (k, mean, var), want = teda_q_scan_chan(words, fmt, 3.0)
    out, st = Q.scan(words, Q.state0(c, "cpu"), 3.0, fmt=FMT)
    assert torch.equal(out["ecc"], want["ecc"])
    assert torch.equal(out["flag"], want["outlier"])
    assert torch.equal(st["mean"], mean) and torch.equal(st["var"], var)
    assert st["k"].tolist() == k.tolist()
    # chunked = whole, bit for bit
    st2, parts = Q.state0(c, "cpu"), []
    for a, b in ((0, 10), (10, t_len)):
        o, st2 = Q.scan(words[a:b], st2, 3.0, fmt=FMT)
        parts.append(o["ecc"])
    assert torch.equal(torch.cat(parts), out["ecc"])


def test_q_hand_rows():
    one = 1 << 20
    x = torch.tensor([[one], [2 * one], [3 * one]], dtype=torch.int32)
    out, st = Q.scan(x, Q.state0(1, "cpu"), 3.0, fmt=FMT)
    # k=1: ecc = 1/1 = one; k=2: mean = 1.5, d2 = 0.25, var = 0.125,
    # ecc = 1/2 + (0.25/0.125)/2 = 1.5
    assert out["ecc"][:2, 0].tolist() == [one, 3 * one // 2]
    # k=3: mean = trunc(1.5 * trunc(2/3)) + 3/3 = 2 - 1 LSB (truncation)
    assert st["mean"].tolist() == [2 * one - 1] and st["k"].tolist() == [3]


def test_controls_differ_from_the_reference():
    g = torch.Generator().manual_seed(9)
    x = (torch.randn((600, 8), generator=g) * 0.02 + 0.6)
    ref, _ = F.scan(x, F.state0(8, "cpu"), 3.0)
    ctl, _ = F.control_scan(x, F.control_state0(8, "cpu"), 3.0)
    gap = ((ctl["ecc"].double() - ref["ecc"]).abs() / ref["ecc"]).max()
    assert float(gap) > 1e-2
    w = torch.round(x * (1 << 20)).to(torch.int32)
    qref, _ = Q.scan(w, Q.state0(8, "cpu"), 3.0, fmt=FMT)
    qctl, _ = Q.control_scan(w, Q.control_state0(8, "cpu"), 3.0, fmt=FMT)
    assert int((qctl["ecc"] != qref["ecc"]).sum()) > 0


def test_unresolved_start_is_not_held():
    """Two first samples one float32 unit apart: float32 makes their
    mean the second, so its variance is 0 and its ecc at k = 2 is 1/2,
    where float64 reads 3/2.  float32 cannot resolve that deviation:
    the ecc there is not held (the flags still are); a resolved one
    is."""
    x1 = torch.tensor(1.0, dtype=torch.float32)
    x2 = torch.nextafter(x1, torch.tensor(2.0))
    x = torch.stack([x1, x2, x1 + 0.5]).reshape(3, 1)
    out, _ = F.scan(x, F.state0(1, "cpu"), 3.0)
    assert out["resolved"][:, 0].tolist() == [False, False, True]
    assert float(out["ecc"][1, 0]) == pytest.approx(1.5)
    prog = out["ecc"].clone()
    prog[1, 0] = 0.5  # float32's reading
    gaps = F.Gaps({"ecc_rel_gap": 0.1, "state_rel_gap": 0.1, "k_off": 0,
                   "flag_margin": 0.004, "summary_off_band": 0})
    gaps.outputs(prog, out["flag"], out)
    assert gaps.v["ecc_rel_gap"] == 0.0 and gaps.v["flag_margin"] == 0.0
    prog[2, 0] *= 1.5
    gaps.outputs(prog, out["flag"], out)
    assert gaps.v["ecc_rel_gap"] == pytest.approx(0.5)
