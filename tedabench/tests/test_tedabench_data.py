"""The generator: determinism per seed, the fault windows, Q words."""
import copy
import json

import numpy as np
import pytest
import torch

from tedabench import data
from tedabench.harness import load_json

CFG = load_json("configs", "damadics-fleet-f32")


def ring(seed, c=32, t=64, n_ring=2, faults=None):
    return data.make_ring(CFG["signals"], CFG["faults"] if faults is None
                          else faults, c, t, n_ring, seed, "cpu")


def nominal():
    f = copy.deepcopy(CFG["faults"])
    f["kinds"] = []
    return f


def test_same_seed_same_stream():
    a, b = ring(2 ** 40 + 3), ring(2 ** 40 + 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, ring(2 ** 40 + 4))
    assert a.shape == (2, 64, 32) and a.dtype == torch.float32
    assert bool(a.isfinite().all())


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 1, -5])
def test_fault_windows(seed):
    """Faults change only one window per actuator, of a length within
    the configured range, and leave the nominal signals elsewhere."""
    f = copy.deepcopy(CFG["faults"])
    f["length"] = [4, 40]
    x = ring(seed, c=64, t=64, faults=f).reshape(128, 64)
    base = ring(seed, c=64, t=64, faults=nominal()).reshape(128, 64)
    diff = (x != base)
    for a in range(32):
        rows = torch.nonzero(diff[:, 2 * a] | diff[:, 2 * a + 1])[:, 0]
        if not len(rows):  # a window whose fault moved nothing visible
            continue
        span = int(rows.max() - rows.min()) + 1
        assert span <= 40
        # contiguous: every changed row lies inside one window
        assert int(rows.min()) >= 0 and int(rows.max()) < 128
    changed = int(diff.any(0).sum())
    assert changed >= 32  # most actuators' flow channel moved


def test_nominal_levels():
    """Flow ~1.0 and valve ~0.6 on average, as the configuration says."""
    x = ring(11, c=256, t=1024, faults=nominal()).reshape(-1, 256)
    flow, valve = x[:, 0::2].mean(), x[:, 1::2].mean()
    assert abs(float(flow) - 1.0) < 0.02
    assert abs(float(valve) - 0.6) < 0.02


def test_words():
    x = torch.tensor([0.0, 1.0, -1.5, 1e9, -1e9, 2 ** -21, 3 * 2 ** -21])
    w = data.to_words(x, 32, 20)
    assert w.dtype == torch.int32
    assert w.tolist() == [0, 1 << 20, -(3 << 19), 2 ** 31 - 1,
                          -(2 ** 31 - 1), 0, 2]


def test_sampled_channels():
    s = data.sample_channels(2 ** 40, 65536, 512)
    assert len(np.unique(s)) == 512 and np.all(np.diff(s) > 0)
    assert np.array_equal(s, data.sample_channels(2 ** 40, 65536, 512))
    assert not np.array_equal(s, data.sample_channels(2 ** 40 + 1, 65536,
                                                      512))


def test_ring_vlens():
    assert data.ring_vlens(None, 8, 16, 2, 0, "cpu") is None
    v = data.ring_vlens({"low": 0.5, "high": 1.0}, 64, 16, 3, 5, "cpu")
    assert v.shape == (3, 64) and v.dtype == torch.int32
    assert int(v.min()) >= 8 and int(v.max()) <= 16
    assert json.dumps(CFG["faults"])  # the file is plain JSON
