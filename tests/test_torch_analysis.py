"""The port's word-length sweep against the JAX package's, on the CPU.

`evaluate_format` and `wordlength_sweep` get the same seeded (T, N)
stream as the JAX package's: every field of every result dict is equal
(the Q datapath is bit-exact and the oracle is float64 on both sides),
and `DEFAULT_FORMATS` lists the same formats.
"""
import numpy as np
import pytest

from repro.fixedpoint import QFormat as JQ
from repro.fixedpoint.analysis import DEFAULT_FORMATS as J_FORMATS
from repro.fixedpoint.analysis import evaluate_format as j_evaluate
from repro.fixedpoint.analysis import wordlength_sweep as j_sweep
from repro_torch.fixedpoint import (DEFAULT_FORMATS, QFormat,
                                    evaluate_format, wordlength_sweep)


def _stream(t=160, n=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, n)).astype(np.float32)
    x[t // 2] += 9.0
    x[t // 3, 0] -= 7.0
    return x


def test_default_formats_equal_reference():
    assert [(f.word_len, f.frac_len, f.rounding) for f in DEFAULT_FORMATS] \
        == [(f.word_len, f.frac_len, f.rounding) for f in J_FORMATS]


@pytest.mark.parametrize("spec", [(16, 8, "round"), (24, 16, "trunc"),
                                  (32, 20, "round")])
def test_evaluate_format_equals_reference(spec):
    x = _stream(seed=sum(spec[:2]))
    mine = evaluate_format(x, QFormat(*spec), m=2.5)
    ref = j_evaluate(x, JQ(*spec), m=2.5)
    assert mine == ref
    assert mine["n_outliers_ref"] > 0


def test_wordlength_sweep_equals_reference():
    x = _stream(t=96, n=2, seed=4)
    formats = [(16, 10), (32, 16)]
    mine = wordlength_sweep(x, [QFormat(*f) for f in formats])
    ref = j_sweep(x, [JQ(*f) for f in formats])
    assert mine == ref and len(mine) == 2
