"""The port's data pipeline against the JAX package's, on the CPU.

`TokenStream` batches are bit-equal for every (seed, step) tried,
deterministic corruption included; `batch_stats` is equal; the
`PrefetchIterator` screen (the port's guard on the CPU) drops the same
batches as the reference's.  The DAMADICS-like fault streams
(`make_benchmark`) and their detection report are bit-equal.
"""
import numpy as np
import pytest

from repro.core.guard import GuardConfig as JGuardConfig
from repro.data import PrefetchIterator as JPrefetch
from repro.data import TokenStream as JTokenStream
from repro.data import batch_stats as jbatch_stats
from repro.data import damadics as jdam
from repro_torch.core import GuardConfig
from repro_torch.data import (TABLE2, PrefetchIterator, TokenStream,
                              batch_stats, detection_report, make_benchmark)


@pytest.mark.parametrize("seed,vocab,corrupt_every,corrupt_prob", [
    (0, 512, 0, 0.0), (3, 1000, 5, 0.0), (7, 32768, 0, 0.3),
    (11, 128256, 10, 0.0)])
def test_token_batches_bit_equal(seed, vocab, corrupt_every, corrupt_prob):
    kw = dict(seed=seed, corrupt_every=corrupt_every,
              corrupt_prob=corrupt_prob)
    ours, ref = TokenStream(vocab, 4, 32, **kw), JTokenStream(vocab, 4, 32,
                                                              **kw)
    for step in (0, 1, 5, 10, 17, 20, 1234):
        a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(batch_stats({"tokens": a}),
                                      jbatch_stats({"tokens": b}))
    first = next(iter(ours))["tokens"]
    np.testing.assert_array_equal(first, ref.batch_at(0)["tokens"])
    if corrupt_every:
        assert (ours.batch_at(corrupt_every)["tokens"] == vocab - 1).all()


def _screened(cls, cfg_cls, n=40):
    src = (TokenStream(100, 2, 16, corrupt_every=10).batch_at(i)
           for i in range(n))
    it = cls(src, depth=2, screen=cfg_cls(m=3.0, warmup_steps=6,
                                          channels=2))
    batches = list(it)
    it.close()
    return it.dropped, [b["tokens"] for b in batches]


def test_prefetch_screen_drops_what_the_reference_drops():
    dropped, kept = _screened(PrefetchIterator, GuardConfig)
    jdropped, jkept = _screened(JPrefetch, JGuardConfig)
    assert dropped == jdropped >= 3
    assert len(kept) == len(jkept)
    for a, b in zip(kept, jkept):
        np.testing.assert_array_equal(a, b)
    assert all(not (t == 99).all() for t in kept)


def test_prefetch_without_screen_and_close():
    it = PrefetchIterator(iter(TokenStream(50, 1, 4)), depth=2)
    got = [next(it)["tokens"] for _ in range(3)]
    it.close()
    assert not it._thread.is_alive()
    np.testing.assert_array_equal(got[2], TokenStream(50, 1, 4).batch_at(2)
                                  ["tokens"])


@pytest.mark.parametrize("item", range(len(TABLE2)))
def test_damadics_bit_equal(item):
    x, w = make_benchmark(item, t_len=60000, seed=1)
    jx, jw = jdam.make_benchmark(item, t_len=60000, seed=1)
    assert tuple(w) == tuple(jw)
    np.testing.assert_array_equal(x, jx)
    flags = np.abs(x[:, 0] - np.median(x[:, 0])) > 0.3
    assert detection_report(flags, w) == jdam.detection_report(flags, jw)
