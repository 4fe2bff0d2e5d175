"""Deterministic synthetic data pipeline with TEDA screening + prefetch.

`TokenStream` yields LM batches (B, S+1) from a seeded Markov-ish zipfian
sampler — fully reproducible across restarts (the stream is indexable by
step, so checkpoint-resume replays exactly). `corrupt_prob` injects
anomalous batches (token-id saturation bursts) to exercise the TEDA
guard end-to-end.

`PrefetchIterator` runs the generator in a background thread with a
bounded queue (host-side input pipelining) and can screen per-batch
statistics with a TEDA state, dropping flagged batches before they reach
the device — the paper's detector as a data-quality gate.  The screen
runs the guard on the CPU: its state is three scalars per channel, and a
host-side gate must not wait on the card.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np

import torch

from repro_torch.core.guard import GuardConfig, guard_init, guard_step


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 corrupt_prob: float = 0.0, corrupt_every: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.corrupt_prob = corrupt_prob
        self.corrupt_every = corrupt_every  # deterministic corruption

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # zipf-distributed ids with short-range repetition structure
        raw = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (raw % self.vocab).astype(np.int32)
        rep = rng.random((self.batch, self.seq + 1)) < 0.25
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        corrupt = (self.corrupt_prob and rng.random() < self.corrupt_prob)
        if self.corrupt_every and step and step % self.corrupt_every == 0:
            corrupt = True
        if corrupt:
            toks[:] = self.vocab - 1  # saturated garbage batch
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_stats(batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Telemetry vector for TEDA screening: [mean_id, unique_frac]."""
    t = batch["tokens"]
    return np.asarray([float(t.mean()),
                       len(np.unique(t)) / t.size], np.float32)


class PrefetchIterator:
    def __init__(self, source, depth: int = 2,
                 screen: Optional[GuardConfig] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = iter(source)
        self._screen_cfg = screen
        self._gs = guard_init(screen, device="cpu") if screen \
            else None
        self.dropped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._src:
                if self._stop.is_set():
                    return
                if self._screen_cfg is not None:
                    stats = torch.from_numpy(batch_stats(item))
                    self._gs, verdict = guard_step(self._gs, stats,
                                                   self._screen_cfg)
                    if bool(verdict.skip):
                        self.dropped += 1
                        continue
                if not self._put(item):
                    return
        finally:
            self._put(None)  # sentinel (skipped when closing)

    def _put(self, item) -> bool:
        """Bounded put that aborts when the iterator is closing.

        A plain `Queue.put` on a full queue would block the daemon
        thread forever once the consumer stops draining; polling the
        stop event keeps `close()` able to finish the worker.
        """
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        # poll the stop event: a consumer already blocked here must wake
        # when close() is called from another thread (after close, the
        # producer drops items and the sentinel instead of enqueueing)
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is None:
                raise StopIteration
            return item

    def close(self, timeout: float = 2.0):
        """Stop the worker, unblock it if it sits on a full queue, join
        it, and drain leftovers (incl. the sentinel) so no daemon thread
        or queued batch outlives the iterator.

        Bounded by `timeout`: a worker stuck inside the *source*
        iterator (e.g. a blocking socket read) cannot observe the stop
        event; after the deadline the daemon thread is abandoned rather
        than hanging the caller.
        """
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:  # make room so a blocked producer can observe the stop
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
