"""Fleet-scale sharded slot pool: one logical pool over N shards.

`ShardedPool` composes N per-shard `SlotPool`s and adds the three things
a fleet needs that a single pool does not have:

  * **Consistent-hash routing** — `HashRing` maps request ids onto the
    shard set through a ring of virtual nodes (a stable 64-bit content
    hash, never Python's salted `hash()`), so the rid -> shard
    assignment is the same in every process and growing the fleet
    N -> N+1 remaps only ~1/N of the streams
    (`tests/test_torch_sharded.py` pins the remap fraction <= 2/N and
    the assignment to the JAX package's ring).

  * **Live slot migration** — `migrate(rid, dst_shard)` fetches one
    slot's packed state (k / mean / var and the ensemble aux column) as
    raw int32 words in one device-to-host copy, with its per-slot
    sensitivity and detector selection, and writes them word for word
    into a slot acquired on the destination, so a stream continues
    mid-window on another shard with identical verdicts.

  * **Occupancy rebalancing** — `rebalance()` migrates streams from the
    most- to the least-loaded shard until the occupancy spread drops
    under `rebalance_threshold`, skipping rids the caller marks in
    flight (`avoid=`); each move is counted, gauged and published as a
    `shard_migrated` event on the wired `EventBus`.

With `devices=`, the list splits into equal groups, one per shard, and
each shard's engines split their channels over the group
(`StreamEngine(devices=)`); every bucket must then divide by the group
size.  Without `devices=`, the shards share the engines' one device.

Behaviour contract: a K-shard pool is bit-exact with a single pool on
the "cuda-q" path for any routing and any migration schedule —
sharding moves placement, never arithmetic.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.engine.pool import PoolFull, SlotPool
from repro_torch.obs import NULL_TRACER, MetricsRegistry, auto_name

__all__ = ["HashRing", "ShardedPool", "stable_hash"]


def stable_hash(key: str) -> int:
    """64-bit content hash, stable across processes and Python runs
    (PYTHONHASHSEED randomizes `hash()`, which would re-route every
    stream on restart)."""
    digest = hashlib.blake2b(str(key).encode("utf-8"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


class HashRing:
    """Consistent-hash ring: stable key -> shard assignment over vnodes.

    Each shard owns `vnodes` points on a 2^64 ring; a key lands on the
    first point clockwise of its own hash.  Adding a shard steals only
    the arcs its new points cover (~1/N of keys for N+1 shards), so a
    fleet can grow without re-routing the whole stream population.
    """

    def __init__(self, shards: Sequence[int] = (), vnodes: int = 128):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._hashes: List[int] = []   # sorted ring point positions
        self._owners: List[int] = []   # shard owning each point
        self._shards: set = set()
        for s in shards:
            self.add(int(s))

    @property
    def shards(self) -> Tuple[int, ...]:
        return tuple(sorted(self._shards))

    def _points(self, shard: int) -> List[int]:
        return [stable_hash(f"shard:{shard}#vn{v}")
                for v in range(self.vnodes)]

    def add(self, shard: int) -> None:
        if shard in self._shards:
            raise ValueError(f"shard {shard} already on the ring")
        for h in self._points(shard):
            i = bisect.bisect_left(self._hashes, h)
            self._hashes.insert(i, h)
            self._owners.insert(i, shard)
        self._shards.add(shard)

    def remove(self, shard: int) -> None:
        if shard not in self._shards:
            raise ValueError(f"shard {shard} not on the ring")
        keep = [(h, o) for h, o in zip(self._hashes, self._owners)
                if o != shard]
        self._hashes = [h for h, _ in keep]
        self._owners = [o for _, o in keep]
        self._shards.discard(shard)

    def assign(self, key: str) -> int:
        """The shard owning `key` (first ring point clockwise)."""
        if not self._shards:
            raise ValueError("empty ring: no shards to assign to")
        i = bisect.bisect_right(self._hashes, stable_hash(key))
        return self._owners[i % len(self._owners)]


class ShardedPool:
    """One logical slot pool composed of N per-shard `SlotPool`s.

    >>> pool = ShardedPool("cuda-q", shards=4, fmt=fmt)
    >>> shard, slot = pool.acquire("tenant-a", m=2.5)
    >>> out = pool.process_shard(shard, chunk, valid_lens=vlens)
    >>> pool.migrate("tenant-a", dst_shard=2)   # live, bit-exact
    >>> pool.release("tenant-a")

    Slots are addressed by request id: `acquire(rid)` routes through
    the consistent-hash ring (or an explicit `shard=`), records the
    placement, and returns `(shard, local_slot)`.  `PoolFull` raised by
    one shard's bucket ladder is backpressure for the streams routed
    *there*; other shards keep serving untouched.  All engine options
    (`device`, `fmt`, ...) pass through to the per-shard pools.
    """

    def __init__(self, backend: str = "scan", *, shards: int = 2,
                 buckets: Tuple[int, ...] = (8, 16, 32, 64),
                 m: float = 3.0, vnodes: int = 128,
                 devices: Optional[Sequence] = None,
                 rebalance_threshold: int = 2,
                 registry=None, tracer=None, events=None,
                 name: Optional[str] = None, **engine_opts):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if rebalance_threshold < 2:
            # moving a stream across a spread of 1 just flips the
            # imbalance forever; 2 is the smallest stable threshold
            raise ValueError(
                f"rebalance_threshold must be >= 2, got "
                f"{rebalance_threshold}")
        self.n_shards = int(shards)
        self.rebalance_threshold = int(rebalance_threshold)
        self.registry = (MetricsRegistry() if registry is None
                         else registry)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.events = events  # optional EventBus for shard_migrated
        self.name = auto_name("shpool") if name is None else str(name)
        self.ring = HashRing(range(self.n_shards), vnodes=vnodes)
        groups = self._shard_devices(devices, buckets)
        self.pools: List[SlotPool] = []
        for s in range(self.n_shards):
            opts = dict(engine_opts)
            if groups[s] is not None:
                opts.update(devices=groups[s])
            self.pools.append(SlotPool(
                backend, buckets=buckets, m=m, registry=self.registry,
                tracer=self.tracer, name=f"{self.name}/s{s}", **opts))
        self._placement: Dict[str, Tuple[int, int]] = {}
        # streams per shard, kept with the placement: the gauges read it
        # on every acquire / release, where a recount would cost a walk
        # over every placement (quadratic over a gateway run)
        self._occ = [0] * self.n_shards
        lbl = {"pool": self.name}
        self._c_migrations = self.registry.counter(
            "sharded_migrations_total",
            "live slot migrations between shards", ("pool",)).labels(**lbl)
        self._g_imbalance = self.registry.gauge(
            "sharded_imbalance",
            "max-min shard occupancy spread", ("pool",)).labels(**lbl)
        self._f_shard_occ = self.registry.gauge(
            "sharded_shard_occupancy", "attached streams per shard",
            ("pool", "shard"))
        self._g_shard_occ = [
            self._f_shard_occ.labels(pool=self.name, shard=str(s))
            for s in range(self.n_shards)]

    def _shard_devices(self, devices, buckets):
        """Per-shard device groups of equal size (None per shard when no
        devices are pinned)."""
        if devices is None:
            return [None] * self.n_shards
        devices = list(devices)
        if not devices or len(devices) % self.n_shards:
            raise ValueError(
                f"{len(devices)} devices do not split evenly over "
                f"{self.n_shards} shards")
        per = len(devices) // self.n_shards
        bad = [b for b in buckets if b % per]
        if bad:
            raise ValueError(
                f"buckets {bad} not divisible by the {per}-device "
                f"shard group (the channel fan-out needs capacity % "
                f"devices == 0)")
        return [devices[s * per:(s + 1) * per]
                for s in range(self.n_shards)]

    # ------------------------------------------------------- topology
    def route(self, rid: str) -> int:
        """The shard the consistent-hash ring assigns to `rid`."""
        return self.ring.assign(rid)

    def lookup(self, rid: str) -> Tuple[int, int]:
        """Current placement of a live stream: (shard, local slot)."""
        try:
            return self._placement[rid]
        except KeyError:
            raise KeyError(f"unknown stream {rid!r}") from None

    @property
    def engine(self):
        """Shard 0's live engine (backend/introspection reference —
        every shard runs the identical backend configuration)."""
        return self.pools[0].engine

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self.pools)

    @property
    def max_capacity(self) -> int:
        return sum(p.max_capacity for p in self.pools)

    @property
    def occupancy(self) -> int:
        return len(self._placement)

    def shard_capacity(self, shard: int) -> int:
        return self.pools[shard].capacity

    def shard_free(self, shard: int) -> int:
        """Slots still acquirable on one shard (down its bucket ladder)."""
        p = self.pools[shard]
        return p.max_capacity - p.occupancy

    def occupancies(self) -> List[int]:
        return list(self._occ)

    @property
    def imbalance(self) -> int:
        occ = self.occupancies()
        return max(occ) - min(occ)

    def _update_gauges(self) -> None:
        occ = self._occ
        for s, g in enumerate(self._g_shard_occ):
            g.set(occ[s])
        self._g_imbalance.set(max(occ) - min(occ))

    # -------------------------------------------------------- tenancy
    def acquire(self, rid: str, *, m: Optional[float] = None,
                shard: Optional[int] = None, detectors=None,
                vote=None) -> Tuple[int, int]:
        """Attach `rid` on its routed shard; returns (shard, slot).

        `shard=` overrides the ring (explicit placement — tests and
        the rebalancer use it).  `PoolFull` from the target shard's
        bucket ladder propagates with the shard named: backpressure
        for streams routed there, invisible to the other shards.
        """
        if rid in self._placement:
            raise ValueError(f"stream {rid!r} already attached at "
                             f"{self._placement[rid]}")
        s = self.route(rid) if shard is None else int(shard)
        if not 0 <= s < self.n_shards:
            raise ValueError(f"shard {s} out of range "
                             f"[0, {self.n_shards})")
        try:
            slot = int(self.pools[s].acquire(
                1, m=m, detectors=detectors, vote=vote)[0])
        except PoolFull as e:
            raise PoolFull(f"shard {s}: {e}", e.occupancy,
                           e.capacity) from None
        self._placement[rid] = (s, slot)
        self._occ[s] += 1
        self._update_gauges()
        return s, slot

    def release(self, rid: str) -> None:
        s, slot = self.lookup(rid)
        del self._placement[rid]
        self._occ[s] -= 1
        self.pools[s].release([slot])
        self._update_gauges()

    # ----------------------------------------------------- processing
    def process_shard(self, shard: int, x, active=None,
                      valid_lens=None) -> dict:
        """Feed one (T, shard_capacity(shard)) chunk to one shard.

        Per-shard calls are independent and do not synchronize — a
        scheduler ticks every shard without a barrier between them
        (`launch/batching.py` keeps each shard's call fenced exactly
        like a single pool's).
        """
        return self.pools[shard].process(x, active=active,
                                         valid_lens=valid_lens)

    # ------------------------------------------------------ migration
    def migrate(self, rid: str, dst_shard: int, *, tick: int = 0) -> int:
        """Move a live stream to `dst_shard` bit-exactly; returns its
        new local slot.

        The slot's packed state (k / mean / var and the ensemble aux
        column) is fetched as int32 words — one device-to-host copy of
        that slot alone, a sync that waits for the source engine's calls
        in flight — and written word for word into a freshly acquired
        destination slot, with the per-slot sensitivity and, under the
        ensemble backend, the member weights and vote threshold.  No
        value passes through arithmetic: Q bits, float32 words and aux
        payloads that alias NaN patterns arrive as they left.  The
        destination engine's device copy of the detector rows is dropped
        so that its next call uploads the moved column.  The destination
        is acquired *before* the source releases: a full destination
        raises `PoolFull` and leaves the stream in place.  The caller
        keeps in-flight calls off the migrating stream (the scheduler's
        `avoid` set).
        """
        src_s, slot = self.lookup(rid)
        dst_shard = int(dst_shard)
        if not 0 <= dst_shard < self.n_shards:
            raise ValueError(f"shard {dst_shard} out of range "
                             f"[0, {self.n_shards})")
        if dst_shard == src_s:
            return slot
        src_pool, dst_pool = self.pools[src_s], self.pools[dst_shard]
        eng = src_pool.engine
        words = eng._slot_words(slot)
        m_val = eng._m[slot]
        ens = eng._ensemble
        det_w = eng._det_w[:, slot].copy() if ens else None
        det_thr = eng._det_thr[slot] if ens else None

        try:
            new_slot = int(dst_pool.acquire(1)[0])
        except PoolFull as e:
            raise PoolFull(f"migration target shard {dst_shard}: {e}",
                           e.occupancy, e.capacity) from None
        deng = dst_pool.engine
        deng._put_slot_words(new_slot, words)
        deng._m[new_slot] = m_val
        if ens:
            deng._det_w[:, new_slot] = det_w
            deng._det_thr[new_slot] = det_thr
            deng._det_dev = None
        src_pool.release([slot])
        self._placement[rid] = (dst_shard, new_slot)
        self._occ[src_s] -= 1
        self._occ[dst_shard] += 1
        self._c_migrations.inc()
        self._update_gauges()
        if self.tracer.enabled:
            self.tracer.instant("shard.migrate", pool=self.name,
                                rid=rid, src=src_s, dst=dst_shard,
                                slot=new_slot)
        if self.events is not None:
            self.events.publish("shard_migrated", tick, rid,
                                src=src_s, dst=dst_shard, slot=new_slot)
        return new_slot

    def rebalance(self, *, avoid=(), max_moves: Optional[int] = None,
                  tick: int = 0) -> List[Tuple[str, int, int, int]]:
        """Migrate streams hottest-shard -> coldest-shard until the
        occupancy spread drops under `rebalance_threshold`.

        `avoid` names rids that must not move (the scheduler passes
        streams with in-flight calls — migration's state fetch must
        not race a dispatched chunk).  Candidate choice is
        deterministic (lexicographically smallest movable rid on the
        hottest shard), so a fixed workload produces a fixed migration
        schedule.  Returns the executed moves as
        (rid, src_shard, dst_shard, new_slot).
        """
        avoid = set(avoid)
        moves: List[Tuple[str, int, int, int]] = []
        if self.n_shards < 2:
            return moves
        while max_moves is None or len(moves) < max_moves:
            occ = self.occupancies()
            hi = max(range(self.n_shards), key=lambda s: (occ[s], s))
            lo = min(range(self.n_shards), key=lambda s: (occ[s], s))
            if occ[hi] - occ[lo] < self.rebalance_threshold:
                break
            rid = min((r for r, (s, _) in self._placement.items()
                       if s == hi and r not in avoid), default=None)
            if rid is None:
                break  # everything movable is in flight: next tick
            try:
                slot = self.migrate(rid, lo, tick=tick)
            except PoolFull:
                break  # cold shard's ladder is full at this bucket mix
            moves.append((rid, hi, lo, slot))
        return moves

    # -------------------------------------------------- introspection
    @property
    def migrations(self) -> int:
        return int(self._c_migrations.value)

    def programs(self) -> list:
        """Union of every shard's (capacity, T) program-shape keys —
        flat after warmup means no shard adds a shape per tick."""
        return sorted({key for p in self.pools for key in p.programs()})

    def stats(self) -> dict:
        occ = self.occupancies()
        return {"shards": self.n_shards, "occupancy": self.occupancy,
                "shard_occupancy": occ,
                "imbalance": max(occ) - min(occ),
                "migrations": self.migrations,
                "resizes": sum(p.resizes for p in self.pools),
                "programs": self.programs(),
                "per_shard": [p.stats() for p in self.pools]}
