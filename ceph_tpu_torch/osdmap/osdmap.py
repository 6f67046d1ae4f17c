"""OSDMap: the versioned cluster map and its placement pipeline.

Counterpart of ``ceph_tpu/osdmap/osdmap.py``, a behavioral mirror of
reference src/osd/OSDMap.{h,cc} and pg_pool_t
(src/osd/osd_types.cc:1395-1423): pg -> pps seeding (stable_mod +
rjenkins1), CRUSH raw placement (_pg_to_raw_osds, OSDMap.cc:1861),
pg_upmap/pg_upmap_items overrides (:1891-1934), up-set filtering (:1937),
primary affinity (:1962+), pg_temp/primary_temp (:2010), and the full
_pg_to_up_acting_osds chain (:2079).

Two execution paths share the same semantics:
- per-PG scalar (ScalarMapper) — the oracle and control-plane path;
- whole-pool batched (TensorMapper) — every PG of a pool as batched
  torch ops on the OSDMap's device (CUDA unless the caller names the
  CPU), with the sparse host-side post-passes vectorized in numpy.  The
  public results are numpy arrays, as the reference's are.

A map given a ``placements`` cache (``set_device``) looks a pool's raw
placement up there by every input of it before computing it, so copies
of one map that share the cache place each pool once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import hashlib
import logging
import pickle

import numpy as np

from ceph_tpu_torch.crush import CrushMap, ScalarMapper
from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.ops import jenkins

CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000

POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """reference src/include/ceph_hash.h ceph_stable_mod."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _calc_mask(n: int) -> int:
    return (1 << max(n - 1, 1).bit_length()) - 1


@dataclass(frozen=True, order=True)
class PGid:
    pool: int
    seed: int

    def __str__(self):
        return f"{self.pool}.{self.seed:x}"


@dataclass
class PGPool:
    """pg_pool_t subset (reference src/osd/osd_types.h)."""

    pool_id: int
    type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 32
    crush_rule: int = 0
    hashpspool: bool = True
    ec_profile: Dict[str, str] = field(default_factory=dict)
    name: str = ""
    # snapshot state (reference pg_pool_t snap fields): snap_seq is the
    # pool-wide snap id allocator; snaps maps POOL snap ids to names
    # (selfmanaged snaps draw ids from the same allocator but are tracked
    # by the client, e.g. RBD); removed_snaps drive OSD snap trimming
    snap_seq: int = 0
    snaps: Dict[int, str] = field(default_factory=dict)
    removed_snaps: Tuple[int, ...] = ()
    # cache tiering (reference pg_pool_t tier fields, osd_types.h:1323-28
    # + cache_mode_t :1235): ``tiers`` lists cache pools over this base;
    # ``tier_of`` points a cache pool at its base; read/write_tier are
    # the objecter overlay redirect targets on the BASE pool
    tiers: Tuple[int, ...] = ()
    tier_of: int = -1
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = "none"   # none|writeback|readproxy|forward
    hit_set_count: int = 4
    hit_set_period: float = 30.0
    hit_set_fpp: float = 0.05
    target_max_objects: int = 0   # agent evict trigger (0 = unbounded)
    cache_target_dirty_ratio: float = 0.4

    @property
    def pg_num_mask(self) -> int:
        return _calc_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return _calc_mask(self.pgp_num)

    def snap_context(self) -> Tuple[int, Tuple[int, ...]]:
        """(seq, existent POOL snaps descending) — the SnapContext writes
        carry by default on a pool-snapshotted pool."""
        return (self.snap_seq,
                tuple(sorted(self.snaps.keys(), reverse=True)))

    def can_shift_osds(self) -> bool:
        return self.type == POOL_TYPE_REPLICATED

    def is_tier(self) -> bool:
        return self.tier_of >= 0

    def has_read_tier(self) -> bool:
        return self.read_tier >= 0

    def has_write_tier(self) -> bool:
        return self.write_tier >= 0

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def raw_pg_to_pg(self, seed: int) -> int:
        return ceph_stable_mod(seed, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, seed: int) -> int:
        if self.hashpspool:
            return int(jenkins.hash2(
                ceph_stable_mod(seed, self.pgp_num, self.pgp_num_mask),
                self.pool_id))
        return ceph_stable_mod(seed, self.pgp_num, self.pgp_num_mask) \
            + self.pool_id

    def raw_pg_to_pps_batch(self, seeds: np.ndarray) -> np.ndarray:
        mask = np.uint32(self.pgp_num_mask)
        half = mask >> np.uint32(1)
        m = seeds.astype(np.uint32) & mask
        stable = np.where(m < self.pgp_num, m, seeds.astype(np.uint32) & half)
        if self.hashpspool:
            return jenkins.hash2(
                stable.astype(np.uint64),
                np.uint64(self.pool_id)).astype(np.uint32)
        return stable + np.uint32(self.pool_id)


@dataclass
class Incremental:
    """Map delta producing epoch ``epoch`` from ``epoch - 1`` (reference
    OSDMap::Incremental, src/osd/OSDMap.h): the mon ships these instead of
    re-serializing the world on every change; consumers apply them in
    order."""

    epoch: int
    new_up: Dict[int, object] = field(default_factory=dict)  # osd -> addr
    new_down: List[int] = field(default_factory=list)
    new_weights: Dict[int, int] = field(default_factory=dict)
    new_pools: Dict[int, "PGPool"] = field(default_factory=dict)
    new_rules: List[object] = field(default_factory=list)  # appended in order
    new_pg_temp: Dict["PGid", List[int]] = field(default_factory=dict)
    # balancer-committed explicit remap pairs (reference
    # OSDMap::Incremental new_pg_upmap_items): pg -> [(from, to), ...];
    # an EMPTY list clears the pg's entry (like new_pg_temp)
    new_pg_upmap_items: Dict["PGid", List[Tuple[int, int]]] = \
        field(default_factory=dict)
    new_primary_temp: Dict["PGid", int] = field(default_factory=dict)
    new_primary_affinity: Dict[int, int] = field(default_factory=dict)
    new_mgr_addr: object = None  # mgr registration (reference MgrMap)
    new_mds_addr: object = None  # active rank-0 MDS (MDSMap-lite)
    new_mds_addrs: Dict[int, object] = field(default_factory=dict)
    new_revoked: Tuple[str, ...] = ()  # cephx entities to revoke
    old_pools: Tuple[int, ...] = ()    # pool deletions
    # cluster flag transitions (reference CEPH_OSDMAP_FULL /
    # NEARFULL / BACKFILLFULL): flag name -> set (True) / clear (False).
    # The mon's full-ratio tick commits these from beacon statfs; OSDs
    # enforce them (ENOSPC on client writes under "full", backfill
    # deferred under "backfillfull").
    new_flags: Dict[str, bool] = field(default_factory=dict)
    # cluster-log events riding the same Paxos stream (the reference's
    # LogMonitor is likewise a PaxosService on the shared paxos); the
    # OSDMap itself ignores them — the mon's log service consumes them
    new_log_entries: Tuple = ()        # of (who, stamp, prio, msg)
    # elastic reshape (reference OSDMap::Incremental
    # new_max_osd + full-crush replacement): grow extends the id space
    # and ships the new device-bearing host buckets; purge retires ids.
    # The crush delta rides as data, not a pickled CrushMap — every
    # consumer applies the same mutation to ITS crush copy.
    new_max_osd: int = 0               # 0 = unchanged
    # of (host_name, (osd ids...), (16.16 weights...), root_name)
    new_crush_hosts: Tuple = ()
    old_osds: Tuple[int, ...] = ()     # purged ids (exists -> False)


class OSDMap:
    def __init__(self, crush: CrushMap, max_osd: int = 0, device=None):
        self.epoch = 1
        # where the batched placement runs: CUDA unless the caller names
        # the CPU (resolved when the mapper is built, so a map can be
        # made and read through the scalar chain on any host)
        self.device = device
        # raw placements shared with other copies of this map (get/put
        # by ``_raw_key``), or None; never pickled
        self.placements = None
        # whole pools mapped by the scalar oracle because the map's shape
        # rules the batched mapper out (legacy tunables, non-straw2
        # buckets, sparse bucket ids)
        self.scalar_fallbacks = 0
        self.crush = crush
        self.max_osd = max_osd or crush.max_devices
        self.osd_exists = [True] * self.max_osd
        self.osd_up = [True] * self.max_osd
        self.osd_weight = [0x10000] * self.max_osd  # in/out weight
        self.mgr_addr = None  # active mgr (reference MgrMap active addr)
        self.mds_addr = None  # active rank-0 MDS (MDSMap-lite, beacons)
        # multi-active MDS ranks (reference MDSMap mds_info): rank -> addr
        self.mds_addrs = {}
        # cephx entities refused ticket issuance (replicated through
        # Paxos like every map mutation, so revocation survives mon
        # failover AND restarts via the persisted map)
        self.revoked_entities: set = set()
        # cluster flags: "nearfull" | "backfillfull" |
        # "full", committed by the mon's full-ratio tick and enforced
        # by every OSD from its own map copy
        self.flags: set = set()
        self.osd_primary_affinity: Optional[List[int]] = None
        self.pools: Dict[int, PGPool] = {}
        self.pg_upmap: Dict[PGid, List[int]] = {}
        self.pg_upmap_items: Dict[PGid, List[Tuple[int, int]]] = {}
        self.pg_temp: Dict[PGid, List[int]] = {}
        self.primary_temp: Dict[PGid, int] = {}
        self._scalar = ScalarMapper(crush)
        self._tensor = None
        self.osd_addrs: Dict[int, object] = {}

    def set_device(self, device, placements=None) -> "OSDMap":
        """Put this map's batched placement on ``device``: a map that
        arrived pickled carries its sender's device, and a mapper built
        on another device is dropped (rebuilt here when next used).
        ``placements``: a cache of raw placements this map shares with
        other copies of it (an object with ``get(key)`` and
        ``put(key, value)``), or None."""
        self.device = device
        self.placements = placements
        if getattr(self._tensor, "device", device) != device:
            self._tensor = None
        return self

    def invalidate_mappers(self) -> None:
        """Call after mutating the CRUSH map (rules/buckets)."""
        self._scalar = ScalarMapper(self.crush)
        self._tensor = None

    # pickling: mappers hold device tensors; rebuild lazily on the far side
    def __getstate__(self):
        d = dict(self.__dict__)
        d["_scalar"] = None
        d["_tensor"] = None
        d["placements"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.__dict__.setdefault("flags", set())
        self.__dict__.setdefault("device", None)
        self.__dict__.setdefault("scalar_fallbacks", 0)
        self.__dict__.setdefault("placements", None)
        self._scalar = ScalarMapper(self.crush)
        self._tensor = None

    # -- state helpers -----------------------------------------------------

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and self.osd_exists[osd]

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_up[osd]

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_out(self, osd: int) -> bool:
        return not self.exists(osd) or self.osd_weight[osd] == 0

    def mark_down(self, osd: int) -> None:
        self.osd_up[osd] = False
        self.epoch += 1

    def mark_up(self, osd: int) -> None:
        self.osd_up[osd] = True
        self.epoch += 1

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0
        self.epoch += 1

    def mark_in(self, osd: int, weight: int = 0x10000) -> None:
        self.osd_weight[osd] = weight
        self.epoch += 1

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = \
                [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * self.max_osd
        self.osd_primary_affinity[osd] = aff
        self.epoch += 1

    def add_pool(self, pool: PGPool) -> None:
        self.pools[pool.pool_id] = pool
        self.epoch += 1

    def apply_incremental(self, inc: Incremental) -> None:
        """Advance this map by one epoch delta (reference
        OSDMap::apply_incremental, src/osd/OSDMap.cc)."""
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental {inc.epoch} does not follow epoch {self.epoch}")
        # id-space growth FIRST: later fields of the same inc may
        # reference the new ids (a grow inc carries crush hosts whose
        # devices sit past the old max_osd)
        new_max = getattr(inc, "new_max_osd", 0)
        if new_max > self.max_osd:
            grown = new_max - self.max_osd
            self.osd_exists.extend([True] * grown)
            # new ids boot "down" until they report in (the vstart rule)
            self.osd_up.extend([False] * grown)
            self.osd_weight.extend([0x10000] * grown)
            if self.osd_primary_affinity is not None:
                self.osd_primary_affinity.extend(
                    [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * grown)
            self.max_osd = new_max
        crush_dirty = False
        for host in getattr(inc, "new_crush_hosts", ()):
            hname, devs, weights, root = host
            self.crush.add_host(hname, list(devs), list(weights),
                                root=root)
            crush_dirty = True
        for osd in getattr(inc, "old_osds", ()):
            if 0 <= osd < self.max_osd:
                self.osd_exists[osd] = False
                self.osd_up[osd] = False
                self.osd_weight[osd] = 0
                self.osd_addrs.pop(osd, None)
                if self.crush.remove_device(osd):
                    crush_dirty = True
                # explicit mappings naming a retired id die with it
                # (reference OSDMap::maybe_remove_pg_upmaps)
                for pg in [p for p, v in self.pg_upmap.items()
                           if osd in v]:
                    del self.pg_upmap[pg]
                for pg in [p for p, v in self.pg_upmap_items.items()
                           if any(osd in pair for pair in v)]:
                    del self.pg_upmap_items[pg]
                for pg in [p for p, v in self.pg_temp.items()
                           if osd in v]:
                    del self.pg_temp[pg]
                for pg in [p for p, v in self.primary_temp.items()
                           if v == osd]:
                    del self.primary_temp[pg]
        if crush_dirty:
            self.invalidate_mappers()
        for osd, addr in inc.new_up.items():
            if 0 <= osd < self.max_osd:
                self.osd_up[osd] = True
                if addr is not None:
                    self.osd_addrs[osd] = tuple(addr)
        for osd in inc.new_down:
            if 0 <= osd < self.max_osd:
                self.osd_up[osd] = False
        for osd, w in inc.new_weights.items():
            if 0 <= osd < self.max_osd:
                self.osd_weight[osd] = w
        for osd, aff in inc.new_primary_affinity.items():
            self.set_primary_affinity(osd, aff)
        if inc.new_mgr_addr is not None:
            self.mgr_addr = tuple(inc.new_mgr_addr)
        if inc.new_mds_addr is not None:
            self.mds_addr = tuple(inc.new_mds_addr)
            self.mds_addrs[0] = tuple(inc.new_mds_addr)
        for r, a in getattr(inc, "new_mds_addrs", {}).items():
            self.mds_addrs[r] = tuple(a)
            if r == 0:
                self.mds_addr = tuple(a)
        if inc.new_revoked:
            self.revoked_entities |= set(inc.new_revoked)
        for flag, on in getattr(inc, "new_flags", {}).items():
            if on:
                self.flags.add(flag)
            else:
                self.flags.discard(flag)
        for pg, temp in inc.new_pg_temp.items():
            if temp:
                self.pg_temp[pg] = list(temp)
            else:
                self.pg_temp.pop(pg, None)
        for pg, pairs in getattr(inc, "new_pg_upmap_items", {}).items():
            if pairs:
                self.pg_upmap_items[pg] = [tuple(p) for p in pairs]
            else:
                self.pg_upmap_items.pop(pg, None)
        for pg, tp in inc.new_primary_temp.items():
            if tp >= 0:
                self.primary_temp[pg] = tp
            else:
                self.primary_temp.pop(pg, None)
        if inc.new_rules:
            for rule in inc.new_rules:
                self.crush.add_rule(rule)
            self.invalidate_mappers()
        for pool_id, pool in inc.new_pools.items():
            self.pools[pool_id] = pool
        for pool_id in inc.old_pools:
            self.pools.pop(pool_id, None)
            for pg in [p for p in self.pg_upmap if p.pool == pool_id]:
                del self.pg_upmap[pg]
            for pg in [p for p in self.pg_upmap_items
                       if p.pool == pool_id]:
                del self.pg_upmap_items[pg]
            for pg in [p for p in self.pg_temp if p.pool == pool_id]:
                del self.pg_temp[pg]
            for pg in [p for p in self.primary_temp
                       if p.pool == pool_id]:
                del self.primary_temp[pg]
        self.epoch = inc.epoch

    @property
    def tensor_mapper(self):
        """The batched mapper on this map's device.  Raises
        NotImplementedError for map shapes it cannot run, and
        RuntimeError when the device is CUDA and there is none."""
        if self._tensor is None:
            try:
                self._tensor = TensorMapper(self.crush, device=self.device)
            except NotImplementedError as e:
                # cache the rejection so every pool_mapping call does not
                # retry construction against an unsupported map
                self._tensor = e
        if isinstance(self._tensor, Exception):
            raise self._tensor
        return self._tensor

    # -- placement pipeline (scalar) ---------------------------------------

    def _pg_to_raw_osds(self, pool: PGPool, pgid: PGid) -> Tuple[List[int], int]:
        pps = pool.raw_pg_to_pps(pgid.seed)
        raw = self._scalar.do_rule(pool.crush_rule, pps, pool.size,
                                   self.osd_weight)
        raw = self._remove_nonexistent(pool, raw)
        return raw, pps

    def _remove_nonexistent(self, pool: PGPool, raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw if o == CRUSH_ITEM_NONE or self.exists(o)]
        return [o if o == CRUSH_ITEM_NONE or self.exists(o) else
                CRUSH_ITEM_NONE for o in raw]

    def _apply_upmap(self, pool: PGPool, pgid: PGid, raw: List[int]) -> List[int]:
        pg = PGid(pgid.pool, pool.raw_pg_to_pg(pgid.seed))
        um = self.pg_upmap.get(pg)
        if um is not None:
            if any(o != CRUSH_ITEM_NONE and 0 <= o < self.max_osd
                   and self.osd_weight[o] == 0 for o in um):
                # a target is marked out: reject the explicit mapping and,
                # like the reference (OSDMap.cc:1899), skip pg_upmap_items too
                return raw
            raw = list(um)
        for src, dst in self.pg_upmap_items.get(pg, []):
            exists_already = False
            pos = -1
            for i, o in enumerate(raw):
                if o == dst:
                    exists_already = True
                    break
                if o == src and pos < 0 and not (
                        dst != CRUSH_ITEM_NONE and 0 <= dst < self.max_osd
                        and self.osd_weight[dst] == 0):
                    pos = i
            if not exists_already and pos >= 0:
                raw[pos] = dst
        return raw

    def _raw_to_up(self, pool: PGPool, raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw
                    if o != CRUSH_ITEM_NONE and not self.is_down(o)]
        return [CRUSH_ITEM_NONE if o == CRUSH_ITEM_NONE or self.is_down(o)
                else o for o in raw]

    @staticmethod
    def _pick_primary(osds: List[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, pps: int, pool: PGPool,
                                osds: List[int], primary: int) -> Tuple[List[int], int]:
        aff = self.osd_primary_affinity
        if aff is None:
            return osds, primary
        if not any(o != CRUSH_ITEM_NONE
                   and aff[o] != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
                   for o in osds):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if a < CEPH_OSD_MAX_PRIMARY_AFFINITY and \
                    (int(jenkins.hash2(pps, o)) >> 16) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1 :]
        return osds, primary

    def _get_temp_osds(self, pool: PGPool, pgid: PGid) -> Tuple[List[int], int]:
        pg = PGid(pgid.pool, pool.raw_pg_to_pg(pgid.seed))
        temp = []
        for o in self.pg_temp.get(pg, []):
            if not self.exists(o) or self.is_down(o):
                if pool.can_shift_osds():
                    continue
                temp.append(CRUSH_ITEM_NONE)
            else:
                temp.append(o)
        tp = self.primary_temp.get(pg, -1)
        if tp == -1 and temp:
            tp = self._pick_primary(temp)
        return temp, tp

    def pg_to_up_acting_osds(self, pgid: PGid):
        """Returns (up, up_primary, acting, acting_primary) — reference
        _pg_to_up_acting_osds (OSDMap.cc:2079)."""
        pool = self.pools.get(pgid.pool)
        if pool is None or pgid.seed >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pgid)
        raw, pps = self._pg_to_raw_osds(pool, pgid)
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(pps, pool, up, up_primary)
        if not acting:
            acting = up
            # the up_primary fallback happens only inside the empty-acting
            # branch, so a standalone primary_temp (no pg_temp) survives and
            # an all-down pg_temp keeps acting_primary == -1 (reference
            # _pg_to_up_acting_osds, OSDMap.cc:2110-2116)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def pg_raw_up(self, pgid: PGid) -> List[int]:
        """Down-BLIND placement: raw CRUSH + upmap, existence-filtered
        but never up-filtered.  This is "where the map says the data
        belongs" — the mon's pg_temp mint reasons about data location
        across epochs, and an OSD's transient down-ness (a beacon blip)
        must not read as the data having moved."""
        pool = self.pools.get(pgid.pool)
        if pool is None or pgid.seed >= pool.pg_num:
            return []
        raw, _ = self._pg_to_raw_osds(pool, pgid)
        return self._apply_upmap(pool, pgid, raw)

    # -- whole-pool batched placement --------------------------------------

    def _raw_key(self, pool_id: int) -> bytes:
        """Every input of ``_pool_raw(pool_id)``: the CRUSH map with the
        pool's own rule in place of the rule list (another pool's rule
        places nothing of this pool), the OSD count, weights and
        existence, the pool and its upmap entries.  The pool's snapshot
        fields place nothing: a snapshot (an RBD ``snap_create`` is a
        map epoch) keeps the key, so it does not remap the pool."""
        pool = dataclasses.replace(self.pools[pool_id], snap_seq=0,
                                   snaps={}, removed_snaps=())
        crush = dict(vars(self.crush))
        rules = crush.pop("rules")
        rule = rules[pool.crush_rule] if 0 <= pool.crush_rule < len(rules) \
            else None
        upmaps = sorted((pg.seed, tuple(v)) for pg, v in self.pg_upmap.items()
                        if pg.pool == pool_id)
        items = sorted((pg.seed, tuple(tuple(p) for p in v))
                       for pg, v in self.pg_upmap_items.items()
                       if pg.pool == pool_id)
        blob = pickle.dumps((sorted(crush.items()), rule, self.max_osd,
                             list(self.osd_weight), list(self.osd_exists),
                             pool, upmaps, items),
                            protocol=pickle.HIGHEST_PROTOCOL)
        return hashlib.blake2b(blob, digest_size=20).digest()

    def _pool_raw(self, pool_id: int):
        """``pool_raw_up`` and its bookkeeping: (raw_up, lengths, pps).
        ``lengths[s]`` is the length of ``pg_raw_up``'s list for seed s
        (firstn rules may place fewer than ``size``), so a caller can tell
        padding from the list's own entries.  Looked up in, and put into,
        the map's ``placements`` cache when it has one."""
        cache = self.placements
        if cache is None:
            return self._pool_raw_once(pool_id)
        key = self._raw_key(pool_id)
        got = cache.get(key)
        if got is None:
            got = self._pool_raw_once(pool_id)
            cache.put(key, got)
        return tuple(a.copy() for a in got)

    def _pool_raw_once(self, pool_id: int):
        pool = self.pools[pool_id]
        seeds = np.arange(pool.pg_num, dtype=np.uint32)
        pps = pool.raw_pg_to_pps_batch(seeds)
        try:
            mapper = self.tensor_mapper
        except NotImplementedError as e:
            # map shape the batched mapper rejects (legacy tunables,
            # non-straw2 buckets, sparse bucket ids): the scalar oracle,
            # with identical semantics.  Surfaced, never silent: a 1M-PG
            # map quietly dropping to a Python loop would look like a
            # device perf bug.  A missing CUDA device is not caught here.
            self.scalar_fallbacks += 1
            logging.getLogger("ceph_tpu_torch.osdmap").warning(
                "pool %d placement FELL BACK to the scalar mapper "
                "(%s); batched device placement disabled for this map",
                pool_id, e)
            res_l, rlen_l = [], []
            for s in range(pool.pg_num):
                raw = self._scalar.do_rule(pool.crush_rule, int(pps[s]),
                                           pool.size, self.osd_weight)
                res_l.append(raw + [0] * (pool.size - len(raw)))
                rlen_l.append(len(raw))
            res = np.asarray(res_l, dtype=np.int64).reshape(
                pool.pg_num, pool.size)
            rlen = np.asarray(rlen_l, dtype=np.int64)
        else:
            weights = np.zeros(self.crush.max_devices, dtype=np.uint32)
            weights[: self.max_osd] = self.osd_weight
            res, rlen = mapper.do_rule_batch(
                pool.crush_rule, pps, pool.size, weights)
            res = res.cpu().numpy()
            rlen = rlen.cpu().numpy()
        size = pool.size
        res64 = np.asarray(res, dtype=np.int64)[:, :size]
        rlen64 = np.asarray(rlen, dtype=np.int64)
        cols = np.arange(size, dtype=np.int64)
        raw = np.where(cols[None, :] < rlen64[:, None], res64,
                       CRUSH_ITEM_NONE)
        # the existence filter, vectorised: a placed id that is not an
        # existing OSD compacts out of a replicated row (the survivors
        # keep their order, NONE entries included) and becomes a NONE
        # hole in place in an erasure row
        real = raw != CRUSH_ITEM_NONE
        ok = real & (raw >= 0) & (raw < self.max_osd)
        ok &= np.asarray(self.osd_exists, dtype=bool)[np.where(ok, raw, 0)]
        gone = real & ~ok
        lengths = rlen64.copy()
        if pool.can_shift_osds():
            order = np.argsort(gone, axis=1, kind="stable")
            vals = np.take_along_axis(raw, order, axis=1)
            kept = ~np.take_along_axis(gone, order, axis=1)
            raw = np.where(kept, vals, CRUSH_ITEM_NONE)
            lengths -= gone.sum(axis=1)
        else:
            raw = np.where(gone, CRUSH_ITEM_NONE, raw)
        # sparse upmap overrides re-run the scalar chain per seed (the
        # folded pg id of seed s < pg_num is s itself)
        special = {pg.seed for pg in self.pg_upmap
                   if pg.pool == pool_id and pg.seed < pool.pg_num}
        special |= {pg.seed for pg in self.pg_upmap_items
                    if pg.pool == pool_id and pg.seed < pool.pg_num}
        for s in sorted(special):
            r = self._remove_nonexistent(
                pool, [int(v) for v in res64[s, : rlen64[s]]])
            r = self._apply_upmap(pool, PGid(pool_id, s), r)
            row = np.full(size, CRUSH_ITEM_NONE, dtype=np.int64)
            row[: len(r)] = r
            raw[s] = row
            lengths[s] = len(r)
        return raw, lengths, pps

    def pool_raw_up(self, pool_id: int) -> np.ndarray:
        """``pg_raw_up`` for every PG of a pool: a (pg_num, size) int64
        array whose row s is ``pg_raw_up(PGid(pool_id, s))`` padded at the
        end with CRUSH_ITEM_NONE (erasure rows keep their holes in place).
        One batched placement on the map's device, the existence filter
        vectorised, the scalar chain only for seeds with upmap entries."""
        return self._pool_raw(pool_id)[0]

    def pool_mapping(self, pool_id: int):
        """Map every PG of a pool as one batched placement on the device.

        Returns (up (pg_num, size) int64 with CRUSH_ITEM_NONE holes/padding,
        up_primary (pg_num,) int64): ``pool_raw_up``, then the up filter
        and the primary pick VECTORIZED in numpy — zero per-PG Python on
        the common path; non-default primary affinity re-runs the scalar
        post-pass for the pool.  Semantics match the per-PG scalar
        pipeline exactly (cross-checked in tests).
        """
        pool = self.pools[pool_id]
        raw, lengths, pps = self._pool_raw(pool_id)
        size = pool.size
        aff = self.osd_primary_affinity
        if aff is not None and any(
                a != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY for a in aff):
            # non-default primary affinity reorders/re-picks primaries
            # per (pps, osd) hash: keep the per-seed scalar post-pass
            # for the whole pool (affinity maps are rare and sparse)
            up = np.full((pool.pg_num, size), CRUSH_ITEM_NONE,
                         dtype=np.int64)
            upp = np.full(pool.pg_num, -1, dtype=np.int64)
            for s in range(pool.pg_num):
                u = self._raw_to_up(
                    pool, [int(v) for v in raw[s, : lengths[s]]])
                u, p = self._apply_primary_affinity(
                    int(pps[s]), pool, u, self._pick_primary(u))
                up[s, : len(u)] = u
                upp[s] = p
            return up, upp
        # vectorized post-pass: up masking and first-non-NONE primary
        # pick as whole-pool array ops
        valid = (raw != CRUSH_ITEM_NONE) & (raw >= 0) & \
            (raw < self.max_osd)
        alive = np.asarray(self.osd_exists, dtype=bool) & \
            np.asarray(self.osd_up, dtype=bool)
        keep = valid & alive[np.where(valid, raw, 0)]
        if pool.can_shift_osds():
            # replicated: down entries compact out, preserving the order
            # of the survivors (stable sort on the drop mask == the
            # scalar chain's filtered list)
            order = np.argsort(~keep, axis=1, kind="stable")
            vals = np.take_along_axis(raw, order, axis=1)
            kept = np.take_along_axis(keep, order, axis=1)
            up = np.where(kept, vals, CRUSH_ITEM_NONE)
        else:
            # erasure: positions are shard slots — down entries become
            # NONE holes in place
            up = np.where(keep, raw, CRUSH_ITEM_NONE)
        has = up != CRUSH_ITEM_NONE
        first = has.argmax(axis=1)
        upp = np.where(has.any(axis=1),
                       up[np.arange(pool.pg_num), first],
                       -1).astype(np.int64)
        return up, upp

    def rebalance_diff(self, pool_id: int, other: "OSDMap"):
        """Changed-PG set between two maps (the BASELINE rebalance metric)."""
        a, ap = self.pool_mapping(pool_id)
        b, bp = other.pool_mapping(pool_id)
        moved = np.nonzero((a != b).any(axis=1))[0]
        return moved, len(moved) / max(a.shape[0], 1)


# -- vectorized epoch deltas -------------------------------------------------
#
# "Which PGs did this epoch change?" as whole-pool array diffs instead of a
# per-PG Python rescan: an OSD snapshots each pool's resolved placement
# after every map advance and diffs the arrays on the next one, so epoch
# application peers only PGs whose up/acting actually moved.  The per-PG
# scan (affected_pgs_scalar) stays as the bit-exactness anchor.


@dataclass
class PoolPlacement:
    """One pool's resolved placement at an epoch — the diffable unit."""

    pool_id: int
    pg_num: int
    size: int
    shift: bool                       # pool.can_shift_osds()
    mode: str                         # "batched" | "scalar"
    up: Optional[np.ndarray] = None   # (pg_num, size), batched mode
    upp: Optional[np.ndarray] = None  # (pg_num,), batched mode
    # per-seed (up, up_primary, acting, acting_primary) normalized
    # tuples: EVERY seed in scalar mode; only pg_temp/primary_temp
    # overridden seeds in batched mode (acting != up only there)
    resolved: Dict[int, Tuple] = field(default_factory=dict)

    def resolve(self, seed: int) -> Tuple:
        got = self.resolved.get(seed)
        if got is not None:
            return got
        row = self.up[seed]
        if self.shift:
            u = tuple(int(o) for o in row if o != CRUSH_ITEM_NONE)
        else:
            u = tuple(int(o) for o in row)
        p = int(self.upp[seed])
        return (u, p, u, p)


def _norm_placement(size: int, shift: bool, up, upp, acting, actp) -> Tuple:
    """Normalize a pg_to_up_acting_osds 4-tuple so scalar- and
    array-derived resolutions compare equal: replicated sets drop NONE
    holes, erasure sets pad to the pool size (trailing padding is not a
    placement change)."""
    if shift:
        u = tuple(o for o in up if o != CRUSH_ITEM_NONE)
        a = tuple(o for o in acting if o != CRUSH_ITEM_NONE)
    else:
        u = tuple(up) + (CRUSH_ITEM_NONE,) * (size - len(up))
        a = tuple(acting) + (CRUSH_ITEM_NONE,) * (size - len(acting))
    return (u, upp, a, actp)


def placement_snapshot(m: OSDMap, pool_id: int,
                       batch_min: int = 0) -> PoolPlacement:
    """Resolve a pool's full placement: one batched placement + sparse
    temp-override scalar re-runs (pools below ``batch_min`` PGs stay on
    the scalar chain — a device call costs more than it saves)."""
    pool = m.pools[pool_id]
    shift = pool.can_shift_osds()
    if pool.pg_num < batch_min:
        snap = PoolPlacement(pool_id, pool.pg_num, pool.size, shift,
                             "scalar")
        for seed in range(pool.pg_num):
            snap.resolved[seed] = _norm_placement(
                pool.size, shift,
                *m.pg_to_up_acting_osds(PGid(pool_id, seed)))
        return snap
    up, upp = m.pool_mapping(pool_id)
    snap = PoolPlacement(pool_id, pool.pg_num, pool.size, shift,
                         "batched", up=up, upp=upp)
    temp = {pg.seed for pg in m.pg_temp
            if pg.pool == pool_id and pg.seed < pool.pg_num}
    temp |= {pg.seed for pg in m.primary_temp
             if pg.pool == pool_id and pg.seed < pool.pg_num}
    for seed in sorted(temp):
        snap.resolved[seed] = _norm_placement(
            pool.size, shift,
            *m.pg_to_up_acting_osds(PGid(pool_id, seed)))
    return snap


def placement_delta(old: Optional[PoolPlacement],
                    new: PoolPlacement) -> Optional[set]:
    """Seeds whose (up, up_primary, acting, acting_primary) changed
    between two snapshots.  ``None`` = treat everything as changed (no
    old snapshot, or an incomparable shape change)."""
    if old is None or old.size != new.size or old.shift != new.shift:
        return None
    if old.pg_num > new.pg_num:
        return None  # shrink is unsupported upstream; stay safe
    changed: set = set(range(old.pg_num, new.pg_num))  # pg_num growth
    overlap = old.pg_num
    if old.mode == "batched" and new.mode == "batched":
        diff = np.nonzero(
            (old.up[:overlap] != new.up[:overlap]).any(axis=1)
            | (old.upp[:overlap] != new.upp[:overlap]))[0]
        changed.update(int(s) for s in diff)
        # temp-overridden seeds (either side) decide by the resolved
        # 4-tuple: the raw arrays ignore pg_temp/primary_temp
        for s in set(old.resolved) | set(new.resolved):
            if s >= overlap:
                continue
            if old.resolve(s) != new.resolve(s):
                changed.add(s)
            else:
                changed.discard(s)
        return changed
    # scalar snapshots (small pools, or a pool that crossed the batch
    # threshold): per-seed tuple compare over the overlap
    for s in range(overlap):
        if old.resolve(s) != new.resolve(s):
            changed.add(s)
    return changed


def affected_pgs(old: OSDMap, new: OSDMap, pool_id: int,
                 batch_min: int = 0) -> set:
    """Vectorized epoch delta: the set of seeds in ``pool_id`` whose
    placement changed from ``old`` to ``new`` — whole-pool batched
    placements diffed as arrays, sparse overrides re-checked scalar.
    Bit-identical to :func:`affected_pgs_scalar` (tier-1 gate)."""
    have_old = pool_id in old.pools
    have_new = pool_id in new.pools
    if not have_new:
        return set(range(old.pools[pool_id].pg_num)) if have_old else set()
    if not have_old:
        return set(range(new.pools[pool_id].pg_num))
    delta = placement_delta(placement_snapshot(old, pool_id, batch_min),
                            placement_snapshot(new, pool_id, batch_min))
    if delta is None:
        return set(range(new.pools[pool_id].pg_num))
    return delta


def affected_pgs_scalar(old: OSDMap, new: OSDMap, pool_id: int) -> set:
    """The per-PG-scan anchor: compare the full scalar placement chain
    seed by seed.  O(pg_num) Python per epoch — exactly the cost the
    vectorized path exists to avoid; kept as the bit-exactness oracle."""
    have_old = pool_id in old.pools
    have_new = pool_id in new.pools
    if not have_new:
        return set(range(old.pools[pool_id].pg_num)) if have_old else set()
    if not have_old:
        return set(range(new.pools[pool_id].pg_num))
    pool = new.pools[pool_id]
    if old.pools[pool_id].size != pool.size:
        return set(range(pool.pg_num))  # width change: everything re-peers
    changed = set()
    for seed in range(pool.pg_num):
        pgid = PGid(pool_id, seed)
        a = _norm_placement(pool.size, pool.can_shift_osds(),
                            *old.pg_to_up_acting_osds(pgid))
        b = _norm_placement(pool.size, pool.can_shift_osds(),
                            *new.pg_to_up_acting_osds(pgid))
        if a != b:
            changed.add(seed)
    return changed


def build_simple_osdmap(n_osds: int = 16, osds_per_host: int = 4,
                        pg_num: int = 64, pool_type: int = POOL_TYPE_REPLICATED,
                        size: int = 3, ec_profile: Optional[Dict] = None,
                        device=None):
    """Dev helper: hierarchy + one pool (the vstart analog)."""
    from ceph_tpu_torch.crush.types import build_hierarchy

    cmap, ruleno = build_hierarchy(
        n_hosts=max(1, n_osds // osds_per_host),
        osds_per_host=osds_per_host,
        numrep=size,
        firstn=pool_type == POOL_TYPE_REPLICATED,
    )
    m = OSDMap(cmap, device=device)
    m.add_pool(PGPool(pool_id=1, type=pool_type, size=size,
                      min_size=max(1, size - 1), pg_num=pg_num,
                      pgp_num=pg_num, crush_rule=ruleno,
                      ec_profile=ec_profile or {}, name="rbd"))
    return m
