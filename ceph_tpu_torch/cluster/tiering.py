"""Cache tiering: hit sets, promote/proxy/forward, and the tier agent.

Counterpart of ``ceph_tpu/cluster/tiering.py``.

Behavioral analog of the reference's cache-tier axis of PrimaryLogPG
(src/osd/PrimaryLogPG.h:904 hit_set_persist, :919-923 agent_work,
maybe_handle_cache / do_proxy_read / promote_object) and the TierAgent
(src/osd/TierAgentState.h), re-seamed for this framework:

- The objecter's overlay redirect (objecter._overlay_pool) sends base-pool
  traffic to the CACHE pool; these mixin hooks run on the cache pool's
  primaries.
- On a cache MISS the op either PROMOTES the object (writeback — the
  promote is literally the local `copy_from` verb pulling from the base
  pool), PROXIES the read (readproxy), or forwards the whole vector to
  the base (forward mode, used to drain a cache).
- Every access records into a per-PG bloom HitSet, rotated every
  ``hit_set_period`` seconds and archived ``hit_set_count`` deep on the
  PG (reference hit_set_persist/trim); the agent uses recency for evict
  ordering.
- Writes on a tier mark the object DIRTY via a replicated attr; the tier
  agent flushes dirty objects to the base (the BASE primary pulls them
  with copy_from, reusing the cross-pool copy seam) and evicts clean
  objects past ``target_max_objects``.
"""

from __future__ import annotations

import asyncio
import pickle
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.pg import PGMETA, PGRB, _coll
from ceph_tpu_torch.cluster.store import Transaction
from ceph_tpu_torch.ops import jenkins

DIRTY_ATTR = "tier_dirty"
# NUL-prefixed like the snapdir marker: client object names can never
# collide with it, and every internal listing/scrub/split path filters it
HITSET_PREFIX = "\x00hitset_"


class BloomHitSet:
    """Bloom-filter hit set (reference BloomHitSet, CompressibleBloom):
    fixed 2^14-bit array, 4 jenkins-derived probes."""

    BITS = 1 << 14
    K = 4

    def __init__(self, bits: Optional[bytearray] = None):
        self.bits = bits if bits is not None else bytearray(self.BITS // 8)

    def _probes(self, oid: str):
        h = jenkins.str_hash_rjenkins(oid.encode())
        for i in range(self.K):
            p = int(jenkins.hash2(h & 0xFFFFFFFF, i)) % self.BITS
            yield p

    def insert(self, oid: str) -> None:
        for p in self._probes(oid):
            self.bits[p >> 3] |= 1 << (p & 7)

    def contains(self, oid: str) -> bool:
        return all(self.bits[p >> 3] & (1 << (p & 7))
                   for p in self._probes(oid))

    def encode(self) -> bytes:
        return bytes(self.bits)

    @classmethod
    def decode(cls, blob: bytes) -> "BloomHitSet":
        return cls(bytearray(blob))


class _PGHitSets:
    def __init__(self):
        self.current = BloomHitSet()
        self.started = time.monotonic()
        self.archive: deque = deque()


class TieringMixin:
    """Cache-pool behavior for OSDDaemon (composed like the other PG
    mixins)."""

    # ---------------------------------------------------------- hit sets

    def _hitsets_for(self, st) -> _PGHitSets:
        hs = getattr(self, "_tier_hitsets", None)
        if hs is None:
            hs = self._tier_hitsets = {}
        cur = hs.get(st.pgid)
        if cur is None:
            cur = hs[st.pgid] = _PGHitSets()
        return cur

    def _hit_set_record(self, pool, st, oid: str) -> None:
        hs = self._hitsets_for(st)
        now = time.monotonic()
        if now - hs.started > pool.hit_set_period:
            self._hit_set_rotate(pool, st, hs)
        hs.current.insert(oid)

    def _hit_set_rotate(self, pool, st, hs: _PGHitSets) -> None:
        """Archive the current set on the PG and start a fresh one
        (reference hit_set_persist + hit_set_trim)."""
        coll = _coll(st.pgid)
        stamp = int(time.time() * 1000)
        name = f"{HITSET_PREFIX}{stamp}"
        txn = Transaction().write(coll, name, 0, hs.current.encode())
        hs.archive.appendleft((name, hs.current))
        while len(hs.archive) > max(1, pool.hit_set_count):
            old_name, _ = hs.archive.pop()
            txn.remove(coll, old_name)
        self.store.queue_transaction(txn)
        hs.current = BloomHitSet()
        hs.started = time.monotonic()
        self.perf.inc("osd_tier_hitset_rotations")

    def _hit_recency(self, st, oid: str) -> int:
        """How many recent hit sets (current first) contain ``oid``;
        0 = cold (reference agent_estimate_temp)."""
        hs = self._hitsets_for(st)
        n = 1 if hs.current.contains(oid) else 0
        for _, b in hs.archive:
            if b.contains(oid):
                n += 1
        return n

    # ------------------------------------------------------- interception

    _TIER_READ_ONLY = frozenset({
        "read", "stat", "getxattr", "getxattrs", "omap_get", "list",
        "watch", "unwatch", "notify", "notify_ack", "cmpxattr"})

    def _tier_mode(self, pool) -> Optional[str]:
        if not pool.is_tier() or pool.cache_mode in ("none", ""):
            return None
        return pool.cache_mode

    async def _tier_intercept(self, conn, msg, m, pool, st) -> bool:
        """Cache-pool admission (reference maybe_handle_cache): returns
        True when the op was fully handled (reply sent)."""
        mode = self._tier_mode(pool)
        if mode is None:
            return False
        base_id = pool.tier_of
        if base_id not in m.pools:
            return False
        opnames = [o[0] for o in msg.ops]
        if "list" in opnames:
            return False  # listings stay local (cache contents)
        self._hit_set_record(pool, st, msg.oid)

        head_here = self.store.stat(_coll(st.pgid), msg.oid) is not None
        if "delete" in opnames:
            # delete-through (all modes): remove from BOTH tiers so a
            # later miss cannot resurrect the object from the base.
            # Guard ops (cmpxattr) in the vector still gate the delete.
            for gname, gargs in msg.ops:
                if gname in self._GUARD_OPS:
                    gr, _ = await self._do_one_op(conn, msg, m, pool, st,
                                                  gname, gargs)
                    if gr < 0:
                        await conn.send(M.MOSDOpReply(
                            reqid=msg.reqid, result=gr, epoch=m.epoch))
                        return True
            # stable derived reqid: a RESENT delete must hit the base's
            # dup detection, not re-execute
            r_base = await self.internal_op(
                base_id, msg.oid, [("delete", {})], snapc=msg.snapc,
                reqid_override=(f"{msg.reqid[0]}#tdel", msg.reqid[1]))
            r_local = 0
            if head_here:
                async with st.lock:
                    r_local = await self._op_delete(pool, st, msg.oid,
                                                    snapc=msg.snapc)
            ok = (r_base.result == 0) or (head_here and r_local == 0)
            await conn.send(M.MOSDOpReply(
                reqid=msg.reqid,
                result=0 if ok else -2, epoch=m.epoch))
            self.perf.inc("osd_tier_delete_through")
            return True
        if mode == "forward":
            # forward mode: the cache takes nothing NEW — misses forward
            # wholesale to the base.  Objects still in the cache keep
            # serving locally (they are newer than the base until the
            # draining agent flushes them out).  The derived reqid stays
            # stable across client resends for the base's dup detection.
            if head_here:
                return False
            reply = await self.internal_op(
                base_id, msg.oid, msg.ops,
                snapid=msg.snapid, snapc=msg.snapc,
                reqid_override=(f"{msg.reqid[0]}#fwd", msg.reqid[1]))
            await conn.send(M.MOSDOpReply(
                reqid=msg.reqid, result=reply.result, data=reply.data,
                epoch=m.epoch))
            self.perf.inc("osd_tier_forward")
            return True
        if head_here:
            return False  # cache hit: run locally
        pure_read = all(o in self._TIER_READ_ONLY for o in opnames)
        full_overwrite = all(o in ("write_full", "create") for o in opnames)
        if full_overwrite:
            return False  # no promote needed; the write replaces anyway
        if mode == "readproxy" and pure_read:
            # proxy the reads through to the base, no promotion
            reply = await self.internal_op(
                base_id, msg.oid, msg.ops,
                snapid=msg.snapid, snapc=msg.snapc)
            await conn.send(M.MOSDOpReply(
                reqid=msg.reqid, result=reply.result, data=reply.data,
                epoch=m.epoch))
            self.perf.inc("osd_tier_proxy_read")
            return True
        # writeback (or readproxy+write): PROMOTE — the local copy_from
        # verb pulls the object from the base, then the op runs locally
        r, _ = await self._do_one_op(
            conn, msg, m, pool, st, "copy_from",
            {"src_pool": base_id, "src_oid": msg.oid})
        if r == -2:
            if pure_read:
                await conn.send(M.MOSDOpReply(
                    reqid=msg.reqid, result=-2, epoch=m.epoch))
                return True
            return False  # new object: writes proceed locally
        if r < 0:
            await conn.send(M.MOSDOpReply(
                reqid=msg.reqid, result=r, epoch=m.epoch))
            return True
        # promoted copies are CLEAN until a local write dirties them
        await self._tier_set_dirty(st, msg.oid, False)
        self.perf.inc("osd_tier_promotions")
        return False

    # ------------------------------------------------------ dirty tracking

    async def _tier_set_dirty(self, st, oid: str, dirty: bool,
                              expect_version: Optional[int] = None) -> bool:
        """Replicated dirty flag (object_info_t FLAG_DIRTY analog): rides
        a logged transaction so a failed-over cache primary still knows
        what needs flushing.  With ``expect_version`` the flag only
        changes if the object is still at that version (the flush/write
        race interlock) — returns False when the object moved."""
        coll = _coll(st.pgid)
        async with st.lock:
            if expect_version is not None and \
                    self.store.get_version(coll, oid) != expect_version:
                return False
            txn = Transaction()
            if dirty:
                txn.setattr(coll, oid, DIRTY_ATTR, b"1")
            else:
                txn.rmattr(coll, oid, DIRTY_ATTR)
            version = self._next_version(st)
            txn.set_version(coll, oid, version[1])
            await self._replicate_txn(st, txn, "modify", oid, version)
        return True

    def _tier_is_dirty(self, st, oid: str) -> bool:
        return self.store.getattr(_coll(st.pgid), oid, DIRTY_ATTR) \
            is not None

    async def _tier_mark_dirty_after_write(self, pool, st, msg) -> None:
        """Called after a successful mutating vector on a cache pool."""
        if self._tier_mode(pool) is None:
            return
        if self.store.stat(_coll(st.pgid), msg.oid) is None:
            return  # vector deleted the object
        await self._tier_set_dirty(st, msg.oid, True)

    # ------------------------------------------------------------- agent

    async def _tier_agent_loop(self) -> None:
        """Background flush/evict (reference agent_work / TierAgentState):
        per cache-pool PG this OSD primaries — flush dirty objects to the
        base (the base primary PULLS them via copy_from, reusing the
        cross-pool seam), then evict cold clean objects past
        target_max_objects.  Forward-mode caches drain completely."""
        while not self._stopped:
            await asyncio.sleep(self.config.osd_tier_agent_interval)
            m = self.osdmap
            if m is None:
                continue
            for pgid, st in list(self.pgs.items()):
                pool = m.pools.get(pgid.pool)
                if pool is None or self._tier_mode(pool) is None:
                    continue
                if st.primary != self.osd_id:
                    continue
                try:
                    await self._tier_agent_pg(m, pool, st)
                except Exception:
                    self.perf.inc("osd_tier_agent_errors")

    def _tier_objects(self, st) -> List[str]:
        from ceph_tpu_torch.cluster import snaps as snapmod

        return [o for o in self._list_pg_objects(st.pgid)
                if not snapmod.is_snap_key(o)]

    async def _tier_agent_pg(self, m, pool, st) -> None:
        base_id = pool.tier_of
        if base_id not in m.pools:
            return
        drain = pool.cache_mode == "forward"
        objs = self._tier_objects(st)
        dirty = [o for o in objs if self._tier_is_dirty(st, o)]
        # flush: base pulls the object; then the copy is clean — but only
        # if no write landed DURING the flush (version interlock, the
        # reference's flush/dirty race guard), else it stays dirty for
        # the next pass
        coll = _coll(st.pgid)
        for oid in dirty:
            v0 = self.store.get_version(coll, oid)
            reply = await self.internal_op(
                base_id, oid,
                [("copy_from", {"src_pool": st.pgid.pool,
                                "src_oid": oid})])
            if reply.result == 0:
                if await self._tier_set_dirty(st, oid, False,
                                              expect_version=v0):
                    self.perf.inc("osd_tier_flushes")
        if not drain and not pool.target_max_objects:
            return
        objs = self._tier_objects(st)
        clean = [o for o in objs if not self._tier_is_dirty(st, o)]
        # per-PG share of the pool target (reference divides by pg_num)
        per_pg_target = 0 if drain else max(
            1, pool.target_max_objects // max(1, pool.pg_num))
        excess = len(objs) - per_pg_target
        if excess <= 0:
            return
        # evict coldest first (lowest hit-set recency)
        clean.sort(key=lambda o: self._hit_recency(st, o))
        for oid in clean[:excess]:
            async with st.lock:
                r = await self._op_delete(pool, st, oid)
            if r == 0:
                self.perf.inc("osd_tier_evictions")
