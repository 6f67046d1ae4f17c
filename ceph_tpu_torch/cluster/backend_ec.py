"""ECBackend: striped shard writes/reads, RMW, decode recovery
(reference src/osd/ECBackend.cc:921,986,1141 via the PGBackend seam).
Encode/decode of the touched stripe range is one batched device call on
the pool codec's device: kernel B1 for a planes-at-rest pool, B2 for a
cauchy pool, behind the OSD's ``EncodeBatcher`` and ``ReadBatcher``.

Counterpart of ``ceph_tpu/cluster/backend_ec.py``."""

from __future__ import annotations

import asyncio
import pickle
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.messenger import Connection
from ceph_tpu_torch.cluster.pglog import LogEntry
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.cluster.pg import PGRB, PGState, _coll
from ceph_tpu_torch.cluster.store import Transaction
from ceph_tpu_torch.ec import planar_store
from ceph_tpu_torch.ops import crc32c as crcmod
from ceph_tpu_torch.osdmap.osdmap import PGid, PGPool


class ECUndersized(Exception):
    """The live acting set is below the pool's EC write floor
    (min_size, never below k): admitting the write would create a
    generation with fewer than k unique shards — acked-but-
    unreconstructable by construction, and a subsequent roll-forward
    would wedge the PG on a generation nothing can ever decode
    (surfaced by graft-chaos batch-kill-midtick: a primary alone in a
    bounced acting set committed a 1-of-3-shard write).  Mapped to -11
    so the client refreshes its map and retries once the set heals."""


class ECSizeMismatch(Exception):
    """The chosen decode group's object size disagrees with the size the
    caller assumed from its LOCAL shard attrs — the local shard is a
    stale generation (e.g. a primary whose recovery pull never finished).
    Carries the group's size so the caller can recompute the stripe
    range and retry against the authoritative generation; mixing group
    bytes with the local length would serve torn reads (surfaced by
    graft-chaos: g2 bytes truncated to g1's length)."""

    def __init__(self, size: int):
        super().__init__(f"decode group size {size}")
        self.size = size


def choose_decode_group(got: Dict[int, Tuple[bytes, int, int]],
                        need_k: int, committed,
                        committed_before=None) -> Tuple[
                            Dict[int, bytes], int, int, Set[int]]:
    """Choose the shard group that decodes consistently: newest version
    first, but versions ABOVE the commit watermark are skipped when an
    older viable group exists — an un-acked write may still be rolled
    back by peering, and serving bytes that later vanish would break
    read-your-ack (the reference compares object_info versions in
    handle_sub_read_reply and serves committed state).

    Pure function so the mixed-generation corruption-matrix
    tests drive it without a cluster: ``got`` maps shard -> (bytes,
    version, size), ``committed(v)`` answers "is generation v at/below
    the commit watermark (or a resolved frontier entry)".  Returns
    ``(shards, size, version, stale_shards)`` — ``stale_shards`` are
    members whose shard belongs to an OLDER generation than a COMMITTED
    chosen one: they missed an acked write (crash/rewind/interrupted
    recovery) and are read-repair candidates.  ``committed_before``
    (default: ``committed``) is the STRICTER predicate staleness is
    judged by — the caller passes its start-of-gather watermark
    snapshot, so a generation that commits WHILE the gather is in
    flight never flags members whose replies merely predate their own
    apply (a healthy write/read race, not damage).  Raises IOError when an
    acked newer generation lacks k same-version shards: serving an
    older group would be a silent stale read (ADVICE r4), so the read
    fails and recovery repairs the object instead."""
    shards: Dict[int, bytes] = {}
    size = 0
    version = 0
    stale: Set[int] = set()
    versions = sorted({ver for _, ver, _ in got.values()}, reverse=True)
    viable = []
    for v in versions:
        group = {s: d for s, (d, ver, _) in got.items() if ver == v}
        if len(group) >= min(need_k, len(got)):
            viable.append((v, group))
    chosen = None
    for v, group in viable:
        if committed(v):
            chosen = (v, group)
            break
    if chosen is None and viable:
        chosen = viable[0]  # only un-acked state exists (new object)
    acked_newest = max((v for v in versions if committed(v)),
                       default=None)
    if (acked_newest is not None and chosen is not None
            and chosen[0] < acked_newest):
        have = sum(1 for _, ver, _ in got.values()
                   if ver == acked_newest)
        raise IOError(
            f"acked version {acked_newest} has only {have} "
            f"of {need_k} shards; refusing stale read")
    if chosen is not None:
        version, shards = chosen[0], chosen[1]
        size = max(sz for _, ver, sz in got.values() if ver == version)
        if (committed_before or committed)(version):
            # a shard BELOW a generation committed BEFORE the gather
            # began can only exist if its member missed an acked write
            # (EC commits require every shard); in-flight newer writes
            # sit above it, and a generation that committed mid-gather
            # is excluded by the stricter predicate
            stale = {s for s, (_d, ver, _sz) in got.items()
                     if ver < version}
    return shards, size, version, stale


class ECBackendMixin:

    def _codec(self, pool: PGPool):
        codec = self._codecs.get(pool.pool_id)
        if codec is None:
            from ceph_tpu_torch.ec import factory

            profile = pool.ec_profile or {
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"}
            # built on this OSD's device, not the thread's default
            codec = factory(profile, device=self.device)
            if self.config.osd_ec_mesh == "on":
                # route the pool's batch encode/decode over the device
                # mesh (parallel/engine.py) — the multi-chip data plane:
                # the visible cards for an OSD on a card; for an OSD on
                # the CPU, slots of the CPU (eight when the option says
                # "all": the JAX package's virtual CPU mesh).  Packet
                # codecs stay as they are (see wrap_codec_for_mesh)
                from ceph_tpu_torch.parallel.engine import wrap_codec_for_mesh

                n = self.config.osd_ec_mesh_devices
                devices = None if self.device.type == "cuda" \
                    else [self.device] * (n or 8)
                codec = wrap_codec_for_mesh(codec, n, devices=devices)
            self._codecs[pool.pool_id] = codec
        return codec

    def _sinfo(self, pool: PGPool, codec) -> "StripeInfo":
        """Stripe layout for a pool (ECUtil::stripe_info_t analog)."""
        from ceph_tpu_torch.ec.stripe import StripeInfo

        unit = int((pool.ec_profile or {}).get(
            "stripe_unit", self.config.osd_ec_stripe_unit))
        return StripeInfo(codec.get_data_chunk_count(), unit)

    def _planar_mode(self, codec, sinfo) -> bool:
        """Bit-planar AT-REST gate: config on AND the codec/
        stripe geometry supports conversion-free plane-domain compute
        (w=8 matrix codec, unit % 8 == 0).  Unsupported geometries
        quietly stay byte-at-rest — the gate never changes what bytes a
        client sees, only how shards are laid out."""
        if not self.config.osd_ec_planar_at_rest:
            return False
        from ceph_tpu_torch.ec import stripe as stripemod

        return stripemod.planar_at_rest_ok(codec, sinfo.chunk_size)

    # ----------------------------------------------------------- EC backend
    #
    # Objects are striped (ECUtil::stripe_info_t math, ceph_tpu_torch.ec.stripe):
    # shard s holds stripe-chunk s of every stripe, concatenated.  Encode /
    # decode of the whole touched stripe range happens in one batched device
    # dispatch; partial writes are read-modify-write over stripe bounds
    # (reference ECBackend::start_rmw, ECBackend.cc:1785-1886).
    #
    # layout contract: between those host boundaries the stripe
    # batch lives in the bit-planar device layout (ec/planar.py) — the
    # encode/decode/RMW-delta hops are planar GF(2) matmuls and a batch is
    # converted (transposed) at most once per direction per client op.
    # Byte layout appears only where bytes must: the store transaction and
    # the sub-write wire format.

    async def _ec_write_pipelined(self, pool: PGPool, st: PGState,
                                  oid: str, data: bytes,
                                  offset: Optional[int],
                                  snapc=None) -> int:
        """Pipelined EC mutation — full rewrite (offset None) AND RMW: prepare (read-merge for RMW, coalesced
        encode) under the per-OBJECT write lock, take the PG lock only
        for the ordered commit section (version assignment, log append,
        local apply, sub-write sends), and await the fan-out acks with
        both RELEASED — the reference's in-flight RepGather pipeline,
        where the PG admits the next write while this one's shards are
        still committing.  The object lock is what the full PG lock
        used to provide for RMW: no other write to the SAME object can
        commit inside the read-merge window (lost-update exclusion,
        ECBackend::start_rmw wait queue), while the rest of the PG
        proceeds.  The commit frontier (pg.py _frontier_*) keeps the
        watermark honest under out-of-order ack arrival."""
        async with self._obj_write_lock(st, oid):
            token = await self._ec_start_objlocked(
                pool, st, oid, data, offset, snapc)
        return await self._ec_commit_finish(st, token)

    async def _ec_start_objlocked(self, pool: PGPool, st: PGState,
                                  oid: str, data: bytes,
                                  offset: Optional[int], snapc):
        """Prepare + commit-start half of a pipelined EC write; the
        caller holds the object write lock and awaits
        ``_ec_commit_finish`` on the returned token OUTSIDE it (an int
        token is an already-final result, e.g. -11 undersized)."""
        codec = self._codec(pool)
        sinfo = self._sinfo(pool, codec)
        if not self._ec_acting_writeable(pool, codec, st):
            return -11  # retry after the map heals; no encode burned
        shards, crcs, new_size, chunk_off, layout = \
            await self._ec_prepare_write(
                pool, st, oid, data, offset, codec, sinfo)
        if offset is not None:
            self.perf.inc("osd_rmw_pipelined")
        try:
            async with st.lock:
                return await self._ec_commit_start(
                    pool, st, oid, new_size, shards, crcs, snapc,
                    codec, sinfo, chunk_off=chunk_off, layout=layout)
        except ECUndersized:
            return -11

    def _ec_acting_writeable(self, pool: PGPool, codec, st: PGState
                             ) -> bool:
        """EC write admission floor (reference: a PG below min_size is
        not active and ops wait): at least min_size live members —
        never below k — or every 'committed' stripe would be missing
        shards it can never reconstruct."""
        live = sum(1 for o in st.acting if o != CRUSH_ITEM_NONE)
        k = codec.get_data_chunk_count()
        need = min(codec.get_chunk_count(), max(k, pool.min_size))
        if live >= need:
            return True
        self.perf.inc("osd_ec_undersized_blocks")
        return False

    async def _ec_truncate_pipelined(self, pool: PGPool, st: PGState,
                                     oid: str, size: int,
                                     snapc=None) -> int:
        """Pipelined EC truncate: read the surviving prefix
        and re-encode it as a full rewrite, all under the OBJECT write
        lock (the read-then-rewrite window must exclude other writes to
        this object — the full PG lock's old job), committing through
        the same frontier path as every other pipelined write."""
        async with self._obj_write_lock(st, oid):
            cur = self._head_size(pool, st, oid)
            if size == cur:
                return 0
            if size < cur:
                head = await self._op_read(pool, st, oid, 0, size)
                head = head.ljust(size, b"\0")
            else:
                head = (await self._op_read(pool, st, oid, 0, cur)
                        ).ljust(size, b"\0")
            token = await self._ec_start_objlocked(
                pool, st, oid, head, None, snapc)
        return await self._ec_commit_finish(st, token)

    async def _ec_write(self, pool: PGPool, st: PGState, oid: str,
                        data: bytes, offset: Optional[int],
                        snapc=None) -> int:
        """Serial (full-PG-lock) EC write incl. the RMW sequence — the
        ``osd_pipeline_writes=0`` fallback and the path for compound
        read-modify callers that hold st.lock across multiple ops
        (copy_from, rollback, EC truncate's read-then-rewrite).
        Callers hold the PG-wide st.lock across the whole op, so
        overlapping RMWs can never interleave.  The hot path uses
        ``_ec_write_pipelined`` instead, which narrows the locks to the
        ordered commit section."""
        codec = self._codec(pool)
        sinfo = self._sinfo(pool, codec)
        if not self._ec_acting_writeable(pool, codec, st):
            return -11
        shards, crcs, new_size, chunk_off, layout = \
            await self._ec_prepare_write(
                pool, st, oid, data, offset, codec, sinfo)
        try:
            token = await self._ec_commit_start(
                pool, st, oid, new_size, shards, crcs, snapc, codec,
                sinfo, chunk_off=chunk_off, layout=layout)
        except ECUndersized:
            return -11
        return await self._ec_commit_finish(st, token)

    async def _ec_prepare_write(self, pool: PGPool, st: PGState,
                                oid: str, data: bytes,
                                offset: Optional[int], codec, sinfo):
        """The pure-compute half of an EC write: RMW read-merge (when
        offset is given) + coalesced encode.  Returns ``(shards, crcs,
        new_size, chunk_off, layout)``.  Shared verbatim by the serial
        and pipelined paths so the two stay bit-identical by
        construction (the tier-1 exactness gate compares their stored
        bytes).  In planar mode the RMW read-half books the sanctioned
        egress (inside the read coalescer) and the re-encode books the
        sanctioned ingest — the merge itself is logical bytes, which
        is the CLIENT's layout, not a shard layout conversion."""
        from ceph_tpu_torch.ec import stripe as stripemod

        coll = _coll(st.pgid)
        if offset is None:
            # write_full: replace the object — a full-shard rewrite, so
            # the coalesced tick also batch-computes the shard crcs
            shards, crcs, layout = await self._encode_for_write(
                codec, sinfo, data, want_crc=True)
            return shards, crcs, len(data), 0, layout
        sa = self.store.getattr(coll, oid, "size")
        if sa is None:
            # no local shard (lost, or never held): the committed
            # size must come from the acting set — merging against
            # an assumed-empty object would truncate committed bytes
            _, old_size, _, _ = await self._gather_shards(
                pool, st, oid, codec.get_data_chunk_count(), 0, 0)
        else:
            old_size = int(sa)
        off0, len0 = sinfo.offset_len_to_stripe_bounds(offset, len(data))
        chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(off0)
        old_bytes = b""
        for _attempt in range(2):
            old_in_range = max(0, min(old_size - off0, len0))
            if not old_in_range:
                break
            try:
                old_bytes = await self._ec_read_stripes(
                    pool, st, oid, chunk_off, old_in_range,
                    expected_size=old_size)
                break
            except ECSizeMismatch as e:
                if _attempt:
                    # still unstable (write racing recovery): fail
                    # the op rather than merge against absent bytes
                    raise IOError(
                        f"{oid}: object size unstable under RMW")
                # stale local size attr: redo the RMW against the
                # decode group's (committed) size
                old_size, old_bytes = e.size, b""
        merged = stripemod.merge_range(
            old_bytes, old_in_range, offset - off0, data)
        new_size = max(old_size, offset + len(data))
        # RMW touches a sub-range: the replica-side mid-shard crc
        # merge stays local, so no batch crc here
        shards, crcs, layout = await self._encode_for_write(
            codec, sinfo, merged, want_crc=False)
        return shards, crcs, new_size, chunk_off, layout

    async def _ec_commit_start(self, pool: PGPool, st: PGState, oid: str,
                               new_size: int, shards, crcs, snapc,
                               codec, sinfo, chunk_off: int = 0,
                               layout: Optional[str] = None):
        """Ordered commit section of an EC write (runs under st.lock):
        version assignment + frontier registration, local shard apply,
        log append, and the sub-write fan-out SENDS — everything whose
        PG-wide order must match the version order.  Returns the token
        ``_ec_commit_finish`` resolves outside the lock.

        ``layout`` == "planar8" means ``shards[i]`` is an (8, cols)
        AT-REST plane matrix: tobytes() serializes it row-major — the
        same bytes that land in the store and ride the wire, so the
        commit path is conversion-free end to end."""
        from ceph_tpu_torch.cluster.optracker import mark_current

        # re-checked UNDER the lock: the acting set can shrink during
        # the prepare awaits, and a commit into an undersized set is
        # the unreconstructable-write bug whatever the prepare-time
        # check saw
        if not self._ec_acting_writeable(pool, codec, st):
            raise ECUndersized(f"{st.pgid}: acting {st.acting}")
        eversion = self._next_version(st)
        version = eversion[1]
        self._frontier_open(st, eversion)
        self._chaos_point("frontier_open")
        shard_size = sinfo.shard_size(new_size)
        hinfo = {"size": new_size, "version": version}

        def hinfo_for(shard: int) -> Dict:
            # full rewrites carry the batch-computed shard crc so no
            # member (local or replica) re-checksums on its event loop
            if crcs is None:
                return hinfo
            return {**hinfo, "crc": crcs[shard]}

        try:
            # clone-on-write (make_writeable): the pre-ops clone each
            # member's SHARD object in place — no snapshot data crosses
            # the wire — and persist the updated SnapSet; they ride the
            # sub-write so clone + write are atomic per shard
            pre_ops = self._cow_pre_ops(st, oid, snapc, erasure=True)
            n = codec.get_chunk_count()
            reqid = self._next_reqid()
            peers = []
            my_shard = None
            for shard in range(n):
                osd = st.acting[shard] if shard < len(st.acting) \
                    else CRUSH_ITEM_NONE
                if osd == self.osd_id:
                    my_shard = shard
                elif osd != CRUSH_ITEM_NONE:
                    peers.append((osd, shard))
            if my_shard is not None:
                self._apply_shard(st.pgid, oid, my_shard,
                                  shards[my_shard].tobytes(), chunk_off,
                                  shard_size, hinfo_for(my_shard),
                                  pre_ops=pre_ops, layout=layout)
                mark_current("store:journal_queued")
            entry = self._log_mutation(st, "modify", oid, eversion)
            self._chaos_point("commit_pre_fanout")
            fut = None
            send_failures = 0
            if peers:
                fut = self._make_waiter(reqid, len(peers))
                # span propagation: each shard sub-write carries the
                # current span id so the replica's apply span joins
                # this op's tree
                subctx = self.tracer.context()
                # sub-writes inherit the client op's deadline (None for
                # recovery traffic): a replica sheds the dead legs
                from ceph_tpu_torch.cluster.pg import CURRENT_OP_DEADLINE

                sub_deadline = CURRENT_OP_DEADLINE.get()
                subs = []
                for osd, shard in peers:
                    sub = M.MOSDECSubOpWrite(
                        reqid=reqid, pgid=st.pgid, oid=oid, shard=shard,
                        data=shards[shard].tobytes(),
                        chunk_off=chunk_off,
                        shard_size=shard_size, hinfo=hinfo_for(shard),
                        entry=entry,
                        pre_ops=pre_ops,
                        epoch=self.osdmap.epoch,
                        deadline=sub_deadline,
                        layout=layout)
                    if subctx is not None:
                        sub.trace = dict(subctx)
                    subs.append((osd, sub))
                if self.config.osd_batch_tick_ops > 0:
                    # batched fan-out: same-tick sub-writes
                    # for one peer share a frame; a failed send still
                    # surfaces per sub-write, so the every-shard-durable
                    # rule holds
                    results = await asyncio.gather(
                        *(self._sub_batcher.send(o, s) for o, s in subs),
                        return_exceptions=True)
                    for res in results:
                        if isinstance(res, asyncio.CancelledError):
                            # daemon stop / chaos crash mid-fan-out:
                            # propagate — counting cancellation as a
                            # peer send failure would swallow the
                            # teardown (the swallowed-async-error bug
                            # class a lint rule polices)
                            raise res
                        if isinstance(res, BaseException):
                            send_failures += 1
                            self._waiter_dec(reqid)
                else:
                    for osd, sub in subs:
                        try:
                            await self._send_osd(osd, sub)
                        except (ConnectionError, OSError, RuntimeError):
                            send_failures += 1
                            self._waiter_dec(reqid)
                mark_current("ec_sub_write_sent")
        except BaseException:
            # frontier hygiene: a registered-but-unresolved entry would
            # wedge the PG's commit watermark forever
            self._frontier_done(st, eversion, ok=False)
            raise
        return (reqid, eversion, fut, send_failures, entry,
                st.interval_epoch)

    async def _ec_commit_finish(self, st: PGState, token) -> int:
        """Ack-wait half of an EC write — runs with the PG lock
        RELEASED on the pipelined path, so the next same-PG write
        overlaps this one's shard commits.  Resolves the commit
        frontier however it exits."""
        from ceph_tpu_torch.cluster.optracker import mark_current

        if isinstance(token, int):
            return token  # already-final result (e.g. -11 undersized)
        reqid, eversion, fut, send_failures, entry, interval = token
        try:
            if fut is not None:
                try:
                    if not fut.done():
                        await asyncio.wait_for(
                            fut, timeout=self._ack_wait_timeout())
                    mark_current("sub_write_acked")
                except asyncio.TimeoutError:
                    self._frontier_done(st, eversion, ok=False)
                    return -110
                finally:
                    self._pending.pop(reqid, None)
                refused = any(r != 0 for r, _p in fut.result())
                if send_failures or refused:
                    # a shard sub-write never left this host, or a member
                    # refused it (a gap in its log, _sub_write_gapped):
                    # unlike the replicated path (full copies, reachable
                    # set suffices) every EC shard is unique, so the stripe
                    # is NOT k+m durable and must not ack — the
                    # reference blocks EC writes until EVERY acting
                    # shard commits.  Stay un-acked (-110): the
                    # divergent entry rewinds during peering and the
                    # client retries against the post-peering acting
                    # set.  (Surfaced by graft-chaos: a just-restarted
                    # primary with dead peer sessions could ack a
                    # 1-shard stripe.)  A member that refused it has a
                    # gap (an earlier sub-write shed or dropped) that it
                    # refuses every later one across: queue the round
                    # that resyncs it now, since the frontier may not
                    # drain under a steady stream and no map change is
                    # due.
                    self._frontier_done(st, eversion, ok=False)
                    if refused:
                        self._queue_recovery_retry(st)
                    return -110
        except BaseException:
            self._frontier_done(st, eversion, ok=False)
            raise
        if st.interval_epoch != interval or st.peer_interval > interval \
                or self.pgs.get(st.pgid) is not st:
            # the PG's acting set or primary changed before every
            # sub-write ack was in, or a newer interval's primary has
            # already queried this daemon (whose own map may not show
            # that interval yet): the new interval's peering rules on
            # this entry (it may rewind it from members that took it),
            # so an ack now could name a write the PG then rolls back.
            # Stay un-acked; the client retries against the new acting
            # set.  (The port's fence for a stale EC primary: the
            # reference acks here.)
            self._frontier_done(st, eversion, ok=False)
            return -110
        if not self._entry_still_logged(st, entry):
            # a concurrent peering round REWOUND this entry (or
            # replaced the log) while our acks were in flight: whatever
            # the shards said, the entry is no longer part of the PG's
            # history — stay un-acked so the client retries (and
            # dup-resolves) against the post-peering state.  Checked by
            # entry IDENTITY: head/version comparisons are foolable
            # once post-rewind writes re-advance (or re-mint) versions.
            self._frontier_done(st, eversion, ok=False)
            return -110
        # every shard acked: this version can never roll back now
        self._chaos_point("frontier_pre_done")
        self._frontier_done(st, eversion, ok=True)
        mark_current("commit")
        return 0

    async def _encode_for_write(self, codec, sinfo, data: bytes,
                                want_crc: bool):
        """Encode one op's stripe range -> (shards, crcs-or-None,
        layout).

        With ``osd_batch_tick_ops`` > 0 the encode rides the per-tick
        coalescer (cluster/batcher.py): every same-profile write in the
        tick shares ONE planar conversion + fused dispatch + crc32c
        batch, and the op's timeline gets the attribution
        stages — ``batch_wait`` (parked awaiting its tick) and
        ``batch_encode`` (its amortized share of the coalesced
        dispatch).  At 0 this is exactly the per-op dispatch.

        Planar at rest: when the gate is on, the tick runs
        ``encode_planes_multi`` and the returned shards are (n, 8,
        cols) AT-REST plane matrices with plane-major crcs —
        layout == "planar8" tells the commit path to land and ship
        them as planes (store txn write_planar, wire layout field)."""
        from ceph_tpu_torch.cluster.optracker import CURRENT_OP, mark_current

        planar = self._planar_mode(codec, sinfo)
        layout = planar_store.LAYOUT_PLANAR if planar else None
        if self.config.osd_batch_tick_ops > 0:
            mark_current("batch_parked")
            shards, crcs, (t0, t1, batch_n) = \
                await self._ec_batcher.encode(codec, sinfo, data,
                                              want_crc, planar=planar)
            op = CURRENT_OP.get()
            if op is not None:
                # amortized attribution: this op's share of the tick's
                # encode wall; the rest of the window books as parked
                # time (both stamps stay monotone: t1 - share >= t0)
                share = (t1 - t0) / max(batch_n, 1)
                op.mark_at("batch_tick", t1 - share)
                op.mark_at("batch_encoded", t1)
            if planar:
                # the tick's client-bytes -> planes hop was this op's
                # one sanctioned ingest conversion — stamp it so
                # `bench.py --attribute` books it as planar_convert
                mark_current("planar_ingest")
            return shards, crcs, layout
        mark_current("ec_encode")
        # even the per-op anchor dispatches through the
        # sanctioned coalescer module (batcher.encode_once) — zero
        # device entry points on cluster/ op paths outside that seam
        shards = await self._ec_batcher.encode_once(codec, sinfo, data,
                                                    planar=planar)
        mark_current("planar_ingest" if planar else "ec_encoded")
        return shards, None, layout

    def _apply_shard(self, pgid: PGid, oid: str, shard: int, data: bytes,
                     chunk_off: int, shard_size: int, hinfo: Dict,
                     pre_ops: Optional[List[Tuple]] = None,
                     layout: Optional[str] = None) -> None:
        """Apply a shard sub-range write with its crc in ONE atomic
        transaction (ECUtil::HashInfo analog, reference ECUtil.h:105-163:
        the crc is CUMULATIVE for appends/full rewrites — no whole-shard
        re-read on the hot path — and data+crc can never disagree).

        ``layout`` == "planar8" routes to the planar-at-rest twin: the
        payload is a plane window, not shard bytes."""
        if layout == planar_store.LAYOUT_PLANAR:
            self._apply_shard_planar(pgid, oid, shard, data, chunk_off,
                                     shard_size, hinfo, pre_ops)
            return
        coll = _coll(pgid)
        old_size = self.store.stat(coll, oid)
        if chunk_off == 0 and len(data) >= shard_size:
            # full-shard rewrite: use the tick's batch-computed crc when
            # the primary shipped one (hinfo["crc"]) — no
            # per-shard host pass on the event loop; else one pass here
            crc = hinfo.get("crc")
            if crc is None:
                crc = crcmod.crc32c(0xFFFFFFFF, data[:shard_size])
        elif old_size is not None and chunk_off == old_size and \
                shard_size == chunk_off + len(data):
            # append: combine the stored cumulative crc with the new
            # bytes' crc (GF(2) zero-extension, reference HashInfo append)
            stored = self.store.getattr(coll, oid, "hinfo_crc")
            if stored is not None:
                crc = crcmod.crc32c_combine(
                    int(stored), crcmod.crc32c(0, data), len(data))
            else:
                crc = crcmod.crc32c(0xFFFFFFFF,
                                    self.store.read(coll, oid) + data)
        else:
            # true mid-shard RMW: recompute over the merged bytes
            old = bytearray(self.store.read(coll, oid)) \
                if old_size is not None else bytearray()
            if len(old) < shard_size:
                old.extend(b"\0" * (shard_size - len(old)))
            old[chunk_off:chunk_off + len(data)] = data
            crc = crcmod.crc32c(0xFFFFFFFF, bytes(old[:shard_size]))
        txn = Transaction()
        if pre_ops:
            # snapshot pre-ops (shard-local COW clone + snapset) must land
            # in the same transaction, BEFORE the new bytes
            txn.ops.extend(tuple(op) for op in pre_ops)
        # rollback record (ecbackend.rst:10-27): the exact pre-write state
        # of the touched shard range, so peering can REWIND this entry if
        # the write never completes cluster-wide; pruned at commit
        existed = old_size is not None
        rec = {
            "oid": oid, "existed": existed, "chunk_off": chunk_off,
            "old_range": (bytes(self.store.read(coll, oid, chunk_off,
                                                len(data)))
                          if existed else b""),
            "old_total": old_size or 0,
            "old_attrs": {k: self.store.getattr(coll, oid, k)
                          for k in ("shard", "size", "hinfo_crc")},
            "old_version": self.store.get_version(coll, oid),
        }
        txn.omap_set(coll, PGRB,
                     {self._rb_key(hinfo["version"]): pickle.dumps(rec)})
        txn.write(coll, oid, chunk_off, data) \
           .truncate(coll, oid, shard_size) \
           .setattr(coll, oid, "shard", str(shard).encode()) \
           .setattr(coll, oid, "size", str(hinfo["size"]).encode()) \
           .setattr(coll, oid, "hinfo_crc", str(crc).encode()) \
           .set_version(coll, oid, hinfo["version"])
        self.store.queue_transaction(txn)

    def _apply_shard_planar(self, pgid: PGid, oid: str, shard: int,
                            data: bytes, chunk_off: int, shard_size: int,
                            hinfo: Dict,
                            pre_ops: Optional[List[Tuple]] = None) -> None:
        """Planar-at-rest twin of ``_apply_shard``: ``data``
        is an (8, cols) plane window serialized row-major — the SAME
        bytes the encode produced and the wire carried — and it lands
        via the store's ``write_planar`` op without ever materializing
        the byte view.  The cumulative hinfo crc stays bit-identical to
        the byte anchor because crc32c over plane-major rows uses the
        column-spread identity (ops/crc32c.crc32c_planar_rows), so
        verify-on-read and scrub agree across mixed-layout members."""
        coll = _coll(pgid)
        Q = planar_store.QUANTUM
        if chunk_off % Q or len(data) % Q:
            raise ValueError(f"{oid}: unaligned planar sub-write "
                             f"(off={chunk_off}, len={len(data)})")
        old_size = self.store.stat(coll, oid)
        old_layout = self.store.object_layout(coll, oid)
        cols = shard_size // Q
        col_off = chunk_off // Q
        window = planar_store.blob_to_planes(data)
        if col_off + window.shape[1] > cols:
            # window overshoots the final shard (byte path: write then
            # truncate) — clip COLUMNS, not blob bytes: the serialized
            # form is row-major so a byte-level cut would shear rows
            window = window[:, :cols - col_off]
            data = planar_store.planes_to_blob(window)
        if chunk_off == 0 and window.shape[1] >= cols:
            # full-shard rewrite: the tick's batch-computed plane-major
            # crc when the primary shipped one; else one host pass here
            crc = hinfo.get("crc")
            if crc is None:
                crc = crcmod.crc32c_planar_rows(window)[0]
        elif old_size is not None and chunk_off == old_size and \
                shard_size == chunk_off + len(data) and \
                self.store.getattr(coll, oid, "hinfo_crc") is not None:
            # append: combine the stored cumulative crc with the delta
            # window's crc (GF(2) zero-extension) — no whole-shard pass,
            # and the delta crc comes straight off the planes
            stored = int(self.store.getattr(coll, oid, "hinfo_crc"))
            crc = crcmod.crc32c_combine(
                stored, crcmod.crc32c_planar_rows(window, seed=0)[0],
                len(data))
        else:
            # true mid-shard RMW (or no stored crc): splice the window
            # into the old plane matrix and crc the merge — plane-major
            # throughout, zero byte-view materializations
            old = None
            if old_size is not None:
                if old_layout == planar_store.LAYOUT_PLANAR:
                    old = planar_store.blob_to_planes(
                        self.store.read_planar(coll, oid))
                else:
                    # byte-at-rest pre-state meeting a planar write: the
                    # one legal relayout hop — the STORE books it when
                    # the write_planar op lands, so seam=None here
                    raw = bytes(self.store.read(coll, oid))
                    if len(raw) % Q:
                        raw += b"\0" * (Q - len(raw) % Q)
                    old = planar_store.shard_to_planes(raw, seam=None)
            merged = planar_store.splice_columns(old, col_off, window,
                                                 cols)
            crc = crcmod.crc32c_planar_rows(merged)[0]
        txn = Transaction()
        if pre_ops:
            txn.ops.extend(tuple(op) for op in pre_ops)
        # rollback record: planar pre-state is captured WHOLE-OBJECT as
        # the raw stored blob (plane-major for planar members, logical
        # bytes for a byte-at-rest pre-state) so the peering rewind can
        # restore it without any layout conversion — rec["layout"]
        # tells pg.rewind_divergent_log which restore op to emit
        existed = old_size is not None
        if existed and old_layout == planar_store.LAYOUT_PLANAR:
            old_range = self.store.read_planar(coll, oid)
        elif existed:
            old_range = bytes(self.store.read(coll, oid))
        else:
            old_range = b""
        rec = {
            "oid": oid, "existed": existed, "chunk_off": 0,
            "old_range": old_range,
            "old_total": old_size or 0,
            "layout": old_layout,
            "old_attrs": {k: self.store.getattr(coll, oid, k)
                          for k in ("shard", "size", "hinfo_crc")},
            "old_version": self.store.get_version(coll, oid),
        }
        txn.omap_set(coll, PGRB,
                     {self._rb_key(hinfo["version"]): pickle.dumps(rec)})
        # ONE op covers the byte path's write+truncate pair: total_cols
        # pins the final shard extent, so no separate truncate
        txn.write_planar(coll, oid, col_off, data, cols) \
           .setattr(coll, oid, "shard", str(shard).encode()) \
           .setattr(coll, oid, "size", str(hinfo["size"]).encode()) \
           .setattr(coll, oid, "hinfo_crc", str(crc).encode()) \
           .set_version(coll, oid, hinfo["version"])
        self.store.queue_transaction(txn)

    def _apply_ec_sub_write(self, msg: M.MOSDECSubOpWrite) -> None:
        """Apply one shard sub-write (store txn + log) — the shared
        core of the single-frame and batched handlers."""
        # replica-side span: joins the primary's op tree via the sub-op
        # trace header (NULL_SPAN when untraced/disabled)
        tr = getattr(msg, "trace", None)
        span = self.tracer.start(
            "ec_sub_write", trace_id=tr.get("id"),
            parent_id=tr.get("span")) if tr else None
        try:
            shard_size = msg.shard_size if msg.shard_size is not None \
                else msg.chunk_off + len(msg.data)
            self._apply_shard(msg.pgid, msg.oid, msg.shard, msg.data,
                              msg.chunk_off, shard_size, msg.hinfo,
                              pre_ops=msg.pre_ops,
                              layout=getattr(msg, "layout", None))
            st = self.pgs.get(msg.pgid)
            if st is not None and msg.entry is not None:
                self._log_mutation(st, msg.entry.op, msg.entry.oid,
                                   msg.entry.version, entry=msg.entry)
            self.perf.inc("osd_ec_sub_writes")
        finally:
            if span is not None:
                span.annotate(shard=msg.shard, oid=msg.oid)
                span.finish()

    def _sub_write_gapped(self, msg: M.MOSDECSubOpWrite) -> bool:
        """A client mutation's sub-write (one that carries the client's
        deadline; recovery pushes carry none and may skip superseded
        entries) whose entry does not follow this member's log head: an
        earlier sub-write of the PG never arrived here (a dropped batch
        item, a member that joined acting before it was recovered).
        Applying it would put the head past an object this member does
        not hold, and peering, which compares heads, would never push
        that object: the member refuses it instead, the op stays
        un-acked, and the primary queues a recovery round that resyncs
        it (``_ec_commit_finish``).  A sub-write issued on a map older
        than the newest interval a peering query announced here
        (``PGState.peer_interval``) is refused the same way."""
        if msg.entry is None or msg.deadline is None:
            return False
        st = self.pgs.get(msg.pgid)
        if st is None:
            return False
        if msg.epoch < st.peer_interval:
            # issued on a map older than the interval whose peering query
            # this member already answered (Ceph's can_discard_replica_op):
            # that round's log choice did not see this entry, so the
            # write must not complete
            return True
        if msg.entry.version <= st.last_update:
            return False
        return st.last_update < msg.entry.prior_version

    async def _handle_ec_write(self, conn: Connection,
                               msg: M.MOSDECSubOpWrite) -> None:
        if self._sub_op_expired(msg):
            # dead work: the parent op's client deadline passed — no
            # apply, no reply (the primary times out and stays un-acked,
            # so a shed shard can never count toward durability)
            return
        if self._sub_write_gapped(msg):
            self.perf.inc("osd_ec_sub_write_gaps")
            await self._reply_osd(conn, msg, M.MOSDECSubOpWriteReply(
                reqid=msg.reqid, result=-11))
            return
        self._apply_ec_sub_write(msg)
        await self._reply_osd(conn, msg, M.MOSDECSubOpWriteReply(
            reqid=msg.reqid, result=0))

    async def _handle_ec_write_batch(self, conn: Connection,
                                     msg: M.MOSDECSubOpWriteBatch) -> None:
        """A peer's tick batch: apply every item in list order, ack them
        in ONE reply.  Expired items are silently absent from the
        results — the shed contract of the unbatched path."""
        results = []
        for item in msg.items:
            if results:
                # crash seam: peer dies MID-TICK — some of the frame's
                # items applied (and will ack via nothing), the rest
                # never land; the primaries' acks all die with us
                self._chaos_point("batch_apply_mid")
            if self._sub_op_expired(item):
                continue
            if self._sub_write_gapped(item):
                # refused: its primary's op fails at once
                self.perf.inc("osd_ec_sub_write_gaps")
                results.append((item.reqid, -11, item.shard))
                continue
            try:
                self._apply_ec_sub_write(item)
            except Exception:
                # per-item fault isolation: one item's failure (e.g. a
                # chaos store injection) must not abort the rest of the
                # frame or their acks — the failed item simply never
                # acks, so ITS primary alone stays un-acked (the
                # unbatched path's one-op blast radius)
                self.perf.inc("osd_dispatch_errors")
                continue
            results.append((item.reqid, 0, item.shard))
        await self._reply_osd(conn, msg, M.MOSDECSubOpWriteBatchReply(
            results=results))

    async def _handle_ec_read(self, conn: Connection,
                              msg: M.MOSDECSubOpRead) -> None:
        if self._sub_op_expired(msg):
            return  # nobody awaits: shed instead of burning device time
        coll = _coll(msg.pgid)
        # a planar-at-rest shard is read, verified, sliced and
        # SHIPPED as its plane matrix — zero layout conversions on this
        # holder (whole-object pulls, shard == -1, stay on bytes: they
        # come from the replicated pull path, which stores bytes)
        planar = (msg.shard != -1 and
                  self.store.object_layout(coll, msg.oid)
                  == planar_store.LAYOUT_PLANAR)
        try:
            full = (self.store.read_planar(coll, msg.oid) if planar
                    else self.store.read(coll, msg.oid))
        except FileNotFoundError:
            await self._reply_osd(conn, msg, M.MOSDECSubOpReadReply(
                reqid=msg.reqid, result=-2, shard=msg.shard))
            return
        except IOError:
            # media EIO: DISTINCT from absent (-2) — the gatherer
            # queues this shard for in-place read-repair
            self.perf.inc("osd_read_shard_errors")
            await self._reply_osd(conn, msg, M.MOSDECSubOpReadReply(
                reqid=msg.reqid, result=-5, shard=msg.shard))
            return
        stored_crc = self.store.getattr(coll, msg.oid, "hinfo_crc")
        # the attrs that describe these bytes, read with them: the
        # verify below awaits a read-coalescer tick, and a sub-write
        # applied meanwhile would otherwise label the old bytes with its
        # new version and size (a reply the gatherer then decodes with
        # newer shards into a torn object)
        shard_attr = self.store.getattr(coll, msg.oid, "shard")
        size = self.store.getattr(coll, msg.oid, "size")
        version = self.store.get_version(coll, msg.oid)
        xattrs = dict(self.store.get_xattrs(coll, msg.oid)) \
            if msg.shard == -1 else None
        # verify-on-read: the shard crc checks
        # against the stored hinfo before any byte leaves this holder
        # (ecbackend.rst:86-99); concurrent sub-reads on this daemon
        # share one crc32c batch through the read coalescer — planar
        # shards verify over plane-major rows via the spread identity,
        # bit-identical to the byte anchor's cumulative crc
        if stored_crc is not None and self.config.osd_ec_verify_reads:
            [ok] = await self._read_batcher.verify([full],
                                                   [int(stored_crc)],
                                                   planar=planar)
            if not ok:
                self.perf.inc("osd_read_shard_crc_errors")
                await self._reply_osd(conn, msg, M.MOSDECSubOpReadReply(
                    reqid=msg.reqid, result=-5, shard=msg.shard))
                return
        out_layout = None
        if planar:
            Q = planar_store.QUANTUM
            if msg.off % Q == 0 and (msg.length is None
                                     or msg.length % Q == 0):
                # sub-range by COLUMN slice of the plane matrix — every
                # chunk-aligned gather lands here (unit % 8 == 0 gates
                # planar mode, so chunk offsets are always 8-aligned)
                planes = planar_store.blob_to_planes(full)
                hi = (msg.off + msg.length) // Q \
                    if msg.length is not None else None
                data = planar_store.planes_to_blob(
                    planes[:, msg.off // Q: hi])
                out_layout = planar_store.LAYOUT_PLANAR
            else:
                # unaligned range: correctness-only byte fallback (books
                # the unseamed counter; never hit by aligned gathers)
                full = self.store.read(coll, msg.oid)
                data = full[msg.off: msg.off + msg.length] \
                    if msg.length is not None else full[msg.off:]
        else:
            data = full[msg.off: msg.off + msg.length] \
                if msg.length is not None else full[msg.off:]
        shard = int(shard_attr) if shard_attr else msg.shard
        hinfo = {"size": int(size) if size else 0,
                 # version on EVERY reply: the gatherer groups shards
                 # by generation before decoding (stale-member guard)
                 "version": version}
        if msg.shard == -1:
            # whole-object fetch (pull recovery): carry xattrs so the
            # puller stores a faithful copy
            hinfo["xattrs"] = xattrs
        await self._reply_osd(conn, msg, M.MOSDECSubOpReadReply(
            reqid=msg.reqid, result=0, shard=shard, data=data,
            hinfo=hinfo, layout=out_layout))
        self.perf.inc("osd_ec_sub_reads")

    def _hedge_delay(self) -> float:
        """Straggler-hedge delay for degraded k-of-n reads: the p90 of
        recent sub-read gather latencies x2, floored by config and
        capped well under the op timeout — a slow shard holder costs
        one quantile, not a full timeout."""
        floor = self.config.osd_ec_hedge_delay_floor
        lats = sorted(self._subread_lats)
        if not lats:
            return floor * 4
        q = lats[min(len(lats) - 1, (9 * len(lats)) // 10)]
        return min(max(2.0 * q, floor),
                   self.config.osd_client_op_timeout / 4.0)

    async def _subread_round(self, st: PGState, oid: str, targets,
                             off: int, length: Optional[int],
                             spare=None, check=None) -> List:
        """One shard sub-read fan-out: contact ``targets``, promoting a
        ``spare`` shard holder immediately when a send fails outright
        (dead peer), and hedging the remaining spares after the
        quantile-derived delay (slow peer).  ``check(acc)`` resolves the
        waiter early — typically "k same-generation shards arrived".
        Returns the (result, reply) accumulator."""
        from ceph_tpu_torch.cluster.optracker import mark_current
        from ceph_tpu_torch.cluster.pg import CURRENT_OP_DEADLINE

        spare = list(spare or [])
        reqid = self._next_reqid()
        fut = self._make_waiter(reqid, len(targets))
        if check is not None:
            fut.check = check  # type: ignore[attr-defined]
        sub_deadline = CURRENT_OP_DEADLINE.get()

        async def _send_one(shard: int, osd: int) -> bool:
            try:
                await self._send_osd(osd, M.MOSDECSubOpRead(
                    reqid=reqid, pgid=st.pgid, oid=oid, shard=shard,
                    off=off, length=length, deadline=sub_deadline))
                return True
            except (ConnectionError, OSError, RuntimeError):
                return False

        pending = list(targets)
        while pending:
            shard, osd = pending.pop(0)
            if await _send_one(shard, osd):
                continue
            if spare:
                # dead shard holder: promote a spare NOW instead of
                # shrinking the gather below k
                pending.append(spare.pop(0))
                self.perf.inc("osd_ec_hedge_promotions")
            else:
                self._waiter_dec(reqid)
        mark_current("ec_sub_read_sent")
        hedge_task = None
        if spare and not fut.done():
            delay = self._hedge_delay()

            async def _hedge():
                await asyncio.sleep(delay)
                if fut.done() or self._stopped:
                    return
                # a straggler is late past the quantile: widen the
                # gather so a slow holder degrades latency, not
                # availability
                self.perf.inc("osd_ec_hedged_reads")
                mark_current("ec_hedge_sent")
                for shard, osd in spare:
                    fut.needed += 1  # type: ignore[attr-defined]
                    if not await _send_one(shard, osd):
                        self._waiter_dec(reqid)

            hedge_task = self._track(
                asyncio.get_event_loop().create_task(_hedge()))
        t0 = asyncio.get_event_loop().time()
        try:
            if fut.done():
                acc = fut.result()
            else:
                acc = await asyncio.wait_for(
                    fut, timeout=self._ack_wait_timeout())
            mark_current("sub_read_acked")
            self._subread_lats.append(
                asyncio.get_event_loop().time() - t0)
        except asyncio.TimeoutError:
            acc = self._pending[reqid][1]
        finally:
            self._pending.pop(reqid, None)
            if hedge_task is not None:
                hedge_task.cancel()
        return acc

    async def _gather_shards(
        self, pool: PGPool, st: PGState, oid: str, need_k: int,
        off: int = 0, length: Optional[int] = None,
        exclude_shards: Optional[Set[int]] = None,
        fast_k: bool = False,
    ) -> Tuple[Dict[int, bytes], int, int, Dict[int, Optional[str]]]:
        """Collect >= k shard (ranges) from the acting set (own shard
        free).  ``exclude_shards``: shard ids known corrupt — they must
        never be decode sources (scrub repair would otherwise reconstruct
        FROM the corruption and bless it).  ``fast_k``: degraded-mode
        client reads — contact only the first k shard holders, resolve
        on the first k clean same-generation shards, and hedge/promote
        stragglers instead of gathering the full group.

        the 4th return maps each CHOSEN shard id to the
        layout its payload arrived in (``"planar8"`` plane matrices
        from planar-at-rest holders, None for byte ranges) — payload
        lengths are identical either way, so the generation grouping
        and size checks below are layout-blind.

        Verified reads: the LOCAL shard's crc checks against
        its stored hinfo before it may feed a decode (riding the read
        coalescer's per-tick crc batch; peers verify their own shards
        in _handle_ec_read), and any shard that fails crc, returns EIO,
        or proves generation-stale queues an ASYNCHRONOUS in-place
        read-repair — never on the client's critical path."""
        exclude_shards = exclude_shards or set()
        coll = _coll(st.pgid)
        # shard id -> why it needs repair ("crc" | "eio" | "stale")
        repair: Dict[int, str] = {}
        # (shard -> (bytes, version, size, layout)): versions gate which
        # shards may decode together — a stale rejoined member's shard
        # from an older generation mixed with current shards would
        # decode to garbage (the reference compares per-shard
        # object_info versions when gathering,
        # ECBackend::handle_sub_read_reply)
        got: Dict[int, Tuple[bytes, int, int, Optional[str]]] = {}
        my = self.store.stat(coll, oid)
        if my is not None:
            shard_attr = self.store.getattr(coll, oid, "shard")
            local_shard = int(shard_attr) if shard_attr is not None \
                else None
            Q = planar_store.QUANTUM
            # planar-at-rest local shard with an aligned range: read
            # the plane blob, verify plane-major, slice COLUMNS — the
            # byte view is never materialized
            lp = (self.store.object_layout(coll, oid)
                  == planar_store.LAYOUT_PLANAR and off % Q == 0
                  and (length is None or length % Q == 0))
            data = full = None
            try:
                if lp:
                    full = self.store.read_planar(coll, oid)
                elif self.config.osd_ec_verify_reads:
                    # the cumulative crc covers the WHOLE shard: read
                    # it all, verify, then slice the requested range
                    full = self.store.read(coll, oid)
                else:
                    data = self.store.read(coll, oid, off, length)
            except IOError:
                # local-shard media error (chaos disk EIO): our own
                # shard is absent from the gather — decode from peers,
                # mirroring the peer-side path — and queues repair
                # (counted like the peer-side detection, so EIOs that
                # only ever hit primaries still move the counter)
                self.perf.inc("osd_read_shard_errors")
                if local_shard is not None:
                    repair[local_shard] = "eio"
            # the local shard's size and version, read with its bytes:
            # the verify below awaits a tick, across which a write can
            # land newer attrs on older bytes (_handle_ec_read's race)
            sa = self.store.getattr(coll, oid, "size")
            local_version = self.store.get_version(coll, oid)
            if full is not None:
                stored = self.store.getattr(coll, oid, "hinfo_crc")
                ok = True
                if stored is not None and \
                        self.config.osd_ec_verify_reads:
                    [ok] = await self._read_batcher.verify(
                        [full], [int(stored)], planar=lp)
                if ok:
                    if lp:
                        planes = planar_store.blob_to_planes(full)
                        hi = (off + length) // Q \
                            if length is not None else None
                        data = planar_store.planes_to_blob(
                            planes[:, off // Q: hi])
                    else:
                        data = full[off:] if length is None \
                            else full[off: off + length]
                else:
                    self.perf.inc("osd_read_shard_crc_errors")
                    if local_shard is not None:
                        repair[local_shard] = "crc"
            if data is not None and local_shard is not None and \
                    local_shard not in exclude_shards and \
                    local_shard not in repair:
                got[local_shard] = (
                    data,
                    local_version,
                    int(sa) if sa else 0,
                    planar_store.LAYOUT_PLANAR if lp else None)
        committed_seq = st.last_complete[1]

        def _committed(v: int) -> bool:
            # at/below the watermark, OR a resolved frontier entry the
            # contiguous-prefix sweep hasn't reached
            return v <= committed_seq or st.frontier_acked(v)

        peers = [(shard, osd) for shard, osd in enumerate(st.acting)
                 if osd not in (self.osd_id, CRUSH_ITEM_NONE)
                 and shard not in got and shard not in exclude_shards]
        if peers and len(got) < need_k:
            want = need_k - len(got)
            fast = (fast_k and bool(self.config.osd_ec_hedge_reads)
                    and len(peers) > want)
            if fast:
                # the object's newest logged generation: when the pg
                # log still covers the object, early-resolve ONLY on
                # exactly that generation — k shards of an OLDER
                # committed generation (just-revived members not yet
                # recovered) must never outvote an unseen newer one.
                # Objects past the log window have had no recent
                # writes, so no newer generation can exist to miss
                # (kill victims boot empty and reply ENOENT, they
                # don't serve stale bytes).
                logged_ver = next(
                    (e.version[1] for e in reversed(st.log.entries)
                     if e.oid == oid), None)

                def _viable(acc, _local=dict(got), _c=_committed,
                            _k=need_k, _lv=logged_ver):
                    """k same-generation shards at/below the commit
                    watermark — pinned to the logged generation when
                    the log knows it."""
                    byver: Dict[int, set] = {}
                    for s, (_d, v, _sz, _ly) in _local.items():
                        byver.setdefault(v, set()).add(s)
                    for result, reply in acc:
                        if result == 0 and reply is not None:
                            byver.setdefault(
                                reply.hinfo.get("version", 0),
                                set()).add(reply.shard)
                    if _lv is not None and _c(_lv):
                        ss = byver.get(_lv)
                        return ss is not None and len(ss) >= _k
                    return any(_c(v) and len(ss) >= _k
                               for v, ss in byver.items())

                acc = await self._subread_round(
                    st, oid, peers[:want], off, length,
                    spare=peers[want:], check=_viable)
                if _viable(acc):
                    self.perf.inc("osd_ec_fastk_reads")
                else:
                    # fast path came up short (mixed generations, dead
                    # holders, un-acked head): widen to every shard not
                    # yet heard from — correctness never rests on the
                    # fast path
                    heard = {r.shard for res, r in acc
                             if res == 0 and r is not None}
                    rest = [(s, o) for s, o in peers if s not in heard]
                    if rest:
                        acc = acc + await self._subread_round(
                            st, oid, rest, off, length)
            else:
                acc = await self._subread_round(st, oid, peers, off,
                                                length)
            for result, reply in acc:
                if result == 0 and reply is not None:
                    got[reply.shard] = (
                        reply.data,
                        reply.hinfo.get("version", 0),
                        reply.hinfo.get("size", 0),
                        getattr(reply, "layout", None))
                elif result == -5 and reply is not None and \
                        reply.shard >= 0:
                    # the holder found its shard corrupt (crc) or
                    # unreadable (EIO): absent from the decode, queued
                    # for in-place repair
                    repair.setdefault(reply.shard, "crc")
        try:
            # staleness judged against the START-of-gather watermark
            # snapshot: a write committing mid-gather must not flag
            # members whose replies simply predate their own apply
            # (choose_decode_group stays the layout-blind 3-tuple pure
            # function the corruption-matrix tests drive directly)
            shards, size, version, stale = choose_decode_group(
                {s: (d, v, sz) for s, (d, v, sz, _ly) in got.items()},
                need_k, _committed,
                committed_before=lambda v: v <= committed_seq)
        except IOError as e:
            raise IOError(f"{oid}: {e}") from None
        for s in stale:
            repair.setdefault(s, "stale")
        if repair:
            self._queue_read_repair(pool, st, oid, repair)
        layouts = {s: got[s][3] for s in shards}
        return shards, size, version, layouts

    # attempts of one read-repair whose rebuild the map made incomplete
    READ_REPAIR_TRIES = 5

    def _queue_read_repair(self, pool: PGPool, st: PGState, oid: str,
                           bad: Dict[int, str]) -> None:
        """Arm ONE asynchronous in-place repair for shards a gather
        found bad (crc mismatch, media EIO, generation-stale): the
        object is reconstructed from the surviving shards — the bad
        ones excluded as decode sources — and rewritten on the affected
        members, OFF the client's critical path (the read that detected
        the corruption already decoded from survivors and returned).
        The PG rides the inconsistent -> clean health flow: the object
        joins ``st.inconsistent`` (beacon-fed PG_INCONSISTENT /
        OSD_SCRUB_ERRORS warnings) until the repair lands."""
        if not self.config.osd_read_repair or self._stopped or \
                st.primary != self.osd_id:
            return
        key = (st.pgid, oid)
        if key in self._read_repairs_inflight:
            return
        self._read_repairs_inflight.add(key)
        st.inconsistent.add(oid)
        reasons = dict(bad)

        async def _repair() -> None:
            try:
                for attempt in range(self.READ_REPAIR_TRIES):
                    if attempt:
                        # the rebuild was incomplete: say a member of a
                        # bad slot left acting while the shards were
                        # gathered (the map moved).  The reference counts
                        # such a rebuild done and clears the object; this
                        # rebuild says it is not, so the repair tries
                        # again on the map of its next attempt
                        await asyncio.sleep(0.25 * attempt)
                    if self._stopped or st.primary != self.osd_id:
                        return
                    # each attempt's targets: whoever holds a bad slot
                    # in acting now
                    targets = sorted({st.acting[s] for s in reasons
                                      if s < len(st.acting)
                                      and st.acting[s] != CRUSH_ITEM_NONE})
                    # the object write lock excludes concurrent writes to
                    # THIS object while the rebuild is being stamped (the
                    # scrub path holds st.lock for the same reason); other
                    # objects of the PG proceed
                    async with self._obj_write_lock(st, oid):
                        ok = await self._recover_ec_object(
                            pool, st, oid, targets=targets,
                            exclude_sources=set(reasons))
                    if ok:
                        self.perf.inc("osd_read_repairs")
                        st.inconsistent.discard(oid)
                        self.clog(
                            "WRN",
                            f"pg {st.pgid} read-repair: {oid} shards "
                            f"{reasons} rebuilt on osds {targets}")
                        return
                # not repaired: the object stays inconsistent — the
                # scheduled scrub (or the next detecting read) retries
            except asyncio.CancelledError:
                raise
            except Exception:
                self.perf.inc("osd_read_repair_errors")
            finally:
                self._read_repairs_inflight.discard(key)

        self._track(asyncio.get_event_loop().create_task(_repair()))

    async def _ec_read_stripes(self, pool: PGPool, st: PGState, oid: str,
                               chunk_off: int, logical_len: int,
                               expected_size: Optional[int] = None) -> bytes:
        """Read a stripe-aligned logical range: gather the touched chunk
        range from >= k shards and decode it as a mini-object.  When the
        caller computed the range from a size it assumed (its local size
        attr), pass ``expected_size``: a disagreeing decode group raises
        ECSizeMismatch BEFORE the under/over-fetch can fail or truncate,
        so the caller re-ranges against the group's size."""
        import numpy as np

        from ceph_tpu_torch.cluster.optracker import mark_current

        codec = self._codec(pool)
        sinfo = self._sinfo(pool, codec)
        k = codec.get_data_chunk_count()
        nstripes = sinfo.object_stripes(logical_len)
        chunk_len = nstripes * sinfo.chunk_size
        # degraded-mode client read: first k clean shards decode, a
        # slow/dead holder is hedged/promoted instead of awaited
        shards, gsize, _, layouts = await self._gather_shards(
            pool, st, oid, k, off=chunk_off, length=chunk_len,
            fast_k=True)
        if expected_size is not None and shards and gsize != expected_size:
            raise ECSizeMismatch(gsize)
        planar = self._planar_mode(codec, sinfo)
        avail = {}
        for s, d in shards.items():
            if len(d) != chunk_len:
                continue
            shard_planar = layouts.get(s) == planar_store.LAYOUT_PLANAR
            if planar:
                # steady state: the holder shipped planes and the
                # decode consumes planes — blob_to_planes is a reshape,
                # not a conversion.  A byte reply (mixed-generation
                # member still byte-at-rest) takes the one legal
                # relayout hop on the gather edge.
                avail[s] = planar_store.blob_to_planes(d) \
                    if shard_planar \
                    else planar_store.shard_to_planes(d, seam="relayout")
            else:
                if shard_planar:
                    # byte-mode decode of a still-planar holder's reply
                    # (gate just flipped off): normalize — legal, never
                    # on the pinned steady-state path
                    d = planar_store.planes_to_shard(
                        planar_store.blob_to_planes(d), seam="relayout")
                avail[s] = np.frombuffer(d, dtype=np.uint8)
        if len(avail) < k:
            raise IOError(
                f"only {len(avail)} of {k} shard ranges for {oid}")
        # the decode rides the read coalescer — a tick's read
        # gathers share one layout conversion + one fused decode batch
        #
        out = await self._read_batcher.decode(
            codec, sinfo, avail, logical_len, planar=planar)
        if planar:
            # the assemble's planes -> logical-bytes hop was this op's
            # one sanctioned egress conversion — stamp it so
            # `bench.py --attribute` books it as planar_convert
            mark_current("planar_egress")
        return out

    async def _ec_read(self, pool: PGPool, st: PGState, oid: str,
                       offset: int = 0, length: Optional[int] = None) -> bytes:
        """objects_read_async analog: min shards + batched device decode
        (ECBackend.cc:2111,1588,2262)."""
        coll = _coll(st.pgid)
        sa = self.store.getattr(coll, oid, "size")
        if sa is None:
            # primary lost its shard (or never had one): probe peers
            codec = self._codec(pool)
            shards, size, _, _ = await self._gather_shards(
                pool, st, oid, codec.get_data_chunk_count(), 0, 0)
            if not shards and size == 0:
                raise FileNotFoundError(oid)
        else:
            size = int(sa)
        codec = self._codec(pool)
        sinfo = self._sinfo(pool, codec)
        # the object length is a property of the GENERATION being read:
        # when the decode group disagrees with our local size attr (our
        # own shard is stale), re-range against the group's size instead
        # of truncating/overstretching its bytes to the local length
        for attempt in range(2):
            want = max(0, size - offset) if length is None else length
            if want == 0 or offset >= size:
                return b""
            want = min(want, size - offset)
            off0, len0 = sinfo.offset_len_to_stripe_bounds(offset, want)
            len0 = min(len0, max(0, size - off0))
            chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(off0)
            try:
                out = await self._ec_read_stripes(
                    pool, st, oid, chunk_off, len0, expected_size=size)
            except ECSizeMismatch as e:
                if attempt:
                    raise IOError(f"{oid}: object size unstable "
                                  "(write or recovery in flight)")
                size = e.size
                continue
            return out[offset - off0: offset - off0 + want]
        raise IOError(f"{oid}: unreadable")  # unreachable

    async def _recover_ec_object(self, pool: PGPool, st: PGState, oid: str,
                                 targets: Optional[List[int]] = None,
                                 entry: Optional[LogEntry] = None,
                                 exclude_sources: Optional[Set[int]] = None,
                                 ) -> bool:
        """Reconstruct shards for the target members (batched device decode +
        encode, ECBackend::run_recovery_op analog).  targets=None rebuilds
        every acting member's shard; exclude_sources keeps known-corrupt
        shard ids out of the decode.  Returns False when the object is
        currently unrecoverable (fewer than k shard sources)."""
        import numpy as np

        codec = self._codec(pool)
        sinfo = self._sinfo(pool, codec)
        k = codec.get_data_chunk_count()
        shards, size, group_version, layouts = await self._gather_shards(
            pool, st, oid, k, exclude_shards=exclude_sources)
        shard_len = sinfo.shard_size(size)
        planar = self._planar_mode(codec, sinfo)
        avail = {}
        for s, d in shards.items():
            if len(d) != shard_len:
                continue
            shard_planar = layouts.get(s) == planar_store.LAYOUT_PLANAR
            if planar:
                # steady state: sources shipped planes, the rebuild
                # decodes AND re-encodes in the plane domain, and the
                # pushed shards land as planes — conversion-free end to
                # end; byte replies (mixed members) relayout once here
                avail[s] = planar_store.blob_to_planes(d) \
                    if shard_planar \
                    else planar_store.shard_to_planes(d, seam="relayout")
            else:
                if shard_planar:
                    d = planar_store.planes_to_shard(
                        planar_store.blob_to_planes(d), seam="relayout")
                avail[s] = np.frombuffer(d, dtype=np.uint8)
        if len(avail) < k:
            self.perf.inc("osd_unrecoverable")
            return False
        # decode + re-encode in ONE round trip through the read
        # coalescer: concurrent recovery rebuilds of a tick
        # share a layout conversion + fused decode/encode batch; on CPU
        # jax backends the rebuild runs the table-driven host GF engine
        # like the coalesced write path (engine-per-backend)
        chunks = await self._read_batcher.reencode(
            codec, sinfo, avail, size, planar=planar)
        out_layout = planar_store.LAYOUT_PLANAR if planar else None
        # stamp the rebuilt shards with the DECODE GROUP's version, not
        # our local one: a primary whose own shard is newer (or staler)
        # than the group it decoded from would otherwise relabel old
        # bytes as new, and a later read could mix generations that
        # claim the same version (surfaced by graft-chaos as torn reads)
        version = max(group_version, 1)
        hinfo = {"size": size, "version": version}
        ok = True
        # each target's shard slot: its place in acting, or, for a pg_temp
        # handoff member outside acting, its place in up.  A target with
        # neither (the map moved it while the shards were gathered) gets
        # nothing, and the rebuild is incomplete: a backfill that counted
        # it done would log_sync a member that lacks the object
        acting, up = list(st.acting), list(st.up)
        slots = [(shard, osd) for shard, osd in enumerate(acting)
                 if osd != CRUSH_ITEM_NONE
                 and (targets is None or osd in targets)]
        for osd in targets or ():
            if osd not in acting:
                if osd in up:
                    slots.append((up.index(osd), osd))
                else:
                    self.perf.inc("osd_recovery_target_moved")
                    ok = False
        for shard, osd in slots:
            blob = chunks[shard].tobytes()
            if osd == self.osd_id:
                self._apply_shard(st.pgid, oid, shard, blob, 0,
                                  shard_len, hinfo, layout=out_layout)
            else:
                try:
                    await self._send_osd(osd, M.MOSDECSubOpWrite(
                        reqid=self._next_reqid(), pgid=st.pgid, oid=oid,
                        shard=shard, data=blob, chunk_off=0,
                        shard_size=shard_len, hinfo=hinfo, entry=entry,
                        epoch=self.osdmap.epoch, layout=out_layout))
                    self.perf.inc("osd_pushes_sent")
                except ConnectionError:
                    # target unreachable: the rebuild did NOT land there —
                    # report incompleteness so the recovery round retries
                    ok = False
        return ok
