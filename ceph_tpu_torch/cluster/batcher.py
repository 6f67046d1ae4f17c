"""Per-tick stripe-batch coalescing: the OSD's group-commit encode seam.

Counterpart of ``ceph_tpu/cluster/batcher.py``.

Round 11 (ROADMAP items 1-2): concurrent EC writes must stop crossing
the host/device boundary alone.  Every `_ec_write` submits its stripe
range here instead of dispatching its own encode; requests that arrive
while a tick is in flight accumulate, and the next tick encodes ALL of
them as one `PlanarBatch` round trip (`ec/stripe.encode_stripes_multi`:
one layout conversion, one launch of kernel B1 or B2 on the codec's
device, one crc32c batch), scattering shard rows back to each op's
sub-write fan-out.

The tick is SELF-CLOCKING (group commit): a request hitting an idle
profile encodes immediately — a lone op (t1 latency) never waits — and
under load the encode-in-flight window is exactly what accumulates the
next tick's batch.  That also gives the double-buffering the design
calls for: while tick T encodes in the executor, tick T-1's ops are
already fanning out sub-writes and tick T+1 is accumulating.
`osd_batch_tick_ops` bounds a tick's batch; `osd_batch_tick_window`
optionally stretches accumulation after an idle-start request.

This module is the ONE sanctioned device-dispatch seam for per-op EC
encodes under cluster/.

Devices: an encode, decode or reencode tick runs on its codec's device
(every tensor of the tick is made there, so a tick in an executor thread
never relies on that thread's current CUDA device); a verify tick runs
on the OSD's ``device`` (``utils/device.resolve_device``: CUDA unless
the OSD names another).  Results cross back as numpy arrays and ints,
never as tensors, so no device state rides a message.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Tuple

from ceph_tpu_torch.utils.device import resolve_device


class _Req:
    __slots__ = ("data", "want_crc", "fut")

    def __init__(self, data, want_crc: bool, fut: asyncio.Future):
        self.data = data
        self.want_crc = want_crc
        self.fut = fut


class SubWriteBatcher:
    """Per-peer group commit for EC shard sub-writes: the tick's
    sub-writes destined for one peer ride ONE MOSDECSubOpWriteBatch
    frame (one pickle, one session frame, one transport ack, one
    batched reply) instead of one frame per op.  Same self-clocking
    shape as EncodeBatcher: a lone sub-write sends immediately as a
    plain MOSDECSubOpWrite — the wire format of the unbatched path."""

    def __init__(self, osd):
        self._osd = osd
        self._pending: Dict[int, List] = {}      # target osd -> [(sub, fut)]
        self._workers: Dict[int, asyncio.Task] = {}

    async def send(self, target: int, sub) -> None:
        """Queue one sub-write for ``target``; returns when the frame
        carrying it was handed to the session (raises like _send_osd on
        a failed send, so _ec_write's every-shard-durable rule holds)."""
        fut = asyncio.get_event_loop().create_future()
        self._pending.setdefault(target, []).append((sub, fut))
        if target not in self._workers:
            task = asyncio.get_event_loop().create_task(
                self._drain(target))
            self._workers[target] = task
            self._osd._track(task)
        # resolved by the local worker's finally even on cancellation
        # (exception), never a cross-daemon wait
        await fut  # graftlint: ignore[rpc-timeout]

    async def _drain(self, target: int) -> None:
        from ceph_tpu_torch.cluster import messages as M

        osd = self._osd
        batch: List = []
        try:
            while not osd._stopped:
                pending = self._pending.get(target)
                if not pending:
                    break
                cap = max(1, osd.config.osd_batch_tick_ops)
                batch = pending[:cap]
                self._pending[target] = pending[cap:]
                try:
                    if len(batch) == 1:
                        await osd._send_osd(target, batch[0][0])
                    else:
                        await osd._send_osd(
                            target, M.MOSDECSubOpWriteBatch(
                                items=[s for s, _f in batch],
                                epoch=osd.osdmap.epoch))
                        osd.perf.inc("osd_subwrite_batches")
                        osd.perf.inc("osd_subwrite_batched_items",
                                     len(batch))
                    # crash seam: THIS peer's tick frame left, other
                    # peers' frames (and these acks) never happen — the
                    # partial fan-out peering must rule on
                    osd._chaos_point("commit_mid_fanout")
                    for _s, f in batch:
                        if not f.done():
                            f.set_result(None)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    for _s, f in batch:
                        if not f.done():
                            f.set_exception(e)
                batch = []
        finally:
            self._workers.pop(target, None)
            leftovers = batch + (self._pending.pop(target, None) or [])
            for _s, f in leftovers:
                if not f.done():
                    f.set_exception(
                        ConnectionError("sub-write batcher stopped"))


class OpBatcher:
    """Round 18: the CLIENT-edge twin of SubWriteBatcher, living in the
    objecter.  Ops targeting one OSD park here and ship as ONE
    MOSDOpBatch frame per tick (one pickle, one session frame, one
    transport ack) instead of one MOSDOp frame per op — the per-op
    frame churn PR 6's attribution measured dominating the t16 wall.
    Same self-clocking group-commit shape: a lone op sends immediately
    as a plain MOSDOp (the wire format of the unbatched path, so the
    ``objecter_batch_tick_ops=0`` anchor and a 1-op tick are
    bit-identical on the wire), and the send-in-flight window is
    exactly what accumulates the next tick's batch.

    Per-op semantics survive batching end to end: each item keeps its
    own reqid/future in ``objecter._inflight`` (a shed item un-acks
    only itself — the SubWriteBatcher per-item rule), and each item's
    trace header gets the amortized ``objecter:batch_tick`` /
    ``objecter:batch_sent`` stamps the ``client_batch_wait`` /
    ``client_batch_send`` attribution stages are computed from."""

    def __init__(self, objecter):
        self._obj = objecter
        self._pending: Dict[Tuple, List] = {}   # osd addr -> [(msg, fut)]
        self._workers: Dict[Tuple, asyncio.Task] = {}

    async def send(self, addr: Tuple, msg) -> None:
        """Park one MOSDOp for ``addr``; returns when the frame carrying
        it was handed to the session (raises like send_message on a
        failed send, so the submit loop's retarget/retry rule holds)."""
        fut = asyncio.get_event_loop().create_future()
        self._pending.setdefault(addr, []).append((msg, fut))
        if addr not in self._workers:
            task = asyncio.get_event_loop().create_task(self._drain(addr))
            self._workers[addr] = task
            self._obj._track(task)
        # resolved by the local worker's finally even on cancellation
        # (exception), never a cross-daemon wait
        await fut  # graftlint: ignore[rpc-timeout]

    async def _drain(self, addr: Tuple) -> None:
        import time as _time

        from ceph_tpu_torch.cluster import messages as M

        obj = self._obj
        batch: List = []
        try:
            while not obj._stopped:
                pending = self._pending.get(addr)
                if not pending:
                    break
                t0 = _time.time()
                window = obj.config.objecter_batch_tick_window
                if window and len(pending) == 1:
                    # optional accumulation stretch after an idle start
                    await asyncio.sleep(window)
                    pending = self._pending.get(addr) or []
                cap = max(1, obj.config.objecter_batch_tick_ops)
                batch = pending[:cap]
                self._pending[addr] = pending[cap:]
                try:
                    if len(batch) == 1:
                        # lone op: the plain legacy frame, byte-exact
                        # with the objecter_batch_tick_ops=0 anchor
                        await obj.messenger.send_message(batch[0][0],
                                                         addr)
                    else:
                        # amortized tick attribution (the batch_wait/
                        # batch_encode convention): each op books its
                        # share of the tick window as client_batch_send
                        # and the rest of its park time as
                        # client_batch_wait.  Stamped BEFORE the send —
                        # the header pickles with the frame.
                        t1 = _time.time()
                        share = (t1 - t0) / len(batch)
                        for m, _f in batch:
                            tr = getattr(m, "trace", None)
                            if tr is not None:
                                tr["events"].append(
                                    ("objecter:batch_tick", t1 - share))
                                tr["events"].append(
                                    ("objecter:batch_sent", t1))
                        obj._batch_ticks += 1
                        obj._batch_tick_ops += len(batch)
                        if obj.flight:
                            obj.flight.record("client_batch_tick",
                                              osd=f"{addr[0]}:{addr[1]}",
                                              items=len(batch))
                        await obj.messenger.send_message(
                            M.MOSDOpBatch(
                                items=[m for m, _f in batch],
                                epoch=max(m.epoch for m, _f in batch)),
                            addr)
                    for _m, f in batch:
                        if not f.done():
                            f.set_result(None)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    for _m, f in batch:
                        if not f.done():
                            f.set_exception(e)
                batch = []
        finally:
            self._workers.pop(addr, None)
            leftovers = batch + (self._pending.pop(addr, None) or [])
            for _m, f in leftovers:
                if not f.done():
                    f.set_exception(
                        ConnectionError("op batcher stopped"))


class ClientReplyBatcher:
    """Round 18: the OSD's reply-edge coalescer — terminal MOSDOpReply
    frames destined for one client connection park here and ship as ONE
    MOSDOpReplyBatch per reply tick.  Same self-clocking shape: a lone
    reply sends immediately as a plain MOSDOpReply (the legacy wire
    format), so replies are never delayed waiting for tick-mates — the
    zero-acked-past-deadline gate depends on that.  Shed ops never
    enter (no reply exists), so absence-means-unacked holds per item."""

    def __init__(self, osd):
        self._osd = osd
        self._pending: Dict[int, List] = {}     # id(conn) -> [(conn, reply)]
        self._workers: Dict[int, asyncio.Task] = {}

    def send(self, conn, reply) -> None:
        """Park one terminal reply for ``conn`` (fire-and-forget, like
        conn.send: a dead client conn drops replies and the client's
        resend machinery covers it)."""
        key = id(conn)
        self._pending.setdefault(key, []).append((conn, reply))
        if key not in self._workers:
            task = asyncio.get_event_loop().create_task(self._drain(key))
            self._workers[key] = task
            self._osd._track(task)

    async def _drain(self, key: int) -> None:
        from ceph_tpu_torch.cluster import messages as M

        osd = self._osd
        try:
            while not osd._stopped:
                pending = self._pending.get(key)
                if not pending:
                    break
                cap = max(1, osd.config.objecter_batch_tick_ops)
                batch = pending[:cap]
                self._pending[key] = pending[cap:]
                conn = batch[0][0]
                try:
                    if len(batch) == 1:
                        await conn.send(batch[0][1])
                    else:
                        await conn.send(M.MOSDOpReplyBatch(
                            items=[r for _c, r in batch]))
                        osd.perf.inc("osd_client_batch_reply_frames")
                        osd.perf.inc("osd_client_batch_reply_items",
                                     len(batch))
                except asyncio.CancelledError:
                    raise
                except (ConnectionError, OSError, RuntimeError):
                    # client conn died mid-tick: the un-acked items are
                    # covered by the client's resend machinery — count
                    # the drop and keep draining later ticks
                    osd.perf.inc("osd_client_batch_reply_drops",
                                 len(batch))
        finally:
            self._workers.pop(key, None)
            self._pending.pop(key, None)


class ReadBatcher:
    """Per-tick coalescer for the READ half of the data plane (round
    16): a tick's read gathers share one layout conversion + one fused
    decode (``ec/stripe.decode_stripes_multi``), recovery rebuilds
    share one decode+reencode round trip (``reencode_stripes_multi``),
    and shard crc verification rides one crc32c batch per tick.  Same
    self-clocking group-commit shape as EncodeBatcher: a lone request
    never waits, and the compute-in-flight window is exactly what
    accumulates the next tick's batch.  Together with EncodeBatcher
    this module is the ONE sanctioned device-dispatch seam under
    cluster/ — with this class, on the read/recovery/verify paths too
    (the three round-11 ``per-op-device-dispatch`` baseline remnants
    retire here)."""

    def __init__(self, osd):
        self._osd = osd
        self._pending: Dict[Tuple, List] = {}
        self._workers: Dict[Tuple, asyncio.Task] = {}
        # the verify ticks' device: the OSD's, CUDA unless it names
        # another (raises where CUDA is asked for and absent)
        self.device = resolve_device(getattr(osd, "device", None))

    async def decode(self, codec, sinfo, shards, logical_size,
                     planar: bool = False) -> bytes:
        """Coalesced decode of one gather's shard ranges -> logical
        bytes (the ``decode_stripes`` contract, tick-batched).
        ``planar`` (round 19): the shards are AT-REST plane matrices
        and the decode runs in the plane domain end to end
        (``decode_planes_multi``) — the assemble's planes->bytes hop is
        the read's ONE sanctioned egress conversion."""
        from ceph_tpu_torch.cluster.optracker import CURRENT_OP, mark_current

        if all(s in shards for s in range(sinfo.k)):
            # every data shard present: the "decode" is a pure host
            # interleave — no device work exists to coalesce, and the
            # tick/executor round trip would only add latency to the
            # hottest read shape (same bytes as decode_stripes' own
            # non-missing fast path, so bit-exactness is unaffected)
            from ceph_tpu_torch.ec import stripe as stripemod

            if planar:
                return stripemod.decode_planes_multi(
                    codec, sinfo, [(shards, logical_size)])[0]
            return stripemod.assemble_data_stripes(sinfo, shards,
                                                   logical_size)
        mark_current("read_batch_parked")
        data, (t0, t1, batch_n) = await self._submit(
            ("decode", id(codec), sinfo.k, sinfo.chunk_size, planar),
            codec, sinfo, (shards, logical_size))
        op = CURRENT_OP.get()
        if op is not None:
            # amortized attribution, mirroring the write tick: this
            # op's share of the fused decode wall; the rest of the
            # window books as parked time
            share = (t1 - t0) / max(batch_n, 1)
            op.mark_at("read_batch_tick", t1 - share)
            op.mark_at("read_batch_decoded", t1)
        return data

    async def reencode(self, codec, sinfo, shards, logical_size,
                       planar: bool = False):
        """Coalesced recovery rebuild -> the op's (k+m, shard_len)
        matrix (the ``reencode_stripes`` contract, tick-batched).
        ``planar``: at-rest plane matrices in, (n, 8, cols) plane
        matrices out — ZERO layout conversions
        (``reencode_planes_multi``)."""
        rows, _tick = await self._submit(
            ("reencode", id(codec), sinfo.k, sinfo.chunk_size, planar),
            codec, sinfo, (shards, logical_size))
        return rows

    async def verify(self, rows, crcs, planar: bool = False) -> List[bool]:
        """Batched shard-crc verification: ``rows[i]`` checks against
        the stored ``ceph_crc32c(~0, row)`` value ``crcs[i]``; a tick's
        verifies share one crc32c batch per row-length group.  Returns
        the per-row pass/fail list.

        ``planar``: each row is an AT-REST plane blob; the crc runs on
        plane-major rows (``crc32c_planar_rows``) and stays bit-exact
        with the byte-anchor hinfo crc — no layout conversion.

        Every verify rides the tick: the stacked rows go to this
        batcher's device (the GF(2) matmul batch on the card, the host
        table path on the CPU).  The reference's inline per-row branch
        for hosts with a hardware crc32c has no counterpart here."""
        oks, _tick = await self._submit(
            ("verify_planar",) if planar else ("verify",), None, None,
            (rows, crcs))
        return oks

    async def _submit(self, key, codec, sinfo, payload):
        fut = asyncio.get_event_loop().create_future()
        self._pending.setdefault(key, []).append(_Req(payload, False, fut))
        if key not in self._workers:
            task = asyncio.get_event_loop().create_task(
                self._drain(key, codec, sinfo))
            self._workers[key] = task
            self._osd._track(task)
        # resolved by the local worker's finally even on cancellation —
        # never a cross-daemon wait (the EncodeBatcher contract)
        return await fut  # graftlint: ignore[rpc-timeout]

    @staticmethod
    def _verify_multi(reqs, device):
        """One tick's crc verifications: every row of every request,
        batched per row-length group through ``crc32c_rows`` on
        ``device`` (the GF(2) matmul batch on the card, the host table
        path on the CPU)."""
        import numpy as np
        import torch

        from ceph_tpu_torch.ops.crc32c import crc32c_rows

        flat: List = []           # (req index, row index, bytes, crc)
        for ri, (rows, crcs) in enumerate(reqs):
            for j, (row, crc) in enumerate(zip(rows, crcs)):
                flat.append((ri, j, row, crc))
        by_len: Dict[int, List] = {}
        for item in flat:
            by_len.setdefault(len(item[2]), []).append(item)
        out = [[True] * len(rows) for rows, _c in reqs]
        for _length, group in by_len.items():
            stacked = np.stack([np.frombuffer(row, dtype=np.uint8)
                                for _ri, _j, row, _c in group])
            got = crc32c_rows(torch.from_numpy(stacked).to(device))
            for (ri, j, _row, crc), g in zip(group, got):
                out[ri][j] = (crc is None) or (int(g) == int(crc))
        return out

    @staticmethod
    def _verify_planar_multi(reqs, device):
        """One tick's PLANAR crc verifications: every at-rest plane
        blob of every request, batched per length group through
        ``crc32c_planar_rows`` (plane-major rows, bit-exact with the
        byte-anchor hinfo crcs) — zero layout conversions — on
        ``device``."""
        import numpy as np
        import torch

        from ceph_tpu_torch.ec import planar_store
        from ceph_tpu_torch.ops.crc32c import crc32c_planar_rows

        flat: List = []           # (req index, row index, planes, crc)
        for ri, (rows, crcs) in enumerate(reqs):
            for j, (row, crc) in enumerate(zip(rows, crcs)):
                flat.append((ri, j, planar_store.blob_to_planes(row),
                             crc))
        by_len: Dict[int, List] = {}
        for item in flat:
            by_len.setdefault(item[2].shape[1], []).append(item)
        out = [[True] * len(rows) for rows, _c in reqs]
        for _cols, group in by_len.items():
            stacked = np.vstack([planes for _ri, _j, planes, _c in group])
            got = crc32c_planar_rows(torch.from_numpy(stacked).to(device))
            for (ri, j, _p, crc), g in zip(group, got):
                out[ri][j] = (crc is None) or (int(g) == int(crc))
        return out

    async def _drain(self, key, codec, sinfo) -> None:
        from ceph_tpu_torch.ec import stripe as stripemod

        osd = self._osd
        mode = key[0]
        # one dispatcher per key: the planar flag rides the key (round
        # 19), so a planar tick and a byte tick of the same codec never
        # coalesce — their payload types differ
        if mode == "decode":
            fn = stripemod.decode_planes_multi if key[4] \
                else stripemod.decode_stripes_multi

            def compute(reqs):
                return osd._compute(fn, codec, sinfo, reqs)
        elif mode == "reencode":
            fn = stripemod.reencode_planes_multi if key[4] \
                else stripemod.reencode_stripes_multi

            def compute(reqs):
                return osd._compute(fn, codec, sinfo, reqs)
        elif mode == "verify_planar":
            def compute(reqs):
                return osd._compute(self._verify_planar_multi, reqs,
                                    self.device)
        else:
            def compute(reqs):
                return osd._compute(self._verify_multi, reqs, self.device)
        batch: List[_Req] = []
        try:
            while not osd._stopped:
                pending = self._pending.get(key)
                if not pending:
                    break
                cap = max(1, osd.config.osd_batch_tick_ops)
                batch = pending[:cap]
                self._pending[key] = pending[cap:]
                t0 = osd.clock.monotonic()
                try:
                    results = await compute([r.data for r in batch])
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # per-item fault isolation (the batched-frame rule):
                    # one op's bad inputs must not fail its tick-mates —
                    # re-run each request alone so only the poisoned one
                    # surfaces its error
                    if len(batch) == 1:
                        if not batch[0].fut.done():
                            batch[0].fut.set_exception(e)
                    else:
                        for r in batch:
                            if r.fut.done():
                                continue
                            try:
                                [res] = await compute([r.data])
                                r.fut.set_result(
                                    (res, (t0, osd.clock.monotonic(), 1)))
                            except asyncio.CancelledError:
                                raise
                            except Exception as e1:
                                r.fut.set_exception(e1)
                    batch = []
                    continue
                t1 = osd.clock.monotonic()
                osd.perf.inc("osd_read_batch_ticks")
                osd.perf.inc("osd_read_batch_coalesced", len(batch))
                tick = (t0, t1, len(batch))
                for r, res in zip(batch, results):
                    if not r.fut.done():
                        r.fut.set_result((res, tick))
                batch = []
        finally:
            self._workers.pop(key, None)
            leftovers = batch + (self._pending.pop(key, None) or [])
            for r in leftovers:
                if not r.fut.done():
                    r.fut.set_exception(
                        ConnectionError("read batcher stopped"))


class EncodeBatcher:
    """One per OSD daemon; keyed by codec identity so only same-profile
    writes coalesce (mixed-profile ticks run as independent batches —
    their math never mixes)."""

    def __init__(self, osd):
        self._osd = osd
        self._pending: Dict[Tuple, List[_Req]] = {}
        self._workers: Dict[Tuple, asyncio.Task] = {}

    async def encode(self, codec, sinfo, data, want_crc: bool,
                     planar: bool = False):
        """Coalesced encode of one op's stripe-aligned byte range.

        Returns ``(shards, crcs, (t0, t1, batch_n))``: the op's
        (k+m, nstripes*unit) shard matrix, the per-shard-row crcs (full
        rewrites only, else None), and the tick's encode window +
        batch size for amortized attribution.  ``planar`` (round 19):
        the tick runs ``encode_planes_multi`` — the op gets (n, 8,
        cols) AT-REST plane matrices and plane-major crcs; the client
        bytes -> planes hop inside the tick is the write's ONE
        sanctioned ingest conversion."""
        key = (id(codec), sinfo.k, sinfo.chunk_size, planar)
        fut = asyncio.get_event_loop().create_future()
        self._pending.setdefault(key, []).append(
            _Req(data, want_crc, fut))
        if key not in self._workers:
            task = asyncio.get_event_loop().create_task(
                self._drain(key, codec, sinfo))
            self._workers[key] = task
            self._osd._track(task)
        # not a cross-daemon RPC wait: the resolver is the local worker
        # task just armed above, whose finally resolves EVERY parked
        # request (exception on cancellation) — a bound here would only
        # add a spurious failure mode under first-call kernel builds
        return await fut  # graftlint: ignore[rpc-timeout]

    async def encode_once(self, codec, sinfo, data,
                          planar: bool = False):
        """The ``osd_batch_tick_ops=0`` legacy per-op encode — the
        round-10 bisection anchor — hosted INSIDE the sanctioned
        dispatch seam: exactly the per-op ``encode_stripes`` executor
        hop, no coalescing, no batch crc (replicas re-checksum, the
        round-10 contract).  Living here rather than in backend_ec
        keeps the ``per-op-device-dispatch`` rule honest: every device
        dispatch of the cluster data plane, legacy branch included,
        routes through this module.  ``planar``: the per-op variant of
        the planar tick — a 1-request ``encode_planes_multi``."""
        from ceph_tpu_torch.ec import stripe as stripemod

        if planar:
            [(planes, _crcs)] = await self._osd._compute(
                stripemod.encode_planes_multi, codec, sinfo, [data],
                [False])
            return planes
        return await self._osd._compute(
            stripemod.encode_stripes, codec, sinfo, data)

    async def _drain(self, key, codec, sinfo) -> None:
        """Tick loop for one codec profile; exits when idle (the next
        request re-arms it).  The empty-check/exit runs with no await in
        between, so an enqueue can never race the worker's death."""
        from ceph_tpu_torch.ec import stripe as stripemod

        osd = self._osd
        # the planar flag rides the key: a planar tick returns plane
        # matrices + plane-major crcs, a byte tick returns shard rows —
        # same-profile writes still coalesce within each mode
        encode_fn = stripemod.encode_planes_multi if key[3] \
            else stripemod.encode_stripes_multi
        batch: List[_Req] = []
        try:
            while not osd._stopped:
                pending = self._pending.get(key)
                if not pending:
                    break
                window = osd.config.osd_batch_tick_window
                if window and len(pending) == 1:
                    # optional accumulation stretch after an idle start
                    await asyncio.sleep(window)
                    pending = self._pending.get(key) or []
                cap = max(1, osd.config.osd_batch_tick_ops)
                batch = pending[:cap]
                self._pending[key] = pending[cap:]
                # crash seam: the tick's batch is composed but the
                # encode never runs — every parked op dies un-encoded
                osd._chaos_point("tick_mid_encode")
                t0 = osd.clock.monotonic()
                try:
                    results = await osd._compute(
                        encode_fn, codec, sinfo,
                        [r.data for r in batch],
                        [r.want_crc for r in batch])
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    for r in batch:
                        if not r.fut.done():
                            r.fut.set_exception(e)
                    batch = []
                    continue
                t1 = osd.clock.monotonic()
                # crash seam: encoded but no op of the tick has entered
                # its commit section — nothing may survive as acked
                osd._chaos_point("tick_post_encode")
                osd.perf.inc("osd_batch_ticks")
                osd.perf.inc("osd_batch_coalesced_ops", len(batch))
                tick = (t0, t1, len(batch))
                for r, (shards, crcs) in zip(batch, results):
                    if not r.fut.done():
                        r.fut.set_result((shards, crcs, tick))
                batch = []
        finally:
            self._workers.pop(key, None)
            # cancellation mid-tick (daemon stop): parked requests must
            # fail loudly, never hang their ops to the full timeout
            leftovers = batch + (self._pending.pop(key, None) or [])
            for r in leftovers:
                if not r.fut.done():
                    r.fut.set_exception(
                        ConnectionError("encode batcher stopped"))
