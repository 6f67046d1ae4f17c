"""The port's batched data plane against ``ceph_tpu``'s: the cases of
``tests/test_batch_dataplane.py``.

Unit level, each case runs both packages' functions (the port's on the
CPU) on the same seeded inputs and compares what they return and the
state they leave: the coalesced stripe encode and its crcs, the batched
row crc, the attribution of a tick's stage marks, the commit frontier.
Cluster level, each package's coalesced (and client-batched) workload
must leave the shards its own per-op anchor leaves, and the port's must
equal the reference's, byte for byte and OSD for OSD.
"""

import asyncio

import numpy as np
import pytest

from tests._flaky import contention_retry
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, PORT, REF, _port_lockdep_reset, run, run_both)


def _coll(pgid):
    return f"pg_{pgid.pool}_{pgid.seed}"


RS21 = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "2", "m": "1"}


# ------------------------------------------------------------- unit level


def test_encode_stripes_multi_bit_exact_and_crcs():
    """One coalesced dispatch == N per-op dispatches, byte for byte;
    batch CRCs == the host ceph_crc32c each shard row would get."""
    def case(P):
        stripe = P.imp("ec.stripe")
        crcmod = P.imp("ops.crc32c")
        codec = P.imp("ec.factory")(RS21)
        sinfo = stripe.StripeInfo(2, 4096)
        rng = np.random.default_rng(11)
        datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                 for n in (8192, 40960, 1, 8192, 0, 12345)]
        multi = stripe.encode_stripes_multi(codec, sinfo, datas,
                                            want_crcs=[True] * len(datas))
        out = []
        for data, (shards, crcs) in zip(datas, multi):
            shards = np.asarray(shards)
            solo = np.asarray(stripe.encode_stripes(codec, sinfo, data))
            assert shards.shape == solo.shape
            assert np.array_equal(shards, solo)
            assert crcs is not None and len(crcs) == shards.shape[0]
            for row, crc in zip(shards, crcs):
                assert crc == crcmod.crc32c(0xFFFFFFFF, row.tobytes())
            out.append((shards.tobytes(), [int(c) for c in crcs]))
        return out

    assert case(PORT) == case(REF)


def test_encode_stripes_multi_single_op_degenerate():
    """The 1-op tick: no coalescing partner, still bit-exact."""
    def case(P):
        stripe = P.imp("ec.stripe")
        crcmod = P.imp("ops.crc32c")
        codec = P.imp("ec.factory")(RS21)
        sinfo = stripe.StripeInfo(2, 4096)
        data = bytes(range(256)) * 64
        [(shards, crcs)] = stripe.encode_stripes_multi(codec, sinfo, [data],
                                                       [True])
        shards = np.asarray(shards)
        assert np.array_equal(
            shards, np.asarray(stripe.encode_stripes(codec, sinfo, data)))
        assert list(crcs) == [crcmod.crc32c(0xFFFFFFFF, r.tobytes())
                              for r in shards]
        return shards.tobytes(), [int(c) for c in crcs]

    assert case(PORT) == case(REF)


def test_crc32c_rows_matches_host():
    def case(P):
        crcmod = P.imp("ops.crc32c")
        rng = np.random.default_rng(7)
        # block-aligned rows: the batch + vectorized fold path
        rows = rng.integers(0, 256, (5, 3 * 4096), dtype=np.uint8)
        got = crcmod.crc32c_rows(rows)
        assert got == [crcmod.crc32c(0xFFFFFFFF, r.tobytes()) for r in rows]
        # non-multiple length: the per-row host path
        odd = rng.integers(0, 256, (3, 1000), dtype=np.uint8)
        got_odd = crcmod.crc32c_rows(odd)
        assert got_odd == \
            [crcmod.crc32c(0xFFFFFFFF, r.tobytes()) for r in odd]
        # empty rows
        empty = crcmod.crc32c_rows(np.zeros((2, 0), dtype=np.uint8))
        assert empty == [0xFFFFFFFF, 0xFFFFFFFF]
        return [int(c) for c in got + got_odd + empty]

    assert case(PORT) == case(REF)


def test_batch_attribution_amortized_stage_math():
    """The coalescer's amortized marks: batch_wait + batch_encode
    partition the parked->encoded window, batch_encode gets exactly
    the tick's wall / batch size, and the stage sums stay equal to the
    traced total (the attribution invariant)."""
    def case(P):
        attribute_events = P.imp("trace.attribution.attribute_events")
        # an op parked at t=1.0; tick ran 2.0 -> 5.0 with 3 ops coalesced
        share = (5.0 - 2.0) / 3
        evs = [(0.0, "initiated"), (0.5, "dispatched"),
               (1.0, "batch_parked"),
               (5.0 - share, "batch_tick"), (5.0, "batch_encoded"),
               (5.2, "done")]
        stages, total = attribute_events(evs)
        assert abs(sum(stages.values()) - total) < 1e-9
        assert abs(stages["batch_encode"] - share) < 1e-9
        assert abs(stages["batch_wait"] - (4.0 - share)) < 1e-9
        assert stages["op_prepare"] == pytest.approx(0.5)
        return dict(stages), total

    assert case(PORT) == case(REF)


class _Store:
    def omap_get(self, coll, oid):
        return {}

    def queue_transaction(self, txn):
        pass


def _host(P):
    class _Host(P.imp("cluster.pg.PGLogMixin")):
        def __init__(self):
            self.store = _Store()
            self.perf = P.imp("utils.PerfCounters")("t")

    return _Host()


def _frontier(st):
    return (st.last_update, st.last_complete, list(st.pipeline_pending),
            sorted(st.frontier_recovering))


def test_commit_frontier_blocks_out_of_order_acks():
    """The pipelined-write watermark invariant: a later write's acks
    arriving first must NOT advance last_complete past an earlier
    still-pending write; a FAILED earlier write unblocks the later one
    (the pre-pipeline skip semantics)."""
    def case(P):
        PGState = P.imp("cluster.pg.PGState")
        PGid = P.imp("osdmap.osdmap.PGid")
        h = _host(P)
        st = PGState(PGid(1, 0))
        zero = st.last_complete
        v5, v6, v7 = (1, 5), (1, 6), (1, 7)
        states = []
        for v in (v5, v6, v7):
            h._frontier_open(st, v)
        # commit starts log before their acks: the head covers the opens
        # (the watermark can never pass the log head)
        st.last_update = v7
        # v6 acks first: watermark must NOT move (v5 still pending)
        h._frontier_done(st, v6, ok=True)
        assert st.last_complete == zero
        states.append(_frontier(st))
        # direct advances (recovery-style) are clamped below pending too
        h._advance_last_complete(st, v7)
        assert st.last_complete == zero
        # v5 fails: removed without blessing, v6's ack now advances to 6
        h._frontier_done(st, v5, ok=False)
        assert st.last_complete == v6
        states.append(_frontier(st))
        # v7 acks: contiguous prefix advances to 7
        h._frontier_done(st, v7, ok=True)
        assert st.last_complete == v7
        states.append(_frontier(st))
        return states

    assert case(PORT) == case(REF)


def test_frontier_rebuild_and_learn():
    """Crash-restart reconstruction: logged entries above the
    persisted watermark re-register as OPEN frontier entries, a
    post-restart fully-acked write can NOT advance the watermark past
    them, and an authoritative learn (peering roll-forward / primary
    entry stream) resolves them — while a rewind drops them."""
    def case(P):
        PGState = P.imp("cluster.pg.PGState")
        LogEntry = P.imp("cluster.pglog.LogEntry")
        PGLog = P.imp("cluster.pglog.PGLog")
        PGid = P.imp("osdmap.osdmap.PGid")
        h = _host(P)
        states = []
        st = PGState(PGid(1, 0))
        st.last_complete = (1, 5)
        st.log = PGLog(entries=[
            LogEntry(op="modify", oid=f"o{s}", version=(1, s))
            for s in (4, 5, 6, 7, 8)])
        st.last_update = (1, 8)
        h._frontier_rebuild(st)
        # only the entries ABOVE the persisted watermark are open
        assert list(st.pipeline_pending) == [(1, 6), (1, 7), (1, 8)]
        assert st.frontier_recovering == {(1, 6), (1, 7), (1, 8)}
        states.append(_frontier(st))
        # a new write fully acks out of order: watermark must NOT move
        h._frontier_open(st, (1, 9))
        st.last_update = (1, 9)
        h._frontier_done(st, (1, 9), ok=True)
        assert st.last_complete == (1, 5)
        # ... but reads may serve the resolved entry (read-your-ack)
        assert st.frontier_acked(9) and not st.frontier_acked(7)
        # peering verified every member holds up to 7: 6,7 resolve; 8 stays
        h._frontier_learn(st, (1, 7))
        assert st.last_complete == (1, 7)
        assert list(st.pipeline_pending) == [(1, 8), (1, 9)]
        assert st.frontier_recovering == {(1, 8)}
        states.append(_frontier(st))
        # ... and verifying up to 8 sweeps straight through the resolved 9
        h._frontier_learn(st, (1, 8))
        assert st.last_complete == (1, 9)
        assert not st.pipeline_pending and not st.frontier_recovering
        states.append(_frontier(st))

        # the rewind path, on a fresh reconstruction: divergent open
        # entries leave the frontier with the log (they can never ack)
        st2 = PGState(PGid(1, 1))
        st2.last_complete = (1, 2)
        st2.log = PGLog(entries=[
            LogEntry(op="modify", oid=f"r{s}", version=(1, s))
            for s in (3, 4)])
        st2.last_update = (1, 4)
        h._frontier_rebuild(st2)
        assert set(st2.pipeline_pending) == {(1, 3), (1, 4)}
        h.rewind_divergent_log(st2, (1, 3))
        assert list(st2.pipeline_pending) == [(1, 3)]
        assert st2.frontier_recovering == {(1, 3)}
        states.append(_frontier(st2))
        states.append([(e.op, e.oid, e.version) for e in st2.log.entries])
        return states

    assert case(PORT) == case(REF)


def test_fast_config_enables_batched_data_plane():
    """The vstart config (tests, bench, chaos scenarios incl. the
    tier-1 overload-smoke run) exercises sharded dispatch + coalescing;
    plain Config() keeps the zero-default per-op path for bisection."""
    shown = []
    for P in (REF, PORT):
        cfg = P.imp("cluster.vstart._fast_config")()
        assert cfg.osd_op_shards > 0 and cfg.osd_batch_tick_ops > 0
        # the client edge coalesces too — same anchor rule
        assert cfg.objecter_batch_tick_ops > 0
        plain = P.imp("utils.Config")()
        assert plain.osd_op_shards == 0 and plain.osd_batch_tick_ops == 0
        assert plain.objecter_batch_tick_ops == 0
        shown.append(cfg.show())
    assert shown[0] == shown[1]


# ---------------------------------------------------------- cluster level


async def _write_workload(cluster, concurrent: bool):
    """The shared workload: full writes across two EC profiles (a
    mixed-profile tick when concurrent) + an RMW partial write + a
    1-op-tick straggler + a replicated pool (full, partial, append,
    truncate, delete — the pipelined verbs).  Returns
    {pool_name: (pool_id, [oids])}."""
    client = await cluster.client()
    pool_a = await client.pool_create(
        "bxa", "erasure", pg_num=4,
        ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "2", "m": "1"})
    pool_b = await client.pool_create(
        "bxb", "erasure", pg_num=4,
        ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "3", "m": "2"})
    pool_r = await client.pool_create("bxr", "replicated", pg_num=4,
                                      size=3)
    io_a = client.ioctx(pool_a)
    io_b = client.ioctx(pool_b)
    io_r = client.ioctx(pool_r)
    rng = np.random.default_rng(42)
    jobs = []
    oids_a, oids_b = [], []
    for i in range(6):
        oid = f"obj_a{i}"
        oids_a.append(oid)
        payload = rng.integers(0, 256, 65536 + i * 4096,
                               dtype=np.uint8).tobytes()
        jobs.append((io_a, oid, payload))
    for i in range(4):
        oid = f"obj_b{i}"
        oids_b.append(oid)
        payload = rng.integers(0, 256, 49152, dtype=np.uint8).tobytes()
        jobs.append((io_b, oid, payload))
    if concurrent:
        await asyncio.gather(*(io.write_full(oid, payload, timeout=120)
                               for io, oid, payload in jobs))
    else:
        for io, oid, payload in jobs:
            await io.write_full(oid, payload, timeout=120)
    # RMW partial overwrite crossing a stripe boundary (no batch crc)
    patch = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    await io_a.write("obj_a0", patch, offset=5000, timeout=120)
    # EC append + truncate: pipelined compound verbs
    await io_a.append("obj_a1", b"\x5a" * 4096)
    await io_a.truncate("obj_a2", 30000)
    # 1-op tick: a lone write with nothing to coalesce against
    await io_a.write_full("obj_a_solo", b"\xa5" * 20480, timeout=120)
    oids_a.append("obj_a_solo")
    # replicated verbs through the same frontier path
    oids_r = []
    for i in range(3):
        oid = f"obj_r{i}"
        oids_r.append(oid)
        await io_r.write_full(
            oid, rng.integers(0, 256, 16384, dtype=np.uint8).tobytes(),
            timeout=120)
    await io_r.write("obj_r0", b"\x0f" * 777, offset=100, timeout=120)
    await io_r.append("obj_r1", b"\xf0" * 512)
    await io_r.truncate("obj_r2", 5000)
    await io_r.write_full("obj_r_gone", b"bye" * 100, timeout=120)
    await io_r.remove("obj_r_gone")
    oids_r.append("obj_r_gone")  # snapshot proves absence on BOTH paths
    return client, {"bxa": (pool_a, oids_a), "bxb": (pool_b, oids_b),
                    "bxr": (pool_r, oids_r)}


def _shard_snapshot(cluster, client, pools):
    """Every member's stored shard state per object: (bytes, shard,
    size, hinfo_crc) — the on-disk truth the two paths must agree on."""
    out = {}
    for pname, (pool, oids) in pools.items():
        for oid in oids:
            pgid = client.objecter.object_pgid(pool, oid)
            coll = _coll(pgid)
            for osd_id, osd in cluster.osds.items():
                if osd.store.stat(coll, oid) is None:
                    continue
                out[(pname, oid, osd_id)] = (
                    bytes(osd.store.read(coll, oid)),
                    osd.store.getattr(coll, oid, "shard"),
                    osd.store.getattr(coll, oid, "size"),
                    osd.store.getattr(coll, oid, "hinfo_crc"),
                )
    return out


def _paths(run_path, a, b):
    """Each package's two paths (``run_path(P, a)``, ``run_path(P, b)``),
    each under its own bound: every path's snapshot equals the other
    path's, and the port's the reference's."""
    snaps = {}
    for P in (REF, PORT):
        for flag in (a, b):
            snaps[P.name, flag] = run(run_path(P, flag))
        first, second = snaps[P.name, a], snaps[P.name, b]
        assert set(first) == set(second)
        for key in sorted(second):
            assert first[key] == second[key], (P.name, key)
    assert snaps["port", a] == snaps["ref", a]


@contention_retry()
def test_coalesced_writes_bit_exact_vs_per_op_path():
    """Concurrent writes through sharded dispatch + coalescing leave
    every OSD's stored shards and CRCs byte-identical to the same writes
    issued serially through the per-op path (mixed-profile ticks + RMW
    + 1-op tick included), in both packages, and the port's equal the
    reference's."""
    async def run_path(P, coalesced: bool):
        cfg = P.imp("cluster.vstart._fast_config")()
        if not coalesced:
            # the serial anchor: per-op dispatch/encode
            # AND full-PG-lock commits (no pipelined frontier)
            cfg.osd_op_shards = 0
            cfg.osd_batch_tick_ops = 0
            cfg.osd_pipeline_writes = 0
        cluster = await P.imp("cluster.vstart.start_cluster")(5, config=cfg)
        try:
            client, pools = await _write_workload(
                cluster, concurrent=coalesced)
            snap = _shard_snapshot(cluster, client, pools)
            if coalesced:
                # every full write really rode the coalescer
                ticks = sum(o.perf.get("osd_batch_ticks")
                            for o in cluster.osds.values())
                coalesced_ops = sum(
                    o.perf.get("osd_batch_coalesced_ops")
                    for o in cluster.osds.values())
                assert ticks > 0 and coalesced_ops >= 12
            return snap
        finally:
            await cluster.stop()

    _paths(run_path, True, False)


@contention_retry()
def test_client_batched_frames_bit_exact_vs_per_op_frames():
    """The SAME concurrent workload through MOSDOpBatch client frames vs
    per-op MOSDOp frames (OSD-interior coalescing identical on both
    sides) leaves every OSD's stored shards and CRCs byte-identical —
    mixed verbs (write/RMW/append/truncate/delete), replicated + EC
    pools, and the 1-op-tick straggler included — in both packages, and
    the port's equal the reference's."""
    async def run_path(P, client_batched: bool):
        cfg = P.imp("cluster.vstart._fast_config")()
        if not client_batched:
            # the anchor: per-op client frames, everything else equal
            cfg.objecter_batch_tick_ops = 0
        cluster = await P.imp("cluster.vstart.start_cluster")(5, config=cfg)
        try:
            client, pools = await _write_workload(
                cluster, concurrent=True)
            snap = _shard_snapshot(cluster, client, pools)
            frames = sum(o.perf.get("osd_client_batch_frames")
                         for o in cluster.osds.values())
            items = sum(o.perf.get("osd_client_batch_items")
                        for o in cluster.osds.values())
            if client_batched:
                # the workload really rode batched client frames
                assert frames > 0 and items >= frames
                assert client.objecter.flow_counters()[
                    "client_batch_ticks"] > 0
            else:
                assert frames == 0 and items == 0
            return snap
        finally:
            await cluster.stop()

    _paths(run_path, True, False)


@contention_retry()
def test_coalesced_concurrent_appends_apply_exactly_once():
    """Same-object concurrency under sharded dispatch: every append
    lands exactly once and the object stays readable (per-object
    ordering lives inside one shard by PG affinity)."""
    async def scenario(P):
        cluster = await P.imp("cluster.vstart.start_cluster")(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "bxo", "erasure", pg_num=4, ec_profile=dict(RS21))
            io = client.ioctx(pool)
            await io.write_full("log", b"", timeout=120)
            pieces = [bytes([65 + i]) * 512 for i in range(8)]
            await asyncio.gather(
                *(io.append("log", p) for p in pieces))
            data = await io.read("log", timeout=120)
            assert len(data) == sum(len(p) for p in pieces)
            for p in pieces:
                assert data.count(p[:1]) == len(p)
            return sorted(data)
        finally:
            await cluster.stop()

    # the appends' order is the scheduler's: only the multiset of bytes
    # is compared
    run_both(scenario, reads=False, stores=False)
