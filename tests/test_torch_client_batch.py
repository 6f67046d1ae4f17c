"""The port's client-edge batching against ``ceph_tpu``'s, on the cases of
``tests/test_client_batch.py``, and the client cases of
``tests/test_messenger.py`` and ``tests/test_verified_reads.py`` that
need a whole cluster.

The objecter's ``OpBatcher`` coalesces a tick's ops to one OSD into one
``MOSDOpBatch`` frame, and the reply-batch scatter resolves each item's
future on its own.  Unit cases run an objecter of each package with no
cluster (the port's on ``device="cpu"``) and require equal frames and
counters.  Cluster cases run one cluster of each package
(``tests/test_torch_cluster.run_both``) with each reference test's own
assertions.  Throttle pushback, mclock pacing and connection drops
depend on timing: those cases compare what does not.
"""

import asyncio

import numpy as np

from tests._flaky import contention_retry
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    PORT, REF, _one_torch_thread, _port_lockdep_reset, run_both)


def both(scenario):
    """``scenario(P)`` in a fresh loop for each package: equal returns."""
    got = [asyncio.run(asyncio.wait_for(scenario(P), 60))
           for P in (PORT, REF)]
    assert got[0] == got[1]
    return got[0]


def _mk_objecter(P, **cfg):
    """An objecter with a live event loop but no cluster: the unit seams
    (OpBatcher, reply scatter) never touch the wire."""
    Objecter = P.imp("cluster.objecter.Objecter")
    Config = P.imp("utils.Config")
    return Objecter("cbt", ("127.0.0.1", 1), config=Config(**cfg))


def _frame(M, m):
    """A sent frame as comparable data."""
    if isinstance(m, M.MOSDOpBatch):
        return ("batch", m.epoch, [_frame(M, it) for it in m.items])
    return (type(m).__name__, m.reqid, m.oid,
            [n for n, _ in (m.trace or {}).get("events", [])]
            if getattr(m, "trace", None) else None)


# -- the cases of tests/test_client_batch.py ----------------------------------

def test_reply_batch_scatters_per_item_preserving_throttled_and_absence():
    async def scenario(P):
        M = P.imp("cluster.messages")
        obj = _mk_objecter(P)
        loop = asyncio.get_event_loop()
        futs = {i: loop.create_future() for i in range(4)}
        for i, fut in futs.items():
            obj._inflight[("c", i)] = fut
        await obj.ms_dispatch(None, M.MOSDOpReplyBatch(items=[
            M.MOSDOpReply(reqid=("c", 0), result=0, data=b"a"),
            M.MOSDOpReply(reqid=("c", 1), result=M.THROTTLED,
                          throttled=True),
            M.MOSDOpReply(reqid=("c", 2), result=-2),
        ]))
        assert futs[0].result().result == 0
        assert futs[0].result().data == b"a"
        assert futs[1].result().throttled is True
        assert futs[1].result().result == M.THROTTLED
        assert futs[2].result().result == -2
        assert not futs[3].done(), "absent item must stay un-acked"
        assert ("c", 3) in obj._inflight
        fc = obj.flow_counters()
        assert fc["client_batch_reply_frames"] == 1
        assert fc["client_batch_reply_items"] == 3
        return fc

    both(scenario)


def test_op_batcher_coalesces_per_osd_and_lone_op_ships_plain_frame():
    async def scenario(P):
        M = P.imp("cluster.messages")
        obj = _mk_objecter(P, objecter_batch_tick_ops=8)
        sent = []

        async def fake_send(msg, addr):
            sent.append((addr, msg))

        obj.messenger.send_message = fake_send
        addr_a, addr_b = ("10.0.0.1", 1), ("10.0.0.2", 2)

        def op(tid):
            m = M.MOSDOp(reqid=("c", tid), pgid=None, oid=f"o{tid}",
                         ops=[("write_full", {"data": b"x"})], epoch=7)
            m.trace = {"id": f"t{tid}", "events": []}
            return m

        await asyncio.gather(*[obj._send_op(op(i), addr_a)
                               for i in range(5)],
                             obj._send_op(op(99), addr_b))
        a_frames = [m for a, m in sent if a == addr_a]
        b_frames = [m for a, m in sent if a == addr_b]
        assert len(b_frames) == 1 and isinstance(b_frames[0], M.MOSDOp)
        assert all(name not in ("objecter:batch_tick",
                                "objecter:batch_sent")
                   for name, _ in b_frames[0].trace["events"])
        items = []
        for m in a_frames:
            if isinstance(m, M.MOSDOpBatch):
                assert m.epoch == 7
                for it in m.items:
                    names = [n for n, _ in it.trace["events"]]
                    assert "objecter:batch_tick" in names
                    assert "objecter:batch_sent" in names
                items.extend(m.items)
            else:
                items.append(m)
        assert {it.reqid[1] for it in items} == set(range(5))
        fc = obj.flow_counters()
        assert fc["client_batch_ticks"] >= 1
        assert fc["client_batch_ops"] >= 2
        await obj.stop()
        return [(a, _frame(M, m)) for a, m in sent]

    both(scenario)


def test_op_batcher_zero_gate_keeps_legacy_per_op_frames():
    async def scenario(P):
        M = P.imp("cluster.messages")
        obj = _mk_objecter(P)  # zero-default gate
        sent = []

        async def fake_send(msg, addr):
            sent.append(msg)

        obj.messenger.send_message = fake_send
        await asyncio.gather(*[
            obj._send_op(M.MOSDOp(reqid=("c", i), pgid=None, oid="o",
                                  ops=[("read", {})], epoch=1),
                         ("10.0.0.1", 1))
            for i in range(4)])
        assert len(sent) == 4
        assert all(isinstance(m, M.MOSDOp) for m in sent)
        assert not obj._op_batcher._workers
        assert obj.flow_counters()["client_batch_ticks"] == 0
        return [_frame(M, m) for m in sent]

    both(scenario)


def test_op_batcher_send_failure_fails_only_that_tick():
    async def scenario(P):
        M = P.imp("cluster.messages")
        obj = _mk_objecter(P, objecter_batch_tick_ops=8)
        calls = []

        async def flaky_send(msg, addr):
            calls.append(msg)
            if len(calls) == 1:
                raise ConnectionError("wire down")

        obj.messenger.send_message = flaky_send

        def op(tid):
            return M.MOSDOp(reqid=("c", tid), pgid=None, oid="o",
                            ops=[("read", {})], epoch=1)

        results = await asyncio.gather(
            *[obj._send_op(op(i), ("10.0.0.1", 1)) for i in range(3)],
            return_exceptions=True)
        assert any(isinstance(r, ConnectionError) for r in results)
        await obj._send_op(op(9), ("10.0.0.1", 1))
        assert len(calls) >= 2
        await obj.stop()
        return [type(r).__name__ for r in results], len(calls)

    both(scenario)


def test_client_batch_attribution_stage_math():
    from ceph_tpu.trace.attribution import attribute_events as jattr
    from ceph_tpu_torch.trace.attribution import attribute_events

    share = (2.6 - 2.0) / 3
    evs = [(0.0, "objecter:submit"), (1.0, "objecter:send"),
           (2.6 - share, "objecter:batch_tick"),
           (2.6, "objecter:batch_sent"),
           (2.7, "msgr:osd.0:recv"), (2.9, "done")]
    stages, total = attribute_events(evs)
    assert abs(sum(stages.values()) - total) < 1e-9
    assert abs(stages["client_batch_send"] - share) < 1e-9
    assert abs(stages["client_batch_wait"] - (1.6 - share)) < 1e-9
    assert stages["wire"] > 0
    assert (stages, total) == jattr(evs)


def test_fast_config_enables_client_batching_and_plain_config_does_not():
    for P in (PORT, REF):
        vstart = P.imp("cluster.vstart")
        Config = P.imp("utils.Config")
        assert vstart._fast_config().objecter_batch_tick_ops > 0
        assert Config().objecter_batch_tick_ops == 0
    assert PORT.imp("cluster.vstart")._fast_config().show() == \
        REF.imp("cluster.vstart")._fast_config().show()


@contention_retry()
def test_mid_batch_throttled_item_does_not_collapse_tick_mates():
    """Tight OSD admission under client batching: THROTTLED pushback
    arrives per item inside the batched reply, so tick-mates ack
    normally.  The pushback counts depend on timing: compares the reads
    and the stored objects only."""
    async def scenario(P):
        vstart = P.imp("cluster.vstart")
        cfg = vstart._fast_config()
        cfg.osd_op_throttle_ops = 2
        cluster = await vstart.start_cluster(3, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("cbt", pg_num=8, size=3)
            io = client.ioctx(pool)
            await asyncio.gather(*[
                io.write_full(f"o{i}", bytes([i]) * 2048, timeout=60)
                for i in range(16)])
            datas = await asyncio.gather(*[io.read(f"o{i}")
                                           for i in range(16)])
            assert all(datas[i] == bytes([i]) * 2048 for i in range(16))
            fc = client.objecter.flow_counters()
            assert fc["client_batch_ticks"] > 0, "ops never coalesced"
            assert fc["client_cwnd_pushbacks"] > 0, \
                "throttle budget never pushed back"
            assert fc["client_ops_acked"] >= 32
            assert fc["client_cwnd"] >= 1
        finally:
            await cluster.stop()

    run_both(scenario)


@contention_retry()
def test_mid_batch_expired_item_unacks_only_itself():
    """Six coalesced writes to one hot object through a 2 op/s mclock
    limit: the queue tail expires mid-batch and is shed, and zero ops ack
    past their deadline.  Which writes make it depends on the pacing:
    compares nothing but each run's own assertions."""
    async def scenario(P):
        vstart = P.imp("cluster.vstart")
        config = vstart._fast_config()
        config.osd_op_queue = "mclock"
        cluster = await vstart.start_cluster(3, config=config)
        try:
            client = await cluster.client()
            pool = await client.pool_create("cbx", pg_num=4, size=3)
            io = client.ioctx(pool)
            await io.write_full("hot", b"warm")
            entity = client.objecter.client_name.split("#", 1)[0]
            for osd in cluster.osds.values():
                osd.set_qos(entity, reservation=0.0, weight=1.0,
                            limit=2.0)
            loop = asyncio.get_event_loop()
            deadline_s = 1.2
            late_acks = []

            async def put(i):
                t0 = loop.time()
                try:
                    await io.write_full("hot", bytes([i]) * 512,
                                        timeout=deadline_s)
                except (IOError, OSError, TimeoutError):
                    return 0
                if loop.time() - t0 > deadline_s + 0.25:
                    late_acks.append(i)
                return 1

            acked = sum(await asyncio.gather(*[put(i) for i in range(6)]))
            deadline = loop.time() + 10.0
            shed = 0
            while loop.time() < deadline:
                shed = sum(o.perf.get("osd_ops_shed_expired")
                           for o in cluster.osds.values())
                if shed > 0:
                    break
                await asyncio.sleep(0.05)
            fc = client.objecter.flow_counters()
            assert fc["client_batch_ticks"] > 0, "ops never coalesced"
            assert late_acks == [], f"ops acked past deadline: {late_acks}"
            assert shed > 0, "expired queued ops executed instead of shed"
            assert acked >= 1
        finally:
            await cluster.stop()

    run_both(scenario, reads=False, stores=False)


# -- the client cases of tests/test_messenger.py ------------------------------

@contention_retry()
def test_ec_write_survives_connection_drops():
    """EC writes while every OSD-to-OSD connection is hard-dropped: every
    object stays readable and every acting shard holder converges.  The
    replays' timing differs, the stored shards do not."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "ecdrop", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            io = client.ioctx(pool)
            payloads = {}
            for i in range(12):
                oid = f"obj{i}"
                payloads[oid] = f"drop-{i}-".encode() * 120
                if i % 3 == 1:
                    for osd in cluster.osds.values():
                        for conn in list(osd.messenger._out.values()):
                            conn.writer.close()
                await io.write_full(oid, payloads[oid], timeout=60)
            for oid, data in payloads.items():
                assert await io.read(oid, timeout=60) == data, oid

            def _all_shards_present() -> bool:
                for oid in payloads:
                    pgid = client.objecter.object_pgid(pool, oid)
                    _, _, acting, _ = \
                        client.objecter.osdmap.pg_to_up_acting_osds(pgid)
                    for o in acting:
                        if o >= 0 and o in cluster.osds and \
                                cluster.osds[o].store.stat(
                                    f"pg_{pgid.pool}_{pgid.seed}",
                                    oid) is None:
                            return False
                return True

            deadline = asyncio.get_event_loop().time() + 15.0
            while not _all_shards_present() and \
                    asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.05)
            assert _all_shards_present()
        finally:
            await cluster.stop()

    run_both(scenario)


def test_signed_cluster_end_to_end_and_rejects_unsigned():
    """cephx-lite: a secret-keyed cluster serves I/O normally; an
    unsigned client cannot talk to it."""
    async def scenario(P):
        vstart = P.imp("cluster.vstart")
        RadosClient = P.imp("cluster.objecter.RadosClient")
        Config = P.imp("utils.Config")
        cfg = vstart._fast_config()
        cfg.auth_shared_secret = "sekrit"
        cluster = await vstart.start_cluster(3, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("authp", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"signed-payload" * 50)
            assert await io.read("obj") == b"signed-payload" * 50
            rogue = RadosClient(cluster.mon_addr, name="rogue",
                                config=Config())
            refused = None
            try:
                await asyncio.wait_for(rogue.connect(), timeout=3)
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    TimeoutError) as e:
                refused = e
            assert refused is not None, "an unsigned client connected"
            await rogue.shutdown()
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the client cases of tests/test_verified_reads.py -------------------------

async def _read_workload(cluster, concurrent: bool):
    client = await cluster.client()
    pool_a = await client.pool_create(
        "vra", "erasure", pg_num=4,
        ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "2", "m": "1"})
    pool_b = await client.pool_create(
        "vrb", "erasure", pg_num=4,
        ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "3", "m": "2"})
    io_a, io_b = client.ioctx(pool_a), client.ioctx(pool_b)
    rng = np.random.default_rng(77)
    expect = {}
    for i in range(4):
        payload = rng.integers(0, 256, 32768 + i * 4096,
                               dtype=np.uint8).tobytes()
        await io_a.write_full(f"ra{i}", payload, timeout=120)
        expect[("a", f"ra{i}")] = payload
    for i in range(3):
        payload = rng.integers(0, 256, 24576, dtype=np.uint8).tobytes()
        await io_b.write_full(f"rb{i}", payload, timeout=120)
        expect[("b", f"rb{i}")] = payload
    patch = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    await io_a.write("ra0", patch, offset=5000, timeout=120)
    base = bytearray(expect[("a", "ra0")])
    base[5000:5000 + len(patch)] = patch
    expect[("a", "ra0")] = bytes(base)

    ios = {"a": io_a, "b": io_b}
    jobs = [(pool_name, oid) for pool_name, oid in expect]
    if concurrent:
        datas = await asyncio.gather(
            *(ios[p].read(oid, timeout=120) for p, oid in jobs))
        got = dict(zip(jobs, datas))
        parts = await asyncio.gather(
            *(ios[p].read(oid, offset=100, length=1000, timeout=120)
              for p, oid in jobs))
        got_parts = dict(zip(jobs, parts))
    else:
        got = {}
        got_parts = {}
        for p, oid in jobs:
            got[(p, oid)] = await ios[p].read(oid, timeout=120)
            got_parts[(p, oid)] = await ios[p].read(
                oid, offset=100, length=1000, timeout=120)
    return client, expect, got, got_parts, (pool_a, io_a)


@contention_retry()
def test_batched_reads_bit_exact_vs_per_op_path():
    """Concurrent reads through the read coalescer return byte-identical
    data to the same reads issued serially through the per-op anchor —
    full and sub-range reads, mixed profiles, plus a degraded fast-k read
    with a shard holder stopped — in each package, and the two packages
    agree."""
    def run_path(coalesced: bool):
        async def scenario(P):
            vstart = P.imp("cluster.vstart")
            cfg = vstart._fast_config()
            if not coalesced:
                cfg.osd_op_shards = 0
                cfg.osd_batch_tick_ops = 0
                cfg.osd_pipeline_writes = 0
            cluster = await vstart.start_cluster(5, config=cfg)
            try:
                client, expect, got, got_parts, (pool_a, io_a) = \
                    await _read_workload(cluster, concurrent=coalesced)
                for key, payload in expect.items():
                    assert got[key] == payload, key
                    assert got_parts[key] == payload[100:1100], key
                pgid = client.objecter.object_pgid(pool_a, "ra1")
                _, _, acting, primary = \
                    client.objecter.osdmap.pg_to_up_acting_osds(pgid)
                victim = next(acting[s] for s in range(2)
                              if acting[s] >= 0 and acting[s] != primary)
                await cluster.kill_osd(victim)
                degraded = await io_a.read("ra1", timeout=120)
                assert degraded == expect[("a", "ra1")]
                if coalesced:
                    ticks = sum(o.perf.get("osd_read_batch_ticks")
                                for o in cluster.osds.values())
                    assert ticks > 0
                return {k: (got[k], got_parts[k]) for k in expect}, degraded
            finally:
                await cluster.stop()
        return scenario

    batched = run_both(run_path(True), bound=120.0)
    serial = run_both(run_path(False), bound=120.0)
    assert batched == serial


@contention_retry()
def test_recovery_reencode_through_seam_heals_blanked_shard():
    """Rot one member's shard, let scrub rebuild it, and require the
    healed shard byte-identical to its state before the damage."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        crcmod = P.imp("ops.crc32c")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "vrc", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            io = client.ioctx(pool)
            payload = bytes(range(256)) * 128
            await io.write_full("heal", payload, timeout=120)
            pgid = client.objecter.object_pgid(pool, "heal")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = next(o for o in acting if o >= 0 and o != primary)
            before = bytes(cluster.osds[victim].store.read(coll, "heal"))
            cluster.osds[victim].store.debug_bitrot(coll, "heal", 999)
            rep = await cluster.osds[primary].scrub_pg(
                cluster.osds[primary].pgs[pgid])
            assert "heal" in rep["repaired"], rep
            deadline = asyncio.get_event_loop().time() + 20.0
            after = None
            while asyncio.get_event_loop().time() < deadline:
                after = bytes(
                    cluster.osds[victim].store.read(coll, "heal"))
                if after == before:
                    break
                await asyncio.sleep(0.05)
            assert after == before
            assert crcmod.crc32c(0xFFFFFFFF, after) == int(
                cluster.osds[victim].store.getattr(coll, "heal",
                                                   "hinfo_crc"))
            return rep["repaired"], victim != primary
        finally:
            await cluster.stop()

    run_both(scenario)
