"""The port's OSD cluster against ``ceph_tpu``'s on the cases earlier
slices set aside until a monitor and OSDs could run together: the
OSD-backed cases of ``tests/test_cluster_mon.py`` and
``tests/test_control_plane.py``, the cluster cases of
``tests/test_bluestore.py``, ``tests/test_filestore.py``,
``tests/test_batch_chaos.py``, ``tests/test_ec_planar_at_rest.py``,
``tests/test_chaos.py`` and ``tests/test_integrity.py``, and
``tests/test_balance_elastic.py::test_disabled_balance_subsystem_is_noop``.
Each runs on both packages through ``tests/test_torch_cluster.run_both``
(or, for a scenario in several phases, phase by phase under the same
bound), each run under its own deadline.
"""

import asyncio
import pickle

from tests._flaky import contention_retry
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    PORT, REF, _one_torch_thread, _port_lockdep_reset, run, run_both)

# -- the cases of tests/test_cluster_mon.py -----------------------------------

def test_three_mon_quorum_replicates_maps():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, n_mons=3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            await io.write_full("obj", b"quorum-payload" * 50)
            assert await io.read("obj") == b"quorum-payload" * 50

            # every monitor converges on the same committed map
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                epochs = {m.osdmap.epoch for m in cluster.mons}
                pools = [sorted(p.name for p in m.osdmap.pools.values())
                         for m in cluster.mons]
                if len(epochs) == 1 and all(p == pools[0] for p in pools):
                    break
                await asyncio.sleep(0.05)
            assert len({m.osdmap.epoch for m in cluster.mons}) == 1
            for m in cluster.mons:
                assert any(p.name == "repl" for p in m.osdmap.pools.values())
            # exactly one leader
            assert sum(1 for m in cluster.mons if m.is_leader) == 1
        finally:
            await cluster.stop()

    run_both(scenario)


def test_leader_failover_mid_pool_create():
    """Kill the leader while a pool create is in flight: a new leader is
    elected, the command succeeds (client failover + idempotent create),
    maps converge identically on the survivors, and OSDs keep serving."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, n_mons=3)
        try:
            client = await cluster.client()
            p1 = await client.pool_create("before", "replicated",
                                          pg_num=4, size=3)
            io1 = client.ioctx(p1)
            await io1.write_full("pre", b"pre-failover" * 40)

            leader = cluster.mon
            dead_rank = leader.rank

            async def create():
                return await client.pool_create("during", "replicated",
                                                pg_num=4, size=3)

            before = leader.perf.get("mon_proposals")
            task = asyncio.get_event_loop().create_task(create())
            # converge-poll: wait until the create
            # actually REACHED the leader's proposal path, then kill —
            # a fixed sleep raced the command under load (too early:
            # nothing in flight; too late: already committed)
            deadline = asyncio.get_event_loop().time() + 5
            while asyncio.get_event_loop().time() < deadline:
                if leader.perf.get("mon_proposals") > before or \
                        task.done():
                    break
                await asyncio.sleep(0.005)
            await cluster.kill_mon(dead_rank)

            p2 = await asyncio.wait_for(task, timeout=30)
            new_leader = await cluster.wait_for_leader(exclude=dead_rank)
            assert new_leader.rank != dead_rank

            survivors = [m for m in cluster.mons if m.rank != dead_rank]
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                epochs = {m.osdmap.epoch for m in survivors}
                if len(epochs) == 1 and all(
                        any(p.name == "during"
                            for p in m.osdmap.pools.values())
                        for m in survivors):
                    break
                await asyncio.sleep(0.05)
            names = [sorted(p.name for p in m.osdmap.pools.values())
                     for m in survivors]
            assert names[0] == names[1], names
            # the pool exists exactly ONCE despite the client retry
            assert sum(1 for p in survivors[0].osdmap.pools.values()
                       if p.name == "during") == 1

            # OSDs keep serving through the new quorum
            io2 = client.ioctx(p2)
            await io2.write_full("post", b"post-failover" * 40, timeout=60)
            assert await io2.read("post", timeout=60) == \
                b"post-failover" * 40
            assert await io1.read("pre") == b"pre-failover" * 40
        finally:
            await cluster.stop()

    run_both(scenario)


def test_cluster_log_service():
    """Central cluster log (reference LogMonitor,
    src/mon/LogMonitor.h:39): daemon and mon events Paxos-replicate into
    a queryable log; 'log last' shows an induced failure."""
    import asyncio


    async def scenario(P):

        _fast_config = P.imp("cluster.vstart._fast_config")

        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, config=_fast_config())
        try:
            client = await cluster.client()
            await client.pool_create("clogp", "replicated",
                                     pg_num=4, size=2)
            victim = max(cluster.osds)
            await cluster.osds[victim].stop()
            # wait for failure detection to mark it down, then for the
            # mon tick to flush the clog buffer through Paxos
            deadline = 400
            entries = []
            for _ in range(deadline):
                await asyncio.sleep(0.1)
                r = await client.objecter.mon_command(
                    {"prefix": "log last", "num": 50})
                entries = r if isinstance(r, list) else []
                if any(f"osd.{victim}" in e["msg"] and "down" in e["msg"]
                       for e in entries):
                    break
            msgs = [e["msg"] for e in entries]
            assert any("pool 'clogp' created" in m for m in msgs), msgs
            assert any(f"osd.{victim}" in m and "down" in m
                       for m in msgs), msgs
            # entries carry who/stamp/prio
            assert all({"who", "stamp", "prio", "msg"} <= set(e)
                       for e in entries)
        finally:
            await cluster.stop()

    run_both(scenario)



# -- the cases of tests/test_control_plane.py ---------------------------------

def test_inc_chain_cap_skips_to_full_and_failures_coalesce():
    """Two control-plane bounds on one cluster: (a) an OSD handed an
    incremental chain past osd_map_max_inc_chain requests a full map
    instead of applying it; (b) simultaneous failure reports coalesce
    into few epochs (mon_osd_failure_coalesce window); (c) a no-op
    epoch re-peers nothing (the vectorized delta's whole point)."""
    import pickle


    async def scenario(P):
        M = P.imp("cluster.messages")
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        Incremental = P.imp("osdmap.osdmap.Incremental")
        cfg = _fast_config()
        cfg.mon_osd_failure_coalesce = 0.5
        cfg.osd_map_max_inc_chain = 2
        # the beacon-staleness tick must not win the markdown race:
        # this test proves the failure-REPORT aggregation path
        cfg.mon_osd_beacon_grace = 30.0
        cluster = await start_cluster(6, config=cfg)
        try:
            client = await cluster.client()
            await client.pool_create("cp", "replicated", pg_num=8,
                                     size=3)
            await cluster.wait_for_epoch(cluster.mon.osdmap.epoch,
                                         timeout=10)
            osd = cluster.osds[0]

            # (c) a placement-neutral epoch (clog-only inc) must not
            # re-peer anything on a vectorized-delta OSD
            repeered0 = osd.perf.get("osd_pgs_repeered")
            mon = cluster.mon
            async with mon._map_mutex:
                inc = mon._new_inc()
                inc.new_log_entries = (("test", 0.0, "INF", "noop"),)
                await mon._commit_inc(inc)
            await cluster.wait_for_epoch(mon.osdmap.epoch, timeout=10)
            assert osd.perf.get("osd_pgs_repeered") == repeered0

            # (a) synthetic over-long chain -> skip-to-full request
            base = osd.osdmap.epoch
            blobs = [pickle.dumps(Incremental(epoch=base + 1 + i))
                     for i in range(3)]
            skips0 = osd.perf.get("osd_map_skip_to_full")
            await osd._handle_inc_map(M.MOSDIncMapMsg(
                prev_epoch=base, epoch=base + 3, inc_blobs=blobs))
            assert osd.perf.get("osd_map_skip_to_full") == skips0 + 1
            # the chain was NOT applied; the mon's full-map reply (the
            # since=0 re-subscribe) re-syncs the daemon
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                if osd.osdmap.epoch >= mon.osdmap.epoch:
                    break
                await asyncio.sleep(0.05)
            assert osd.osdmap.epoch >= mon.osdmap.epoch

            # (b) three dead OSDs -> their markdowns share epochs
            epoch0 = mon.osdmap.epoch
            for victim in (3, 4, 5):
                await cluster.kill_osd(victim)
            deadline = asyncio.get_event_loop().time() + 20
            while asyncio.get_event_loop().time() < deadline:
                if all(not mon.osdmap.osd_up[v] for v in (3, 4, 5)):
                    break
                await asyncio.sleep(0.05)
            assert all(not mon.osdmap.osd_up[v] for v in (3, 4, 5))
            assert mon.perf.get("mon_failures_coalesced") >= 1
            # 3 markdowns + their clog flushes in well under 3+3 epochs
            assert mon.osdmap.epoch - epoch0 <= 4, \
                (epoch0, mon.osdmap.epoch)
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the cases of tests/test_bluestore.py -------------------------------------

@contention_retry()
def test_full_cluster_on_bluestore(tmp_path):
    """vstart --bluestore analog: the whole cluster on BlueStore,
    including a full-cluster restart resume (the FileStore restart test's
    flagship-store twin)."""
    import asyncio


    async def scenario(P):
        root = tmp_path / P.name
        root.mkdir(exist_ok=True)
        OSDDaemon = P.imp("cluster.osd.OSDDaemon")
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")

        BlueStore = P.imp("cluster.bluestore.BlueStore")
        cfg = _fast_config()
        cluster = await start_cluster(
            3, config=cfg,
            store_factory=lambda o: BlueStore(
                str(root / f"osd{o}"), size=64 << 20))
        try:
            client = await cluster.client()
            pool = await client.pool_create("bs", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"bluestore-cluster" * 100)
            assert await io.read("obj") == b"bluestore-cluster" * 100
            # bounce one OSD, keeping its store directory
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(
                    client.objecter.object_pgid(pool, "obj"))
            victim = acting[0]
            stopped = cluster.osds.pop(victim)
            await stopped.stop()
            osd = OSDDaemon(victim, cluster.mon_addr, config=cfg,
                            store=BlueStore(str(root / f"osd{victim}"),
                                            size=64 << 20))
            await osd.start()
            cluster.osds[victim] = osd
            for _ in range(100):
                if cluster.mon.osdmap.osd_up[victim]:
                    break
                await asyncio.sleep(0.05)
            assert await io.read("obj", timeout=60) == \
                b"bluestore-cluster" * 100
        finally:
            await cluster.stop()

    run_both(scenario)


def test_snapshots_and_scrub_on_bluestore_ec_pool(tmp_path):
    """Cross-feature integration: EC pool + snapshots (shard-local COW
    clones) + scrub, all on the BlueStore flagship store — the stack a
    reference user actually runs."""
    import asyncio


    async def scenario(P):
        root = tmp_path / P.name
        root.mkdir(exist_ok=True)
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")

        BlueStore = P.imp("cluster.bluestore.BlueStore")
        cfg = _fast_config()
        cluster = await start_cluster(
            3, config=cfg,
            store_factory=lambda o: BlueStore(
                str(root / f"bosd{o}"), size=64 << 20))
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "bsec", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            io = client.ioctx(pool)
            v1 = bytes(range(256)) * 32
            await io.write_full("obj", v1)
            sid = await io.selfmanaged_snap_create()
            io.set_snap_context(sid, [sid])
            await io.write_full("obj", b"HEAD" * 2048)
            assert await io.read("obj") == b"HEAD" * 2048
            assert await io.read("obj", snapid=sid) == v1
            # scrub finds the BlueStore-backed EC shards consistent
            for osd in cluster.osds.values():
                for st in list(osd.pgs.values()):
                    if st.primary == osd.osd_id:
                        rep = await osd.scrub_pg(st)
                        assert not rep["inconsistent"], rep
        finally:
            await cluster.stop()

    run_both(scenario)



# -- the cases of tests/test_filestore.py -------------------------------------

def test_cluster_full_restart_zero_pushes(tmp_path):
    """Write to a durable cluster, stop EVERY osd, restart from disk:
    reads succeed and recovery pushes nothing (logs all agree)."""
    async def scenario(P):
        root = tmp_path / P.name
        root.mkdir(exist_ok=True)
        FileStore = P.imp("cluster.filestore.FileStore")
        OSDDaemon = P.imp("cluster.osd.OSDDaemon")
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")

        cfg = _fast_config()
        cfg.mon_osd_down_out_interval = 120.0

        def factory(osd_id):
            return FileStore(str(root / f"osd{osd_id}"))

        cluster = await start_cluster(3, config=cfg, store_factory=factory)
        try:
            client = await cluster.client()
            rpool = await client.pool_create("repl", "replicated",
                                             pg_num=8, size=3)
            epool = await client.pool_create(
                "ecp", "erasure", pg_num=8,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            rio = client.ioctx(rpool)
            eio = client.ioctx(epool)
            payloads = {f"r{i}": f"repl-{i}".encode() * 100 for i in range(6)}
            epayloads = {f"e{i}": f"ec-{i}".encode() * 200 for i in range(4)}
            for oid, data in payloads.items():
                await rio.write_full(oid, data)
            for oid, data in epayloads.items():
                await eio.write_full(oid, data)

            # full stop of every OSD (mon stays; its durable store is the
            # paxos-mon milestone)
            ids = list(cluster.osds)
            for o in ids:
                osd = cluster.osds.pop(o)
                await osd.stop()
            for o in ids:
                await cluster.wait_down(o)

            for o in ids:
                osd = OSDDaemon(o, cluster.mon_addr, config=cfg,
                                store=factory(o))
                await osd.start()
                cluster.osds[o] = osd
            deadline = asyncio.get_event_loop().time() + 15
            while asyncio.get_event_loop().time() < deadline:
                if all(cluster.mon.osdmap.osd_up[o] for o in ids):
                    break
                await asyncio.sleep(0.05)
            # peering window: converge-poll the first read against a
            # wall deadline instead of a fixed sleep
            deadline = asyncio.get_event_loop().time() + 15
            first = next(iter(payloads))
            while asyncio.get_event_loop().time() < deadline:
                try:
                    if await rio.read(first, timeout=5) \
                            == payloads[first]:
                        break
                except Exception:
                    pass
                await asyncio.sleep(0.05)

            for oid, data in payloads.items():
                assert await rio.read(oid) == data, oid
            for oid, data in epayloads.items():
                assert await eio.read(oid) == data, oid
            pushes = sum(o.perf.get("osd_pushes_sent")
                         for o in cluster.osds.values())
            assert pushes == 0, f"restart resume must not push ({pushes})"
        finally:
            await cluster.stop()

    run_both(scenario)


def test_whole_cluster_restart_including_mon(tmp_path):
    """THE full durability story: stop mon AND every osd, restart all
    from disk — pools, maps, and data all resume (MonitorDBStore +
    superblock + pg logs).  Both packages, each on its own stores."""
    async def phase1(P, root):
        FileStore = P.imp("cluster.filestore.FileStore")
        cfg = P.imp("cluster.vstart._fast_config")()

        def osd_store(o):
            return FileStore(str(root / f"osd{o}"))

        def mon_store(r):
            return FileStore(str(root / f"mon{r}"))

        cluster = await P.imp("cluster.vstart.start_cluster")(
            3, config=cfg, store_factory=osd_store,
            mon_store_factory=mon_store)
        try:
            client = await cluster.client()
            pool = await client.pool_create("persist", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("survivor", b"across-restarts" * 50)
            return cluster.mon.osdmap.epoch, pool
        finally:
            await cluster.stop()

    async def phase2(P, root, epoch, pool):
        FileStore = P.imp("cluster.filestore.FileStore")
        OSDDaemon = P.imp("cluster.osd.OSDDaemon")
        cfg = P.imp("cluster.vstart._fast_config")()
        # the ctor map is a throwaway: start() resumes the persisted one
        cmap, _ = P.imp("crush.types.build_hierarchy")(3, 1, numrep=3)
        osdmap = P.imp("osdmap.osdmap.OSDMap")(cmap, max_osd=3)
        mon = P.imp("cluster.mon.Monitor")(
            osdmap, config=cfg, store=FileStore(str(root / "mon0")))
        addr = await mon.start()
        assert mon.osdmap.epoch >= epoch          # resumed, not reset
        assert pool in mon.osdmap.pools           # pool survived
        osds = []
        try:
            for o in range(3):
                osd = OSDDaemon(o, addr, config=cfg,
                                store=FileStore(str(root / f"osd{o}")))
                await osd.start()
                osds.append(osd)
            deadline = asyncio.get_event_loop().time() + 15
            while asyncio.get_event_loop().time() < deadline:
                if all(mon.osdmap.osd_up[o] for o in range(3)):
                    break
                await asyncio.sleep(0.05)
            client = P.imp("cluster.objecter.RadosClient")(addr, config=cfg)
            await client.connect()
            try:
                io = client.ioctx(pool)
                data = await io.read("survivor")
                assert data == b"across-restarts" * 50
                return data
            finally:
                await client.shutdown()
        finally:
            for osd in osds:
                await osd.stop()
            await mon.stop()

    out = []
    for P in (REF, PORT):
        root = tmp_path / P.name
        epoch, pool = run(phase1(P, root))
        out.append((pool, run(phase2(P, root, epoch, pool))))
    assert out[0] == out[1]


# -- the cases of tests/test_batch_chaos.py -----------------------------------

def test_crash_point_fires_and_cluster_recovers():
    """Arm commit_pre_fanout on a primary: the daemon power-cuts itself
    mid-write (after frontier open + local apply, before any sub-write
    leaves), the cluster's bookkeeping absorbs the crash, and after a
    revive every acked write reads back bit-exact — the write caught by
    the crash either fails or lands whole via client retry, never
    torn."""

    async def scenario(P):

        _fast_config = P.imp("cluster.vstart._fast_config")

        start_cluster = P.imp("cluster.vstart.start_cluster")
        # seeded payloads: both packages write the same bytes
        rng = __import__("random").Random(11)

        cluster = await start_cluster(4, config=_fast_config())
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "cp", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            io = client.ioctx(pool)
            datas = {f"o{i}": rng.randbytes(8192) for i in range(4)}
            for oid, d in datas.items():
                await io.write_full(oid, d)
            pgid = client.objecter.object_pgid(pool, "o0")
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            before = _counters(P).get("crash_points_fired", 0)
            cluster.osds[primary].config.injectargs(
                {"chaos_crash_point": "commit_pre_fanout"})
            # the overwrite that trips the crash retries onto the
            # post-peering acting set and must land whole
            new = rng.randbytes(8192)
            await io.write_full("o0", new, timeout=60)
            datas["o0"] = new
            await cluster.drain_chaos()
            assert _counters(P)["crash_points_fired"] == before + 1
            assert primary not in cluster.osds  # bookkeeping coherent
            await cluster.revive_osd(primary)
            deadline = asyncio.get_event_loop().time() + 30
            while asyncio.get_event_loop().time() < deadline:
                if cluster.mon.osdmap.osd_up[primary]:
                    break
                await asyncio.sleep(0.1)
            for oid, d in datas.items():
                got = None
                err = None
                while asyncio.get_event_loop().time() < deadline:
                    try:
                        got = await io.read(oid, timeout=30)
                        err = None
                    except (IOError, OSError) as e:
                        err = e
                        await asyncio.sleep(0.25)
                        continue
                    if got == d:
                        break
                    await asyncio.sleep(0.25)
                assert got == d, (oid, err)
        finally:
            await cluster.stop()

    run_both(scenario)


def test_sharded_wq_tick_composition_is_seed_stable():
    """Chaos replays on the sharded WQ: PG->shard placement is a pure
    function (same pgid, same shard, across runs, processes and
    packages), so a seeded scenario's ops meet the same shard queues;
    the batch mutator consumes per-frame draws deterministically."""
    class _O:
        class config:
            osd_op_queue = "fifo"
            osd_batch_tick_ops = 16

    shards, drops = [], []
    for P in (REF, PORT):
        ShardedOpWQ = P.imp("cluster.sharded_wq.ShardedOpWQ")
        PGid = P.imp("osdmap.osdmap.PGid")
        a = ShardedOpWQ(_O(), 4)
        b = ShardedOpWQ(_O(), 4)
        got = []
        for pool in range(3):
            for seed in range(32):
                assert a.shard_for(PGid(pool, seed)).idx == \
                    b.shard_for(PGid(pool, seed)).idx
                got.append(a.shard_for(PGid(pool, seed)).idx)
        shards.append(got)
        NetInjector = P.imp("chaos.net.NetInjector")
        stream = P.imp("chaos.rng.stream")
        M = P.imp("cluster.messages")
        inj1 = NetInjector(stream(3, "net:osd.1"), batch_item_drop=0.4)
        inj2 = NetInjector(stream(3, "net:osd.1"), batch_item_drop=0.4)
        kept = []
        for n in (4, 7, 2, 9):
            f1, f2 = _frame(M, n), _frame(M, n)
            inj1.mutate_batch(f1)
            inj2.mutate_batch(f2)
            assert [i.reqid for i in f1.items] == [i.reqid for i in f2.items]
            kept.append([i.reqid for i in f1.items])
        drops.append(kept)
    assert shards[0] == shards[1] and drops[0] == drops[1]


# -- the cases of tests/test_ec_planar_at_rest.py -----------------------------

PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
           "k": "2", "m": "1"}


def _unseamed(KERNELS):
    return KERNELS.get("ec_planar_unseamed_conversions")


def _frame(M, n):
    return M.MOSDECSubOpWriteBatch(
        items=[M.MOSDECSubOpWrite(reqid=("c", i), shard=i % 3)
               for i in range(n)],
        epoch=1)


async def _cluster_workload(P, planar: int):
    """One full shard life-cycle (write_full, append, RMW, ranged +
    full reads, deep scrub) on a 3-OSD cluster; returns every
    client-visible byte, per-member shard crc, scrub verdict, and the
    planar counter deltas."""
    KERNELS = P.imp("ops.profiling.KERNELS")
    cfg = P.imp("cluster.vstart._fast_config")()
    cfg.osd_ec_planar_at_rest = planar
    cluster = await P.imp("cluster.vstart.start_cluster")(3, config=cfg)
    out = {}
    try:
        client = await cluster.client()
        pool = await client.pool_create("p", "erasure", pg_num=4,
                                        ec_profile=PROFILE)
        io = client.ioctx(pool)
        base = _unseamed(KERNELS)
        await io.write_full("a", bytes(range(256)) * 40, timeout=60)
        await io.append("a", b"tail-" * 100)
        await io.write("a", b"X" * 777, 1000)          # mid-object RMW
        await io.write_full("b", b"hello world" * 9)
        await io.truncate("b", 37)
        out["reads"] = (await io.read("a"), await io.read("b"),
                        await io.read("a", 500, 2000))
        # per-member shard state: crc + layout, keyed by (oid, shard)
        state = {}
        layouts = set()
        for osd in cluster.osds.values():
            for coll in list(osd.store._colls):
                for oid in ("a", "b"):
                    if oid in osd.store._colls[coll]:
                        sh = osd.store.getattr(coll, oid, "shard")
                        state[(oid, sh)] = osd.store.getattr(
                            coll, oid, "hinfo_crc")
                        layouts.add(osd.store.object_layout(coll, oid))
        out["shard_crcs"] = state
        out["layouts"] = layouts
        # deep scrub the PG holding "a": verdict must be clean
        pgid = client.objecter.object_pgid(pool, "a")
        _, _, _, primary = \
            client.objecter.osdmap.pg_to_up_acting_osds(pgid)
        st = cluster.osds[primary].pgs[pgid]
        report = await cluster.osds[primary].scrub_pg(st)
        out["scrub"] = (sorted(report["inconsistent"]),
                        sorted(report["repaired"]))
        out["unseamed_delta"] = _unseamed(KERNELS) - base
        out["ingest"] = KERNELS.get("ec_planar_ingest_conversions")
        out["egress"] = KERNELS.get("ec_planar_egress_conversions")
    finally:
        await cluster.stop()
    return out


@contention_retry()
def test_cluster_planar_vs_byte_anchor_bit_exact():
    """THE gate: the same workload under planar=1 and the
    byte anchor yields byte-identical client reads, identical shard
    crcs, and identical (clean) scrub verdicts — while the planar run
    stores every EC object as planes and books ZERO unseamed
    conversions (write, append, RMW, ranged read, deep scrub all
    steady-state conversion-free)."""
    async def scenario(P):
        planar_store = P.imp("ec.planar_store")
        p = await _cluster_workload(P, 1)
        b = await _cluster_workload(P, 0)
        assert p["reads"] == b["reads"]
        assert p["shard_crcs"] == b["shard_crcs"]
        assert p["scrub"] == b["scrub"] == ([], [])
        assert p["layouts"] == {planar_store.LAYOUT_PLANAR}
        assert b["layouts"] == {None}
        assert p["unseamed_delta"] == 0, \
            f"unseamed conversions on the steady-state path: " \
            f"{p['unseamed_delta']}"
        assert p["ingest"] > 0 and p["egress"] > 0
        return p["reads"], p["shard_crcs"], p["scrub"]

    run_both(scenario)


@contention_retry()
def test_cluster_planar_scrub_repair_and_recovery():
    """Corrupt one member's planar shard: deep scrub detects it over
    plane-major rows, the recovery rebuild re-encodes IN the plane
    domain, the repaired shard lands planar bit-identical — and the
    whole detect/rebuild/land cycle books zero unseamed
    conversions."""

    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")

        _coll = P.imp("cluster.pg._coll")

        planar_store = P.imp("ec.planar_store")
        cluster = await start_cluster(3)   # vstart default: planar on
        try:
            client = await cluster.client()
            pool = await client.pool_create("sp", "erasure", pg_num=4,
                                            ec_profile=PROFILE)
            io = client.ioctx(pool)
            payload = b"planar-scrub" * 300
            await io.write_full("obj", payload, timeout=60)
            KERNELS = P.imp("ops.profiling.KERNELS")
            base = _unseamed(KERNELS)
            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = next(o for o in acting
                          if o >= 0 and o != primary
                          and o in cluster.osds)
            vstore = cluster.osds[victim].store
            assert vstore.object_layout(_coll(pgid), "obj") \
                == planar_store.LAYOUT_PLANAR
            before = bytes(vstore.read_planar(_coll(pgid), "obj"))
            vstore._colls[_coll(pgid)]["obj"].data[3] ^= 0xFF
            st = cluster.osds[primary].pgs[pgid]
            report = await cluster.osds[primary].scrub_pg(st)
            assert report["inconsistent"] == ["obj"]
            assert report["repaired"] == ["obj"]
            # repair lands asynchronously on the victim: converge-poll
            # against a wall deadline instead of a fixed sleep
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                if bytes(vstore.read_planar(_coll(pgid), "obj")) \
                        == before:
                    break
                await asyncio.sleep(0.05)
            assert bytes(vstore.read_planar(_coll(pgid), "obj")) \
                == before
            assert vstore.object_layout(_coll(pgid), "obj") \
                == planar_store.LAYOUT_PLANAR
            assert await io.read("obj", timeout=60) == payload
            assert _unseamed(KERNELS) - base == 0
        finally:
            await cluster.stop()

    run_both(scenario)


def test_planar_counters_ride_prometheus_scrape():
    """The KERNELS counters of the planar layout surface through the same
    perfcoll.dump() -> render_prometheus path the mgr's scrape and
    exporter serve, in both packages, under the same names."""
    for P in (REF, PORT):
        KERNELS = P.imp("ops.profiling.KERNELS")
        # book explicitly so this test stands alone
        record_planar_at_rest = P.imp("ops.profiling.record_planar_at_rest")
        record_planar_at_rest("ingest", 4096)
        record_planar_at_rest("egress", 4096)
        coll = P.imp("utils.PerfCountersCollection")()
        coll.register(KERNELS)
        text = P.imp("cluster.mgr.render_prometheus")(
            {n: c["counters"] if "counters" in c else c
             for n, c in coll.dump().items()})
        for name in ("ec_planar_ingest_conversions",
                     "ec_planar_ingest_bytes",
                     "ec_planar_egress_conversions"):
            assert name in text, text[:2000]


def test_attribution_books_planar_convert_stage():
    for P in (REF, PORT):
        stage_for = P.imp("trace.attribution.stage_for")
        assert stage_for("planar_ingest") == "planar_convert"
        assert stage_for("planar_egress") == "planar_convert"


# -- the cases of tests/test_chaos.py -----------------------------------------

def _counters(P):
    return dict(P.imp("chaos.counters.CHAOS").dump()["chaos"])


def test_cluster_without_chaos_emits_zero_counters():
    """The acceptance no-op proof: a chaos-free cluster run — boot,
    pool, writes, reads, scrub — leaves messenger.chaos/store.chaos None
    and increments NO chaos counter."""
    async def scenario(P):
        chaos_total = P.imp("chaos.counters.chaos_total")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        before = chaos_total()
        cluster = await start_cluster(3)
        try:
            for osd in cluster.osds.values():
                assert osd.messenger.chaos is None
                assert osd.store.chaos is None
            for mon in cluster.mons:
                assert mon.messenger.chaos is None
            client = await cluster.client()
            pool = await client.pool_create("noop", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            for i in range(4):
                await io.write_full(f"o{i}", b"quiet" * 50)
            for i in range(4):
                assert await io.read(f"o{i}") == b"quiet" * 50
        finally:
            await cluster.stop()
        assert chaos_total() == before
    run_both(scenario)


def test_messenger_injector_follows_injectargs():
    """The injectargs seam: chaos_net_* on a daemon's config rebuilds
    its messenger injector live; zeroing returns it to None."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            osd = cluster.osds[0]
            assert osd.messenger.chaos is None
            osd.config.injectargs({"chaos_net_drop": 0.25})
            assert osd.messenger.chaos is not None
            assert osd.messenger.chaos.drop == 0.25
            osd.config.injectargs({"chaos_net_drop": 0.0})
            assert osd.messenger.chaos is None
        finally:
            await cluster.stop()
    run_both(scenario)


def test_chaos_report_admin_command():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            data = await cluster.daemon_command("osd.1",
                                                "chaos report")
            assert data["active"] is False
            assert "net_drops" in data["counters"]
            cluster.osds[1].config.injectargs({"chaos_net_drop": 0.1})
            data = await cluster.daemon_command("osd.1",
                                                "chaos report")
            assert data["active"] is True
            assert data["options"]["chaos_net_drop"] == 0.1
            # the other daemon's view stays inactive (per-daemon config)
            data = await cluster.daemon_command("osd.0",
                                                "chaos report")
            assert data["active"] is False
        finally:
            await cluster.stop()
    run_both(scenario)


def test_restart_osd_keeps_injected_config():
    """The satellite fix: kill/revive and restart must resume the
    daemon's per-daemon config copy, so injected fault options survive a
    bounce within a scenario."""
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()
        cfg.mon_osd_down_out_interval = 60.0
        cluster = await start_cluster(3, config=cfg)
        try:
            cluster.osds[0].config.injectargs(
                {"chaos_net_drop": 0.05, "chaos_seed": 99})
            await cluster.restart_osd(0)
            assert cluster.osds[0].config.chaos_net_drop == 0.05
            assert cluster.osds[0].config.chaos_seed == 99
            assert cluster.osds[0].messenger.chaos is not None

            cluster.osds[1].config.injectargs({"chaos_clock_skew": 1.5})
            await cluster.kill_osd(1)
            await cluster.revive_osd(1)
            assert cluster.osds[1].config.chaos_clock_skew == 1.5
            assert cluster.osds[1].clock.skew == 1.5
            # an untouched daemon still boots from the cluster template
            await cluster.restart_osd(2)
            assert cluster.osds[2].config.chaos_net_drop == 0.0
        finally:
            await cluster.stop()
    run_both(scenario)


def test_incomplete_recovery_retries_without_map_change():
    """An incomplete recovery round (unreachable member, failed
    pull/push) must re-arm itself with capped backoff: peering is
    otherwise only triggered by map changes, and a pull that fails
    AFTER the last map change of an outage would leave the primary
    stale forever (graft-chaos: persistent torn EC reads)."""
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, config=_fast_config())
        try:
            client = await cluster.client()
            pool = await client.pool_create("retry", "replicated",
                                            pg_num=2, size=3)
            io = client.ioctx(pool)
            await io.write_full("o", b"x" * 64)
            pgid = client.objecter.object_pgid(pool, "o")
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            osd = cluster.osds[primary]
            st = osd.pgs[pgid]

            import random as _random

            ExpBackoff = P.imp("utils.backoff.ExpBackoff")

            # fast, seeded backoff so the test runs in milliseconds
            osd._recovery_backoffs[st.pgid] = ExpBackoff(
                base=0.02, cap=0.05, rng=_random.Random(7))
            calls = []
            orig = osd._recover_pg_locked

            async def flaky(st_arg):
                calls.append(len(calls))
                if len(calls) < 3:
                    return False          # incomplete: must re-arm
                return await orig(st_arg)

            osd._recover_pg_locked = flaky
            await osd._recover_pg(st)
            # converge-poll: wait for a COMPLETE
            # round to clear the backoff too — under suite load the
            # real rounds can keep coming up incomplete (2s peering
            # query timeouts) well past the old 5s window
            deadline = asyncio.get_event_loop().time() + 20.0
            while asyncio.get_event_loop().time() < deadline:
                if len(calls) >= 3 and \
                        st.pgid not in osd._recovery_retry_tasks and \
                        st.pgid not in osd._recovery_backoffs:
                    break
                await asyncio.sleep(0.05)
            assert len(calls) >= 3, "incomplete recovery never retried"
            # a COMPLETE round resets the backoff and leaves no retry
            assert st.pgid not in osd._recovery_backoffs
        finally:
            await cluster.stop()
    run_both(scenario)



# -- the cases of tests/test_integrity.py -------------------------------------

EC21 = {"plugin": "jerasure", "technique": "reed_sol_van",
        "k": "2", "m": "1"}


async def _converge_poll(fn, timeout=20.0, interval=0.05):
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        v = fn()
        if v:
            return v
        await asyncio.sleep(interval)
    return fn()


@contention_retry()
def test_read_repair_heals_bitrot_off_client_path():
    """A flipped bit on one shard: the read still returns the acked
    payload (decode around the corruption — zero wrong bytes), the
    corrupt shard is rebuilt in place asynchronously, counters fire,
    and the PG's inconsistent set drains (clean health flow)."""
    async def scenario(P):
        DiskInjector = P.imp("chaos.disk.DiskInjector")
        stream = P.imp("chaos.rng.stream")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        crcmod = P.imp("ops.crc32c")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rr", "erasure", pg_num=4,
                                            ec_profile=EC21)
            io = client.ioctx(pool)
            payload = b"verified-read-payload-" * 800
            await io.write_full("obj0", payload, timeout=120)
            pgid = client.objecter.object_pgid(pool, "obj0")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = [o for o in acting if o >= 0][0]
            DiskInjector(stream(7, "t")).flip_bit(
                cluster.osds[victim].store, coll, "obj0", bit=12345)
            got = await io.read("obj0", timeout=60)
            assert got == payload          # zero wrong-bytes acks
            assert await _converge_poll(lambda: sum(
                o.perf.get("osd_read_repairs")
                for o in cluster.osds.values()))
            assert sum(o.perf.get("osd_read_shard_crc_errors")
                       for o in cluster.osds.values()) >= 1

            def _healed():
                full = cluster.osds[victim].store.read(coll, "obj0")
                stored = int(cluster.osds[victim].store.getattr(
                    coll, "obj0", "hinfo_crc"))
                return crcmod.crc32c(0xFFFFFFFF, full) == stored

            assert await _converge_poll(_healed)
            st = cluster.osds[primary].pgs[pgid]
            assert await _converge_poll(lambda: not st.inconsistent)
        finally:
            await cluster.stop()

    run_both(scenario)


@contention_retry()
def test_scheduled_scrub_repairs_without_a_read():
    """The jittered scrub scheduler finds and heals silent rot that NO
    client read ever touches, and the list-inconsistent / repair admin
    commands serve their contract."""
    async def scenario(P):
        DiskInjector = P.imp("chaos.disk.DiskInjector")
        stream = P.imp("chaos.rng.stream")
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        crcmod = P.imp("ops.crc32c")
        cfg = _fast_config()
        cfg.osd_scrub_interval = 0.4
        cluster = await start_cluster(4, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ss", "erasure", pg_num=4,
                                            ec_profile=EC21)
            io = client.ioctx(pool)
            await io.write_full("cold", b"never-read-again-" * 600,
                                timeout=120)
            pgid = client.objecter.object_pgid(pool, "cold")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = [o for o in acting if o >= 0][-1]
            DiskInjector(stream(9, "s")).flip_bit(
                cluster.osds[victim].store, coll, "cold", bit=777)

            def _healed():
                full = cluster.osds[victim].store.read(coll, "cold")
                stored = int(cluster.osds[victim].store.getattr(
                    coll, "cold", "hinfo_crc"))
                return crcmod.crc32c(0xFFFFFFFF, full) == stored

            assert await _converge_poll(_healed, timeout=30.0)
            assert sum(o.perf.get("osd_scrubs_scheduled")
                       for o in cluster.osds.values()) > 0
            assert sum(o.perf.get("osd_scrub_errors_repaired")
                       for o in cluster.osds.values()) >= 1
            # admin surface: nothing left inconsistent, repair runs
            li = await cluster.daemon_command(f"osd.{primary}",
                                              "list-inconsistent")
            assert li == {}
            rep = await cluster.daemon_command(f"osd.{primary}",
                                               "repair")
            assert all(not r["inconsistent"]
                       for r in rep.values()), rep
        finally:
            await cluster.stop()

    run_both(scenario)


@contention_retry()
def test_inconsistent_health_raises_and_clears():
    """PG_INCONSISTENT / OSD_SCRUB_ERRORS ride the beacon stream: an
    unrepaired object raises both (and list-inconsistent names it);
    healing clears them on the next beacon, like SLOW_OPS."""
    async def scenario(P):
        stream = P.imp("chaos.rng.stream")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("hi", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            await io.write_full("h0", b"payload", timeout=60)
            pgid = client.objecter.object_pgid(pool, "h0")
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            st = cluster.osds[primary].pgs[pgid]
            st.inconsistent.add("h0")

            def _raised():
                checks = cluster.mon._health_data()["checks"]
                return "PG_INCONSISTENT" in checks and \
                    "OSD_SCRUB_ERRORS" in checks

            assert await _converge_poll(_raised)
            li = await cluster.daemon_command(f"osd.{primary}",
                                              "list-inconsistent")
            assert li == {str(pgid): ["h0"]}
            st.inconsistent.discard("h0")
            assert await _converge_poll(
                lambda: "PG_INCONSISTENT" not in
                cluster.mon._health_data()["checks"])
        finally:
            await cluster.stop()

    run_both(scenario)


@contention_retry()
def test_full_flag_cycle_enospc_drain_resume():
    """Fill to the enforced capacity: explicit ENOSPC (errno 28, never
    a timeout), the map's full flag + OSD_FULL/HEALTH_ERR raise,
    deletes stay admitted, the flag clears as space frees, writes
    resume, and every surviving acked object reads back intact."""
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()
        cfg.memstore_device_bytes = 1 << 19       # 512 KiB stores
        cluster = await start_cluster(3, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ff", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            payload = b"f" * 24576
            acked, enospc = [], 0
            for i in range(40):
                try:
                    await io.write_full(f"o{i}", payload, timeout=20)
                    acked.append(f"o{i}")
                except OSError as e:
                    assert getattr(e, "errno", None) == 28, e
                    enospc += 1
                    if enospc >= 3:
                        break
                    await asyncio.sleep(0.15)
            assert enospc >= 3 and acked
            assert await _converge_poll(
                lambda: "full" in cluster.mon.osdmap.flags)
            h = cluster.mon._health_data()
            assert "OSD_FULL" in h["checks"]
            assert h["status"] == "HEALTH_ERR"
            # deletes admitted WHILE full
            doomed = acked[: max(1, len(acked) * 3 // 4)]
            for oid in doomed:
                await io.remove(oid, timeout=20)
            survivors = [o for o in acked if o not in doomed]
            assert await _converge_poll(
                lambda: "full" not in cluster.mon.osdmap.flags,
                timeout=30.0)
            await cluster.wait_for_epoch(cluster.mon.osdmap.epoch,
                                         timeout=10)
            await io.write_full("post", payload, timeout=30)
            assert await io.read("post", timeout=30) == payload
            for oid in survivors:      # zero acked-then-lost
                assert await io.read(oid, timeout=30) == payload, oid
        finally:
            await cluster.stop()

    run_both(scenario)


@contention_retry()
def test_backfillfull_gates_backfill_data_movement():
    """With the backfillfull flag on the primary's map, a peering
    round defers FULL-INVENTORY backfill (counter + incomplete round)
    while log-DELTA recovery still proceeds; clearing the flag lets
    the armed retry backfill the member."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            # ONE PG so the log-trim below provably strands the victim
            # behind the tail (a true backfill, not a delta resync)
            pool = await client.pool_create("bf", "replicated",
                                            pg_num=1, size=3)
            io = client.ioctx(pool)
            payload = b"b" * 8192
            for i in range(4):
                await io.write_full(f"g{i}", payload, timeout=60)
            # the victim must be a NON-primary member: the gate lives
            # on the pushing primary (a dead primary would come back
            # and PULL itself current instead — the ungated path)
            pgid = client.objecter.object_pgid(pool, "g0")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = next(o for o in acting if o >= 0 and o != primary)
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            # shrink the survivors' log window and write past it: the
            # dead member falls behind the TAIL — backfill territory
            for osd in cluster.osds.values():
                for st in osd.pgs.values():
                    st.log.max_entries = 2
            for i in range(4, 12):
                await io.write_full(f"g{i}", payload, timeout=60)
            # arm the gate on every survivor's map copy, then revive
            # the (empty) member: backfill must defer
            for osd in cluster.osds.values():
                osd.osdmap.flags.add("backfillfull")
            await cluster.revive_osd(victim)
            assert await _converge_poll(lambda: sum(
                o.perf.get("osd_backfill_blocked_full")
                for o in cluster.osds.values()), timeout=30.0)
            # clear the gate; the capped-backoff retry completes the
            # backfill and the member converges
            for osd in cluster.osds.values():
                osd.osdmap.flags.discard("backfillfull")

            def _member_current():
                osd = cluster.osds.get(victim)
                if osd is None:
                    return False
                return all(osd.store.stat(
                    f"pg_{p.pool}_{p.seed}", f"g{i}") is not None
                    for i in range(12)
                    for p in [client.objecter.object_pgid(
                        pool, f"g{i}")])

            assert await _converge_poll(_member_current, timeout=40.0)
        finally:
            await cluster.stop()

    run_both(scenario)


@contention_retry()
def test_read_repair_heals_generation_stale_shard():
    """A primary shard surgically regressed to an older committed
    generation (bytes/attrs/version self-consistent, crc clean — an
    interrupted recovery's leftover): the read serves the committed
    group's bytes AND the stale detection queues a read-repair that
    brings the shard back to the current generation, no scrub needed
    (the detect-only anchor lives in test_rewind)."""

    async def scenario(P):

        Transaction = P.imp("cluster.store.Transaction")

        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            pool = await client.pool_create("sr", "erasure", pg_num=4,
                                            ec_profile=EC21)
            io = client.ioctx(pool)
            g1 = b"g1-" * 340
            g2 = b"g2-xyz" * 180
            await io.write_full("obj", g1, timeout=120)
            pgid = client.objecter.object_pgid(pool, "obj")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            posd = cluster.osds[primary]
            old_bytes = bytes(posd.store.read(coll, "obj"))
            old_attrs = {k: posd.store.getattr(coll, "obj", k)
                         for k in ("shard", "size", "hinfo_crc")}
            old_ver = posd.store.get_version(coll, "obj")
            await io.write_full("obj", g2, timeout=120)
            txn = (Transaction()
                   .write(coll, "obj", 0, old_bytes)
                   .truncate(coll, "obj", len(old_bytes)))
            for k, v in old_attrs.items():
                txn.setattr(coll, "obj", k, v)
            txn.set_version(coll, "obj", old_ver)
            posd.store.queue_transaction(txn)
            assert await io.read("obj", timeout=60) == g2

            def _healed():
                sa = posd.store.getattr(coll, "obj", "size")
                return sa == str(len(g2)).encode() and \
                    posd.store.get_version(coll, "obj") != old_ver

            assert await _converge_poll(_healed)
            assert sum(o.perf.get("osd_read_repairs")
                       for o in cluster.osds.values()) >= 1
        finally:
            await cluster.stop()

    run_both(scenario)



# -- the cases of tests/test_balance_elastic.py -------------------------------

def test_disabled_balance_subsystem_is_noop():
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()  # mgr_balancer_enabled defaults to 0
        cluster = await start_cluster(4, config=cfg, with_mgr=True)
        try:
            client = await cluster.client()
            pool = await client.pool_create("idle", "replicated",
                                            pg_num=32, size=2)
            io = client.ioctx(pool)
            for i in range(24):
                await io.write_full(f"idle-{i}", b"x" * 512)
            # give any (wrongly) armed background loop time to tick
            await asyncio.sleep(max(
                0.3, cluster.mgr.config.mgr_balancer_interval / 8))
            assert getattr(cluster.mgr, "_balance_task", None) is None
            assert getattr(cluster.mgr, "_autoscale_task", None) is None
            # the counter families exist (scrape contract) and are zero
            for name in ("mgr_balancer_rounds",
                         "mgr_balancer_candidates",
                         "mgr_balancer_moves_proposed",
                         "mgr_balancer_moves_committed",
                         "mgr_autoscale_rounds",
                         "mgr_autoscale_splits"):
                assert cluster.mgr.perf.get(name) == 0, name
            # and the subsystem left no fingerprints on the map
            assert cluster.mon.osdmap.pg_upmap_items == {}
            assert cluster.mgr.reshaper.ops == {}
            status = await cluster.daemon_command("mgr",
                                                  "balance status")
            assert status["enabled"] is False
            assert status["reshape_ops"] == []
        finally:
            await cluster.stop()

    run_both(scenario)


