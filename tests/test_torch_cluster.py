"""The port's OSD cluster against ``ceph_tpu``'s, on the cases of
``tests/test_cluster.py``.

Every case runs one scenario twice: on an in-process cluster of the
reference package (JAX on the CPU) and on one of the port
(``device="cpu"``, the plain versions of kernels B1 and B2), each under
its own ``asyncio.wait_for`` bound of ``BOUND`` seconds.  Each run keeps
its own assertions (those of the reference test), and the two runs must
agree on what does not depend on timing:

- what the scenario returns;
- the set of client reads and stats (pool, object, arguments, a digest
  of the bytes or the exception's type): a converge-poll may repeat a
  read as often as its timing asks;
- the objects the live OSDs' stores hold when the cluster stops, as a set
  of (pool, object, shard, at-rest layout, digest of the stored bytes):
  the EC shards in the layout each store keeps them in, and replicas.

Scenarios whose outcome depends on timing (concurrent writers, a member
bounced mid-write) compare their own results only.  The module also
holds the helpers the other ``tests/test_torch_cluster_*.py`` files use.
"""

import asyncio
import contextlib
import functools
import hashlib
import importlib

import pytest

import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu_torch.utils.lockdep as plockdep
from tests._flaky import contention_retry
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

BOUND = 60.0

# the port's entry points that take ``device`` (CUDA unless named)
DEVICE_TAKERS = {"start_cluster", "OSDDaemon", "RadosClient", "Objecter",
                 "Monitor", "MgrDaemon", "factory"}


class _Mod:
    """A module of one package; for the port, its device-taking entry
    points are bound to ``device="cpu"``."""

    def __init__(self, mod, dev):
        self._mod, self._dev = mod, dev

    def __getattr__(self, name):
        value = getattr(self._mod, name)
        if self._dev and name in DEVICE_TAKERS:
            return functools.partial(value, **self._dev)
        return value


class Pkg:
    def __init__(self, name: str, root: str, dev: dict):
        self.name, self.root, self.dev = name, root, dev

    def imp(self, path: str):
        """``ceph_tpu.<path>`` or ``ceph_tpu_torch.<path>``: a module, or
        an attribute of one (``"cluster.vstart.start_cluster"``)."""
        try:
            return _Mod(importlib.import_module(f"{self.root}.{path}"),
                        self.dev)
        except ModuleNotFoundError:
            mod, _, attr = path.rpartition(".")
            return getattr(self.imp(mod), attr)

    def __repr__(self):
        return self.name


REF = Pkg("ref", "ceph_tpu", {})
PORT = Pkg("port", "ceph_tpu_torch", {"device": "cpu"})


@pytest.fixture(autouse=True)
def _port_lockdep_reset():
    """The port's lock graph is its own process-wide one (the conftest
    resets only the reference's)."""
    plockdep.LockDep.instance().reset()
    plockdep.DepLock._held.clear()
    yield
    plockdep.LockDep.instance().reset()
    plockdep.DepLock._held.clear()
    jlockdep.LockDep.instance().reset()


def digest(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()[:16]


def _key(args, kwargs):
    return (tuple(a if isinstance(a, (int, str)) else repr(a)
                  for a in args),
            tuple(sorted((k, v) for k, v in kwargs.items()
                         if k != "timeout")))


def store_objects(cluster):
    """Every object the live OSDs hold in PG collections, as a sorted
    list of (pool, oid, shard, layout, digest): PG metadata, rollback
    objects and hit sets (which carry times) are left out."""
    seen = set()
    for osd in cluster.osds.values():
        st = osd.store
        for coll in st.list_collections():
            if not coll.startswith("pg_"):
                continue
            pool = int(coll.split("_")[1])
            for oid in st.list_objects(coll):
                if oid.startswith("_pg") or oid.startswith("\x00hitset_"):
                    continue
                shard = st.getattr(coll, oid, "shard")
                layout = st.object_layout(coll, oid)
                try:
                    data = (st.read_planar(coll, oid) if layout == "planar8"
                            else st.read(coll, oid))
                    d = digest(data)
                except (IOError, OSError) as e:
                    d = type(e).__name__
                seen.add((pool, oid,
                          None if shard is None else int(shard), layout, d))
    return sorted(seen, key=repr)


@contextlib.contextmanager
def recording(P: Pkg):
    """Record every client read and stat, and the stores at the first
    ``Cluster.stop`` of each cluster, while a scenario of ``P`` runs."""
    objecter = importlib.import_module(f"{P.root}.cluster.objecter")
    vstart = importlib.import_module(f"{P.root}.cluster.vstart")
    rec = {"reads": [], "stores": []}
    saved = {name: getattr(objecter.IoCtx, name) for name in ("read", "stat")}
    stop = vstart.Cluster.stop

    def wrap(name, orig):
        async def call(self, oid, *args, **kwargs):
            key = (name, self.pool_id, oid) + _key(args, kwargs)
            try:
                out = await orig(self, oid, *args, **kwargs)
            except Exception as e:
                rec["reads"].append(key + (type(e).__name__,))
                raise
            rec["reads"].append(key + (
                digest(out) if isinstance(out, (bytes, bytearray))
                else repr(out),))
            return out
        return call

    async def stopping(self):
        if not getattr(self, "_recorded", False):
            self._recorded = True
            rec["stores"].append(store_objects(self))
        return await stop(self)

    for name, orig in saved.items():
        setattr(objecter.IoCtx, name, wrap(name, orig))
    vstart.Cluster.stop = stopping
    try:
        yield rec
    finally:
        for name, orig in saved.items():
            setattr(objecter.IoCtx, name, orig)
        vstart.Cluster.stop = stop


def run_one(scenario, P: Pkg, bound: float = BOUND):
    with recording(P) as rec:
        out = asyncio.run(asyncio.wait_for(scenario(P), timeout=bound))
    return out, rec


def run_both(scenario, reads: bool = True, stores: bool = True,
             bound: float = BOUND):
    """``scenario(P)`` on the reference, then on the port, each under its
    own ``bound``; the two must return the same result and, unless the
    caller says the scenario depends on timing, read the same bytes and
    leave the same objects in the stores.  Returns the port's result."""
    ref, ref_rec = run_one(scenario, REF, bound)
    got, got_rec = run_one(scenario, PORT, bound)
    assert got == ref
    if reads:
        assert sorted(set(got_rec["reads"]), key=repr) == \
            sorted(set(ref_rec["reads"]), key=repr)
    if stores:
        assert got_rec["stores"] == ref_rec["stores"]
    return got


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


# -- the cases of tests/test_cluster.py ---------------------------------------

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}

def test_replicated_put_get_delete():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            payload = b"replicated-payload" * 100
            await io.write_full("obj1", payload)
            assert await io.read("obj1") == payload
            assert await io.stat("obj1") == len(payload)
            # overwrite
            await io.write_full("obj1", b"short")
            assert await io.read("obj1") == b"short"
            await io.remove("obj1")
            with pytest.raises(FileNotFoundError):
                await io.read("obj1")
            # data must exist on every acting replica, not just the
            # primary (converge-poll to a wall deadline: ack precedes
            # the last store applies only by scheduler noise, but a
            # fixed beat flaked under host load)
            pgid = client.objecter.object_pgid(pool, "obj2")
            await io.write_full("obj2", b"fanout")
            _, _, acting, _ = client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            coll = f"pg_{pgid.pool}_{pgid.seed}"

            def _holders():
                return [o for o in acting
                        if cluster.osds[o].store.stat(coll, "obj2")
                        is not None]

            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline and \
                    _holders() != list(acting):
                await asyncio.sleep(0.05)
            assert _holders() == list(acting), \
                f"replicas missing: {_holders()} vs acting {acting}"
        finally:
            await cluster.stop()

    run_both(scenario)

def test_ec_put_get():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ecpool", "erasure", pg_num=8,
                                            ec_profile=EC_PROFILE)
            io = client.ioctx(pool)
            payload = bytes(range(256)) * 64
            await io.write_full("ecobj", payload)
            assert await io.read("ecobj") == payload
            assert await io.stat("ecobj") == len(payload)
            # each acting OSD holds exactly one shard, not the full object
            pgid = client.objecter.object_pgid(pool, "ecobj")
            _, _, acting, _ = client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            CRUSH_ITEM_NONE = P.imp("crush.types.CRUSH_ITEM_NONE")
            for shard, osd in enumerate(acting):
                if osd == CRUSH_ITEM_NONE:
                    continue
                size = cluster.osds[osd].store.stat(coll, "ecobj")
                assert size is not None and size < len(payload)
                attr = cluster.osds[osd].store.getattr(coll, "ecobj", "shard")
                assert int(attr) == shard
        finally:
            await cluster.stop()

    run_both(scenario)

def test_ec_read_with_dead_shard():
    """Kill an OSD; reads must reconstruct the lost shard from survivors
    (the decode path under failure)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ecpool", "erasure", pg_num=8,
                                            ec_profile=EC_PROFILE)
            io = client.ioctx(pool)
            objects = {f"obj{i}": bytes([i]) * (1000 + i) for i in range(8)}
            for oid, data in objects.items():
                await io.write_full(oid, data)
            victim = 2
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            # misdirected ops resend against the refreshed map; reads on PGs
            # that lost a shard decode from the k survivors
            for oid, data in objects.items():
                assert await io.read(oid) == data, oid
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_failure_detection_marks_down():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            victim = 1
            assert cluster.mon.osdmap.osd_up[victim]
            await cluster.kill_osd(victim)
            # peers' heartbeats stop acking -> MOSDFailure -> mon marks down
            await cluster.wait_down(victim)
            assert not cluster.mon.osdmap.osd_up[victim]
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_down_out_rebalance_and_recovery():
    """Down OSD is auto-outed by the mon tick; replicated PGs remap and the
    new acting set is backfilled by primary-driven recovery."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(4, osds_per_host=1)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            objects = {f"o{i}": bytes([i]) * 500 for i in range(12)}
            for oid, data in objects.items():
                await io.write_full(oid, data)
            victim = 0
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            # wait for auto-out (mon_osd_down_out_interval=2s) + remap
            deadline = asyncio.get_event_loop().time() + 15
            while asyncio.get_event_loop().time() < deadline:
                if cluster.mon.osdmap.osd_weight[victim] == 0:
                    break
                await asyncio.sleep(0.1)
            assert cluster.mon.osdmap.osd_weight[victim] == 0, "never auto-outed"
            # converge-poll instead of a fixed recovery-window sleep
            # (the invariant stays strict, only
            # the wall clock is relaxed): wait until the client's map
            # has remapped every PG off the victim
            PGid = P.imp("osdmap.osdmap.PGid")

            def _remapped():
                m = client.objecter.osdmap
                return all(
                    victim not in m.pg_to_up_acting_osds(
                        PGid(pool, seed))[2]
                    for seed in range(8))

            deadline = asyncio.get_event_loop().time() + 20
            while asyncio.get_event_loop().time() < deadline \
                    and not _remapped():
                await asyncio.sleep(0.1)
            assert _remapped(), "PGs never remapped off the out OSD"
            # every object still readable; every PG's acting set avoids victim
            for oid, data in objects.items():
                assert await io.read(oid) == data, oid
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_ec_recovery_rebuilds_lost_shards():
    """Kill an OSD holding shards, revive it empty: primary-driven EC
    recovery re-encodes and pushes the missing shard back
    (ECBackend::run_recovery_op analog)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ecpool", "erasure", pg_num=4,
                                            ec_profile=EC_PROFILE)
            io = client.ioctx(pool)
            objects = {f"e{i}": bytes([i + 1]) * 900 for i in range(6)}
            for oid, data in objects.items():
                await io.write_full(oid, data)
            victim = 1
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            # revive with an EMPTY store: boot -> map -> recovery repushes
            await cluster.revive_osd(victim)
            deadline = asyncio.get_event_loop().time() + 15
            revived = cluster.osds[victim]

            def victim_shard_count():
                n = 0
                for seed in range(4):
                    coll = f"pg_{pool}_{seed}"
                    n += len(revived.store.list_objects(coll))
                return n

            # count how many shards the victim *should* hold
            while asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.2)
                if victim_shard_count() >= 1:
                    break
            assert victim_shard_count() >= 1, "no shards recovered to revived OSD"
            for oid, data in objects.items():
                assert await io.read(oid) == data, oid
        finally:
            await cluster.stop()

    # the rebuild may still be landing on the revived member when the
    # cluster stops: only the reads are compared
    run_both(scenario, stores=False)

def test_mon_status_and_perf_dump():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            status = await client.status()
            assert status["num_osds"] == 3
            assert status["num_up"] == 3
            perf = await client.objecter.mon_command({"prefix": "perf dump"})
            assert perf["mon"]["mon_osd_boot"] >= 3
            with pytest.raises(RuntimeError):
                await client.objecter.mon_command({"prefix": "bogus"})
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_client_misdirect_resend():
    """Write through a client whose map predates a pool's remap: the OSD
    replies -EAGAIN-style misdirect and the client refreshes + resends."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("mis", b"first")
            # stale-map simulation: client keeps targeting with an old map
            # while the cluster loses an OSD
            victim = 0
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            # converge-poll: wait until every
            # SURVIVING OSD's map marks the victim down — the remapped
            # primary must know it owns the PG before the stale client
            # retargets, and on a loaded host that propagation can
            # outlive any fixed sleep
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 10.0
            while loop.time() < deadline and any(
                    o.osdmap is None or o.osdmap.is_up(victim)
                    for oid, o in cluster.osds.items() if oid != victim):
                await asyncio.sleep(0.05)
            # ops keep succeeding despite the stale cached map (resend loop)
            await io.write_full("mis", b"second")
            assert await io.read("mis") == b"second"
        finally:
            await cluster.stop()

    run_both(scenario)

def test_ec_partial_write_rmw():
    """Overwrite a sub-range of an EC object: read-modify-write over stripe
    bounds (reference ECBackend::start_rmw, ECBackend.cc:1785)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            profile = dict(EC_PROFILE, stripe_unit="64")
            pool = await client.pool_create("ecpool", "erasure", pg_num=4,
                                            ec_profile=profile)
            io = client.ioctx(pool)
            base = bytes(range(256)) * 4  # 1024 bytes = 8 stripes of 128
            await io.write_full("rmw", base)
            # unaligned overwrite inside one stripe
            patch = b"X" * 50
            await io.write("rmw", patch, offset=200)
            expect = bytearray(base)
            expect[200:250] = patch
            assert await io.read("rmw") == bytes(expect)
            # overwrite spanning stripe boundaries
            patch2 = b"Y" * 300
            await io.write("rmw", patch2, offset=100)
            expect[100:400] = patch2
            assert await io.read("rmw") == bytes(expect)
            # appending extension past the old end
            tail = b"Z" * 77
            await io.write("rmw", tail, offset=len(expect) + 31)
            expect_full = bytes(expect) + b"\0" * 31 + tail
            assert await io.read("rmw") == expect_full
            assert await io.stat("rmw") == len(expect_full)
            # range reads
            assert await io.read("rmw", offset=150, length=100) == \
                expect_full[150:250]
            assert await io.read("rmw", offset=1000) == expect_full[1000:]
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_ec_rmw_survives_shard_loss():
    """RMW then kill an OSD: the modified object decodes correctly from the
    survivors (stripe-consistent shards)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            profile = dict(EC_PROFILE, stripe_unit="64")
            pool = await client.pool_create("ecpool", "erasure", pg_num=4,
                                            ec_profile=profile)
            io = client.ioctx(pool)
            base = b"A" * 640
            await io.write_full("obj", base)
            await io.write("obj", b"B" * 128, offset=256)
            expect = b"A" * 256 + b"B" * 128 + b"A" * 256
            victim = 0
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            assert await io.read("obj") == expect
        finally:
            await cluster.stop()

    run_both(scenario)

def test_replicated_partial_write():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=4, size=2)
            io = client.ioctx(pool)
            await io.write_full("p", b"0123456789")
            await io.write("p", b"AB", offset=3)
            assert await io.read("p") == b"012AB56789"
            assert await io.read("p", offset=2, length=4) == b"2AB5"
        finally:
            await cluster.stop()

    run_both(scenario)

def test_map_distribution_is_incremental():
    """After the initial full map, epoch churn ships deltas: the number of
    full maps sent stays bounded by subscriber joins, not by epochs."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            for i in range(4):
                await client.pool_create(f"p{i}", "replicated", pg_num=4,
                                         size=2)
            perf = cluster.mon.perf.dump()["mon"]
            # 3 OSD subscribes + 1 client subscribe = at most a handful of
            # full maps; the pool-create broadcasts must all be incremental
            assert perf.get("mon_inc_maps_sent", 0) >= 8, perf
            assert perf.get("mon_full_maps_sent", 0) <= 6, perf
            # clients converge on the same epoch as the mon
            await client.objecter._refresh_map()
            assert client.objecter.osdmap.epoch == cluster.mon.osdmap.epoch
        finally:
            await cluster.stop()

    run_both(scenario)

def test_delta_recovery_counts():
    async def scenario(P):
        OSDDaemon = P.imp("cluster.osd.OSDDaemon")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        _fast_config = P.imp("cluster.vstart._fast_config")

        cfg = _fast_config()
        cfg.mon_osd_down_out_interval = 60.0
        cluster = await start_cluster(4, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            total = 24
            for i in range(total):
                await io.write_full(f"obj{i}", f"payload-{i}".encode() * 50)

            target = 1
            # stop the daemon but KEEP its store for the restart
            stopped = cluster.osds.pop(target)
            store = stopped.store
            await stopped.stop()
            await cluster.wait_down(target)

            delta = {f"new{i}": f"delta-{i}".encode() * 80 for i in range(3)}
            for oid, data in delta.items():
                await io.write_full(oid, data)
            await io.write_full("obj0", b"obj0-rewritten" * 40)

            before = sum(o.perf.get("osd_pushes_sent") or 0
                         for o in cluster.osds.values())
            osd = OSDDaemon(target, cluster.mon_addr, config=cfg, store=store)
            await osd.start()
            cluster.osds[target] = osd
            # wait for the mon to mark it up + peers to recover it
            deadline = asyncio.get_event_loop().time() + 15
            while asyncio.get_event_loop().time() < deadline:
                if cluster.mon.osdmap.osd_up[target]:
                    break
                await asyncio.sleep(0.05)

            # converge-poll instead of a fixed recovery-window sleep
            #: wait until the rejoined member
            # actually holds every delta byte it is acting for — the
            # strict invariant — with a generous wall deadline
            def _member_oids():
                out = []
                for oid, data in delta.items():
                    pgid = client.objecter.object_pgid(pool, oid)
                    _, _, acting, _ = \
                        client.objecter.osdmap.pg_to_up_acting_osds(pgid)
                    if target in acting:
                        out.append((f"pg_{pgid.pool}_{pgid.seed}",
                                    oid, data))
                return out

            def _caught_up():
                try:
                    return all(osd.store.read(coll, oid) == data
                               for coll, oid, data in _member_oids())
                except FileNotFoundError:
                    return False  # push not applied yet

            def _pushes():
                after = sum(o.perf.get("osd_pushes_sent") or 0
                            for o in cluster.osds.values()
                            if o is not osd)
                return after - before

            # recovery must have actually pushed something AND the
            # member must hold the delta bytes (pushes>0 guards the
            # vacuous case where no delta object maps to the member)
            deadline = asyncio.get_event_loop().time() + 20
            while asyncio.get_event_loop().time() < deadline and \
                    not (_caught_up() and _pushes() > 0):
                await asyncio.sleep(0.1)
            assert _caught_up(), "rejoined member never caught up"

            pushes = _pushes()
            changed = len(delta) + 1  # new0..2 + obj0 rewrite
            # delta resync: push count tracks the CHANGED objects, far
            # below the total object count.  Upper bound allows seeded
            # recovery-round retries under host load (each retry may
            # re-push); the strict discriminator is pushes < total
            assert 0 < pushes <= changed * 6, (pushes, changed)
            assert pushes < total, (pushes, total)
        finally:
            await cluster.stop()

    # the rejoined member may still hold a pre-bounce copy of obj0 when
    # the cluster stops: only the reads are compared
    run_both(scenario, stores=False)

@contention_retry()
def test_concurrent_writes_during_restart_converge():
    """Concurrent writers + a member bounce: every acting replica ends
    byte-identical (per-PG ordering + log-delta resync)."""
    async def scenario(P):
        OSDDaemon = P.imp("cluster.osd.OSDDaemon")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        _fast_config = P.imp("cluster.vstart._fast_config")

        cfg = _fast_config()
        cfg.mon_osd_down_out_interval = 60.0
        cluster = await start_cluster(4, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("repl", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            stop_evt = asyncio.Event()

            done = [0]      # completed write rounds across both writers

            async def writer(tag):
                i = 0
                while not stop_evt.is_set():
                    for oid in ("shared-a", "shared-b"):
                        try:
                            await io.write_full(
                                oid, f"{tag}-{i}-".encode() * 100)
                            done[0] += 1
                        except Exception:
                            pass
                    i += 1
                    await asyncio.sleep(0.01)

            async def _writes_past(mark, n, timeout=15.0):
                # converge on OBSERVED write progress instead of fixed
                # beats: the scenario needs writes to really land in
                # each phase (down / recovering), and a timed window
                # under host load sometimes contained none
                deadline = asyncio.get_event_loop().time() + timeout
                while asyncio.get_event_loop().time() < deadline and \
                        done[0] < mark + n:
                    await asyncio.sleep(0.05)
                return done[0]

            writers = [asyncio.get_event_loop().create_task(writer(t))
                       for t in ("w1", "w2")]
            await _writes_past(0, 4)
            target = 2
            stopped = cluster.osds.pop(target)
            store = stopped.store
            await stopped.stop()
            await cluster.wait_down(target)
            mark = done[0]
            await _writes_past(mark, 4)   # writes flow while down
            osd = OSDDaemon(target, cluster.mon_addr, config=cfg, store=store)
            await osd.start()
            cluster.osds[target] = osd
            deadline = asyncio.get_event_loop().time() + 15
            while asyncio.get_event_loop().time() < deadline:
                if cluster.mon.osdmap.osd_up[target]:
                    break
                await asyncio.sleep(0.05)
            mark = done[0]
            await _writes_past(mark, 4)   # writes overlap the resync
            stop_evt.set()
            await asyncio.gather(*writers)

            # converge-poll instead of a fixed recovery-window sleep
            #: replicas must END byte-identical
            # — strict — but recovery gets a generous wall deadline
            def _replica_sets():
                out = {}
                for oid in ("shared-a", "shared-b"):
                    pgid = client.objecter.object_pgid(pool, oid)
                    coll = f"pg_{pgid.pool}_{pgid.seed}"
                    _, _, acting, _ = \
                        client.objecter.osdmap.pg_to_up_acting_osds(pgid)
                    out[oid] = {o: bytes(
                        cluster.osds[o].store.read(coll, oid))
                        for o in acting}
                return out

            deadline = asyncio.get_event_loop().time() + 20
            while asyncio.get_event_loop().time() < deadline:
                if all(len(set(blobs.values())) == 1
                       for blobs in _replica_sets().values()):
                    break
                await asyncio.sleep(0.2)
            for oid, blobs in _replica_sets().items():
                assert len(set(blobs.values())) == 1, \
                    (oid, {k: v[:20] for k, v in blobs.items()})
        finally:
            await cluster.stop()

    # the writers race the bounce: what each package's replicas converge
    # on depends on timing, so each run holds only its own invariant
    run_both(scenario, reads=False, stores=False)


# -- the placements an in-process cluster shares -------------------------------


def test_shared_placements_equal_fresh_ones_and_follow_their_inputs():
    """Copies of a map that share a ``PlacementCache`` get from
    ``pool_raw_up`` what a fresh placement of each copy returns, computed
    once per distinct input: a weight, an OSD's existence or an upmap
    entry of the pool changes the key; a down mark and another pool's
    new rule do not (raw placement is down-blind, and a rule places only
    its own pools).  A copy without the cache, a pickled one included,
    computes afresh."""
    import copy
    import pickle

    import numpy as np

    from ceph_tpu_torch.cluster.vstart import PlacementCache
    from ceph_tpu_torch.osdmap.osdmap import PGid, build_simple_osdmap

    base = build_simple_osdmap(16, 4, 64, device="cpu")
    src = int(base.pool_raw_up(1)[5][0])
    fresh = {}

    def variants():
        m = copy.deepcopy(base)
        yield "base", m
        m = copy.deepcopy(base)
        m.osd_up[3] = False
        yield "down", m
        m = copy.deepcopy(base)
        m.crush.rules.append(copy.deepcopy(m.crush.rules[0]))
        yield "rule", m
        m = copy.deepcopy(base)
        m.osd_weight[3] = 0
        yield "out", m
        m = copy.deepcopy(base)
        m.pg_upmap_items[PGid(1, 5)] = [(src, 15)]
        yield "upmap", m

    for name, m in variants():
        fresh[name] = m.pool_raw_up(1)
    cache = PlacementCache()
    for _ in range(2):
        for name, m in variants():
            m.set_device("cpu", cache)
            assert np.array_equal(m.pool_raw_up(1), fresh[name]), name
    # base, down and rule share a key: three placements computed, seven
    # answered from the cache
    assert (cache.misses, cache.hits) == (3, 7)
    base.set_device("cpu", cache)
    got = base.pool_raw_up(1)
    got[:] = -7                  # a caller's copy, not the cache's
    assert np.array_equal(base.pool_raw_up(1), fresh["base"])
    assert cache.hits == 9
    for m in (pickle.loads(pickle.dumps(base)), base.set_device("cpu")):
        assert m.placements is None
        assert np.array_equal(m.pool_raw_up(1), fresh["base"])
    assert (cache.misses, cache.hits) == (3, 9)


def test_a_cluster_holds_the_shared_placements_while_it_runs():
    """``start_cluster`` hands its daemons one ``PlacementCache``: the
    OSDs that map a new pool compute it once and share it."""

    async def scenario():
        cfg = PORT.imp("cluster.vstart._fast_config")()
        cfg.osd_map_batch_min_pgs = 1
        cluster = await PORT.imp("cluster.vstart.start_cluster")(
            6, config=cfg)
        try:
            cache = cluster.placements
            assert all(d.placements is cache and
                       d.osdmap.placements is cache
                       for d in list(cluster.osds.values()) + cluster.mons)
            hits = cache.hits
            client = await cluster.client()
            pool = await client.pool_create("p", "replicated", pg_num=16,
                                            size=3)
            await client.ioctx(pool).write_full("o", b"z" * 100)
            # six OSDs map the new pool: one computes, the others share
            assert cache.hits - hits >= 5
            assert all(o.osdmap.placements is cache
                       for o in cluster.osds.values())
        finally:
            await cluster.stop()

    run(scenario())
