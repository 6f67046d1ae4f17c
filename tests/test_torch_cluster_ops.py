"""The port's OSD cluster against ``ceph_tpu``'s on the op breadth and
snapshots: the cases of ``tests/test_cluster_ops.py`` (xattrs, omap,
object classes, watch/notify, copy-from) and ``tests/test_snaps.py``
(pool and self-managed snapshots, clones, trimming), each run on both
packages through ``tests/test_torch_cluster.run_both``; the ``SnapSet``
unit cases run both packages' classes and compare their state.
"""

import asyncio
import pickle

import pytest

from tests._flaky import contention_retry
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, PORT, REF, _port_lockdep_reset, run_both)


# -- the cases of tests/test_cluster_ops.py ---------------------------------

def test_xattr_roundtrip_and_replication():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("xp", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            await io.write_full("obj", b"payload")
            await io.setxattr("obj", "user.k1", b"v1")
            await io.setxattr("obj", "user.k2", b"v2")
            assert await io.getxattr("obj", "user.k1") == b"v1"
            assert await io.getxattrs("obj") == {
                "user.k1": b"v1", "user.k2": b"v2"}
            await io.rmxattr("obj", "user.k1")
            with pytest.raises(KeyError):
                await io.getxattr("obj", "user.k1")
            # replicated to every acting member's store (with the "_"
            # user-attr prefix)
            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, _ = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)

            # converge-poll: replica applies land asynchronously after
            # the ack — wait for the state, not a guessed duration
            def _replicated() -> bool:
                for o in acting:
                    xs = cluster.osds[o].store.get_xattrs(
                        f"pg_{pgid.pool}_{pgid.seed}", "obj")
                    if xs.get("_user.k2") != b"v2" or "_user.k1" in xs:
                        return False
                return True

            deadline = asyncio.get_event_loop().time() + 10.0
            while not _replicated() and \
                    asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.02)
            for o in acting:
                xs = cluster.osds[o].store.get_xattrs(
                    f"pg_{pgid.pool}_{pgid.seed}", "obj")
                assert xs.get("_user.k2") == b"v2", o
                assert "_user.k1" not in xs, o
            # missing object
            with pytest.raises(IOError):
                await io.getxattrs("nope")
        finally:
            await cluster.stop()

    run_both(scenario)

def test_omap_roundtrip():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("op", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"x")
            await io.omap_set("obj", {"a": b"1", "b": b"2", "c": b"3"})
            assert await io.omap_get("obj") == {
                "a": b"1", "b": b"2", "c": b"3"}
            await io.omap_rmkeys("obj", ["b"])
            assert await io.omap_get("obj") == {"a": b"1", "c": b"3"}
        finally:
            await cluster.stop()

    run_both(scenario)

def test_object_class_exec():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("cp", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"x")
            # cls_hello analog
            out = await io.execute("obj", "hello", "say_hello", b"ceph")
            assert out == b"Hello, ceph!"
            # cls_lock analog: exclusive lock semantics
            req = pickle.dumps({"name": "l1", "cookie": "c1"})
            await io.execute("obj", "lock", "lock", req)
            other = pickle.dumps({"name": "l1", "cookie": "c2"})
            with pytest.raises(IOError):
                await io.execute("obj", "lock", "lock", other)
            await io.execute("obj", "lock", "unlock", req)
            await io.execute("obj", "lock", "lock", other)  # now free
            # unknown class fails loudly
            with pytest.raises(IOError):
                await io.execute("obj", "nosuch", "m", b"")
        finally:
            await cluster.stop()

    run_both(scenario)

def test_watch_notify():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            watcher = await cluster.client("watcher")
            pool = await client.pool_create("wp", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            wio = watcher.ioctx(pool)
            await io.write_full("obj", b"x")

            got = []
            cookie = await wio.watch("obj", lambda payload:
                                     got.append(payload))
            ackers = await io.notify("obj", b"ping-1")
            assert got == [b"ping-1"]
            assert len(ackers) == 1

            # second notify, then unwatch stops delivery
            await io.notify("obj", b"ping-2")
            assert got == [b"ping-1", b"ping-2"]
            await wio.unwatch("obj", cookie)
            ackers = await io.notify("obj", b"ping-3")
            assert ackers == []
            assert got == [b"ping-1", b"ping-2"]
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_extended_osd_verbs_replicated_and_ec():
    """Widening of the do_osd_ops interpreter: append, truncate,
    zero, exclusive create, cmpxattr (reference PrimaryLogPG.cc:4917
    cases) on BOTH pool types."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pools = []
            pools.append(await client.pool_create(
                "verbs_r", "replicated", pg_num=8, size=2))
            pools.append(await client.pool_create(
                "verbs_e", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"}))
            for pool in pools:
                io = client.ioctx(pool)
                # append: atomic, returns the landing offset
                off0 = await io.append("log", b"one")
                off1 = await io.append("log", b"two")
                assert (off0, off1) == (0, 3)
                assert await io.read("log") == b"onetwo"
                # truncate shrink + grow (zero-extended)
                await io.write_full("t", b"0123456789" * 40)
                await io.truncate("t", 5)
                assert await io.read("t") == b"01234"
                await io.truncate("t", 8)
                assert await io.read("t") == b"01234\0\0\0"
                # zero a range
                await io.write_full("z", b"Z" * 64)
                await io.zero("z", 8, 16)
                got = await io.read("z")
                assert got[8:24] == b"\0" * 16 and got[:8] == b"Z" * 8
                # exclusive create
                await io.create("fresh")
                with __import__("pytest").raises(FileExistsError):
                    await io.create("fresh")
                # cmpxattr guard
                await io.setxattr("fresh", "tag", b"v1")
                assert await io.cmpxattr("fresh", "tag", b"v1")
                assert not await io.cmpxattr("fresh", "tag", b"v2")
        finally:
            await cluster.stop()

    run_both(scenario)

def test_compound_op_vector_gates_on_first_error():
    """ADVICE r4: the op vector must stop at the FIRST failing op (the
    reference do_osd_ops `while (!bp.end() && !result)`) and return one
    terminal reply — a cmpxattr mismatch really gates the writes behind
    it."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2)
        try:
            client = await cluster.client()
            pool = await client.pool_create("gate", "replicated",
                                            pg_num=4, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"original")
            await io.setxattr("obj", "user.state", b"ready")
            # matching gate: the write lands
            r = await client.objecter.op_submit(pool, "obj", [
                ("cmpxattr", {"name": "user.state", "value": b"ready"}),
                ("write_full", {"data": b"updated"})])
            assert r.result == 0
            assert await io.read("obj") == b"updated"
            # mismatching gate: -ECANCELED and the write must NOT land
            r = await client.objecter.op_submit(pool, "obj", [
                ("cmpxattr", {"name": "user.state", "value": b"WRONG"}),
                ("write_full", {"data": b"MUST-NOT-LAND"})])
            assert r.result == -125
            assert await io.read("obj") == b"updated"
        finally:
            await cluster.stop()

    run_both(scenario)

def test_mutation_never_lands_before_failing_guard():
    """Reference atomicity approximation: a mutation placed BEFORE a
    failing guard in the vector must not land (guards run first)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2)
        try:
            client = await cluster.client()
            pool = await client.pool_create("gate2", "replicated",
                                            pg_num=4, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"original")
            r = await client.objecter.op_submit(pool, "obj", [
                ("write_full", {"data": b"MUST-NOT-LAND"}),
                ("cmpxattr", {"name": "user.absent", "value": b"x"})])
            assert r.result == -125
            assert await io.read("obj") == b"original"
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_copy_from_cross_pool_and_rollback():
    """Server-side copy_from (replicated ->
    EC and back, with xattrs/omap) and head rollback-to-snap with the
    snapshot state intact (reference PrimaryLogPG.cc:3113 COPY_FROM and
    _rollback_to)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            rp = await client.pool_create("cp_rep", "replicated",
                                          pg_num=4, size=2)
            ep = await client.pool_create(
                "cp_ec", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            rio, eio = client.ioctx(rp), client.ioctx(ep)
            # warm the EC codec compile before timed internal ops
            await eio.write_full("warm", b"w" * 4096)
            payload = bytes(range(256)) * 40
            await rio.write_full("src", payload)
            await rio.setxattr("src", "user.tag", b"orig")
            await rio.omap_set("src", {"k1": b"v1"})
            # replicated -> EC, different object name
            n = await eio.copy_from("dst", "src", src_pool=rp)
            assert n == len(payload)
            assert await eio.read("dst") == payload
            assert await eio.getxattr("dst", "user.tag") == b"orig"
            assert (await eio.omap_get("dst"))["k1"] == b"v1"
            # EC -> replicated round trip
            await rio.copy_from("back", "dst", src_pool=ep)
            assert await rio.read("back") == payload

            # copy onto an EXISTING dst replaces wholesale: stale dst
            # metadata absent from the source must vanish
            await eio.setxattr("dst", "user.stale", b"gone")
            await eio.omap_set("dst", {"stale_k": b"gone"})
            await eio.copy_from("dst", "src", src_pool=rp)
            with pytest.raises(KeyError):
                await eio.getxattr("dst", "user.stale")
            assert "stale_k" not in await eio.omap_get("dst")

            # rollback: snapshot, overwrite, roll back
            await rio.snap_create("keep")
            sid = next(s for s, nme in
                       client.objecter.osdmap.pools[rp].snaps.items()
                       if nme == "keep")
            await rio.write_full("src", b"overwritten")
            await rio.setxattr("src", "user.tag", b"new")
            await rio.setxattr("src", "user.post", b"added-after-snap")
            await rio.omap_set("src", {"k_post": b"after"})
            assert await rio.read("src") == b"overwritten"
            await rio.rollback("src", sid)
            assert await rio.read("src") == payload
            assert await rio.getxattr("src", "user.tag") == b"orig"
            # keys created AFTER the snapshot are gone (wholesale restore)
            with pytest.raises(KeyError):
                await rio.getxattr("src", "user.post")
            assert "k_post" not in await rio.omap_get("src")
            # the snapshot itself still reads the original
            assert await rio.read("src", snapid=sid) == payload
            # copy_from a snapshot source
            await eio.copy_from("from_snap", "src", src_pool=rp,
                                src_snapid=sid)
            assert await eio.read("from_snap") == payload
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the cases of tests/test_snaps.py ---------------------------------------

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}

def test_snapset_clone_decision_and_resolution():
    def case(P):
        SnapContext = P.imp("cluster.snaps.SnapContext")
        SnapSet = P.imp("cluster.snaps.SnapSet")
        ss = SnapSet()
        # snap 1 exists, object written under seq=1 -> clone of pre-write head
        snapc = SnapContext(seq=1, snaps=(1,))
        assert ss.needs_clone(snapc, head_exists=True)
        cid = ss.add_clone(snapc, head_size=10)
        assert cid == 1 and ss.seq == 1
        # snap 1 reads the clone; snap 2 (taken later, no writes) the head
        assert ss.resolve_read(1, head_exists=True) == ("clone", 1)
        assert ss.resolve_read(2, head_exists=True) == ("head", None)
        assert ss.resolve_read(None, head_exists=True) == ("head", None)
        # head deleted: snap 1 still resolves, HEAD/2 do not
        assert ss.resolve_read(1, head_exists=False) == ("clone", 1)
        assert ss.resolve_read(2, head_exists=False) == ("enoent", None)
        assert ss.resolve_read(None, head_exists=False) == ("enoent", None)
        return repr(vars(ss))

    assert case(PORT) == case(REF)


def test_snapset_trim():
    def case(P):
        SnapContext = P.imp("cluster.snaps.SnapContext")
        SnapSet = P.imp("cluster.snaps.SnapSet")
        ss = SnapSet()
        ss.add_clone(SnapContext(seq=1, snaps=(1,)), 10)
        ss.add_clone(SnapContext(seq=3, snaps=(3, 2, 1)), 20)
        v = ss.version
        assert v >= 2                        # every mutation stamps a version
        dead, dirty = ss.trim({2})
        assert dirty and dead == []          # clone 3 still serves snap 3
        assert ss.version > v                # trims must bump it too (the
        v = ss.version                       # backfill gate keys off it)
        dead, dirty = ss.trim({1})
        assert dead == [1]                   # clone 1 served only snap 1
        dead, dirty = ss.trim({3})
        assert dead == [3]
        assert ss.clones == []
        assert ss.version > v
        return repr(vars(ss))

    assert case(PORT) == case(REF)


def test_snap_key_naming():
    for P in (REF, PORT):
        clone_oid = P.imp("cluster.snaps.clone_oid")
        is_snap_key = P.imp("cluster.snaps.is_snap_key")
        assert is_snap_key(clone_oid("obj", 5))
        assert not is_snap_key("obj")
        assert not is_snap_key("obj@5")      # client oids with @ are fine
    assert PORT.imp("cluster.snaps.clone_oid")("obj", 5) == \
        REF.imp("cluster.snaps.clone_oid")("obj", 5)

def test_pool_snap_write_snap_overwrite_read_back_replicated():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rsnap", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            v1 = b"version-one" * 50
            v2 = b"VERSION-TWO!" * 77
            await io.write_full("obj", v1)
            sid = await io.snap_create("s1")
            await io.write_full("obj", v2)
            assert await io.read("obj") == v2
            assert await io.read("obj", snapid=sid) == v1
            # a second snap with no intervening write sees the head data
            sid2 = await io.snap_create("s2")
            assert await io.read("obj", snapid=sid2) == v2
            # snap_list + lookup
            assert io.snap_lookup("s1") == sid
            assert set(io.snap_list().values()) == {"s1", "s2"}
            # clones never leak into listings
            assert await io.list_objects() == ["obj"]
        finally:
            await cluster.stop()

    run_both(scenario)

def test_selfmanaged_snap_ec_pool_byte_exact():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ecsnap", "erasure",
                                            pg_num=8,
                                            ec_profile=dict(EC_PROFILE))
            io = client.ioctx(pool)
            v1 = bytes(range(256)) * 40          # 10240 bytes
            v2 = bytes(reversed(range(256))) * 60
            await io.write_full("eobj", v1)
            sid = await io.selfmanaged_snap_create()
            io.set_snap_context(sid, [sid])
            await io.write_full("eobj", v2)
            assert await io.read("eobj") == v2
            assert await io.read("eobj", snapid=sid) == v1
            # partial overwrite (RMW path) after a second snap
            sid2 = await io.selfmanaged_snap_create()
            io.set_snap_context(sid2, [sid2, sid])
            await io.write("eobj", b"X" * 1000, offset=500)
            at2 = await io.read("eobj", snapid=sid2)
            assert at2 == v2
            head = await io.read("eobj")
            assert head[500:1500] == b"X" * 1000
            assert head[:500] == v2[:500]
            assert await io.read("eobj", snapid=sid) == v1
        finally:
            await cluster.stop()

    run_both(scenario)

def test_delete_after_snap_keeps_snap_readable():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("dsnap", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            payload = b"preserve-me" * 30
            await io.write_full("victim", payload)
            sid = await io.snap_create("keep")
            await io.remove("victim")
            with pytest.raises(FileNotFoundError):
                await io.read("victim")
            assert await io.read("victim", snapid=sid) == payload
            with pytest.raises(FileNotFoundError):
                await io.stat("victim")
            assert await io.stat("victim", snapid=sid) == len(payload)
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_snap_trim_removes_clone_objects():
    async def scenario(P):
        clone_oid = P.imp("cluster.snaps.clone_oid")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("tsnap", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("obj", b"old")
            sid = await io.snap_create("s1")
            await io.write_full("obj", b"new")
            assert await io.read("obj", snapid=sid) == b"old"
            pgid = client.objecter.object_pgid(pool, "obj")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            cname = clone_oid("obj", sid)
            _, _, acting, _ = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            assert all(cluster.osds[o].store.stat(coll, cname) is not None
                       for o in acting), "clone object missing pre-trim"
            await io.snap_remove("s1")
            # trimmer runs off the map-update path on every member
            for _ in range(100):
                if all(cluster.osds[o].store.stat(coll, cname) is None
                       for o in acting):
                    break
                await asyncio.sleep(0.1)
            assert all(cluster.osds[o].store.stat(coll, cname) is None
                       for o in acting), "trim left clone objects behind"
            with pytest.raises(FileNotFoundError):
                await io.read("obj", snapid=sid)
            assert await io.read("obj") == b"new"
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_ec_snap_survives_shard_loss():
    """Snap reads ride the same decode path as head reads: kill one OSD
    and the clone must still reconstruct."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ecs2", "erasure",
                                            pg_num=4,
                                            ec_profile=dict(EC_PROFILE))
            io = client.ioctx(pool)
            v1 = b"snapdata" * 512
            await io.write_full("hot", v1)
            sid = await io.selfmanaged_snap_create()
            io.set_snap_context(sid, [sid])
            await io.write_full("hot", b"headdata" * 700)
            pgid = client.objecter.object_pgid(pool, "hot")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = next(o for o in acting if o != primary)
            await cluster.osds[victim].stop()
            got = await io.read("hot", snapid=sid, timeout=60)
            assert got == v1
        finally:
            await cluster.stop()

    run_both(scenario)
