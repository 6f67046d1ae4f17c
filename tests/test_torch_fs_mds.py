"""The port's CephFS layer and MDS against ``ceph_tpu``'s, on the cases of
``tests/test_fs.py``, ``tests/test_mds.py`` and
``tests/test_mds_multiactive.py``.

Each case runs one cluster of each package
(``tests/_torch_clients.run_both_clients``; the port on
``device="cpu"``, its MDS ranks started by ``Cluster.start_mds`` on the
cluster's device), with each reference test's own assertions, and
requires equal returns.  Equal reads and stored objects are required
where the scenario does not depend on timing.  Two clients racing
creates and renames, and a restart that waits for the map, do; those
cases say so.
"""

import asyncio
import pickle

import pytest

from tests._flaky import contention_retry
from tests._torch_clients import run_both_clients
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    PORT, REF, _one_torch_thread, _port_lockdep_reset)


# -- the cases of tests/test_fs.py --------------------------------------------

async def _mount(P, cluster):
    FileSystem = P.imp("cluster.fs.FileSystem")
    FileLayout = P.imp("cluster.striper.FileLayout")
    client = await cluster.client()
    meta = await client.pool_create("fs_meta", "replicated",
                                    pg_num=8, size=2)
    data = await client.pool_create("fs_data", "replicated",
                                    pg_num=8, size=2)
    fs = FileSystem(client.ioctx(meta), client.ioctx(data),
                    layout=FileLayout(stripe_unit=4096, stripe_count=2,
                                      object_size=16384))
    await fs.mkfs()
    return fs


def test_fs_namespace_and_io():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            fs = await _mount(P, cluster)
            await fs.mkdir("/home")
            await fs.mkdir("/home/user")
            await fs.create("/home/user/hello.txt")
            assert await fs.listdir("/") == ["home"]
            assert await fs.listdir("/home/user") == ["hello.txt"]
            with pytest.raises(FileExistsError):
                await fs.mkdir("/home")
            with pytest.raises(FileNotFoundError):
                await fs.stat("/home/user/nope")

            payload = bytes(range(256)) * 300  # ~75 KiB, several objects
            await fs.write("/home/user/hello.txt", 0, payload)
            assert await fs.read("/home/user/hello.txt") == payload
            st = await fs.stat("/home/user/hello.txt")
            assert st.mode == "file" and st.size == len(payload)
            await fs.write("/home/user/hello.txt", 100, b"X" * 50)
            got = await fs.read("/home/user/hello.txt", 90, 80)
            assert got == payload[90:100] + b"X" * 50 + payload[150:170]
            await fs.write("/home/user/hello.txt", 200000, b"tail")
            st = await fs.stat("/home/user/hello.txt")
            assert st.size == 200004
            assert await fs.read("/home/user/hello.txt",
                                 199990, 20) == b"\0" * 10 + b"tail"

            await fs.rename("/home/user/hello.txt", "/home/moved.txt")
            assert await fs.listdir("/home") == ["moved.txt", "user"]
            assert (await fs.read("/home/moved.txt", 0, 10)) == payload[:10]
            with pytest.raises(OSError):
                await fs.unlink("/home")   # non-empty directory
            await fs.unlink("/home/moved.txt")
            await fs.unlink("/home/user")
            await fs.unlink("/home")
            assert await fs.listdir("/") == []
            return st.ino, st.size, st.mode
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_fs_data_on_ec_pool():
    """File data striped onto an EC pool; metadata replicated — the
    standard CephFS deployment split."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        FileSystem = P.imp("cluster.fs.FileSystem")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            meta = await client.pool_create("fsm", "replicated",
                                            pg_num=4, size=2)
            data = await client.pool_create(
                "fsd", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            fs = FileSystem(client.ioctx(meta), client.ioctx(data))
            await fs.mkfs()
            await fs.create("/big.bin")
            blob = b"ec-file-data" * 2000
            await fs.write("/big.bin", 0, blob)
            assert await fs.read("/big.bin") == blob
        finally:
            await cluster.stop()

    run_both_clients(scenario)


# -- the cases of tests/test_mds.py -------------------------------------------

async def _fs_cluster(P):
    start_cluster = P.imp("cluster.vstart.start_cluster")
    cluster = await start_cluster(3)
    admin = await cluster.client()
    meta = await admin.pool_create("fsmeta", "replicated", pg_num=8, size=2)
    data = await admin.pool_create("fsdata", "replicated", pg_num=8, size=2)
    await cluster.start_mds(meta, data)
    deadline = asyncio.get_event_loop().time() + 20
    while asyncio.get_event_loop().time() < deadline:
        await admin.objecter._refresh_map()
        if getattr(admin.objecter.osdmap, "mds_addr", None):
            break
        await asyncio.sleep(0.05)
    assert getattr(admin.objecter.osdmap, "mds_addr", None), \
        "MDS never registered in the map"
    return cluster, admin, meta, data


def _inode(st):
    return st.ino, st.mode, st.size


def test_mds_namespace_and_file_io():
    async def scenario(P):
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster, admin, meta, data = await _fs_cluster(P)
        try:
            fs = MDSClient(admin, data)
            await fs.mkdir("/dir")
            await fs.create("/dir/file")
            payload = b"mds-routed-metadata, direct data" * 100
            await fs.write("/dir/file", 0, payload)
            assert await fs.read("/dir/file") == payload
            st = await fs.stat("/dir/file")
            assert st.size == len(payload)
            assert await fs.listdir("/dir") == ["file"]
            await fs.rename("/dir/file", "/dir/renamed")
            assert await fs.listdir("/dir") == ["renamed"]
            assert await fs.read("/dir/renamed") == payload
            await fs.unlink("/dir/renamed")
            with pytest.raises(FileNotFoundError):
                await fs.stat("/dir/renamed")
            return _inode(st)
        finally:
            await cluster.stop()

    run_both_clients(scenario)


@contention_retry()
def test_two_clients_coherent_under_concurrency():
    """Two clients hammer the same directory with creates + renames; the
    MDS serializes them — every op lands exactly once, names never
    duplicate or vanish.  Which client wins each race depends on timing:
    compares the race-free returns only."""
    async def scenario(P):
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster, admin, meta, data = await _fs_cluster(P)
        try:
            c2 = await cluster.client("second")
            fs1 = MDSClient(admin, data)
            fs2 = MDSClient(c2, data)
            await fs1.mkdir("/race")

            async def creator(fs, tag, n):
                made = []
                for i in range(n):
                    try:
                        await fs.create(f"/race/{tag}{i}")
                        made.append(f"{tag}{i}")
                    except FileExistsError:
                        pass
                return made

            made1, made2 = await asyncio.gather(
                creator(fs1, "a", 8), creator(fs2, "b", 8))
            names = set(await fs1.listdir("/race"))
            assert set(made1) | set(made2) <= names
            assert len(names) == len(made1) + len(made2)
            r1 = fs1.rename("/race/a0", "/race/target")
            r2 = fs2.rename("/race/b0", "/race/target")
            await asyncio.gather(r1, r2, return_exceptions=True)
            fs1._lease.clear()
            after = set(await fs1.listdir("/race"))
            assert "target" in after
            survivors = {"a0", "b0"} & after
            assert len(survivors) + 1 + len(
                after - {"target", "a0", "b0"}) == len(after)
            return sorted(made1), sorted(made2), sorted(
                after - {"a0", "b0", "target"})
        finally:
            await cluster.stop()

    run_both_clients(scenario, reads=False, stores=False)


@contention_retry()
def test_mds_restart_replays_journal():
    """Kill the MDS after journal append but before dirfrag apply; the
    restarted MDS must replay the event (MDSRank boot replay).  The
    restart's wait for the map is timing-dependent: compares returns
    and the reads of the namespace only."""
    async def scenario(P):
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster, admin, meta, data = await _fs_cluster(P)
        try:
            fs = MDSClient(admin, data)
            await fs.mkdir("/jd")
            await fs.create("/jd/before")
            mds = cluster.mds
            seq = mds._seq + 1
            await mds._journal_append(seq, ("create", "/jd/orphan"))
            await mds.stop()

            await cluster.start_mds(meta, data)
            if P.dev and cluster.mds.device.type != "cpu":
                raise AssertionError("the restarted rank left the CPU")
            deadline = asyncio.get_event_loop().time() + 20
            while asyncio.get_event_loop().time() < deadline:
                await admin.objecter._refresh_map()
                a = getattr(admin.objecter.osdmap, "mds_addr", None)
                if a and tuple(a) == tuple(cluster.mds_addr):
                    break
                await asyncio.sleep(0.05)
            else:
                raise TimeoutError(
                    "restarted MDS never re-registered in the map")
            fs2 = MDSClient(admin, data)
            names = set(await fs2.listdir("/jd"))
            assert "orphan" in names, "journal replay missed the event"
            assert "before" in names
            assert cluster.mds._seq >= seq
            return sorted(names), seq
        finally:
            await cluster.stop()

    run_both_clients(scenario, stores=False)


@contention_retry()
def test_mds_lease_caching():
    """stat/listdir replies carry a lease: repeated lookups inside the
    TTL are served from the client cache; mutations invalidate it."""
    async def scenario(P):
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster, admin, meta, data = await _fs_cluster(P)
        try:
            fs = MDSClient(admin, data)
            await fs.mkdir("/ld")
            await fs.create("/ld/f")
            before = cluster.mds.perf.get("mds_requests")
            for _ in range(5):
                await fs.stat("/ld/f")     # leased: one round-trip only
            mid = cluster.mds.perf.get("mds_requests")
            assert mid == before + 1
            await fs.create("/ld/g")        # mutation drops the lease
            await fs.listdir("/ld")
            assert cluster.mds.perf.get("mds_requests") > mid
            return mid - before
        finally:
            await cluster.stop()

    run_both_clients(scenario)


# -- the cases of tests/test_mds_multiactive.py -------------------------------

async def _ranks(cluster, ranks=2):
    client = await cluster.client()
    meta = await client.pool_create("meta", "replicated", pg_num=4, size=2)
    data = await client.pool_create("data", "replicated", pg_num=4, size=2)
    daemons = []
    for r in range(ranks):
        daemons.append(await cluster.start_mds(meta, data, rank=r))
    await client.objecter._refresh_map()
    return client, meta, data, daemons


@contention_retry()
def test_subtree_export_and_routing():
    """The stale client's bounce count depends on when its map arrives:
    the count is held to at least one in each run, not compared."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster = await start_cluster(3)
        try:
            client, meta, data, (mds0, mds1) = await _ranks(cluster)
            fs = MDSClient(client, data, meta_pool=meta)
            await fs.mkdir("/a")
            await fs.mkdir("/b")
            await fs.create("/a/f1")
            await fs.write("/a/f1", 0, b"before-export")

            await fs.export_dir("/a", 1)
            assert fs._owner_rank("/a/f1") == 1
            assert fs._owner_rank("/b/x") == 0

            before = mds1.perf.dump()["mds.1"].get("mds_requests", 0)
            await fs.create("/a/f2")
            await fs.write("/a/f2", 0, b"on-rank-1")
            assert await fs.read("/a/f2") == b"on-rank-1"
            assert await fs.read("/a/f1") == b"before-export"
            after = mds1.perf.dump()["mds.1"].get("mds_requests", 0)
            assert after > before, "rank 1 never served /a"
            await fs.create("/b/g1")
            assert sorted(await fs.listdir("/b")) == ["g1"]

            c2 = await cluster.client("second")
            fs2 = MDSClient(c2, data, meta_pool=meta)
            assert await fs2.read("/a/f2") == b"on-rank-1"
            assert mds0.perf.dump()["mds.0"].get("mds_bounced", 0) >= 1

            with pytest.raises(OSError) as ei:
                await fs.rename("/a/f2", "/b/f2")
            assert ei.value.errno == 18
            await fs.rename("/b/g1", "/b/g2")
            assert sorted(await fs.listdir("/b")) == ["g2"]

            await mds1.stop()
            await cluster.start_mds(meta, data, rank=1)
            assert await fs.read("/a/f1") == b"before-export"
            await fs.create("/a/f3")
            names = await fs.listdir("/a")
            assert "f3" in names
            return dict(fs._subtrees), sorted(names), sorted(cluster.mdss)
        finally:
            await cluster.stop()

    run_both_clients(scenario)


@contention_retry()
def test_fs_snapshots():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster = await start_cluster(3)
        try:
            client, meta, data, _ = await _ranks(cluster, ranks=1)
            fs = MDSClient(client, data, meta_pool=meta)
            await fs.mkdir("/d")
            await fs.create("/d/file")
            await fs.write("/d/file", 0, b"version-1")
            await fs.create("/d/gone")
            await fs.write("/d/gone", 0, b"doomed")

            s1 = await fs.snap_create("/d", "s1")

            await fs.write("/d/file", 0, b"VERSION-2")
            await fs.create("/d/new")
            await fs.unlink("/d/gone")

            assert await fs.read("/d/file") == b"VERSION-2"
            assert sorted(await fs.listdir("/d")) == ["file", "new"]
            assert await fs.read("/d/.snap/s1/file") == b"version-1"
            assert sorted(await fs.listdir("/d/.snap/s1")) == \
                ["file", "gone"]
            assert await fs.read("/d/.snap/s1/gone") == b"doomed"
            assert await fs.listdir("/d/.snap") == ["s1"]
            with pytest.raises(PermissionError):
                await fs.write("/d/.snap/s1/file", 0, b"nope")

            s2 = await fs.snap_create("/d", "s2")
            await fs.write("/d/file", 0, b"version-3")
            assert await fs.read("/d/.snap/s1/file") == b"version-1"
            assert await fs.read("/d/.snap/s2/file") == b"VERSION-2"
            assert await fs.read("/d/file") == b"version-3"

            await fs.snap_rm("/d", "s1")
            assert await fs.listdir("/d/.snap") == ["s2"]
            with pytest.raises(FileNotFoundError):
                await fs.read("/d/.snap/s1/file")
            return s1, s2
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_mds_messages_pickle_as_the_reference():
    """The MDS wire messages keep the reference's fields and defaults."""
    from ceph_tpu.cluster import mds as jmds
    from ceph_tpu_torch.cluster import mds as pmds

    for name in ("MClientRequest", "MClientReply", "MMDSBeacon"):
        got, want = getattr(pmds, name)(), getattr(jmds, name)()
        assert vars(got) == vars(want), name
    assert pmds.JOURNAL_OID == jmds.JOURNAL_OID
    assert pmds.SUBTREE_OID == jmds.SUBTREE_OID
    for subtrees, path in (({"/": 0}, "/a/b"),
                           ({"/": 0, "/a": 1}, "/a/b"),
                           ({"/": 0, "/a": 1, "/a/b": 2}, "/a/bc"),
                           ({"/": 0, "/a/b": 2}, "/a/b/c/../d")):
        assert pmds.owner_rank(subtrees, path) == \
            jmds.owner_rank(subtrees, path)
        assert pmds.norm_path(path) == jmds.norm_path(path)
    assert pickle.loads(pickle.dumps(pmds.MClientReply(tid=3))).tid == 3


def test_mds_serves_on_a_three_monitor_cluster():
    """ROADMAP §C: the reference's MDS sends its beacon to ``mon_addr`` as
    given, and a cluster of three monitors gives a list, so its
    ``start_mds`` raises ``TypeError`` there.  The port's beacons hunt
    across the monmap (``MonTargeter``): the rank registers and serves."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        MDSClient = P.imp("cluster.mds.MDSClient")
        cluster = await start_cluster(3, n_mons=3)
        try:
            client = await cluster.client()
            meta = await client.pool_create("m3", "replicated", pg_num=4,
                                            size=2)
            data = await client.pool_create("d3", "replicated", pg_num=4,
                                            size=2)
            try:
                await cluster.start_mds(meta, data)
            except TypeError as e:
                return "refused", type(e).__name__
            deadline = asyncio.get_event_loop().time() + 20
            while not (getattr(client.objecter.osdmap, "mds_addrs", None)
                       or {}).get(0):
                assert asyncio.get_event_loop().time() < deadline, \
                    "the MDS never reached the map"
                await client.objecter._refresh_map()
                await asyncio.sleep(0.05)
            fs = MDSClient(client, data, meta_pool=meta)
            await fs.mkdir("/m")
            await fs.create("/m/f")
            await fs.write("/m/f", 0, b"three-mons" * 100)
            assert await fs.read("/m/f") == b"three-mons" * 100
            return "served", await fs.listdir("/m")
        finally:
            await cluster.stop()

    from tests.test_torch_cluster import run_one
    ref, _ = run_one(scenario, REF)
    got, _ = run_one(scenario, PORT)
    assert ref == ("refused", "TypeError")
    assert got == ("served", ["f"])
