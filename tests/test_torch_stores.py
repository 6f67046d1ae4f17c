"""The port's object stores against ``ceph_tpu``'s: MemStore, FileStore,
BlueStore and the KV on top of them, with the disk injector.

The store cases of the JAX package that need no cluster
(``tests/test_bluestore.py``, ``test_filestore.py``,
``test_aux_components.py::test_kv_db``, the store layer of
``test_ec_planar_at_rest.py``, ``test_integrity.py``'s MemStore capacity
case and the store cases of ``test_chaos.py``) run here on both packages.
Then a seeded transaction fuzz drives a reference store and a port store
of each kind through the same ~200 transactions of every op kind, with
planar windows cut from the stripe encode of each package on the CPU, and
requires every read, stat, attribute, omap, listing, statfs, layout and
version to be equal after every transaction and again after a crash with
a torn journal tail and a remount; for BlueStore also every onode's block
numbers and block csums.  ENOSPC must refuse the same transactions.

A transaction crosses from the reference to the port as its ``ops`` list
of plain tuples.
"""

import os
import types

import numpy as np
import pytest

import ceph_tpu.chaos.counters as jcounters
import ceph_tpu.chaos.disk as jdisk
import ceph_tpu.chaos.rng as jrng
import ceph_tpu.cluster.bluestore as jbluestore
import ceph_tpu.cluster.filestore as jfilestore
import ceph_tpu.cluster.kv as jkv
import ceph_tpu.cluster.store as jstore
import ceph_tpu.ec.planar_store as jplanar_store
import ceph_tpu.ops.crc32c as jcrc
import ceph_tpu.utils.config as jconfig
from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import stripe as jstripe
import ceph_tpu_torch.chaos.counters as counters
import ceph_tpu_torch.chaos.disk as disk
import ceph_tpu_torch.chaos.rng as rng
import ceph_tpu_torch.cluster.bluestore as bluestore
import ceph_tpu_torch.cluster.filestore as filestore
import ceph_tpu_torch.cluster.kv as kv
import ceph_tpu_torch.cluster.store as store
import ceph_tpu_torch.ec.planar_store as planar_store
import ceph_tpu_torch.ops.crc32c as pcrc
import ceph_tpu_torch.utils.config as config
from ceph_tpu_torch.ec import factory
from ceph_tpu_torch.ec import stripe
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF = types.SimpleNamespace(
    store=jstore, kv=jkv, filestore=jfilestore, bluestore=jbluestore,
    disk=jdisk, rng=jrng, counters=jcounters, planar_store=jplanar_store,
    config=jconfig)
PORT = types.SimpleNamespace(
    store=store, kv=kv, filestore=filestore, bluestore=bluestore,
    disk=disk, rng=rng, counters=counters, planar_store=planar_store,
    config=config)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
BLOCK = bluestore.BLOCK


def _chaos(pkg):
    return dict(pkg.counters.CHAOS.dump()["chaos"])


# ------------------------------------------------------------- BlueStore


def _bstore(pkg, tmp_path, **kw):
    s = pkg.bluestore.BlueStore(str(tmp_path / "bs"), size=8 << 20, **kw)
    s.mount()
    return s


@BOTH
def test_bluestore_write_read_roundtrip_and_partial(pkg, tmp_path):
    T = pkg.store.Transaction
    s = _bstore(pkg, tmp_path)
    payload = bytes(range(256)) * 40          # 10240: crosses blocks
    s.queue_transaction(T().write("c", "o", 0, payload)
                        .set_version("c", "o", 7))
    assert s.read("c", "o") == payload
    assert s.stat("c", "o") == len(payload)
    assert s.get_version("c", "o") == 7
    s.queue_transaction(T().write("c", "o", 4000, b"X" * 200))
    got = s.read("c", "o")
    assert got[4000:4200] == b"X" * 200
    assert got[:4000] == payload[:4000]
    assert got[4200:] == payload[4200:]
    assert s.read("c", "o", 4100, 50) == b"X" * 50
    s.umount()


@BOTH
def test_bluestore_csum_detects_silent_corruption(pkg, tmp_path):
    s = _bstore(pkg, tmp_path)
    s.queue_transaction(pkg.store.Transaction().write("c", "o", 0,
                                                      b"A" * BLOCK))
    blkno = s._onodes["c"]["o"].blocks[0]
    s.umount()
    path = os.path.join(str(tmp_path / "bs"), "block")
    with open(path, "r+b") as f:
        f.seek((16 + blkno) * BLOCK + 100)
        f.write(b"\xff\xfe\xfd")
    s2 = pkg.bluestore.BlueStore(str(tmp_path / "bs"), size=8 << 20)
    s2.mount()
    with pytest.raises(IOError):
        s2.read("c", "o")
    s2.umount()


@BOTH
def test_bluestore_allocator_reclaims_on_remove_and_overwrite(pkg, tmp_path):
    T = pkg.store.Transaction
    s = _bstore(pkg, tmp_path)
    free0 = s.alloc.n_free
    s.queue_transaction(T().write("c", "o", 0, b"B" * (BLOCK * 4)))
    assert s.alloc.n_free == free0 - 4
    s.queue_transaction(T().write("c", "o", 0, b"C" * (BLOCK * 4)))
    assert s.alloc.n_free == free0 - 4
    s.queue_transaction(T().remove("c", "o"))
    assert s.alloc.n_free == free0
    s.queue_transaction(T().write("c", "t", 0, b"D" * (BLOCK * 4)))
    s.queue_transaction(T().truncate("c", "t", BLOCK))
    assert s.alloc.n_free == free0 - 1
    assert s.read("c", "t") == b"D" * BLOCK
    s.umount()


@BOTH
def test_bluestore_device_full_is_enospc(pkg, tmp_path):
    s = pkg.bluestore.BlueStore(str(tmp_path / "tiny"), size=64 * BLOCK)
    s.mount()
    with pytest.raises(OSError):
        s.queue_transaction(pkg.store.Transaction().write(
            "c", "big", 0, b"x" * (100 * BLOCK)))
    s.umount()


@BOTH
def test_bluestore_remount_durability_and_wal_replay(pkg, tmp_path):
    T = pkg.store.Transaction
    s = _bstore(pkg, tmp_path, checkpoint_every=10_000)
    s.queue_transaction(T().write("c", "o", 0, b"persist-me" * 500)
                        .setattr("c", "o", "k", b"v")
                        .omap_set("c", "o", {"a": b"1"})
                        .set_version("c", "o", 9))
    s.queue_transaction(T().clone("c", "o", "o2"))
    s._wal.flush()
    s._dev.flush()
    s._mounted = False
    s2 = pkg.bluestore.BlueStore(str(tmp_path / "bs"), size=8 << 20)
    s2.mount()
    assert s2.read("c", "o") == b"persist-me" * 500
    assert s2.getattr("c", "o", "k") == b"v"
    assert s2.omap_get("c", "o") == {"a": b"1"}
    assert s2.get_version("c", "o") == 9
    assert s2.read("c", "o2") == b"persist-me" * 500
    used = sum(1 for f in s2.alloc.free if not f)
    want = len([b for b in s2._onodes["c"]["o"].blocks if b >= 0]) + \
        len([b for b in s2._onodes["c"]["o2"].blocks if b >= 0])
    assert used == want
    s2.umount()


@BOTH
def test_bluestore_wal_replay_never_clobbers_checkpointed_blocks(pkg,
                                                                 tmp_path):
    T = pkg.store.Transaction
    s = _bstore(pkg, tmp_path, checkpoint_every=10_000)
    s.queue_transaction(T().write("c", "A", 0, b"a" * BLOCK * 3))
    s.checkpoint()
    s.queue_transaction(T().write("c", "B", 0, b"b" * BLOCK * 2))
    s._wal.flush()
    s._dev.flush()
    s._mounted = False
    s2 = pkg.bluestore.BlueStore(str(tmp_path / "bs"), size=8 << 20)
    s2.mount()
    assert s2.read("c", "A") == b"a" * BLOCK * 3
    assert s2.read("c", "B") == b"b" * BLOCK * 2
    s2.umount()


def test_bluestore_csums_are_one_batched_call_per_transaction(tmp_path,
                                                              monkeypatch):
    """The port checksums a transaction's blocks in one ``crc32c_rows``
    call and a read's blocks in another, never one host crc per block;
    the values are the reference's."""
    calls = []
    rows_fn = pcrc.crc32c_rows

    def counted(rows, *a, **k):
        calls.append(tuple(rows.shape))
        return rows_fn(rows, *a, **k)

    monkeypatch.setattr(pcrc, "crc32c_rows", counted)
    monkeypatch.setattr(pcrc, "crc32c", lambda *a, **k: pytest.fail(
        "per-block host crc called"))
    payload = np.random.default_rng(3).integers(
        0, 256, 5 * BLOCK + 123, dtype=np.uint8).tobytes()
    s = bluestore.BlueStore(str(tmp_path / "p"), size=8 << 20)
    s.mount()
    s.queue_transaction(store.Transaction().write("c", "o", 0, payload)
                        .clone("c", "o", "o2"))
    # the clone reads the blocks this transaction staged: one call
    assert calls == [(12, BLOCK)]
    calls.clear()
    assert s.read("c", "o") == payload
    assert calls == [(6, BLOCK)]
    want = [jcrc.crc32c(0xFFFFFFFF, (payload + bytes(6 * BLOCK))
                        [i * BLOCK:(i + 1) * BLOCK]) for i in range(6)]
    assert s._onodes["c"]["o"].csums == want
    assert s._onodes["c"]["o2"].csums == want
    s.umount()


# ------------------------------------------------------------- FileStore


@BOTH
def test_filestore_roundtrip(pkg, tmp_path):
    s = pkg.filestore.FileStore(str(tmp_path / "osd0"))
    s.mount()
    s.queue_transaction(
        pkg.store.Transaction()
        .create_collection("c")
        .write("c", "obj", 0, b"hello world")
        .setattr("c", "obj", "k", b"v")
        .omap_set("c", "obj", {"ok": b"ov"})
        .set_version("c", "obj", 7))
    s.umount()
    s2 = pkg.filestore.FileStore(str(tmp_path / "osd0"))
    s2.mount()
    assert s2.read("c", "obj") == b"hello world"
    assert s2.getattr("c", "obj", "k") == b"v"
    assert s2.omap_get("c", "obj") == {"ok": b"ov"}
    assert s2.get_version("c", "obj") == 7
    s2.umount()


@BOTH
def test_filestore_journal_replay_without_checkpoint(pkg, tmp_path):
    s = pkg.filestore.FileStore(str(tmp_path / "osd1"))
    s.mount()
    s.queue_transaction(pkg.store.Transaction().create_collection("c")
                        .write("c", "o", 0, b"abc"))
    s._journal.flush()
    s._journal.close()
    s2 = pkg.filestore.FileStore(str(tmp_path / "osd1"))
    s2.mount()
    assert s2.read("c", "o") == b"abc"
    s2.umount()


@BOTH
def test_filestore_torn_tail_discarded(pkg, tmp_path):
    s = pkg.filestore.FileStore(str(tmp_path / "osd2"))
    s.mount()
    s.queue_transaction(pkg.store.Transaction().create_collection("c")
                        .write("c", "o", 0, b"good"))
    s._journal.flush()
    s._journal.close()
    with open(s._journal_path, "ab") as f:
        f.write(b"\xff\x00\x00\x00partial")
    s2 = pkg.filestore.FileStore(str(tmp_path / "osd2"))
    s2.mount()
    assert s2.read("c", "o") == b"good"
    s2.umount()


@BOTH
def test_filestore_checkpoint_truncates_journal(pkg, tmp_path):
    s = pkg.filestore.FileStore(str(tmp_path / "osd3"), checkpoint_every=4)
    s.mount()
    for i in range(10):
        s.queue_transaction(pkg.store.Transaction().create_collection("c")
                            .write("c", f"o{i}", 0, b"x" * 100))
    assert os.path.getsize(s._journal_path) < 4 * 300
    s.umount()
    s2 = pkg.filestore.FileStore(str(tmp_path / "osd3"))
    s2.mount()
    assert len(s2.list_objects("c")) == 10
    s2.umount()


# -------------------------------------------------------------------- KV


@BOTH
@pytest.mark.parametrize("mk", ["mem", "store"])
def test_kv_db(pkg, mk, tmp_path):
    KVT = pkg.kv.KVTransaction
    if mk == "mem":
        db = pkg.kv.MemDB()
    else:
        st = pkg.filestore.FileStore(str(tmp_path / "kv"))
        st.mount()
        db = pkg.kv.StoreDB(st)
    db.submit_transaction(
        KVT().set("osdmap", "epoch_1", b"m1")
        .set("osdmap", "epoch_2", b"m2").set("paxos", "v", b"p"))
    assert db.get("osdmap", "epoch_1") == b"m1"
    assert list(db.iterate("osdmap")) == [
        ("epoch_1", b"m1"), ("epoch_2", b"m2")]
    db.submit_transaction(KVT().rmkey("osdmap", "epoch_1"))
    assert db.get("osdmap", "epoch_1") is None
    db.submit_transaction(KVT().rmkeys_by_prefix("paxos"))
    assert db.get("paxos", "v") is None
    if mk == "store":
        st.umount()
        st2 = pkg.filestore.FileStore(str(tmp_path / "kv"))
        st2.mount()
        assert pkg.kv.StoreDB(st2).get("osdmap", "epoch_2") == b"m2"
        st2.umount()


# ------------------------------------------------- capacity, planar at rest


@BOTH
def test_memstore_capacity_enforced_and_accounted(pkg):
    T = pkg.store.Transaction
    st = pkg.store.MemStore(device_bytes=10000)
    st.queue_transaction(T().write("c", "a", 0, b"x" * 4000))
    st.queue_transaction(T().write("c", "b", 0, b"y" * 4000))
    assert st.statfs() == (10000, 8000)
    with pytest.raises(OSError) as ei:
        st.queue_transaction(T().write("c", "big", 0, b"z" * 4000))
    assert ei.value.errno == 28
    assert st.stat("c", "big") is None and st.statfs()[1] == 8000
    st.queue_transaction(T().write("c", "a", 0, b"w" * 4000))
    st.queue_transaction(T().remove("c", "a").write("c", "a2", 0,
                                                    b"v" * 3000))
    assert st.statfs()[1] == 7000
    st.queue_transaction(T().truncate("c", "a2", 1000))
    assert st.statfs()[1] == 5000
    st.queue_transaction(T().clone("c", "b", "b2"))
    assert st.statfs()[1] == 9000
    with pytest.raises(OSError):
        st.queue_transaction(T().clone("c", "b", "b3"))
    st.queue_transaction(T().remove_collection("c"))
    assert st.statfs()[1] == 0
    st.queue_transaction(T().write("d", "o", 100, b"q" * 50))
    used = st.statfs()[1]
    st._recount_used()
    assert st.statfs()[1] == used == 150


@BOTH
def test_memstore_planar_accounting_and_enospc_parity(pkg):
    ps = pkg.planar_store
    cap = 1 << 14
    outcomes = []
    for planar in (False, True):
        s = pkg.store.MemStore(device_bytes=cap)
        s.queue_transaction(pkg.store.Transaction().create_collection("c"))
        blob = bytes(range(256)) * 16
        for i in range(4):
            txn = pkg.store.Transaction()
            if planar:
                txn.write_planar("c", f"o{i}", 0, ps.planes_to_blob(
                    ps.shard_to_planes(blob)), len(blob) // 8)
            else:
                txn.write("c", f"o{i}", 0, blob)
            s.queue_transaction(txn)
        used, total = s.statfs()
        assert (used, total) == (cap, cap)
        txn = pkg.store.Transaction()
        if planar:
            txn.write_planar("c", "overflow", 0, blob, len(blob) // 8)
        else:
            txn.write("c", "overflow", 0, blob)
        with pytest.raises(OSError) as ei:
            s.queue_transaction(txn)
        outcomes.append((used, ei.value.errno, str(ei.value)))
        if planar:
            assert all(s.object_layout("c", f"o{i}") == ps.LAYOUT_PLANAR
                       for i in range(4))
    assert outcomes[0] == outcomes[1]


@BOTH
def test_filestore_checkpoint_and_journal_bounce_planar(pkg, tmp_path):
    ps = pkg.planar_store
    blob = ps.planes_to_blob(ps.shard_to_planes(bytes(range(256)) * 8))
    for checkpoint_every, tag in ((1, "ckpt"), (2048, "journal")):
        path = str(tmp_path / tag)
        s = pkg.filestore.FileStore(path, checkpoint_every=checkpoint_every)
        s.mount()
        s.queue_transaction(
            pkg.store.Transaction().create_collection("c")
            .write_planar("c", "obj", 0, blob, len(blob) // 8)
            .setattr("c", "obj", "hinfo_crc", b"123"))
        s2 = pkg.filestore.FileStore(path)
        s2.mount()
        assert s2.object_layout("c", "obj") == ps.LAYOUT_PLANAR
        assert s2.read_planar("c", "obj") == blob
        assert s2.getattr("c", "obj", "hinfo_crc") == b"123"
        s2.umount()


@BOTH
def test_bluestore_wal_bounce_and_bitrot_planar(pkg, tmp_path):
    ps = pkg.planar_store
    blob = ps.planes_to_blob(ps.shard_to_planes(bytes(range(256)) * 32))
    path = str(tmp_path / "bs")
    s = pkg.bluestore.BlueStore(path, size=8 << 20,
                                checkpoint_every=10_000)
    s.mount()
    s.queue_transaction(pkg.store.Transaction().create_collection("c")
                        .write_planar("c", "obj", 0, blob, len(blob) // 8))
    s2 = pkg.bluestore.BlueStore(path, size=8 << 20)
    s2.mount()
    assert s2.object_layout("c", "obj") == ps.LAYOUT_PLANAR
    assert s2.read_planar("c", "obj") == blob
    s2.debug_bitrot("c", "obj", bit=41)
    with pytest.raises(IOError):
        s2.read_planar("c", "obj")
    s2.umount()


# ----------------------------------------------------------- disk chaos


@BOTH
def test_disk_injector_none_at_default_config(pkg):
    cfg = pkg.config.Config()
    assert pkg.disk.DiskInjector.from_config(cfg, "osd.0") is None
    inj = pkg.disk.DiskInjector.from_config(
        pkg.config.Config(chaos_disk_read_err=0.5, chaos_seed=9), "osd.0")
    assert inj is not None and inj.read_err == 0.5
    assert inj.rng.random() == pkg.rng.stream(9, "disk:osd.0").random()


@BOTH
def test_disk_injector_eio_and_enospc(pkg):
    T = pkg.store.Transaction
    st = pkg.store.MemStore()
    st.queue_transaction(T().create_collection("c").write("c", "o", 0,
                                                          b"data"))
    st.chaos = pkg.disk.DiskInjector(pkg.rng.stream(1, "d"), read_err=1.0)
    with pytest.raises(IOError):
        st.read("c", "o")
    st.chaos = pkg.disk.DiskInjector(pkg.rng.stream(1, "d"), enospc=1.0)
    with pytest.raises(OSError) as ei:
        st.queue_transaction(T().write("c", "o", 0, b"x"))
    assert ei.value.errno == 28
    st.chaos = None
    assert st.read("c", "o") == b"data"


def test_flip_bit_memstore_silent_same_bit_both_packages():
    bits = []
    for pkg in (REF, PORT):
        T = pkg.store.Transaction
        st = pkg.store.MemStore()
        st.queue_transaction(T().create_collection("c").write(
            "c", "o", 0, b"A" * 64))
        before = _chaos(pkg).get("disk_bitrot_flips", 0)
        bit = pkg.disk.DiskInjector(pkg.rng.stream(7, "rot")).flip_bit(
            st, "c", "o")
        assert _chaos(pkg)["disk_bitrot_flips"] == before + 1
        data = st.read("c", "o")
        diff = [a ^ b for a, b in zip(data, b"A" * 64)]
        assert sum(bin(d).count("1") for d in diff) == 1
        assert st.get_version("c", "o") == 1
        bits.append(bit)
    assert bits[0] == bits[1]


@BOTH
def test_flip_bit_bluestore_surfaces_as_eio(pkg, tmp_path):
    st = pkg.bluestore.BlueStore(str(tmp_path / "bs"), size=8 << 20)
    st.mount()
    st.queue_transaction(pkg.store.Transaction().create_collection("c")
                         .write("c", "o", 0, b"B" * 1000))
    pkg.disk.DiskInjector(pkg.rng.stream(3, "rot")).flip_bit(st, "c", "o",
                                                             bit=40)
    with pytest.raises(IOError):
        st.read("c", "o")
    st.umount()


@BOTH
def test_filestore_crash_torn_tail_discards_last_txn(pkg, tmp_path):
    T = pkg.store.Transaction
    st = pkg.filestore.FileStore(str(tmp_path / "fs"))
    st.mount()
    st.queue_transaction(T().create_collection("c").write("c", "a", 0,
                                                          b"first"))
    st.queue_transaction(T().write("c", "b", 0, b"second"))
    st.crash(torn_tail=True)
    st.mount()
    assert st.read("c", "a") == b"first"
    assert st.stat("c", "b") is None
    st.umount()


@BOTH
def test_filestore_crash_lose_frames(pkg, tmp_path):
    T = pkg.store.Transaction
    st = pkg.filestore.FileStore(str(tmp_path / "fs2"))
    st.mount()
    st.queue_transaction(T().create_collection("c").write("c", "a", 0,
                                                          b"one"))
    st.queue_transaction(T().write("c", "b", 0, b"two"))
    st.queue_transaction(T().write("c", "z", 0, b"three"))
    before = _chaos(pkg).get("disk_lost_frames", 0)
    st.crash(lose_frames=2)
    assert _chaos(pkg)["disk_lost_frames"] == before + 2
    st.mount()
    assert st.read("c", "a") == b"one"
    assert st.stat("c", "b") is None
    assert st.stat("c", "z") is None
    st.umount()


@BOTH
def test_bluestore_crash_replays_wal(pkg, tmp_path):
    T = pkg.store.Transaction
    st = pkg.bluestore.BlueStore(str(tmp_path / "bs2"), size=8 << 20)
    st.mount()
    st.queue_transaction(T().create_collection("c").write("c", "a", 0,
                                                          b"W" * 100))
    st.queue_transaction(T().write("c", "b", 0, b"X" * 100))
    st.crash(torn_tail=True)
    st.mount()
    assert st.read("c", "a") == b"W" * 100
    assert st.stat("c", "b") is None
    st.umount()


# ------------------------------------------------ seeded transaction fuzz

COLLS = ["c0", "c1"]
OIDS = ["o0", "o1", "o2", "o3", "o4"]
ATTRS = ["shard", "size", "hinfo_crc", "k"]
N_TXNS = 200


def _planar_blobs():
    """Plane matrices of one small ISA k4m2 tick, encoded by each package
    on the CPU (they must agree): the windows the fuzz lands."""
    prof = {"plugin": "isa", "k": "4", "m": "2"}
    jc, pc = jfactory(dict(prof)), factory(dict(prof), device="cpu")
    rs = np.random.default_rng(11)
    datas = [rs.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in (1000, 2048, 5000)]
    want = jstripe.encode_planes_multi(jc, jstripe.StripeInfo(4, 512),
                                       datas)
    got = stripe.encode_planes_multi(pc, stripe.StripeInfo(4, 512), datas)
    mats = []
    for (gp, _gc), (wp, _wc) in zip(got, want):
        assert np.array_equal(gp, wp)
        mats.extend(gp[s] for s in range(gp.shape[0]))
    return mats


_PLANES = []


def _planes():
    if not _PLANES:
        _PLANES.extend(_planar_blobs())
    return _PLANES


def _gen_txn(rs, T, planes):
    """One reference transaction of 1-4 random ops."""
    txn = T()
    for _ in range(int(rs.integers(1, 5))):
        coll = COLLS[int(rs.integers(len(COLLS)))]
        oid = OIDS[int(rs.integers(len(OIDS)))]
        kind = int(rs.integers(15))
        if kind == 0:
            txn.create_collection(coll)
        elif kind == 1 and rs.random() < 0.2:
            txn.remove_collection(coll)
        elif kind in (2, 3):
            n = int(rs.integers(0, 3 * BLOCK))
            off = int(rs.integers(0, 2 * BLOCK)) if rs.random() < 0.5 else 0
            txn.write(coll, oid, off,
                      rs.integers(0, 256, n, dtype=np.uint8).tobytes())
        elif kind in (4, 5):
            mat = planes[int(rs.integers(len(planes)))]
            cols = mat.shape[1]
            a = int(rs.integers(0, cols)) if rs.random() < 0.4 else 0
            b = int(rs.integers(a + 1, cols + 1))
            total = cols if rs.random() < 0.7 else int(rs.integers(b, 2 * cols))
            txn.write_planar(coll, oid, a,
                             np.ascontiguousarray(mat[:, a:b]).tobytes(),
                             total)
        elif kind == 6:
            txn.truncate(coll, oid, int(rs.integers(0, 3 * BLOCK)))
        elif kind == 7:
            txn.remove(coll, oid)
        elif kind == 8:
            txn.clone(coll, oid, OIDS[int(rs.integers(len(OIDS)))])
        elif kind == 9:
            txn.rb_capture(coll, oid, "rb", f"v{int(rs.integers(100))}")
        elif kind == 10:
            txn.setattr(coll, oid, ATTRS[int(rs.integers(len(ATTRS)))],
                        rs.integers(0, 256, 8, dtype=np.uint8).tobytes())
        elif kind == 11:
            txn.rmattr(coll, oid, ATTRS[int(rs.integers(len(ATTRS)))])
        elif kind == 12:
            txn.omap_set(coll, oid, {f"k{int(rs.integers(6))}":
                                     bytes([int(rs.integers(256))]) * 3})
        elif kind == 13:
            txn.omap_rmkeys(coll, oid, [f"k{int(rs.integers(6))}"])
        else:
            if rs.random() < 0.5:
                txn.touch(coll, oid)
            else:
                txn.set_version(coll, oid, int(rs.integers(1, 1000)))
    return txn


def _outcome(fn):
    try:
        return ("ok", fn())
    except (OSError, ValueError) as e:
        return ("err", type(e).__name__, getattr(e, "errno", None))


def _snapshot(st, blue: bool):
    out = {"colls": st.list_collections(), "statfs": st.statfs()}
    for coll in COLLS:
        out[coll] = st.list_objects(coll)
        for oid in OIDS + ["rb"]:
            key = (coll, oid)
            out[key] = (
                st.stat(coll, oid), st.get_version(coll, oid),
                st.get_xattrs(coll, oid), st.omap_get(coll, oid),
                st.getattr(coll, oid, "k"), st.object_layout(coll, oid),
                _outcome(lambda: st.read(coll, oid)),
                _outcome(lambda: st.read(coll, oid, 1000, 3000)),
                _outcome(lambda: st.read_planar(coll, oid)))
    if blue:
        out["onodes"] = {
            (c, o): (list(n.blocks), list(n.csums), n.size,
                     getattr(n, "layout", None))
            for c, objs in st._onodes.items() for o, n in objs.items()}
        out["n_free"] = st.alloc.n_free
    return out


def _make(pkg, kind, path):
    if kind == "mem":
        return pkg.store.MemStore(device_bytes=40 << 10)
    if kind == "file":
        st = pkg.filestore.FileStore(path, checkpoint_every=16,
                                     device_bytes=40 << 10)
    else:
        st = pkg.bluestore.BlueStore(path, size=(16 + 16) * BLOCK,
                                     checkpoint_every=16)
    st.mount()
    return st


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["mem", "file", "blue"])
def test_transaction_fuzz_equal_reference(kind, seed, tmp_path):
    blue = kind == "blue"
    ref = _make(REF, kind, str(tmp_path / "ref"))
    port = _make(PORT, kind, str(tmp_path / "port"))
    rs = np.random.default_rng(seed)
    planes = _planes()
    outcomes = {"ok": 0, "err": 0}
    for i in range(N_TXNS):
        rtxn = _gen_txn(rs, jstore.Transaction, planes)
        ptxn = store.Transaction()
        ptxn.ops = list(rtxn.ops)
        want = _outcome(lambda: ref.queue_transaction(rtxn))
        got = _outcome(lambda: port.queue_transaction(ptxn))
        assert got == want, (i, rtxn.ops)
        outcomes[want[0]] += 1
        assert _snapshot(port, blue) == _snapshot(ref, blue), (i, rtxn.ops)
    # the fuzz reached both sides of admission
    assert outcomes["ok"] > N_TXNS // 2 and outcomes["err"] > 0, outcomes
    if kind == "mem":
        return
    for st in (ref, port):
        st.crash(torn_tail=True)
        st.mount()
    assert _snapshot(port, blue) == _snapshot(ref, blue)
    for st in (ref, port):
        st.umount()
