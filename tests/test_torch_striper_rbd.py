"""The port's striper and RBD against ``ceph_tpu``'s, on the cases of
``tests/test_striper_rbd.py`` and ``tests/test_rbd_snaps.py``.

The striper's extent math is pure host arithmetic: each case runs it in
both packages and requires equal extents (and the reference test's own
assertions), and a seeded property test holds ``file_to_extents``,
``scatter`` and ``assemble`` to the reference over random layouts and
ranges.  The RBD cases run one cluster of each package
(``tests/_torch_clients.run_both_clients``; the port on
``device="cpu"``) and require equal returns, reads and stored objects.
"""

import numpy as np
import pytest

from ceph_tpu.cluster import striper as jstriper
from ceph_tpu_torch.cluster import striper as pstriper
from tests._torch_clients import run_both_clients
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)


def extents_both(layout_kw, offset, length, fmt="o.%016x"):
    """``file_to_extents`` of both packages, as comparable tuples."""
    out = []
    for mod in (pstriper, jstriper):
        ex = mod.file_to_extents(fmt, mod.FileLayout(**layout_kw),
                                 offset, length)
        out.append([(e.oid, e.objectno, e.offset, e.length,
                     list(e.buffer_extents)) for e in ex])
    assert out[0] == out[1]
    return pstriper.file_to_extents(fmt, pstriper.FileLayout(**layout_kw),
                                    offset, length)


# -- the cases of tests/test_striper_rbd.py -----------------------------------

def test_extents_single_object():
    ex = extents_both(dict(stripe_unit=1 << 20, stripe_count=1,
                           object_size=1 << 22), 0, 100)
    assert len(ex) == 1
    assert ex[0].objectno == 0 and ex[0].offset == 0 and ex[0].length == 100


def test_extents_cross_object_boundary():
    ex = extents_both(dict(stripe_unit=4096, stripe_count=1,
                           object_size=8192), 6000, 4000)
    assert [(e.objectno, e.offset, e.length) for e in ex] == [
        (0, 6000, 2192), (1, 0, 1808)]


def test_extents_interleave_stripes():
    """stripe_count 2: units round-robin across the object pair."""
    ex = extents_both(dict(stripe_unit=1000, stripe_count=2,
                           object_size=2000), 0, 4000)
    by_obj = {e.objectno: e for e in ex}
    assert by_obj[0].offset == 0 and by_obj[0].length == 2000
    assert by_obj[1].offset == 0 and by_obj[1].length == 2000
    assert by_obj[0].buffer_extents == [(0, 1000), (2000, 1000)]
    assert by_obj[1].buffer_extents == [(1000, 1000), (3000, 1000)]


def test_scatter_assemble_roundtrip():
    data = bytes(range(256)) * 40  # 10240 bytes, several periods
    got = []
    for mod in (pstriper, jstriper):
        lo = mod.FileLayout(stripe_unit=512, stripe_count=3,
                            object_size=2048)
        ex = mod.file_to_extents("o.%016x", lo, 300, len(data))
        per_obj = mod.StripedReader.scatter(ex, data)
        objects = {}
        for oid, parts in per_obj.items():
            buf = bytearray(4096)
            for off, blob in parts:
                buf[off: off + len(blob)] = blob
            objects[oid] = bytes(buf)
        out = mod.StripedReader.assemble(ex, objects, len(data))
        assert out == data
        got.append((per_obj, objects))
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(4))
def test_file_to_extents_property_equals_reference(seed):
    """Seeded random layouts and ranges: the extents, the scatter of a
    random buffer and the assembly of sparse objects (relative and
    absolute) equal the reference's, and assembling the scatter gives
    the buffer back."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        su = int(rng.choice([1, 7, 512, 4096, 65536]))
        layout = dict(stripe_unit=su,
                      stripe_count=int(rng.integers(1, 6)),
                      object_size=su * int(rng.integers(1, 9)))
        period = layout["object_size"] * layout["stripe_count"]
        offset = int(rng.integers(0, 3 * period + 1))
        length = int(rng.integers(0, 4 * period + 2))
        extents_both(layout, offset, length, fmt="rbd_data.x.%016x")
        data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
        outs = []
        for mod in (pstriper, jstriper):
            lo = mod.FileLayout(**layout)
            ex = mod.file_to_extents("f.%016x", lo, offset, length)
            per_obj = mod.StripedReader.scatter(ex, data)
            rel = {oid: b"".join(b for _, b in parts)
                   for oid, parts in per_obj.items()}
            # a sparse image: every other object absent, one short
            sparse = {e.oid: rel[e.oid][: e.length // 2]
                      for e in ex[::2]}
            absolute = {}
            for oid, parts in per_obj.items():
                buf = bytearray(layout["object_size"])
                for off, blob in parts:
                    buf[off: off + len(blob)] = blob
                absolute[oid] = bytes(buf)
            back = mod.StripedReader.assemble(ex, rel, length, relative=True)
            assert back == data
            outs.append((per_obj, back,
                         mod.StripedReader.assemble(ex, sparse, length,
                                                    relative=True),
                         mod.StripedReader.assemble(ex, absolute, length)))
        assert outs[0] == outs[1]


def test_layout_validation_equals_reference():
    for kw in (dict(stripe_unit=0), dict(stripe_count=0),
               dict(stripe_unit=3000, object_size=4096)):
        with pytest.raises(ValueError) as ref:
            jstriper.FileLayout(**kw).validate()
        with pytest.raises(ValueError) as got:
            pstriper.FileLayout(**kw).validate()
        assert str(got.value) == str(ref.value)


def test_rbd_image_end_to_end():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rbdpool", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            rbd = RBD(io)
            await rbd.create("img", size=1 << 20, stripe_unit=4096,
                             stripe_count=2, object_size=16384)
            assert await rbd.list() == ["img"]
            img = await rbd.open("img")
            assert img.size() == 1 << 20

            blob = bytes(range(256)) * 256  # 64 KiB
            await img.write(10000, blob)
            assert await img.read(10000, len(blob)) == blob
            assert await img.read(1 << 19, 100) == b"\0" * 100
            await img.write(12000, b"X" * 5000)
            got = await img.read(10000, len(blob))
            expect = bytearray(blob)
            expect[2000:7000] = b"X" * 5000
            assert got == bytes(expect)

            sid = await img.snap_create("s1")
            assert img.snap_list() == {"s1": sid}
            await img.resize(1 << 21)
            st = await img.stat()
            assert st["size"] == 1 << 21 and st["snaps"] == {"s1": sid}

            img2 = await rbd.open("img")
            assert img2.size() == 1 << 21
            assert await img2.read(10000, 100) == blob[:100]

            await rbd.remove("img")
            assert await rbd.list() == []
            return sid, st
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_rbd_image_on_ec_pool():
    """Images work unchanged on an erasure-coded pool (the data path is
    plain IoCtx ops; EC striping happens below)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "rbdec", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            io = client.ioctx(pool)
            rbd = RBD(io)
            await rbd.create("ecimg", size=1 << 19, stripe_unit=8192,
                             stripe_count=1, object_size=32768)
            img = await rbd.open("ecimg")
            payload = b"ec-image-data" * 1000
            await img.write(5000, payload)
            assert await img.read(5000, len(payload)) == payload
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_rbd_shrink_then_grow_reads_zeros():
    """Shrinking must not let old bytes resurface after a later grow
    (dead object sets removed, partial tail zeroed)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rz", "replicated",
                                            pg_num=8, size=2)
            rbd = RBD(client.ioctx(pool))
            await rbd.create("img", size=1 << 16, stripe_unit=4096,
                             stripe_count=2, object_size=16384)
            img = await rbd.open("img")
            await img.write(0, b"A" * (1 << 16))
            await img.resize(20000)
            await img.resize(1 << 16)
            assert await img.read(20000, 4096) == b"\0" * 4096
            assert await img.read(40000, 100) == b"\0" * 100
            assert await img.read(0, 100) == b"A" * 100
        finally:
            await cluster.stop()

    run_both_clients(scenario)


# -- the cases of tests/test_rbd_snaps.py -------------------------------------

def test_rbd_snapshot_point_in_time_read():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rbds", "replicated",
                                            pg_num=8, size=2)
            rbd = RBD(client.ioctx(pool))
            await rbd.create("img", size=1 << 20, stripe_unit=4096,
                             stripe_count=2, object_size=16384)
            img = await rbd.open("img")
            v1 = bytes(range(256)) * 256            # 64 KiB
            await img.write(8192, v1)
            sid = await img.snap_create("s1")
            assert img.snap_list() == {"s1": sid}
            await img.write(12000, b"Y" * 30000)
            head = await img.read(8192, len(v1))
            assert head[12000 - 8192:12000 - 8192 + 30000] == b"Y" * 30000
            assert await img.read(8192, len(v1), snap_name="s1") == v1
            await img.write(200000, b"Z" * 5000)
            assert await img.read(200000, 5000, snap_name="s1") == \
                b"\0" * 5000
            assert await img.read(200000, 5000) == b"Z" * 5000
            return sid
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_rbd_snapshot_on_ec_pool():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "rbdecs", "erasure", pg_num=8,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            rbd = RBD(client.ioctx(pool))
            await rbd.create("eimg", size=1 << 20, stripe_unit=8192,
                             stripe_count=1, object_size=32768)
            img = await rbd.open("eimg")
            v1 = b"ec-snap-payload!" * 2048          # 32 KiB
            await img.write(0, v1)
            await img.snap_create("es1")
            await img.write(0, b"N" * len(v1))
            assert await img.read(0, len(v1)) == b"N" * len(v1)
            assert await img.read(0, len(v1), snap_name="es1") == v1
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_rbd_clone_and_copyup():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rbdc", "replicated",
                                            pg_num=8, size=2)
            rbd = RBD(client.ioctx(pool))
            await rbd.create("parent", size=1 << 20, stripe_unit=4096,
                             stripe_count=1, object_size=16384)
            parent = await rbd.open("parent")
            base = bytes(range(256)) * 128           # 32 KiB
            await parent.write(0, base)
            await parent.snap_create("gold")
            await parent.write(0, b"P" * 1000)

            await rbd.clone("parent", "gold", "child")
            child = await rbd.open("child")
            assert child.size() == 1 << 20
            assert await child.read(0, len(base)) == base
            await child.write(100, b"c" * 50)
            got = await child.read(0, 16384)
            expect = bytearray(base[:16384])
            expect[100:150] = b"c" * 50
            assert got == bytes(expect)
            assert await parent.read(0, 150, snap_name="gold") == base[:150]
            assert (await parent.read(0, 1000)) == b"P" * 1000
            await child.write(500000, b"only-child" * 10)
            assert await child.read(500000, 100) == b"only-child" * 10
            return child.header.parent, sorted(
                c for c, _ in parent.header.children.get("gold", []))
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_rbd_snap_remove_triggers_trim():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rbdt", "replicated",
                                            pg_num=8, size=2)
            rbd = RBD(client.ioctx(pool))
            await rbd.create("timg", size=1 << 20)
            img = await rbd.open("timg")
            await img.write(0, b"A" * 4096)
            await img.snap_create("t1")
            await img.write(0, b"B" * 4096)
            assert await img.read(0, 4096, snap_name="t1") == b"A" * 4096
            await img.snap_remove("t1")
            assert img.snap_list() == {}
            with pytest.raises(KeyError):
                await img.read(0, 10, snap_name="t1")
            assert await img.read(0, 4096) == b"B" * 4096
        finally:
            await cluster.stop()

    run_both_clients(scenario)
