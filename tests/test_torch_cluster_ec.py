"""The port's OSD cluster against ``ceph_tpu``'s on the erasure-code
families and on scrub: the cases of ``tests/test_cluster_ec_families.py``
and ``tests/test_cluster_scrub.py``, each run on both packages through
``tests/test_torch_cluster.run_both`` (equal returns, reads and stored
objects), and the mesh seam: an ISA pool behind ``osd_ec_mesh="on"`` on
eight CPU slots stores the shards it stores with the seam off.
"""

import asyncio

from tests._flaky import contention_retry
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, PORT, _port_lockdep_reset, run, run_both, store_objects)


# -- the cases of tests/test_cluster_ec_families.py -----------------------------

def _coll(pgid):
    return f"pg_{pgid.pool}_{pgid.seed}"

@contention_retry()
def test_lrc_pool_end_to_end():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(8)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "lrcp", "erasure", pg_num=4,
                ec_profile={"plugin": "lrc", "k": "4", "m": "2", "l": "3"})
            io = client.ioctx(pool)
            payload = b"lrc-payload" * 400
            await io.write_full("obj", payload, timeout=120)
            assert await io.read("obj", timeout=120) == payload

            # kill a shard holder; degraded read must still work
            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            victim = next(o for o in acting if o != primary and o >= 0)
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)
            assert await io.read("obj", timeout=60) == payload
        finally:
            await cluster.stop()

    run_both(scenario)

def test_shec_pool_parity_shard_loss_recovers():
    """Losing a PARITY shard of a shec pool re-protects via the batched
    parity-recovery path (reference ErasureCodeShec.cc:526-756)."""
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()
        # 8 osds for 7 shards: a replacement member must exist after the
        # parity holder dies, or CRUSH can never fill the hole
        cluster = await start_cluster(8, config=cfg)
        try:
            client = await cluster.client()
            profile = {"plugin": "shec", "k": "4", "m": "3", "c": "2"}
            pool = await client.pool_create("shecp", "erasure", pg_num=4,
                                            ec_profile=dict(profile))
            io = client.ioctx(pool)
            payload = b"shec-payload" * 300
            await io.write_full("obj", payload, timeout=120)
            assert await io.read("obj", timeout=120) == payload

            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            k = 4
            # shard ids follow acting positions; pick a parity holder
            parity_holders = [o for i, o in enumerate(acting)
                              if i >= k and o >= 0 and o != primary]
            victim = parity_holders[0]
            await cluster.kill_osd(victim)
            await cluster.wait_down(victim)

            # degraded read (parity loss doesn't block data)
            assert await io.read("obj", timeout=60) == payload

            # after auto-out + remap, recovery must rebuild the parity
            # shard on the replacement member (batched parity decode)
            deadline = asyncio.get_event_loop().time() + 20
            reprotected = False
            while asyncio.get_event_loop().time() < deadline:
                _, _, acting2, _ = \
                    cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
                live = [o for o in acting2 if o >= 0 and o in cluster.osds]
                if victim not in acting2 and len(live) == len(acting):
                    holders = 0
                    for i, o in enumerate(acting2):
                        if o < 0 or o not in cluster.osds:
                            continue
                        osd = cluster.osds[o]
                        if osd.store.stat(_coll(pgid), "obj") is not None:
                            holders += 1
                    if holders == len(acting):
                        reprotected = True
                        break
                await asyncio.sleep(0.2)
            assert reprotected, "shec parity shard was never rebuilt"
            unrecoverable = sum(o.perf.get("osd_unrecoverable")
                                for o in cluster.osds.values())
            assert unrecoverable == 0
            assert await io.read("obj", timeout=60) == payload
        finally:
            await cluster.stop()

    run_both(scenario)

def test_jerasure_cauchy_pool_end_to_end():
    """A packet-interleaved bit-matrix codec through the cluster stripe
    path (batch layout consistent with single-stripe encode)."""
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()
        # stripe unit must be a multiple of w*packetsize for the packet
        # layout; choose packetsize = 64 -> 8*64 = 512 divides 4096
        cluster = await start_cluster(4, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "cauchyp", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure", "technique": "cauchy_good",
                            "k": "2", "m": "1", "packetsize": "64"})
            io = client.ioctx(pool)
            payload = b"cauchy-bytes" * 500
            await io.write_full("obj", payload, timeout=120)
            assert await io.read("obj", timeout=120) == payload
            # partial overwrite through the RMW path
            await io.write("obj", b"PATCH" * 100, offset=1000, timeout=120)
            expect = bytearray(payload)
            expect[1000:1000 + 500] = b"PATCH" * 100
            assert await io.read("obj", timeout=120) == bytes(expect)
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the cases of tests/test_cluster_scrub.py ---------------------------------------

def _corrupt(store, coll, oid, at=3):
    """Flip a byte directly in the backing store: silent corruption the
    transaction/version layer never sees (qa EIO-injection analog)."""
    store._colls[coll][oid].data[at] ^= 0xFF

async def _converge(cond, timeout=10.0):
    """Wall-deadline converge-poll: replica/shard applies land
    asynchronously after the ack — wait for the state, not a guessed
    duration.  The caller asserts the condition afterwards."""
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        try:
            if cond():
                return
        except Exception:
            pass
        await asyncio.sleep(0.02)

def test_scrub_detects_and_repairs_replica_corruption():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("sp", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            payload = b"scrub-me" * 200
            await io.write_full("obj", payload)

            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            await _converge(lambda: all(
                cluster.osds[o].store.read(_coll(pgid), "obj") ==
                bytes(payload) for o in acting))
            victim = next(o for o in acting if o != primary)
            _corrupt(cluster.osds[victim].store, _coll(pgid), "obj")
            assert cluster.osds[victim].store.read(
                _coll(pgid), "obj") != payload

            st = cluster.osds[primary].pgs[pgid]
            report = await cluster.osds[primary].scrub_pg(st)
            assert report["inconsistent"] == ["obj"]
            assert report["repaired"] == ["obj"]
            await _converge(lambda: cluster.osds[victim].store.read(
                _coll(pgid), "obj") == bytes(payload))
            # repaired WITHOUT any client read
            assert cluster.osds[victim].store.read(
                _coll(pgid), "obj") == bytes(payload)
            # clean scrub afterwards
            report = await cluster.osds[primary].scrub_pg(st)
            assert report["inconsistent"] == []
        finally:
            await cluster.stop()

    run_both(scenario)

def test_scrub_detects_and_repairs_primary_corruption():
    """The primary itself can be the divergent copy: majority wins."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("sp2", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            payload = b"primary-corrupt" * 100
            await io.write_full("obj", payload)

            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            await _converge(lambda: all(
                cluster.osds[o].store.read(_coll(pgid), "obj") ==
                bytes(payload) for o in acting))
            _corrupt(cluster.osds[primary].store, _coll(pgid), "obj")

            st = cluster.osds[primary].pgs[pgid]
            report = await cluster.osds[primary].scrub_pg(st)
            assert report["inconsistent"] == ["obj"]
            await _converge(lambda: cluster.osds[primary].store.read(
                _coll(pgid), "obj") == bytes(payload))
            assert cluster.osds[primary].store.read(
                _coll(pgid), "obj") == bytes(payload)
        finally:
            await cluster.stop()

    run_both(scenario)

def test_scrub_repairs_corrupt_ec_shard():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(4)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "esp", "erasure", pg_num=8,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            io = client.ioctx(pool)
            payload = b"ec-scrub" * 300
            await io.write_full("obj", payload, timeout=60)

            pgid = client.objecter.object_pgid(pool, "obj")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            await _converge(lambda: all(
                cluster.osds[o].store.read(_coll(pgid), "obj")
                for o in acting if o >= 0 and o in cluster.osds))
            victim = next(o for o in acting
                          if o >= 0 and o != primary
                          and o in cluster.osds)
            before = bytes(cluster.osds[victim].store.read(
                _coll(pgid), "obj"))
            _corrupt(cluster.osds[victim].store, _coll(pgid), "obj")

            st = cluster.osds[primary].pgs[pgid]
            report = await cluster.osds[primary].scrub_pg(st)
            assert report["inconsistent"] == ["obj"]
            assert report["repaired"] == ["obj"]
            # repair lands asynchronously on the victim: converge-poll
            # against a wall deadline instead of a fixed sleep
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                if bytes(cluster.osds[victim].store.read(
                        _coll(pgid), "obj")) == before:
                    break
                await asyncio.sleep(0.05)
            after = bytes(cluster.osds[victim].store.read(
                _coll(pgid), "obj"))
            assert after == before
            assert await io.read("obj", timeout=60) == payload
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the mesh seam ------------------------------------------------------------


def test_isa_pool_behind_the_mesh_seam_stores_the_same_shards(monkeypatch):
    """``osd_ec_mesh="on"`` routes an ISA pool's batch encode and decode
    through ``parallel.engine.MeshCodecAdapter`` over eight ``"cpu"``
    slots: the shards every store holds, after writes, an RMW and a
    degraded read, equal those of the same pool with the seam off (both
    byte-at-rest: the adapter hides the planar entry points)."""
    from ceph_tpu_torch.parallel.engine import MeshCodecAdapter

    calls = {"encode_batch": 0, "decode_batch": 0}
    for name in calls:
        def spy(self, *args, _orig=getattr(MeshCodecAdapter, name),
                _name=name, **kwargs):
            calls[_name] += 1
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(MeshCodecAdapter, name, spy)

    async def scenario(mesh: str):
        start_cluster = PORT.imp("cluster.vstart.start_cluster")
        cfg = PORT.imp("cluster.vstart._fast_config")()
        cfg.osd_ec_planar_at_rest = 0
        cfg.osd_ec_mesh = mesh
        cluster = await start_cluster(6, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "isa", "erasure", pg_num=8,
                ec_profile={"plugin": "isa", "k": "4", "m": "2"})
            io = client.ioctx(pool)
            rng = __import__("numpy").random.default_rng(5)
            objs = {f"o{i}": rng.integers(0, 256, 3000 + 4096 * i,
                                          dtype="uint8").tobytes()
                    for i in range(6)}
            for oid, data in objs.items():
                await io.write_full(oid, data)
            await io.write("o2", b"patch" * 300, offset=777)
            want = bytearray(objs["o2"])
            want[777:777 + 1500] = b"patch" * 300
            objs["o2"] = bytes(want)
            for oid, data in objs.items():
                assert await io.read(oid) == data
            codecs = [c for o in cluster.osds.values()
                      for c in o._codecs.values()]
            assert codecs and all(
                isinstance(c, MeshCodecAdapter) == (mesh == "on")
                for c in codecs)
            if mesh == "on":
                assert {len(c._mesh_engine.mesh.distinct())
                        for c in codecs} == {1}
            shards = store_objects(cluster)
            assert {s[3] for s in shards} == {None}
            assert len(shards) == 6 * 6
            pgid = client.objecter.object_pgid(pool, "o3")
            _, _, acting, _ = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            await cluster.kill_osd(acting[0])
            await cluster.wait_down(acting[0])
            assert await io.read("o3") == objs["o3"]
            return shards
        finally:
            await cluster.stop()

    off = run(scenario("off"))
    assert calls == {"encode_batch": 0, "decode_batch": 0}
    on = run(scenario("on"))
    assert on == off
    assert calls["encode_batch"] > 0 and calls["decode_batch"] > 0


# -- a rebuild for a member the map moved -----------------------------------


def test_ec_rebuild_for_a_member_the_map_moved_is_incomplete():
    """The port's ``_recover_ec_object`` (a deliberate difference from the
    reference, which counts such a rebuild done): a target that holds no
    slot of acting when the shards are pushed, because the map moved it
    while they were gathered, gets nothing and the rebuild returns False,
    so a backfill does not ``log_sync`` a member that lacks the object.
    A pg_temp handoff member outside acting gets the shard of its slot in
    up."""
    import copy

    from ceph_tpu_torch.cluster.store import Transaction
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    def blob(store, coll, oid):
        if store.stat(coll, oid) is None:
            return None
        if store.object_layout(coll, oid) == "planar8":
            return store.read_planar(coll, oid)
        return store.read(coll, oid)

    async def scenario():
        start_cluster = PORT.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(
            6, config=PORT.imp("cluster.vstart._fast_config")())
        try:
            client = await cluster.client()
            pool_id = await client.pool_create(
                "isa", "erasure", pg_num=8,
                ec_profile={"plugin": "isa", "k": "4", "m": "2"})
            data = bytes(range(256)) * 40
            await client.ioctx(pool_id).write_full("o", data)
            pgid = client.objecter.object_pgid(pool_id, "o")
            _, _, acting, primary_id = \
                cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
            primary = cluster.osds[primary_id]
            st = primary.pgs[pgid]
            pool = primary.osdmap.pools[pool_id]
            slot = next(i for i, o in enumerate(acting) if o != primary_id)
            victim = cluster.osds[acting[slot]]
            coll = _coll(pgid)
            want = blob(victim.store, coll, "o")
            assert want is not None
            victim.store.queue_transaction(Transaction().remove(coll, "o"))
            holes = [CRUSH_ITEM_NONE if i == slot else o
                     for i, o in enumerate(acting)]

            pushes = primary.perf.get("osd_pushes_sent")
            moved = copy.copy(st)
            moved.acting, moved.up = list(holes), list(holes)
            assert not await primary._recover_ec_object(
                pool, moved, "o", targets=[victim.osd_id])
            assert primary.perf.get("osd_recovery_target_moved") == 1
            assert primary.perf.get("osd_pushes_sent") == pushes
            assert blob(victim.store, coll, "o") is None

            handoff = copy.copy(st)
            handoff.acting, handoff.up = list(holes), list(acting)
            assert await primary._recover_ec_object(
                pool, handoff, "o", targets=[victim.osd_id])
            await _converge(
                lambda: blob(victim.store, coll, "o") is not None)
            assert blob(victim.store, coll, "o") == want
            assert int(victim.store.getattr(coll, "o", "shard")) == slot
            assert await client.ioctx(pool_id).read("o") == data
        finally:
            await cluster.stop()

    run(scenario())
