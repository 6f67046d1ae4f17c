"""The port's OSD cluster against ``ceph_tpu``'s on cache tiering, PG
split, log rewind and dedup fencing: the cases of ``tests/test_tiering.py``,
``tests/test_pg_split.py``, ``tests/test_rewind.py`` (not its slow
thrash case) and ``tests/test_dedup_fencing.py``, each run on both
packages through ``tests/test_torch_cluster.run_both``.
"""

import asyncio
import importlib

import pytest

from tests._flaky import contention_retry
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset, digest, run_both)


# -- the cases of tests/test_tiering.py ---------------------------------------

async def _setup(cluster, base_kind="erasure"):
    client = await cluster.client()
    if base_kind == "erasure":
        base = await client.pool_create(
            "base", "erasure", pg_num=4,
            ec_profile={"plugin": "jerasure",
                        "technique": "reed_sol_van",
                        "k": "2", "m": "1"})
    else:
        base = await client.pool_create("base", "replicated",
                                        pg_num=4, size=2)
    cache = await client.pool_create("cache", "replicated",
                                     pg_num=4, size=2)
    await client.tier_add("base", "cache")
    await client.tier_cache_mode("cache", "writeback")
    await client.tier_set_overlay("base", "cache")
    return client, base, cache

def _pool_objects(cluster, pool_id):
    """Union of client-visible objects across every OSD's collections
    for a pool."""
    from ceph_tpu.cluster import snaps as snapmod

    out = set()
    for osd in cluster.osds.values():
        for coll in osd.store.list_collections():
            if not coll.startswith(f"pg_{pool_id}_"):
                continue
            for name in osd.store.list_objects(coll):
                if name.startswith("_") or snapmod.is_snap_key(name):
                    continue
                out.add(name)
    return out

@contention_retry()
def test_writeback_promote_flush_evict():
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, config=_fast_config())
        try:
            client, base, cache = await _setup(cluster)
            bio = client.ioctx(base)  # ops redirect through the overlay

            # 1. writes land in the CACHE pool (writeback)
            payload = b"tiered-payload " * 200
            await bio.write_full("hot", payload)
            assert await bio.read("hot") == payload
            assert "hot" in _pool_objects(cluster, cache)
            assert "hot" not in _pool_objects(cluster, base)

            # 2. the agent flushes the dirty object to the base
            for _ in range(300):
                if "hot" in _pool_objects(cluster, base):
                    break
                await asyncio.sleep(0.1)
            assert "hot" in _pool_objects(cluster, base), "never flushed"
            assert await bio.read("hot") == payload

            # 3. eviction: cap the cache and write enough cold objects
            await client.pool_set("cache", "target_max_objects", 4)
            for i in range(12):
                await bio.write_full(f"cold-{i}", b"c" * 512)
            for _ in range(400):
                if len(_pool_objects(cluster, cache)) <= 8:
                    break
                await asyncio.sleep(0.1)
            assert len(_pool_objects(cluster, cache)) <= 8, \
                _pool_objects(cluster, cache)
            # every object still reads back (from cache or via promote)
            for i in range(12):
                assert await bio.read(f"cold-{i}", timeout=60) \
                    == b"c" * 512

            # 4. promote-on-read: read an object that was evicted from
            # the cache — it must come back via promotion and land there
            evicted = sorted(
                _pool_objects(cluster, base) -
                _pool_objects(cluster, cache))
            if evicted:
                target = evicted[0]
                assert await bio.read(target, timeout=60) is not None
                assert target in _pool_objects(cluster, cache), \
                    "read miss did not promote"

            # 5. delete-through: removing via the overlay removes BOTH
            await bio.remove("hot")
            with pytest.raises((IOError, FileNotFoundError)):
                await bio.read("hot", timeout=15)
            # converge-poll: the write-through delete of the base copy
            # lands asynchronously behind the overlay ack
            deadline = asyncio.get_event_loop().time() + 15.0
            while asyncio.get_event_loop().time() < deadline:
                if "hot" not in _pool_objects(cluster, base) and \
                        "hot" not in _pool_objects(cluster, cache):
                    break
                await asyncio.sleep(0.05)
            assert "hot" not in _pool_objects(cluster, base)
            assert "hot" not in _pool_objects(cluster, cache)
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_readproxy_and_forward_modes():
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, config=_fast_config())
        try:
            client, base, cache = await _setup(cluster)
            bio = client.ioctx(base)
            await bio.write_full("obj", b"payload-1")
            # flush it to the base, then drop the cache copy via drain
            await client.tier_cache_mode("cache", "forward")
            for _ in range(300):
                if "obj" in _pool_objects(cluster, base) and \
                        "obj" not in _pool_objects(cluster, cache):
                    break
                await asyncio.sleep(0.1)
            assert "obj" in _pool_objects(cluster, base)
            assert "obj" not in _pool_objects(cluster, cache)
            # forward mode: reads work, nothing re-enters the cache
            assert await bio.read("obj") == b"payload-1"
            assert "obj" not in _pool_objects(cluster, cache)

            # readproxy: reads proxy to the base WITHOUT promoting;
            # writes still land in the cache
            await client.tier_cache_mode("cache", "readproxy")
            assert await bio.read("obj") == b"payload-1"
            assert "obj" not in _pool_objects(cluster, cache)
            await bio.write_full("obj2", b"payload-2")
            assert "obj2" in _pool_objects(cluster, cache)
            assert await bio.read("obj2") == b"payload-2"

            # remove-overlay: traffic goes straight to the base again
            await client.tier_remove_overlay("base")
            assert await bio.read("obj") == b"payload-1"
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_tiering_survives_cache_primary_kill():
    """Thrash: dirty objects in the cache survive a cache-primary kill —
    the replicated dirty flag lets the new primary flush them."""
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3, config=_fast_config())
        try:
            client, base, cache = await _setup(cluster)
            bio = client.ioctx(base)
            payloads = {f"o{i}": (b"D%d" % i) * 300 for i in range(6)}
            for k, v in payloads.items():
                await bio.write_full(k, v)
            # kill one OSD serving the cache pool
            pgid = client.objecter.object_pgid(cache, "o0")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            await cluster.osds[primary].stop()
            # everything still reads back and eventually flushes
            for k, v in payloads.items():
                assert await bio.read(k, timeout=90) == v, k
            for _ in range(600):
                if all(k in _pool_objects(cluster, base)
                       for k in payloads):
                    break
                await asyncio.sleep(0.1)
            assert all(k in _pool_objects(cluster, base)
                       for k in payloads), "flush stalled after kill"
        finally:
            await cluster.stop()

    run_both(scenario)

def test_tier_command_validation():
    async def scenario(P):
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2, config=_fast_config())
        try:
            client = await cluster.client()
            await client.pool_create("b1", "replicated", pg_num=4, size=2)
            await client.pool_create("c1", "replicated", pg_num=4, size=2)
            await client.pool_create("c2", "replicated", pg_num=4, size=2)
            await client.tier_add("b1", "c1")
            # a tier cannot itself get a tier; a pool can't tier twice
            with pytest.raises(RuntimeError):
                await client.tier_add("c1", "c2")
            with pytest.raises(RuntimeError):
                await client.tier_add("b1", "c1")
            # overlay must be a registered tier
            with pytest.raises(RuntimeError):
                await client.tier_set_overlay("b1", "c2")
            await client.tier_set_overlay("b1", "c1")
            # cannot remove an active overlay tier
            with pytest.raises(RuntimeError):
                await client.tier_remove("b1", "c1")
            await client.tier_remove_overlay("b1")
            await client.tier_remove("b1", "c1")
            p = client.objecter.osdmap.pools
            assert all(not po.is_tier() and not po.tiers
                       for po in p.values())
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the cases of tests/test_pg_split.py --------------------------------------

@contention_retry(attempts=4)
def test_pg_split_doubles_under_load_and_scrubs_clean():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        PGid = P.imp("osdmap.osdmap.PGid")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("split", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            objs = {f"obj-{i}": (b"payload-%d " % i) * 50
                    for i in range(24)}
            for k, v in objs.items():
                await io.write_full(k, v)
            # snapshot + overwrite so clones must follow their heads
            await io.snap_create("before")
            await io.write_full("obj-0", b"after-snap")

            async def writer():
                for i in range(10):
                    await io.write_full(f"live-{i}", b"during-split")
                    await asyncio.sleep(0.01)

            wtask = asyncio.get_event_loop().create_task(writer())
            await client.pool_set("split", "pg_num", 8)
            await wtask
            p = client.objecter.osdmap.pools[pool]
            assert p.pg_num == 8 and p.pgp_num == 4
            # wait until every OSD has advanced to the split map (fixed
            # sleeps flake on a loaded one-core host)
            for _ in range(300):
                if all(o.osdmap.pools[pool].pg_num == 8
                       for o in cluster.osds.values() if not o._stopped):
                    break
                await asyncio.sleep(0.1)

            # every object still reads back
            for k, v in objs.items():
                want = b"after-snap" if k == "obj-0" else v
                assert await io.read(k, timeout=60) == want, k
            for i in range(10):
                assert await io.read(f"live-{i}", timeout=60) \
                    == b"during-split"
            # snap read resolves through the split
            snapid = client.objecter.osdmap.pools[pool].snaps
            sid = next(s for s, n in snapid.items() if n == "before")
            assert await io.read("obj-0", snapid=sid) == objs["obj-0"]

            # child PGs actually exist and hold objects
            seeds = {client.objecter.object_pgid(pool, k).seed
                     for k in objs}
            assert any(s >= 4 for s in seeds), "no object maps to a child"

            # scrub every PG clean on its primary
            for seed in range(8):
                pgid = PGid(pool, seed)
                _, _, acting, primary = \
                    client.objecter.osdmap.pg_to_up_acting_osds(pgid)
                st = cluster.osds[primary].pgs.get(pgid)
                if st is None:
                    continue
                report = await cluster.osds[primary].scrub_pg(st)
                assert report["inconsistent"] == [], (seed, report)

            # now move placements: pgp_num follows, children remap and
            # recover; data survives
            await client.pool_set("split", "pgp_num", 8)
            for _ in range(300):
                if all(o.osdmap.pools[pool].pgp_num == 8
                       for o in cluster.osds.values() if not o._stopped):
                    break
                await asyncio.sleep(0.1)
            for k, v in objs.items():
                want = b"after-snap" if k == "obj-0" else v
                assert await io.read(k, timeout=60) == want, k
            assert client.objecter.osdmap.pools[pool].pgp_num == 8
        finally:
            await cluster.stop()

    run_both(scenario)

def test_pg_num_validation():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2)
        try:
            client = await cluster.client()
            pool = await client.pool_create("v", "replicated",
                                            pg_num=4, size=2)
            with pytest.raises(RuntimeError):
                await client.pool_set("v", "pg_num", 4)     # no shrink/same
            with pytest.raises(RuntimeError):
                await client.pool_set("v", "pg_num", 2)
            with pytest.raises(RuntimeError):
                await client.pool_set("v", "pgp_num", 9)    # > pg_num
            ec = await client.pool_create(
                "ev", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van",
                            "k": "2", "m": "1"})
            with pytest.raises(RuntimeError):
                await client.pool_set("ev", "pg_num", 8)    # EC refused
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_osd_down_across_split_splits_on_resume():
    """An OSD that missed the pg_num bump must split its parent
    collections when it rejoins (the split watermark persists on the
    PGMETA object, not in daemon memory)."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rsplit", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            for i in range(20):
                await io.write_full(f"r-{i}", b"resume-%d" % i)
            victim = next(iter(cluster.osds))
            await cluster.osds[victim].stop()
            await client.pool_set("rsplit", "pg_num", 8)
            # converge-poll: the SURVIVING daemons learn the split map
            # and split their collections before the victim resumes
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 15.0
            while loop.time() < deadline:
                if all(o.osdmap.pools.get(pool) is not None and
                       o.osdmap.pools[pool].pg_num == 8
                       for o in cluster.osds.values()
                       if o.osd_id != victim):
                    break
                await asyncio.sleep(0.05)
            osd = await cluster.restart_osd(victim)
            # wait for the resumed OSD to advance to the split map
            for _ in range(300):
                if osd.osdmap.pools.get(pool) is not None and \
                        osd.osdmap.pools[pool].pg_num == 8:
                    break
                await asyncio.sleep(0.1)

            PGMETA = P.imp("cluster.pg.PGMETA")
            PGRB = P.imp("cluster.pg.PGRB")
            _coll = P.imp("cluster.pg._coll")
            str_hash_rjenkins = P.imp("ops.jenkins.str_hash_rjenkins")
            ceph_stable_mod = P.imp("osdmap.osdmap.ceph_stable_mod")

            def _no_stranded() -> bool:
                # collection splits run asynchronously after the map
                # advance — converge on the final no-child-objects-in-
                # parent condition, then assert it below
                p = osd.osdmap.pools[pool]
                for coll in osd.store.list_collections():
                    if not coll.startswith(f"pg_{pool}_"):
                        continue
                    seed = int(coll.split("_")[2])
                    for name in osd.store.list_objects(coll):
                        if name in (PGMETA, PGRB):
                            continue
                        want = ceph_stable_mod(
                            str_hash_rjenkins(name.encode()),
                            p.pg_num, p.pg_num_mask)
                        if want != seed:
                            return False
                return True

            deadline = loop.time() + 15.0
            while not _no_stranded() and loop.time() < deadline:
                await asyncio.sleep(0.05)
            for i in range(20):
                assert await io.read(f"r-{i}", timeout=60) \
                    == b"resume-%d" % i
            # the resumed OSD's parent collections hold no child objects
            p = osd.osdmap.pools[pool]
            for coll in osd.store.list_collections():
                if not coll.startswith(f"pg_{pool}_"):
                    continue
                seed = int(coll.split("_")[2])
                for name in osd.store.list_objects(coll):
                    if name in (PGMETA, PGRB):
                        continue
                    want = ceph_stable_mod(
                        str_hash_rjenkins(name.encode()),
                        p.pg_num, p.pg_num_mask)
                    assert want == seed, \
                        f"{name} stranded in {coll} (belongs to {want})"
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the cases of tests/test_rewind.py ----------------------------------------

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}

def _shard_crc(osd, coll, oid):
    """A fingerprint of the shard's bytes."""
    return digest(osd.store.read(coll, oid))

@contention_retry()
def test_ec_partial_write_rolls_back():
    """Primary applies its shard + log entry but the sub-writes never
    reach the replicas (crash mid-write).  Peering must elect the
    replicas' shorter log (min-rule) and REWIND the primary's divergent
    entry, restoring its pre-write shard bytes exactly (verified via
    per-shard crc), not copy objects around."""
    async def scenario(P):
        M = P.imp("cluster.messages")
        PGRB = P.imp("cluster.pg.PGRB")
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()
        cfg.osd_client_op_timeout = 1.0   # the doomed write times out fast
        # load-deflake: under suite load a starved event loop
        # misses heartbeats/beacons, a false down-mark churns the map,
        # and peering rewinds the divergent entry EARLY — racing the
        # intermediate asserts below (seen as last_update "never
        # advancing": it had already been rewound).  Generous graces pin
        # peering to the explicit _recover_pg call; the invariants
        # stay strict.
        cfg.osd_heartbeat_grace = 30.0
        cfg.mon_osd_beacon_grace = 30.0
        # ... and pin BACKGROUND recovery out of the window too: an
        # incomplete boot-time round arms a delayed retry that can
        # fire mid-doomed-write and rewind the divergent entry before
        # the intermediate asserts observe it.  The test drives peering explicitly.
        cfg.osd_recovery_delay_start = 300.0
        cluster = await start_cluster(3, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rwnd", "erasure", pg_num=4,
                                            ec_profile=dict(EC_PROFILE))
            io = client.ioctx(pool)
            v1 = bytes(range(256)) * 32
            await io.write_full("victim", v1)

            pgid = client.objecter.object_pgid(pool, "victim")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            # converge-poll (not a fixed beat): every member's shard
            # apply must land before the crc/log snapshot below
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline and \
                    any(cluster.osds[o].store.stat(coll, "victim")
                        is None for o in acting):
                await asyncio.sleep(0.05)
            posd = cluster.osds[primary]
            st = posd.pgs[pgid]
            lu_before = st.last_update
            crc_before = _shard_crc(posd, coll, "victim")

            # crash-mid-write model: the sub-writes VANISH (sent into the
            # void, no error) — exactly what a primary death after the
            # local apply looks like; the op times out un-acked
            orig_send = posd._send_osd

            async def drop_subwrites(osd, msg):
                if isinstance(msg, M.MOSDECSubOpWrite):
                    return  # swallowed: replicas never see it
                return await orig_send(osd, msg)

            posd._send_osd = drop_subwrites
            pobj = posd.osdmap.pools[pool]
            r = await posd._op_write_full(pobj, st, "victim", b"Z" * 8192)
            posd._send_osd = orig_send
            assert r == -110, "doomed write must time out un-acked"
            # local shard applied + logged, replicas never saw it
            assert st.last_update > lu_before
            assert _shard_crc(posd, coll, "victim") != crc_before
            assert st.last_complete < st.last_update
            rb = posd.store.omap_get(coll, PGRB)
            assert rb, "no rollback record captured for the shard write"

            # peering (what the restarted primary runs): the replicas'
            # log wins under the EC min-rule; our entry rewinds
            await posd._recover_pg(st)
            assert st.last_update == lu_before, "divergent entry survived"
            assert _shard_crc(posd, coll, "victim") == crc_before, \
                "rewind did not restore the pre-write shard bytes"
            # the object still reads back as v1 for clients
            assert await io.read("victim", timeout=60) == v1
        finally:
            await cluster.stop()

    run_both(scenario)

def test_ec_divergent_replica_rewinds_on_instruction():
    """A REPLICA holding a divergent entry (it applied a sub-write the
    other members never got, then the primary's log moved on without it)
    is rolled back by the primary's rewind instruction during peering."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rwnd2", "erasure", pg_num=4,
                                            ec_profile=dict(EC_PROFILE))
            io = client.ioctx(pool)
            v1 = b"stable-state" * 100
            await io.write_full("obj", v1)
            pgid = client.objecter.object_pgid(pool, "obj")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            # converge-poll: the replica's shard + log entry must land
            # before crc_before/lu snapshot below (fixed beat flaked)
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline and \
                    any(cluster.osds[o].store.stat(coll, "obj") is None
                        for o in acting):
                await asyncio.sleep(0.05)
            replica = next(o for o in acting if o != primary)
            rosd = cluster.osds[replica]
            rst = rosd.pgs[pgid]
            crc_before = _shard_crc(rosd, coll, "obj")
            lu = rst.last_update

            # forge a divergent sub-write on the replica only (the shard
            # apply + entry the reference's crashed primary would have
            # fanned out to just this member)
            fake_v = (rosd.osdmap.epoch, lu[1] + 1)
            shard = int(rosd.store.getattr(coll, "obj", "shard"))
            rosd._apply_shard(pgid, "obj", shard, b"G" * 1024, 0, 1024,
                              {"size": 2048, "version": fake_v[1]})
            rosd._log_mutation(rst, "modify", "obj", fake_v)
            assert rst.last_update == fake_v
            assert _shard_crc(rosd, coll, "obj") != crc_before

            # primary peers: sees the replica ahead, instructs rewind
            posd = cluster.osds[primary]
            await posd._recover_pg(posd.pgs[pgid])
            for _ in range(50):
                if rst.last_update == lu:
                    break
                await asyncio.sleep(0.1)
            assert rst.last_update == lu, "replica kept divergent entry"
            assert _shard_crc(rosd, coll, "obj") == crc_before, \
                "replica shard bytes not restored"
            assert await io.read("obj", timeout=60) == v1
        finally:
            await cluster.stop()

    run_both(scenario)

def test_stale_primary_shard_serves_committed_group():
    """A primary whose OWN shard is a stale older generation — the state
    an interrupted recovery pull leaves behind when no further map
    change retriggers peering — must serve reads from the newest
    COMMITTED shard group at the GROUP's size, never the group's bytes
    truncated to the local size attr (graft-chaos: obj read back as g2
    bytes at g1's length).  Scrub must then flag + rebuild the stale
    shard even though its crc is self-consistent.

    automatic READ-repair would heal the stale shard before
    the scrub half of this test could see it (that path has its own
    coverage in tests/test_integrity.py), so this anchor runs with
    osd_read_repair=0 — detection-only — to keep exercising the scrub
    generation-divergence machinery."""
    async def scenario(P):
        Transaction = P.imp("cluster.store.Transaction")
        _fast_config = P.imp("cluster.vstart._fast_config")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cfg = _fast_config()
        cfg.osd_read_repair = 0
        cluster = await start_cluster(4, config=cfg)
        try:
            client = await cluster.client()
            pool = await client.pool_create("stale", "erasure", pg_num=4,
                                            ec_profile=dict(EC_PROFILE))
            io = client.ioctx(pool)
            g1 = b"g1-" * 340                 # 1020 bytes
            g2 = b"g2-xyz" * 180              # 1080 bytes
            await io.write_full("obj", g1)
            pgid = client.objecter.object_pgid(pool, "obj")
            coll = f"pg_{pgid.pool}_{pgid.seed}"
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            posd = cluster.osds[primary]
            # capture the primary's complete g1 shard state
            old_bytes = bytes(posd.store.read(coll, "obj"))
            old_attrs = {k: posd.store.getattr(coll, "obj", k)
                         for k in ("shard", "size", "hinfo_crc")}
            old_ver = posd.store.get_version(coll, "obj")
            await io.write_full("obj", g2)    # acked: every shard at g2

            # surgically regress ONLY the primary's shard back to g1
            # (bytes + attrs + version all self-consistent, crc clean)
            txn = (Transaction()
                   .write(coll, "obj", 0, old_bytes)
                   .truncate(coll, "obj", len(old_bytes)))
            for k, v in old_attrs.items():
                txn.setattr(coll, "obj", k, v)
            txn.set_version(coll, "obj", old_ver)
            posd.store.queue_transaction(txn)

            # read must be the committed generation, whole — not g2
            # bytes cut to g1's 1020
            assert await io.read("obj", timeout=60) == g2

            # scrub sees the generation divergence and rebuilds the
            # stale shard from the committed group
            st = posd.pgs[pgid]
            rep = await posd.scrub_pg(st)
            assert "obj" in rep["inconsistent"], \
                "scrub missed the stale (old-generation) shard"
            assert "obj" in rep["repaired"]
            assert posd.store.getattr(coll, "obj", "size") == \
                str(len(g2)).encode()
            assert await io.read("obj", timeout=60) == g2
        finally:
            await cluster.stop()

    run_both(scenario)


# -- the cases of tests/test_dedup_fencing.py ---------------------------------

async def _send_op_raw(objecter, pool_id, oid, ops, reqid):
    """Send one MOSDOp with a FIXED reqid and await its reply — lets a
    test deliver byte-identical duplicates the way a resend does."""
    M = importlib.import_module(
        type(objecter).__module__.replace(".objecter", ".messages"))
    pgid = objecter.object_pgid(pool_id, oid)
    primary = objecter._target_osd(pgid)
    addr = objecter.osdmap.osd_addrs[primary]
    fut = asyncio.get_event_loop().create_future()
    objecter._inflight[reqid] = fut
    await objecter.messenger.send_message(
        M.MOSDOp(reqid=reqid, pgid=pgid, oid=oid, ops=ops,
                 epoch=objecter.osdmap.epoch), tuple(addr))
    return await asyncio.wait_for(fut, timeout=30)

def test_duplicate_exec_returns_cached_reply():
    """A resent non-idempotent exec (inotable.alloc) must not allocate a
    second inode: the dup gets the original reply from the reqid cache."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("meta", "replicated",
                                            pg_num=8, size=2)
            obj = client.objecter
            reqid = (obj.client_name, 999_991)
            ops = [("exec", {"cls": "inotable", "method": "alloc",
                             "indata": b""})]
            r1 = await _send_op_raw(obj, pool, "ino_obj", ops, reqid)
            r2 = await _send_op_raw(obj, pool, "ino_obj", ops, reqid)
            assert r1.result == 0
            assert r2.result == r1.result
            assert r2.data == r1.data, \
                "duplicate exec re-executed: allocated a fresh inode"
            # a genuinely new reqid must still allocate the next inode
            r3 = await _send_op_raw(obj, pool, "ino_obj", ops,
                                    (obj.client_name, 999_992))
            assert r3.data != r1.data
        finally:
            await cluster.stop()

    run_both(scenario)

def test_duplicate_write_and_delete_cached():
    """A resent delete returns the original 0, not -ENOENT."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("dpool", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            obj = client.objecter
            await io.write_full("victim", b"payload")
            reqid = (obj.client_name, 999_993)
            ops = [("delete", {})]
            r1 = await _send_op_raw(obj, pool, "victim", ops, reqid)
            r2 = await _send_op_raw(obj, pool, "victim", ops, reqid)
            assert r1.result == 0
            assert r2.result == 0, \
                f"duplicate delete re-executed -> {r2.result}"
        finally:
            await cluster.stop()

    run_both(scenario)

def test_stale_leader_lease_ignored():
    """A lease carrying an older election epoch must neither refresh the
    peon's lease timer nor flip its forwarding target."""
    async def scenario(P):
        M = P.imp("cluster.messages")
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2, n_mons=3)
        try:
            peon = next(m for m in cluster.mons if not m.is_leader)
            leader_rank = peon.leader_rank
            stale_epoch = peon.elector.epoch - 2
            before = peon._last_lease
            # time-semantic pacing, not a convergence wait: the lease
            # stamp must tick past `before` so the refresh assertion
            # below can distinguish the current-epoch lease landing
            await asyncio.sleep(0.05)  # graftlint: ignore[fixed-sleep-in-tests]
            # forge a lease from a deposed leader (older epoch, rank != now)
            fake_rank = next(r for r in range(3)
                             if r not in (leader_rank, peon.rank))
            await peon.ms_dispatch(None, M.MMonPaxos(
                op="lease", rank=fake_rank, epoch=stale_epoch,
                last_committed=0))
            assert peon.leader_rank == leader_rank, \
                "stale lease flipped the forwarding target"
            assert peon._last_lease == before, \
                "stale lease refreshed the lease timer"
            # current-epoch lease still lands
            await peon.ms_dispatch(None, M.MMonPaxos(
                op="lease", rank=leader_rank, epoch=peon.elector.epoch,
                last_committed=0))
            assert peon._last_lease > before
        finally:
            await cluster.stop()

    run_both(scenario)

def test_scrub_tie_marks_inconsistent_not_repaired():
    """size-2 pool, 1-1 crc split: scrub must record the object as
    inconsistent and must NOT push either copy over the other."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2)
        try:
            client = await cluster.client()
            pool = await client.pool_create("two", "replicated",
                                            pg_num=8, size=2)
            io = client.ioctx(pool)
            await io.write_full("tied", b"good-data")
            pgid = client.objecter.object_pgid(pool, "tied")
            _, _, acting, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            coll = f"pg_{pgid.pool}_{pgid.seed}"

            # converge-poll: wait for BOTH copies to land (the replica
            # apply is async) before corrupting one of them
            def _both_hold() -> bool:
                try:
                    return all(
                        cluster.osds[o].store.read(coll, "tied") ==
                        b"good-data" for o in acting)
                except Exception:
                    return False

            deadline = asyncio.get_event_loop().time() + 10.0
            while not _both_hold() and \
                    asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.02)
            # corrupt the PRIMARY copy: under first-inserted tie-breaking
            # this bad copy would win and clobber the good replica
            Transaction = P.imp("cluster.store.Transaction")
            cluster.osds[primary].store.queue_transaction(
                Transaction().write(coll, "tied", 0, b"BAD!-data"))
            st = cluster.osds[primary].pgs[pgid]
            report = await cluster.osds[primary].scrub_pg(st)
            assert "tied" in report["inconsistent"]
            assert "tied" not in report["repaired"]
            replica = next(o for o in acting if o != primary)
            assert cluster.osds[replica].store.read(coll, "tied") == \
                b"good-data", "tie repair overwrote the good replica"
        finally:
            await cluster.stop()

    run_both(scenario)

@contention_retry()
def test_resend_after_primary_change_not_reexecuted():
    """ADVICE r5: the in-memory reqid cache dies with the primary, but
    client reqids ride the replicated pg log entries — a resend landing
    on the NEW primary must find the reqid in its log and refuse to
    re-apply the (non-idempotent) append."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("failover", "replicated",
                                            pg_num=4, size=3)
            obj = client.objecter
            io = client.ioctx(pool)
            await io.write_full("log", b"base")
            reqid = (obj.client_name, 999_995)
            ops = [("append", {"data": b"+one"})]
            r1 = await _send_op_raw(obj, pool, "log", ops, reqid)
            assert r1.result == 0
            assert await io.read("log") == b"base+one"
            # kill the primary, wait for a new acting primary
            pgid = obj.object_pgid(pool, "log")
            _, _, _, old_primary = obj.osdmap.pg_to_up_acting_osds(pgid)
            await cluster.osds[old_primary].stop()
            for _ in range(200):
                await asyncio.sleep(0.25)
                _, _, acting, primary = \
                    obj.osdmap.pg_to_up_acting_osds(pgid)
                if primary >= 0 and primary != old_primary \
                        and pgid in cluster.osds[primary].pgs:
                    break
            assert primary != old_primary, "no failover happened"
            # resend the SAME op to the new primary
            r2 = await _send_op_raw(obj, pool, "log", ops, reqid)
            assert r2.result == 0
            got = await io.read("log", timeout=60)
            assert got == b"base+one", \
                f"resend re-executed after failover: {got!r}"
        finally:
            await cluster.stop()

    run_both(scenario)
