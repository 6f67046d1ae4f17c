"""A revived EC primary that is behind its members, and the fence that
keeps an old primary from acking past an interval change.

The captured state (``batch-smoke`` at seed 31 on a loaded CPU): a
k2m1 PG whose primary went down and came back with its store.  While it
was down the PG's next primary acked writes with the third member, then
issued writes that only its own shards took (un-acked).  The revived
primary is behind; the member that missed the un-acked writes holds
the authoritative log; the other member holds shards of a newer
generation, past that log.  The revived primary rebuilds each object
from the members' shards and mixes the two generations: in both
packages it never syncs, and an acked overwrite reads back as an error.
The port rewinds the member that is ahead before it syncs (a
deliberate difference from the reference, pinned below), and fences
the writes of an old primary so that the rewind can never drop an acked
one: a member refuses a client sub-write, and a primary refuses to ack,
once a newer interval's peering query has reached it; a member refuses
a rewind from an older interval's primary.

The state is built directly, with no race: a primary's send of its
sub-writes to one member fails, so those writes are logged on its own
shards and stay un-acked, and that primary runs no peering round of its
own before the revive.
"""

import asyncio
import importlib
import os
import time

import pytest

from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    PORT, REF, _one_torch_thread, _port_lockdep_reset)

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}
NONE = 0x7FFFFFFF


async def stale_primary_case(P, tmp: str, settle: float):
    """Build the captured state in a cluster of ``P``, revive the
    primary, give peering ``settle`` seconds to bring it level with the
    authoritative log, and read every acked object back.  Returns the
    shape of the state before the revive and, per acked object, whether
    it read back exactly."""
    start_cluster = P.imp("cluster.vstart.start_cluster")
    cfg = P.imp("cluster.vstart._fast_config")()
    cfg.mon_osd_down_out_interval = 600.0      # the dead primary stays in
    FileStore = P.imp("cluster.filestore.FileStore")
    M = importlib.import_module(f"{P.root}.cluster.messages")
    cluster = await start_cluster(
        3, config=cfg,
        store_factory=lambda o: FileStore(os.path.join(tmp, f"osd{o}")))
    loop = asyncio.get_running_loop()
    try:
        client = await cluster.client()
        pool = await client.pool_create("stale", "erasure", pg_num=1,
                                        ec_profile=EC_PROFILE)
        io = client.ioctx(pool)
        acked = {}

        async def write(oid, fill):
            await io.write_full(oid, fill * 3000)
            acked[oid] = fill * 3000

        await write("obj0", b"0")
        await write("obj1", b"1")
        pgid = client.objecter.object_pgid(pool, "obj1")
        _, _, _, first = cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
        await cluster.kill_osd(first)
        deadline = loop.time() + 20
        while cluster.mon.osdmap.osd_up[first]:
            assert loop.time() < deadline, "the primary never went down"
            await asyncio.sleep(0.05)
        _, _, acting, second = cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
        third = next(o for o in acting if o not in (first, second, NONE))
        # the PG's next primary acks an overwrite of obj1 and two more
        for oid, fill in (("obj1", b"2"), ("obj2", b"3"), ("obj3", b"4")):
            await write(oid, fill)
        # ...and runs no peering round of its own from here to the revive
        # (one would rewind the un-acked writes below from its own log):
        # wait out the round it took the PG over with, then stub them
        osd = cluster.osds[second]
        deadline = loop.time() + 20
        while (osd._peering_task is not None
               and not osd._peering_task.done()) or \
                osd._recovery_retry_tasks:
            assert loop.time() < deadline, "its peering never settled"
            await asyncio.sleep(0.05)

        async def no_round(st):
            return None

        osd._recover_pg = no_round
        # ...then its sub-writes to the third member fail: three writes
        # (obj1's next generation among them) land on its shards only
        send, batch_send = osd._send_osd, osd._sub_batcher.send

        async def failing_send(peer, msg, *args, **kwargs):
            if peer == third and isinstance(msg, M.MOSDECSubOpWrite):
                raise ConnectionError("sub-write lost")
            return await send(peer, msg, *args, **kwargs)

        async def failing_batch_send(peer, msg):
            if peer == third:
                raise ConnectionError("sub-write lost")
            return await batch_send(peer, msg)

        osd._send_osd, osd._sub_batcher.send = \
            failing_send, failing_batch_send
        unacked = 0
        for oid, fill in (("obj1", b"5"), ("obj4", b"6"), ("obj5", b"7")):
            try:
                await write(oid, fill)
            except OSError:
                unacked += 1
        osd._send_osd, osd._sub_batcher.send = send, batch_send
        ahead, auth = osd.pgs[pgid], cluster.osds[third].pgs[pgid]
        shape = {"unacked": unacked,
                 "ahead_past_auth": ahead.last_update > auth.last_update,
                 "ahead_watermark_at_auth":
                     ahead.last_complete == auth.last_update}
        await cluster.revive_osd(first, with_store=True)
        revived = cluster.osds[first]
        shape["revived_behind"] = \
            revived.pgs[pgid].last_update < auth.last_update
        deadline = loop.time() + settle
        while loop.time() < deadline:
            st = revived.pgs.get(pgid)
            if st is not None and st.primary == first and \
                    st.last_update >= auth.last_update and \
                    st.last_complete == st.last_update:
                break
            await asyncio.sleep(0.1)
        reads = {}
        for oid, data in sorted(acked.items()):
            try:
                reads[oid] = await asyncio.wait_for(io.read(oid), 10) == data
            except (OSError, asyncio.TimeoutError):
                reads[oid] = False
        return shape, reads
    finally:
        await cluster.stop()


@pytest.mark.parametrize("P,settle,lost", [(PORT, 40.0, []),
                                            (REF, 6.0, ["obj1"])],
                         ids=["port", "ref"])
def test_a_revived_ec_primary_behind_its_members_keeps_every_acked_object(
        P, settle, lost, tmp_path):
    """ROADMAP §C1 built directly.  The port's revived primary has the
    member that is ahead rewind to the authoritative head, syncs, and
    every acked object reads back.  The reference's loses obj1, whose
    acked generation it cannot rebuild: its case pins the difference."""
    shape, reads = asyncio.run(asyncio.wait_for(
        stale_primary_case(P, str(tmp_path), settle), 120))
    assert shape == {"unacked": 3, "ahead_past_auth": True,
                     "ahead_watermark_at_auth": True,
                     "revived_behind": True}
    assert sorted(reads) == ["obj0", "obj1", "obj2", "obj3"]
    assert sorted(o for o, ok in reads.items() if not ok) == lost


class _Conn:
    """The peer's end of a connection: records the replies it is sent."""

    def __init__(self):
        self.replies = []

    async def send(self, msg):
        self.replies.append(msg)


async def _one_pg_cluster():
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster

    cfg = _fast_config()
    # no false downs on a loaded worker: the intervals must stay put
    cfg.osd_heartbeat_grace = cfg.mon_osd_beacon_grace = 30.0
    cluster = await start_cluster(3, config=cfg, device="cpu")
    client = await cluster.client()
    pool = await client.pool_create("fence", "erasure", pg_num=1,
                                    ec_profile=EC_PROFILE)
    io = client.ioctx(pool)
    await io.write_full("a", b"a" * 3000)
    pgid = client.objecter.object_pgid(pool, "a")
    _, _, acting, primary = cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
    return cluster, io, pgid, acting, primary


def test_a_member_refuses_sub_writes_and_rewinds_of_an_older_interval():
    """Once a newer interval's primary has queried a member, the member
    refuses a client sub-write issued on a map older than that interval
    (-11, alone or in a batch frame), and a rewind from an older
    interval's primary leaves its log as it is; the newer interval's own
    sub-write and rewind still apply."""
    import pickle

    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.cluster.pg import MOSDPGQuery, _coll
    from ceph_tpu_torch.cluster.pglog import LogEntry

    async def case():
        cluster, io, pgid, acting, primary = await _one_pg_cluster()
        try:
            member = cluster.osds[next(o for o in acting if o != primary)]
            st = member.pgs[pgid]
            # the member's map epoch, and a newer interval's first epoch
            old = cluster.mon.osdmap.epoch
            new = old + 5
            head = st.last_update
            blob = member.store.read_planar(_coll(pgid), "a")
            layout = member.store.object_layout(_coll(pgid), "a")

            def sub(oid, seq, epoch, n):
                entry = LogEntry(op="modify", oid=oid,
                                 version=(head[0], seq),
                                 prior_version=(head[0], seq - 1))
                return M.MOSDECSubOpWrite(
                    reqid=("fence", n), pgid=pgid, oid=oid, shard=1,
                    data=blob, chunk_off=0, shard_size=None,
                    hinfo={"size": 3000, "version": seq}, entry=entry,
                    epoch=epoch, deadline=time.time() + 60,
                    layout=layout)

            out = {}
            conn = _Conn()
            await member._handle_ec_write(conn, sub("b", head[1] + 1,
                                                    old, 1))
            out["before_query"] = [r.result for r in conn.replies]
            await member._dispatch(_Conn(), MOSDPGQuery(pgid=pgid,
                                                        interval=new))
            conn = _Conn()
            await member._handle_ec_write(conn, sub("c", head[1] + 2,
                                                    old, 2))
            await member._handle_ec_write_batch(
                conn, M.MOSDECSubOpWriteBatch(
                    items=[sub("c", head[1] + 2, old, 3)]))
            out["older"] = ([conn.replies[0].result],
                            conn.replies[1].results,
                            member.store.stat(_coll(pgid), "c"))
            for interval in (old, new):
                member._handle_push(M.MOSDPGPush(
                    pgid=pgid, op="rewind", data=pickle.dumps(head),
                    interval=interval))
                out[f"rewind_{'old' if interval == old else 'new'}"] = \
                    st.last_update
            conn = _Conn()
            await member._handle_ec_write(conn, sub("d", head[1] + 1,
                                                    new, 4))
            out["newer"] = [r.result for r in conn.replies]
            return head, out
        finally:
            await cluster.stop()

    head, out = asyncio.run(asyncio.wait_for(case(), 60))
    assert out["before_query"] == [0]
    assert out["older"] == ([-11], [(("fence", 3), -11, 1)], None)
    assert out["rewind_old"] == (head[0], head[1] + 1)
    assert out["rewind_new"] == head
    assert out["newer"] == [0]


def test_a_primary_does_not_ack_a_write_once_a_newer_interval_queried_it():
    """An EC write whose sub-write acks come in after a newer interval's
    peering query reached its primary stays un-acked (-110, the client
    sees an error) although every shard took it; a write before the
    query is acked."""
    from ceph_tpu_torch.cluster.pg import MOSDPGQuery

    async def case():
        cluster, io, pgid, acting, primary = await _one_pg_cluster()
        try:
            prim = cluster.osds[primary]
            member = cluster.osds[next(o for o in acting if o != primary)]
            gate, arrived = asyncio.Event(), asyncio.Event()
            handlers = {}
            for name in ("_handle_ec_write", "_handle_ec_write_batch"):
                real = getattr(member, name)

                async def held(conn, msg, real=real):
                    arrived.set()
                    await gate.wait()
                    return await real(conn, msg)

                handlers[name] = held
            for name, fn in handlers.items():
                setattr(member, name, fn)
            write = asyncio.ensure_future(io.write_full("b", b"b" * 3000))
            await asyncio.wait_for(arrived.wait(), 20)
            st = prim.pgs[pgid]
            await prim._dispatch(_Conn(), MOSDPGQuery(
                pgid=pgid, interval=st.interval_epoch + 5))
            gate.set()
            try:
                await write
                fenced = False
            except OSError:
                fenced = True
            return fenced, member.pgs[pgid].log.entries[-1].oid
        finally:
            await cluster.stop()

    fenced, last_on_member = asyncio.run(asyncio.wait_for(case(), 60))
    assert fenced
    assert last_on_member == "b"     # the member took it; no ack all the same
