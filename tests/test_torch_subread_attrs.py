"""An EC shard read labels its bytes with the attrs they were read with.

A shard holder reads a shard, verifies its crc through the read
coalescer (an awaited tick) and replies with the shard's version and
size.  The reference reads those attrs after the verify: a sub-write
that lands on the holder during the tick makes the reply carry the old
bytes under the new version and size.  The gatherer then groups those
bytes with the new generation's other shards and decodes a torn object;
a rebuild stamps the torn shard with the new version, and an acked write
reads back wrong.  ``race_run("batch-smoke", 31)`` hit it on the card
(the port verifies on a device tick, which keeps the window open longer):
the revived primary rebuilt its shard of ``obj1`` from the parity
member's reply, whose bytes were one generation older than its version.
The reference verifies inline where ``google_crc32c`` is installed, so
its tick path needs its verify to yield to show the same fault.  The
port reads the version and size with the bytes, on the holder and for
the gatherer's own shard (a deliberate difference, pinned below).

Each case holds every verify of one OSD until a new write of the object
has been acked, then lets the read go on, in a cluster of each package
(the port on ``device="cpu"``) under its own deadline.
"""

import asyncio

import pytest

from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    BOUND, PORT, REF, _one_torch_thread, _port_lockdep_reset)

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}
OLD, NEW = b"a" * 3000, b"b" * 2000


async def held_read_case(P, holder: str):
    """Write ``OLD``; hold the verifies of one OSD of the PG while a
    gather reads its shard, write ``NEW`` through the client and wait for
    its ack, then release the gather.  ``holder == "member"``: the third
    member gathers a member's shard (a sub-read over its own connection,
    as a revived primary's rebuild does while the PG's primary writes);
    ``"primary"``: the primary gathers with its own shard held.  Returns
    the holder's shard (version, size) before and after the write, the
    (version, size) label of the held shard's bytes, and the gather's
    chosen (version, size, shards)."""
    start_cluster = P.imp("cluster.vstart.start_cluster")
    cluster = await start_cluster(3)
    loop = asyncio.get_running_loop()
    try:
        client = await cluster.client()
        pool = await client.pool_create("sr", "erasure", pg_num=1,
                                        ec_profile=EC_PROFILE)
        io = client.ioctx(pool)
        await io.write_full("o", OLD)
        pgid = client.objecter.object_pgid(pool, "o")
        _, _, acting, primary = \
            cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
        members = [o for o in acting if o != primary]
        held = primary if holder == "primary" else members[0]
        gatherer = cluster.osds[primary if holder == "primary"
                                else members[1]]
        coll = f"pg_{pgid.pool}_{pgid.seed}"
        gate, entered = asyncio.Event(), asyncio.Event()
        osd = cluster.osds[held]
        real_verify = osd._read_batcher.verify

        async def verify(blobs, crcs, planar=False):
            entered.set()
            await gate.wait()
            return await real_verify(blobs, crcs, planar=planar)

        osd._read_batcher.verify = verify

        def shard_state():
            st = osd.store
            return (st.get_version(coll, "o"),
                    int(st.getattr(coll, "o", "size")))

        before = shard_state()
        st = gatherer.pgs[pgid]
        if holder == "primary":
            gather = loop.create_task(gatherer._gather_shards(
                gatherer.osdmap.pools[pgid.pool], st, "o", 2))
        else:
            gather = loop.create_task(gatherer._subread_round(
                st, "o", [(acting.index(held), held)], 0, None))
        await asyncio.wait_for(entered.wait(), 20)
        await io.write_full("o", NEW, timeout=30)
        after = shard_state()
        gate.set()
        out = await asyncio.wait_for(gather, 30)
        if holder == "primary":
            shards, size, version, _ = out
            label = None
            chosen = (version, size, sorted(shards))
        else:
            [(result, reply)] = out
            assert result == 0, out
            label = (reply.hinfo["version"], reply.hinfo["size"])
            chosen = None
        return before, after, label, chosen, acting.index(held)
    finally:
        await cluster.stop()


def run(P, holder):
    return asyncio.run(asyncio.wait_for(held_read_case(P, holder), BOUND))


@pytest.mark.parametrize("holder", ["member", "primary"])
def test_port_labels_shard_bytes_with_the_attrs_they_were_read_with(holder):
    """The port: the held shard, read before the NEW write landed, is
    labelled with the OLD write's version and size; the primary's gather
    decodes the NEW write from the two members alone."""
    before, after, label, chosen, held_shard = run(PORT, holder)
    assert before != after and after[1] == len(NEW)
    if holder == "member":
        assert label == before, (label, before, after)
    else:
        others = sorted({0, 1, 2} - {held_shard})
        assert chosen == (after[0], after[1], others), (chosen, after)


@pytest.mark.parametrize("holder", ["member", "primary"])
def test_reference_labels_old_bytes_with_the_new_write(holder):
    """The reference on its own tick path (its verify held like the
    port's): the held shard's old bytes carry the NEW write's version
    and size, and the primary's gather decodes them with the members'
    new shards."""
    before, after, label, chosen, held_shard = run(REF, holder)
    assert before != after
    if holder == "member":
        assert label == after, (label, before, after)
    else:
        assert chosen == (after[0], after[1], [0, 1, 2]), (chosen, after)
