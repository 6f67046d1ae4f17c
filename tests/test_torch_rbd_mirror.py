"""The port's RBD journaling and rbd-mirror against ``ceph_tpu``'s, on the
cases of ``tests/test_rbd_mirror.py``.

Each case runs one cluster of each package
(``tests/_torch_clients.run_both_clients``; the port on
``device="cpu"``).  ``sync_once`` replays a journal in one pass, so those
cases require equal returns, reads and stored objects; the background
daemon's catch-up depends on when its polls land, so that case compares
only what it returns.
"""

import asyncio

import pytest

from tests._flaky import contention_retry
from tests._torch_clients import run_both_clients
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)


async def _pools(cluster):
    client = await cluster.client()
    a = await client.pool_create("site_a", "replicated", pg_num=8, size=2)
    b = await client.pool_create("site_b", "replicated", pg_num=8, size=2)
    return client, a, b


def test_journal_records_and_mirror_replays():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        MirrorDaemon = P.imp("cluster.rbd_mirror.MirrorDaemon")
        cluster = await start_cluster(3)
        try:
            client, a, b = await _pools(cluster)
            rbd_a = RBD(client.ioctx(a))
            await rbd_a.create("img", size=1 << 20, journaling=True)
            img = await rbd_a.open("img")
            blob1 = bytes(range(256)) * 64
            await img.write(4096, blob1)
            await img.write(100_000, b"tail" * 50)

            mirror = MirrorDaemon(client.ioctx(a), client.ioctx(b))
            applied = await mirror.sync_once()
            assert applied == 2
            rbd_b = RBD(client.ioctx(b))
            mirrored = await rbd_b.open("img")
            assert await mirrored.read(4096, len(blob1)) == blob1
            assert await mirrored.read(100_000, 200) == b"tail" * 50
            omap = await client.ioctx(a).omap_get("rbd_journal.img")
            assert [k for k in omap if not k.startswith("_")] == []
            assert await mirror.sync_once() == 0

            await img.resize(2 << 20)
            await img.write((1 << 20) + 5000, b"grown!" * 10)
            assert await mirror.sync_once() == 2
            mirrored = await rbd_b.open("img")
            assert mirrored.size() == 2 << 20
            assert await mirrored.read((1 << 20) + 5000, 60) == \
                b"grown!" * 10
            return applied, mirror.replayed, sorted(omap)
        finally:
            await cluster.stop()

    run_both_clients(scenario)


@contention_retry()
def test_mirror_daemon_background_catchup():
    """Timing-dependent (the poller's wakeups): compares returns only."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        MirrorDaemon = P.imp("cluster.rbd_mirror.MirrorDaemon")
        cluster = await start_cluster(3)
        try:
            client, a, b = await _pools(cluster)
            rbd_a = RBD(client.ioctx(a))
            await rbd_a.create("live", size=1 << 20, journaling=True)
            img = await rbd_a.open("live")
            mirror = MirrorDaemon(client.ioctx(a), client.ioctx(b),
                                  poll_interval=0.05)
            mirror.start()
            payloads = []
            for i in range(5):
                p = f"gen{i}-".encode() * 100
                await img.write(i * 10_000, p)
                payloads.append((i * 10_000, p))
            deadline = asyncio.get_event_loop().time() + 20
            while asyncio.get_event_loop().time() < deadline and \
                    mirror.replayed < 5:
                await asyncio.sleep(0.05)
            assert mirror.replayed >= 5, "mirror never caught up"
            await mirror.stop()
            rbd_b = RBD(client.ioctx(b))
            mirrored = await rbd_b.open("live")
            for off, p in payloads:
                assert await mirrored.read(off, len(p)) == p, off
            return mirrored.size()
        finally:
            await cluster.stop()

    run_both_clients(scenario, reads=False, stores=False)


def test_unjournaled_image_not_mirrored():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RBD = P.imp("cluster.rbd.RBD")
        MirrorDaemon = P.imp("cluster.rbd_mirror.MirrorDaemon")
        cluster = await start_cluster(2)
        try:
            client, a, b = await _pools(cluster)
            rbd_a = RBD(client.ioctx(a))
            await rbd_a.create("plain", size=1 << 20)   # no journaling
            img = await rbd_a.open("plain")
            await img.write(0, b"local-only")
            mirror = MirrorDaemon(client.ioctx(a), client.ioctx(b))
            assert await mirror.sync_once() == 0
            with pytest.raises(FileNotFoundError):
                await RBD(client.ioctx(b)).open("plain")
        finally:
            await cluster.stop()

    run_both_clients(scenario)
