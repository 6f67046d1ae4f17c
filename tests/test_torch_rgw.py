"""The port's RGW, its S3/Swift frontend, multisite sync and dmClock
against ``ceph_tpu``'s, on the cases of ``tests/test_rgw_dmclock.py``,
``tests/test_rgw_http.py`` and ``tests/test_rgw_multisite.py``.

Each cluster case runs one cluster of each package
(``tests/_torch_clients.run_both_clients``; the port on
``device="cpu"``), with each reference test's own assertions, and
requires equal returns.  Equal reads and stored objects are required
where the scenario does not depend on timing: object ETags, listings and
the data objects do not; the signing dates, the Swift token expiries,
the bucket-log stamps and the mclock pacing do, and those cases say so.
The dmClock queue cases run on a fake clock in both packages and require
the same dequeue order.
"""

import asyncio
import re
import time

import pytest

from ceph_tpu.cluster import dmclock as jdmclock
from ceph_tpu_torch.cluster import dmclock as pdmclock
from tests._flaky import contention_retry
from tests._torch_clients import run_both_clients
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)


async def _http(addr, method, path, body=b"", headers=None):
    """Minimal HTTP/1.1 client: -> (status, headers, body)."""
    reader, writer = await asyncio.open_connection(*addr)
    headers = dict(headers or {})
    headers["Content-Length"] = str(len(body))
    headers["Host"] = "s3.local"
    req = f"{method} {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
    writer.write(req.encode() + body)
    await writer.drain()
    status_line = (await reader.readline()).decode()
    status = int(status_line.split(" ", 2)[1])
    rh = {}
    while True:
        line = (await reader.readline()).decode().strip()
        if not line:
            break
        k, v = line.split(":", 1)
        rh[k.strip().lower()] = v.strip()
    n = 0 if method == "HEAD" else int(rh.get("content-length", "0"))
    data = await reader.readexactly(n)
    writer.close()
    return status, rh, data


async def _gateway(P, cluster, accounts=None):
    RGW = P.imp("cluster.rgw.RGW")
    RGWFrontend = P.imp("cluster.rgw_http.RGWFrontend")
    client = await cluster.client()
    pool = await client.pool_create("rgw", "replicated", pg_num=8, size=2)
    fe = RGWFrontend(RGW(client.ioctx(pool)), accounts=accounts)
    addr = await fe.start()
    return fe, addr


# -- the cases of tests/test_rgw_dmclock.py -----------------------------------

def test_rgw_bucket_object_lifecycle():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RGW = P.imp("cluster.rgw.RGW")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rgwp", "replicated",
                                            pg_num=8, size=2)
            rgw = RGW(client.ioctx(pool))
            await rgw.create_bucket("photos")
            with pytest.raises(FileExistsError):
                await rgw.create_bucket("photos")
            assert await rgw.list_buckets() == ["photos"]

            etag = await rgw.put_object("photos", "a/1.jpg",
                                        b"jpegbytes" * 100,
                                        content_type="image/jpeg",
                                        user_meta={"owner": "alice"})
            await rgw.put_object("photos", "a/2.jpg", b"x" * 10)
            await rgw.put_object("photos", "b/3.jpg", b"y" * 20)

            meta, data = await rgw.get_object("photos", "a/1.jpg")
            assert data == b"jpegbytes" * 100
            assert meta.etag == etag and meta.content_type == "image/jpeg"
            assert meta.user_meta == {"owner": "alice"}

            res = await rgw.list_objects("photos", prefix="a/")
            keys = [m.key for m in res.keys]
            assert keys == ["a/1.jpg", "a/2.jpg"]
            res = await rgw.list_objects("photos", max_keys=2)
            assert res.is_truncated and res.next_marker == "a/2.jpg"
            res2 = await rgw.list_objects("photos",
                                          marker=res.next_marker)
            assert [m.key for m in res2.keys] == ["b/3.jpg"]

            with pytest.raises(OSError):
                await rgw.delete_bucket("photos")   # not empty
            for k in ("a/1.jpg", "a/2.jpg", "b/3.jpg"):
                await rgw.delete_object("photos", k)
            with pytest.raises(FileNotFoundError):
                await rgw.get_object("photos", "a/1.jpg")
            await rgw.delete_bucket("photos")
            assert await rgw.list_buckets() == []
            return etag, keys, [(m.key, m.size, m.etag)
                                for m in res.keys]
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def _queues(**kw):
    """A dmClock queue of each package on its own fake clock."""
    t = [0.0]
    return t, [mod.DmClockQueue(now=lambda: t[0], **kw)
               for mod in (pdmclock, jdmclock)]


def _spec(q, **kw):
    mod = pdmclock if isinstance(q, pdmclock.DmClockQueue) else jdmclock
    return mod.QoSSpec(**kw)


def test_dmclock_reservation_and_weights():
    t, qs = _queues()
    out = []
    for q in qs:
        t[0] = 0.0
        q.set_client("gold", _spec(q, reservation=10.0, weight=1.0))
        q.set_client("silver", _spec(q, weight=1.0))
        for i in range(5):
            q.enqueue("gold", f"g{i}")
            q.enqueue("silver", f"s{i}")
        first = q.dequeue()
        assert first == "g0"
        t[0] = 10.0
        rest = q.drain_eligible()
        assert set(rest) == {f"g{i}" for i in range(1, 5)} | \
            {f"s{i}" for i in range(5)}
        assert len(q) == 0
        out.append([first] + list(rest))
    assert out[0] == out[1]


def test_dmclock_limit_caps_service():
    t, qs = _queues()
    out = []
    for q in qs:
        t[0] = 0.0
        q.set_client("capped", _spec(q, weight=1.0, limit=1.0))
        for i in range(3):
            q.enqueue("capped", i)
        seen = [q.dequeue()]
        assert seen[0] == 0
        seen.append(q.dequeue())
        assert seen[-1] is None
        t[0] = 1.05
        seen += [q.dequeue(), q.dequeue()]
        assert seen[-2:] == [1, None]
        t[0] = 2.1
        seen.append(q.dequeue())
        assert seen[-1] == 2
        out.append(seen)
    assert out[0] == out[1]


def test_dmclock_weight_proportionality():
    t, qs = _queues()
    out = []
    for q in qs:
        t[0] = 0.0
        q.set_client("heavy", _spec(q, weight=3.0))
        q.set_client("light", _spec(q, weight=1.0))
        for i in range(40):
            q.enqueue("heavy", ("h", i))
            q.enqueue("light", ("l", i))
        t[0] = 0.001
        served = []
        for _ in range(20):
            item = q.dequeue()
            if item is None:
                t[0] += 0.3
                continue
            served.append(item)
        heavy = sum(1 for s in served if s[0] == "h")
        light = sum(1 for s in served if s[0] == "l")
        assert heavy > light * 1.8, (heavy, light)
        out.append(served)
    assert out[0] == out[1]


@contention_retry()
def test_mclock_op_queue_in_osd():
    """osd_op_queue=mclock: client ops flow through the dmClock queue; a
    limited client is throttled while an unlimited one proceeds.
    Timing-dependent (the pacing): compares returns only."""
    async def scenario(P):
        vstart = P.imp("cluster.vstart")
        cfg = vstart._fast_config()
        cfg.osd_op_queue = "mclock"
        cluster = await vstart.start_cluster(3, config=cfg)
        try:
            fast = await cluster.client("fast")
            slow = await cluster.client("slow")
            pool = await fast.pool_create("qosp", "replicated",
                                          pg_num=1, size=2)
            fio = fast.ioctx(pool)
            sio = slow.ioctx(pool)
            await fio.write_full("warm", b"w")
            pgid = fast.objecter.object_pgid(pool, "warm")
            _, _, _, primary = \
                fast.objecter.osdmap.pg_to_up_acting_osds(pgid)
            cluster.osds[primary].set_qos("slow", limit=5.0)

            async def hammer(io, n):
                done = 0
                for i in range(n):
                    await io.write_full(f"{id(io)}-{i}", b"x")
                    done += 1
                return done

            t0 = asyncio.get_event_loop().time()
            fast_done, slow_done = await asyncio.gather(
                hammer(fio, 40), hammer(sio, 40))
            dt = asyncio.get_event_loop().time() - t0
            assert fast_done == 40 and slow_done == 40
            assert dt >= 5.0, dt
            q = cluster.osds[primary].perf.get("osd_ops_queued_mclock")
            assert q >= 80
            return fast_done, slow_done
        finally:
            await cluster.stop()

    run_both_clients(scenario, reads=False, stores=False)


# -- the cases of tests/test_rgw_http.py --------------------------------------

def test_s3_rest_end_to_end():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(3)
        try:
            fe, addr = await _gateway(P, cluster)
            st, _, _ = await _http(addr, "PUT", "/bkt")
            assert st == 200
            st, h, _ = await _http(
                addr, "PUT", "/bkt/hello.txt", b"payload-bytes",
                {"Content-Type": "text/plain",
                 "x-amz-meta-owner": "tester"})
            assert st == 200 and "etag" in h
            etag = h["etag"]
            st, h, body = await _http(addr, "GET", "/bkt/hello.txt")
            assert st == 200 and body == b"payload-bytes"
            assert h["content-type"] == "text/plain"
            assert h["x-amz-meta-owner"] == "tester"
            st, h, _ = await _http(addr, "HEAD", "/bkt/hello.txt")
            assert st == 200 and h["content-length"] == "13"
            for k in ("a/1", "a/2", "b/1"):
                await _http(addr, "PUT", f"/bkt/{k}", b"x")
            st, _, body = await _http(addr, "GET", "/bkt?prefix=a/")
            assert st == 200
            keys = re.findall(r"<Key>(.*?)</Key>", body.decode())
            assert keys == ["a/1", "a/2"]
            st, _, listing = await _http(addr, "GET", "/")
            assert st == 200 and b"<Name>bkt</Name>" in listing
            st, _, _ = await _http(addr, "DELETE", "/bkt/hello.txt")
            assert st == 204
            st, _, _ = await _http(addr, "GET", "/bkt/hello.txt")
            assert st == 404
            await fe.stop()
            return etag, keys, body, listing
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_s3_auth_required_and_enforced():
    """The signing dates come from the clock, so the signatures differ
    between the runs; the statuses and the stored objects do not."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RGWFrontend = P.imp("cluster.rgw_http.RGWFrontend")
        cluster = await start_cluster(2)
        try:
            fe, addr = await _gateway(P, cluster,
                                      accounts={"AKIDEMO": "sekrit"})
            seen = []
            st, _, body = await _http(addr, "PUT", "/locked")
            assert st == 403 and b"AccessDenied" in body
            seen.append(st)
            now = str(time.time())
            st, _, _ = await _http(addr, "PUT", "/locked", headers={
                "Authorization": "AWS AKIDEMO:deadbeef",
                "x-amz-date": now})
            assert st == 403
            seen.append(st)

            def signed(method, path, body=b""):
                date = str(time.time())
                return {"Authorization": RGWFrontend.sign(
                    method, path, date, "AKIDEMO", "sekrit", body=body),
                    "x-amz-date": date}

            st, _, _ = await _http(addr, "PUT", "/locked",
                                   headers=signed("PUT", "/locked"))
            assert st == 200
            st, _, _ = await _http(addr, "PUT", "/locked/k", b"v",
                                   signed("PUT", "/locked/k", b"v"))
            assert st == 200
            st, _, body = await _http(addr, "GET", "/locked/k",
                                      headers=signed("GET", "/locked/k"))
            assert st == 200 and body == b"v"
            cap = signed("PUT", "/locked/k", b"v")
            st, _, _ = await _http(addr, "PUT", "/locked/k", b"EVIL", cap)
            assert st == 403
            seen.append(st)
            old = str(time.time() - 3600)
            st, _, _ = await _http(addr, "PUT", "/locked/k", b"v", {
                "Authorization": RGWFrontend.sign(
                    "PUT", "/locked/k", old, "AKIDEMO", "sekrit",
                    body=b"v"),
                "x-amz-date": old})
            assert st == 403
            seen.append(st)
            await fe.stop()
            return seen
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_s3_sign_equals_reference():
    """The client-side signer of both packages, on fixed inputs."""
    from ceph_tpu.cluster.rgw_http import RGWFrontend as J
    from ceph_tpu_torch.cluster.rgw_http import RGWFrontend as P

    for args, kw in ((("PUT", "/b/k", "1700000000.5", "AK", "s"),
                      {"body": b"x" * 100}),
                     (("POST", "/b/k", "1", "AK", "s"),
                      {"query": {"uploads": ""}}),
                     (("PUT", "/b/k", "2", "AK", "s"),
                      {"body": b"p", "query": {"partNumber": "3",
                                               "uploadId": "a&b=c"}})):
        assert P.sign(*args, **kw) == J.sign(*args, **kw)


def test_s3_multipart_upload():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2)
        try:
            fe, addr = await _gateway(P, cluster)
            await _http(addr, "PUT", "/mp")
            st, _, body = await _http(addr, "POST", "/mp/big?uploads")
            assert st == 200
            upload_id = re.search(r"<UploadId>(\w+)</UploadId>",
                                  body.decode()).group(1)
            p1, p2, p3 = b"A" * 7000, b"B" * 5000, b"C" * 100
            etags = []
            for n, part in ((2, p2), (1, p1), (3, p3)):  # out of order
                st, h, _ = await _http(
                    addr, "PUT",
                    f"/mp/big?partNumber={n}&uploadId={upload_id}", part)
                assert st == 200 and "etag" in h
                etags.append(h["etag"])
            st, _, done = await _http(
                addr, "POST", f"/mp/big?uploadId={upload_id}")
            assert st == 200 and b"CompleteMultipartUploadResult" in done
            st, _, body = await _http(addr, "GET", "/mp/big")
            assert st == 200
            assert body == p1 + p2 + p3, "parts assembled out of order"
            st, _, listing = await _http(addr, "GET", "/mp")
            assert re.findall(r"<Key>(.*?)</Key>", listing.decode()) \
                == ["big"]
            st, _, _ = await _http(
                addr, "PUT", f"/mp/big?partNumber=1&uploadId={upload_id}",
                b"zz")
            assert st == 404
            await fe.stop()
            return etags, re.sub(rb"<Key>.*?</Key>", b"", done)
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_swift_api_surface():
    """Swift tokens carry their expiry time, so the runs' tokens differ;
    statuses, bodies and the stored objects do not."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RGWFrontend = P.imp("cluster.rgw_http.RGWFrontend")
        cluster = await start_cluster(2)
        try:
            fe, addr = await _gateway(P, cluster,
                                      accounts={"swifty": "s3cr3t"})
            tok = {"X-Auth-Token": RGWFrontend.swift_token(
                "swifty", "s3cr3t")}
            seen = []
            st, _, _ = await _http(addr, "PUT", "/swift/v1/cont")
            assert st == 401
            seen.append(st)
            st, _, _ = await _http(addr, "PUT", "/swift/v1/cont",
                                   headers=tok)
            assert st == 201
            st, _, _ = await _http(addr, "PUT", "/swift/v1/cont",
                                   headers=tok)
            assert st == 202
            st, h, _ = await _http(
                addr, "PUT", "/swift/v1/cont/obj.txt", b"swift-body",
                {**tok, "Content-Type": "text/plain",
                 "X-Object-Meta-Color": "blue"})
            assert st == 201 and "etag" in h
            seen.append(h["etag"])
            st, h, body = await _http(addr, "GET", "/swift/v1/cont/obj.txt",
                                      headers=tok)
            assert st == 200 and body == b"swift-body"
            assert h["x-object-meta-color"] == "blue"
            st, _, body = await _http(addr, "GET", "/swift/v1/cont",
                                      headers=tok)
            assert st == 200 and body == b"obj.txt\n"
            st, _, body = await _http(addr, "GET", "/swift/v1",
                                      headers=tok)
            assert st == 200 and b"cont" in body
            seen.append(body)
            st, _, _ = await _http(
                addr, "GET", "/swift/v1/cont",
                headers={"X-Auth-Token": RGWFrontend.swift_token(
                    "swifty", "s3cr3t", ttl=-5)})
            assert st == 401
            st, h, _ = await _http(addr, "GET", "/swift/auth", headers={
                "X-Auth-User": "swifty", "X-Auth-Key": "s3cr3t"})
            assert st == 200 and h.get("x-auth-token")
            st, _, _ = await _http(
                addr, "GET", "/swift/v1/cont",
                headers={"X-Auth-Token": h["x-auth-token"]})
            assert st == 200
            date = str(time.time())
            sig = {"Authorization": RGWFrontend.sign(
                "GET", "/cont/obj.txt", date, "swifty", "s3cr3t"),
                "x-amz-date": date}
            st, _, body = await _http(addr, "GET", "/cont/obj.txt",
                                      headers=sig)
            assert st == 200 and body == b"swift-body"
            st, _, _ = await _http(addr, "DELETE",
                                   "/swift/v1/cont/obj.txt", headers=tok)
            assert st == 204
            st, _, _ = await _http(addr, "GET", "/swift/v1/cont/obj.txt",
                                   headers=tok)
            assert st == 404
            await fe.stop()
            return seen
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_swift_edge_semantics():
    """Prefix guard, directory markers, 409 on non-empty delete, 412 on
    a bad limit, the total object count header."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        cluster = await start_cluster(2)
        try:
            fe, addr = await _gateway(P, cluster)
            st, _, _ = await _http(addr, "PUT", "/swift")
            assert st == 200
            st, _, _ = await _http(addr, "PUT", "/swift/v1.txt", b"s3!")
            assert st == 200
            st, _, body = await _http(addr, "GET", "/swift/v1.txt")
            assert st == 200 and body == b"s3!"
            st, _, _ = await _http(addr, "PUT", "/swift/v1/c")
            assert st == 201
            st, _, _ = await _http(addr, "PUT", "/swift/v1/c/dir/", b"")
            assert st == 201
            st, _, _ = await _http(addr, "PUT", "/swift/v1/c/dir", b"real")
            assert st == 201
            st, _, listing = await _http(addr, "GET", "/swift/v1/c")
            assert set(listing.decode().split()) == {"dir", "dir/"}
            st, h, _ = await _http(addr, "GET", "/swift/v1/c?limit=1")
            assert h["x-container-object-count"] == "2"
            st, _, _ = await _http(addr, "GET", "/swift/v1/c?limit=abc")
            assert st == 412
            st, _, _ = await _http(addr, "DELETE", "/swift/v1/c")
            assert st == 409
            st, _, _ = await _http(addr, "DELETE", "/swift/v1")
            assert st == 405
            await fe.stop()
            return listing
        finally:
            await cluster.stop()

    run_both_clients(scenario)


# -- the cases of tests/test_rgw_multisite.py ---------------------------------

async def _zones(P, cluster):
    RGW = P.imp("cluster.rgw.RGW")
    client = await cluster.client()
    pa = await client.pool_create("zone_a", "replicated", pg_num=4, size=2)
    pb = await client.pool_create("zone_b", "replicated", pg_num=4, size=2)
    return RGW(client.ioctx(pa), zone="a"), RGW(client.ioctx(pb), zone="b")


def test_incremental_and_full_sync():
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RGW = P.imp("cluster.rgw.RGW")
        RGWSyncAgent = P.imp("cluster.rgw_sync.RGWSyncAgent")
        cluster = await start_cluster(3)
        try:
            za, zb = await _zones(P, cluster)
            await za.create_bucket("bkt")
            for i in range(5):
                await za.put_object("bkt", f"k{i}", b"v%d" % i,
                                    user_meta={"n": str(i)})
            agent = RGWSyncAgent(za, zb)
            counts = [await agent.sync_once()]
            assert counts[-1] == 5
            assert await zb.list_buckets() == ["bkt"]
            meta, data = await zb.get_object("bkt", "k3")
            assert data == b"v3" and meta.user_meta == {"n": "3"}
            src_meta = await za.head_object("bkt", "k3")
            assert meta.etag == src_meta.etag

            await za.put_object("bkt", "k5", b"v5")
            await za.delete_object("bkt", "k0")
            counts.append(await agent.sync_once())
            assert counts[-1] == 2
            assert (await zb.get_object("bkt", "k5"))[1] == b"v5"
            with pytest.raises(FileNotFoundError):
                await zb.head_object("bkt", "k0")
            counts.append(await agent.sync_once())
            assert counts[-1] == 0

            za.BILOG_MAX = 3
            for i in range(8):
                await za.put_object("bkt", f"burst{i}", b"b%d" % i)
            client = await cluster.client("second")
            pc = await client.pool_create("zone_c", "replicated",
                                          pg_num=4, size=2)
            zc = RGW(client.ioctx(pc), zone="c")
            agent2 = RGWSyncAgent(za, zc)
            counts.append(await agent2.sync_once())
            assert agent2.stats["full_syncs"] >= 1
            listing = await zc.list_objects("bkt")
            keys = {m.key for m in listing.keys}
            assert keys == {m.key for m in (await za.list_objects("bkt")).keys}
            return counts, sorted(keys), agent.stats, agent2.stats
        finally:
            await cluster.stop()

    run_both_clients(scenario)


def test_active_active_no_echo():
    """The last part runs both agents in the background and polls for the
    live write: timing-dependent, so compares returns only."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        RGWSyncAgent = P.imp("cluster.rgw_sync.RGWSyncAgent")
        cluster = await start_cluster(3)
        try:
            za, zb = await _zones(P, cluster)
            await za.create_bucket("aa")
            ab = RGWSyncAgent(za, zb)   # a -> b
            ba = RGWSyncAgent(zb, za)   # b -> a
            await za.put_object("aa", "from_a", b"A")
            await ab.sync_once()
            await zb.put_object("aa", "from_b", b"B")
            rounds = []
            for _ in range(4):
                rounds.append((await ab.sync_once(), await ba.sync_once()))
            assert (await za.get_object("aa", "from_b"))[1] == b"B"
            assert (await zb.get_object("aa", "from_a"))[1] == b"A"
            assert await ab.sync_once() == 0
            assert await ba.sync_once() == 0
            assert ab.stats["skipped_echo"] >= 1 or \
                ba.stats["skipped_echo"] >= 1

            ab.interval = ba.interval = 0.1
            ab.start()
            ba.start()
            await za.put_object("aa", "live", b"L")
            for _ in range(100):
                try:
                    if (await zb.get_object("aa", "live"))[1] == b"L":
                        break
                except FileNotFoundError:
                    pass
                await asyncio.sleep(0.1)
            assert (await zb.get_object("aa", "live"))[1] == b"L"
            await ab.stop()
            await ba.stop()
            return rounds
        finally:
            await cluster.stop()

    run_both_clients(scenario, reads=False, stores=False)
