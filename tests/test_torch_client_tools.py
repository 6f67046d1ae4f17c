"""The port's client tools against ``ceph_tpu``'s: ``rados`` (its
subcommands and ``bench``), ``ceph`` (``daemon``, ``resolve_daemon``,
``_rate_rows``) and ``objectstore-tool``, on the rados and
objectstore-tool cases of ``tests/test_tools.py`` and the CLI case of
``tests/test_trace.py``.

Each CLI case runs one cluster of each package, drives the tool's
``_run`` inside that cluster's event loop, and requires equal exit codes
and equal printed text (the port's CLI with ``--device cpu``; the
reference's has no such flag).  ``rados bench`` prints rates and
latencies that depend on timing: its case compares exit codes, the
report's keys and its mode lines only.
"""

import asyncio
import re

import pytest
import torch

from ceph_tpu.tools import ceph as jceph
from ceph_tpu.tools import objectstore_tool as jost
from ceph_tpu.tools import rados as jrados
from ceph_tpu_torch.tools import ceph as pceph
from ceph_tpu_torch.tools import objectstore_tool as post
from ceph_tpu_torch.tools import rados as prados
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    PORT, REF, _one_torch_thread, _port_lockdep_reset)

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}
TOOLS = {"ref": (jrados, jceph, []), "port": (prados, pceph,
                                               ["--device", "cpu"])}


def with_cluster(P, setup, drive, capsys, n_osds=3):
    """Start a cluster of ``P`` in a fresh loop, ``setup(client)`` there,
    then ``drive(cli, mon)`` with ``cli(tool, argv)`` running the tool's
    ``_run`` in the same loop: (drive's result, captured output)."""
    start_cluster = P.imp("cluster.vstart.start_cluster")
    loop = asyncio.new_event_loop()

    async def boot():
        cluster = await start_cluster(n_osds)
        try:
            client = await cluster.client()
            await setup(cluster, client)
        except Exception:
            await cluster.stop()
            raise
        return cluster, (f"{cluster.mon_addrs[0][0]}:"
                         f"{cluster.mon_addrs[0][1]}")

    cluster, mon = loop.run_until_complete(
        asyncio.wait_for(boot(), timeout=60))
    rados, ceph, dev = TOOLS[P.name]
    mods = {"rados": rados, "ceph": ceph}

    def cli(tool, argv):
        mod = mods[tool]
        return loop.run_until_complete(asyncio.wait_for(
            mod._run(mod.parse_args(dev + argv)), timeout=60))

    try:
        capsys.readouterr()
        out = drive(cli, mon, cluster)
        return out, capsys.readouterr().out
    finally:
        loop.run_until_complete(cluster.stop())
        loop.close()


# -- the cases of tests/test_tools.py -----------------------------------------

def test_objectstore_tool(tmp_path, capsys):
    outs = []
    for P, tool in ((PORT, post), (REF, jost)):
        FileStore = P.imp("cluster.filestore.FileStore")
        Transaction = P.imp("cluster.store.Transaction")
        path = str(tmp_path / f"{P.name}-osd0")
        s = FileStore(path)
        s.mount()
        s.queue_transaction(
            Transaction().create_collection("pg_1_0")
            .write("pg_1_0", "obj", 0, b"tool-bytes")
            .setattr("pg_1_0", "obj", "_k", b"v")
            .set_version("pg_1_0", "obj", 4))
        s.umount()
        got = []
        assert tool.main(["--data-path", path, "--op", "list"]) == 0
        got.append(capsys.readouterr().out)
        assert "pg_1_0/obj" in got[-1]
        assert tool.main(["--data-path", path, "--op", "info",
                          "--collection", "pg_1_0", "--object", "obj"]) == 0
        got.append(capsys.readouterr().out)
        assert "size 10" in got[-1] and "version 4" in got[-1]
        assert tool.main(["--data-path", path, "--op", "dump",
                          "--collection", "pg_1_0", "--object", "obj"]) == 0
        got.append(capsys.readouterr().out)
        assert "tool-bytes" in got[-1]
        assert tool.main(["--data-path", path, "--op", "meta",
                          "--collection", "pg_1_0"]) == 0
        got.append(capsys.readouterr().out)
        outs.append(got)
    assert outs[0] == outs[1]


def test_objectstore_tool_reads_a_stopped_osds_pg_log(tmp_path, capsys):
    """``--op meta`` on a FileStore an OSD wrote: the persisted PG log
    (the port's ``osd.PGMETA`` object), as the reference prints it.

    The two packages' FileStores share their on-disk format, so each
    tool reads both stores and the two must print the same text for
    each store.  Across the packages the logs hold the same entries
    (sequence, op, object); each entry's epoch is the one its own
    cluster's primary held at that write.  Which epoch the writes land
    in depends on timing (a loaded host's missed heartbeat commits one
    more), so the two clusters' epochs are not compared."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        FileStore = P.imp("cluster.filestore.FileStore")
        root = tmp_path / P.name
        cluster = await start_cluster(
            3, store_factory=lambda o: FileStore(str(root / f"osd{o}")))
        try:
            client = await cluster.client()
            pool = await client.pool_create("ost", "replicated",
                                            pg_num=1, size=1)
            io = client.ioctx(pool)
            pgid = client.objecter.object_pgid(pool, "o0")
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            epochs = []
            for i in range(3):
                before = cluster.osds[primary].osdmap.epoch
                await io.write_full(f"o{i}", b"v" * (i + 1))
                epochs.append((before, cluster.osds[primary].osdmap.epoch))
            return (str(root / f"osd{primary}"), f"pg_{pool}_{pgid.seed}",
                    epochs)
        finally:
            await cluster.stop()

    def meta(tool, path, coll):
        capsys.readouterr()
        assert tool.main(["--data-path", path, "--op", "meta",
                          "--collection", coll]) == 0
        return capsys.readouterr().out

    stores = [asyncio.run(asyncio.wait_for(scenario(P), 60))
              for P in (PORT, REF)]
    entries = []
    for path, coll, epochs in stores:
        text = meta(post, path, coll)
        assert text == meta(jost, path, coll)
        assert text.startswith("last_update") and " o2" in text
        logged = re.findall(r"^  \((\d+), (\d+)\) (\w+) (\S+)$", text,
                            re.MULTILINE)
        assert len(logged) == len(epochs) == 3
        for (epoch, _seq, _op, _oid), (lo, hi) in zip(logged, epochs):
            assert lo <= int(epoch) <= hi
        assert text.splitlines()[0] == \
            f"last_update ({logged[-1][0]}, {logged[-1][1]})"
        entries.append([e[1:] for e in logged])
    assert entries[0] == entries[1] == [("1", "modify", "o0"),
                                        ("2", "modify", "o1"),
                                        ("3", "modify", "o2")]


def test_rados_cli_against_live_cluster(tmp_path, capsys):
    async def setup(cluster, client):
        await client.pool_create("cli", "replicated", pg_num=8, size=2)

    outs = []
    for P in (PORT, REF):
        infile = tmp_path / f"{P.name}-payload"
        infile.write_bytes(b"cli-payload" * 100)
        outfile = tmp_path / f"{P.name}-out"

        def drive(cli, mon, cluster):
            rcs = [cli("rados", ["--mon", mon, "lspools"]),
                   cli("rados", ["--mon", mon, "-p", "cli", "put", "obj1",
                                 str(infile)]),
                   cli("rados", ["--mon", mon, "-p", "cli", "get", "obj1",
                                 str(outfile)]),
                   cli("rados", ["--mon", mon, "-p", "cli", "stat",
                                 "obj1"]),
                   cli("rados", ["--mon", mon, "-p", "cli", "ls"]),
                   cli("rados", ["--mon", mon, "-p", "cli", "rm", "obj1"]),
                   cli("rados", ["--mon", mon, "-p", "nope", "ls"])]
            assert outfile.read_bytes() == b"cli-payload" * 100
            return rcs

        rcs, text = with_cluster(P, setup, drive, capsys)
        assert rcs == [0, 0, 0, 0, 0, 0, 1]
        assert "cli" in text and "obj1" in text
        outs.append((rcs, text))
    assert outs[0] == outs[1]


def test_rados_bench_modes_on_ec_pool(capsys):
    """``rados bench <secs> write|seq|rand`` on an EC pool reports MB/s
    and latency percentiles.  Timing-dependent: compares exit codes and
    the report's shape."""
    async def setup(cluster, client):
        await client.pool_create("benchec", "erasure", pg_num=4,
                                 ec_profile=EC_PROFILE)

    def shape(text):
        return [re.sub(r"[0-9.]+", "N", line) for line in text.splitlines()]

    outs = []
    for P in (PORT, REF):
        def drive(cli, mon, cluster):
            rcs, texts = [], []
            for argv in (["1.0", "write", "-t", "4", "--block-size",
                          "32768", "--no-cleanup"],
                         ["0.5", "seq", "-t", "4", "--block-size", "32768"],
                         ["0.5", "rand", "-t", "4", "--block-size",
                          "32768"]):
                rcs.append(cli("rados", ["--mon", mon, "-p", "benchec",
                                         "bench"] + argv))
            return rcs

        rcs, text = with_cluster(P, setup, drive, capsys)
        assert rcs == [0, 0, 0]
        assert "bandwidth" in text and "latency ms" in text and "p95" in text
        for mode in ("write:", "seq:", "rand:"):
            assert mode in text
        outs.append((rcs, shape(text)))
    assert outs[0] == outs[1]


def test_rados_bench_report_keys_equal_reference():
    """``bench`` itself, on both clusters: the same report keys, mode,
    block size, and an op count that moves."""
    async def scenario(P):
        start_cluster = P.imp("cluster.vstart.start_cluster")
        bench = P.imp("tools.rados.bench")
        cluster = await start_cluster(3)
        try:
            client = await cluster.client()
            pool = await client.pool_create("rb", "replicated", pg_num=4,
                                            size=2)
            io = client.ioctx(pool)
            w = await bench(io, 0.5, "write", concurrency=4,
                            block_size=4096, cleanup=False)
            s = await bench(io, 0.3, "seq", concurrency=4,
                            block_size=4096)
            assert w["ops"] > 0 and s["ops"] > 0
            return [(sorted(r), r["mode"], r["block_size"]) for r in (w, s)]
        finally:
            await cluster.stop()

    from tests.test_torch_cluster import run_both
    run_both(scenario, reads=False, stores=False)


def test_ceph_cli_daemon_commands(capsys):
    """``ceph daemon <name> ...`` through ``resolve_daemon`` for an OSD,
    the mgr-less map's refusal and an MDS rank, on both packages."""
    async def setup(cluster, client):
        meta = await client.pool_create("m", "replicated", pg_num=4, size=2)
        data = await client.pool_create("d", "replicated", pg_num=4, size=2)
        await cluster.start_mds(meta, data)
        deadline = asyncio.get_event_loop().time() + 20
        while asyncio.get_event_loop().time() < deadline:
            await client.objecter._refresh_map()
            if getattr(client.objecter.osdmap, "mds_addrs", None):
                break
            await asyncio.sleep(0.05)

    outs = []
    for P in (PORT, REF):
        def drive(cli, mon, cluster):
            rcs = [cli("ceph", ["--mon", mon, "daemon", "mds.0",
                                "status"])]
            with pytest.raises(KeyError):
                cli("ceph", ["--mon", mon, "daemon", "mgr", "status"])
            with pytest.raises(KeyError):
                cli("ceph", ["--mon", mon, "daemon", "mon.3", "status"])
            rcs.append(cli("ceph", ["--mon", mon, "daemon", "osd.1",
                                    "perf", "schema"]))
            return rcs

        rcs, text = with_cluster(P, setup, drive, capsys)
        assert rcs == [0, 0]
        status, _, schema = text.partition("}\n")
        assert '"rank": 0' in status and '"osd.1": {' in schema
        # the OSDs' counter sets differ (the port's OSD counts more)
        outs.append((rcs, re.sub(r'"(meta|data)_pool": \d+', "", status)))
    assert outs[0] == outs[1]


# -- the CLI case of tests/test_trace.py --------------------------------------

def test_loop_lag_flows_to_prometheus_and_daemonperf():
    """The lag counters ride the exporter paths: the port's Prometheus
    text and daemonperf rows equal the reference's."""
    from ceph_tpu.cluster.mgr import render_prometheus as jrender
    from ceph_tpu.trace import LoopProfiler as JLoopProfiler
    from ceph_tpu.utils.perf import PerfCounters as JPerf
    from ceph_tpu_torch.cluster.mgr import render_prometheus
    from ceph_tpu_torch.trace import LoopProfiler
    from ceph_tpu_torch.utils.perf import PerfCounters

    got = []
    for perf_cls, prof, render, rate_rows in (
            (PerfCounters, LoopProfiler, render_prometheus,
             pceph._rate_rows),
            (JPerf, JLoopProfiler, jrender, jceph._rate_rows)):
        perf = perf_cls("osd.0")
        mon = prof(perf, interval=0.01, prefix="osd_loop")
        assert mon.enabled
        perf.tinc("osd_loop_lag", 0.02)
        counters = perf.dump()["osd.0"]
        text = render({"osd.0": counters})
        assert "ceph_osd_loop_lag_sum" in text
        assert "ceph_osd_loop_lag_count" in text
        prev = {"osd.0": {"osd_loop_lag": {"avgcount": 0, "sum": 0.0}}}
        rows = rate_rows(prev, {"osd.0": counters}, 1.0)
        assert any("osd_loop_lag" in name for name, _ in rows)
        got.append((text, rows))
    assert got[0] == got[1]


def test_rate_rows_equal_reference():
    prev = {"osd.0": {"ops": 10, "lat": {"avgcount": 4, "sum": 0.4},
                      "same": 3},
            "mds.0": {"reqs": 1}}
    cur = {"osd.0": {"ops": 25, "lat": {"avgcount": 9, "sum": 1.4},
                     "same": 3, "new": 5},
           "mds.0": {"reqs": 7.5}}
    for dt in (1.0, 2.5):
        assert pceph._rate_rows(prev, cur, dt) == \
            jceph._rate_rows(prev, cur, dt)


def test_rados_cli_flags_equal_reference_and_add_device():
    """The port's ``rados`` parses every reference flag the same way and
    adds ``--device`` (default: the card)."""
    for argv in (["--mon", "h:1", "lspools"],
                 ["--mon", "h:1,h:2", "-p", "p", "bench", "3", "seq",
                  "-t", "2", "--block-size", "4096", "--no-cleanup"],
                 ["--mon", "h:1", "-p", "7", "get", "o", "out"]):
        got = vars(prados.parse_args(argv))
        assert got.pop("device") is None
        assert got == vars(jrados.parse_args(argv))
    assert prados.parse_args(["--device", "cpu", "--mon", "h:1",
                              "lspools"]).device == "cpu"
    assert pceph.parse_args(["--mon", "h:1", "status"]).device is None


def test_rados_cli_runs_on_cuda_unless_asked(monkeypatch):
    """With no ``--device`` the CLI's client wants the card and raises
    where there is none, before it connects."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (prados, pceph):
        argv = ["--mon", "127.0.0.1:1", "lspools" if mod is prados
                else "status"]
        with pytest.raises(RuntimeError, match="CUDA"):
            asyncio.run(mod._run(mod.parse_args(argv)))
