"""The port's trace CLI (``ceph_tpu_torch/tools/trace.py``) and its
traced clusters against ``ceph_tpu``'s: the cases of
``tests/test_trace.py`` that need a CLI or a cluster.

``convert`` of one dump gives the same Chrome-trace JSON through both
CLIs.  Every cluster case runs its scenario on a cluster of each package
(the port's on ``device="cpu"``), each under its own ``asyncio.wait_for``
bound; each run keeps the reference test's assertions, and the two agree
on what does not depend on timing: the shape of the traced op's span
tree (span names and daemon kinds) and its set of stages, the stored EC
shards of a traced and an untraced write, and whether the loop-lag
warning rose and cleared.  No timing is compared.
"""

import asyncio
import importlib
import json
import os
import subprocess
import sys
import time

from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixture)
    BOUND, _port_lockdep_reset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
PKGS = {"port": ("ceph_tpu_torch", {"device": "cpu"}),
        "ref": ("ceph_tpu", {})}

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}


def imp(side: str, path: str):
    return importlib.import_module(f"{PKGS[side][0]}.{path}")


async def boot(side: str, n: int, config):
    vstart = imp(side, "cluster.vstart")
    return await vstart.start_cluster(n, config=config, **PKGS[side][1])


def run_both(scenario):
    """``scenario(side)`` for the port, then the reference, each under
    its own deadline; returns {side: result}."""
    return {side: asyncio.run(asyncio.wait_for(scenario(side), BOUND))
            for side in PKGS}


def _synthetic_events():
    return [
        (-0.005, "objecter:submit"),
        (-0.004, "objecter:send"),
        (-0.003, "msgr:client.1:send"),
        (-0.001, "msgr:osd.0:recv"),
        (0.0, "initiated"),
        (0.0001, "dispatched"),
        (0.0002, "lock_wait:pg.lock"),
        (0.0012, "lock_acquired:pg.lock"),
        (0.002, "ec_encode"),
        (0.010, "ec_encoded"),
        (0.0105, "store:commit"),
        (0.011, "ec_sub_write_sent"),
        (0.015, "sub_write_acked"),
        (0.0151, "commit"),
        (0.0152, "done"),
    ]


# ------------------------------------------------------------ CLI (convert)


def test_trace_cli_exit_codes(tmp_path):
    """The port's trace CLI exit codes, code for code with
    ``scripts/trace.py``: 0 on a good convert (with the reference's
    Chrome-trace JSON), 1 on bad input, 2 on usage errors."""
    port = [sys.executable, "-m", "ceph_tpu_torch.tools.trace"]
    ref = [sys.executable, os.path.join(REPO, "scripts", "trace.py")]

    def both(*args):
        procs = [subprocess.Popen(cmd + list(args), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  cwd=REPO, env=ENV)
                 for cmd in (port, ref)]
        out = [(p.wait(timeout=60), p.stderr.read()) for p in procs]
        for p in procs:
            p.stdout.close()
            p.stderr.close()
        assert out[0][0] == out[1][0], (args, out)
        assert "Traceback" not in out[0][1], (args, out[0][1])
        return out[0][0]

    dump = {"num_ops": 1, "ops": [{
        "trace_id": "T1", "description": "osd_op",
        "type_data": {"events": [
            {"time": t, "event": e} for t, e in _synthetic_events()]}}]}
    df = tmp_path / "dump.json"
    df.write_text(json.dumps(dump))
    multi = tmp_path / "multi.json"
    multi.write_text(json.dumps({"osd.0": dump, "osd.1": dump}))
    for src in (df, multi):
        outs = [tmp_path / f"{side}_{src.stem}.json"
                for side in ("port", "ref")]
        for cmd, out in zip((port, ref), outs):
            proc = subprocess.run(cmd + ["convert", str(src), "-o",
                                         str(out)],
                                  capture_output=True, text=True, timeout=60,
                                  cwd=REPO, env=ENV)
            assert proc.returncode == 0, proc.stdout + proc.stderr
        doc = json.loads(outs[0].read_text())
        assert doc["traceEvents"]
        assert doc == json.loads(outs[1].read_text())
    # missing input -> 1
    assert both("convert", str(tmp_path / "nope.json")) == 1
    # a bare JSON array (not a dump payload) -> clean 1, no traceback
    dfa = tmp_path / "array.json"
    dfa.write_text(json.dumps([1, 2, 3]))
    assert both("convert", str(dfa)) == 1
    # empty dump -> 1
    df2 = tmp_path / "empty.json"
    df2.write_text(json.dumps({"num_ops": 0, "ops": []}))
    assert both("convert", str(df2)) == 1
    # usage error -> 2 (argparse)
    assert both("bogus") == 2


# ------------------------------------------------------------------- e2e


def _trace_config(side):
    vstart = imp(side, "cluster.vstart")
    config = vstart._fast_config()
    config.trace_enabled = 1
    config.osd_op_history_size = 200
    return config


def _shape(nodes):
    """A span tree without timings or ids: (span name, daemon kind,
    children's shapes sorted)."""
    return sorted((n["name"], n["daemon"].split(".")[0],
                   _shape(n["children"])) for n in nodes)


def test_traced_op_cross_daemon_smoke():
    """One traced EC write through a 3-OSD cluster of each package: the
    reference test's span tree, optracker timeline and attribution
    checks hold in both, and the trees' shapes and the stage sets are
    equal."""

    async def scenario(side):
        assemble_tree = imp(side, "trace.span").assemble_tree
        attribute_events = imp(side, "trace.attribution").attribute_events
        cluster = await boot(side, 3, _trace_config(side))
        try:
            client = await cluster.client()
            pool = await client.pool_create("tr", "erasure", pg_num=4,
                                            ec_profile=EC_PROFILE)
            io = client.ioctx(pool)
            await io.write_full("warm", b"w" * 8192)  # first-call warmup
            t0 = time.perf_counter()
            await io.write_full("traced", b"\xa5" * 65536)
            wall = time.perf_counter() - t0
            tracer = client.objecter.tracer
            tid = list(tracer._traces)[-1]
            spans = tracer.dump_trace(tid)
            for oid in cluster.osds:
                spans += await cluster.daemon_command(
                    f"osd.{oid}", {"prefix": "trace dump",
                                   "args": {"trace_id": tid}})
            roots = assemble_tree(spans)
            assert len(roots) == 1, [s["name"] for s in spans]
            root = roots[0]
            assert root["name"] == "op_submit"
            assert root["daemon"].startswith("client.")
            osd_ops = [c for c in root["children"]
                       if c["name"] == "osd_op"]
            assert len(osd_ops) == 1
            subs = [c for c in osd_ops[0]["children"]
                    if c["name"] == "ec_sub_write"]
            assert len(subs) == 2  # k2m1 on 3 osds: two peer shards
            # the tree reaches all three OSDs
            assert {osd_ops[0]["daemon"]} | {s["daemon"] for s in subs} \
                == {f"osd.{o}" for o in cluster.osds}
            found = None
            for oid in cluster.osds:
                hist = await cluster.daemon_command(
                    f"osd.{oid}", "dump_historic_ops")
                for op in hist["ops"]:
                    if op.get("trace_id") == tid:
                        found = op
            assert found is not None
            names = [e["event"] for e in found["type_data"]["events"]]
            assert "objecter:submit" in names
            assert any(n.startswith("msgr:") and n.endswith(":recv")
                       for n in names)
            assert (("batch_parked" in names and "batch_tick" in names
                     and "batch_encoded" in names)
                    or ("ec_encode" in names and "ec_encoded" in names))
            assert "store:commit" in names
            assert "ec_sub_write_sent" in names
            assert "sub_write_acked" in names
            assert "lock_acquired:pg.lock" in names
            times = [e["time"] for e in found["type_data"]["events"]]
            assert times == sorted(times)
            assert found["spans"]
            evs = [(e["time"], e["event"])
                   for e in found["type_data"]["events"]]
            stages, total = attribute_events(evs)
            assert abs(sum(stages.values()) - total) < 1e-9
            assert total >= 0.85 * wall, (total, wall, stages)
            assert "batch_encode" in stages or "device_encode" in stages
            primary = client.objecter._target_osd(
                client.objecter.object_pgid(pool, "traced"))
            rep = await cluster.daemon_command(
                f"osd.{primary}",
                {"prefix": "dump_op_attribution",
                 "args": {"match": "write_full",
                          "measured_wall_s": wall}})
            assert rep["ops"] >= 1
            assert rep["wall_coverage"] >= 0.85
            return _shape(roots), sorted(stages), primary
        finally:
            await cluster.stop()

    got = run_both(scenario)
    assert got["port"] == got["ref"]


def test_trace_survives_reconnect_and_daemon_restart():
    """Trace propagation survives a chaos-dropped (and retransmitted)
    frame and a primary daemon restart, in both packages: every write
    that rode a dropped frame still carries its client trace, and a
    restarted primary keeps absorbing headers."""

    async def scenario(side):
        cluster = await boot(side, 3, _trace_config(side))
        try:
            client = await cluster.client()
            pool = await client.pool_create("tr2", "replicated",
                                            pg_num=4, size=2)
            io = client.ioctx(pool)
            await io.write_full("pre", b"x")
            client.objecter.config.injectargs(
                {"chaos_seed": 7, "chaos_net_drop": 0.25})
            for i in range(6):
                await io.write_full(f"dropped_{i}", bytes([i]) * 512)
            client.objecter.config.injectargs({"chaos_net_drop": 0.0})

            async def traced_ids():
                out = set()
                for oid in cluster.osds:
                    hist = await cluster.daemon_command(
                        f"osd.{oid}", "dump_historic_ops")
                    for op in hist["ops"]:
                        if op.get("trace_id"):
                            names = [e["event"]
                                     for e in op["type_data"]["events"]]
                            assert "objecter:submit" in names
                            out.add(op["trace_id"])
                return out

            before = len(await traced_ids())
            assert before >= 7
            pgid = client.objecter.object_pgid(pool, "after_restart")
            primary = client.objecter._target_osd(pgid)
            await cluster.restart_osd(primary)
            await io.write_full("after_restart", b"z" * 512)
            newest = list(client.objecter.tracer._traces)[-1]
            assert newest in await traced_ids()
            return primary
        finally:
            await cluster.stop()

    got = run_both(scenario)
    assert got["port"] == got["ref"]   # the same primary restarted


def test_tracing_disabled_bit_identical_ec_write():
    """Tracing on and off store bit-identical EC shards in the port, and
    the port's shards are the reference's."""
    payloads = {f"obj_{i}": bytes([i * 17 % 251]) * (4096 * (i + 1))
                for i in range(3)}

    def run_one(trace_on: bool):
        async def scenario(side):
            vstart = imp(side, "cluster.vstart")
            config = vstart._fast_config()
            config.trace_enabled = 1 if trace_on else 0
            cluster = await boot(side, 3, config)
            try:
                client = await cluster.client()
                pool = await client.pool_create("bit", "erasure", pg_num=4,
                                                ec_profile=EC_PROFILE)
                io = client.ioctx(pool)
                for oid, data in payloads.items():
                    await io.write_full(oid, data)
                state = {}
                for osd_id, osd in cluster.osds.items():
                    for coll in osd.store.list_collections():
                        if not coll.startswith(f"pg_{pool}_"):
                            continue
                        for name in osd.store.list_objects(coll):
                            if name not in payloads:
                                continue
                            state[(osd_id, coll, name)] = (
                                bytes(osd.store.read(coll, name)),
                                osd.store.getattr(coll, name, "shard"),
                                osd.store.getattr(coll, name, "hinfo_crc"),
                            )
                return state
            finally:
                await cluster.stop()

        return scenario

    on = run_both(run_one(True))
    off = asyncio.run(asyncio.wait_for(run_one(False)("port"), BOUND))
    assert on["port"] and on["port"] == off
    assert on["port"] == on["ref"]


def test_loop_lag_health_warning_raises_and_clears():
    """Sustained loop lag raises LOOP_LAG beside SLOW_OPS (beacon-fed)
    and clears once the loop drains, in both packages."""

    async def scenario(side):
        vstart = imp(side, "cluster.vstart")
        config = vstart._fast_config()
        config.loop_profile_interval = 0.02
        config.loop_lag_warn = 0.05
        cluster = await boot(side, 2, config)
        try:
            client = await cluster.client()
            pool = await client.pool_create("ll", "replicated",
                                            pg_num=2, size=2)
            await client.ioctx(pool).write_full("o", b"x")
            spawns = walls = 0
            for oid in cluster.osds:
                d = await cluster.daemon_command(f"osd.{oid}",
                                                 "perf dump")
                spawns += d[f"osd.{oid}"]["osd_loop_task_spawns"]
                walls += d[f"osd.{oid}"]["osd_loop_task_wall"]["avgcount"]
            assert spawns >= 1 and walls >= 1

            async def stall():
                # block the shared loop long enough for a sample to
                # overshoot the warn threshold — the duration IS the
                # test stimulus, not a convergence wait
                # graftlint: ignore[asyncio-blocking] graftlint: ignore[fixed-sleep-in-tests]
                time.sleep(0.12)

            await stall()
            deadline = asyncio.get_event_loop().time() + 5.0
            seen = False
            while asyncio.get_event_loop().time() < deadline:
                health = await client.objecter.mon_command(
                    {"prefix": "health"})
                if "LOOP_LAG" in health["checks"]:
                    seen = True
                    break
                await asyncio.sleep(0.05)
            assert seen, health
            deadline = asyncio.get_event_loop().time() + 5.0
            while asyncio.get_event_loop().time() < deadline:
                health = await client.objecter.mon_command(
                    {"prefix": "health"})
                if "LOOP_LAG" not in health["checks"]:
                    return "raised and cleared"
                await asyncio.sleep(0.05)
            raise AssertionError(f"LOOP_LAG never cleared: {health}")
        finally:
            await cluster.stop()

    got = run_both(scenario)
    assert got["port"] == got["ref"] == "raised and cleared"
