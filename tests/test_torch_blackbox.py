"""The port's blackbox CLI (``python -m ceph_tpu_torch.tools.blackbox``)
against ``scripts/blackbox.py``, and the four postmortem triggers of
``tests/test_blackbox.py`` on a port cluster.

The CLI keeps the reference's exit codes (0 success, 1 a bundle found but
malformed for the request, 2 usage / no bundle / not a bundle), and its
``report``, ``report --json``, ``key`` and ``perfetto`` output equals the
reference CLI's on the same bundle: a synthetic one, and a bundle the
port's cluster wrote.

The triggers run on ``device="cpu"``, each under its own deadline: a
forced SLO-gate failure, a forced chaos conviction replayed to the same
bundle path and replay key, an armed crash point, and the mon's edge into
HEALTH_ERR.  Each produces exactly one parseable bundle.
"""

import asyncio
import json
import os
import subprocess
import sys
from dataclasses import replace

import pytest

from ceph_tpu_torch.trace import postmortem as pm
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 120.0
TIMEOUT = 120


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


def port(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.blackbox", *args],
        cwd=cwd, capture_output=True, text=True, timeout=TIMEOUT, env=env)


def ref(args, cwd):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "blackbox.py"),
         *args],
        cwd=cwd, capture_output=True, text=True, timeout=TIMEOUT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def _fake_bundle():
    return {
        "kind": pm.BUNDLE_KIND,
        "trigger": {"kind": "slo_gate", "reason": "forced",
                    "detail": {"gates": [{"gate": "goodput", "value": 1,
                                          "threshold": 2}],
                               "seed": 7, "spec": "bb"}},
        "daemons": {"osd.0": {"daemon": "osd.0", "skew": 0.0,
                              "dropped": 0, "capacity": 8, "events": [
                                  {"seq": 1, "t": 10.0, "kind": "queue",
                                   "data": {"depth": 3}}]}},
        "historic_ops": {"osd.0": {"ops": {"ops": [
            {"description": "write_full o0 pg=1.2s0",
             "duration": 0.02,
             "type_data": {"events": [
                 {"time": 0.0, "event": "initiated"},
                 {"time": 0.02, "event": "done"}]}}]},
            "slow": {"ops": []}}},
        "health": {"status": "HEALTH_OK", "checks": {}},
        "health_history": [],
        "mgr_scrape": {"error": "no mgr"},
    }


def assert_cli_equals_reference(path, tmp_path):
    """Every subcommand of both CLIs on the bundle at ``path``: equal exit
    codes and output (the perfetto document compared as written)."""
    for args in (["report", path], ["report", path, "--json"],
                 ["report", path, "--tail", "3"], ["key", path]):
        got, want = port(args, tmp_path), ref(args, tmp_path)
        assert got.returncode == want.returncode == 0, \
            got.stderr + want.stderr
        assert got.stdout == want.stdout, args
    outs = []
    for cli, name in ((port, "p"), (ref, "r")):
        out = str(tmp_path / f"{name}.trace.json")
        res = cli(["perfetto", path, "--out", out], tmp_path)
        assert res.returncode == 0, res.stderr
        outs.append((res.stdout.replace(out, "OUT"),
                     json.loads(open(out).read())))
    assert outs[0] == outs[1]
    assert outs[0][1]["traceEvents"]


# ----------------------------------------------------------- report CLI


def test_cli_exit_codes(tmp_path):
    """Exit-code contract: 0 success, 1 bundle found but malformed for
    the request, 2 usage / no bundle / not a bundle."""
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port(["report"], empty).returncode == 2
    bad = tmp_path / "POSTMORTEM_x_nota.json"
    bad.write_text(json.dumps({"kind": "something-else"}))
    assert port(["key", str(bad)], tmp_path).returncode == 2
    good = tmp_path / "POSTMORTEM_slo_gate_abc.json"
    good.write_text(json.dumps(_fake_bundle()))
    r = port(["report", str(good)], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "breach set" in r.stdout and "goodput" in r.stdout
    r = port(["key", str(good)], tmp_path)
    assert r.returncode == 0 and len(r.stdout.strip()) == 64
    out = tmp_path / "t.trace.json"
    r = port(["perfetto", str(good), "--out", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    assert json.loads(out.read_text())["traceEvents"]
    rot = _fake_bundle()
    rot["daemons"]["osd.0"]["events"][0]["t"] = "not-a-stamp"
    rot_p = tmp_path / "POSTMORTEM_slo_gate_rot.json"
    rot_p.write_text(json.dumps(rot))
    assert port(["report", str(rot_p)], tmp_path).returncode == 1


def test_cli_exit_codes_equal_reference(tmp_path):
    """The same five cases through both CLIs: equal exit codes, and equal
    output where they succeed."""
    empty = tmp_path / "empty"
    empty.mkdir()
    bad = tmp_path / "POSTMORTEM_x_nota.json"
    bad.write_text(json.dumps({"kind": "something-else"}))
    rot = _fake_bundle()
    rot["daemons"]["osd.0"]["events"][0]["t"] = "not-a-stamp"
    rot_p = tmp_path / "POSTMORTEM_slo_gate_rot.json"
    rot_p.write_text(json.dumps(rot))
    for args, cwd, rc in ((["report"], empty, 2),
                          (["key", str(bad)], tmp_path, 2),
                          (["report", str(rot_p)], tmp_path, 1),
                          (["perfetto", str(tmp_path / "nope.json")],
                           tmp_path, 2)):
        got, want = port(args, cwd), ref(args, cwd)
        assert got.returncode == want.returncode == rc, args
        assert got.stdout == want.stdout


def test_cli_output_equals_reference_on_one_bundle(tmp_path):
    good = tmp_path / "POSTMORTEM_slo_gate_abc.json"
    good.write_text(json.dumps(_fake_bundle()))
    assert_cli_equals_reference(str(good), tmp_path)


def test_cli_defaults_to_the_newest_bundle_here(tmp_path):
    """With no PATH both CLIs read the newest POSTMORTEM_*.json of the
    current directory."""
    old = _fake_bundle()
    old["trigger"]["reason"] = "older"
    (tmp_path / "POSTMORTEM_slo_gate_old.json").write_text(json.dumps(old))
    os.utime(tmp_path / "POSTMORTEM_slo_gate_old.json", (1, 1))
    (tmp_path / "POSTMORTEM_slo_gate_new.json").write_text(
        json.dumps(_fake_bundle()))
    got, want = port(["key"], tmp_path), ref(["key"], tmp_path)
    assert got.returncode == want.returncode == 0
    assert got.stdout == want.stdout == \
        pm.replay_key(_fake_bundle()) + "\n"


# ------------------------------------------------------- trigger matrix


def test_slo_gate_failure_produces_postmortem_bundle(tmp_path):
    """A forced SLO-gate failure (an unreachable goodput floor) produces
    exactly one parseable bundle whose breach attribution explains at
    least 0.9 of the late ops' wall; both CLIs read it alike."""
    from ceph_tpu_torch.load.driver import builtin_specs, run_load

    spec = replace(
        builtin_specs()["smoke-micro"], name="bb-slo",
        gates=(("goodput_min_frac", 1e9),),
        config=(("blackbox_enabled", 1),
                ("blackbox_dir", str(tmp_path))))
    _result, report = run(run_load(spec, 7, device="cpu"))
    assert not report.passed
    assert any(g["gate"] == "goodput" for g in report.failing_gates())
    assert report.postmortem and os.path.exists(report.postmortem)
    bundle = pm.load_bundle(report.postmortem)
    assert bundle["trigger"]["kind"] == "slo_gate"
    det = {g["gate"]: g for g in bundle["trigger"]["detail"]["gates"]}
    assert det["goodput"]["threshold"] >= 1e9
    breach = bundle["breach"]
    assert breach["breach_ops"] >= 1
    assert breach["attribution"]["wall_coverage"] >= 0.9
    assert breach["suspects"], "top-suspects table must not be empty"
    assert any(k.startswith("client.") for k in bundle["daemons"])
    bundles = sorted(p.name for p in tmp_path.glob("POSTMORTEM_*.json"))
    assert len(bundles) == 1, bundles
    cli_dir = tmp_path / "cli"
    cli_dir.mkdir()
    assert_cli_equals_reference(report.postmortem, cli_dir)


@pytest.mark.chaos
def test_chaos_conviction_bundle_replays_bit_identical(tmp_path):
    """A forced chaos conviction (an unreachable epochs floor) produces a
    bundle, the verdict records the failing gate's row and the bundle
    path, and a seeded rerun lands on the same path with a bit-identical
    replay key."""
    from ceph_tpu_torch.chaos.scenario import Scenario, run_scenario

    sc = Scenario(
        name="bb-conv", osds=3, pool_size=2, pg_num=4, rounds=1,
        objects_per_round=2, payload_repeat=10,
        invariants=("durability",), epochs_floor=1e9,
        config=(("blackbox_enabled", 1),
                ("blackbox_dir", str(tmp_path))),
        converge_timeout=45.0)
    v1 = run(run_scenario(sc, 13, device="cpu"))
    assert not v1.passed
    rows = {g["gate"]: g for g in v1.gates}
    assert rows["epochs"]["passed"] is False
    assert rows["epochs"]["threshold"] == 1e9
    assert v1.postmortem and os.path.exists(v1.postmortem)
    b1 = pm.load_bundle(v1.postmortem)
    assert b1["trigger"]["kind"] == "chaos_conviction"
    assert b1["trigger"]["detail"]["gates"]
    assert b1["breach"]["attribution"].get("wall_coverage", 0) >= 0.9
    k1 = pm.replay_key(b1)
    v2 = run(run_scenario(sc, 13, device="cpu"))
    assert v2.postmortem == v1.postmortem
    assert pm.replay_key(pm.load_bundle(v2.postmortem)) == k1


def test_crash_point_trigger_produces_one_bundle(tmp_path):
    """An armed crash point power-cuts its daemon and fires a postmortem,
    taken with the victim already down."""
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster

    async def scenario():
        cfg = _fast_config()
        cfg.set("blackbox_enabled", 1)
        cfg.set("blackbox_dir", str(tmp_path))
        cluster = await start_cluster(4, config=cfg, device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create("bb", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            await io.write_full("o0", b"x" * 4096)
            pgid = client.objecter.object_pgid(pool, "o0")
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(pgid)
            cluster.osds[primary].config.injectargs(
                {"chaos_crash_point": "commit_pre_fanout"})
            await io.write_full("o0", b"y" * 4096, timeout=60)
            await cluster.drain_chaos()
            await cluster.drain_blackbox()
            recs = [r for r in cluster.postmortems
                    if r["kind"] == "crash_point"]
            assert len(recs) == 1, cluster.postmortems
            assert f"osd.{primary}" in recs[0]["reason"]
            assert recs[0]["path"] and os.path.exists(recs[0]["path"])
            bundle = pm.load_bundle(recs[0]["path"])
            assert f"osd.{primary}" not in bundle["daemons"]
            assert any(d.get("events")
                       for d in bundle["daemons"].values()
                       if isinstance(d, dict))
        finally:
            await cluster.stop()

    run(scenario())


def test_health_err_transition_triggers_one_bundle(tmp_path):
    """The mon's edge into HEALTH_ERR (every OSD down) fires exactly one
    bundle, and the mon's bounded health-history ring records the raise
    and the status transition and serves them over the admin socket."""
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster

    async def scenario():
        cfg = _fast_config()
        cfg.set("blackbox_enabled", 1)
        cfg.set("blackbox_dir", str(tmp_path))
        cfg.set("mon_health_history", 8)
        cluster = await start_cluster(2, config=cfg, device="cpu")
        try:
            await cluster.client()
            for osd_id in sorted(cluster.osds):
                await cluster.kill_osd(osd_id)
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 30
            while loop.time() < deadline and not cluster.postmortems:
                await asyncio.sleep(0.1)
            await cluster.drain_blackbox()
            recs = [r for r in cluster.postmortems
                    if r["kind"] == "health_err"]
            assert len(recs) == 1, cluster.postmortems
            bundle = pm.load_bundle(recs[0]["path"])
            assert bundle["trigger"]["detail"]["checks"].get("OSD_DOWN")
            hist = bundle["health_history"]
            assert any(r["check"] == "OSD_DOWN" and r["op"] == "raise"
                       for r in hist)
            served = await cluster.daemon_command("mon.0",
                                                  "health history")
            assert len(served) <= 8
            assert any(r["check"] == "STATUS"
                       and r["severity"] == "HEALTH_ERR"
                       for r in served)
        finally:
            await cluster.stop()

    run(scenario())
