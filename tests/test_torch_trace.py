"""The port's ``trace/`` against ``ceph_tpu.trace`` on synthetic events.

Span trees, stage attribution, Perfetto export, the flight recorder, the
event-loop profiler and the postmortem bundle functions need no cluster:
the same synthetic event lists, span dumps, flight feeds and bundles go
through both packages, and the outputs must be equal.  The cases of
``tests/test_trace.py`` and ``tests/test_blackbox.py`` that need no
cluster run against the port as well.
"""

import asyncio
import json
import time
import types

import numpy as np
import pytest

import ceph_tpu.trace as jtrace
import ceph_tpu.trace.attribution as jattr
import ceph_tpu.trace.flight as jflight
import ceph_tpu.trace.perfetto as jperfetto
import ceph_tpu.trace.postmortem as jpm
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.perf as jperf
import ceph_tpu_torch.trace as trace
import ceph_tpu_torch.trace.attribution as attr
import ceph_tpu_torch.trace.flight as flight
import ceph_tpu_torch.trace.perfetto as perfetto
import ceph_tpu_torch.trace.postmortem as pm
import ceph_tpu_torch.utils.config as config
import ceph_tpu_torch.utils.perf as perf

REF = types.SimpleNamespace(trace=jtrace, attr=jattr, flight=jflight,
                            perfetto=jperfetto, pm=jpm, config=jconfig,
                            perf=jperf)
PORT = types.SimpleNamespace(trace=trace, attr=attr, flight=flight,
                             perfetto=perfetto, pm=pm, config=config,
                             perf=perf)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


def synthetic_events():
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


def random_events(seed: int, n: int = 40):
    """A seeded monotone timeline over every known event name plus
    unknown ones."""
    r = np.random.default_rng(seed)
    names = sorted(attr.EVENT_STAGE) + [
        "msgr:osd.3:recv", "msgr:mon.0:send", "lock_acquired:osd.sess",
        "lock_wait:x", "made_up_event"]
    t = np.cumsum(r.random(n) / 1000) - 0.01
    return [(float(ti), names[int(r.integers(0, len(names)))]) for ti in t]


# ----------------------------------------------------------- span tracer


@BOTH
def test_disabled_tracer_is_provably_null(pkg):
    t = pkg.trace.Tracer("osd.0", enabled=False)
    s1 = t.start("a")
    s2 = t.start("b", trace_id="x", parent_id="y")
    assert s1 is pkg.trace.NULL_SPAN and s2 is pkg.trace.NULL_SPAN
    with s1:
        assert t.context() is None
        s1.annotate(k=1)
    s1.finish()
    assert t.dump_recent() == {}
    assert not s1


def span_tree(pkg):
    t = pkg.trace.Tracer("client.x", enabled=True)
    u = pkg.trace.Tracer("osd.1", enabled=True)
    with t.start("op_submit", trace_id="T") as root:
        ctx = t.context()
        assert ctx == {"id": "T", "span": root.span_id}
        with u.start("osd_op", trace_id=ctx["id"],
                     parent_id=ctx["span"]) as osd_span:
            with u.start("ec_sub_write") as inner:
                inner.annotate(shard=3)
    spans = t.dump_trace("T") + u.dump_trace("T")
    assert len(spans) == 3
    for s in spans:
        assert s["dur"] is not None and s["dur"] >= 0
    roots = pkg.trace.assemble_tree(spans)
    assert roots[0]["children"][0]["span_id"] == osd_span.span_id

    def shape(node):
        return (node["name"], node["daemon"], node.get("meta"),
                [shape(c) for c in node["children"]])

    return [shape(r) for r in roots]


def test_span_trees_equal_reference():
    tree = span_tree(PORT)
    assert tree == span_tree(REF)
    assert tree == [("op_submit", "client.x", None, [
        ("osd_op", "osd.1", None, [
            ("ec_sub_write", "osd.1", {"shard": 3}, [])])])]


@BOTH
def test_tracer_ring_bounded(pkg):
    t = pkg.trace.Tracer("osd.0", enabled=True, keep=3)
    for i in range(10):
        t.start("op", trace_id=f"T{i}").finish()
    rec = t.dump_recent(99)
    assert len(rec) == 3 and set(rec) == {"T7", "T8", "T9"}


# ----------------------------------------------------------- attribution


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_attribution_equals_reference(seed):
    ev = synthetic_events() if seed is None else random_events(seed)
    assert attr.attribute_events(ev) == jattr.attribute_events(ev)
    assert attr.spans_from_events(ev) == jattr.spans_from_events(ev)
    lists = [ev, synthetic_events(), random_events(7)]
    rep = attr.aggregate(lists, measured_wall_s=0.03)
    assert rep == jattr.aggregate(lists, measured_wall_s=0.03)
    parts = [attr.aggregate([e]) for e in lists] + [{"ops": 0}]
    assert attr.merge_reports(parts, measured_wall_s=0.03) == \
        jattr.merge_reports(parts, measured_wall_s=0.03)
    for _t, name in ev:
        assert attr.stage_for(name) == jattr.stage_for(name)
    assert attr.EVENT_STAGE == jattr.EVENT_STAGE


@BOTH
def test_attribution_sums_exactly_and_maps_stages(pkg):
    stages, total = pkg.trace.attribute_events(synthetic_events())
    assert abs(sum(stages.values()) - total) < 1e-12
    assert abs(total - 0.0202) < 1e-9
    assert abs(stages["lock:pg.lock"] - 0.001) < 1e-9
    assert abs(stages["device_encode"] - 0.008) < 1e-9
    assert abs(stages["sub_write_wait"] - 0.004) < 1e-9
    assert "wire" in stages and "dispatch_queue" in stages
    agg = pkg.trace.aggregate([synthetic_events()], measured_wall_s=0.021)
    assert agg["ops"] == 1
    assert agg["wall_coverage"] == pytest.approx(0.0202 / 0.021, abs=1e-3)
    assert sum(row["frac"] for row in agg["stages"].values()) == \
        pytest.approx(1.0, abs=0.01)
    a = pkg.trace.aggregate([synthetic_events()])
    merged = pkg.attr.merge_reports([a, a, {"ops": 0}],
                                    measured_wall_s=0.021)
    assert merged["ops"] == 2
    assert merged["stages"]["device_encode"]["s"] == \
        pytest.approx(0.016, abs=1e-6)
    assert pkg.attr.merge_reports([{"ops": 0}]) == \
        {"ops": 0, "traced_total_s": 0.0, "stages": {}}


@BOTH
def test_stage_mapping_rules(pkg):
    sf = pkg.trace.stage_for
    assert sf("msgr:osd.2:recv") == "wire"
    assert sf("msgr:osd.2:send") == "messenger_send"
    assert sf("msgr:flushed") == "messenger_send"
    assert sf("lock_acquired:messenger.session") == "lock:messenger.session"
    assert sf("lock_wait:pg.lock") == "exec"
    assert sf("never_seen_before") == "other:never_seen_before"
    spans = pkg.trace.spans_from_events(synthetic_events())
    assert spans[0]["start"] == 0.0
    assert all(sp["dur"] >= 0 for sp in spans)
    assert any(sp["stage"] == "device_encode" for sp in spans)


def test_aggregate_tracker_equals_reference():
    """The tracker roll-up over completed ops, fed a stand-in tracker."""
    class Op:
        def __init__(self, desc, events):
            self.desc, self.events = desc, events

    class Tracker:
        def __init__(self, ops):
            self.ops = ops

        def history(self):
            return self.ops

    ops = [Op("osd_op(write a)", synthetic_events()),
           Op("osd_op(read b)", random_events(3)),
           Op("osd_op(write c)", random_events(4))]
    got = attr.aggregate_tracker(Tracker(ops), match="write",
                                 measured_wall_s=0.02)
    assert got == jattr.aggregate_tracker(Tracker(ops), match="write",
                                          measured_wall_s=0.02)
    assert got["ops"] == 2


# --------------------------------------------------------------- perfetto


def historic_dump(seed: int):
    ops = []
    for i in range(3):
        ev = random_events(seed + i, 12)
        ops.append({"trace_id": f"T{i}", "description": f"osd_op({i})",
                    "duration": ev[-1][0] - ev[0][0],
                    "type_data": {"events": [{"time": t, "event": e}
                                             for t, e in ev]}})
    return {"osd.0": {"num_ops": 3, "ops": ops},
            "osd.1": {"num_ops": 1, "ops": ops[:1]}}


def test_chrome_traces_equal_reference():
    dumps = historic_dump(11)
    doc = perfetto.chrome_trace_from_dumps(dumps)
    assert doc == jperfetto.chrome_trace_from_dumps(dumps)
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["args"]["name"] == "osd.0" for e in evs)
    slices = [e for e in evs if e["ph"] == "X"]
    assert slices and all(e["dur"] >= 0 and e["ts"] >= 0 for e in slices)
    json.dumps(doc)
    t = trace.Tracer("osd.0", enabled=True)
    with t.start("osd_op", trace_id="T"):
        with t.start("ec_encode"):
            pass
    spans = t.dump_trace("T")
    sdoc = perfetto.chrome_trace_from_spans(spans)
    assert sdoc == jperfetto.chrome_trace_from_spans(spans)
    xs = [e for e in sdoc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in xs) == ["ec_encode", "osd_op"]


def test_perfetto_write_round_trips(tmp_path):
    doc = perfetto.chrome_trace_from_dumps(historic_dump(2))
    out = tmp_path / "t.json"
    perfetto.write(str(out), doc)
    jout = tmp_path / "j.json"
    jperfetto.write(str(jout), doc)
    assert json.loads(out.read_text()) == doc
    assert out.read_bytes() == jout.read_bytes()


# ------------------------------------------------------- flight recorder


class FakeClock:
    def __init__(self, skew):
        self.skew, self.t = skew, 1000.0

    def time(self):
        self.t += 0.25
        return self.t + self.skew


def flight_run(pkg, seed):
    r = np.random.default_rng(seed)
    fr = pkg.flight.FlightRecorder("osd.4", capacity=16, sample_every=3,
                                   clock=FakeClock(2.5))
    for i in range(60):
        if r.random() < 0.5:
            fr.record("queue", depth=int(r.integers(0, 99)))
        else:
            fr.op_sample(f"op{i}", float(r.random()),
                         slow=bool(r.random() < 0.1))
    other = pkg.flight.FlightRecorder("osd.5", capacity=4,
                                      clock=FakeClock(0.0))
    for i in range(6):
        other.record("map", epoch=i)
    dumps = {"osd.4": fr.dump(), "osd.5": other.dump()}
    return dumps, pkg.flight.merged_timeline(dumps), \
        pkg.flight.merged_timeline(dumps, limit=5), fr.dropped


@pytest.mark.parametrize("seed", [0, 1])
def test_flight_recorder_equals_reference(seed):
    mine, theirs = flight_run(PORT, seed), flight_run(REF, seed)
    assert mine == theirs
    dumps, tl, tail, dropped = mine
    assert len(dumps["osd.4"]["events"]) == 16 and dropped > 0
    assert [e["t"] for e in tl] == sorted(e["t"] for e in tl)
    assert tail == tl[-5:]


@BOTH
def test_disabled_recorder_is_the_null_singleton(pkg):
    cfg = pkg.config.Config()
    assert cfg.blackbox_enabled == 0
    for name in ("osd.0", "mon.0", "mgr", "client.x"):
        assert pkg.flight.FlightRecorder.from_config(name, cfg) is \
            pkg.flight.NULL_FLIGHT
    null = pkg.flight.NULL_FLIGHT
    assert not null
    null.record("op", desc="w", dur=1.0)
    null.op_sample("w", 9.9, slow=True)
    assert null.events() == []
    d = null.dump()
    assert d["enabled"] is False and d["events"] == []
    assert type(null).__slots__ == ()
    on = pkg.config.Config(blackbox_enabled=1, blackbox_ring=8)
    fr = pkg.flight.FlightRecorder.from_config("osd.0", on)
    assert fr and fr.ring.maxlen == 8


@BOTH
def test_ring_bounded_sampling_and_skew(pkg):
    fr = pkg.flight.FlightRecorder("osd.9", capacity=8, sample_every=4)
    for i in range(100):
        fr.record("queue", depth=i)
    assert len(fr.events()) == 8 and fr.dropped == 92
    d = fr.dump()
    assert d["capacity"] == 8
    assert [e["data"]["depth"] for e in d["events"]] == list(range(92, 100))
    fr = pkg.flight.FlightRecorder("osd.8", capacity=64, sample_every=4)
    for i in range(16):
        fr.op_sample(f"op{i}", 0.001)
    assert len(fr.events()) == 4
    fr.op_sample("slowop", 9.9, slow=True)
    last = fr.events()[-1]
    assert last[2] == "op" and last[3]["slow"] is True
    a = {"daemon": "osd.0", "skew": 100.0, "events": [
        {"seq": 1, "t": 1100.0, "kind": "map", "data": {"epoch": 2}}]}
    b = {"daemon": "osd.1", "skew": 0.0, "events": [
        {"seq": 1, "t": 999.0, "kind": "map", "data": {"epoch": 1}}]}
    tl = pkg.flight.merged_timeline({"osd.0": a, "osd.1": b})
    assert [e["data"]["epoch"] for e in tl] == [1, 2]
    assert tl[1]["t"] == 1000.0


# ------------------------------------------------------- loop profiler


def test_loop_profiler_catches_a_stall_and_wraps_tasks():
    pc = perf.PerfCounters("t")
    mon = trace.LoopProfiler(pc, interval=0.01, prefix="loop")

    async def scenario():
        loop = asyncio.get_event_loop()
        sampler = loop.create_task(mon.sample())
        try:
            deadline = loop.time() + 5.0
            while loop.time() < deadline and \
                    pc.dump()["t"]["loop_lag"]["avgcount"] < 1:
                await asyncio.sleep(0.005)

            async def stall():
                # a deliberate loop stall: the stimulus under test, not a
                # convergence wait
                # graftlint: ignore[asyncio-blocking] graftlint: ignore[fixed-sleep-in-tests]
                time.sleep(0.08)

            await mon.wrap(stall())
            deadline = loop.time() + 5.0
            while loop.time() < deadline and mon.window_max < 0.05:
                await asyncio.sleep(0.005)
        finally:
            sampler.cancel()

    asyncio.run(scenario())
    assert mon.window_max >= 0.05
    dump = pc.dump()["t"]
    assert dump["loop_lag"]["avgcount"] >= 1
    assert dump["loop_lag"]["max"] >= 0.05
    assert dump["loop_task_spawns"] == 1
    assert dump["loop_task_wall"]["avgcount"] == 1
    mon.reset_window()
    assert mon.window_max == 0.0 and mon.lag_report() is not None


def test_loop_profiler_schema_equals_reference():
    pc, jpc = perf.PerfCounters("osd.0"), jperf.PerfCounters("osd.0")
    trace.LoopProfiler(pc, interval=0.02, prefix="osd_loop")
    jtrace.LoopProfiler(jpc, interval=0.02, prefix="osd_loop")
    assert pc.dump_schema() == jpc.dump_schema()
    assert pc.dump() == jpc.dump()


@BOTH
def test_loop_profiler_disabled_is_identity(pkg):
    pc = pkg.perf.PerfCounters("t")
    mon = pkg.trace.LoopProfiler(pc, interval=0.0)
    assert not mon.enabled and mon.lag_report() is None

    async def coro():
        return 7

    c = coro()
    assert mon.wrap(c) is c

    async def consume():
        return await c

    assert asyncio.run(consume()) == 7
    assert pc.dump()["t"] == {}


# ------------------------------------------------------------ postmortem


def fake_bundle(mod):
    return {
        "kind": mod.BUNDLE_KIND,
        "trigger": {"kind": "slo_gate", "reason": "forced",
                    "detail": {"gates": [{"gate": "goodput", "value": 1,
                                          "threshold": 2}],
                               "seed": 7, "spec": "bb"}},
        "daemons": {
            "osd.0": {"daemon": "osd.0", "skew": 0.0, "dropped": 0,
                      "capacity": 8, "events": [
                          {"seq": 1, "t": 10.0, "kind": "queue",
                           "data": {"depth": 3}}]},
            "osd.1": flight_run(PORT, 3)[0]["osd.4"]},
        "historic_ops": {
            "osd.0": {"ops": {"ops": [
                {"description": "write_full o0 pg=1.2s0",
                 "duration": 0.02,
                 "type_data": {"events": [
                     {"time": 0.0, "event": "initiated"},
                     {"time": 0.02, "event": "done"}]}}]},
                "slow": {"ops": []}},
            "osd.1": {"ops": historic_dump(5)["osd.0"],
                      "slow": {"ops": historic_dump(6)["osd.1"]["ops"]}}},
        "health": {"status": "HEALTH_WARN",
                   "checks": {"SLOW_OPS": "1 slow op"}},
        "health_history": [],
        "mgr_scrape": {"error": "no mgr"},
    }


def test_postmortem_outputs_equal_reference(tmp_path):
    assert pm.BUNDLE_KIND == jpm.BUNDLE_KIND
    b, jb = fake_bundle(pm), fake_bundle(jpm)
    assert pm.replay_key(b) == jpm.replay_key(jb)
    assert pm.breach_report(b) == jpm.breach_report(jb)
    assert pm.chrome_trace(b) == jpm.chrome_trace(jb)
    text = pm.render_report(b)
    assert text == jpm.render_report(jb)
    assert "breach set" in text and "goodput" in text
    assert "SLOW_OPS" in text
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    path = pm.write_bundle(b, str(tmp_path / "p"))
    jpath = jpm.write_bundle(jb, str(tmp_path / "j"))
    assert path.rsplit("/", 1)[1] == jpath.rsplit("/", 1)[1]
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert pm.load_bundle(path) == json.loads(json.dumps(b))
    bad = tmp_path / "POSTMORTEM_x_nota.json"
    bad.write_text(json.dumps({"kind": "something-else"}))
    with pytest.raises(ValueError, match="not a"):
        pm.load_bundle(str(bad))


@BOTH
def test_replay_key_ignores_wall_stamps(pkg):
    b1, b2 = fake_bundle(pkg.pm), fake_bundle(pkg.pm)
    b2["daemons"]["osd.0"]["events"][0]["t"] = 99999.0
    b2["historic_ops"]["osd.0"]["ops"]["ops"][0]["duration"] = 5.0
    assert pkg.pm.replay_key(b1) == pkg.pm.replay_key(b2)
    b3 = fake_bundle(pkg.pm)
    b3["trigger"]["reason"] = "a different conviction"
    assert pkg.pm.replay_key(b3) != pkg.pm.replay_key(b1)


def test_trace_exports_equal_reference():
    assert sorted(n for n in dir(trace) if not n.startswith("_")) == \
        sorted(n for n in dir(jtrace) if not n.startswith("_"))
