"""The port's load driver and SLO judge (``ceph_tpu_torch/load/``) against
``ceph_tpu``'s, on the cases of ``tests/test_load.py``.

Host determinism, exact equality with the reference throughout:

- every seeded sampler of ``load/dist.py`` draws what the reference's
  draws from the same stream;
- ``build_plan`` and ``plan_key`` equal the reference's for every spec of
  ``builtin_specs()`` at seeds 0-4, and the spec library equals the
  reference's entry for entry;
- ``slo.parse_prometheus``, the histogram quantile and ``slo.judge`` give
  the reference's rows on the synthetic before/after snapshots of
  ``tests/test_load.py``.

The whole run: ``run_load`` of the ``smoke`` spec at seed 42 on a port
cluster (``device="cpu"``, under its own deadline) passes every gate, and
its plan key equals the reference's.  The reference's own cluster is not
run here: ``tests/test_load.py`` runs it.
"""

import asyncio
import dataclasses
import random

import pytest

import ceph_tpu.load.dist as jdist
import ceph_tpu.load.driver as jdriver
import ceph_tpu.load.slo as jslo
import ceph_tpu_torch.load.dist as dist
import ceph_tpu_torch.load.driver as driver
import ceph_tpu_torch.load.slo as slo
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 120.0
SPECS = sorted(jdriver.builtin_specs())
SEEDS = range(5)


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


# ------------------------------------------------------------- dist


@pytest.mark.parametrize("process", ["poisson", "fixed"])
@pytest.mark.parametrize("seed,cid,rate,duration", [
    (7, 3, 5.0, 2.0), (0, 0, 1.2, 2.5), (42, 63, 0.8, 3.0),
    (1, 1, 0.0, 2.0), (9, 5, 40.0, 0.5)])
def test_arrival_offsets_equal_reference(process, seed, cid, rate,
                                         duration):
    a, b = dist.client_stream(seed, cid), jdist.client_stream(seed, cid)
    got = dist.arrival_offsets(a, rate, duration, process)
    assert got == jdist.arrival_offsets(b, rate, duration, process)
    assert a.getstate() == b.getstate()


def test_arrival_offsets_refuse_an_unknown_process():
    for mod in (dist, jdist):
        with pytest.raises(ValueError):
            mod.arrival_offsets(random.Random(1), 1.0, 1.0, "bogus")


@pytest.mark.parametrize("n,alpha", [(64, 1.2), (32, 1.2), (16, 0.9),
                                     (1, 1.2), (24, 2.0)])
def test_zipf_pick_equals_reference(n, alpha):
    a, b = random.Random(n * 1000 + 7), random.Random(n * 1000 + 7)
    got = [dist.zipf_pick(a, n, alpha) for _ in range(500)]
    assert got == [jdist.zipf_pick(b, n, alpha) for _ in range(500)]
    assert a.getstate() == b.getstate()


def test_zipf_pick_takes_one_draw_a_pick():
    a, b = random.Random(123), random.Random(123)
    for _ in range(50):
        dist.zipf_pick(a, 64)
        b.random()
    assert a.getstate() == b.getstate()


@pytest.mark.parametrize("spec", SPECS)
def test_pick_weighted_equals_reference_on_each_verb_mix(spec):
    verbs = jdriver.builtin_specs()[spec].verbs
    a, b = dist.client_stream(9, 0), jdist.client_stream(9, 0)
    got = [dist.pick_weighted(a, verbs) for _ in range(300)]
    assert got == [jdist.pick_weighted(b, verbs) for _ in range(300)]


@pytest.mark.parametrize("seed,cid,tag", [(0, 0, "sched"), (42, 17, "sched"),
                                          (5, 3, "other")])
def test_client_stream_draws_equal_reference(seed, cid, tag):
    a, b = dist.client_stream(seed, cid, tag), \
        jdist.client_stream(seed, cid, tag)
    assert [a.random() for _ in range(64)] == [b.random() for _ in range(64)]


# ------------------------------------------------------------- plans


@pytest.mark.parametrize("name", SPECS)
def test_spec_library_equals_reference(name):
    assert sorted(driver.builtin_specs()) == SPECS
    assert dataclasses.asdict(driver.builtin_specs()[name]) == \
        dataclasses.asdict(jdriver.builtin_specs()[name])
    assert driver.DEFAULT_GATES == jdriver.DEFAULT_GATES
    assert driver.DEFAULT_VERBS == jdriver.DEFAULT_VERBS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SPECS)
def test_build_plan_and_key_equal_reference(name, seed):
    got = driver.build_plan(driver.builtin_specs()[name], seed)
    ref = jdriver.build_plan(jdriver.builtin_specs()[name], seed)
    assert got == ref
    assert driver.plan_key(got) == jdriver.plan_key(ref)


def test_plan_streams_are_per_client():
    spec = driver.builtin_specs()["smoke"]
    fewer = dataclasses.replace(spec, clients=8)
    assert driver.build_plan(fewer, 42) == driver.build_plan(spec, 42)[:8]


@pytest.mark.parametrize("nonce", [0, 1, 12345, (1 << 30) - 1])
def test_payload_equals_reference(nonce):
    for name in SPECS:
        got = driver._payload(driver.builtin_specs()[name], 3, "obj7", nonce)
        assert got == jdriver._payload(jdriver.builtin_specs()[name], 3,
                                       "obj7", nonce)


# ------------------------------------------------------------- the judge

PROM_TEXT = (
    "# TYPE ceph_osd_client_ops untyped\n"
    'ceph_osd_client_ops{daemon="osd.0"} 10\n'
    'ceph_osd_client_ops{daemon="osd.1"} 5\n'
    'ceph_client_cwnd{daemon="client.load0"} 256\n'
    'ceph_osd_op_lat_hist_bucket{daemon="osd.0",le="0.002"} 3\n'
    'ceph_osd_op_lat_hist_bucket{daemon="osd.0",le="+Inf"} 4\n'
    "not a series line\n"
    'ceph_weird{daemon="osd.0"} +Inf\n'
    "ceph_unparsed 1.2.3\n")


def test_parse_prometheus_and_counters_equal_reference():
    got, ref = slo.parse_prometheus(PROM_TEXT), jslo.parse_prometheus(
        PROM_TEXT)
    assert got == ref
    snap = slo.TelemetrySnapshot(prom=got, health={}, dmclock={})
    jsnap = jslo.TelemetrySnapshot(prom=ref, health={}, dmclock={})
    for metric, prefix in (("ceph_osd_client_ops", "osd."),
                           ("ceph_client_cwnd", "client.")):
        assert slo.counter_sum(snap, metric, prefix) == \
            jslo.counter_sum(jsnap, metric, prefix)
    assert slo.counter_sum(snap, "ceph_osd_client_ops") == 15


def _hist_rows(buckets):
    return [({"daemon": daemon, "le": le}, cum)
            for daemon, per_le in buckets.items()
            for le, cum in per_le.items()]


def _snaps(mod, prom, health=None, dmclock=None):
    return mod.TelemetrySnapshot(prom=prom, health=health or {},
                                 dmclock=dmclock or {})


HISTS = {
    "empty": {"osd.0": {"0.002": 0, "0.004": 0, "+Inf": 0}},
    "two_buckets": {"osd.0": {"0.002": 90, "0.004": 100, "+Inf": 100}},
    "spill": {"osd.0": {"0.002": 90, "0.004": 95, "+Inf": 100}},
    "no_inf": {"osd.0": {"0.002": 50, "0.004": 60},
               "osd.1": {"0.002": 10, "0.008": 40}},
}


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 1.0])
@pytest.mark.parametrize("after", sorted(HISTS))
def test_hist_quantile_equals_reference(after, q):
    metric = "ceph_osd_op_lat_hist"
    before = {f"{metric}_bucket": _hist_rows(HISTS["empty"])}
    aft = {f"{metric}_bucket": _hist_rows(HISTS[after])}
    got = slo.hist_quantile(_snaps(slo, before), _snaps(slo, aft), metric, q)
    assert got == jslo.hist_quantile(_snaps(jslo, before),
                                     _snaps(jslo, aft), metric, q)


def _prom(ops=0, cwnd=256, pushbacks=0, hist=None, res=0, evicted=0):
    """The synthetic scrape of ``tests/test_load.py::_mk_snap``."""
    prom = {
        "ceph_osd_client_ops": [({"daemon": "osd.0"}, ops)],
        "ceph_client_cwnd": [({"daemon": "client.load0"}, cwnd)],
        "ceph_client_cwnd_pushbacks": [({"daemon": "client.load0"},
                                        pushbacks)],
        "ceph_osd_qos_served_reservation": [({"daemon": "osd.0"}, res)],
        "ceph_osd_qos_evicted": [({"daemon": "osd.0"}, evicted)],
        "ceph_osd_map_epochs_applied": [({"daemon": "osd.0"}, 5)],
        "ceph_osd_pgs_repeered": [({"daemon": "osd.0"}, 2)],
        "ceph_osd_map_skip_to_full": [({"daemon": "osd.0"}, 0)],
        "ceph_osd_peering_lat_hist_bucket": [
            ({"daemon": "osd.0", "le": "+Inf"}, 2)],
        "ceph_osd_read_repairs": [({"daemon": "osd.0"}, 0)],
        "ceph_osd_read_shard_crc_errors": [({"daemon": "osd.0"}, 0)],
        "ceph_osd_scrub_errors_repaired": [({"daemon": "osd.0"}, 0)],
        "ceph_osd_full_rejects": [({"daemon": "osd.0"}, 0)],
        "ceph_osd_read_batch_ticks": [({"daemon": "osd.0"}, 1)],
        "ceph_mgr_balancer_rounds": [({"daemon": "mgr.x"}, 0)],
        "ceph_mgr_balancer_candidates": [({"daemon": "mgr.x"}, 0)],
        "ceph_mgr_balancer_moves_committed": [({"daemon": "mgr.x"}, 0)],
        "ceph_mgr_balancer_throttled": [({"daemon": "mgr.x"}, 0)],
        "ceph_mgr_autoscale_rounds": [({"daemon": "mgr.x"}, 0)],
    }
    if hist:
        prom["ceph_osd_op_lat_hist_bucket"] = [
            ({"daemon": "osd.0", "le": le}, cum) for le, cum in hist.items()]
    return prom


# (before, after, offered, late acks, gates override) — the judge cases of
# tests/test_load.py::test_judge_all_gates_pass_and_fail_paths and
# ::test_hist_quantile_from_cumulative_bucket_deltas
JUDGE_CASES = {
    "all_pass": (dict(ops=0, hist={"0.002": 0, "+Inf": 0}),
                 dict(ops=100, hist={"0.002": 100, "+Inf": 100}), {},
                 100, 0, None),
    "goodput_low": (dict(ops=0, hist={"0.002": 0, "+Inf": 0}),
                    dict(ops=100, hist={"0.002": 100, "+Inf": 100}), {},
                    1000, 0, None),
    "cwnd_collapsed": (dict(ops=0, hist={"0.002": 0, "+Inf": 0}),
                       dict(ops=100, cwnd=1, pushbacks=40,
                            hist={"0.002": 100, "+Inf": 100}), {},
                       100, 0, None),
    "slow_ops": (dict(ops=0, hist={"0.002": 0, "+Inf": 0}),
                 dict(ops=100, hist={"0.002": 100, "+Inf": 100}),
                 {"checks": {"SLOW_OPS": "3 slow ops"}}, 100, 0, None),
    "late_ack": (dict(ops=0, hist={"0.002": 0, "+Inf": 0}),
                 dict(ops=100, hist={"0.002": 100, "+Inf": 100}), {},
                 100, 1, None),
    "qos_idle": (dict(ops=0, hist={"0.002": 0, "+Inf": 0}),
                 dict(ops=100, hist={"0.002": 100, "+Inf": 100}),
                 {"mclock": True}, 100, 0, (("qos_reservation_min", 1.0),)),
    "p99_spill": (dict(hist={"0.002": 0, "0.004": 0, "+Inf": 0}),
                  dict(hist={"0.002": 90, "0.004": 95, "+Inf": 100}), {},
                  100, 0, None),
    "no_samples": (dict(ops=5), dict(ops=5), {}, 100, 0, None),
}


def _judge(mod, drv, case):
    before, after, extra, offered, late, gates = JUDGE_CASES[case]
    spec = drv.builtin_specs()["smoke"]
    if gates:
        spec = dataclasses.replace(spec, gates=spec.gates[:-1] + gates)
    health = {"status": "HEALTH_OK", "checks": extra.get("checks", {})}
    dm = {"osd.0": {"enabled": extra.get("mclock", False)}}
    result = drv.LoadResult(spec_name="x", seed=1, plan_key="k",
                            offered=offered)
    result.late_acks = ["late"] * late
    rep = mod.judge(spec, result,
                    _snaps(mod, _prom(**before), health, dm),
                    _snaps(mod, _prom(**after), health, dm))
    return rep.passed, rep.as_rows(), rep.failures(), rep.failing_gates()


@pytest.mark.parametrize("case", sorted(JUDGE_CASES))
def test_judge_equals_reference(case):
    got = _judge(slo, driver, case)
    assert got == _judge(jslo, jdriver, case)
    if case == "all_pass":
        assert got[0]


# ------------------------------------------------------------- the run


def test_load_smoke_passes_every_gate_on_the_reference_plan():
    """``tests/test_load.py::test_load_smoke_all_gates_and_bit_identical_
    replay`` on the port: every SLO gate passes from the scraped
    telemetry, and the plan is the reference's."""
    spec = driver.builtin_specs()["smoke"]
    ref_key = jdriver.plan_key(jdriver.build_plan(
        jdriver.builtin_specs()["smoke"], 42))
    result, rep = run(driver.run_load(spec, 42, device="cpu"))
    assert rep.passed, rep.failures()
    assert result.plan_key == ref_key
    assert result.offered == 180
    by = {r["gate"]: r for r in rep.rows}
    assert set(by) == {"goodput", "p99", "cwnd", "qos", "health",
                       "map_churn", "integrity", "balance", "deadline"}
    assert by["goodput"]["value"] >= result.offered * 0.5
    assert by["p99"]["value"] is not None
    assert by["cwnd"]["value"] is not None
    for gate in ("map_churn", "integrity", "balance"):
        assert by[gate]["passed"] and by[gate]["note"] == "", by[gate]
    assert by["balance"]["value"] == 0
