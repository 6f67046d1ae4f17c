"""The port's saturation ramp and soak runner (``ceph_tpu_torch/load/
{ramp,soak}.py``) against ``ceph_tpu``'s, on the cases of
``tests/test_load.py``.

Host determinism, exact equality with the reference: ``format_table``'s
text and ``write_artifact``'s bytes for the same document (the port's
artifact adds a ``card`` field, and its numbering counts only the port's
own ``LOAD_torch_r*.json``), the soak library field by field, and
``build_schedule`` of each soak's shell at several seeds.

Whole runs on a port cluster (``device="cpu"``, each under its own
deadline): a one-step ramp of ``smoke-micro`` carries every trust stamp,
and ``test_load.py``'s mgr-scrape case.  The reference's slow two-step
ramp and its soak cases have slow-marked copies, as they are there.  The
entry points run on CUDA unless ``device`` names another, and raise
without one.
"""

import asyncio
import dataclasses
import json
import os

import pytest
import torch

import ceph_tpu.chaos.scenario as jscenario
import ceph_tpu.load.ramp as jramp
import ceph_tpu.load.soak as jsoak
import ceph_tpu_torch.chaos.scenario as scenario
import ceph_tpu_torch.load.ramp as ramp
import ceph_tpu_torch.load.soak as soak
from ceph_tpu_torch.load.driver import builtin_specs
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 120.0
SOAKS = sorted(jsoak.builtin_soaks())


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


# ------------------------------------------------------------- the artifact


def _step(scale, passed, failed=(), acked=10.0, p99=2.0):
    gates = [{"gate": g, "value": 1.0, "threshold": 0.5, "source": "s",
              "note": "", "passed": g not in failed}
             for g in ("goodput", "p99", "cwnd")]
    return {"scale": scale, "offered_ops_s": 10.0 * scale,
            "offered_ops": int(10 * scale), "acked_ops_scraped": acked,
            "p99_ms": p99, "passed": passed, "gates": gates,
            "failed_gates": [g for g in gates if not g["passed"]],
            "postmortem": None, "client": {"offered": int(10 * scale)}}


DOCS = {
    # tests/test_load.py::test_cli_report_reads_artifact's document
    "report": {"kind": "graft-load ramp", "spec": "t", "seed": 1,
               "mode": "cluster_vstart", "vs_baseline": None,
               "session_only": True,
               "steps": [{"scale": 1, "offered_ops_s": 10.0,
                          "offered_ops": 10, "acked_ops_scraped": 10.0,
                          "p99_ms": 2.0, "passed": True, "gates": []}],
               "knee": {"scale": 1, "offered_ops_s": 10.0,
                        "acked_ops_scraped": 10.0, "p99_ms": 2.0}},
    "knee-then-fail": {
        "kind": "graft-load ramp", "spec": "ramp-ec", "seed": 42,
        "mode": "cluster_vstart", "vs_baseline": None,
        "baseline_src": "unmeasured", "session_only": True,
        "load_sensitive_host": True, "excluded_from_vs_baseline": True,
        "steps": [_step(1, True), _step(2, True, p99=40.5),
                  _step(4, False, ("p99", "cwnd"), p99=9000.25)],
        "knee": {"scale": 2, "offered_ops_s": 20.0,
                 "acked_ops_scraped": 10.0, "p99_ms": 40.5}},
    "no-knee": {
        "kind": "graft-load ramp", "spec": "smoke", "seed": 3,
        "mode": "cluster_vstart", "vs_baseline": None,
        "baseline_src": "unmeasured", "session_only": True,
        "load_sensitive_host": True, "excluded_from_vs_baseline": True,
        "steps": [_step(0.5, False, ("goodput",), acked=None, p99=None)],
        "knee": None},
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_format_table_equals_reference(name):
    assert ramp.format_table(DOCS[name]) == jramp.format_table(DOCS[name])


@pytest.mark.parametrize("name", sorted(DOCS))
def test_write_artifact_equals_reference_apart_from_the_card(name,
                                                             tmp_path):
    doc = DOCS[name]
    mine = ramp.write_artifact(doc, out=str(tmp_path / "port.json"))
    ref = jramp.write_artifact(doc, out=str(tmp_path / "ref.json"))
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    carded = ramp.write_artifact({**doc, "card": "cpu"},
                                 out=str(tmp_path / "carded.json"))
    with open(carded) as f:
        got = json.load(f)
    assert got.pop("card") == "cpu"
    with open(ref) as f:
        assert got == json.load(f)


def test_artifact_numbering_counts_only_the_ports_own(tmp_path,
                                                       monkeypatch):
    """The port's default path never reads, renumbers or overwrites the
    reference's BENCH/LOAD records: it counts its own artifacts only."""
    for name in ("BENCH_r05.json", "LOAD_r08.json"):
        (tmp_path / name).write_text("{}\n")
    assert ramp.next_round(str(tmp_path)) == 1
    monkeypatch.setattr(ramp, "_REPO", str(tmp_path))
    first = ramp.write_artifact(DOCS["report"])
    assert os.path.basename(first) == "LOAD_torch_r01.json"
    (tmp_path / "LOAD_torch_r07.json").write_text("{}\n")
    assert ramp.next_round(str(tmp_path)) == 8
    assert os.path.basename(ramp.write_artifact(DOCS["report"])) == \
        "LOAD_torch_r08.json"
    for name in ("BENCH_r05.json", "LOAD_r08.json"):
        assert (tmp_path / name).read_text() == "{}\n"


def _check_stamps(doc):
    assert doc["vs_baseline"] is None
    assert doc["session_only"] and doc["load_sensitive_host"]
    assert doc["mode"] == "cluster_vstart"
    assert doc["baseline_src"] == "unmeasured"
    assert doc["excluded_from_vs_baseline"]
    assert doc["knee"] is not None
    assert all("gates" in s and "failed_gates" in s for s in doc["steps"])
    assert doc["card"] == "cpu"


def test_ramp_one_step_carries_every_trust_stamp(tmp_path):
    """A one-step ``ramp`` of ``smoke-micro`` at seed 21 on a port
    cluster: every stamp of the reference's artifact, the knee, and the
    ``card`` field naming the CPU; the artifact reads back as written."""
    spec = builtin_specs()["smoke-micro"]
    doc = run(ramp.ramp(spec, 21, scales=(1,), device="cpu"))
    _check_stamps(doc)
    assert [s["scale"] for s in doc["steps"]] == [1]
    assert doc["steps"][0]["passed"]
    path = ramp.write_artifact(doc, out=str(tmp_path / "LOAD_rt.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(doc))
    assert "knee:" in ramp.format_table(doc)


@pytest.mark.slow
def test_ramp_finds_knee_with_trust_stamps(tmp_path):
    """``tests/test_load.py::test_ramp_finds_knee_with_trust_stamps`` on
    the port."""
    spec = builtin_specs()["smoke-micro"]
    doc = run(ramp.ramp(spec, 21, scales=(1, 2), device="cpu"), 300)
    _check_stamps(doc)
    path = ramp.write_artifact(doc, out=str(tmp_path / "LOAD_rt.json"))
    assert os.path.exists(path)
    assert "knee:" in ramp.format_table(doc)


def test_card_stamp_names_the_cpu_and_the_card(monkeypatch):
    assert ramp.card_stamp("cpu") == "cpu"
    assert ramp.card_stamp(torch.device("cpu")) == "cpu"

    class Smi:
        returncode, stdout = 0, "NVIDIA H100 80GB HBM3, 700.00 W\n"

    seen = []

    def smi(argv, **kwargs):
        seen.append(argv)
        return Smi()

    monkeypatch.setattr(ramp.subprocess, "run", smi)
    assert ramp.card_stamp(torch.device("cuda", 0)) == \
        "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen == [["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader", "-i", "0"]]


# ---------------------------------------------------------------- the soak


@pytest.mark.parametrize("name", SOAKS)
def test_soak_library_equals_reference(name):
    assert sorted(soak.builtin_soaks()) == SOAKS
    got = dataclasses.asdict(soak.builtin_soaks()[name])
    assert got == dataclasses.asdict(jsoak.builtin_soaks()[name])


@pytest.mark.parametrize("seed", [0, 1, 2, 17, 42, 31337])
@pytest.mark.parametrize("name", SOAKS)
def test_soak_schedule_equals_reference(name, seed):
    """The soak's fault plan resolves through the chaos resolver from
    the seed exactly as the reference's does (no cluster)."""
    shell = soak.builtin_soaks()[name].schedule_shell()
    jshell = jsoak.builtin_soaks()[name].schedule_shell()
    assert dataclasses.asdict(shell) == dataclasses.asdict(jshell)
    assert scenario.build_schedule(shell, seed) == \
        jscenario.build_schedule(jshell, seed)


@pytest.mark.soak
def test_soak_mixed_crash_invariants(tmp_path):
    """``tests/test_load.py::test_soak_mixed_crash_invariants`` on the
    port: durability + frontier + deadline invariants hold after
    convergence, a crash point fired, and the schedule replays from the
    seed."""
    sk = soak.builtin_soaks()["soak-mixed-crash"]
    v = run(soak.run_soak(sk, 17, tmpdir=str(tmp_path), device="cpu"), 600)
    assert v.passed, v.failures
    assert v.counters.get("crash_points_fired", 0) >= 1
    assert v.acked_objects > 0
    assert scenario.build_schedule(sk.schedule_shell(), 17) == v.schedule


@pytest.mark.soak
def test_soak_marker_implies_slow(request):
    """pytest.ini contract: soak tests are slow-implied, so the tier-1
    '-m not slow' gate can never pick one up."""
    marks = {m.name for m in request.node.iter_markers()}
    assert "slow" in marks


# ---------------------------------------------------------- the mgr scrape


def test_mgr_scrape_carries_client_and_qos_counters():
    """``tests/test_load.py::test_mgr_scrape_carries_client_and_qos_
    counters`` on the port: the client window and the dmclock eviction
    stat are on the mgr's Prometheus text."""
    from ceph_tpu_torch.load.driver import LoadContext, drive

    spec = builtin_specs()["smoke-micro"]

    async def case():
        ctx = await LoadContext.create(spec, 5, device="cpu")
        try:
            await drive(ctx, spec, 5)
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 10.0
            text = ""
            while loop.time() < deadline:
                text = await ctx.cluster.daemon_command(
                    "mgr", "prometheus metrics")
                if 'ceph_client_cwnd{daemon="client.load0"}' in text:
                    break
                await asyncio.sleep(0.05)
        finally:
            await ctx.close()
        return text

    text = run(case())
    assert 'ceph_client_cwnd{daemon="client.load0"}' in text
    assert "ceph_client_cwnd_pushbacks" in text
    assert "ceph_osd_qos_evicted" in text
    assert "ceph_osd_qos_served_reservation" in text


# ------------------------------------------------------- the card, or none


def test_ramp_and_soak_default_to_cuda_and_refuse_cpu_fallback(monkeypatch):
    """Asked for no device, ``ramp`` and ``run_soak`` want CUDA and raise
    without it, before any cluster boots."""
    from ceph_tpu_torch.cluster import vstart

    booted = []

    async def start_cluster(*args, **kwargs):
        booted.append(kwargs)
        raise AssertionError("a cluster was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(vstart, "start_cluster", start_cluster)
    spec = builtin_specs()["smoke-micro"]
    with pytest.raises(RuntimeError, match="CUDA"):
        run(ramp.ramp(spec, 1, scales=(1,)))
    with pytest.raises(RuntimeError, match="CUDA"):
        run(soak.run_soak(soak.builtin_soaks()["soak-mixed-crash"], 1))
    assert booted == []
