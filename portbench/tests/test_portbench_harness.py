"""Runs of every cell at toy sizes on the CPU: the last line's keys, the
checks, and a configuration, traffic mix and metric added as files."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, cells, toy_cells
from portbench import harness

SEED = 2**31 + 12345


def seconds(cell):
    """A window that holds the check's units at toy sizes on the CPU."""
    return 4.0 if cell.endswith("osd_out") else 1.0
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", toy_cells())
def test_untraced_run_reports_its_end_to_end_metrics(toy, cell):
    result, checks, _stats = harness.run(toy, cell, SEED, seconds(cell),
                                         False, torch.device("cpu"))
    assert RESULT_KEYS <= set(result)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(checks)
    want = {m["name"] for m in harness.load_cell(toy, cell).end_to_end}
    assert set(result["metrics"]) == want
    assert result["attempted"] > 0 and result["failed"] == 0
    for m in result["metrics"].values():
        assert m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])


@pytest.mark.parametrize("cell", toy_cells())
def test_traced_run_has_window_and_breakdown(toy, cell):
    result, _, _stats = harness.run(toy, cell, SEED + 1, seconds(cell),
                                    True, torch.device("cpu"))
    assert result["correct"] is True, result["checks"]
    dev = result["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: no device metric is made up; host ones stay
    for name in result["metrics"]:
        assert name.startswith("op_p95_ms")


def _digest(root):
    out = {}
    for base, _dirs, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    with open(os.path.join(root, "BENCHMARK.json"), "rb") as fh:
        out["BENCHMARK.json"] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_files(toy, tmp_path):
    from conftest import make_toy

    root = make_toy(str(tmp_path / "copy"))
    before = _digest(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "isa_k8m4.json")) as f:
        cfg = json.load(f)
    cfg["profile"] = {"plugin": "isa", "technique": "reed_sol_van",
                      "k": "4", "m": "2"}
    cfg["pool"]["size"] = 6
    with open(os.path.join(pb, "configs", "isa_k4m2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "write_1m.json"), "w") as f:
        json.dump({"driver": "ec_write", "op_bytes": 65536, "in_flight": 2,
                   "objects": 4, "check_ops": 2, "profile_units": 1}, f)
    with open(os.path.join(pb, "metrics", "toy_ops_per_s.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx.stats['attempted'] / ctx.stats['window_s']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "isa_k4m2", "source": "x",
                             "file": "portbench/configs/isa_k4m2.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "isa_k4m2.write_1m",
                               "config": "isa_k4m2", "traffic": "write_1m",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "toy_ops_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["isa_k4m2.write_1m"]})
    bench["end_to_end"][0]["workloads"].append("isa_k4m2.write_1m")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    result, _, _stats = harness.run(root, "isa_k4m2.write_1m", SEED, 0.5,
                                    False, torch.device("cpu"))
    assert result["correct"] is True
    assert {"setup_s", "write_MBps", "toy_ops_per_s"} == \
        set(result["metrics"])
    after = _digest(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}


def test_cli_without_a_card_exits_2_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         cells()[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, HOME=str(tmp_path)))
    assert p.returncode == 2
    assert p.stdout == ""


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceph_tpu_torch_x", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.banned_modules() == ["jaxlib"]
