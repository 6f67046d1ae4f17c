"""Settings for the benchmark's own tests (``python -m pytest
portbench/tests``): the ``card`` marker, for tests that need a CUDA card
and skip without one, and the toy copy of the benchmark that the CPU
tests run."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cell's sizes cut to what a CPU test holds: a 32-OSD map of 16
# hosts, a 128-PG pool, ops of 256 KiB
TOY_CLUSTER = {"racks": 4, "hosts_per_rack": 4, "osds_per_host": 2}
TOY_PG_NUM = 128
TOY_TRAFFIC = {
    "write_4m": {"op_bytes": 262144, "in_flight": 4, "objects": 8,
                 "check_ops": 6},
    "degraded_read_4m": {"op_bytes": 262144, "in_flight": 4, "objects": 16,
                         "check_reads": 6},
    "osd_out": {"check_pgs": 16, "ref_workers": 1},
}

# the cauchy_k8m4 cells, which the toy copy declares where BENCHMARK.json
# does not (PERF.md's Open questions), so the CPU tests always cover the
# byte layout and the read path
TOY_CONFIG = {"name": "cauchy_k8m4", "source": "jerasure docs",
              "file": "portbench/configs/cauchy_k8m4.json", "reduced": [],
              "why": "toy"}
TOY_CELLS = [
    {"name": "cauchy_k8m4.write_4m", "config": "cauchy_k8m4",
     "traffic": "write_4m", "chips": 1, "why": "toy"},
    {"name": "cauchy_k8m4.degraded_read_4m", "config": "cauchy_k8m4",
     "traffic": "degraded_read_4m", "chips": 1, "why": "toy"},
]
TOY_READ_METRICS = {
    "end_to_end": [{"name": "read_MBps", "unit": "MB/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": n, "unit": u, "better": b, "source": s,
                   "layer": "toy", "moves": "read_MBps"}
                  for n, u, b, s in (
                      ("device_idle_pct.read", "%", "lower", "device_trace"),
                      ("codec_roofline_pct.read", "%", "higher",
                       "device_trace"),
                      ("op_p95_ms.read", "ms", "lower", "host_clock"))],
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_toy(dst: str) -> str:
    """A copy of BENCHMARK.json and portbench/ at toy sizes under
    ``dst``; returns ``dst``."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if TOY_CONFIG["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append(TOY_CONFIG)
    have = {w["name"] for w in bench["workloads"]}
    if TOY_CELLS[0]["name"] not in have:
        bench["workloads"].append(TOY_CELLS[0])
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"].endswith("write") or m["name"] == "write_MBps":
                m["workloads"].append(TOY_CELLS[0]["name"])
    if TOY_CELLS[1]["name"] not in have:
        bench["workloads"].append(TOY_CELLS[1])
        for kind, specs in TOY_READ_METRICS.items():
            for m in specs:
                bench[kind].append(dict(m, workloads=[TOY_CELLS[1]["name"]]))
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name in os.listdir(os.path.join(dst, "portbench", "configs")):
        path = os.path.join(dst, "portbench", "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["cluster"].update(TOY_CLUSTER)
        cfg["pool"]["pg_num"] = TOY_PG_NUM
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, upd in TOY_TRAFFIC.items():
        path = os.path.join(dst, "portbench", "traffic", name + ".json")
        with open(path) as f:
            t = json.load(f)
        t.update(upd)
        with open(path, "w") as f:
            json.dump(t, f)
    return dst


@pytest.fixture(scope="session")
def toy(tmp_path_factory):
    return make_toy(str(tmp_path_factory.mktemp("toy")))


def cells():
    """The cells of BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def toy_cells():
    """The cells of the toy copy: BENCHMARK.json's and the cauchy cells."""
    have = cells()
    return have + [c["name"] for c in TOY_CELLS if c["name"] not in have]
