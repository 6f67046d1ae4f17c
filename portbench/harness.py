"""The benchmark's general machinery, driven by ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  Everything that belongs
to one of them is a file found by its name:

- ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file
  (sizes, the codec profile, the cluster);
- ``portbench/traffic/<traffic>.json`` is the traffic mix: parameters,
  and the name of the driver that generates and drives it;
- ``portbench/drivers/<driver>.py`` is a driver: it makes the inputs from
  the seed, builds the program's state, runs one closed-loop unit of the
  window at a time, and checks what the window produced against the plain
  reference in ``portbench/reference/``;
- ``portbench/metrics/<metric>.py`` reads one metric, end to end or of one
  layer, from the window's statistics, the program's counters or the
  device trace, and returns None when it finds nothing to read.

``run`` makes one run: set-up (inputs, program state, warm-up of every
shape the window uses), the measured window, the metrics, then the check.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

BANNED = ("jax", "jaxlib", "flax", "ceph_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Context:
    """What a metric reader sees."""

    cell: Cell
    stats: Dict[str, object]
    counters: Dict[str, float]
    trace: Optional[object] = None


def _applies(spec: dict, cell: str) -> bool:
    return "workloads" not in spec or cell in spec["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    config.setdefault("name", cfg["name"])
    traffic.setdefault("name", w["traffic"])
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(prefix: str, name: str) -> str:
    return prefix + "".join(c if c.isalnum() else "_" for c in name)


def load_driver_module(root: str, kind: str):
    path = os.path.join(root, "portbench", "drivers", kind + ".py")
    return _load_file(path, _modname("portbench_driver_", kind))


def load_driver(root: str, kind: str):
    return load_driver_module(root, kind).Driver


def load_reader(root: str, metric: str):
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    return _load_file(path, _modname("portbench_metric_", metric)).read


def banned_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counters() -> Dict[str, float]:
    from ceph_tpu_torch.utils.perf import KERNELS

    return {k: v for k, v in KERNELS.dump().get("device_kernels", {}).items()
            if isinstance(v, (int, float))}


def _diff(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}


def _device_info(device) -> Dict[str, object]:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": dev.type, "kind": dev.type, "count": 1,
            "memory_peak_bytes": 0}


def _profiler(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def window(drv, seconds: float, trace: bool, profile_units: int, device):
    """Drive ``drv`` unit by unit for ``seconds`` (the last unit ends the
    window); with ``trace``, profile units 1.. of the window, at most
    ``profile_units`` of them.  Returns (window seconds, each unit's
    milliseconds, profiler or None)."""
    from torch.profiler import record_function

    from portbench import trace as trace_mod

    prof = None
    stack = contextlib.ExitStack()
    unit_ms: List[float] = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        if trace and len(unit_ms) == 1:
            prof = _profiler(device)
            stack.enter_context(prof)
            stack.enter_context(record_function(trace_mod.WINDOW))
            drv.profiling = True
        if drv.profiling:
            with record_function(trace_mod.UNIT):
                drv.step()
            drv.profile_work["units"] = drv.profile_work.get("units", 0) + 1
            if drv.profile_work["units"] >= profile_units:
                drv.profiling = False
                stack.close()
        else:
            drv.step()
        unit_ms.append((time.perf_counter() - t) * 1e3)
    elapsed = time.perf_counter() - start
    if drv.profiling:
        drv.profiling = False
        stack.close()
    _sync(device)
    return elapsed, unit_ms, prof


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device, t0: Optional[float] = None, cell: Optional[Cell] = None
        ) -> Tuple[dict, Dict[str, Tuple[float, float]], dict]:
    """One run of a cell on ``device``: returns (the result line's object,
    the checks as name -> (number, limit), the window's statistics)."""
    from portbench import trace as trace_mod

    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or load_cell(root, workload)
    Driver = load_driver(root, cell.traffic["driver"])
    drv = Driver(cell.config, cell.traffic, seed, device)
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    c0 = _counters()
    window_s, unit_ms, prof = window(
        drv, seconds, trace, int(cell.traffic.get("profile_units", 1)),
        device)
    counters = _diff(c0, _counters())
    stats = drv.stats()
    stats.update(window_s=window_s, units=len(unit_ms), unit_ms=unit_ms)
    device_info = _device_info(device)
    ctx = Context(cell=cell, stats=stats, counters=counters)
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        tr = trace_mod.from_profiler(prof) if prof is not None else None
        if tr is not None:
            tr.work = dict(drv.profile_work)
            ctx.trace = tr
            device_info["busy_s"] = tr.busy_us() * 1e-6
            device_info["window_s"] = tr.window_us * 1e-6
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        specs = cell.per_layer
    else:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        specs = [m for m in cell.end_to_end if m["name"] != "setup_s"]
    for spec in specs:
        value = load_reader(root, spec["name"])(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    prof = None
    drv.release()
    gc.collect()
    checks = drv.check()
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": int(stats["attempted"]),
        "failed": int(stats["failed"]),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks, stats


def _summary(result: dict, stats: dict, traced: int) -> str:
    """One line for the reader of standard error: set-up, units, and the
    spread of the units' times (the run's own noise)."""
    import statistics

    ms = stats.get("unit_ms") or []
    q = statistics.quantiles(ms, n=4) if len(ms) >= 2 else ms * 3
    setup = result["metrics"].get("setup_s", {}).get("value")
    return (f"{'traced' if traced else 'untraced'} run: setup_s {setup}, "
            f"window {stats['window_s']:.3f} s, {stats['units']} units, "
            f"unit ms quartiles {[round(x, 3) for x in q]}")


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None, root: str = ".") -> int:
    args = _args(argv)
    cell = load_cell(root, args.workload)
    try:
        import ceph_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program is not here: {e}", file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); found {cards}", file=sys.stderr)
        return 2
    result, checks, stats = run(root, args.workload, args.seed,
                                args.seconds, bool(args.trace),
                                torch.device("cuda", 0), t0=t0, cell=cell)
    found = banned_modules()
    if found:
        print(f"portbench: modules loaded that the run may not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    print(_summary(result, stats, args.trace), file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
