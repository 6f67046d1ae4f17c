"""Saturation search: step the offered rate until an SLO gate breaks.

Counterpart of ``ceph_tpu/load/ramp.py``.  ``ramp`` boots its cluster
on the ``device`` the caller names: CUDA unless it names another
(``device="cpu"`` for the plain versions); it raises when CUDA is absent
and no device was named.

The knee is the highest offered rate at which EVERY gate still passes
— the number a capacity planner actually wants.  One cluster is booted
and reused across steps (counter deltas make each window
self-contained), the offered rate doubles per step, and the sweep stops
at the first failing step (or when the scale list runs out).

The result is an artifact document carrying the reference's trust-model
stamps: mode ``cluster_vstart``, a NULL ``vs_baseline`` (load artifacts
are never a baseline ratio), and ``session_only: true`` — the host is
load-sensitive, so absolute knee numbers only compare WITHIN one
session; cross-session judgments use gate verdicts, not ops/s.  It adds
one field, ``card``: the card's name and power limit as ``nvidia-smi``
reports them, or ``"cpu"``.  The port's artifacts are numbered on their
own (``LOAD_torch_r<n>.json``), apart from the reference's records.
"""

from __future__ import annotations

import asyncio
import glob
import json
import os
import re
import subprocess
from typing import Dict, List, Optional, Sequence

from ceph_tpu_torch.load.driver import LoadContext, LoadSpec, run_load

DEFAULT_SCALES: Sequence[float] = (1, 2, 4, 8, 16, 32, 64)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACT_PREFIX = "LOAD_torch_r"


def card_stamp(device) -> str:
    """``"<name>, <power limit>"`` of the CUDA card ``device`` names, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it; ``"cpu"`` for any other device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else ""
        if out.returncode == 0 and line:
            return line
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


async def ramp(spec: LoadSpec, seed: int,
               scales: Sequence[float] = DEFAULT_SCALES,
               tmpdir: Optional[str] = None, device=None) -> Dict:
    """Run the sweep on a cluster booted on ``device`` (CUDA unless
    named; raises without one); returns the artifact document
    (unwritten)."""
    ctx = await LoadContext.create(spec, seed, tmpdir=tmpdir, device=device)
    steps: List[Dict] = []
    knee: Optional[Dict] = None
    try:
        card = card_stamp(ctx.cluster.device)
        for scale in scales:
            step_spec = spec.scaled(scale)
            result, report = await run_load(step_spec, seed, ctx=ctx)
            offered_rate = result.offered / max(1e-6, step_spec.duration)
            p99_row = next((r for r in report.rows
                            if r["gate"] == "p99"), {})
            goodput_row = next((r for r in report.rows
                                if r["gate"] == "goodput"), {})
            step = {
                "scale": scale,
                "offered_ops_s": round(offered_rate, 1),
                "offered_ops": result.offered,
                "acked_ops_scraped": goodput_row.get("value"),
                "p99_ms": p99_row.get("value"),
                "passed": report.passed,
                "gates": report.as_rows(),
                # the failing gates' observed vs threshold values and the
                # postmortem bundle a failed judgment triggered: the
                # artifact alone diagnoses a failed step
                "failed_gates": report.failing_gates(),
                "postmortem": report.postmortem,
                "client": result.as_dict(),
            }
            steps.append(step)
            if report.passed:
                knee = {"scale": scale,
                        "offered_ops_s": step["offered_ops_s"],
                        "acked_ops_scraped": step["acked_ops_scraped"],
                        "p99_ms": step["p99_ms"]}
            else:
                break
            # quiesce between steps so one window's stragglers don't
            # bleed into the next window's scrape delta
            await asyncio.sleep(0.5)
    finally:
        await ctx.close()
    return {
        "kind": "graft-load ramp",
        "spec": spec.name,
        "seed": seed,
        "mode": "cluster_vstart",
        "vs_baseline": None,
        "baseline_src": "unmeasured",
        "session_only": True,
        "load_sensitive_host": True,
        "excluded_from_vs_baseline": True,
        "steps": steps,
        "knee": knee,
        "card": card,
    }


def next_round(root: Optional[str] = None) -> int:
    """One past the newest ``LOAD_torch_r<n>.json`` in ``root`` (the
    repo's root unless named): the port's own artifacts, never the
    reference's BENCH/LOAD records."""
    rounds = [0]
    for path in glob.glob(os.path.join(root or _REPO,
                                       ARTIFACT_PREFIX + "*.json")):
        m = re.search(r"_r(\d+)\.json$", path)
        if m:
            rounds.append(int(m.group(1)))
    return max(rounds) + 1


def write_artifact(doc: Dict, out: Optional[str] = None) -> str:
    path = out or os.path.join(
        _REPO, f"{ARTIFACT_PREFIX}{next_round():02d}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def format_table(doc: Dict) -> str:
    """The worked ramp table (``tools/load.py report``)."""
    lines = [f"ramp {doc['spec']} seed={doc['seed']} "
             f"(mode={doc['mode']}, session-only numbers)",
             f"{'scale':>6} {'offered/s':>10} {'acked':>8} "
             f"{'p99 ms':>9}  gates"]
    for s in doc["steps"]:
        failed = [r["gate"] for r in s["gates"] if not r["passed"]]
        lines.append(
            f"{s['scale']:>6g} {s['offered_ops_s']:>10} "
            f"{s['acked_ops_scraped'] if s['acked_ops_scraped'] is not None else '-':>8} "
            f"{s['p99_ms'] if s['p99_ms'] is not None else '-':>9}  "
            + ("ALL PASS" if s["passed"] else
               "FAIL: " + ",".join(failed)))
    knee = doc.get("knee")
    lines.append("knee: " + (
        f"{knee['offered_ops_s']} offered ops/s (scale {knee['scale']})"
        if knee else "NONE — no step passed every gate"))
    return "\n".join(lines)
