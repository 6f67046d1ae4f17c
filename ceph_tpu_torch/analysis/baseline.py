"""Suppression baseline: accepted pre-existing findings.

Counterpart of ``ceph_tpu/analysis/baseline.py``. The port's baseline is
its own file, ``GRAFTLINT_TORCH_BASELINE.json`` at the repo root.

The tier-1 gate requires ZERO unsuppressed findings; anything the team
has looked at and accepted lives here as a stable baseline key
(rule::path::symbol::message — no line numbers, so unrelated edits
don't invalidate entries).  The file is JSON so diffs review cleanly:

    {"version": 1, "suppressions": [{"key": "...", "reason": "..."}]}

A stale entry (its finding no longer fires) is reported by the CLI so
the baseline shrinks monotonically instead of fossilizing.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Set


def default_baseline_path(root: Optional[str] = None) -> str:
    from ceph_tpu_torch.analysis.engine import repo_root

    return os.path.join(root or repo_root(), "GRAFTLINT_TORCH_BASELINE.json")


def load_baseline(path: str) -> Set[str]:
    """Baseline keys from ``path``; a missing file is an empty baseline."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError:
        return set()
    return {s["key"] for s in doc.get("suppressions", []) if "key" in s}


def write_baseline(path: str, findings: Iterable,
                   reason: str = "accepted pre-existing finding") -> int:
    """Write every finding's key as a suppression; returns the count."""
    entries = sorted({f.baseline_key for f in findings})
    doc = {
        "version": 1,
        "comment": "graftlint suppression baseline; keys are "
                   "rule::path::symbol::message (line-number free). "
                   "Remove entries as the findings are fixed.",
        "suppressions": [{"key": k, "reason": reason} for k in entries],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(entries)
