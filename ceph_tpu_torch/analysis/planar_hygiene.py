"""Rule family ``planar-conversion-hygiene``: at-rest layout seams.

Counterpart of ``ceph_tpu/analysis/planar_hygiene.py``. Its scope is
``ceph_tpu_torch/cluster/`` less the coalescer,
``ceph_tpu_torch/cluster/batcher.py``.

Round 19 contract (planar at rest): with ``osd_ec_planar_at_rest=1``
EC shards LIVE as packed bit-plane matrices — in the store, on the
wire, and entering the kernels — and the byte view may materialize
only at the sanctioned seams (the coalesced encode's ingest, the read
assemble's egress, and declared relayout transitions).  A stray
conversion call in ``cluster/`` quietly re-opens the
convert-per-hop cost the format removed, without any test failing
until the perf gate notices.

Flagged under ``ceph_tpu_torch/cluster/`` (excluding the coalescer module,
which IS the sanctioned dispatch seam):

- any call to a RAW layout transform (``to_planar``, ``to_batch``,
  ``from_batch``, ``rows_to_planes``, ``planes_to_rows``) — these
  belong in the ``ec/`` kernel seam modules only;
- a ``shard_to_planes(...)`` / ``planes_to_shard(...)`` call with NO
  explicit ``seam=`` keyword — the planar_store API makes every
  caller declare which seam books the conversion, and an undeclared
  call is exactly the silent hop this rule exists to catch;
- a call declaring ``seam="unseamed"`` — the steady-state counter
  those book is PINNED to zero by test, so a new unseamed site needs
  an inline pragma (and a story), like the store ``read()`` byte-view
  fallbacks carry.

``blob_to_planes``/``planes_to_blob`` are reshapes of the SAME bytes,
not conversions, and stay unflagged.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "planar-conversion-hygiene"

# raw layout transforms: never legal in cluster/ at all
RAW_CONVERSIONS = frozenset({
    "to_planar", "to_batch", "from_batch",
    "rows_to_planes", "planes_to_rows",
})

# seam-declaring transforms: legal with an explicit seam= keyword
SEAM_CONVERSIONS = frozenset({"shard_to_planes", "planes_to_shard"})

# the one sanctioned per-op dispatch seam: the tick coalescer
COALESCER = "ceph_tpu_torch/cluster/batcher.py"

FIX = ("keep layout conversions at the sanctioned seams "
       "(ec/planar_store.py callers declare seam=)")


def _call_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        if not m.relpath.startswith("ceph_tpu_torch/cluster/") or \
                m.relpath == COALESCER:
            continue
        from ceph_tpu_torch.analysis.astutil import walk_functions

        fn_of = {}
        for sym, fn in walk_functions(m.tree):
            for node in ast.walk(fn):
                fn_of.setdefault(node, sym)
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            sym = fn_of.get(node, "")
            if name in RAW_CONVERSIONS:
                findings.append(Finding(
                    rule=RULE, path=m.relpath, line=node.lineno,
                    symbol=sym,
                    message=f"raw layout transform {name}() in a "
                            f"cluster/ module; {FIX}"))
                continue
            if name not in SEAM_CONVERSIONS:
                continue
            seam = next((kw for kw in node.keywords
                         if kw.arg == "seam"), None)
            if seam is None:
                findings.append(Finding(
                    rule=RULE, path=m.relpath, line=node.lineno,
                    symbol=sym,
                    message=f"{name}() without an explicit seam= "
                            f"declaration in a cluster/ module; {FIX}"))
            elif isinstance(seam.value, ast.Constant) and \
                    seam.value.value == "unseamed":
                findings.append(Finding(
                    rule=RULE, path=m.relpath, line=node.lineno,
                    symbol=sym,
                    message=f"{name}(seam=\"unseamed\") materializes a "
                            f"byte view outside the seams — the pinned "
                            f"steady-state counter; {FIX}"))
    return findings
