"""Rule family ``per-op-device-dispatch``: device calls on per-op paths.

Counterpart of ``ceph_tpu/analysis/device_dispatch.py``. Its scope is
``ceph_tpu_torch/cluster/``, the port's device entry points and its
coalescer, ``ceph_tpu_torch/cluster/batcher.py``.

Round 11 contract (the batched data plane): EC stripe work in the
cluster data plane crosses the host/device boundary through the tick
coalescer (``cluster/batcher.py``), which turns every same-profile
write of a dispatch tick into ONE planar conversion + fused encode +
crc32c batch.  A device entry point (planar conversion, batch
encode/decode, batched crc) reachable PER OP inside a ``cluster/``
async handler silently defeats that: every op pays its own host/device
round trip again, and the cluster/device throughput gap the tick
closed re-opens without any test failing.

Flagged inside ``async def``s under ``ceph_tpu_torch/cluster/`` (excluding
the coalescer module itself):

- a direct call to a device entry point
  (``codec.encode_planar(...)``, ``stripemod.encode_stripes(...)``);
- a device entry point handed as a CALLABLE to another call
  (``self._compute(stripemod.encode_stripes, ...)`` — the dominant
  idiom: the executor hop does not change who pays the dispatch).

Accepted remnants (the legacy ``osd_batch_tick_ops=0`` bisection path,
the not-yet-coalesced read/recovery decodes) live in the suppression
baseline, where removing one is a visible diff.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "per-op-device-dispatch"

# device entry points of the EC data plane: planar layout transforms,
# batch encode/decode dispatches, and the batched crc kernels
# (round 19 widened the set with the planar-at-rest multi entry points
# and the plane-major crc batch — the at-rest format must not become a
# license to hand-roll per-op dispatches outside the coalescer)
DEVICE_CALLS = frozenset({
    "to_planar", "encode_planar", "decode_planar",
    "encode_batch", "decode_batch",
    "encode_stripes", "decode_stripes", "reencode_stripes",
    "encode_stripes_multi", "crc32c_batch", "crc32c_rows",
    "encode_planes_multi", "decode_planes_multi",
    "reencode_planes_multi", "crc32c_planar_rows",
})

# the one sanctioned per-op dispatch seam: the tick coalescer
COALESCER = "ceph_tpu_torch/cluster/batcher.py"

FIX = ("route it through the batch coalescer "
       "(cluster/batcher.py encode seam)")


def _device_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and node.attr in DEVICE_CALLS:
        return node.attr
    if isinstance(node, ast.Name) and node.id in DEVICE_CALLS:
        return node.id
    return None


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _nearest_fn(node: ast.AST,
                parents: Dict[ast.AST, ast.AST]) -> Optional[ast.AST]:
    p = parents.get(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        p = parents.get(p)
    return p


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        if not m.relpath.startswith("ceph_tpu_torch/cluster/") or \
                m.relpath == COALESCER:
            continue
        parents = _parents(m.tree)
        for sym, fn in walk_functions(m.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or \
                        _nearest_fn(node, parents) is not fn:
                    continue
                name = _device_name(node.func)
                if name is not None:
                    findings.append(Finding(
                        rule=RULE, path=m.relpath, line=node.lineno,
                        symbol=sym,
                        message=f"device entry point {name}() called "
                                f"per-op in a cluster/ async handler; "
                                f"{FIX}"))
                    continue
                for arg in list(node.args) + \
                        [kw.value for kw in node.keywords]:
                    aname = _device_name(arg)
                    if aname is not None:
                        callee = dotted(node.func) or "a call"
                        findings.append(Finding(
                            rule=RULE, path=m.relpath, line=node.lineno,
                            symbol=sym,
                            message=f"device callable {aname} handed "
                                    f"to {callee}() per-op in a "
                                    f"cluster/ async handler; {FIX}"))
    return findings
