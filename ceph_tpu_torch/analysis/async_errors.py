"""Rule family ``swallowed-async-error``: silently-dropped failures in
cluster/ async handlers.

Counterpart of ``ceph_tpu/analysis/async_errors.py``. Its scope is the
port's packages.

Lost sub-op failures are exactly how un-acked shards leak: a replica
send that fails inside a broad ``except: pass`` (or an
``asyncio.gather(..., return_exceptions=True)`` whose result list is
discarded) leaves the primary's durability accounting silently short —
the op neither fails loudly nor retries, and the write it served claims
a durability it does not have.  graft-chaos only catches the instances
a fault schedule happens to hit; this rule catches the pattern
statically.

Two shapes are flagged, both only inside ``async def`` functions under
``ceph_tpu_torch/cluster/``:

- a BARE/BROAD except whose body is only ``pass``: ``except:``,
  ``except Exception:``, or ``except BaseException:`` (bare ``except``
  additionally swallows ``CancelledError`` — a handler that eats its
  own cancellation).  Narrow, typed excepts (``except (ConnectionError,
  OSError):``) are deliberate protocol decisions and stay legal, as
  does any body that observes the failure (counter, log, retry).
- ``asyncio.gather(..., return_exceptions=True)`` whose result is
  discarded — a bare expression statement or a binding the function
  never reads.  With ``return_exceptions=True`` the gather NEVER
  raises; dropping the result list drops every child failure.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "swallowed-async-error"

# round 15: the cluster/ prefix covers the front-door libraries
# (rbd/rgw*/mds/fs/snaps) — pinned by tests/test_frontdoor.py.
# round 13: graft-load's async driver joined the scope — a load window
# that silently eats op failures reports a goodput it never served
SCOPE = ("ceph_tpu_torch/cluster/", "ceph_tpu_torch/load/",
         "ceph_tpu_torch/osdmap/", "ceph_tpu_torch/chaos/",
         "ceph_tpu_torch/trace/flight.py",
         "ceph_tpu_torch/trace/postmortem.py")

_BROAD = ("Exception", "BaseException")


def _is_broad_handler(h: ast.ExceptHandler) -> bool:
    if h.type is None:
        return True  # bare except: eats CancelledError too
    name = dotted(h.type) or ""
    return name.split(".")[-1] in _BROAD


def _body_only_pass(h: ast.ExceptHandler) -> bool:
    return all(isinstance(s, ast.Pass) for s in h.body)


def _is_gather_re(call: ast.Call) -> bool:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        (dotted(f) or "").split(".")[-1]
    if name != "gather":
        return False
    for kw in call.keywords:
        if kw.arg == "return_exceptions" and \
                isinstance(kw.value, ast.Constant) and \
                kw.value.value is True:
            return True
    return False


def _gather_result_discarded(fn: ast.AST, call: ast.Call,
                             parents) -> Optional[str]:
    """None when the result is consumed; else a defect description."""
    parent = parents.get(call)
    if isinstance(parent, ast.Await):
        parent = parents.get(parent)
    if isinstance(parent, ast.Expr):
        return ("gather(..., return_exceptions=True) result discarded "
                "— every child failure is silently dropped")
    if isinstance(parent, ast.Assign):
        target = parent.targets[0] if len(parent.targets) == 1 else None
        if isinstance(target, ast.Name):
            name = target.id
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and node.id == name and \
                        isinstance(node.ctx, ast.Load):
                    return None
            return (f"gather(..., return_exceptions=True) result bound "
                    f"to {name!r} but never read — every child failure "
                    f"is silently dropped")
    return None


def _parents(tree: ast.AST):
    out = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _nearest_fn(node: ast.AST, parents) -> Optional[ast.AST]:
    p = parents.get(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        p = parents.get(p)
    return p


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        if not m.relpath.startswith(SCOPE):
            continue
        parents = _parents(m.tree)
        for sym, fn in walk_functions(m.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in ast.walk(fn):
                if _nearest_fn(node, parents) is not fn:
                    continue  # reported against the nested function
                if isinstance(node, ast.ExceptHandler) and \
                        _is_broad_handler(node) and \
                        _body_only_pass(node):
                    what = "bare 'except:'" if node.type is None else \
                        f"'except {dotted(node.type)}:'"
                    findings.append(Finding(
                        rule=RULE, path=m.relpath, line=node.lineno,
                        symbol=sym,
                        message=f"{what} with a pass-only body in an "
                                f"async handler swallows the failure "
                                f"(lost sub-op errors = leaked un-acked "
                                f"shards); narrow the exception types "
                                f"or observe the failure (counter/log/"
                                f"retry)"))
                elif isinstance(node, ast.Call) and _is_gather_re(node):
                    defect = _gather_result_discarded(fn, node, parents)
                    if defect is not None:
                        findings.append(Finding(
                            rule=RULE, path=m.relpath, line=node.lineno,
                            symbol=sym,
                            message=f"{defect}; iterate the results and "
                                    f"handle (or at least count) the "
                                    f"exceptions"))
    return findings
