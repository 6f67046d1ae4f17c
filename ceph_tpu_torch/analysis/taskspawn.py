"""Rule family ``task-spawn``: unbounded per-op task spawns in cluster/.

Counterpart of ``ceph_tpu/analysis/taskspawn.py``. Its scope is the
port's packages.

ROADMAP item 2 names the bug class: a daemon that spawns an asyncio
task per op (or per map change, per retry, per dropped frame) and
either discards the handle or parks it in a grow-only list keeps one
dead Task alive per event for the daemon's life — graft-chaos runs
found the messenger doing exactly this before it gained the
self-discarding ``_track`` registry.  This rule makes the pattern a
lint invariant for everything under ``ceph_tpu_torch/cluster/``.

A ``create_task``/``ensure_future`` call is accepted when its result is

- passed straight into a call (``self._track(loop.create_task(...))``
  — the callee owns the lifetime);
- awaited (bounded by the awaiting coroutine);
- assigned to an ATTRIBUTE or subscript (a replace-on-rearm slot like
  ``self._relinger_task`` / ``self._retry_tasks[pgid]``);
- assigned to a name that the function then actually uses (handed to a
  tracker, given ``add_done_callback``, cancelled, stored).

It is flagged when the result is

- discarded (a bare expression statement), or
- fed straight into ``.append(...)`` / ``.add(...)`` (a grow-only
  registry with no discard path), or
- assigned to a name the function never touches again.

Round 13: the scope grew to ``ceph_tpu_torch/load/`` — the open-loop driver
spawns one task per planned op, exactly the per-op shape this rule
polices.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "task-spawn"

# async daemon/driver code the rule polices (tests and scripts are
# callers, not long-lived event-loop residents)
# round 15: the cluster/ prefix covers the front-door libraries
# (rbd/rgw*/mds/fs/snaps) — pinned by tests/test_frontdoor.py.
SCOPE = ("ceph_tpu_torch/cluster/", "ceph_tpu_torch/load/",
         "ceph_tpu_torch/osdmap/", "ceph_tpu_torch/chaos/",
         "ceph_tpu_torch/trace/flight.py",
         "ceph_tpu_torch/trace/postmortem.py")

FIX = ("route it through a self-discarding tracker (the messenger "
       "_track pattern: set.add + add_done_callback(discard)) or a "
       "replace-on-rearm attribute slot")


def _is_spawn(call: ast.Call) -> bool:
    # match the ATTRIBUTE name, not a full dotted chain: the dominant
    # idiom is asyncio.get_event_loop().create_task(...), whose chain
    # contains a Call and so has no dotted name
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr in ("create_task", "ensure_future")
    return isinstance(f, ast.Name) and \
        f.id in ("create_task", "ensure_future")


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _name_reused(fn: ast.AST, assign: ast.Assign, name: str) -> bool:
    """Does the function touch ``name`` anywhere besides the binding
    assignment itself?  (Tracker call, add_done_callback, cancel,
    storing it — any later use counts as taking ownership.)"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == name and \
                not (isinstance(node.ctx, ast.Store) and
                     node in getattr(assign, "targets", ())):
            return True
    return False


def _classify(fn: ast.AST, call: ast.Call,
              parents: Dict[ast.AST, ast.AST]) -> Optional[str]:
    """None when the spawn is tracked; else a short defect description."""
    parent = parents.get(call)
    if isinstance(parent, ast.Await):
        return None
    if isinstance(parent, ast.Call) and call in parent.args:
        callee = dotted(parent.func) or ""
        if callee.endswith(".append") or callee.endswith(".add"):
            return (f"task handle fed straight into {callee}() — a "
                    f"grow-only registry keeps one dead Task per spawn")
        return None  # handed to a tracker/helper: the callee owns it
    if isinstance(parent, ast.Expr):
        return "task handle discarded — the spawn is untracked"
    if isinstance(parent, ast.Assign):
        target = parent.targets[0] if len(parent.targets) == 1 else None
        if isinstance(target, (ast.Attribute, ast.Subscript)):
            return None  # replace-on-rearm slot
        if isinstance(target, ast.Name):
            if _name_reused(fn, parent, target.id):
                return None
            return (f"task bound to {target.id!r} but never tracked, "
                    f"awaited, or cancelled")
    return None  # unusual shapes (tuple targets, comprehensions): pass


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
        if not m.relpath.startswith(SCOPE):
            continue
        parents = _parents(m.tree)
        for sym, fn in walk_functions(m.tree):
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call) and _is_spawn(node)):
                    continue
                if _nearest_fn(node, parents) is not fn:
                    continue  # reported against the nested function
                defect = _classify(fn, node, parents)
                if defect is not None:
                    findings.append(Finding(
                        rule=RULE, path=m.relpath, line=node.lineno,
                        symbol=sym,
                        message=f"unbounded per-op task spawn: {defect}; "
                                f"{FIX}"))
    return findings
