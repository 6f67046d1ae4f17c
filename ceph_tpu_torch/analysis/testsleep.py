"""Rule ``fixed-sleep-in-tests``: bare constant sleeps in the test
suite.

Counterpart of ``ceph_tpu/analysis/testsleep.py``.

A ``await asyncio.sleep(0.2)`` before an assertion is a guess about
how long the cluster needs — right on the laptop that wrote it, flaky
under CI load, and the class earlier work has been deflaking one file at
a time.  The repo's sanctioned shape is the wall-deadline converge
poll::

    deadline = loop.time() + 5.0
    while loop.time() < deadline and not cond():
        await asyncio.sleep(0.02)
    assert cond()

which this rule recognises lexically: a constant-duration sleep INSIDE
a ``while`` loop is the poll interval of a bounded retry and is legal.
A constant-duration sleep NOT inside a loop is a bare timing guess and
is flagged.

Exemptions:

- ``sleep(0)`` — a pure cooperative yield, not a wait (scheduling
  semantics, not timing);
- variable durations (``sleep(dt)``, ``sleep(interval)``) — the
  constant-guess smell is about literals;
- genuinely time-semantic pacing (e.g. spacing two wall-clock
  timestamps apart) carries an inline
  ``graftlint: ignore[fixed-sleep-in-tests]`` pragma with the reason
  in a comment — the baseline for this rule is pinned at ZERO, so the
  pragma is the only sanctioned escape and every use is visible at the
  call site.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "fixed-sleep-in-tests"

SCOPE = ("tests/",)

FIX = ("convert to a wall-deadline converge-poll (loop until the "
       "condition or a deadline), or pragma a genuinely time-semantic "
       "pacing sleep with the reason")

_SLEEP_CALLEES = frozenset({
    "asyncio.sleep", "time.sleep", "sleep",
})


def _const_duration(call: ast.Call) -> Optional[float]:
    """The literal duration if the first argument is a numeric
    constant, else None."""
    if not call.args or call.keywords:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and \
            isinstance(arg.value, (int, float)) and \
            not isinstance(arg.value, bool):
        return float(arg.value)
    return None


def _in_loop(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> bool:
    p = parents.get(node)
    while p is not None:
        if isinstance(p, (ast.While, ast.For, ast.AsyncFor)):
            return True
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return False
        p = parents.get(p)
    return False


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
        if not m.relpath.startswith(SCOPE):
            continue
        parents = _parents(m.tree)
        for sym, fn in walk_functions(m.tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or \
                        _nearest_fn(node, parents) is not fn:
                    continue
                callee = dotted(node.func)
                if callee not in _SLEEP_CALLEES:
                    continue
                dur = _const_duration(node)
                if dur is None or dur == 0:
                    continue
                if _in_loop(node, parents):
                    continue  # poll interval of a converge loop
                findings.append(Finding(
                    rule=RULE, path=m.relpath, line=node.lineno,
                    symbol=sym,
                    message=f"bare constant {callee}({dur:g}) outside "
                            f"a converge-poll loop; {FIX}"))
    return findings
