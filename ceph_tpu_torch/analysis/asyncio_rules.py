"""Rule family ``asyncio-blocking``: event-loop stalls and untracked locks.

Counterpart of ``ceph_tpu/analysis/asyncio_rules.py``. The bare-lock
check's scope is ``ceph_tpu_torch/cluster/``.

Every daemon here is a single asyncio event loop; one blocking call in
an ``async def`` stalls every op the daemon has in flight — the
symptom is a SLOW_OPS health warning with nothing actually wrong, the
kind of bug thrash tests only trip under load.  And a bare
``asyncio.Lock()`` in cluster code is invisible to lockdep: its
orderings never enter the runtime graph, so neither the runtime
checker nor the static lock-order pass can prove anything about it.

Checks:
- blocking calls inside ``async def`` bodies: ``time.sleep``, builtin
  ``open()``, ``os.system``/``os.popen``, the ``subprocess`` family,
  ``urllib.request.urlopen``, ``socket.create_connection`` (nested
  ``def``s are skipped — they may run anywhere);
- ``asyncio.Lock()`` / ``asyncio.Semaphore()`` construction anywhere
  under ``ceph_tpu_torch/cluster/``: use ``DepLock(name)`` so the lock's
  orderings join the lockdep graphs (``asyncio.Condition`` is exempt:
  lockdep has no wait/notify model to track it with).
"""

from __future__ import annotations

import ast
from typing import List

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "asyncio-blocking"

_BLOCKING = {
    "time.sleep": "asyncio.sleep",
    "os.system": "asyncio.create_subprocess_shell",
    "os.popen": "asyncio.create_subprocess_shell",
    "subprocess.run": "asyncio.create_subprocess_exec",
    "subprocess.call": "asyncio.create_subprocess_exec",
    "subprocess.check_call": "asyncio.create_subprocess_exec",
    "subprocess.check_output": "asyncio.create_subprocess_exec",
    "subprocess.Popen": "asyncio.create_subprocess_exec",
    "urllib.request.urlopen": "an executor",
    "socket.create_connection": "asyncio.open_connection",
    "open": "an executor (or do the IO before going async)",
}

_UNTRACKED_LOCKS = {"asyncio.Lock", "asyncio.Semaphore",
                    "asyncio.BoundedSemaphore"}

# the lockdep implementation itself wraps asyncio.Lock — that is the
# one sanctioned constructor
_LOCKDEP_MODULE = "ceph_tpu_torch/utils/lockdep.py"


def _async_body_calls(fn: ast.AsyncFunctionDef):
    """Calls lexically in the async function's own body, skipping
    nested function/lambda definitions."""

    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from rec(child)

    yield from rec(fn)


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        for sym, fn in walk_functions(m.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for call in _async_body_calls(fn):
                cn = dotted(call.func)
                if cn in _BLOCKING:
                    findings.append(Finding(
                        rule=RULE, path=m.relpath, line=call.lineno,
                        symbol=sym,
                        message=f"blocking {cn}() inside async def stalls "
                                f"the daemon's event loop; use "
                                f"{_BLOCKING[cn]}"))
        if m.relpath.startswith("ceph_tpu_torch/cluster/"):
            for node in ast.walk(m.tree):
                hit = None
                if isinstance(node, ast.Call):
                    if dotted(node.func) in _UNTRACKED_LOCKS:
                        hit = f"bare {dotted(node.func)}()"
                    else:
                        # constructor passed by reference:
                        # field(default_factory=asyncio.Lock)
                        for kw in node.keywords:
                            if dotted(kw.value) in _UNTRACKED_LOCKS:
                                hit = f"{dotted(kw.value)} factory"
                if hit is not None:
                    findings.append(Finding(
                        rule=RULE, path=m.relpath, line=node.lineno,
                        symbol="",
                        message=f"{hit} escapes lockdep coverage; use "
                                f"DepLock(name) so static+runtime lock "
                                f"graphs see it"))
    return findings
