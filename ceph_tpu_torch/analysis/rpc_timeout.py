"""Rule family ``rpc-timeout``: cluster RPC awaits that can hang forever.

Counterpart of ``ceph_tpu/analysis/rpc_timeout.py``. Its scope is the
port's packages.

Every cross-daemon wait in ``ceph_tpu_torch/cluster/`` rides an
``asyncio.Future`` — either ``loop.create_future()`` (reply waiters) or
the OSD's ``_make_waiter()`` (sub-op ack accumulators).  A *bare*
``await fut`` on one of these has no timeout and no deadline: if the
peer dies, the reply frame is lost past replay, or the waiter is
orphaned by a map change, the coroutine hangs for the daemon's lifetime
— the op it serves never fails, never retries, and never frees its
admission budget.  Chaos runs only catch the instances the fault
schedule happens to hit; this rule catches the pattern statically.

Every legitimate wait wraps the future: ``asyncio.wait_for(fut, t)``
bounds it, ``fut.done()``/``fut.result()`` polls it.  The rule flags an
``await`` whose operand is a bare name bound (in the same function)
from a future-constructing call.
"""

from __future__ import annotations

import ast
from typing import List

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "rpc-timeout"

# call names (last dotted segment) that mint RPC futures in cluster code
_FUT_MAKERS = frozenset({"create_future", "_make_waiter"})

# round 13: graft-load's async driver joined the scope (a hung wait in
# the driver wedges the whole offered-load window the same way).
# round 15: the cluster/ prefix COVERS the front-door libraries
# (rbd.py, rgw.py, rgw_http.py, rgw_sync.py, mds.py, fs.py, snaps.py)
# — asserted by tests/test_frontdoor.py so a future scope refactor
# cannot silently drop them.
SCOPE = ("ceph_tpu_torch/cluster/", "ceph_tpu_torch/load/",
         "ceph_tpu_torch/osdmap/", "ceph_tpu_torch/chaos/",
         "ceph_tpu_torch/trace/flight.py",
         "ceph_tpu_torch/trace/postmortem.py")


def _future_names(fn: ast.AsyncFunctionDef) -> set:
    """Names assigned from a future-constructing call anywhere in the
    function body (nested defs included: a closure awaiting its parent's
    future hangs the same way).  Covers plain, annotated
    (``fut: asyncio.Future = ...``), and chained
    (``fut = self._waiter = ...``) assignments — all shapes cluster
    code actually uses to bind RPC futures."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        # the callee's terminal name, robust to chained receivers like
        # asyncio.get_event_loop().create_future() (dotted() bails on
        # call-chains)
        func = value.func
        if isinstance(func, ast.Attribute):
            callee = func.attr
        else:
            callee = (dotted(func) or "").split(".")[-1]
        if callee not in _FUT_MAKERS:
            continue
        for target in targets:
            if isinstance(target, ast.Name):
                names.add(target.id)
    return names


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        if not m.relpath.startswith(SCOPE):
            continue
        for sym, fn in walk_functions(m.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            futs = _future_names(fn)
            if not futs:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Await) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id in futs:
                    findings.append(Finding(
                        rule=RULE, path=m.relpath, line=node.lineno,
                        symbol=sym,
                        message=f"bare 'await {node.value.id}' on an RPC "
                                f"future can hang forever; wrap in "
                                f"asyncio.wait_for with a timeout or "
                                f"deadline"))
    return findings
