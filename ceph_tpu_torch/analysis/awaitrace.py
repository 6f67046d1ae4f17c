"""Rule family ``await-atomicity``: stale shared-state snapshots across
await boundaries in the cluster data plane.

Counterpart of ``ceph_tpu/analysis/awaitrace.py``. Its scope is
``ceph_tpu_torch/cluster/``.

The costliest bug class of this reproduction is the await-interleaving
race: a coroutine snapshots shared cluster state, awaits, and then acts
on the stale snapshot — the superseded-PGState ack-wait persist
(``_advance_last_complete`` wrote a watermark through a PGState the PG
had left and rejoined around), the stale self-info peering wedge
(the roll-forward floor rested on an ``infos`` snapshot taken before
``_sync_self_from`` advanced the primary's own log), and the stale
RBD handle ``snap_remove`` were all exactly this shape, and every one
was found by a lucky chaos seed.  This pass convicts the shape
statically, the way the lock-order rule convicts deadlocks before any
test interleaves them.

Flagged inside ``async def``s under the cluster scope, driven by a
declared watch-list of known-mutable hot state (``WATCHED_STATE`` — the
DEVICE_CALLS idiom: adding a field to the list is a one-line diff):

- **stale-snapshot-across-await**: a local bound from a watched
  attribute read, where an ``await`` separates the binding from a later
  use and nothing revalidates in between.  Revalidation = re-binding
  the name after the await, or a test (``if``/``while``/``assert``/
  conditional expression) that mentions BOTH the name and its watched
  source — the ack-wait fix's ``pgs.get(st.pgid) is not st`` identity
  recheck is the canonical form.
- **check-then-act-across-await**: a conditional whose test reads a
  watched attribute and whose body awaits and THEN mutates state
  through that same attribute without re-checking — the classic
  check/act window where the checked predicate no longer holds.
- **lock-window-escape**: a local bound from a watched attribute read
  INSIDE an ``async with DepLock(...)`` block and used after the block
  exits — the lock made the snapshot consistent, leaving the window
  un-makes it.  (The sanctioned split-commit pattern — commit section
  under the lock, ack-wait outside — stays legal exactly when the
  post-window code revalidates, which is what the ack-wait and RBD fixes
  added; un-revalidated escapes land here.)

The analysis is lexical (source order approximates control flow, the
standard linter trade): it can miss loop-carried staleness and may flag
a snapshot whose await is on an unrelated branch.  Deliberate,
documented windows carry a ``graftlint: ignore[await-atomicity]``
pragma at the use site or a justified baseline entry — every remnant is
then a visible, reviewed inventory row of the repo's await windows.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis.astutil import dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "await-atomicity"

# async daemon code the rule polices — the cluster data/control plane
# (same shape as the task-spawn scope; pinned by the graftlint scope
# tests so a refactor can't silently drop cluster/ coverage)
SCOPE = ("ceph_tpu_torch/cluster/",)

# The watch-list: attribute names whose read is a SNAPSHOT of shared
# mutable cluster state that concurrent tasks advance across awaits.
# Chosen for the hot races this repo has already paid for: the per-OSD
# PG registry, PGState commit watermarks and membership (the ack-wait
# and self-info races, the frontier), and the in-flight pipeline map.  osdmap/epoch
# reads are deliberately NOT listed: epochs are versioned values whose
# staleness the map-subscription protocol already handles by design.
WATCHED_STATE = frozenset({
    "pgs", "_pgs",                       # OSD pgid -> PGState registry
    "acting", "up",                      # PG membership (peering moves it)
    "last_update", "last_complete",      # log head / commit watermark
    "pipeline_pending",                  # in-flight commit frontier
    "frontier_recovering",               # boot-reconstructed open entries
})

FIX = ("revalidate after the await (re-read the attribute, or "
       "identity-check the snapshot against its source) or pragma the "
       "documented window")

# mutating method names: a call through the snapshot/watched attr that
# writes state (the check-then-act "act" half, and a stale-snapshot use
# that is definitely not a harmless read)
_MUTATORS = frozenset({
    "append", "add", "pop", "remove", "discard", "clear", "update",
    "setdefault", "insert", "extend",
})


def _walk_shallow(root: ast.AST):
    """ast.walk that does not descend into nested function bodies —
    nested defs run on their own schedule and are analysed on their
    own when ``walk_functions`` yields them."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _watched_reads(expr: ast.AST) -> Set[str]:
    """Watched attribute names read anywhere inside ``expr``."""
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in WATCHED_STATE:
            out.add(node.attr)
        elif isinstance(node, ast.Name) and node.id in WATCHED_STATE:
            out.add(node.id)
    return out


def _pos(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def _end(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "end_lineno", getattr(node, "lineno", 0)),
            getattr(node, "end_col_offset", 0))


_INF = (10 ** 9, 0)


def _scope_end(node: ast.AST, parents: Dict[ast.AST, ast.AST],
               fn: ast.AST) -> Tuple[int, int]:
    """How far forward an await at ``node`` can flow: if an enclosing
    block ends in ``return``/``raise`` (the guard-clause idiom —
    ``if st is None: await reply(...); return``), executions that ran
    the await terminate inside that block and never reach code after
    it, so the await cannot stale-ify later uses."""
    cur = node
    p = parents.get(cur)
    while p is not None and cur is not fn:
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            break
        for _field, value in ast.iter_fields(p):
            if isinstance(value, list) and cur in value and value and \
                    isinstance(value[-1], (ast.Return, ast.Raise)) and \
                    p is not fn:
                return _end(value[-1])
        cur, p = p, parents.get(p)
    return _INF


class _FnScan:
    """One async function's lexical event streams."""

    def __init__(self, fn: ast.AsyncFunctionDef):
        self.fn = fn
        self._parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(fn):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        # (pos, name, watched_attrs, rhs_node) for x = <watched read>
        self.snapshots: List[Tuple[Tuple[int, int], str, Set[str]]] = []
        # (pos, end, reach) of suspension points (Await / AsyncWith /
        # AsyncFor): ``end`` closes the expression itself (arguments
        # evaluate BEFORE the suspension), ``reach`` bounds the code
        # the suspension can flow into
        self.awaits: List[Tuple[Tuple[int, int], Tuple[int, int],
                                Tuple[int, int]]] = []
        # name -> sorted positions of Store bindings (incl. the snapshot)
        self.stores: Dict[str, List[Tuple[int, int]]] = {}
        # name -> sorted positions of Load uses
        self.loads: Dict[str, List[Tuple[int, int]]] = {}
        # test expressions (if/while/assert/ternary/comprehension-if):
        # (pos, names mentioned, watched attrs mentioned)
        self.tests: List[Tuple[Tuple[int, int], Set[str], Set[str]]] = []
        self._walk(fn)

    def _note_test(self, expr: ast.AST) -> None:
        names = {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}
        self.tests.append((_pos(expr), names, _watched_reads(expr)))

    def _walk(self, root: ast.AST) -> None:
        def rec(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # nested defs run on their own schedule
                if isinstance(child, ast.Await):
                    self.awaits.append(
                        (_pos(child), _end(child),
                         _scope_end(child, self._parents, self.fn)))
                elif isinstance(child, (ast.AsyncWith, ast.AsyncFor)):
                    # the whole block is a suspension region, but its
                    # header expression still evaluates pre-suspension
                    self.awaits.append(
                        (_pos(child), _pos(child),
                         _scope_end(child, self._parents, self.fn)))
                if isinstance(child, (ast.If, ast.While)):
                    self._note_test(child.test)
                elif isinstance(child, ast.Assert):
                    self._note_test(child.test)
                elif isinstance(child, ast.IfExp):
                    self._note_test(child.test)
                elif isinstance(child, ast.comprehension):
                    for cond in child.ifs:
                        self._note_test(cond)
                if isinstance(child, ast.Assign):
                    watched = _watched_reads(child.value)
                    for t in child.targets:
                        if isinstance(t, ast.Name):
                            self.stores.setdefault(
                                t.id, []).append(_pos(child))
                            if watched:
                                self.snapshots.append(
                                    (_pos(child), t.id, watched))
                elif isinstance(child, ast.AnnAssign) and child.value:
                    if isinstance(child.target, ast.Name):
                        watched = _watched_reads(child.value)
                        self.stores.setdefault(
                            child.target.id, []).append(_pos(child))
                        if watched:
                            self.snapshots.append(
                                (_pos(child), child.target.id, watched))
                elif isinstance(child, ast.NamedExpr) and \
                        isinstance(child.target, ast.Name):
                    watched = _watched_reads(child.value)
                    self.stores.setdefault(
                        child.target.id, []).append(_pos(child))
                    if watched:
                        self.snapshots.append(
                            (_pos(child), child.target.id, watched))
                elif isinstance(child, (ast.For, ast.AsyncFor)):
                    # loop targets rebind on every iteration — a fresh
                    # binding for staleness purposes
                    for n in ast.walk(child.target):
                        if isinstance(n, ast.Name):
                            self.stores.setdefault(
                                n.id, []).append(_pos(child))
                elif isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        if item.optional_vars is not None:
                            for n in ast.walk(item.optional_vars):
                                if isinstance(n, ast.Name):
                                    self.stores.setdefault(
                                        n.id, []).append(_pos(child))
                if isinstance(child, ast.Name) and \
                        isinstance(child.ctx, ast.Load):
                    self.loads.setdefault(child.id, []).append(_pos(child))
                rec(child)

        rec(root)
        self.awaits.sort()

    def await_between(self, pos, use) -> bool:
        """Is there a suspension point between ``pos`` and ``use``
        whose post-await flow can reach ``use``?  A use inside the
        await expression itself evaluates pre-suspension and does not
        count."""
        return any(pos < a and end < use and use <= reach
                   for (a, end, reach) in self.awaits)

    def revalidated(self, name: str, watched: Set[str],
                    lo, hi) -> bool:
        """Is there a re-binding of ``name`` or a test mentioning both
        ``name`` and one of its watched sources in (lo, hi]?"""
        for p in self.stores.get(name, ()):
            if lo < p <= hi:
                return True
        for (p, names, attrs) in self.tests:
            if lo < p <= hi and name in names and (attrs & watched):
                return True
        return False


def _mutation_sites(body_nodes: List[ast.AST]) -> List[Tuple[Tuple[int, int],
                                                             ast.AST]]:
    """(pos, node) of state mutations lexically inside ``body_nodes``:
    attribute/subscript stores, augmented assigns, ``del``, and calls
    of mutating methods."""
    out = []
    for root in body_nodes:
        for node in _walk_shallow(root):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        out.append((_pos(node), t))
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, (ast.Attribute, ast.Subscript)):
                out.append((_pos(node), node.target))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        out.append((_pos(node), t))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                out.append((_pos(node), node.func.value))
    return out


def _check_stale_snapshot(m, sym: str, scan: _FnScan, windows,
                          findings: List[Finding]) -> None:
    reported: Set[Tuple[str, str]] = set()
    for (pos, name, watched) in scan.snapshots:
        if (name, min(watched)) in reported:
            continue
        if any(w_start <= pos <= w_end for (w_start, w_end) in windows):
            # snapshot taken inside an async-with DepLock window: the
            # lock IS the revalidation while the window lasts (the
            # sanctioned split-commit shape), and a value that OUTLIVES
            # the window is the escape variant's conviction — either
            # way, not this variant's call
            continue
        # the first awaited-across use that is not revalidated
        for use in sorted(scan.loads.get(name, ())):
            if use <= pos or not scan.await_between(pos, use):
                continue
            if scan.revalidated(name, watched, pos, use):
                break  # later uses read the revalidated binding
            attr = sorted(watched)[0]
            findings.append(Finding(
                rule=RULE, path=m.relpath, line=use[0], symbol=sym,
                message=f"stale-snapshot-across-await: {name!r} "
                        f"snapshots shared {attr!r} before an await "
                        f"and is used after it without revalidation; "
                        f"{FIX}"))
            reported.add((name, min(watched)))
            break


def _check_check_then_act(m, sym: str, fn: ast.AsyncFunctionDef,
                          findings: List[Finding]) -> None:
    for node in _walk_shallow(fn):
        if not isinstance(node, ast.If):
            continue
        watched = _watched_reads(node.test)
        if not watched:
            continue
        # an await inside the body, then a mutation through the same
        # watched attr after it, with no re-check of the attr between
        awaits = []
        for sub in node.body:
            for n in _walk_shallow(sub):
                if isinstance(n, (ast.Await, ast.AsyncWith, ast.AsyncFor)):
                    awaits.append(_pos(n))
        if not awaits:
            continue
        first_await = min(awaits)
        rechecks = []
        for sub in node.body:
            for n in _walk_shallow(sub):
                if isinstance(n, (ast.If, ast.While)) and \
                        (_watched_reads(n.test) & watched) and \
                        _pos(n) > first_await:
                    rechecks.append(_pos(n))
        for (mpos, target) in _mutation_sites(node.body):
            if mpos <= first_await:
                continue
            hit = _watched_reads(target) & watched
            if not hit:
                continue
            if any(r < mpos for r in rechecks):
                continue
            attr = sorted(hit)[0]
            findings.append(Finding(
                rule=RULE, path=m.relpath, line=mpos[0], symbol=sym,
                message=f"check-then-act-across-await: conditional on "
                        f"shared {attr!r} awaits and then mutates it "
                        f"without re-checking; {FIX}"))
            break


def _deplock_withs(fn: ast.AsyncFunctionDef, m, attr_map,
                   var_map) -> List[ast.AsyncWith]:
    """AsyncWith blocks in ``fn`` whose context manager resolves to a
    DepLock (by the lock-order rule's binding maps, plus the inline
    ``async with DepLock("x")`` form)."""
    from ceph_tpu_torch.analysis import lockgraph

    out = []
    for node in _walk_shallow(fn):
        if not isinstance(node, ast.AsyncWith):
            continue
        for item in node.items:
            if lockgraph._resolve(item.context_expr, m.relpath,
                                  attr_map, var_map) is not None:
                out.append(node)
                break
    return out


def _check_lock_window_escape(m, sym: str, scan: _FnScan, windows,
                              findings: List[Finding]) -> None:
    reported: Set[str] = set()
    for (w_start, w_end) in windows:
        for (pos, name, watched) in scan.snapshots:
            if not (w_start <= pos <= w_end) or name in reported:
                continue
            for use in scan.loads.get(name, ()):
                if use <= w_end:
                    continue
                if scan.revalidated(name, watched, w_end, use):
                    break
                attr = sorted(watched)[0]
                findings.append(Finding(
                    rule=RULE, path=m.relpath, line=use[0], symbol=sym,
                    message=f"lock-window-escape: {name!r} snapshots "
                            f"shared {attr!r} inside an async-with "
                            f"DepLock window and is used after the "
                            f"lock is released without revalidation; "
                            f"{FIX}"))
                reported.add(name)
                break


def check(modules, ctx: LintContext) -> List[Finding]:
    from ceph_tpu_torch.analysis import lockgraph

    findings: List[Finding] = []
    # DepLock bindings are collected over the WHOLE module set (like
    # the lock-order rule): a lock bound in pg.py resolves in osd.py
    attr_map, var_map = lockgraph.collect_bindings(modules)
    for m in modules:
        if not m.relpath.startswith(SCOPE):
            continue
        for sym, fn in walk_functions(m.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            scan = _FnScan(fn)
            windows = [(_pos(w), _end(w))
                       for w in _deplock_withs(fn, m, attr_map, var_map)]
            _check_stale_snapshot(m, sym, scan, windows, findings)
            _check_check_then_act(m, sym, fn, findings)
            _check_lock_window_escape(m, sym, scan, windows, findings)
    return findings
