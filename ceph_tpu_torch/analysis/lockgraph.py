"""Rule family ``lock-order``: whole-program static lock graph.

Counterpart of ``ceph_tpu/analysis/lockgraph.py``.

Reference lockdep (src/common/lockdep.cc) learns ordering edges at
RUNTIME — it only sees orderings a test happens to execute.  This pass
extracts the edges statically: every ``DepLock("name")`` binding is
collected (self-attribute, dataclass field factory, or local variable),
then every function body is walked with a held-stack over ``async
with`` nesting, producing held->acquired edges with file:line
provenance.  The static edges are merged with the runtime lockdep dump
(when provided) and the merged graph must be ACYCLIC — a cycle is a
deadlock that some interleaving can reach, reported before any test
runs it.

Nesting is mostly INTERPROCEDURAL here (a PG-lock holder calls into the
messenger, which takes the session lock), so the walk propagates
through calls: each function's intra-procedural acquisitions are
closed over the called-name graph to a fixpoint, and a call made while
holding L contributes L -> every lock the callee (by name) can reach.
Calls spawned via ``create_task``/``ensure_future``/``gather`` are
excluded — they do not run under the caller's locks.

Limitations (documented, deliberate): resolution is by attribute/
variable NAME, not points-to analysis — two locks bound to the same
attribute name merge, and same-named methods union their acquisitions
(conservative: may create edges, never misses a DepLock nesting);
nested function defs reset the held stack (a callback does not
necessarily run under its definition site's locks).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis.astutil import const_str, dotted, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "lock-order"

Edge = Tuple[str, str]


def _deplock_name(node: ast.AST) -> Optional[str]:
    """The lock name if ``node`` contains a DepLock("name") call."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = dotted(sub.func)
            if fn is not None and fn.split(".")[-1] == "DepLock" and sub.args:
                return const_str(sub.args[0])
    return None


def collect_bindings(modules) -> Tuple[Dict[str, str], Dict[Tuple[str, str], str]]:
    """(attr -> lock name, (relpath, var) -> lock name) over the repo."""
    attr_map: Dict[str, str] = {}
    var_map: Dict[Tuple[str, str], str] = {}

    for m in modules:

        def visit(node, scope: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.Assign, ast.AnnAssign)):
                    name = _deplock_name(child.value) \
                        if getattr(child, "value", None) else None
                    if name is not None:
                        targets = child.targets if isinstance(
                            child, ast.Assign) else [child.target]
                        for t in targets:
                            if isinstance(t, ast.Attribute):
                                attr_map[t.attr] = name
                            elif isinstance(t, ast.Name):
                                if scope == "class":
                                    attr_map[t.id] = name
                                var_map[(m.relpath, t.id)] = name
                if isinstance(child, ast.ClassDef):
                    visit(child, "class")
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda)):
                    visit(child, "function")
                else:
                    visit(child, scope)

        visit(m.tree, "module")
    return attr_map, var_map


def _resolve(expr: ast.AST, relpath: str, attr_map, var_map) -> Optional[str]:
    direct = _deplock_name(expr) if isinstance(expr, ast.Call) else None
    if direct is not None:
        return direct
    if isinstance(expr, ast.Attribute):
        return attr_map.get(expr.attr)
    if isinstance(expr, ast.Name):
        return var_map.get((relpath, expr.id))
    return None


# calls whose arguments run as their OWN tasks, not under our locks
_SPAWN_CALLS = {"create_task", "ensure_future", "gather", "call_soon",
                "call_later", "run_in_executor", "to_thread", "start_server"}


def _call_bare_name(call: ast.Call) -> Optional[str]:
    fn = dotted(call.func)
    return fn.split(".")[-1] if fn else None


def _scan_fn(fn, relpath, attr_map, var_map):
    """(acquires, called_names) of one function body: lock names taken
    via ``async with`` (DepLock is async-only, so plain ``with`` can
    never be one — threading locks sharing an attribute name must not
    alias in), and bare names of AWAITED calls (a sync call cannot
    acquire an asyncio lock; spawn-wrapped and nested-def calls are
    excluded — they do not run under our locks)."""
    acquires: Set[str] = set()
    called: Set[str] = set()

    def rec(node, spawned: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            sp = spawned
            if isinstance(child, ast.Call) and \
                    _call_bare_name(child) in _SPAWN_CALLS:
                sp = True  # its args don't run under our locks
            if isinstance(child, ast.Await) and \
                    isinstance(child.value, ast.Call) and not spawned:
                name = _call_bare_name(child.value)
                if name is not None and name not in _SPAWN_CALLS:
                    called.add(name)
            if isinstance(child, ast.AsyncWith):
                for item in child.items:
                    name = _resolve(item.context_expr, relpath,
                                    attr_map, var_map)
                    if name is not None:
                        acquires.add(name)
            rec(child, sp)

    rec(fn, False)
    return acquires, called


def _reachable_locks(modules, attr_map, var_map) -> Dict[str, Set[str]]:
    """bare function name -> every lock a call to that name can acquire,
    closed transitively over the called-name graph (name-based union
    across same-named functions; fixpoint)."""
    acquires: Dict[str, Set[str]] = {}
    calls: Dict[str, Set[str]] = {}
    for m in modules:
        for sym, fn in walk_functions(m.tree):
            bare = sym.split(".")[-1]
            a, c = _scan_fn(fn, m.relpath, attr_map, var_map)
            acquires.setdefault(bare, set()).update(a)
            calls.setdefault(bare, set()).update(c)
    reach = {n: set(a) for n, a in acquires.items()}
    changed = True
    while changed:
        changed = False
        for n, outs in calls.items():
            cur = reach.setdefault(n, set())
            before = len(cur)
            for o in outs:
                cur |= reach.get(o, set())
            changed = changed or len(cur) != before
    return reach


def extract_static_edges(modules) -> Dict[Edge, Tuple[str, int]]:
    """held->acquired edges from every DepLock ``async with`` nesting,
    each with (relpath, line) provenance of the inner acquisition.
    Direct nesting AND call-through: a call made while holding L adds
    L -> every lock the callee can transitively acquire."""
    attr_map, var_map = collect_bindings(modules)
    reach = _reachable_locks(modules, attr_map, var_map)
    edges: Dict[Edge, Tuple[str, int]] = {}

    for m in modules:
        for sym, fn in walk_functions(m.tree):

            def walk(node, held: List[str], spawned: bool):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                        continue  # callbacks don't inherit our held set
                    sp = spawned
                    if isinstance(child, ast.Call) and \
                            _call_bare_name(child) in _SPAWN_CALLS:
                        sp = True
                    if isinstance(child, ast.Await) and \
                            isinstance(child.value, ast.Call) and \
                            held and not spawned:
                        name = _call_bare_name(child.value)
                        for lock in (reach.get(name, ())
                                     if name not in _SPAWN_CALLS else ()):
                            for h in held:
                                if h != lock:
                                    edges.setdefault(
                                        (h, lock),
                                        (m.relpath, child.lineno))
                    if isinstance(child, ast.AsyncWith):
                        acquired = []
                        for item in child.items:
                            name = _resolve(item.context_expr, m.relpath,
                                            attr_map, var_map)
                            if name is None:
                                continue
                            for h in held:
                                if h != name:
                                    edges.setdefault(
                                        (h, name),
                                        (m.relpath, child.lineno))
                            held.append(name)
                            acquired.append(name)
                        walk(child, held, sp)
                        for _ in acquired:
                            held.pop()
                    else:
                        walk(child, held, sp)

            walk(fn, [], False)
    return edges


def find_cycle(succ: Dict[str, Set[str]]) -> Optional[List[str]]:
    """A cycle as [a, b, ..., a], or None if the graph is acyclic."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in set(succ) | {s for v in succ.values()
                                            for s in v}}
    path: List[str] = []

    def dfs(n) -> Optional[List[str]]:
        color[n] = GRAY
        path.append(n)
        for s in sorted(succ.get(n, ())):
            if color[s] == GRAY:
                return path[path.index(s):] + [s]
            if color[s] == WHITE:
                cyc = dfs(s)
                if cyc is not None:
                    return cyc
        path.pop()
        color[n] = BLACK
        return None

    for n in sorted(color):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc is not None:
                return cyc
    return None


def merged_graph(static_edges: Dict[Edge, Tuple[str, int]],
                 runtime_edges: Dict[str, list]) -> Dict[str, Set[str]]:
    succ: Dict[str, Set[str]] = {}
    for (a, b) in static_edges:
        succ.setdefault(a, set()).add(b)
    for a, outs in (runtime_edges or {}).items():
        for b in outs:
            if a != b:
                succ.setdefault(a, set()).add(b)
    return succ


def to_dot(static_edges: Dict[Edge, Tuple[str, int]],
           runtime_edges: Dict[str, list],
           cycle: Optional[List[str]] = None) -> str:
    """GraphViz DOT of the merged lock graph; static edges solid with
    provenance labels, runtime-only edges dashed, cycle edges red."""
    cyc_pairs = set()
    if cycle:
        cyc_pairs = {(cycle[i], cycle[i + 1]) for i in range(len(cycle) - 1)}
    lines = ["digraph lock_order {", '  rankdir=LR;',
             '  node [shape=box, fontname="monospace"];']
    seen = set()
    for (a, b), (path, ln) in sorted(static_edges.items()):
        attrs = [f'label="{path}:{ln}"']
        if (a, b) in cyc_pairs:
            attrs.append('color=red')
        lines.append(f'  "{a}" -> "{b}" [{", ".join(attrs)}];')
        seen.add((a, b))
    for a, outs in sorted((runtime_edges or {}).items()):
        for b in sorted(outs):
            if (a, b) in seen or a == b:
                continue
            attrs = ['style=dashed', 'label="runtime"']
            if (a, b) in cyc_pairs:
                attrs.append('color=red')
            lines.append(f'  "{a}" -> "{b}" [{", ".join(attrs)}];')
    lines.append("}")
    return "\n".join(lines)


def product_modules(modules):
    """Drop test modules: tests acquire deliberately-inverted orders to
    exercise runtime lockdep (and reset the graph between tests), so
    their orderings are not whole-program facts.  The lint corpus is
    exempt — its fixtures exist to be linted explicitly."""
    return [m for m in modules
            if not m.relpath.startswith("tests/")
            or m.relpath.startswith("tests/lint_corpus/")]


def check(modules, ctx: LintContext) -> List[Finding]:
    modules = product_modules(modules)
    static_edges = extract_static_edges(modules)
    succ = merged_graph(static_edges, ctx.runtime_edges)
    cycle = find_cycle(succ)
    ctx.static_edges_raw = static_edges
    ctx.lock_graph = {
        "locks": sorted(set(succ) | {s for v in succ.values() for s in v}),
        "static_edges": sorted(f"{a} -> {b} ({p}:{ln})"
                               for (a, b), (p, ln) in static_edges.items()),
        "runtime_edges": sorted(f"{a} -> {b}"
                                for a, outs in (ctx.runtime_edges or {}).items()
                                for b in outs if a != b),
        "acyclic": cycle is None,
        "cycle": cycle,
    }
    if cycle is None:
        return []
    # provenance: anchor the finding on the first static edge of the cycle
    path, line = "", 0
    for i in range(len(cycle) - 1):
        prov = static_edges.get((cycle[i], cycle[i + 1]))
        if prov is not None:
            path, line = prov
            break
    return [Finding(
        rule=RULE, path=path or "<runtime-only>", line=line, symbol="",
        message="lock ordering cycle in merged static+runtime graph: "
                + " -> ".join(cycle))]
