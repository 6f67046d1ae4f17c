"""Rule family ``torch-hygiene``: host syncs in the timed device region.

Counterpart of ``ceph_tpu/analysis/jax_hygiene.py``. The port has no jit
and no scan, so the reference's traced code narrows to its other half:
the step and feedback callables handed to the device-loop harness
(``ops/profiling.device_loop_slope``), the measured region of the timing
contract. There a hidden host sync serialises the chain the harness
replays on the device (a CUDA graph on the card) and the slope no longer
measures the step; the harness's own docstring says the callables must
not synchronise with the host.

Checks inside the timed region:
- host syncs: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
  ``torch.cuda.synchronize()`` anywhere (the counterpart of
  ``.block_until_ready()`` / ``.item()``);
- host materialization of a tensor parameter: ``bool``/``int``/``float``
  (and ``np.asarray``/``np.array``) applied to a parameter
  (``.shape``/``.ndim``/``.dtype``/``.size``/``len()`` uses are host
  metadata and exempt);
- ``time.*`` wall-clock calls (they time the host's enqueue, not the
  step);
- Python ``if``/``while`` branching on a bare tensor parameter (an
  implicit ``bool()``: a host sync per step).

Module scope: tensor creation on a CUDA device in a top-level statement
(``device="cuda"``, ``torch.device("cuda")``, ``.cuda()``,
``.to("cuda")``) reaches the card at import — flagged (host tables are
fine).

Resolution is by direct parameter reference (no dataflow), as in the
reference: high-precision, low-noise checks that hold as a zero-findings
gate.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from ceph_tpu_torch.analysis.astutil import const_str, dotted, \
    param_names, walk_functions
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "torch-hygiene"

_DEVICE_LOOP_NAMES = {"device_loop_slope", "_bench_device_loop"}
_HOST_COERCE = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                "float", "int", "bool"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "time.sleep", "time.process_time", "datetime.datetime.now"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "numel", "dim"}


def _collect_timed(module) -> List[Tuple[str, ast.AST]]:
    """(symbol, fn_node) for every step/feedback callable (function or
    lambda) handed to the device-loop harness in the module."""
    fns = list(walk_functions(module.tree))
    by_name: dict = {}
    for sym, fn in fns:
        by_name.setdefault(fn.name, []).append((sym, fn))

    timed: dict = {}

    def mark_by_ref(node: ast.AST):
        if isinstance(node, ast.Lambda):
            timed.setdefault(node, "<lambda>")
        elif isinstance(node, ast.Name):
            for s, f in by_name.get(node.id, []):
                timed.setdefault(f, s)

    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        cn = dotted(node.func)
        if cn is not None and cn.split(".")[-1] in _DEVICE_LOOP_NAMES:
            for arg in node.args[:2]:
                mark_by_ref(arg)
    return [(sym, fn) for fn, sym in timed.items()]


def _bare_param_refs(expr: ast.AST, params: Set[str]) -> Set[str]:
    """Parameter names used 'bare' in ``expr`` — excluding host-metadata
    uses (.shape/.ndim/.dtype/.size/..., len(), isinstance(), ``is None``
    checks)."""
    bare: Set[str] = set()

    def visit(node):
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return  # x.shape / x.size() is host metadata
            visit(node.value)
            return
        if isinstance(node, ast.Call):
            cn = dotted(node.func)
            if cn in ("len", "isinstance", "getattr", "hasattr", "type"):
                return
            visit(node.func)
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                visit(a)
            return
        if isinstance(node, ast.Compare) and \
                all(isinstance(o, (ast.Is, ast.IsNot)) for o in node.ops):
            return  # `x is None` style identity checks are host-side
        if isinstance(node, ast.Name):
            if node.id in params:
                bare.add(node.id)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return bare


def _check_timed_fn(module, sym: str, fn, findings: List[Finding]):
    params = set(param_names(fn))
    if params and param_names(fn)[0] in ("self", "cls"):
        params.discard(param_names(fn)[0])

    def flag(node, msg):
        findings.append(Finding(
            rule=RULE, path=module.relpath, line=node.lineno,
            symbol=sym or "<lambda>", message=msg))

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                cn = dotted(node.func)
                if cn in _HOST_COERCE:
                    ref = set().union(
                        *(_bare_param_refs(a, params) for a in node.args),
                        set())
                    if ref:
                        flag(node,
                             f"host materialization {cn}() of tensor "
                             f"{sorted(ref)[0]!r} inside the device-loop "
                             f"step (host sync)")
                elif cn in _TIME_CALLS:
                    flag(node,
                         f"wall-clock call {cn}() inside the device-loop "
                         f"step times the host's enqueue, not the step")
                elif cn in _SYNC_CALLS:
                    flag(node,
                         f"{cn}() inside the device-loop step (host sync "
                         f"in the measured region)")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_METHODS and not node.args:
                    flag(node,
                         f".{node.func.attr}() inside the device-loop step "
                         f"forces a host readback")
            elif isinstance(node, (ast.If, ast.While)):
                bare = _bare_param_refs(node.test, params)
                if bare:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    flag(node,
                         f"Python `{kind}` branches on tensor "
                         f"{sorted(bare)[0]!r} (an implicit bool(): a host "
                         f"sync per step); use torch.where or hoist the "
                         f"decision to host metadata")


def _names_cuda(node: ast.AST) -> bool:
    """Does ``node`` name a CUDA device: a 'cuda…' string or a
    ``torch.device('cuda…')`` call?"""
    s = const_str(node)
    if s is not None:
        return s.startswith("cuda")
    if isinstance(node, ast.Call) and \
            (dotted(node.func) or "").split(".")[-1] == "device" and \
            node.args:
        return _names_cuda(node.args[0])
    return False


def _cuda_creation(call: ast.Call) -> bool:
    if isinstance(call.func, ast.Attribute):
        if call.func.attr == "cuda":
            return True  # x.cuda()
        if call.func.attr == "to" and call.args and \
                _names_cuda(call.args[0]):
            return True  # x.to("cuda")
    return any(kw.arg == "device" and _names_cuda(kw.value)
               for kw in call.keywords)


def _module_scope_cuda(module, findings: List[Finding]):
    for stmt in module.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Import, ast.ImportFrom)):
            continue
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and _cuda_creation(node):
                cn = dotted(node.func) or \
                    f".{getattr(node.func, 'attr', 'call')}"
                findings.append(Finding(
                    rule=RULE, path=module.relpath, line=node.lineno,
                    symbol="",
                    message=f"module-scope {cn}() puts a tensor on a CUDA "
                            f"device at import time; build it host-side "
                            f"and move it inside a function"))


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        for sym, fn in _collect_timed(m):
            _check_timed_fn(m, sym, fn, findings)
        _module_scope_cuda(m, findings)
    return findings
