"""Rule family ``encode-decode``: wire/struct codec field symmetry.

Counterpart of ``ceph_tpu/analysis/symmetry.py``.

The reference's denc layer asserts encode/decode round-trips; our
structs are hand-paired, so a field added to ``encode`` but forgotten
in ``decode`` only fails when a message of that exact shape crosses a
version boundary.  This pass checks symmetry statically, three ways:

1. Class struct codecs — a class with ``encode(self)`` (serializer
   taking no payload args) and a paired ``decode``: every ``self.X``
   the encoder reads must be restored by the decoder (constructor
   kwarg or attribute assignment), and vice versa.  Decoders that
   rebuild wholesale (``pickle.loads(...)`` returned directly, or a
   positional constructor call) are opaque-total and exempt.

2. Module function pairs ``_encode_X``/``_decode_X`` (the messenger
   handshake idiom): for each message class the encoder handles in an
   ``isinstance`` branch, the decoder must construct the same class,
   and the field sets (attrs read while encoding vs constructor kwargs
   while decoding) must match.  Messenger-stamped header fields
   (src/seq/sid/trace) are exempt.

3. Wire dataclasses — every ``@dataclass`` deriving from ``Message``
   must give EVERY field a default: peers at different versions omit
   fields they don't know, and a default-less field turns that into a
   constructor error instead of a graceful downgrade.  Version-guard
   constants in encode/decode bodies (``if v >= N:``) must be
   monotonically nondecreasing in source order, and never exceed the
   class's declared ``struct_v``/``STRUCT_V`` bound (the denc analog of
   DECODE_START/DECODE_FINISH version sanity).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis.astutil import dotted, param_names
from ceph_tpu_torch.analysis.engine import Finding, LintContext

RULE = "encode-decode"

# header fields stamped by the messenger, never hand-encoded
_HEADER_FIELDS = {"src", "seq", "sid", "trace"}
_VERSION_NAMES = {"v", "ver", "version", "struct_v"}


def _attr_reads(node: ast.AST, base: str) -> Set[str]:
    """Attributes read off ``base`` (e.g. self.X / msg.X) under node."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                isinstance(sub.value, ast.Name) and sub.value.id == base \
                and not isinstance(getattr(sub, "ctx", None), ast.Store):
            out.add(sub.attr)
    return out


def _attr_writes(node: ast.AST) -> Set[str]:
    """Attributes assigned on ANY local object (t.ops = ..., self.X = ...)."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for tt in targets:
                    if isinstance(tt, ast.Attribute):
                        out.add(tt.attr)
        elif isinstance(sub, ast.AnnAssign) and \
                isinstance(sub.target, ast.Attribute):
            out.add(sub.target.attr)
    return out


def _ctor_calls(node: ast.AST, class_names: Set[str]) -> List[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = dotted(sub.func)
            if fn is not None and fn.split(".")[-1] in class_names:
                out.append(sub)
    return out


def _returns_pickle_loads(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Return) and sub.value is not None:
            for c in ast.walk(sub.value):
                if isinstance(c, ast.Call) and \
                        dotted(c.func) in ("pickle.loads", "pickle.load"):
                    return True
    return False


def _version_guards(fn: ast.AST) -> List[Tuple[int, int]]:
    """(line, constant) for every ``<ver> >= N`` / ``<ver> > N`` guard,
    in source order."""
    out = []
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Compare) and len(sub.ops) == 1 and \
                isinstance(sub.ops[0], (ast.Gt, ast.GtE)) and \
                isinstance(sub.left, ast.Name) and \
                sub.left.id in _VERSION_NAMES and \
                isinstance(sub.comparators[0], ast.Constant) and \
                isinstance(sub.comparators[0].value, int):
            out.append((sub.lineno, sub.comparators[0].value))
    return sorted(out)


def _class_struct_v(cls: ast.ClassDef) -> Optional[int]:
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name):
            targets, value = [stmt.target.id], stmt.value
        else:
            continue
        if any(t in ("struct_v", "STRUCT_V") for t in targets) and \
                isinstance(value, ast.Constant) and \
                isinstance(value.value, int):
            return value.value
    return None


def _check_version_guards(module, cls_name: str, fn, struct_v,
                          findings: List[Finding]):
    guards = _version_guards(fn)
    prev = None
    for line, const in guards:
        if prev is not None and const < prev:
            findings.append(Finding(
                rule=RULE, path=module.relpath, line=line,
                symbol=f"{cls_name}.{fn.name}" if cls_name else fn.name,
                message=f"version guards not monotonic: v>={const} after "
                        f"v>={prev} (fields must decode in version order)"))
        prev = const
        if struct_v is not None and const > struct_v:
            findings.append(Finding(
                rule=RULE, path=module.relpath, line=line,
                symbol=f"{cls_name}.{fn.name}" if cls_name else fn.name,
                message=f"version guard v>={const} exceeds declared "
                        f"struct_v={struct_v}"))


def _check_class_codecs(module, findings: List[Finding]):
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {s.name: s for s in node.body
                   if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        enc, dec = methods.get("encode"), methods.get("decode")
        if enc is None or dec is None:
            continue
        # struct serializers only: encode(self) with no payload params —
        # codec-transform encode(self, data, ...) APIs are not field
        # serialization and are exempt
        if [p for p in param_names(enc) if p not in ("self",)]:
            continue
        struct_v = _class_struct_v(node)
        _check_version_guards(module, node.name, enc, struct_v, findings)
        _check_version_guards(module, node.name, dec, struct_v, findings)

        encoded = _attr_reads(enc, "self") - _HEADER_FIELDS
        if not encoded:
            continue  # pickles self wholesale (or abstract): symmetric
        if _returns_pickle_loads(dec):
            continue  # opaque-total decode
        ctors = _ctor_calls(dec, {node.name, "cls"})
        if any(c.args for c in ctors):
            continue  # positional rebuild: can't map fields, assume total
        decoded = {kw.arg for c in ctors for kw in c.keywords
                   if kw.arg is not None}
        decoded |= _attr_writes(dec)
        sym = f"{node.name}.encode/decode"
        for f in sorted(encoded - decoded):
            findings.append(Finding(
                rule=RULE, path=module.relpath, line=dec.lineno, symbol=sym,
                message=f"field {f!r} is encoded but never restored by "
                        f"decode"))
        for f in sorted(decoded - encoded):
            findings.append(Finding(
                rule=RULE, path=module.relpath, line=enc.lineno, symbol=sym,
                message=f"field {f!r} is restored by decode but never "
                        f"encoded"))


def _isinstance_branches(fn: ast.AST, var: str) -> Dict[str, ast.If]:
    """class-name -> the `if isinstance(var, Cls)` branch node."""
    out: Dict[str, ast.If] = {}
    for sub in ast.walk(fn):
        if isinstance(sub, ast.If) and isinstance(sub.test, ast.Call) and \
                dotted(sub.test.func) == "isinstance" and \
                len(sub.test.args) == 2 and \
                isinstance(sub.test.args[0], ast.Name) and \
                sub.test.args[0].id == var:
            cls = dotted(sub.test.args[1])
            if cls is not None:
                out.setdefault(cls.split(".")[-1], sub)
    return out


def _check_fn_pairs(module, findings: List[Finding]):
    fns = {s.name: s for s in module.tree.body
           if isinstance(s, ast.FunctionDef)}
    for name, enc in fns.items():
        if not name.lstrip("_").startswith("encode"):
            continue
        dec_name = name.replace("encode", "decode", 1)
        dec = fns.get(dec_name)
        if dec is None or not param_names(enc):
            continue
        var = param_names(enc)[0]
        branches = _isinstance_branches(enc, var)
        if not branches:
            continue
        for cls, branch in branches.items():
            encoded = set()
            for stmt in branch.body:
                encoded |= _attr_reads(stmt, var)
            encoded -= _HEADER_FIELDS
            ctors = _ctor_calls(dec, {cls})
            if not ctors:
                findings.append(Finding(
                    rule=RULE, path=module.relpath, line=branch.lineno,
                    symbol=f"{name}/{dec_name}",
                    message=f"{cls} is encoded but {dec_name} never "
                            f"constructs it (no mirrored decode)"))
                continue
            if any(c.args for c in ctors):
                continue  # positional rebuild: assume total
            decoded = {kw.arg for c in ctors for kw in c.keywords
                       if kw.arg is not None}
            sym = f"{name}/{dec_name}:{cls}"
            for f in sorted(encoded - decoded):
                findings.append(Finding(
                    rule=RULE, path=module.relpath, line=branch.lineno,
                    symbol=sym,
                    message=f"field {f!r} is encoded but not decoded"))
            for f in sorted(decoded - encoded):
                findings.append(Finding(
                    rule=RULE, path=module.relpath, line=branch.lineno,
                    symbol=sym,
                    message=f"field {f!r} is decoded but never encoded"))


def _is_message_dataclass(node: ast.ClassDef) -> bool:
    has_dc = any((dotted(d) or "").split(".")[-1] == "dataclass"
                 or (isinstance(d, ast.Call) and
                     (dotted(d.func) or "").split(".")[-1] == "dataclass")
                 for d in node.decorator_list)
    derives = any((dotted(b) or "").split(".")[-1] in ("Message",)
                  for b in node.bases)
    return has_dc and derives


def _check_message_defaults(module, findings: List[Finding]):
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.ClassDef) and
                _is_message_dataclass(node)):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and \
                    stmt.value is None:
                findings.append(Finding(
                    rule=RULE, path=module.relpath, line=stmt.lineno,
                    symbol=node.name,
                    message=f"wire message field {stmt.target.id!r} has "
                            f"no default: an older peer omitting it "
                            f"breaks decode (version downgrade)"))


def check(modules, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for m in modules:
        _check_class_codecs(m, findings)
        _check_fn_pairs(m, findings)
        _check_message_defaults(m, findings)
    return findings
