"""CRUSH text-map compiler/decompiler — the operator map language.

A copy of ``ceph_tpu/crush/compiler.py`` on the port's types.

Behavioral analog of the reference CrushCompiler
(reference src/crush/CrushCompiler.cc: decompile_* and the
parse_* grammar): the `crushtool -d`/`-c` round-trippable text format
operators hand-edit —

    tunable choose_total_tries 50
    device 0 osd.0 class ssd
    type 0 osd
    host host0 {
        id -1
        alg straw2
        hash 0
        item osd.0 weight 1.000
    }
    rule replicated_rule {
        ruleset 0
        type replicated
        min_size 1
        max_size 10
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }

Covered subset: tunables, devices (+classes), types, all five bucket
algs, take/choose/chooseleaf (firstn|indep)/emit steps — the constructs
the rest of this framework implements.  choose_args (a binary-era
extension) are not expressible in the classic text format, matching the
reference.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from ceph_tpu_torch.crush.types import (
    Bucket,
    CrushMap,
    Rule,
    Tunables,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_TAKE,
)

_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable")

_STEP_OPS = {
    (RULE_TAKE): "take",
    (RULE_CHOOSE_FIRSTN): "choose firstn",
    (RULE_CHOOSE_INDEP): "choose indep",
    (RULE_CHOOSELEAF_FIRSTN): "chooseleaf firstn",
    (RULE_CHOOSELEAF_INDEP): "chooseleaf indep",
    (RULE_EMIT): "emit",
}


def decompile(cmap: CrushMap) -> str:
    """CrushMap -> operator text (CrushCompiler::decompile)."""
    out: List[str] = ["# begin crush map"]
    t = cmap.tunables
    for name in _TUNABLES:
        out.append(f"tunable {name} {getattr(t, name)}")
    out.append("")
    out.append("# devices")
    for dev in range(cmap.max_devices):
        cls = cmap.device_class.get(dev)
        suffix = f" class {cls}" if cls else ""
        out.append(f"device {dev} osd.{dev}{suffix}")
    out.append("")
    out.append("# types")
    for tid in sorted(cmap.type_names):
        out.append(f"type {tid} {cmap.type_names[tid]}")
    out.append("")
    out.append("# buckets")
    # children before parents (the reference emits leaves upward)
    emitted = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted:
            return
        b = cmap.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        emitted.add(bid)
        name = cmap.item_names.get(bid, f"bucket{-bid}")
        tname = cmap.type_names.get(b.type, str(b.type))
        out.append(f"{tname} {name} {{")
        out.append(f"\tid {bid}")
        out.append(f"\talg {b.alg}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for item, w in zip(b.items, b.weights):
            iname = (f"osd.{item}" if item >= 0
                     else cmap.item_names.get(item, f"bucket{-item}"))
            # 5 decimals: 1/0x10000 granularity round-trips exactly
            # (3 would silently perturb reweighted values -> placements)
            out.append(f"\titem {iname} weight {w / 0x10000:.5f}")
        out.append("}")
    for bid in sorted(cmap.buckets, reverse=True):
        emit_bucket(bid)
    out.append("")
    out.append("# rules")
    for ruleno, rule in enumerate(cmap.rules):
        out.append(f"rule rule{ruleno} {{")
        out.append(f"\truleset {ruleno}")
        out.append("\ttype replicated" if rule.type == 1
                   else "\ttype erasure")
        out.append(f"\tmin_size {rule.min_size}")
        out.append(f"\tmax_size {rule.max_size}")
        for op, arg1, arg2 in rule.steps:
            if op == RULE_TAKE:
                name = cmap.item_names.get(arg1, f"bucket{-arg1}")
                out.append(f"\tstep take {name}")
            elif op == RULE_EMIT:
                out.append("\tstep emit")
            elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
                tname = cmap.type_names.get(arg2, str(arg2))
                out.append(f"\tstep {_STEP_OPS[op]} {arg1} type {tname}")
            else:
                raise ValueError(f"undecompilable step op {op}")
        out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


def compile_text(text: str) -> CrushMap:
    """Operator text -> CrushMap (CrushCompiler::compile grammar)."""
    # strip comments, blank lines
    lines: List[str] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if line:
            lines.append(line)

    cmap = CrushMap(Tunables())
    cmap.type_names = {}
    name_to_id: Dict[str, int] = {}
    type_by_name: Dict[str, int] = {}
    pending_buckets: List[Tuple[str, str, List[str]]] = []
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("tunable "):
            _, name, val = line.split()
            if name not in _TUNABLES:
                raise ValueError(f"unknown tunable {name!r}")
            setattr(cmap.tunables, name, int(val))
            i += 1
        elif line.startswith("device "):
            parts = line.split()
            dev = int(parts[1])
            cmap.max_devices = max(cmap.max_devices, dev + 1)
            if len(parts) >= 5 and parts[3] == "class":
                cmap.device_class[dev] = parts[4]
            i += 1
        elif line.startswith("type "):
            _, tid, tname = line.split()
            cmap.type_names[int(tid)] = tname
            type_by_name[tname] = int(tid)
            i += 1
        elif line.startswith("rule ") and line.endswith("{"):
            body, i = _block(lines, i, line)
            _parse_rule(cmap, body, name_to_id)
        else:
            m = re.match(r"^(\S+)\s+(\S+)\s*\{$", line)
            if m is None:
                raise ValueError(f"cannot parse line: {line!r}")
            tname, bname = m.group(1), m.group(2)
            body, i = _block(lines, i, line)
            _parse_bucket(cmap, tname, bname, body, name_to_id,
                          type_by_name)
    return cmap


def _block(lines: List[str], i: int, opener: str) -> Tuple[List[str], int]:
    """Collect the body of a { } block; a hand-edited map missing its
    closing brace must fail as a parse error, not an IndexError."""
    body: List[str] = []
    i += 1
    while i < len(lines) and lines[i] != "}":
        body.append(lines[i])
        i += 1
    if i >= len(lines):
        raise ValueError(f"unterminated block: {opener!r} has no '}}'")
    return body, i + 1


def _parse_bucket(cmap, tname, bname, body, name_to_id, type_by_name):
    if tname not in type_by_name:
        raise ValueError(f"bucket {bname!r} has unknown type {tname!r}")
    bid = None
    alg = "straw2"
    hashv = 0
    items: List[int] = []
    weights: List[int] = []
    for line in body:
        parts = line.split()
        if parts[0] == "id":
            bid = int(parts[1])
        elif parts[0] == "alg":
            if parts[1] not in ("uniform", "list", "tree", "straw",
                                "straw2"):
                raise ValueError(f"unknown bucket alg {parts[1]!r}")
            alg = parts[1]
        elif parts[0] == "hash":
            hashv = int(parts[1])
        elif parts[0] == "item":
            iname = parts[1]
            w = 0x10000
            if "weight" in parts:
                w = int(round(float(parts[parts.index("weight") + 1])
                              * 0x10000))
            if iname.startswith("osd."):
                item = int(iname[4:])
                cmap.max_devices = max(cmap.max_devices, item + 1)
            elif iname in name_to_id:
                item = name_to_id[iname]
            else:
                raise ValueError(
                    f"bucket {bname!r} references undefined item {iname!r}")
            items.append(item)
            weights.append(w)
        else:
            raise ValueError(f"bad bucket line: {line!r}")
    b = Bucket(id=bid if bid is not None else 0,
               type=type_by_name[tname], alg=alg, hash=hashv,
               items=items, weights=weights)
    got = cmap.add_bucket(b, name=bname)
    name_to_id[bname] = got


def _parse_rule(cmap, body, name_to_id):
    rtype = 1
    min_size, max_size = 1, 10
    steps: List[Tuple[int, int, int]] = []
    for line in body:
        parts = line.split()
        if parts[0] in ("ruleset", "id"):
            pass  # rule number = position, as crushtool renumbers
        elif parts[0] == "type":
            rtype = 1 if parts[1] == "replicated" else 3
        elif parts[0] == "min_size":
            min_size = int(parts[1])
        elif parts[0] == "max_size":
            max_size = int(parts[1])
        elif parts[0] == "step":
            if parts[1] == "take":
                if parts[2] not in name_to_id:
                    raise ValueError(f"take of undefined {parts[2]!r}")
                steps.append((RULE_TAKE, name_to_id[parts[2]], 0))
            elif parts[1] == "emit":
                steps.append((RULE_EMIT, 0, 0))
            elif parts[1] in ("choose", "chooseleaf"):
                mode = parts[2]          # firstn | indep
                n = int(parts[3])
                tname = parts[5]         # "type" at parts[4]
                by_name = {v: k for k, v in cmap.type_names.items()}
                if tname not in by_name:
                    raise ValueError(
                        f"step references undeclared type {tname!r}")
                tid = by_name[tname]
                op = {
                    ("choose", "firstn"): RULE_CHOOSE_FIRSTN,
                    ("choose", "indep"): RULE_CHOOSE_INDEP,
                    ("chooseleaf", "firstn"): RULE_CHOOSELEAF_FIRSTN,
                    ("chooseleaf", "indep"): RULE_CHOOSELEAF_INDEP,
                }[(parts[1], mode)]
                steps.append((op, n, tid))
            else:
                raise ValueError(f"bad step: {line!r}")
        else:
            raise ValueError(f"bad rule line: {line!r}")
    cmap.add_rule(Rule(steps=steps, type=rtype, min_size=min_size,
                       max_size=max_size))
