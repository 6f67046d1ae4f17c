"""Small shared AST helpers for the graftlint rule modules.

Counterpart of ``ceph_tpu/analysis/astutil.py``. """

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple


def dotted(node: ast.AST) -> Optional[str]:
    """'jax.lax.scan'-style dotted name for Name/Attribute chains, else
    None (calls, subscripts etc. break the chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_functions(tree: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """Yield (qualified_symbol, fn_node) for every (async) function,
    qualified through enclosing classes/functions."""

    def rec(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = f"{prefix}.{child.name}" if prefix else child.name
                yield sym, child
                yield from rec(child, sym)
            elif isinstance(child, ast.ClassDef):
                sym = f"{prefix}.{child.name}" if prefix else child.name
                yield from rec(child, sym)
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def param_names(fn: ast.AST) -> List[str]:
    """Positional parameter names of a FunctionDef/Lambda, in order."""
    a = fn.args
    return [p.arg for p in list(a.posonlyargs) + list(a.args)]


def names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
