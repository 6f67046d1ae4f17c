"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``ceph_tpu_torch`` starts with
``ceph_tpu``); the reference imports nothing of the program either."""

import ast
import os

import pytest

from conftest import ROOT

PB = os.path.join(ROOT, "portbench")
BANNED = {"jax", "jaxlib", "flax", "ceph_tpu"}


def _sources():
    for base, dirs, files in os.walk(PB):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package(path):
    tops = set(_imports(path))
    assert not tops & BANNED, tops & BANNED
    if os.sep + "reference" + os.sep in path:
        assert "ceph_tpu_torch" not in tops


def test_the_check_tells_the_port_from_the_jax_package():
    assert "ceph_tpu_torch".split(".")[0] not in BANNED
    assert "ceph_tpu.ec".split(".")[0] in BANNED


def test_the_jax_records_are_not_read():
    here = os.path.dirname(os.path.abspath(__file__))
    for path in _sources():
        if os.path.dirname(path) == here:
            continue
        with open(path) as f:
            text = f.read()
        assert "bench.py" not in text.replace("portbench", "")
        assert "BENCH_" not in text and "BASELINE_MEASURED" not in text
