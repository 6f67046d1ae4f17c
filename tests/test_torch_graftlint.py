"""The port's graftlint (``ceph_tpu_torch/analysis/``,
``ceph_tpu_torch/tools/graftlint.py``) against ``ceph_tpu``'s: the cases
of ``tests/test_graftlint.py``, ``tests/test_frontdoor.py::
test_graftlint_scopes_cover_frontdoor_files`` and ``tests/test_racecheck.py
::test_graftlint_race_cli_exit_codes``.

Three layers, as in the reference: (1) the port lints clean against its
own baseline (``GRAFTLINT_TORCH_BASELINE.json``); (2) each rule family
fires on its bad fixture and stays quiet on its good twin — the
reference's corpus (``tests/lint_corpus/``) relabelled into the port's
scopes, and for ``torch-hygiene``, the counterpart of ``jax-hygiene``,
the port's own (``tests/lint_corpus/torch/``); (3) the runtime wiring on
the port's lockdep and admin socket.  Every rule copied from the
reference with only its scope re-pointed gives the reference's findings
on the same files of ``tests/lint_corpus/`` and ``ceph_tpu/``
(``test_copied_rule_equals_reference``).
"""

import asyncio
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest

import ceph_tpu.analysis.engine as jengine
import ceph_tpu.analysis.racecheck as jracecheck
from ceph_tpu_torch.analysis import baseline as baseline_mod
from ceph_tpu_torch.analysis import (
    asyncio_rules, engine, lockgraph, planar_hygiene, racecheck, symmetry,
    taskspawn, torch_hygiene,
)
from ceph_tpu_torch.utils.lockdep import DepLock, LockCycleError, LockDep
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REPO = engine.repo_root()
CORPUS = os.path.join(REPO, "tests", "lint_corpus")
TORCH_CORPUS = os.path.join(CORPUS, "torch")
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}


@pytest.fixture(autouse=True)
def _port_lockdep_reset():
    """The port's lock graph is its own process-wide one (the conftest
    resets only the reference's)."""
    LockDep.instance().reset()
    DepLock._held.clear()
    yield
    LockDep.instance().reset()
    DepLock._held.clear()


@pytest.fixture(scope="module")
def shipped_report():
    """One whole-port lint with the shipped baseline (it also fills the
    report cache that ``graftlint report`` serves)."""
    return engine.run_lint(baseline=baseline_mod.load_baseline(
        baseline_mod.default_baseline_path()))


def corpus(name):
    return os.path.join(CORPUS, name)


def cluster_path(name):
    return f"ceph_tpu_torch/cluster/{name}"


def lint_files(rule_mod, *names, relpath_as=None, runtime_edges=None,
               root=CORPUS):
    """Run one rule family over corpus files; relpath_as relabels the
    single module (most rules are scoped to the port's packages)."""
    modules, errors = engine.load_modules([os.path.join(root, n)
                                           for n in names])
    assert not errors, errors
    if relpath_as is not None:
        for m in modules:
            m.relpath = relpath_as
    ctx = engine.LintContext(runtime_edges=runtime_edges)
    return rule_mod.check(modules, ctx), ctx


def run_cli(*args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.graftlint", *args],
        capture_output=True, text=True, timeout=timeout, env=ENV, cwd=REPO)


# ---------------------------------------------------------------- the gate


def test_repo_lints_clean_with_shipped_baseline(shipped_report):
    """The gate: zero unsuppressed findings over the port, and the
    merged lock graph is acyclic."""
    report = shipped_report
    assert report.parse_errors == []
    assert report.findings == [], "\n" + report.render_text()
    assert report.stale_baseline == []
    assert report.lock_graph["acyclic"], report.lock_graph
    # the static pass extracted the port's cluster lock nestings
    # (daemon locks order before messenger locks)
    edges = "\n".join(report.lock_graph["static_edges"])
    assert "pg.lock -> messenger.session" in edges
    assert "messenger.session -> messenger.conn_send" in edges
    # the file set is the port's: its package, chip_smoke.py and its
    # tests, and nothing of the reference or the corpus
    paths = {os.path.relpath(p, REPO).replace(os.sep, "/")
             for p in engine.default_paths()}
    assert "chip_smoke.py" in paths
    assert "tests/test_torch_graftlint.py" in paths
    assert "tests/_torch_threads.py" in paths
    assert not [p for p in paths if p.startswith("ceph_tpu/")
                or "lint_corpus" in p or p.startswith("scripts/")
                or "/_build/" in p
                or (p.startswith("tests/") and "torch" not in p)]
    assert report.files_checked == len(paths)


def test_balance_subsystem_in_scope_with_no_baseline_debt():
    """Scope pin (graft-balance): every file of ceph_tpu_torch/balance/
    is in the default lint file set, with the balance CLI and the
    elastic scenario module, and the port's baseline carries ZERO
    entries for it."""
    paths = {os.path.relpath(p, REPO).replace(os.sep, "/")
             for p in engine.default_paths()}
    bal_dir = os.path.join(REPO, "ceph_tpu_torch", "balance")
    expected = {f"ceph_tpu_torch/balance/{fn}" for fn in os.listdir(bal_dir)
                if fn.endswith(".py")}
    assert expected, "ceph_tpu_torch/balance/ vanished"
    assert expected <= paths, expected - paths
    assert "ceph_tpu_torch/tools/balance.py" in paths
    assert "ceph_tpu_torch/chaos/balance.py" in paths
    baseline = baseline_mod.load_baseline(
        baseline_mod.default_baseline_path())
    debt = [k for k in baseline if "balance" in k]
    assert debt == [], debt


def test_cli_exits_zero_on_repo():
    proc = run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_json_and_dot(tmp_path):
    dot = tmp_path / "locks.dot"
    proc = run_cli("--json", "--dot", str(dot))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["ok"] is True
    assert doc["lock_graph"]["acyclic"] is True
    text = dot.read_text()
    assert "digraph lock_order" in text
    assert '"pg.lock" -> "messenger.session"' in text


def test_cli_exits_one_on_a_finding_and_writes_a_baseline(tmp_path):
    """Exit 1 on an unbaselined finding; --write-baseline accepts it
    (exit 0), after which the same lint exits 0."""
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nasync def t():\n    time.sleep(1)\n")
    base = tmp_path / "base.json"
    proc = run_cli(str(bad), "--baseline", str(base))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "asyncio-blocking" in proc.stdout
    proc = run_cli(str(bad), "--baseline", str(base), "--write-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 suppression(s)" in proc.stdout
    proc = run_cli(str(bad), "--baseline", str(base))
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------- rule: lock-order


def test_lock_order_good_clean():
    findings, _ = lint_files(lockgraph, "lock_order_good.py")
    assert findings == []


def test_lock_order_bad_cycle_detected():
    findings, ctx = lint_files(lockgraph, "lock_order_bad.py")
    assert len(findings) == 1
    assert findings[0].rule == "lock-order"
    assert "corpus.A" in findings[0].message
    assert "corpus.B" in findings[0].message
    assert ctx.lock_graph["acyclic"] is False


def test_lock_order_call_through_cycle():
    """Neither function nests directly; the inversion only exists
    through the awaited call — the interprocedural pass finds it."""
    findings, _ = lint_files(lockgraph, "lock_order_call_through_bad.py")
    assert len(findings) == 1
    assert "corpus.CT_A" in findings[0].message


def test_static_detection_fires_before_any_runtime_acquisition():
    """The bad corpus never RUNS — the port's runtime lockdep graph stays
    empty — yet the static pass already reports the deadlock."""
    LockDep.instance().reset()
    assert LockDep.instance().edges == {}
    findings, _ = lint_files(lockgraph, "lock_order_bad.py")
    assert findings, "static analysis must fire with zero runtime edges"
    assert LockDep.instance().edges == {}


def test_merged_static_plus_runtime_cycle():
    """A runtime-observed edge closing a static edge into a cycle fails
    the merged graph; the port's LockDep dump feeds straight in."""
    findings, ctx = lint_files(lockgraph, "lock_order_good.py",
                               runtime_edges={"corpus.B": ["corpus.A"]})
    assert len(findings) == 1
    assert ctx.lock_graph["acyclic"] is False

    async def scenario():
        a, b = DepLock("mg.A"), DepLock("mg.B")
        async with a:
            async with b:
                pass

    asyncio.run(scenario())
    dump = LockDep.instance().dump()
    assert dump["edges"] == {"mg.A": ["mg.B"]}
    succ = lockgraph.merged_graph({}, dump["edges"])
    assert lockgraph.find_cycle(succ) is None
    succ = lockgraph.merged_graph({("mg.B", "mg.A"): ("t", 1)},
                                  dump["edges"])
    assert lockgraph.find_cycle(succ) is not None


# ----------------------------------------------------- rule: torch-hygiene


def test_torch_hygiene_good_clean():
    """Counterpart of ``test_jax_hygiene_good_clean``."""
    findings, _ = lint_files(torch_hygiene, "torch_hygiene_good.py",
                             root=TORCH_CORPUS)
    assert findings == [], [f.render() for f in findings]


def test_torch_hygiene_bad_all_families_fire():
    """Counterpart of ``test_jax_hygiene_bad_all_families_fire``: every
    family of the reference's rule, in the port's timed region."""
    findings, _ = lint_files(torch_hygiene, "torch_hygiene_bad.py",
                             root=TORCH_CORPUS)
    msgs = "\n".join(f.message for f in findings)
    syms = {f.symbol for f in findings}
    assert {f.rule for f in findings} == {"torch-hygiene"}
    assert ".item()" in msgs and "bad_item" in syms
    assert ".cpu()" in msgs and "bad_cpu" in syms
    assert ".numpy()" in msgs and "bad_numpy" in syms
    assert ".tolist()" in msgs and "<lambda>" in syms
    assert "torch.cuda.synchronize()" in msgs and "bad_sync" in syms
    assert "host materialization float()" in msgs and "bad_float" in syms
    assert "host materialization np.asarray()" in msgs and \
        "bad_asarray" in syms
    assert "wall-clock" in msgs and "bad_clock" in syms
    assert "branches on tensor" in msgs and "bad_branch" in syms
    assert "module-scope torch.arange()" in msgs    # import-time card work
    assert "module-scope .cuda()" in msgs
    assert "feedback" not in syms                   # a clean callable
    assert len(findings) == 11, [f.render() for f in findings]


def test_torch_hygiene_metadata_uses_of_params_are_exempt(tmp_path):
    """Counterpart of ``test_static_argnames_params_are_static``: correct
    device-loop code — host metadata of a parameter (``.shape``,
    ``.ndim``, ``len()``), ``is None`` checks — must not fail the gate;
    the same step reading the tensor's value must."""
    src = (
        "import torch\n"
        "from ceph_tpu_torch.ops.profiling import device_loop_slope\n"
        "def step(x):\n"
        "    if x.ndim != 1 or len(x) < 2:\n"
        "        raise ValueError('1-D')\n"
        "    n = int(x.shape[0])\n"
        "    return x[: n // 2]\n"
        "def feedback(d, out):\n"
        "    if out is None:\n"
        "        return d\n"
        "    return d ^ out.sum(dtype=d.dtype)\n"
        "device_loop_slope(step, feedback, torch.zeros(8))\n")
    p = tmp_path / "metadata.py"
    p.write_text(src)
    report = engine.run_lint(paths=[str(p)], rules=[torch_hygiene],
                             root=str(tmp_path))
    assert report.findings == [], [f.render() for f in report.findings]
    p.write_text(src.replace("int(x.shape[0])", "int(x[0])"))
    report = engine.run_lint(paths=[str(p)], rules=[torch_hygiene],
                             root=str(tmp_path))
    assert [f.symbol for f in report.findings] == ["step"]


def test_torch_hygiene_reads_the_ports_timed_callables():
    """The rule's scope is the port's device-loop harness: it finds the
    step and feedback callables chip_smoke.py and the port's tests hand
    to ``device_loop_slope``, and they are clean."""
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_host_gaps.py")]
    modules, errors = engine.load_modules(paths)
    assert not errors, errors
    timed = {m.relpath: [s for s, _ in torch_hygiene._collect_timed(m)]
             for m in modules}
    assert "phase_loop_slope.feedback" in timed["chip_smoke.py"]
    assert len(timed["tests/test_torch_host_gaps.py"]) >= 2
    assert torch_hygiene.check(modules, engine.LintContext()) == []


# ----------------------------------------------------- rule: encode-decode


def test_symmetry_good_clean():
    findings, _ = lint_files(symmetry, "symmetry_good.py")
    assert findings == [], [f.render() for f in findings]


def test_symmetry_bad_all_families_fire():
    findings, _ = lint_files(symmetry, "symmetry_bad.py")
    msgs = "\n".join(f.message for f in findings)
    assert "'stamp' is encoded but never restored" in msgs
    assert "exceeds declared struct_v=2" in msgs
    assert "not monotonic" in msgs
    assert "'blob' is encoded but not decoded" in msgs
    assert "MOrphan is encoded but _decode_frame never constructs" in msgs
    assert "wire message field 'blob' has no default" in msgs


# -------------------------------------------------- rule: asyncio-blocking


def test_asyncio_good_clean():
    findings, _ = lint_files(asyncio_rules, "asyncio_good.py",
                             relpath_as=cluster_path("asyncio_good.py"))
    assert findings == [], [f.render() for f in findings]


def test_asyncio_bad_fires():
    findings, _ = lint_files(asyncio_rules, "asyncio_bad.py",
                             relpath_as=cluster_path("asyncio_bad.py"))
    msgs = "\n".join(f.message for f in findings)
    assert "time.sleep" in msgs
    assert "open()" in msgs
    assert "subprocess.run" in msgs
    assert "bare asyncio.Lock() escapes lockdep" in msgs


# ----------------------------------------------------- rule: task-spawn


def test_task_spawn_good_clean():
    findings, _ = lint_files(taskspawn, "task_spawn_good.py",
                             relpath_as=cluster_path("task_spawn_good.py"))
    assert findings == [], [f.render() for f in findings]


def test_task_spawn_bad_all_shapes_fire():
    findings, _ = lint_files(taskspawn, "task_spawn_bad.py",
                             relpath_as=cluster_path("task_spawn_bad.py"))
    msgs = "\n".join(f.message for f in findings)
    assert len(findings) == 5, [f.render() for f in findings]
    assert "task handle discarded" in msgs
    assert "_tasks.append()" in msgs        # grow-only list
    assert "_running.add()" in msgs         # grow-only set
    assert "'orphan' but never tracked" in msgs
    assert all(f.rule == "task-spawn" for f in findings)


def test_task_spawn_scoped_to_cluster():
    """The same source outside the port's packages stays quiet, and so
    does the reference's cluster/ path."""
    for relpath in (None, "ceph_tpu/cluster/task_spawn_bad.py"):
        findings, _ = lint_files(taskspawn, "task_spawn_bad.py",
                                 relpath_as=relpath)
        assert findings == [], relpath


# ------------------------------------- rule: swallowed-async-error


def test_swallowed_async_error_good_clean():
    from ceph_tpu_torch.analysis import async_errors

    findings, _ = lint_files(
        async_errors, "swallowed_async_good.py",
        relpath_as=cluster_path("swallowed_async_good.py"))
    assert findings == [], [f.render() for f in findings]


def test_swallowed_async_error_bad_all_shapes_fire():
    from ceph_tpu_torch.analysis import async_errors

    findings, _ = lint_files(
        async_errors, "swallowed_async_bad.py",
        relpath_as=cluster_path("swallowed_async_bad.py"))
    assert len(findings) == 4, [f.render() for f in findings]
    msgs = "\n".join(f.message for f in findings)
    assert "bare 'except:'" in msgs
    assert "'except Exception:'" in msgs
    assert "result discarded" in msgs
    assert "bound to 'results' but never read" in msgs
    assert all(f.rule == "swallowed-async-error" for f in findings)


def test_swallowed_async_error_scoped_to_cluster():
    from ceph_tpu_torch.analysis import async_errors

    findings, _ = lint_files(async_errors, "swallowed_async_bad.py")
    assert findings == []


def test_rpc_timeout_good_clean():
    from ceph_tpu_torch.analysis import rpc_timeout

    findings, _ = lint_files(
        rpc_timeout, "rpc_timeout_good.py",
        relpath_as=cluster_path("rpc_timeout_good.py"))
    assert findings == [], [f.render() for f in findings]


def test_rpc_timeout_bad_fires():
    from ceph_tpu_torch.analysis import rpc_timeout

    findings, _ = lint_files(
        rpc_timeout, "rpc_timeout_bad.py",
        relpath_as=cluster_path("rpc_timeout_bad.py"))
    # plain, annotated, and chained bindings all fire
    assert len(findings) == 4, [f.render() for f in findings]
    assert all(f.rule == "rpc-timeout" for f in findings)
    msgs = "\n".join(f.message for f in findings)
    assert "can hang forever" in msgs
    assert "wait_for" in msgs


def test_rpc_timeout_scoped_to_cluster():
    from ceph_tpu_torch.analysis import rpc_timeout

    findings, _ = lint_files(rpc_timeout, "rpc_timeout_bad.py")
    assert findings == []


def _port_scope(ref_scope):
    return tuple(s.replace("ceph_tpu/", "ceph_tpu_torch/", 1)
                 for s in ref_scope)


def test_scopes_cover_blackbox_modules():
    """Scope pin: the task-spawn / swallowed-async-error / rpc-timeout
    rules keep the port's blackbox modules in range, and each scope is
    the reference's re-pointed at the port."""
    from ceph_tpu.analysis import async_errors as jasync_errors
    from ceph_tpu.analysis import rpc_timeout as jrpc_timeout
    from ceph_tpu.analysis import taskspawn as jtaskspawn
    from ceph_tpu_torch.analysis import async_errors, rpc_timeout

    blackbox_files = [
        "ceph_tpu_torch/trace/flight.py",
        "ceph_tpu_torch/trace/postmortem.py",
        "ceph_tpu_torch/cluster/vstart.py",
        "ceph_tpu_torch/load/driver.py",
        "ceph_tpu_torch/chaos/scenario.py",
    ]
    for mod, ref in ((taskspawn, jtaskspawn), (async_errors, jasync_errors),
                     (rpc_timeout, jrpc_timeout)):
        assert mod.SCOPE == _port_scope(ref.SCOPE), mod.RULE
        assert mod.RULE == ref.RULE
        for path in blackbox_files:
            assert path.startswith(mod.SCOPE), (mod.RULE, path)
            assert os.path.exists(os.path.join(REPO, path)), path


def test_scopes_cover_client_batcher_modules():
    """Scope pin: the client-edge coalescer (the objecter and
    cluster/batcher.py) stays in the three rules' range, and
    per-op-device-dispatch keeps the port's batcher as its one
    coalescer seam."""
    from ceph_tpu_torch.analysis import (async_errors, device_dispatch,
                                         rpc_timeout)

    client_batch_files = [
        "ceph_tpu_torch/cluster/objecter.py",
        "ceph_tpu_torch/cluster/batcher.py",
        "ceph_tpu_torch/cluster/client_ops.py",
    ]
    for mod in (taskspawn, async_errors, rpc_timeout):
        for path in client_batch_files:
            assert path.startswith(mod.SCOPE), (mod.RULE, path)
    for path in client_batch_files:
        assert path.startswith("ceph_tpu_torch/cluster/"), path
    assert device_dispatch.COALESCER == "ceph_tpu_torch/cluster/batcher.py"


def test_graftlint_scopes_cover_frontdoor_files():
    """``tests/test_frontdoor.py``'s scope pin on the port: the three
    rules keep every front-door library, chaos seam and integrity module
    of the port in range."""
    from ceph_tpu_torch.analysis import async_errors, rpc_timeout

    frontdoor_files = [
        "ceph_tpu_torch/cluster/rbd.py", "ceph_tpu_torch/cluster/rgw.py",
        "ceph_tpu_torch/cluster/rgw_http.py",
        "ceph_tpu_torch/cluster/rgw_sync.py",
        "ceph_tpu_torch/cluster/mds.py", "ceph_tpu_torch/cluster/fs.py",
        "ceph_tpu_torch/cluster/snaps.py",
        "ceph_tpu_torch/chaos/frontdoor.py",
        "ceph_tpu_torch/chaos/points.py", "ceph_tpu_torch/load/driver.py",
        "ceph_tpu_torch/cluster/batcher.py",
        "ceph_tpu_torch/cluster/scrub.py",
        "ceph_tpu_torch/chaos/integrity.py",
    ]
    for mod in (taskspawn, async_errors, rpc_timeout):
        for path in frontdoor_files:
            assert path.startswith(mod.SCOPE), (mod.RULE, path)
            assert os.path.exists(os.path.join(REPO, path)), path


def test_device_dispatch_good_clean():
    from ceph_tpu_torch.analysis import device_dispatch

    findings, _ = lint_files(
        device_dispatch, "device_dispatch_good.py",
        relpath_as=cluster_path("device_dispatch_good.py"))
    assert findings == [], [f.render() for f in findings]


def test_device_dispatch_bad_fires():
    from ceph_tpu_torch.analysis import device_dispatch

    findings, _ = lint_files(
        device_dispatch, "device_dispatch_bad.py",
        relpath_as=cluster_path("device_dispatch_bad.py"))
    assert len(findings) == 4, [f.render() for f in findings]
    assert all(f.rule == "per-op-device-dispatch" for f in findings)
    msgs = "\n".join(f.message for f in findings)
    assert "to_planar()" in msgs and "encode_planar()" in msgs
    assert "encode_stripes handed to self._compute()" in msgs
    assert "crc32c_batch()" in msgs
    assert "batch coalescer" in msgs


def test_device_dispatch_scoped_and_coalescer_exempt():
    from ceph_tpu_torch.analysis import device_dispatch

    findings, _ = lint_files(device_dispatch, "device_dispatch_bad.py")
    assert findings == []
    findings, _ = lint_files(
        device_dispatch, "device_dispatch_bad.py",
        relpath_as=cluster_path("batcher.py"))
    assert findings == []


def test_device_dispatch_baseline_is_empty():
    """The reference's zero-debt pin holds for the port: every device
    dispatch of the port's cluster data plane routes through
    cluster/batcher.py, with ZERO baseline entries for the rule."""
    keys = baseline_mod.load_baseline(baseline_mod.default_baseline_path())
    assert not [k for k in keys
                if k.startswith("per-op-device-dispatch::")], keys
    from ceph_tpu_torch.analysis import device_dispatch

    report = engine.run_lint(rules=[device_dispatch])
    assert report.findings == [], "\n" + report.render_text()


# ------------------------------------------------------- runtime wiring


def test_deplock_aexit_pops_most_recent():
    """Same-named locks nesting must unwind LIFO on the port's DepLock
    (cycle detection off: only the held-stack bookkeeping is under
    test)."""

    async def scenario():
        outer, mid, inner = DepLock("dl.A"), DepLock("dl.B"), DepLock("dl.A")
        async with outer:
            async with mid:
                key = id(asyncio.current_task())
                async with inner:
                    assert DepLock._held[key] == ["dl.A", "dl.B", "dl.A"]
                assert DepLock._held[key] == ["dl.A", "dl.B"]
            assert DepLock._held[key] == ["dl.A"]
        assert key not in DepLock._held

    LockDep.instance().enabled = False
    try:
        asyncio.run(scenario())
    finally:
        LockDep.instance().enabled = True


def test_lockdep_fixture_isolate_between_tests_a():
    """With the module's reset fixture, an A->B order learned here must
    not leak into the next test (which takes B->A legitimately)."""

    async def scenario():
        async with DepLock("iso.A"):
            async with DepLock("iso.B"):
                pass

    asyncio.run(scenario())
    assert "iso.A" in LockDep.instance().edges


def test_lockdep_fixture_isolate_between_tests_b():
    assert "iso.A" not in LockDep.instance().edges  # fixture wiped it

    async def scenario():
        async with DepLock("iso.B"):
            async with DepLock("iso.A"):  # would cycle without the reset
                pass

    asyncio.run(scenario())


def test_admin_socket_lockdep_dump_and_graftlint_report(shipped_report):
    """`lockdep dump` and `graftlint report` on the port's AdminSocket:
    the observed lock graph and the port's last lint summary."""
    from ceph_tpu_torch.utils.admin_socket import AdminSocket
    from ceph_tpu_torch.utils.perf import PerfCounters

    async def scenario():
        asok = AdminSocket()
        asok.register_common(PerfCounters("t"))
        async with DepLock("asok.A"):
            async with DepLock("asok.B"):
                pass
        rc, dump = await asok.dispatch({"prefix": "lockdep dump"})
        assert rc == 0
        assert dump["edges"] == {"asok.A": ["asok.B"]}
        rc, rep = await asok.dispatch({"prefix": "graftlint report"})
        assert rc == 0
        assert rep["ok"] is True
        assert rep["files_checked"] > 100
        assert rep["lock_graph"]["acyclic"] is True
        assert rep == shipped_report.summary()

    asyncio.run(scenario())


def test_runtime_lockdep_still_catches_dynamic_cycles():
    """The static pass complements — not replaces — runtime lockdep."""

    async def scenario():
        a, b = DepLock("rt.A"), DepLock("rt.B")
        async with a:
            async with b:
                pass
        with pytest.raises(LockCycleError):
            async with b:
                async with a:
                    pass

    asyncio.run(scenario())


def test_baseline_roundtrip(tmp_path):
    f = engine.Finding(rule="r", path="p.py", line=3, symbol="s",
                       message="m")
    path = tmp_path / "b.json"
    n = baseline_mod.write_baseline(str(path), [f])
    assert n == 1
    keys = baseline_mod.load_baseline(str(path))
    assert f.baseline_key in keys
    f2 = engine.Finding(rule="r", path="p.py", line=99, symbol="s",
                        message="m")
    assert f2.baseline_key in keys
    # the key is the reference's, byte for byte
    jf = jengine.Finding(rule="r", path="p.py", line=3, symbol="s",
                         message="m")
    assert jf.baseline_key == f.baseline_key and jf.render() == f.render()


def test_pragma_suppression(tmp_path):
    src = (
        "import asyncio\n"
        "import time\n"
        "async def tick():\n"
        "    # graftlint: ignore[asyncio-blocking]\n"
        "    time.sleep(1)\n")
    p = tmp_path / "prag.py"
    p.write_text(src)
    report = engine.run_lint(paths=[str(p)],
                             rules=[asyncio_rules], root=str(tmp_path))
    assert report.findings == []
    p.write_text(src.replace("    # graftlint: ignore"
                             "[asyncio-blocking]\n", ""))
    report = engine.run_lint(paths=[str(p)],
                             rules=[asyncio_rules], root=str(tmp_path))
    assert len(report.findings) == 1


def test_subset_lint_does_not_poison_report_cache(shipped_report, tmp_path):
    """last_report (the `graftlint report` payload) must never serve a
    subset lint as the port's state."""
    whole = shipped_report
    assert whole.ok
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nasync def t():\n    time.sleep(1)\n")
    subset = engine.run_lint(paths=[str(bad)], rules=[asyncio_rules],
                             root=str(tmp_path))
    assert not subset.ok
    # nor one rule family over every file (the reference caches that
    # one; the port does not, ROADMAP section C)
    one_rule = engine.run_lint(rules=[asyncio_rules])
    assert one_rule.lock_graph is None
    cached = engine.last_report(run_if_missing=False)
    assert cached is not None
    assert cached["ok"] is True
    assert cached == whole.summary()


def test_stale_baseline_reported(tmp_path):
    p = tmp_path / "clean.py"
    p.write_text("x = 1\n")
    report = engine.run_lint(paths=[str(p)], rules=[asyncio_rules],
                             baseline={"ghost::entry::s::m"},
                             root=str(tmp_path))
    assert report.ok
    assert report.stale_baseline == ["ghost::entry::s::m"]


# ------------------------------------------- planar-conversion-hygiene


def test_planar_hygiene_good_clean():
    """Seam-declared transitions and reshape-only blob views pass; the
    one deliberately-unseamed fixture line carries a pragma the engine
    (not the raw rule) drops."""
    findings, _ = lint_files(planar_hygiene, "planar_hygiene_good.py",
                             relpath_as=cluster_path("store.py"))
    assert [f for f in findings if "unseamed" not in f.message] == [], \
        [f.render() for f in findings]
    modules, _ = engine.load_modules([corpus("planar_hygiene_good.py")])
    (m,) = modules
    assert all(m.pragma_suppressed(f.rule, f.line) for f in findings)


def test_planar_hygiene_bad_all_shapes_fire():
    findings, _ = lint_files(planar_hygiene, "planar_hygiene_bad.py",
                             relpath_as=cluster_path("store.py"))
    msgs = "\n".join(f.message for f in findings)
    assert "raw layout transform to_planar()" in msgs
    assert "raw layout transform rows_to_planes()" in msgs
    assert "shard_to_planes() without an explicit seam=" in msgs
    assert "planes_to_shard() without an explicit seam=" in msgs
    assert 'seam="unseamed"' in msgs
    assert len(findings) == 6, [f.render() for f in findings]


def test_planar_hygiene_scoped_to_cluster():
    """Scope pin: the rule polices the port's cluster/ modules only, and
    the tick coalescer is exempt by name."""
    for relpath in ("ceph_tpu_torch/ec/planar_store.py",
                    "ceph_tpu_torch/ops/gf8.py",
                    "tests/test_torch_stripe.py",
                    "ceph_tpu_torch/cluster/batcher.py",
                    "ceph_tpu/cluster/store.py"):
        findings, _ = lint_files(planar_hygiene, "planar_hygiene_bad.py",
                                 relpath_as=relpath)
        assert findings == [], (relpath, [f.render() for f in findings])


def test_planar_hygiene_zero_baseline_debt():
    """The reference's zero-debt pin holds for the port: every layout
    conversion in the port's cluster/ is seam-declared or pragma'd at a
    documented fallback."""
    baseline = baseline_mod.load_baseline(
        baseline_mod.default_baseline_path())
    assert not any(k.startswith("planar-conversion-hygiene::")
                   for k in baseline)
    report = engine.run_lint(rules=[planar_hygiene])
    assert report.findings == [], "\n" + report.render_text()


# --------------------------------------------------- rule: await-atomicity


def test_awaitrace_good_clean():
    from ceph_tpu_torch.analysis import awaitrace

    findings, _ = lint_files(awaitrace, "awaitrace_good.py",
                             relpath_as=cluster_path("awaitrace_good.py"))
    assert findings == [], [f.render() for f in findings]


def test_awaitrace_bad_all_variants_fire():
    from ceph_tpu_torch.analysis import awaitrace

    findings, _ = lint_files(awaitrace, "awaitrace_bad.py",
                             relpath_as=cluster_path("awaitrace_bad.py"))
    msgs = "\n".join(f"{f.symbol}: {f.message}" for f in findings)
    assert "stale_snapshot: stale-snapshot-across-await" in msgs
    assert "check_then_act: check-then-act-across-await" in msgs
    assert "lock_window_escape: lock-window-escape" in msgs
    assert len(findings) == 3, [f.render() for f in findings]


def test_awaitrace_scoped_to_cluster():
    from ceph_tpu_torch.analysis import awaitrace

    for relpath in ("ceph_tpu_torch/chaos/scenario.py",
                    "tests/test_torch_cluster_ops.py",
                    "ceph_tpu_torch/trace/flight.py",
                    "ceph_tpu/cluster/pg.py"):
        findings, _ = lint_files(awaitrace, "awaitrace_bad.py",
                                 relpath_as=relpath)
        assert findings == [], (relpath, [f.render() for f in findings])


def test_awaitrace_convicts_pr9_superseded_pgstate():
    """Historical-race pin: the superseded-PGState ack-wait shape is
    convicted, the identity re-check shape stays quiet."""
    from ceph_tpu_torch.analysis import awaitrace

    findings, _ = lint_files(
        awaitrace, "awaitrace_hist_pgstate.py",
        relpath_as=cluster_path("awaitrace_hist_pgstate.py"))
    assert len(findings) == 1, [f.render() for f in findings]
    assert findings[0].symbol.endswith("buggy_pr9_shape")
    assert "stale-snapshot-across-await" in findings[0].message
    assert "'pgs'" in findings[0].message


def test_awaitrace_convicts_pr11_stale_selfinfo_floor():
    """Historical-race pin: the roll-forward floor resting on the
    round-start self head is convicted; the re-read shape stays
    quiet."""
    from ceph_tpu_torch.analysis import awaitrace

    findings, _ = lint_files(
        awaitrace, "awaitrace_hist_selfinfo.py",
        relpath_as=cluster_path("awaitrace_hist_selfinfo.py"))
    assert len(findings) == 1, [f.render() for f in findings]
    assert findings[0].symbol.endswith("buggy_pr11_shape")
    assert "stale-snapshot-across-await" in findings[0].message
    assert "'last_update'" in findings[0].message


def test_scopes_cover_awaitrace_cluster_modules():
    """Scope pin: await-atomicity keeps the port's async data plane in
    range, and its watch-list is the reference's."""
    from ceph_tpu.analysis import awaitrace as jawaitrace
    from ceph_tpu_torch.analysis import awaitrace

    for path in ("ceph_tpu_torch/cluster/pg.py",
                 "ceph_tpu_torch/cluster/osd.py",
                 "ceph_tpu_torch/cluster/backend_ec.py",
                 "ceph_tpu_torch/cluster/recovery.py",
                 "ceph_tpu_torch/cluster/scrub.py",
                 "ceph_tpu_torch/cluster/client_ops.py",
                 "ceph_tpu_torch/cluster/batcher.py"):
        assert path.startswith(awaitrace.SCOPE), (awaitrace.RULE, path)
        assert os.path.exists(os.path.join(REPO, path)), path
    assert awaitrace.WATCHED_STATE == jawaitrace.WATCHED_STATE
    for attr in ("pgs", "acting", "last_update", "last_complete",
                 "pipeline_pending"):
        assert attr in awaitrace.WATCHED_STATE, attr


def test_awaitrace_registered_in_default_rules():
    """A refactor of all_rules() can't silently drop the race rules; the
    port runs the reference's families with torch-hygiene in place of
    jax-hygiene."""
    from ceph_tpu_torch.analysis import awaitrace, testsleep

    rules = engine.all_rules()
    assert awaitrace in rules
    assert testsleep in rules
    assert [r.RULE for r in rules] == [
        "torch-hygiene" if r.RULE == "jax-hygiene" else r.RULE
        for r in jengine.all_rules()]


# ----------------------------------------------- rule: fixed-sleep-in-tests


def test_fixed_sleep_good_clean():
    from ceph_tpu_torch.analysis import testsleep

    modules, errors = engine.load_modules([corpus("fixed_sleep_good.py")])
    assert not errors, errors
    modules[0].relpath = "tests/fixed_sleep_good.py"
    findings = testsleep.check(modules, engine.LintContext())
    live = [f for f in findings
            if not modules[0].pragma_suppressed(f.rule, f.line)]
    assert live == [], [f.render() for f in live]


def test_fixed_sleep_bad_all_shapes_fire():
    from ceph_tpu_torch.analysis import testsleep

    findings, _ = lint_files(testsleep, "fixed_sleep_bad.py",
                             relpath_as="tests/fixed_sleep_bad.py")
    msgs = "\n".join(f.message for f in findings)
    assert "asyncio.sleep(0.1)" in msgs
    assert "asyncio.sleep(1)" in msgs
    assert "time.sleep(0.5)" in msgs
    assert len(findings) == 3, [f.render() for f in findings]


def test_fixed_sleep_scoped_to_tests():
    from ceph_tpu_torch.analysis import testsleep

    findings, _ = lint_files(testsleep, "fixed_sleep_bad.py",
                             relpath_as=cluster_path("osd.py"))
    assert findings == []


def test_fixed_sleep_zero_baseline_debt():
    """The reference's zero-debt pin holds for the port's tests: every
    constant sleep in tests/test_torch_*.py is a converge-poll interval
    or a pragma'd, reasoned pacing sleep."""
    from ceph_tpu_torch.analysis import testsleep

    baseline = baseline_mod.load_baseline(
        baseline_mod.default_baseline_path())
    assert not any(k.startswith("fixed-sleep-in-tests::")
                   for k in baseline)
    report = engine.run_lint(rules=[testsleep])
    assert report.findings == [], "\n" + report.render_text()


# ------------------------------------------- the copied rules, held equal


# the rules copied from the reference with only their scopes re-pointed
COPIED = ["lockgraph", "symmetry", "asyncio_rules", "async_errors",
          "taskspawn", "rpc_timeout", "testsleep", "awaitrace",
          "device_dispatch", "planar_hygiene"]


def _files():
    """The reference's corpus and package: the same files for both."""
    corp = sorted(os.path.join(CORPUS, f) for f in os.listdir(CORPUS)
                  if f.endswith(".py"))
    pkg = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO,
                                                             "ceph_tpu")):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        pkg.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".py"))
    return corp + pkg


def _to_port(relpath):
    return relpath.replace("ceph_tpu/", "ceph_tpu_torch/", 1) \
        if relpath.startswith("ceph_tpu/") else relpath


def _to_ref(relpath):
    return relpath.replace("ceph_tpu_torch/", "ceph_tpu/", 1) \
        if relpath.startswith("ceph_tpu_torch/") else relpath


@pytest.fixture(scope="module")
def equivalence_modules():
    """Each package's parse of the same files: the reference's as they
    lie, the port's with every path under ceph_tpu/ re-pointed at
    ceph_tpu_torch/; and the corpus once more relabelled into the
    cluster scope (``ceph_tpu/cluster/<name>`` and its port twin), which
    is where the scoped rules read it."""
    paths = _files()
    ref, errors = jengine.load_modules(paths, REPO)
    assert not errors, errors
    port, errors = engine.load_modules(paths, REPO)
    assert not errors, errors
    for m in port:
        m.relpath = _to_port(m.relpath)
    corp = [m for m in ref if m.relpath.startswith("tests/lint_corpus/")]
    ref_c = [dataclasses.replace(
        m, relpath="ceph_tpu/cluster/" + os.path.basename(m.relpath))
        for m in corp]
    port_c = [dataclasses.replace(
        m, relpath="ceph_tpu_torch/cluster/" + os.path.basename(m.relpath))
        for m in port if m.relpath.startswith("tests/lint_corpus/")]
    return ref, port, ref_c, port_c


@pytest.mark.parametrize("rule", COPIED)
def test_copied_rule_equals_reference(rule, equivalence_modules):
    """The port's rule and the reference's, run on the same files of
    tests/lint_corpus/ and ceph_tpu/, give the same findings (rule, path,
    line, symbol, message), the port's paths read back as the
    reference's; the lock-order rule also the same lock graph."""
    jmod = importlib.import_module(f"ceph_tpu.analysis.{rule}")
    pmod = importlib.import_module(f"ceph_tpu_torch.analysis.{rule}")
    ref, port, ref_c, port_c = equivalence_modules
    fired = 0
    for jmods, pmods in ((ref, port), (ref_c, port_c)):
        jctx, pctx = jengine.LintContext(), engine.LintContext()
        want = [(f.rule, f.path, f.line, f.symbol, f.message)
                for f in jmod.check(jmods, jctx)]
        got = [(f.rule, _to_ref(f.path), f.line, f.symbol, f.message)
               for f in pmod.check(pmods, pctx)]
        assert got == want
        fired += len(want)
        if rule == "lockgraph":
            assert pctx.lock_graph["locks"] == jctx.lock_graph["locks"]
            assert pctx.lock_graph["cycle"] == jctx.lock_graph["cycle"]
            assert {k: (_to_ref(p), ln) for k, (p, ln)
                    in pctx.static_edges_raw.items()} == \
                jctx.static_edges_raw
    assert fired, "the comparison is vacuous: no finding fired"


# ------------------------------------------------------- the race CLI


def _load_ref_cli():
    path = os.path.join(REPO, "scripts", "graftlint.py")
    spec = importlib.util.spec_from_file_location("graftlint_cli_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_graftlint_race_cli_exit_codes(monkeypatch, capsys):
    """``tests/test_racecheck.py``'s --race contract on the port's CLI,
    code for code with the reference's: 0 clean, 1 convictions or
    scenario failures, 2 usage errors."""
    from ceph_tpu_torch.tools import graftlint as cli

    ref_cli = _load_ref_cli()
    dev = ["--device", "cpu"]
    for argv in (["--race", "batch-smoke", "--seeds", "bogus"],
                 ["--race", "batch-smoke", "--seeds", ""],
                 ["--race", "definitely-not-a-scenario"]):
        assert cli.main(argv + dev) == ref_cli.main(argv) == 2, argv

    class _Pass:
        passed = True
        failures = []

    class _Fail:
        passed = False
        failures = ["durability: obj3 unreadable"]

    clean = {"enabled": True, "seed": 1, "ticks": 3, "reads": 1,
             "writes": 1, "findings": []}
    dirty = dict(clean, findings=[{"message": "task A raced task B",
                                   "rule": "write-after-read"}])
    for result, argv, want in (
            ((_Pass, clean, "digest"), ["--seeds", "1,2"], 0),
            ((_Pass, dirty, "digest"), ["--seeds", "1"], 1),
            ((_Fail, clean, "digest"), ["--seeds", "1"], 1)):
        seen = []

        def fake(*a, _result=result, **k):
            seen.append(k.get("device"))
            return _result

        monkeypatch.setattr(racecheck, "race_run", fake)
        monkeypatch.setattr(jracecheck, "race_run",
                            lambda *a, _result=result, **k: _result)
        for as_json in ([], ["--json"]):
            args = ["--race", "batch-smoke"] + argv + as_json
            assert cli.main(args + dev) == want, args
            port_out = capsys.readouterr().out
            assert ref_cli.main(args) == want, args
            assert port_out == capsys.readouterr().out
        assert {str(d) for d in seen} == {"cpu"}


@pytest.mark.chaos
def test_graftlint_race_cli_runs_a_seed_on_the_cpu(capsys):
    """One real --race run of the port's CLI: the shrunk batch-smoke at
    seed 1 on the CPU exits 0 with no conviction, and its verdict's
    replay key is the reference's passing one."""
    from ceph_tpu_torch.tools import graftlint as cli

    verdicts = []
    real = racecheck.race_run

    def keep(*a, **k):
        out = real(*a, **k)
        verdicts.append(out[0])
        return out

    racecheck.race_run = keep
    try:
        rc = cli.main(["--race", "batch-smoke", "--seeds", "1", "--json",
                       "--device", "cpu"])
    finally:
        racecheck.race_run = real
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0, doc
    assert doc["ok"] is True and doc["runs"][0]["race"]["findings"] == []
    from tests.test_torch_racecheck import _ref_batch_smoke_key

    assert verdicts[0].replay_key() == _ref_batch_smoke_key(1)
