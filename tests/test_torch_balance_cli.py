"""The port's balance CLI (``ceph_tpu_torch/tools/balance.py``) against
``scripts/balance.py``: the cases of ``tests/test_balance_cli.py``.

The operation-outcome codes (0 vs 1) are driven in-band against a fake
cluster, one for each package, and the two CLIs must give the same exit
code and print the same text (the JSON of ``--json`` included).  Usage
errors (2) run the port's CLI as a subprocess, so argparse's own exit
path is covered too, beside the reference's code for the same argv.  The
real ``status`` boots a 3-OSD cluster of each package (the port's on
``--device cpu``) and compares their JSON.
"""

import importlib.util
import json
import os
import subprocess
import sys

from ceph_tpu_torch.tools import balance as cli
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "balance.py")
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}


def _load_ref_cli():
    spec = importlib.util.spec_from_file_location("balance_cli_ref", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ fakes


class _FakeIO:
    async def write_full(self, oid, data):
        pass


class _FakeClient:
    async def pool_create(self, name, kind, pg_num=8, size=3):
        return 1

    def ioctx(self, pool):
        return _FakeIO()


class _FakeMon:
    def _health_data(self):
        return {"status": "HEALTH_OK"}


class _FakeCluster:
    """Scripted mgr: each ``balance status`` poll pops the next canned
    reshape-op snapshot (the last one repeats, like a stuck op)."""

    def __init__(self, statuses, command_results=None):
        self.statuses = list(statuses)
        self.command_results = dict(command_results or {})
        self.commands = []
        self.booted = []
        self.stopped = False
        self.mon = _FakeMon()
        self.osds = {}

    async def daemon_command(self, name, cmd, timeout=30.0):
        prefix = cmd if isinstance(cmd, str) else cmd["prefix"]
        self.commands.append(cmd)
        if prefix == "balance status":
            ops = (self.statuses.pop(0) if len(self.statuses) > 1
                   else self.statuses[0])
            return {"reshape_ops": ops}
        return self.command_results[prefix]

    async def boot_osds(self, osd_ids, timeout=15.0):
        self.booted = list(osd_ids)

    async def stop(self):
        self.stopped = True


def _run_both(make_cluster, argv, capsys, prepare=None):
    """``argv`` through the port's CLI (``--device cpu``) and the
    reference's, each on its own fake cluster from ``make_cluster()``.
    The exit codes and the printed text must be equal; returns (code,
    the port's cluster, its stdout, its stderr)."""
    out = []
    for side in ("port", "ref"):
        cluster = make_cluster()
        if prepare is not None:
            prepare(cluster)
        if side == "port":
            mod = cli
            booted = []

            async def fake_boot(n_osds, device, osds_per_host=1):
                booted.append(device)
                return cluster, _FakeClient()

            saved = (mod._boot, mod.RESHAPE_DEADLINE)
            mod._boot, mod.RESHAPE_DEADLINE = fake_boot, 2.0
            try:
                rc = mod.main(argv + ["--device", "cpu"])
            finally:
                mod._boot, mod.RESHAPE_DEADLINE = saved
            assert [str(d) for d in booted] == ["cpu"]
        else:
            mod = _load_ref_cli()

            async def fake_boot(n_osds, osds_per_host=1):
                return cluster, _FakeClient()

            mod._boot, mod.RESHAPE_DEADLINE = fake_boot, 2.0
            old = sys.argv
            sys.argv = ["balance.py"] + argv
            try:
                rc = mod.main()
            finally:
                sys.argv = old
        cap = capsys.readouterr()
        out.append((rc, cluster, cap.out, cap.err))
    (rc, cluster, pout, perr), (jrc, jcluster, jout, jerr) = out
    assert rc == jrc
    assert pout == jout
    assert perr == jerr
    assert cluster.commands == jcluster.commands
    return rc, cluster, pout, perr


# --------------------------------------------------- exit 0 / 1 in-band


def test_grow_exit0_boots_minted_osds_and_waits_done(capsys):
    def make():
        return _FakeCluster(
            statuses=[[{"id": 7, "kind": "grow", "osds": [3, 4],
                        "phase": "waiting-up", "detail": ""}],
                      [{"id": 7, "kind": "grow", "osds": [3, 4],
                        "phase": "done", "detail": "all new osds up"}]],
            command_results={"balance grow": {"id": 7, "kind": "grow",
                                              "osds": [3, 4],
                                              "phase": "waiting-up"}})

    rc, cluster, out, _ = _run_both(make, ["grow", "--count", "2"], capsys)
    assert rc == 0
    # the CLI played the operator: booted exactly the minted ids
    assert cluster.booted == [3, 4]
    assert cluster.stopped
    assert "OK grew" in out


def test_grow_exit1_when_reshape_op_stuck(capsys):
    def make():
        return _FakeCluster(
            statuses=[[{"id": 7, "kind": "grow", "osds": [3],
                        "phase": "waiting-up",
                        "detail": "1 of 1 not up"}]],
            command_results={"balance grow": {"id": 7, "kind": "grow",
                                              "osds": [3],
                                              "phase": "waiting-up"}})

    rc, cluster, _, err = _run_both(make, ["grow", "--count", "1"], capsys)
    assert rc == 1
    assert cluster.stopped
    assert "stuck in phase" in err


class _FakeOSD:
    def __init__(self):
        self.stopped = False

    async def stop(self):
        self.stopped = True


def test_drain_exit0_stops_daemons_at_wait_down(capsys):
    def make():
        return _FakeCluster(
            statuses=[[{"id": 2, "kind": "drain", "osds": [4],
                        "phase": "wait-clean", "detail": ""}],
                      [{"id": 2, "kind": "drain", "osds": [4],
                        "phase": "wait-down", "detail": "stop daemons"}],
                      [{"id": 2, "kind": "drain", "osds": [4],
                        "phase": "done", "detail": "purged 1 osds"}]],
            command_results={"balance drain": {"id": 2, "kind": "drain",
                                               "osds": [4],
                                               "phase": "wait-clean"}})

    osds = []

    def add_osd(cluster):
        osds.append(_FakeOSD())
        cluster.osds[4] = osds[-1]

    rc, cluster, _, _ = _run_both(make, ["drain", "--osds", "4"], capsys,
                                  prepare=add_osd)
    assert rc == 0
    # the operator's half of the handshake happened in both: the
    # retiring daemon was stopped once the op said wait-down
    assert [o.stopped for o in osds] == [True, True]
    assert 4 not in cluster.osds


def test_drain_exit1_when_stuck_in_wait_clean(capsys):
    def make():
        return _FakeCluster(
            statuses=[[{"id": 2, "kind": "drain", "osds": [4],
                        "phase": "wait-clean",
                        "detail": "3 pg slots still mapped"}]],
            command_results={"balance drain": {"id": 2, "kind": "drain",
                                               "osds": [4],
                                               "phase": "wait-clean"}})

    rc, _, _, _ = _run_both(make, ["drain", "--osds", "4"], capsys)
    assert rc == 1


def test_optimize_exit_codes_commit_error_vs_clean(capsys):
    def make_err():
        return _FakeCluster(
            statuses=[[]],
            command_results={"balance optimize": {
                "epoch": 9, "moves": 3, "dry_run": False,
                "commit_error": "TimeoutError('mon')"}})

    rc, _, _, err = _run_both(make_err, ["optimize"], capsys)
    assert rc == 1
    assert "FAIL commit" in err

    def make_ok():
        return _FakeCluster(
            statuses=[[]],
            command_results={"balance optimize": {
                "epoch": 9, "moves": 3, "dry_run": True}})

    rc, _, out, _ = _run_both(make_ok, ["optimize", "--dry-run", "--json"],
                              capsys)
    assert rc == 0
    assert "OK planned 3 moves" in out
    assert json.loads(out[:out.rindex("}") + 1])["moves"] == 3


def test_autoscale_exit0(capsys):
    def make():
        return _FakeCluster(
            statuses=[[]],
            command_results={"balance autoscale": {
                "epoch": 5, "dry_run": False, "actions": [],
                "pools": {}}})

    rc, _, out, _ = _run_both(make, ["autoscale"], capsys)
    assert rc == 0
    assert "OK autoscale" in out


# ------------------------------------------------------- exit 2 (usage)


def test_usage_errors_exit2():
    """Bad arguments never boot a cluster and exit 2, as the
    reference's: the port's CLI as a subprocess (argparse's own exit
    path, no traceback), the reference's in-band on the same argv."""
    ref = _load_ref_cli()
    cases = [
        ["grow", "--count", "0"],            # non-positive grow
        ["grow", "--count", "-3"],
        ["drain", "--osds", "abc"],          # unparsable id list
        ["drain", "--osds", ""],             # empty id list
        ["drain", "--osds", "9"],            # outside the cluster
        ["drain", "--osds", "0,1,2,3,4"],    # would drain everything
        ["bogus"],                           # unknown subcommand
        ["grow"],                            # missing required --count
    ]
    for argv in cases:
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.balance"] + argv,
            capture_output=True, text=True, timeout=60, cwd=REPO, env=ENV)
        old = sys.argv
        sys.argv = ["balance.py"] + argv
        try:
            jrc = ref.main()
        except SystemExit as e:
            jrc = e.code
        finally:
            sys.argv = old
        assert proc.returncode == jrc == 2, (argv, proc.stdout, proc.stderr)
        assert "Traceback" not in proc.stderr, argv


# ------------------------------------------------------------ e2e smoke


def test_status_subprocess_real_cluster():
    """One real boot through each CLI, side by side: ``status --json``
    against a live 3-OSD cluster reports the subsystem disabled (loops
    off is the CLI contract) with the seeded pool visible to the
    autoscaler; the port's (on ``--device cpu``) prints the reference's
    JSON."""
    args = ["status", "--osds", "3", "--pg-num", "8", "--json"]
    cmds = ([sys.executable, "-m", "ceph_tpu_torch.tools.balance"] + args +
            ["--device", "cpu"], [sys.executable, SCRIPT] + args)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO,
                              env=ENV)
             for cmd in cmds]
    docs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, out + err
            docs.append(json.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for doc in docs:
        assert doc["enabled"] is False and doc["autoscale_enabled"] is False
        assert doc["reshape_ops"] == []
        assert any(p.get("pool") == "balance" for p in doc["pools"].values())
    assert docs[0] == docs[1]
