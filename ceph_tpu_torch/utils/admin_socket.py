"""AdminSocket-style command router (reference src/common/admin_socket.cc).

Every daemon owns one AdminSocket and registers command handlers into it
(AdminSocket::register_command analog); the daemon's MCommand dispatch
becomes one ``dispatch()`` call instead of a per-daemon if/elif ladder,
and the ``ceph daemon <name> <cmd>`` CLI path reaches any daemon through
the same table.

Counterpart of ``ceph_tpu/utils/admin_socket.py``.  The port serves the
same common command set except ``graftlint report``, which reads the
static-analysis package and arrives with it (``race report`` reads the
race tracker, ``ceph_tpu_torch/analysis/racecheck.py``).

Handlers take the full command dict and return the reply payload; they
may be sync or async (the reference's equivalent seam is AdminSocketHook
::call running on the admin socket thread).  Errors surface as
(-EINVAL, repr(e)) like the daemons' previous inline handling.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

from ceph_tpu_torch.utils.perf import PerfCounters, PerfCountersCollection


class AdminSocket:
    def __init__(self):
        self._commands: Dict[str, Tuple[Callable, str]] = {}
        self.register("help", lambda cmd: self.commands(),
                      "list registered commands")

    def register(self, prefix: str, handler: Callable[[Dict], Any],
                 desc: str = "") -> None:
        """Bind ``prefix`` -> handler(cmd_dict) -> reply payload."""
        self._commands[prefix] = (handler, desc)

    def commands(self) -> Dict[str, str]:
        return {p: d for p, (_, d) in sorted(self._commands.items())}

    def has(self, prefix: str) -> bool:
        return prefix in self._commands

    async def dispatch(self, cmd: Dict) -> Tuple[int, Any]:
        """Run the handler for cmd['prefix']; returns (result, data)
        with -22/EINVAL for unknown commands or handler errors."""
        entry = self._commands.get(cmd.get("prefix"))
        if entry is None:
            return -22, f"unknown command {cmd.get('prefix')!r} " \
                        f"(try 'help')"
        handler, _ = entry
        try:
            data = handler(cmd)
            if inspect.isawaitable(data):
                data = await data
        except Exception as e:
            return -22, repr(e)
        return 0, data

    # -- the standard per-daemon command set --------------------------------

    def register_common(self, perf, config=None, flight=None) -> None:
        """Register the commands every daemon serves: the perf family
        (reference perf dump / perf schema / perf histogram dump /
        perf reset) and config show/injectargs.  ``perf`` is a
        PerfCounters or a PerfCountersCollection.  ``flight`` (a
        FlightRecorder or NULL_FLIGHT) adds ``blackbox dump`` — the
        per-daemon postmortem snapshot: the flight ring plus the
        high-priority perf slice.  NULL_FLIGHT serves a disabled
        payload, so bundle collection never errors on a daemon that
        has the recorder off."""
        assert isinstance(perf, (PerfCounters, PerfCountersCollection))
        if flight is not None:
            self.register(
                "blackbox dump",
                lambda cmd: {"flight": flight.dump(),
                             "perf_critical": perf.dump_critical()},
                "flight-recorder ring + critical perf counters "
                "(the postmortem bundle's per-daemon slice)")
        self.register("perf dump", lambda cmd: perf.dump(),
                      "dump perf counter values")
        self.register("perf schema", lambda cmd: perf.dump_schema(),
                      "dump perf counter types/units/priorities")
        self.register("perf histogram dump",
                      lambda cmd: perf.dump_histograms(),
                      "dump histogram counters only")
        self.register("perf reset",
                      lambda cmd: perf.reset() or "reset",
                      "zero perf counter values (schemas kept)")
        if config is not None:
            self.register("config show", lambda cmd: config.show(),
                          "dump the daemon's config values")
            self.register(
                "injectargs",
                lambda cmd: config.injectargs(cmd.get("args", {})),
                "runtime config mutation")
        self.register("race report", lambda cmd: _race_report(),
                      "graft-race tracker state: probe counts, ticks, "
                      "and write-after-read convictions with both "
                      "task stacks (disabled payload when no tracker "
                      "is installed)")
        self.register("lockdep dump", _lockdep_dump,
                      "dump the observed runtime lock-ordering graph")
        self.register("chaos report",
                      lambda cmd: _chaos_report(config),
                      "injected-fault counters + this daemon's active "
                      "chaos options")


def _chaos_report(config):
    """Process-wide chaos counters + the daemon's chaos_* option view
    (config-driven injectors are fully described by those values)."""
    from ceph_tpu_torch.chaos.counters import chaos_report

    return chaos_report(config)


def _race_report():
    """The process-wide race tracker's report: NULL_RACE serves its
    disabled payload, so the command never errors when the sanitizer is
    off (the blackbox-dump contract)."""
    from ceph_tpu_torch.analysis import racecheck

    return racecheck.TRACKER.report()


def _lockdep_dump(cmd):
    """The live runtime lock graph."""
    from ceph_tpu_torch.utils.lockdep import LockDep

    return LockDep.instance().dump()
