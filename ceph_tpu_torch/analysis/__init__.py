"""graftlint for the port: whole-package AST static analysis (the
denc/lockdep of this port, moved to lint time), and the race sanitizer's
access tracker (``racecheck``), which the OSD's probes read.

Counterpart of ``ceph_tpu/analysis/__init__.py``. The rule families:

- ``lockgraph``      lock-order graph extraction over every ``DepLock``
                     nesting; merged with the runtime lockdep edges the
                     whole-program graph must stay acyclic.
- ``torch_hygiene``  host syncs inside the device-loop harness's timed
                     callables, and CUDA tensors made at import (the
                     counterpart of the reference's ``jax_hygiene``).
- ``symmetry``       encode/decode field symmetry for wire structs and
                     codec plans (the denc analog).
- ``asyncio_rules``  blocking calls inside ``async def`` and bare
                     ``asyncio.Lock`` in cluster/ escaping lockdep.
- ``taskspawn``      unbounded per-op task spawns (discarded handles,
                     grow-only registries).
- ``rpc_timeout``    bare ``await fut`` on RPC futures (no timeout).
- ``async_errors``, ``awaitrace``, ``device_dispatch``,
  ``planar_hygiene``, ``testsleep``: swallowed async failures, stale
                     snapshots across awaits, per-op device dispatch,
                     layout conversions off the seams, fixed sleeps in
                     tests.

`engine.run_lint` drives the rules over a file set (by default the
port's: ``ceph_tpu_torch/``, ``chip_smoke.py`` and the port's tests);
`baseline` carries per-finding suppressions
(``GRAFTLINT_TORCH_BASELINE.json``) so accepted findings don't block the
gate while anything NEW fails loudly.
"""

from ceph_tpu_torch.analysis.engine import (  # noqa: F401
    Finding, Report, run_lint, last_report, default_paths,
)
from ceph_tpu_torch.analysis.baseline import (  # noqa: F401
    load_baseline, write_baseline,
)
