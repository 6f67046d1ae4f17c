"""graft-load: deterministic traffic driver + SLO judge + soak.

Counterpart of ``ceph_tpu/load/``:

- ``dist``    — THE seeded samplers (zipfian popularity, arrival
                processes, weighted verb mixes), shared with chaos
- ``driver``  — ``LoadSpec`` + open-loop driver: simulated clients
                multiplexed over a bounded objecter session pool
- ``slo``     — gate verdicts computed from exported telemetry only
                (Prometheus scrape, mon health, admin-socket dumps)
- ``ramp``    — saturation search -> ``LOAD_torch_r*.json`` artifact
- ``soak``    — sustained traffic x seeded chaos fault schedules,
                judged by durability + frontier invariants

The CLI over them is ``python -m ceph_tpu_torch.tools.load``.
Submodules are imported directly (``from ceph_tpu_torch.load import
driver``); this package init stays import-free because chaos/scenario
imports ``load.dist`` — pulling driver/soak here would cycle back into
chaos.
"""

__all__ = ["dist", "driver", "slo", "ramp", "soak"]
