"""graft-load: deterministic traffic driver + SLO judge.

Counterpart of ``ceph_tpu/load/``:

- ``dist``    — THE seeded samplers (zipfian popularity, arrival
                processes, weighted verb mixes), shared with chaos
- ``driver``  — ``LoadSpec`` + open-loop driver: simulated clients
                multiplexed over a bounded objecter session pool
- ``slo``     — gate verdicts computed from exported telemetry only
                (Prometheus scrape, mon health, admin-socket dumps)

The reference's saturation search (``ramp``) and soak runner (``soak``)
come later.  Submodules are imported directly (``from
ceph_tpu_torch.load import driver``); this package init stays
import-free because chaos/scenario imports ``load.dist`` — pulling
driver here would cycle back into chaos.
"""

__all__ = ["dist", "driver", "slo"]
