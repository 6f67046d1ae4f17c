"""graft-balance: the elastic-cluster policy subsystem.

Counterpart of ``ceph_tpu/balance/``: three cooperating mgr-hosted loops
over the batched CRUSH substrate:

- ``scorer`` / ``balancer``: device-batched upmap optimization — generate
  thousands of candidate ``pg_upmap_items`` edits per round, score them
  all with one vectorized objective (per-OSD fill variance + primary
  balance + projected-move bytes), and commit the best safe move-set to
  the mon as a normal Incremental.  The greedy scalar
  ``osdmap/balancer.py::calc_pg_upmaps`` stays behind
  ``mgr_balancer_vectorized=0`` as the bisection anchor.
- ``autoscaler``: per-pool pg_num targets from observed object load vs
  in-OSD count, driving staged pg_num growth through the mon.
- ``reshape``: ``grow`` (add hosts/OSDs via ``osd grow``) and ``drain``
  (weight->0, wait-clean, purge) as first-class resumable operations
  whose phases are derived from observed map state, never from
  in-memory progress alone.
"""

from ceph_tpu_torch.balance.scorer import (  # noqa: F401
    calc_pg_upmaps_vectorized,
    deviation_stats,
    generate_candidates,
    score_candidates,
)
from ceph_tpu_torch.balance.balancer import UpmapBalancer  # noqa: F401
from ceph_tpu_torch.balance.autoscaler import PgAutoscaler  # noqa: F401
from ceph_tpu_torch.balance.reshape import Reshaper, ReshapeOp  # noqa: F401
