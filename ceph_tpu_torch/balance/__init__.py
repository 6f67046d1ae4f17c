"""Upmap balancing: the batched candidate scorer.

Counterpart of ``ceph_tpu/balance/``.  Only the scorer is ported so far;
the mgr-hosted loops (``balancer``, ``autoscaler``, ``reshape``) come with
the port's mgr.
"""

from ceph_tpu_torch.balance.scorer import (  # noqa: F401
    calc_pg_upmaps_vectorized,
    deviation_stats,
    generate_candidates,
    score_candidates,
)
