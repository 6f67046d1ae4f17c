"""The chaos-counter fixture of the port's test modules that run
scenarios: a module imports ``_port_chaos_reset`` and pytest applies it
to every case there."""

import pytest


@pytest.fixture(autouse=True)
def _port_chaos_reset():
    """The port's ``CHAOS`` counters are one process-wide registry: a
    scenario leaves its fault counts behind, and a later module on the
    same worker (``tests/test_torch_utils.py``) holds the counters,
    from zero, to the reference's."""
    from ceph_tpu_torch.chaos.counters import CHAOS

    CHAOS.reset()
    yield
    CHAOS.reset()
