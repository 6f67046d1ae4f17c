"""The thread-count fixture of the port's test modules: a module imports
``_one_torch_thread`` and pytest applies it to every case there."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch on the CPU while a module's cases
    run.  The suite runs one worker a core, and torch's default pool (a
    thread a core, spinning between parallel regions) then oversubscribes
    the host: a mapper case that takes 13 s alone did not finish in 180 s
    beside six busy cores, and 32 s with one thread."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
