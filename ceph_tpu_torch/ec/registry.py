"""Erasure-code plugin registry.

Counterpart of ``ceph_tpu/ec/registry.py``, mirroring reference
src/erasure-code/ErasureCodePlugin.cc:92-202: a singleton registry
mapping plugin names to factories.  The port registers ``isa`` and
``jerasure`` (the default plugin, as in the reference); asking for a
plugin that a later slice brings raises ``ECError(ENOENT)`` naming that
slice.
"""

from __future__ import annotations

import errno
import threading
from typing import Callable, Dict

from ceph_tpu_torch.ec.codec import resolve_device
from ceph_tpu_torch.ec.interface import ECError, ErasureCodeInterface, ErasureCodeProfile

# plugins of the reference package that later slices of the port bring
_LATER = {
    "lrc": "the LRC slice",
    "shec": "the SHEC slice",
}


class ErasureCodePluginRegistry:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._factories: Dict[str, Callable[..., ErasureCodeInterface]] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
                cls._instance._register_builtins()
        return cls._instance

    def _register_builtins(self) -> None:
        from ceph_tpu_torch.ec.isa import make_isa
        from ceph_tpu_torch.ec.jerasure import make_jerasure

        self.add("isa", make_isa)
        self.add("jerasure", make_jerasure)

    def add(self, name: str, factory) -> None:
        with self._lock:
            self._factories[name] = factory

    def load(self, name: str):
        with self._lock:
            if name in self._factories:
                return self._factories[name]
        if name in _LATER:
            raise ECError(errno.ENOENT,
                          f"plugin {name!r} is not ported yet: it arrives "
                          f"with {_LATER[name]}")
        raise ECError(errno.ENOENT, f"no erasure-code plugin {name!r}")

    def factory(self, plugin: str, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        make = self.load(plugin)
        return make(dict(profile), device=device)


def factory(profile: ErasureCodeProfile, device=None) -> ErasureCodeInterface:
    """Instantiate a codec from a profile's ``plugin`` key (default
    jerasure, as in the reference) on ``device``: CUDA when None, and an
    error when CUDA is absent; only an explicit ``device="cpu"`` runs on
    the CPU."""
    profile = dict(profile)
    plugin = profile.get("plugin", "jerasure")
    dev = resolve_device(device)
    return ErasureCodePluginRegistry.instance().factory(plugin, profile, dev)
