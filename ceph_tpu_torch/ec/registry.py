"""Erasure-code plugin registry.

Counterpart of ``ceph_tpu/ec/registry.py``, mirroring reference
src/erasure-code/ErasureCodePlugin.cc:92-202: a singleton registry
mapping plugin names to factories.  The port registers the four plugins
of the reference: ``jerasure`` (the default plugin, as in the reference),
``isa``, ``lrc`` and ``shec``; every factory takes the ``device`` its codec
(and an LRC codec's layers) runs on.
"""

from __future__ import annotations

import errno
import threading
from typing import Callable, Dict

from ceph_tpu_torch.ec.codec import resolve_device
from ceph_tpu_torch.ec.interface import ECError, ErasureCodeInterface, ErasureCodeProfile


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
        from ceph_tpu_torch.ec.lrc import make_lrc
        from ceph_tpu_torch.ec.shec import make_shec

        self.add("isa", make_isa)
        self.add("jerasure", make_jerasure)
        self.add("lrc", make_lrc)
        self.add("shec", make_shec)

    def add(self, name: str, factory) -> None:
        with self._lock:
            self._factories[name] = factory

    def remove(self, name: str) -> None:
        with self._lock:
            self._factories.pop(name, None)

    def load(self, name: str):
        with self._lock:
            if name in self._factories:
                return self._factories[name]
        raise ECError(errno.ENOENT, f"no erasure-code plugin {name!r}")

    def factory(self, plugin: str, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        make = self.load(plugin)
        return make(dict(profile), device=device)

    def preload(self, plugins) -> None:
        """Load each named plugin now, raising ECError(ENOENT) for the
        first that is not registered (reference ErasureCodePlugin.cc
        preload)."""
        for name in plugins:
            self.load(name)


def factory(profile: ErasureCodeProfile, device=None) -> ErasureCodeInterface:
    """Instantiate a codec from a profile's ``plugin`` key (default
    jerasure, as in the reference) on ``device``: CUDA when None, and an
    error when CUDA is absent; only an explicit ``device="cpu"`` runs on
    the CPU."""
    profile = dict(profile)
    plugin = profile.get("plugin", "jerasure")
    dev = resolve_device(device)
    return ErasureCodePluginRegistry.instance().factory(plugin, profile, dev)
