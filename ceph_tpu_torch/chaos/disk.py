"""Disk injector: store-level fault interposition.

Counterpart of ``ceph_tpu/chaos/disk.py``.

The analog of the reference's ``filestore_debug_inject_read_err`` /
``bluestore_debug_inject_bitrot`` debug options: a store whose owning
daemon carries nonzero ``chaos_disk_*`` rates gets a ``DiskInjector``
on ``store.chaos`` that can

- fail reads with EIO (``chaos_disk_read_err``),
- fail whole transactions with ENOSPC BEFORE any byte lands
  (``chaos_disk_enospc`` — transactions stay atomic: refused, never
  half-applied),
- silently flip stored bits (explicit ``flip_bit`` for targeted
  scrub/repair tests, plus a ``chaos_disk_bitrot`` rate that rots a
  freshly-written object — checksums are NOT updated, so the corruption
  is silent until a csum-verified read or a deep scrub meets it).

Torn/lost writes live on the stores themselves (``FileStore.crash`` /
``BlueStore.crash``): a crash-stop closes the store without the clean
checkpoint and can tear the journal tail mid-frame or discard committed
tail frames, so the next mount exercises the torn-tail replay paths for
real.

Disabled proof: ``store.chaos is None`` with all rates zero — the store
hot paths pay one ``is None`` test.
"""

from __future__ import annotations

from typing import Optional

CONFIG_FIELDS = ("chaos_disk_read_err", "chaos_disk_enospc",
                 "chaos_disk_bitrot")


class DiskInjector:
    def __init__(self, rng, read_err: float = 0.0, enospc: float = 0.0,
                 bitrot: float = 0.0):
        self.rng = rng
        self.read_err = read_err
        self.enospc = enospc
        self.bitrot = bitrot

    @classmethod
    def from_config(cls, config, name: str) -> Optional["DiskInjector"]:
        """``None`` when every rate is zero (the provable-no-op state)."""
        from ceph_tpu_torch.chaos.rng import stream

        if not (config.chaos_disk_read_err or config.chaos_disk_enospc
                or config.chaos_disk_bitrot):
            return None
        return cls(stream(config.chaos_seed, f"disk:{name}"),
                   read_err=config.chaos_disk_read_err,
                   enospc=config.chaos_disk_enospc,
                   bitrot=config.chaos_disk_bitrot)

    # -- store hooks --------------------------------------------------------

    def on_read(self, coll: str, oid: str) -> None:
        """Called at the top of ObjectStore.read: injected media EIO."""
        if self.read_err and self.rng.random() < self.read_err:
            from ceph_tpu_torch.chaos.counters import CHAOS

            CHAOS.inc("disk_read_errors")
            raise IOError(5, f"chaos: injected EIO reading {coll}/{oid}")

    def on_write(self, txn) -> None:
        """Called before a transaction touches journal or state: the
        whole txn is refused (atomicity preserved) with ENOSPC."""
        if self.enospc and self.rng.random() < self.enospc:
            from ceph_tpu_torch.chaos.counters import CHAOS

            CHAOS.inc("disk_write_errors")
            raise OSError(28, "chaos: injected ENOSPC")

    def maybe_rot(self, store, txn) -> None:
        """Rate-driven silent rot: after a transaction commits, flip one
        bit of one object the txn wrote (scrub must find + repair it)."""
        if not self.bitrot or self.rng.random() >= self.bitrot:
            return
        writes = [(op[1], op[2]) for op in txn.ops if op[0] == "write"]
        if not writes:
            return
        coll, oid = writes[self.rng.randrange(len(writes))]
        try:
            self.flip_bit(store, coll, oid)
        except (FileNotFoundError, ValueError):
            pass

    def flip_bit(self, store, coll: str, oid: str,
                 bit: Optional[int] = None) -> int:
        """Flip one stored bit of ``coll/oid`` in ``store`` WITHOUT
        updating any checksum — deterministic from this injector's rng
        stream when ``bit`` is None.  Returns the flipped bit index."""
        from ceph_tpu_torch.chaos.counters import CHAOS

        size = store.stat(coll, oid)
        if not size:
            raise FileNotFoundError(f"{coll}/{oid} empty or missing")
        if bit is None:
            bit = self.rng.randrange(size * 8)
        store.debug_bitrot(coll, oid, bit)
        CHAOS.inc("disk_bitrot_flips")
        return bit
