"""Net injector: messenger-level fault interposition.

Counterpart of ``ceph_tpu/chaos/net.py``.

The analog of the reference's ``ms_inject_socket_failures`` /
``ms_inject_delay_*`` debug options (src/msg/Messenger.h): a messenger
whose config carries nonzero ``chaos_net_*`` rates owns a ``NetInjector``
that decides, per outgoing session frame, whether to drop, duplicate,
delay, reorder, or follow up with a session reset — plus an asymmetric
partition set that makes chosen peers unreachable from THIS endpoint
only (``A -> B`` blocked while ``B -> A`` flows, the classic one-way
link failure).

Semantics ride the messenger's own reliability machinery rather than
bypassing it: a dropped frame stays in the session's unacked replay
buffer, so it is re-delivered when a later failure forces a
reconnect+replay — exactly a lost packet under retransmission.  A
partitioned connect raises ``ConnectionError`` like a refused TCP
connection, which drives monclient hunting, heartbeat failure reports,
and session replay in the real code paths.

Disabled proof: a messenger with all rates zero and no partitions has
``messenger.chaos is None`` — the hot send path pays one ``is None``
test and nothing else.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Set, Tuple

Addr = Tuple[str, int]

# the config options this injector is built from (messenger observers
# rebuild on any of these)
CONFIG_FIELDS = (
    "chaos_net_drop", "chaos_net_dup", "chaos_net_delay",
    "chaos_net_delay_prob", "chaos_net_reorder", "chaos_net_reset",
    "chaos_net_partition", "chaos_net_batch_item_drop",
    "chaos_net_batch_ack_dup", "chaos_net_batch_ack_reorder",
)

# message type names the batch mutator understands (duck-typed so the
# chaos layer never imports cluster wire classes)
_BATCH_FRAME = "MOSDECSubOpWriteBatch"
_BATCH_REPLY = "MOSDECSubOpWriteBatchReply"


@dataclass
class FrameFate:
    """Per-frame decision vector (computed once, before the wire)."""

    drop: bool = False
    retransmit: float = 0.0  # drop only: session replay fires after this
    dup: bool = False
    delay: float = 0.0
    reorder: float = 0.0     # >0: defer the frame by this many seconds
    reset: bool = False


def parse_partitions(spec: str) -> Set[Addr]:
    """``"host:port,host:port"`` -> addr set (the injectargs encoding of
    a partition; scenarios resolve daemon names to addrs first)."""
    out: Set[Addr] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.add((host, int(port)))
    return out


class NetInjector:
    def __init__(self, rng, drop: float = 0.0, dup: float = 0.0,
                 delay: float = 0.0, delay_prob: float = 0.0,
                 reorder: float = 0.0, reset: float = 0.0,
                 partitions: Optional[Set[Addr]] = None,
                 batch_item_drop: float = 0.0,
                 batch_ack_dup: float = 0.0,
                 batch_ack_reorder: float = 0.0):
        self.rng = rng
        self.drop = drop
        self.dup = dup
        self.delay = delay
        self.delay_prob = delay_prob
        self.reorder = reorder
        self.reset = reset
        self.partitions: Set[Addr] = set(partitions or ())
        # batch-frame faults (round 12): per-item loss INSIDE a
        # coalesced tick frame, duplicated/shuffled batched acks
        self.batch_item_drop = batch_item_drop
        self.batch_ack_dup = batch_ack_dup
        self.batch_ack_reorder = batch_ack_reorder

    @classmethod
    def from_config(cls, config, name: str,
                    keep_partitions: Optional[Set[Addr]] = None
                    ) -> Optional["NetInjector"]:
        """Build from a daemon's chaos_net_* options; ``None`` when every
        rate is zero and no partition is configured (the provable-no-op
        state).  ``keep_partitions`` preserves programmatically-added
        partitions across an injectargs-triggered rebuild."""
        from ceph_tpu_torch.chaos.rng import stream

        parts = parse_partitions(config.chaos_net_partition)
        if keep_partitions:
            parts |= keep_partitions
        rates = (config.chaos_net_drop, config.chaos_net_dup,
                 config.chaos_net_delay_prob, config.chaos_net_reorder,
                 config.chaos_net_reset,
                 config.chaos_net_batch_item_drop,
                 config.chaos_net_batch_ack_dup,
                 config.chaos_net_batch_ack_reorder)
        if not any(rates) and not parts:
            return None
        return cls(stream(config.chaos_seed, f"net:{name}"),
                   drop=config.chaos_net_drop, dup=config.chaos_net_dup,
                   delay=config.chaos_net_delay,
                   delay_prob=config.chaos_net_delay_prob,
                   reorder=config.chaos_net_reorder,
                   reset=config.chaos_net_reset, partitions=parts,
                   batch_item_drop=config.chaos_net_batch_item_drop,
                   batch_ack_dup=config.chaos_net_batch_ack_dup,
                   batch_ack_reorder=config.chaos_net_batch_ack_reorder)

    # -- partition management (scenario runner API) -------------------------

    def partition(self, *addrs: Addr) -> None:
        self.partitions.update(tuple(a) for a in addrs)

    def heal(self, *addrs: Addr) -> None:
        """Heal specific peers, or everything when called bare."""
        if addrs:
            self.partitions.difference_update(tuple(a) for a in addrs)
        else:
            self.partitions.clear()

    def partitioned(self, addr: Addr) -> bool:
        return tuple(addr) in self.partitions

    # -- messenger hooks ----------------------------------------------------

    def check_connect(self, addr: Addr) -> None:
        """Raises like a refused/blackholed TCP connect when the peer is
        behind a partition (called from Messenger.connect)."""
        if self.partitions and tuple(addr) in self.partitions:
            from ceph_tpu_torch.chaos.counters import CHAOS

            CHAOS.inc("net_partition_blocks")
            raise ConnectionError(f"chaos: partition blocks {addr}")

    def on_frame(self, addr: Addr) -> FrameFate:
        """Decide this frame's fate; counters tick at decision time.
        Each enabled fault family consumes its own rng draws, so
        disabling one family never shifts another's stream."""
        from ceph_tpu_torch.chaos.counters import CHAOS

        fate = FrameFate()
        rng = self.rng
        if self.drop and rng.random() < self.drop:
            fate.drop = True
            # the retransmission timer: the messenger schedules a
            # session replay after this, so loss is transient on a
            # healthy net and real under a partition
            fate.retransmit = rng.uniform(0.02, 0.2)
            CHAOS.inc("net_drops")
            return fate                  # a dropped frame has no other fate
        if self.delay_prob and rng.random() < self.delay_prob:
            fate.delay = rng.uniform(0.0, self.delay or 0.05)
            CHAOS.inc("net_delays")
        if self.reorder and rng.random() < self.reorder:
            fate.reorder = rng.uniform(0.005, max(0.01, self.delay or 0.05))
            CHAOS.inc("net_reorders")
            return fate                  # deferred: dup/reset don't stack
        if self.dup and rng.random() < self.dup:
            fate.dup = True
            CHAOS.inc("net_dups")
        if self.reset and rng.random() < self.reset:
            fate.reset = True
            CHAOS.inc("net_resets")
        return fate

    def mutate_batch(self, msg) -> None:
        """Per-item batch-frame faults (round 12), applied IN PLACE just
        before the frame is pickled for the wire — so session replay
        re-delivers the same mutated frame (the item loss is real, like
        a torn frame the transport reassembled short):

        - ``batch_item_drop``: each sub-write item inside a multi-item
          MOSDECSubOpWriteBatch is independently dropped while the rest
          of the frame delivers — a PARTIAL tick on the wire.  At least
          one item always survives (whole-frame loss is chaos_net_drop's
          job, with retransmission semantics).
        - ``batch_ack_dup``: entries of a batched ack are duplicated —
          the per-responder ack dedup must absorb them or a duplicate
          would stand in for a shard that never committed.
        - ``batch_ack_reorder``: the batched ack's result order is
          shuffled — ack handling must be order-independent.

        Each family consumes its own rng draws only when enabled, so
        toggling one never shifts another's stream."""
        from ceph_tpu_torch.chaos.counters import CHAOS

        name = type(msg).__name__
        rng = self.rng
        if name == _BATCH_FRAME and self.batch_item_drop and \
                len(msg.items) > 1:
            kept = [it for it in msg.items
                    if rng.random() >= self.batch_item_drop]
            if not kept:
                kept = [msg.items[rng.randrange(len(msg.items))]]
            dropped = len(msg.items) - len(kept)
            if dropped:
                CHAOS.inc("net_batch_item_drops", dropped)
                msg.items = kept
        elif name == _BATCH_REPLY and msg.results:
            if self.batch_ack_dup:
                out = []
                dups = 0
                for entry in msg.results:
                    out.append(entry)
                    if rng.random() < self.batch_ack_dup:
                        out.append(entry)
                        dups += 1
                if dups:
                    CHAOS.inc("net_batch_ack_dups", dups)
                    msg.results = out
            if self.batch_ack_reorder and \
                    rng.random() < self.batch_ack_reorder and \
                    len(msg.results) > 1:
                shuffled = list(msg.results)
                rng.shuffle(shuffled)
                CHAOS.inc("net_batch_ack_reorders")
                msg.results = shuffled


def ensure_injector(messenger) -> NetInjector:
    """The scenario runner's handle on a daemon messenger: returns the
    live injector, creating an all-zero-rate one (for partition-only
    scenarios) when chaos is currently disabled."""
    if messenger.chaos is None:
        from ceph_tpu_torch.chaos.rng import stream

        seed = 0
        cfg = getattr(messenger, "config", None)
        if cfg is not None:
            seed = cfg.chaos_seed
        messenger.chaos = NetInjector(
            stream(seed, f"net:{messenger.name}"))
    return messenger.chaos
