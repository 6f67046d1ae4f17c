"""MonClient targeting: monmap normalization + hunting failover.

Counterpart of ``ceph_tpu/cluster/monclient.py``.

The single implementation of the reference MonClient's session-hunting
behavior (src/mon/MonClient.cc _reopen_session: try the next monitor when
the current one stops answering), shared by the OSD daemon and the
client-side Objecter so their failover semantics cannot drift: on every
hunt the new monitor immediately receives a map subscription, keeping the
caller in its subscriber set.

Hunting backs off (reference mon_client_hunt_interval_backoff): each
failed target costs a capped-exponential jittered delay before the next
is tried, instead of the old immediate hammering — under a partition a
daemon's monclient no longer busy-spins the whole monmap.  The jitter
rng is injectable (chaos scenarios seed it) and the backoff resets on
any successful send.
"""

from __future__ import annotations

import asyncio
from typing import Callable, List, Optional, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.utils.backoff import ExpBackoff

Addr = Tuple[str, int]


class MonTargeter:
    def __init__(self, messenger, mon_addr,
                 subscribe_since: Optional[Callable[[], int]] = None,
                 rng=None):
        """``mon_addr``: one (host, port) or a list of them (the monmap).
        ``subscribe_since``: epoch callback used to re-subscribe on the
        newly-hunted monitor (None disables re-subscription).  ``rng``:
        seeded jitter source for the hunt backoff (None = fresh
        entropy)."""
        self.messenger = messenger
        if mon_addr and isinstance(mon_addr[0], (list, tuple)):
            self.addrs: List[Addr] = [tuple(a) for a in mon_addr]
        else:
            self.addrs = [tuple(mon_addr)]
        self._i = 0
        self.subscribe_since = subscribe_since
        self.backoff = ExpBackoff(base=0.05, cap=1.0, rng=rng)

    @property
    def current(self) -> Addr:
        return self.addrs[self._i]

    def hunt(self) -> None:
        self._i = (self._i + 1) % len(self.addrs)

    async def send(self, msg, raise_on_fail: bool = False) -> bool:
        """Send to the current monitor, hunting across the monmap on
        connection failure."""
        last: Optional[Exception] = None
        # RuntimeError included: asyncio raises it for writes on a
        # closing transport and the messenger re-raises it
        errs = (ConnectionError, OSError, RuntimeError)
        for attempt in range(len(self.addrs)):
            try:
                await self.messenger.send_message(msg, self.current)
                self.backoff.reset()
                return True
            except errs as e:
                last = e
                self.hunt()
                if attempt == len(self.addrs) - 1:
                    break  # out of targets: fail now, not a sleep later
                # backoff BEFORE trying the next target: a dead monmap
                # must not be hammered at loop speed
                await asyncio.sleep(self.backoff.next())
                if len(self.addrs) > 1 and \
                        self.subscribe_since is not None:
                    try:
                        await self.messenger.send_message(
                            M.MMonSubscribe(
                                what="osdmap",
                                addr=self.messenger.my_addr,
                                since=self.subscribe_since()),
                            self.current)
                    except errs:
                        continue
        if raise_on_fail:
            raise last or ConnectionError("no monitor reachable")
        return False
