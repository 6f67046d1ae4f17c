"""Whole-object EC reads with one OSD of the acting set down.

Traffic: a closed loop of ``in_flight`` reads of ``op_bytes`` each (one
``rados bench seq`` client) over a working set of ``objects`` objects.
The working set is drawn on the card from the seed and written at rest in
set-up by the pool's own write tick (shards as bytes, or as planes where
``planar_at_rest_ok`` says so).  Each read misses the shard of the down
OSD: its position runs through a seeded permutation of all k+m positions,
block after block, so every seed reads the same mix of decodes
(k of every k+m reads rebuild a data shard) in another order.  A unit of
the window is one tick: the reads in flight decoded together by
``decode_stripes_multi`` (or ``decode_planes_multi`` for planes), as the
OSD's read batcher runs them.  A read completes when its bytes are on the
host.

The check draws ``check_reads`` reads of the window from the seed and
holds every byte each returned to the object the benchmark made.

The control (``control=True``) is the reference in the place of both
ticks with the guarantee that the configuration's
``controls["ec_degraded_read"]`` names broken (``CONTROLS``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers import common
from portbench.reference.ec import Code


def shards_not_interleaved(config):
    """The shards and the rebuild are the reference's; the object's bytes
    come back as its k data shards one after another, without the
    interleave of the stripes that the stripe unit states (it skips the
    read's costliest host pass).  A rebuild by byte arithmetic would not
    do as a control here: with one shard lost, the first parity row, all
    ones, rebuilds it, and XOR is the same in either arithmetic.
    Returns (the write tick that stores the working set, the read tick)."""
    code = Code(config["profile"])

    def store(_codec, sinfo, datas, _want):
        return [(code.shards(d, sinfo.chunk_size), None) for d in datas]

    def entry(_codec, _sinfo, reqs):
        out = []
        for shards, size in reqs:
            rows = {s: np.asarray(v, dtype=np.uint8)
                    for s, v in shards.items()}
            lost = [s for s in range(code.k) if s not in rows]
            if lost:
                rows.update(code.decode(rows, lost))
            data = np.concatenate([rows[s] for s in range(code.k)])
            out.append(data[:size].tobytes())
        return out

    return store, entry


CONTROLS = {"shards_not_interleaved": shards_not_interleaved}


def _wrap_entries(patch, wrap):
    from ceph_tpu_torch.ec import stripe

    for name in ("decode_planes_multi", "decode_stripes_multi"):
        patch(stripe, name, wrap(getattr(stripe, name)))


def answer_altered(patch):
    """The last byte of each read flipped where the tick makes it."""
    def wrap(real):
        def entry(codec, sinfo, reqs):
            return [common.altered(np.frombuffer(d, dtype=np.uint8))
                    .tobytes() for d in real(codec, sinfo, reqs)]
        return entry
    _wrap_entries(patch, wrap)


def half_batch(patch):
    """The tick decodes the first half of its reads and gives zeros for
    the rest."""
    def wrap(real):
        def entry(codec, sinfo, reqs):
            h = max(1, len(reqs) // 2)
            return real(codec, sinfo, reqs[:h]) + \
                [bytes(size) for _s, size in reqs[h:]]
        return entry
    _wrap_entries(patch, wrap)


# the faults this cell can have, each planted in the program; one card,
# so no exchange between chips to leave out
FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch}


class Driver:
    def __init__(self, config, traffic, seed, device, control=False):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.control = control
        self.in_flight = int(traffic["in_flight"])
        self.op_bytes = int(traffic["op_bytes"])
        self.n_objects = int(traffic["objects"])
        self.op_ms = []
        self.ops = 0
        self.bytes_read = 0
        self.profiling = False
        self.profile_work = {}

    def setup(self) -> None:
        from ceph_tpu_torch.ec import factory, stripe

        self.codec = factory(dict(self.config["profile"]), device=self.device)
        unit = self.codec.stripe_unit(int(self.config["stripe_unit"]))
        self.sinfo = stripe.StripeInfo(self.codec.get_data_chunk_count(),
                                       unit)
        self.planar = stripe.planar_at_rest_ok(self.codec, unit)
        if self.control:
            self.store_entry, self.entry = CONTROLS[
                self.config["controls"]["ec_degraded_read"]](self.config)
        elif self.planar:
            self.store_entry = stripe.encode_planes_multi
            self.entry = stripe.decode_planes_multi
        else:
            self.store_entry = stripe.encode_stripes_multi
            self.entry = stripe.decode_stripes_multi
        self.k = self.codec.get_data_chunk_count()
        self.n = self.codec.get_chunk_count()
        self.shard_len = self.sinfo.shard_size(self.op_bytes)
        s_payload, s_obj, s_down, s_sample = common.seeds(self.seed,
                                                          0, 1, 2, 3)
        self.objects = common.payloads(self.n_objects, self.op_bytes,
                                       s_payload, self.device)
        # the working set at rest, written tick by tick
        self.store = []
        for lo in range(0, self.n_objects, self.in_flight):
            datas = [self.objects[i].tobytes() for i in
                     range(lo, min(lo + self.in_flight, self.n_objects))]
            for shards, _crcs in self.store_entry(
                    self.codec, self.sinfo, datas, [True] * len(datas)):
                self.store.append(shards)
        self.obj_order = common.cycle(self.n_objects, s_obj)
        self.s_down = s_down
        self.down_block = []
        self.sample = common.Sample(int(self.traffic["check_reads"]),
                                    s_sample)
        self.next_read = 0
        for _ in range(int(self.traffic.get("warm_units", 2))):
            self._tick(record=False)
        self.next_read = 0
        self.down_block = []

    def _down(self, r: int) -> int:
        """The down OSD's position for read ``r``: blocks of a seeded
        permutation of every position."""
        if r % self.n == 0 or not self.down_block:
            self.down_block = common.cycle(self.n, self.s_down + r // self.n)
        return self.down_block[r % self.n]

    def _tick(self, record: bool = True) -> None:
        reqs, meta = [], []
        for _ in range(self.in_flight):
            r = self.next_read
            self.next_read += 1
            obj = self.obj_order[r % self.n_objects]
            down = self._down(r)
            at_rest = self.store[obj]
            reqs.append(({s: at_rest[s] for s in range(self.n) if s != down},
                         self.op_bytes))
            meta.append((obj, down))
        t0 = time.perf_counter()
        out = self.entry(self.codec, self.sinfo, reqs)
        ms = (time.perf_counter() - t0) * 1e3
        if not record:
            return
        for (obj, down), data in zip(meta, out):
            self.op_ms.append(ms)
            self.sample.offer((obj, down, data))
        self.ops += len(reqs)
        self.bytes_read += sum(len(d) for d in out)
        if self.profiling:
            w = self.profile_work
            w["ops"] = w.get("ops", 0) + len(reqs)
            # a decode reads k surviving shards and writes the one rebuilt
            dec = sum(1 for _o, down in meta if down < self.k)
            w["codec_bytes"] = w.get("codec_bytes", 0) + \
                dec * (self.k + 1) * self.shard_len

    def step(self) -> None:
        self._tick()

    def units_to_check(self) -> int:
        """Ticks that give the check its sample."""
        return -(-self.sample.k // self.in_flight)

    def stats(self) -> dict:
        return {"attempted": self.ops, "failed": 0,
                "client_bytes_read": self.bytes_read,
                "op_ms": list(self.op_ms)}

    def release(self) -> None:
        self.codec = None
        self.store = None
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> dict:
        wrong = 0
        for obj, _down, data in self.sample.items:
            got = np.frombuffer(data or b"", dtype=np.uint8)
            wrong += common.bytes_wrong(got, self.objects[obj])
        missing = self.sample.k - len(self.sample.items)
        return {"read_bytes_wrong": (wrong, 0),
                "reads_unchecked": (missing, 0)}
