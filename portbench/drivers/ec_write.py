"""Full-object EC writes through the OSD's coalesced tick.

Traffic: a closed loop of ``in_flight`` writes of ``op_bytes`` each (one
``rados bench write`` client), cycling over ``objects`` distinct payloads
drawn on the card from the seed.  A unit of the window is one tick: the
ops in flight encoded together by the entry the OSD's batcher picks for
the pool (``cluster/batcher.py``): ``encode_planes_multi`` where
``planar_at_rest_ok`` says the shards live as planes, else
``encode_stripes_multi``, with the shard crcs (``want_crcs``) of a full
write.  An op completes when its shards and crcs are on the host.

The check draws ``check_ops`` ops of the window from the seed and holds
every one of their k+m shards (as bytes, or as the at-rest planes) and
every shard crc to the plain reference.

The control (``control=True``) is the reference in the tick's place with
the guarantee that the configuration's ``controls["ec_write"]`` names
broken (``CONTROLS``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers import common
from portbench.reference import crc32c, gf256, planar
from portbench.reference.ec import Code


def crc_over_planes(config):
    """Each shard's crc32c taken over the planes it is stored as, not over
    the shard's bytes: it skips the host spread of the planes, the planar
    write's costliest step."""
    code = Code(config["profile"])

    def entry(_codec, sinfo, datas, want_crcs):
        out = []
        for d, want in zip(datas, want_crcs):
            planes = planar.rows_to_planes(code.shards(d, sinfo.chunk_size))
            crcs = crc32c.crc32c_rows(planes.reshape(code.n, -1))
            out.append((planes, [int(c) for c in crcs] if want else None))
        return out

    return entry


def byte_parity(config):
    """Parity by the code's matrix applied byte by byte (the byte
    arithmetic of kernel B1), not as the bit-matrix code over packets
    that a cauchy profile states."""
    code = Code(config["profile"])

    def entry(_codec, sinfo, datas, want_crcs):
        out = []
        for d, want in zip(datas, want_crcs):
            data = code.shards(d, sinfo.chunk_size)[: code.k]
            rows = np.concatenate([data, gf256.mul_rows(code.coding, data)])
            crcs = crc32c.crc32c_rows(rows)
            out.append((rows, [int(c) for c in crcs] if want else None))
        return out

    return entry


CONTROLS = {"crc_over_planes": crc_over_planes, "byte_parity": byte_parity}


def _wrap_entries(patch, wrap):
    from ceph_tpu_torch.ec import stripe

    for name in ("encode_planes_multi", "encode_stripes_multi"):
        patch(stripe, name, wrap(getattr(stripe, name)))


def answer_altered(patch):
    """The last byte of each op's shards flipped where the tick makes
    them."""
    def wrap(real):
        def entry(codec, sinfo, datas, want):
            return [(common.altered(s), c)
                    for s, c in real(codec, sinfo, datas, want)]
        return entry
    _wrap_entries(patch, wrap)


def half_batch(patch):
    """The tick encodes the first half of its ops and hands their results
    out again for the rest."""
    def wrap(real):
        def entry(codec, sinfo, datas, want):
            h = max(1, len(datas) // 2)
            done = real(codec, sinfo, datas[:h], want[:h])
            return [done[i % h] for i in range(len(datas))]
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
        self.want_crcs = bool(traffic.get("want_crcs", True))
        self.op_ms = []
        self.ops = 0
        self.profiling = False
        self.profile_work = {}

    def setup(self) -> None:
        from ceph_tpu_torch.ec import factory, stripe

        self.codec = factory(dict(self.config["profile"]), device=self.device)
        # the stripe unit as the monitor composes it for a new pool
        unit = self.codec.stripe_unit(int(self.config["stripe_unit"]))
        self.sinfo = stripe.StripeInfo(self.codec.get_data_chunk_count(),
                                       unit)
        self.planar = stripe.planar_at_rest_ok(self.codec, unit)
        if self.control:
            self.entry = CONTROLS[self.config["controls"]["ec_write"]](
                self.config)
        else:
            self.entry = stripe.encode_planes_multi if self.planar \
                else stripe.encode_stripes_multi
        s_payload, s_order, s_sample = common.seeds(self.seed, 0, 1, 2)
        rows = common.payloads(self.n_objects, self.op_bytes, s_payload,
                               self.device)
        # client data arrives as bytes, as the OSD hands it to the tick
        self.objects = [rows[i].tobytes() for i in range(self.n_objects)]
        del rows
        self.order = common.cycle(self.n_objects, s_order)
        self.sample = common.Sample(int(self.traffic["check_ops"]), s_sample)
        self.k = self.codec.get_data_chunk_count()
        self.n = self.codec.get_chunk_count()
        self.shard_len = self.sinfo.shard_size(self.op_bytes)
        for _ in range(int(self.traffic.get("warm_units", 2))):
            self._tick(record=False)

    def _tick(self, record: bool = True) -> None:
        idx = [self.order[(self.ops + j) % self.n_objects]
               for j in range(self.in_flight)]
        datas = [self.objects[i] for i in idx]
        t0 = time.perf_counter()
        out = self.entry(self.codec, self.sinfo, datas,
                         [self.want_crcs] * self.in_flight)
        ms = (time.perf_counter() - t0) * 1e3
        if not record:
            return
        for j, i in enumerate(idx):
            self.op_ms.append(ms)
            self.sample.offer((i, out[j]))
        self.ops += self.in_flight
        if self.profiling:
            w = self.profile_work
            w["ops"] = w.get("ops", 0) + self.in_flight
            # the code reads k shards and writes m, once each
            w["codec_bytes"] = w.get("codec_bytes", 0) + \
                self.in_flight * self.n * self.shard_len

    def step(self) -> None:
        self._tick()

    def units_to_check(self) -> int:
        """Ticks that give the check its sample."""
        return -(-self.sample.k // self.in_flight)

    def stats(self) -> dict:
        return {"attempted": self.ops, "failed": 0,
                "client_bytes_written": self.ops * self.op_bytes,
                "op_ms": list(self.op_ms)}

    def release(self) -> None:
        self.codec = None
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ref = Code(self.config["profile"])
        unit = self.sinfo.chunk_size
        wrong = crcs_wrong = 0
        for i, (shards, crcs) in self.sample.items:
            rows = ref.shards(self.objects[i], unit)
            want = planar.rows_to_planes(rows) if self.planar else rows
            wrong += common.bytes_wrong(shards, want)
            if self.want_crcs:
                want_crcs = [int(c) for c in crc32c.crc32c_rows(rows)]
                got = [int(c) for c in (crcs if crcs is not None else [])]
                crcs_wrong += sum(a != b for a, b in zip(got, want_crcs)) + \
                    abs(len(want_crcs) - len(got))
        missing = self.sample.k - len(self.sample.items)
        return {"shard_bytes_wrong": (wrong, 0),
                "shard_crcs_wrong": (crcs_wrong, 0),
                "ops_unchecked": (missing, 0)}
