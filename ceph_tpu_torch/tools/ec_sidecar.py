#!/usr/bin/env python
"""EC sidecar: the process C++ erasure-code plugins delegate to.

Counterpart of ``native/ec_sidecar/tpu_sidecar.py`` on the port's codecs:
a unix-socket server speaking a tiny length-prefixed binary protocol;
``native/ec_sidecar/libec_jax.cc`` (the native plugin shim built against
the reference's dlopen ABI, socket path from ``EC_JAX_SIDECAR``)
connects here, and every encode/decode lands on the port's batch
engines, ``ceph_tpu_torch.ec.factory(profile, device=...)``: CUDA unless
the caller names another device.

Coalescing: requests arriving within a small window are merged into ONE
device dispatch per (profile, op, erasures, chunk-size) group, then the
results fan back out per request.  Each group's result is copied to the
host once, after the codec call, and the replies are cut from that copy.

Protocol (little-endian):
  request:  u32 len | u8 op (1=encode 2=decode 3=ping) | u16 profile_len
            | profile json | u8 k | u8 m | u8 n_erasures | u8[] erasures
            | u32 chunk_size | chunk payloads (k for encode, k+m with
            erased zeroed for decode)
  reply:    u32 len | u8 status | payload (m parity chunks for encode,
            len(erasures) chunks for decode)

    python -m ceph_tpu_torch.tools.ec_sidecar /path/to/ec.sock [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import struct
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ceph_tpu_torch.utils.device import resolve_device_index


class Sidecar:
    def __init__(self, coalesce_window: float = 0.002, device=None):
        self._codecs: Dict[str, object] = {}
        self.window = coalesce_window
        self.device = resolve_device_index(device)
        self._queues: Dict[Tuple, List] = defaultdict(list)
        self._flushers: Dict[Tuple, asyncio.Task] = {}
        self.batches = 0
        self.requests = 0

    def codec(self, profile_json: str):
        c = self._codecs.get(profile_json)
        if c is None:
            from ceph_tpu_torch.ec import factory

            c = factory(json.loads(profile_json), device=self.device)
            self._codecs[profile_json] = c
        return c

    async def handle(self, reader, writer):
        try:
            while True:
                hdr = await reader.readexactly(4)
                (n,) = struct.unpack("<I", hdr)
                payload = await reader.readexactly(n)
                resp = await self.dispatch(payload)
                writer.write(struct.pack("<I", len(resp)) + resp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def dispatch(self, payload: bytes) -> bytes:
        op = payload[0]
        if op == 3:
            return b"\x00pong"
        (plen,) = struct.unpack_from("<H", payload, 1)
        off = 3
        profile = payload[off:off + plen].decode()
        off += plen
        k, m, ne = payload[off], payload[off + 1], payload[off + 2]
        off += 3
        erasures = tuple(payload[off:off + ne])
        off += ne
        (chunk,) = struct.unpack_from("<I", payload, off)
        off += 4
        nchunks = k if op == 1 else k + m
        data = np.frombuffer(
            payload, dtype=np.uint8, count=nchunks * chunk, offset=off
        ).reshape(nchunks, chunk)
        self.requests += 1
        out = await self._submit(profile, op, erasures, data)
        return b"\x00" + out.tobytes()

    async def _submit(self, profile, op, erasures, data) -> np.ndarray:
        """Queue into the coalescing window; one device dispatch serves
        every request that arrived in it."""
        key = (profile, op, erasures, data.shape[1])
        fut = asyncio.get_event_loop().create_future()
        self._queues[key].append((data, fut))
        if key not in self._flushers or self._flushers[key].done():
            self._flushers[key] = asyncio.get_event_loop().create_task(
                self._flush(key))
        return await fut

    async def _flush(self, key) -> None:
        await asyncio.sleep(self.window)
        batch = self._queues.pop(key, [])
        if not batch:
            return
        profile, op, erasures, _ = key
        stack = np.stack([d for d, _ in batch])      # (B, nchunks, S)
        self.batches += 1
        try:
            codec = self.codec(profile)
            if op == 1:
                out = codec.encode_batch(stack)
            else:
                out = codec.decode_batch(erasures, stack)
            out = out.cpu().numpy()        # the group's one copy to the host
            for i, (_, fut) in enumerate(batch):
                if not fut.done():
                    fut.set_result(out[i])
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


async def serve(path: str, device=None) -> None:
    sidecar = Sidecar(device=device)
    server = await asyncio.start_unix_server(sidecar.handle, path=path)
    print(f"sidecar listening on {path} ({sidecar.device})", flush=True)
    async with server:
        await server.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ec_sidecar")
    ap.add_argument("sock", nargs="?", default="ec_jax.sock",
                    help="unix socket path (the shim's EC_JAX_SIDECAR)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    asyncio.run(serve(args.sock, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
