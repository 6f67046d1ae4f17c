"""The port's EC sidecar (``ceph_tpu_torch/tools/ec_sidecar.py``) against
``native/ec_sidecar/tpu_sidecar.py``, on the cases of
``tests/test_native_sidecar.py``.

The C++ plugin shim and its driver are built from ``native/ec_sidecar/``
with ``g++`` and run against the port's sidecar on ``device="cpu"``: the
round trip must print ``"native_seam": "ok"``.  Concurrent requests over
the documented protocol must coalesce (``batches < requests``), and every
reply must equal the reference sidecar's for the same request, for an
ISA profile and a cauchy_good one, encode and decode.  Skipped without a
C++ toolchain, as the original is.
"""

import asyncio
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu_torch.tools.ec_sidecar import Sidecar
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

SRC = os.path.join(os.path.dirname(__file__), "..", "native", "ec_sidecar")
ISA = {"plugin": "isa", "k": "8", "m": "4"}
CAUCHY = {"plugin": "jerasure", "technique": "cauchy_good", "k": "8",
          "m": "4", "packetsize": "64"}

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")


def _reference_sidecar():
    sys.path.insert(0, SRC)
    try:
        from tpu_sidecar import Sidecar as Ref
    finally:
        sys.path.pop(0)
    return Ref


def _build(tmp_path):
    so = tmp_path / "libec_jax.so"
    drv = tmp_path / "ec_jax_driver"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so),
                    os.path.join(SRC, "libec_jax.cc")], check=True)
    subprocess.run(["g++", "-O2", "-o", str(drv),
                    os.path.join(SRC, "driver.cc"), "-ldl"], check=True)
    return so, drv


def request(op, profile, k, m, chunk, data, erasures=()):
    """One request body of the documented protocol."""
    prof = json.dumps(profile)
    return (bytes([op]) + struct.pack("<H", len(prof)) + prof.encode()
            + bytes([k, m, len(erasures)]) + bytes(erasures)
            + struct.pack("<I", chunk) + data.tobytes())


async def send(sock, body):
    reader, writer = await asyncio.open_unix_connection(sock)
    writer.write(struct.pack("<I", len(body)) + body)
    await writer.drain()
    (n,) = struct.unpack("<I", await reader.readexactly(4))
    reply = await reader.readexactly(n)
    writer.close()
    return reply


@needs_gxx
def test_native_plugin_roundtrip(tmp_path):
    so, drv = _build(tmp_path)
    sock = str(tmp_path / "ec_jax.sock")

    async def scenario():
        sidecar = Sidecar(device="cpu")
        server = await asyncio.start_unix_server(sidecar.handle, path=sock)
        env = dict(os.environ, EC_JAX_SIDECAR=sock)
        proc = await asyncio.create_subprocess_exec(
            str(drv), str(so), env=env,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(proc.communicate(), timeout=300)
        server.close()
        await server.wait_closed()
        assert proc.returncode == 0, (out, err)
        assert b'"native_seam": "ok"' in out, out
        # the round trip's encode and decode, and the 200 timed encodes
        assert sidecar.requests == 202
        return out

    out = asyncio.run(scenario())
    assert json.loads(out)["native_seam"] == "ok"


@needs_gxx
@pytest.mark.parametrize("profile", [ISA, CAUCHY], ids=["isa", "cauchy"])
def test_sidecar_coalesces_concurrent_requests(tmp_path, profile):
    """Concurrent stripes from many connections merge into fewer codec
    calls, and every reply equals the reference sidecar's."""
    k, m, chunk = 8, 4, 512
    rng = np.random.default_rng(0)
    datas = [rng.integers(0, 256, (k, chunk), dtype=np.uint8)
             for _ in range(16)]
    replies = {}
    for name, make in (("port", lambda: Sidecar(coalesce_window=0.02,
                                                device="cpu")),
                       ("ref", lambda: _reference_sidecar()(
                           coalesce_window=0.02))):
        async def scenario():
            sidecar = make()
            sock = str(tmp_path / f"{name}.sock")
            server = await asyncio.start_unix_server(sidecar.handle,
                                                     path=sock)
            got = await asyncio.gather(*[
                send(sock, request(1, profile, k, m, chunk, d))
                for d in datas])
            server.close()
            await server.wait_closed()
            return sidecar, got

        sidecar, got = asyncio.run(asyncio.wait_for(scenario(), 120))
        assert sidecar.requests == 16
        assert sidecar.batches < 16, \
            f"no coalescing: {sidecar.batches} batches for 16 requests"
        for d, reply in zip(datas, got):
            assert reply[0] == 0
            parity = np.frombuffer(reply, dtype=np.uint8,
                                   offset=1).reshape(m, chunk)
            if profile is ISA:
                # row 0 of the ISA vandermonde parity is the XOR of data
                assert np.array_equal(parity[0],
                                      np.bitwise_xor.reduce(d, axis=0))
        replies[name] = got
    assert replies["port"] == replies["ref"]


@pytest.mark.parametrize("profile", [ISA, CAUCHY], ids=["isa", "cauchy"])
def test_sidecar_decode_equals_reference(tmp_path, profile):
    """A two-erasure decode through each sidecar rebuilds the erased
    chunks, byte for byte the reference's."""
    k, m, chunk = 8, 4, 1024
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (k, chunk), dtype=np.uint8)
    erasures = (2, 9)
    out = {}
    for name, make in (("port", lambda: Sidecar(device="cpu")),
                       ("ref", lambda: _reference_sidecar()())):
        async def scenario():
            sidecar = make()
            parity = (await sidecar.dispatch(
                request(1, profile, k, m, chunk, data)))[1:]
            full = np.concatenate([data, np.frombuffer(
                parity, np.uint8).reshape(m, chunk)])
            full[list(erasures)] = 0
            rebuilt = await sidecar.dispatch(
                request(2, profile, k, m, chunk, full, erasures))
            return parity, rebuilt

        parity, rebuilt = asyncio.run(asyncio.wait_for(scenario(), 120))
        assert rebuilt[0] == 0
        got = np.frombuffer(rebuilt, np.uint8, offset=1).reshape(2, chunk)
        assert np.array_equal(got[0], data[2])
        out[name] = (parity, rebuilt)
    assert out["port"] == out["ref"]


def test_sidecar_ping_and_errors():
    """A ping answers; an unknown plugin fails only its own request."""
    async def scenario():
        sidecar = Sidecar(device="cpu")
        pong = await sidecar.dispatch(b"\x03")
        bad = request(1, {"plugin": "nope", "k": "2", "m": "1"}, 2, 1, 8,
                      np.zeros((2, 8), np.uint8))
        with pytest.raises(Exception):
            await sidecar.dispatch(bad)
        ok = await sidecar.dispatch(request(
            1, {"plugin": "isa", "k": "2", "m": "1"}, 2, 1, 8,
            np.arange(16, dtype=np.uint8).reshape(2, 8)))
        return pong, ok

    pong, ok = asyncio.run(scenario())
    assert pong == b"\x00pong"
    assert ok[0] == 0 and len(ok) == 1 + 8


def test_sidecar_runs_on_cuda_unless_asked(monkeypatch):
    """A sidecar that names no device wants the card and raises where
    there is none; its codecs follow its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Sidecar()
    sidecar = Sidecar(device="cpu")
    assert sidecar.codec(json.dumps(ISA)).device.type == "cpu"


@pytest.mark.parametrize("technique", ["cauchy_good", "liberation"])
def test_packet_codec_batches_route_through_b2(monkeypatch, technique):
    """A packet codec's ``encode_batch`` and ``decode_batch`` (what the
    sidecar calls) run through kernel B2's wrapper, one call each, with
    its cached table; ISA's batches stay on the byte-layout matmul."""
    from ceph_tpu.ec import factory as jfactory
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.ops import gf8_bytes_cuda

    calls = []
    orig = gf8_bytes_cuda.bitmatrix_matmul

    def spy(bitmat, data, blocks=None):
        calls.append(blocks is not None)
        return orig(bitmat, data, blocks)

    monkeypatch.setattr(gf8_bytes_cuda, "bitmatrix_matmul", spy)
    prof = {"plugin": "jerasure", "technique": technique, "k": "4",
            "m": "2", "w": "7" if technique == "liberation" else "8",
            "packetsize": "32"}
    codec = factory(prof, device="cpu")
    ref = jfactory(prof)
    s = 4 * int(prof["w"]) * 32
    data = np.random.default_rng(5).integers(0, 256, (3, 4, s),
                                             dtype=np.uint8)
    parity = codec.encode_batch(data).numpy()
    assert np.array_equal(parity, np.asarray(ref.encode_batch(data)))
    full = np.concatenate([data, parity], axis=1)
    full[:, [0, 5]] = 0
    got = codec.decode_batch((0, 5), full).numpy()
    assert np.array_equal(got, np.asarray(ref.decode_batch((0, 5), full)))
    assert np.array_equal(got[:, 0], data[:, 0])
    assert calls == [True, True]
    calls.clear()
    factory(ISA, device="cpu").encode_batch(np.zeros((1, 8, 64), np.uint8))
    assert calls == []
