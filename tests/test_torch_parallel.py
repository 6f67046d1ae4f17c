"""The port's device mesh and sharded data plane against ``ceph_tpu``'s.

The port runs one controller process over a mesh of eight ``"cpu"`` slots
shaped ``(2, 4)``; ``ceph_tpu.parallel`` runs on the 8-device virtual CPU
mesh the test configuration sets up.  The same seeded numpy inputs go
through both: ``make_mesh`` shapes, ``distributed_ec_step``,
``MeshECEngine`` encode, every erasure pattern of ``tests/test_parallel.py``,
RMW and RMW-then-decode (each also held to the port's single-device
codec), ``MeshCodecAdapter`` on a batch that needs padding,
``wrap_codec_for_mesh``/``mesh_for_codec`` over several codecs and mesh
sizes, and ``crush_batch_sharded``.  The C1-shaped rule is held to
``ceph_tpu.crush.ScalarMapper``, not to the JAX mapper, which still has
fault C1.  Every comparison is of equal bytes.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import ScalarMapper as JScalarMapper
from ceph_tpu.crush.mapper import TensorMapper as JTensorMapper
from ceph_tpu.crush.types import Rule as JRule
from ceph_tpu.crush.types import build_hierarchy as jbuild_hierarchy
from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import matrices as jmatrices
from ceph_tpu.parallel import engine as jengine
from ceph_tpu.parallel import mesh as jmesh
from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.types import (
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_TAKE,
    Rule,
    build_hierarchy,
)
from ceph_tpu_torch.ec import factory, matrices
from ceph_tpu_torch.parallel import engine, mesh
from ceph_tpu_torch.parallel import (MeshECEngine, crush_batch_sharded,
                                     distributed_ec_step, make_mesh)

CPU8 = ["cpu"] * 8
# two distinct devices: the sharded placement then runs one host thread
# for each ("cpu:0" is its own torch.device, with CPU storage)
CPU_PAIRS = ["cpu", "cpu:0"] * 4
ISA = {"plugin": "isa", "k": "8", "m": "4"}
PATTERNS = [(0,), (5,), (8,), (11,), (0, 11), (2, 3), (9, 10), (0, 4, 8),
            (1, 2, 3, 9)]


@pytest.fixture(scope="module")
def engines():
    coding = matrices.isa_rs_matrix(8, 4)
    assert np.array_equal(coding, jmatrices.isa_rs_matrix(8, 4))
    port = MeshECEngine(make_mesh(devices=CPU8), 8, 4, coding)
    ref = jengine.MeshECEngine(jmesh.make_mesh(8), 8, 4, coding)
    return port, ref, factory(ISA, device="cpu")


def encoded(eng, seed, shape):
    data = np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)
    return data, np.concatenate([data, eng.encode_batch(data).numpy()], 1)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_equal_jax(n):
    m = make_mesh(n, devices=CPU8)
    assert m.shape == dict(jmesh.make_mesh(n).shape)
    assert m.axis_names == ("data", "shard")
    assert m.devices.size == n
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_mesh(n, shard_axis=1, devices=CPU8).shape == \
        dict(jmesh.make_mesh(n, shard_axis=1).shape)


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0"] * 8)
    with pytest.raises(ValueError, match="need 9 devices"):
        make_mesh(9, devices=CPU8)
    # one card visible: a second one, or more slots than cards, raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_mesh(4)
    with pytest.raises(ValueError, match="cuda:1"):
        make_mesh(devices=["cuda:0", "cuda:1"])
    one = make_mesh(devices=["cuda"] * 8)
    assert one.shape == {"data": 2, "shard": 4}
    assert set(one.devices.flat) == {torch.device("cuda", 0)}
    assert make_mesh().devices.shape == (1, 1)


def test_distributed_step_equals_jax():
    step, (placed,) = distributed_ec_step(make_mesh(devices=CPU8), 8, 4, 16,
                                          256)
    mismatches, chunks = step(placed)
    jfn, jargs = jmesh.distributed_ec_step(jmesh.make_mesh(8), 8, 4, 16, 256)
    jmis, jchunks = jfn(*jargs)
    assert int(mismatches) == int(jmis) == 0
    assert chunks.shape == (16, 12, 256)
    assert np.array_equal(chunks.numpy(), np.asarray(jchunks))
    # the example is placed: one piece per slot, two stripes each
    assert [[p.shape[0] for p in row] for row in placed] == [[2] * 4] * 2
    with pytest.raises(ValueError, match="data axis"):
        distributed_ec_step(make_mesh(devices=CPU8), 8, 4, 15, 256)
    with pytest.raises(ValueError, match="shard axis"):
        distributed_ec_step(make_mesh(devices=CPU8), 8, 3, 16, 256)


def test_distributed_step_detects_a_corrupted_shard():
    step, (placed,) = distributed_ec_step(make_mesh(devices=CPU8), 8, 4, 8,
                                          64)
    eng = MeshECEngine(make_mesh(devices=CPU8), 8, 4,
                       matrices.isa_rs_matrix(8, 4))
    chunks = eng.chunk_layout([[torch.cat([d, p], 1) for d, p in zip(dr, pr)]
                               for dr, pr in zip(placed,
                                                 eng.encode_placed(placed))])
    chunks[1][0][0, 1, 5] ^= 1            # row 1 of stripe 4: a survivor
    recon = eng.decode_placed(tuple(range(1, 9)), (0,), chunks)
    lost = eng.gather_rows(chunks, (0,))
    bad = sum(int((r != lo).sum()) for rr, lr in zip(recon, lost)
              for r, lo in zip(rr, lr))
    assert bad == 1
    assert int(step(placed)[0]) == 0


def test_mesh_encode_equals_jax_and_single_device(engines):
    port, ref, codec = engines
    data = np.random.default_rng(1).integers(0, 256, (8, 8, 256),
                                             dtype=np.uint8)
    got = port.encode_batch(data)
    assert got.device == torch.device("cpu") and got.shape == (8, 4, 256)
    assert np.array_equal(got.numpy(), np.asarray(ref.encode_batch(data)))
    assert torch.equal(got, codec.encode_batch(data))
    # a tensor input gives the same bytes
    assert torch.equal(port.encode_batch(torch.from_numpy(data)), got)


@pytest.mark.parametrize("erasures", PATTERNS)
def test_mesh_decode_patterns_equal_jax_and_single_device(engines, erasures):
    port, ref, codec = engines
    _, chunks = encoded(port, 2, (8, 8, 128))
    got = port.decode_batch(erasures, chunks).numpy()
    assert np.array_equal(got, chunks[:, list(erasures), :])
    assert np.array_equal(got, np.asarray(ref.decode_batch(erasures, chunks)))
    assert np.array_equal(got, codec.decode_batch(erasures, chunks).numpy())
    want = tuple(reversed(erasures))
    assert np.array_equal(port.decode_batch(erasures, chunks, want).numpy(),
                          chunks[:, list(want), :])


def test_mesh_rmw_equals_jax_and_full_reencode(engines):
    port, ref, codec = engines
    data, chunks = encoded(port, 3, (8, 8, 128))
    update = np.random.default_rng(3).integers(0, 256, (8, 8, 32),
                                               dtype=np.uint8)
    got = port.rmw_batch(chunks, update, col_start=48).numpy()
    assert np.array_equal(got,
                          np.asarray(ref.rmw_batch(chunks, update,
                                                   col_start=48)))
    patched = data.copy()
    patched[:, :, 48:80] = update
    assert np.array_equal(got[:, :8], patched)
    assert np.array_equal(got[:, 8:], codec.encode_batch(patched).numpy())
    # the input is left as it was
    assert np.array_equal(chunks[:, :8], data)


def test_mesh_rmw_then_decode_equals_jax(engines):
    port, ref, codec = engines
    _, chunks = encoded(port, 4, (8, 8, 128))
    update = np.random.default_rng(4).integers(0, 256, (8, 8, 64),
                                               dtype=np.uint8)
    got = port.rmw_batch(torch.from_numpy(chunks), update, col_start=0)
    jgot = np.asarray(ref.rmw_batch(chunks, update, col_start=0))
    assert np.array_equal(got.numpy(), jgot)
    dec = port.decode_batch((1, 6), got).numpy()
    assert np.array_equal(dec, np.asarray(ref.decode_batch((1, 6), jgot)))
    assert np.array_equal(dec[:, 0], got.numpy()[:, 1])
    assert np.array_equal(dec[:, 1], got.numpy()[:, 6])
    assert np.array_equal(dec, codec.decode_batch((1, 6), got).numpy())


@pytest.mark.parametrize("devices", [CPU_PAIRS, ["cpu"] * 6, ["cpu"] * 3],
                         ids=["two_devices", "3x2", "3x1"])
def test_mesh_engine_on_other_grids_equals_single_device(devices):
    """Other grids give the same bytes: two distinct devices, three rows
    of two columns (six chunk rows a column), three rows of one."""
    codec = factory(ISA, device="cpu")
    eng = MeshECEngine(make_mesh(devices=devices), 8, 4,
                       matrices.isa_rs_matrix(8, 4))
    data, chunks = encoded(eng, 7, (12, 8, 64))
    assert torch.equal(eng.encode_batch(data), codec.encode_batch(data))
    for er in ((0,), (7, 8), (0, 5, 11), (1, 2, 3, 9)):
        assert np.array_equal(eng.decode_batch(er, chunks).numpy(),
                              chunks[:, list(er)])
    update = np.random.default_rng(7).integers(0, 256, (12, 8, 16),
                                               dtype=np.uint8)
    got = eng.rmw_batch(chunks, update, col_start=40).numpy()
    patched = data.copy()
    patched[:, :, 40:56] = update
    assert np.array_equal(got[:, :8], patched)
    assert np.array_equal(got[:, 8:], codec.encode_batch(patched).numpy())


def test_mesh_codec_adapter_pads_13_stripes():
    codec = factory(ISA, device="cpu")
    adapter = engine.MeshCodecAdapter(codec, make_mesh(devices=CPU8))
    jcodec = jfactory(ISA)
    jadapter = jengine.MeshCodecAdapter(jcodec, jmesh.make_mesh(8))
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (13, 8, 64), dtype=np.uint8)
    parity = adapter.encode_batch(data)
    assert parity.shape == (13, 4, 64)
    assert torch.equal(parity, codec.encode_batch(data))
    assert np.array_equal(parity.numpy(),
                          np.asarray(jadapter.encode_batch(data)))
    chunks = np.concatenate([data, parity.numpy()], 1)
    got = adapter.decode_batch((2, 9), chunks)
    assert np.array_equal(got.numpy(), chunks[:, [2, 9]])
    assert np.array_equal(got.numpy(),
                          np.asarray(jadapter.decode_batch((2, 9), chunks)))
    # the planar entry points are hidden, everything else delegates
    for name in ("planar_supported", "to_planar", "encode_planar",
                 "decode_planar"):
        assert not hasattr(adapter, name)
    assert adapter.get_chunk_count() == 12 and adapter.k == 8


WRAP_PROFILES = {
    "isa": ISA,
    "reed_sol_van_w8": {"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "4", "m": "2"},
    "reed_sol_van_w16": {"plugin": "jerasure", "technique": "reed_sol_van",
                         "k": "4", "m": "2", "w": "16"},
    "cauchy_good": {"plugin": "jerasure", "technique": "cauchy_good",
                    "k": "4", "m": "2", "packetsize": "8"},
    "shec": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
}


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("name", sorted(WRAP_PROFILES))
def test_wrap_codec_for_mesh_equals_jax(name, n_devices):
    prof = WRAP_PROFILES[name]
    codec = factory(prof, device="cpu")
    jcodec = jfactory(prof)
    got = engine.wrap_codec_for_mesh(codec, n_devices, devices=CPU8)
    jgot = jengine.wrap_codec_for_mesh(jcodec, n_devices)
    wrapped = isinstance(got, engine.MeshCodecAdapter)
    assert wrapped == isinstance(jgot, jengine.MeshCodecAdapter)
    assert wrapped == (name != "reed_sol_van_w16")
    mesh_shape = engine.mesh_for_codec(codec, n_devices, devices=CPU8).shape
    assert mesh_shape == dict(jengine.mesh_for_codec(jcodec,
                                                     n_devices).shape)
    if not wrapped:
        assert got is codec
        return
    assert got._mesh_engine.mesh.shape == mesh_shape
    k = codec.get_data_chunk_count()
    data = np.random.default_rng(n_devices).integers(
        0, 256, (5, k, 64), dtype=np.uint8)
    parity = got.encode_batch(data)
    assert np.array_equal(parity.numpy(), np.asarray(jgot.encode_batch(data)))
    chunks = np.concatenate([data, parity.numpy()], 1)
    assert np.array_equal(got.decode_batch((0,), chunks).numpy(),
                          data[:, [0]])


def test_cauchy_adapter_keeps_the_reference_rule():
    """ROADMAP §C: both packages wrap a cauchy codec (it has a GF(2^8)
    ``coding`` matrix), and the mesh engine then computes a bytewise RS
    code where the codec lays packets out: the adapter's parity is the
    reference adapter's, not the codec's."""
    prof = WRAP_PROFILES["cauchy_good"]
    codec = factory(prof, device="cpu")
    got = engine.wrap_codec_for_mesh(codec, 4, devices=CPU8)
    jgot = jengine.wrap_codec_for_mesh(jfactory(prof), 4)
    data = np.random.default_rng(0).integers(0, 256, (4, 4, 64),
                                             dtype=np.uint8)
    parity = got.encode_batch(data)
    assert np.array_equal(parity.numpy(), np.asarray(jgot.encode_batch(data)))
    assert not torch.equal(parity, codec.encode_batch(data))


@pytest.fixture(scope="module")
def crush_maps():
    pmap, rule = build_hierarchy(n_hosts=8, osds_per_host=4, numrep=3)
    jmap, jrule = jbuild_hierarchy(n_hosts=8, osds_per_host=4, numrep=3)
    assert rule == jrule
    rng = np.random.default_rng(6)
    weights = np.full(pmap.max_devices, 0x10000, dtype=np.uint32)
    weights[rng.choice(32, 3, replace=False)] = 0
    weights[rng.choice(32, 3, replace=False)] = 0x8000
    xs = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    return pmap, jmap, rule, weights, xs


@pytest.mark.parametrize("devices", [CPU8, CPU_PAIRS, ["cpu"] * 3],
                         ids=["one_device", "two_devices", "three_slots"])
def test_crush_batch_sharded_equals_jax_and_single(crush_maps, devices):
    pmap, jmap, rule, weights, xs = crush_maps
    mapper = TensorMapper(pmap, device="cpu")
    m = make_mesh(devices=devices)
    res, lens = crush_batch_sharded(m, mapper, rule, xs, 3, weights)
    single, slens = mapper.do_rule_batch(rule, xs, 3, weights)
    assert res.device == torch.device("cpu")
    assert torch.equal(res, single) and torch.equal(lens, slens)
    jres, jlens = jengine.crush_batch_sharded(
        jmesh.make_mesh(8), JTensorMapper(jmap), rule, xs, 3, weights)
    assert np.array_equal(res.numpy(), np.asarray(jres).astype(np.int64))
    assert np.array_equal(lens.numpy(), np.asarray(jlens))
    # one mapper per distinct device, the mapper itself on its own
    # device, kept for the next call whatever its rule or mesh
    copies = mapper._sharded_cache
    assert set(copies) == {torch.device("cpu")} | set(m.distinct())
    assert copies[torch.device("cpu")] is mapper
    assert all(c.device == d for d, c in copies.items())
    kept = dict(copies)
    res2, _ = crush_batch_sharded(m, mapper, rule, xs[:7], 3, weights)
    assert torch.equal(res2, single[:7])
    res3, _ = crush_batch_sharded(make_mesh(2, devices=devices), mapper,
                                  rule, xs[:9], 2, weights)
    assert torch.equal(res3, mapper.do_rule_batch(rule, xs[:9], 2,
                                                  weights)[0])
    assert mapper._sharded_cache == kept
    assert all(mapper._sharded_cache[d] is c for d, c in kept.items())


def test_crush_batch_sharded_c1_rule_equals_reference_scalar():
    """ROADMAP §C1's rule shape through the sharded path, held to the
    reference's scalar mapper (the JAX mapper still has C1)."""
    steps = [(RULE_SET_CHOOSELEAF_TRIES, 5, 0), (RULE_SET_CHOOSE_TRIES, 100, 0),
             (RULE_TAKE, -3, 0), (RULE_CHOOSELEAF_INDEP, 0, 0),
             (RULE_EMIT, 0, 0)]
    pmap, _ = build_hierarchy(2, 4)
    jmap, _ = jbuild_hierarchy(2, 4)
    ruleno = pmap.add_rule(Rule(steps=steps))
    assert jmap.add_rule(JRule(steps=steps)) == ruleno
    weights = np.full(pmap.max_devices, 0x10000, dtype=np.uint32)
    weights[[1, 5]] = 0
    xs = np.arange(128, dtype=np.uint32)
    res, lens = crush_batch_sharded(make_mesh(devices=CPU_PAIRS[:4]),
                                    TensorMapper(pmap, device="cpu"),
                                    ruleno, xs, 7, weights)
    scalar = JScalarMapper(jmap)
    got = [res[i, : lens[i]].tolist() for i in range(len(xs))]
    want = [scalar.do_rule(ruleno, int(x), 7, list(weights)) for x in xs]
    assert got == want
    assert any({1, 5} & set(g) for g in got)


def test_crush_batch_sharded_threads_count_exactly(crush_maps):
    """Twelve distinct devices, so twelve host threads (more than the
    cores), with a short switch interval: every shard is mapped once,
    the results land in slot order, and the shared counters lose no
    update."""
    import sys

    from ceph_tpu_torch.utils.perf import KERNELS

    pmap, _jmap, rule, weights, xs = crush_maps
    mapper = TensorMapper(pmap, device="cpu")
    single, _ = mapper.do_rule_batch(rule, xs, 3, weights)
    m = make_mesh(devices=[torch.device("cpu", i) for i in range(12)])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        KERNELS.reset()
        res, _ = crush_batch_sharded(m, mapper, rule, xs, 3, weights)
        assert torch.equal(res, single)
        assert KERNELS.get("crush_map_calls") == 12
        assert KERNELS.get("crush_map_pgs") == len(xs) + (-len(xs)) % 12
    finally:
        sys.setswitchinterval(interval)
        KERNELS.reset()
    # cpu:0 .. cpu:11, and the mapper itself on "cpu"
    assert len(mapper._sharded_cache) == 13


def test_mesh_layout_helpers():
    m = make_mesh(6, devices=CPU8)
    assert m.shape == {"data": 3, "shard": 2}
    assert mesh.chunk_columns(m, 12) == [range(0, 6), range(6, 12)]
    assert mesh.stripe_slices(m, 9) == [
        [slice(0, 1), slice(1, 3)], [slice(3, 4), slice(4, 6)],
        [slice(6, 7), slice(7, 9)]]
    with pytest.raises(ValueError):
        mesh.stripe_slices(m, 8)
    with pytest.raises(ValueError):
        mesh.chunk_columns(m, 7)
    assert make_mesh(devices=CPU8) == make_mesh(devices=CPU8)
    assert hash(make_mesh(devices=CPU8)) == hash(make_mesh(devices=CPU8))
    assert make_mesh(devices=CPU8) != make_mesh(devices=CPU_PAIRS)
    assert make_mesh(devices=CPU_PAIRS).distinct() == [
        torch.device("cpu"), torch.device("cpu:0")]
