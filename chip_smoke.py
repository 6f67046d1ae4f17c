#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's erasure-code hot paths, CRUSH placement, device mesh, OSD store path, control plane, OSD cluster and its clients, and its chaos runner and load driver on the CUDA cards.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from ``ceph_tpu_torch/csrc/`` (first use,
one ``nvcc`` per source, in parallel), then runs these phases and exits
non-zero if any of them fails:

1. kernels: B1 (``ops/gf8_cuda.planar_matmul``) and B2
   (``ops/gf8_bytes_cuda.bitmatrix_matmul``) against their plain versions
   on the card, bit-exact: B1 at its ragged check shapes, the shapes the
   ISA path gives it, and those of the SHEC k8m4c3 encode and decodes
   (plans of 4 and 8 sources), the LRC k4m2l3 flattened encode and local
   decode, and reed_sol_van k8m4 at w=16 ((64, 128), staged) and w=32
   ((128, 256), whose lists overflow the staged kernel's table: kept);
   B2 at the general ISA bit-matrices the TPU kernel was validated with,
   the lane-expanded matrices of the cauchy path (encode, decodes with 1,
   2 and 4 erasures, the tick), the encode matrices of liberation k=7
   w=7, blaum_roth k=6 w=6, liber8tion k=8 and cauchy_good w=16 (with a
   planar encode/decode of each against the host reference), a
   misaligned column slice and N in {1, 7, 4097}; both at the staged
   kernel's edges (N of one vector, a tile less or more one vector,
   several tiles and a vector, fewer tiles than CTAs, k=128 with r=64,
   k=49), each call checked to take the path it should (staged or kept),
   and B2 with its host-packed table and with the on-card packing;
2. ISA path (ISA k=8 m=4, bit-planar, kernel B1): 4096 stripes x 8 x
   512 B per step through ``to_planar`` -> ``encode_planar`` ->
   ``to_batch`` against the host GF reference, ``decode_planar`` for 1, 2
   and 4 erasures, ``encode``/``decode_concat`` of a 4 MiB object, and one
   OSD tick at ``StripeInfo(8, 4096)`` through ``encode_planes_multi`` /
   ``decode_planes_multi``;
3. jerasure path (cauchy_good k=8 m=4 w=8 packetsize=2048, packet rows,
   kernel B2): 128 stripes x 8 x 16 KiB = 16 MiB per step through the
   same planar calls against a host reference (the XOR of the packet rows
   the bit-matrix selects), ``encode``/``decode_concat`` of a 4 MiB
   object, one byte-at-rest OSD tick at ``StripeInfo(8, 16384)`` through
   ``encode_stripes_multi`` / ``decode_stripes_multi`` /
   ``reencode_stripes_multi``, and a small tick of Ceph's default profile
   (jerasure reed_sol_van k=2 m=1, kernel B1) through
   ``encode_planes_multi`` / ``decode_planes_multi``;
4. the erasure-code paths, all on kernel B1, each tick of the same op
   sizes as the ISA tick and each result also held against the port's
   plain version on the CPU:
   - SHEC k=8 m=4 c=3, planes at rest at ``StripeInfo(8, 4096)``:
     ``encode_planes_multi`` with CRCs, ``decode_planes_multi`` for lost
     shards (3, 9) (plane engine) and (4,) and (0, 1) (relayout to the
     byte decode), ``reencode_planes_multi`` for (4,) (relayout) and
     (0, 5, 11) (plane engine);
   - LRC k=4 m=2 l=3, bytes at rest at ``StripeInfo(4, 4096)``:
     ``encode_stripes_multi``, ``decode_stripes_multi`` for one local
     loss (which reads only its group) and a loss in each group,
     ``reencode_stripes_multi``;
   - jerasure reed_sol_van k=8 m=4 at w=16 and w=32: codec encode/decode
     on the byte layout and the bitpack planes, and the byte-at-rest tick
     at ``StripeInfo(8, 4096)``;
5. placement (CRUSH and the OSDMap pipeline, torch ops, no hand-written
   kernel) on bench_map's map, ``build_three_level(39, 16, 16)``: 9,984
   OSDs, straw2, optimal tunables.  (a) ``OSDMap.pool_mapping`` of a
   replicated size-3 pool of 1,048,576 PGs, then ``rebalance_diff``
   against a copy with one host's 16 OSDs out and one more OSD down;
   (b) ``pool_mapping`` of an LRC k4m2l3 pool of 65,536 PGs on the rule
   ``ErasureCodeLrc.create_rule`` writes for ``crush-locality=rack``;
   (c) ``TensorMapper.do_rule_batch`` of the replicated rule under a
   balancer weight set on the root's 39 racks, 65,536 PGs.  Checked: 1,000
   sampled PGs of each of (a), (b), (c) and of the diff against the
   scalar chain, the first 16,384 PGs of (a) against
   ``TensorMapper(device="cpu")``, distinct hosts in every PG, no scalar
   fallback and no padded lanes.  Then (d) ROADMAP §C1's repro on the
   card (``build_hierarchy(2, 4)``, an erasure pool of size 7 and 16,384
   PGs on ``chooseleaf indep 0 type 0`` with OSDs 1 and 5 out), 4,096
   sampled PGs against the scalar chain, and the same rule as a
   65,536-PG erasure pool of the 9,984-OSD map with one host out, 1,000
   sampled PGs against it (the scalar chain runs in a pool of spawned
   worker processes);
   (e) one balancer round,
   ``balance.scorer.calc_pg_upmaps_vectorized`` with the mgr's defaults
   (``max_deviation_ratio=0.05``, ``max_moves=16``), on a replicated
   size-3 pool of 65,536 PGs on that map: at least 1000 candidates
   counted, at most 16 legal moves (one per PG, no shared failure
   domain), a lower sum((count - target)^2) under a fresh
   ``pool_mapping``, 1,000,000 sampled device scores equal to the plain
   float64 formula bit for bit, and the round split into measurement,
   enumeration, scoring, sort and pick on a fresh copy of the map; and
   the card's candidates and moves equal to ``device="cpu"``'s on
   ``build_three_level(4, 16, 16)`` with 8,192 PGs;
6. the mesh (``ceph_tpu_torch/parallel/``, torch ops, no hand-written
   kernel): one controller over every visible card when there are two or
   more, else eight slots of ``cuda:0`` shaped ``(2, 4)``.
   ``MeshECEngine`` on ISA k8m4, 4096 stripes x 8 x 512 B: encode, the
   nine erasure patterns of ``tests/test_parallel.py`` and an RMW of
   columns [128, 384) against the single-device codec, byte for byte;
   ``distributed_ec_step`` at the same shape (0 mismatches);
   ``MeshCodecAdapter`` on 4095 stripes (padded to the data axis); and
   ``crush_batch_sharded`` of the 1,000,000 ``BENCH_PGS`` on the
   9,984-OSD map against ``do_rule_batch``;
7. the OSD store path (``ceph_tpu_torch/cluster/``: the tick batchers,
   the messenger and the object stores, with kernels B1 and B2 behind the
   batchers' ticks): a primary stand-in (the port's ``Config``,
   ``PerfCounters`` and clock, ``_compute`` through ``run_in_executor``,
   ``device`` the card, the port's ``EncodeBatcher``, ``ReadBatcher`` and
   ``SubWriteBatcher``, sub-writes out through its own ``Messenger``) and
   twelve shard peers, each a ``Messenger`` on 127.0.0.1 whose dispatcher
   applies every ``MOSDECSubOpWrite``, alone or in a
   ``MOSDECSubOpWriteBatch``, as one ``Transaction`` on its own store and
   acks it; every store in a temporary directory.  Pool A: ISA k8m4 at
   ``StripeInfo(8, 4096)``, planes at rest in twelve BlueStores (256 MiB
   devices, ``checkpoint_every=512``), two ticks of ``TICK_SIZES``, each
   submitted at once to ``EncodeBatcher.encode(..., planar=True)``.
   Checked: every tick coalesced all 261 ops, the sub-writes left as batch
   frames, every peer applied every shard; then every store crashes and
   remounts (WAL replay after its checkpoints), every shard of every op
   is read back with ``read_planar`` and verified through
   ``ReadBatcher.verify`` against the tick's crcs on the card (all true);
   a bit flipped by ``DiskInjector.flip_bit`` makes that store's read
   raise EIO and that row's verify (of the bytes the device holds) false;
   ``ReadBatcher.decode`` of every op with shards (0,), (1, 10) and
   (0, 1, 2, 3) lost equals the client bytes, and ``reencode`` with
   shard 4 lost equals the stored planes.  Pool B: cauchy_good k8m4
   packetsize 2048 at ``StripeInfo(8, 16384)``, bytes at rest in twelve
   FileStores, one tick, crash (journal intact) and remount, verify (all
   true), decode with (0,) and (2, 11) lost.  Printed beside the card:
   the median tick (encode window) and ops per tick, the tick from submit
   to all twelve peers applied and the encode window's share of it, MB/s
   of shard bytes into the stores, the remount time and the
   read-and-verify time;
8. the control plane (``ceph_tpu_torch/cluster/{paxos,mon,monclient,
   mgr}.py`` and ``balance/``, torch ops, no hand-written kernel): three
   monitors on 127.0.0.1, each with its FileStore in a temporary
   directory, and a mgr (defaults but ``mgr_balancer_require_clean=0``:
   no OSD beacons here), all on ``cuda:0``, on
   ``build_three_level(39, 16, 16)`` with every OSD up and in.  Through
   the mgr's ``mon_command``: ``osd pool create`` of a replicated size-3
   pool of 65,536 PGs and of an ISA k8m4 pool of 16,384 PGs (the mon's
   ``chooseleaf indep 12 type host`` rule), a balancer round that
   commits, an ``osd pg-upmap-items`` moving all three members of 64 PGs
   onto three other hosts, the leader stopped and a second round
   committed on the new leader, and the stopped monitor revived from its
   store.  Checked: every monitor and the mgr at one epoch with equal
   pools, upmaps, pg_temp, weights and flags; each round's moves
   committed as planned, legal, the skew lower; each mint's entries equal
   to the per-PG scalar mint on 1,000 sampled PGs of each pool, every PG
   its upmaps touched and the 64 wholesale PGs (64 entries), and
   ``pool_raw_up`` equal to the scalar chain on the same PGs (the scalar
   chain in spawned workers); the revived monitor resumed once from its
   store; no map left the card; every commit inside the mgr's 10 s
   timeout.  Printed beside the card: election to quorum, each commit
   from submit to all three applied and its mint (split by pool), each
   round's plan and commit, the mapper rebuild per deep copy, the longest
   event-loop block, the failover and the revived monitor's catch-up;
9. the OSD cluster (``ceph_tpu_torch/cluster/{osd,pg,pglog,backend_ec,
   backend_replicated,client_ops,recovery,scrub,sharded_wq,objecter,
   vstart}.py``): ``start_cluster`` of 3 monitors, a mgr and 24 OSDs on
   12 hosts, each OSD on a BlueStore in a temporary directory, every
   daemon and the client on ``cuda:0``; an ISA k8m4 pool of 256 PGs
   (planes at rest, kernel B1), a cauchy_good k8m4 pool of 64 PGs (bytes
   at rest, kernel B2) and a replicated size-3 pool of 256 PGs; 8, 4
   and 4 objects of 4 MiB from the seed (a quarter of rados bench's 32,
   16 and 16), written and read back with up to 16 ops in flight (rados
   bench's default); the EC PGs holding them deep-scrubbed (each OSD its
   primary PGs, side by side); one OSD stopped until it is down and out and every PG is
   clean as the cluster reports it (then up to 30 s for the last pushes
   to land on every acting member, and until no OSD peers, retries,
   recovers or launches a kernel for 1 s), every object read again; the
   OSD revived on an empty BlueStore, marked in and backfilled, and quiet
   in the same way before the next window opens.  Checked:
   every read equals what was written, the scrub finds nothing, every
   acting member of every object's PG holds it after the recovery and
   the backfill, every EC shard every store holds equals the plain CPU
   codec's (``factory(profile, device="cpu")``) in the layout the store
   holds it, and each EC pool's stores hold at least a shard for every
   slot CRUSH fills, after the writes, the recovery and the backfill.
   Printed beside the card: each pool's write and read MB/s and p50/p99
   op latency, ops per encode tick, scrub time, the times to down, out
   and clean, the backfill, the map advances summed over the OSDs per
   epoch (the daemons share one placement cache) and one OSD's unshared
   placement of one epoch, the client's scalar targeting and the
   longest event-loop block; each window's recovery work (peering
   rounds, recoveries, pushes, read repairs) beside its launches.  Then,
   on the same cluster, the client
   windows (``ceph_tpu_torch/{tools/rados,cluster/rbd,cluster/mds,
   cluster/fs,cluster/striper,cluster/rgw,cluster/rgw_http,
   tools/ec_sidecar}.py``): ``tools/rados.bench`` at Ceph's defaults
   (4 MiB blocks, 16 in flight) for 2 s of ``write`` and 2 s of ``seq``
   on the ISA pool, every read compared with the block; an RBD image of
   32 MiB on the ISA pool at RBD's default layout (4 MiB objects,
   ``stripe_unit`` the object size, ``stripe_count`` 1): 8 sequential
   4 MiB writes with 8 in flight, 16 random 4 KiB overwrites of distinct
   blocks from the seed (fio's ``randwrite 4k``), a full read against a
   host model of the image, a snapshot and its full read;
   ``Cluster.start_mds`` with its metadata on the replicated pool and
   its data on the cauchy pool, an ``MDSClient``: ``mkdir /d``, 4 files
   of 4 MiB from the seed written and read back, ``listdir`` and
   ``stat``; RGW on the replicated pool behind ``RGWFrontend`` on
   loopback with one account: signed PUT and GET of 4 objects of 4 MiB
   and one multipart upload of three 5 MiB parts, every ETag and byte
   checked; the EC sidecar (``ec_sidecar.Sidecar`` on the card, a unix
   socket in the phase's temporary directory), the native shim and its
   driver built with ``g++`` from ``native/ec_sidecar/`` into
   ``ceph_tpu_torch/_build/ec_sidecar/`` (ISA k8m4, 512 B chunks: the
   round trip and 200 serial encodes, ``"native_seam": "ok"``), then 64
   concurrent cauchy_good k8m4 encodes of 16 KiB chunks and one decode
   of two erasures over the documented protocol, fewer batches than
   requests and every reply equal to ``factory(profile, device="cpu")``'s;
   then a deep scrub of the EC PGs the windows wrote (nothing
   inconsistent), and every EC shard of the bench, RBD and CephFS data
   objects in every store equal to the plain CPU codec's.  Printed
   beside the card: each window's MB/s and p50/p99 latencies, the MDS
   start and create times, the sidecar's batches and the driver's rate,
   the scrub and the longest loop block of each window;
10. chaos and load (``ceph_tpu_torch/chaos/{daemons,invariants,scenario,
   integrity}.py``, ``load/{dist,driver,slo,ramp,soak}.py``,
   ``tools/load.py``, ``analysis/racecheck.race_run``): (a) last on
   phase 9's cluster,
   ``LoadContext.create`` of the library's ``read-heavy`` spec at 256
   PGs (jerasure reed_sol_van k2m1, 4096 B payloads, zipf 1.2 over 32
   objects, 64 clients at 1.2 ops/s for 2.5 s over four sessions) and
   one ``run_load`` window judged by the SLO gates from the mgr's scrape
   (goodput at least half the offered ops, p99 at most 5000 ms, the
   client window not collapsed below 2, health clear, no ack past its
   deadline); every object the window left is read back (a tracked one
   must hold a whole payload the window attempted) and every shard of it
   held to the plain CPU codec's, and each failed op's error, errno,
   verb, object and PG printed; (b) ``run_scenario`` of the library's
   ``batch-smoke`` at seed 31, ``thrash-ec-midwrite`` and
   ``integrity_scenarios()["bitrot-under-load"]``, each on a fresh
   cluster on ``cuda:0``: every verdict passes (its durability invariant
   reads back every acked object and checks its crc), and each replay
   key is the passing one of its schedule; (c) ``race_run("batch-smoke", SEED, shrink=True)`` on the card:
   the verdict passes and the race tracker convicts nothing; (d)
   ``ramp`` of ``read-heavy`` at 256 PGs at scales 1 and 2 on a fresh
   cluster on the card, its PGs clean before the first step, its
   artifact written to a temporary directory:
   the trust stamps, a knee, and the card's name and power limit in its
   ``card`` field; (e) ``run_soak`` of ``soak-mixed-crash`` at seed 17
   (jerasure reed_sol_van k2m1 on FileStore, 5 % batch-item drops,
   ``tick_post_encode`` and ``commit_mid_fanout`` crash points during
   writes, each followed by a revive): the verdict passes, a crash point
   fired, objects were acked and the schedule is ``build_schedule``'s at
   seed 17; (f) ``python -m ceph_tpu_torch.tools.load run --spec
   read-heavy --seed 3 --no-postmortem`` in a subprocess on the card
   exits 0 with ``ALL GATES PASS``; (g) the elastic runner and the chaos
   CLI (``chaos/{frontdoor,balance}.py``, ``tools/chaos.py``):
   ``run_elastic`` of ``expand-drain-smoke`` at seed 7 on a fresh
   cluster on the card (grow 3 -> 6 OSDs through the mgr's reshape op
   under a load window, rebalance, drain back): the verdict passes, its
   plan is ``build_elastic_plan``'s, a move was committed, the grown OSDs
   were up at the rebalance and out of the map at the judge; then
   ``python -m ceph_tpu_torch.tools.chaos run --scenario frontdoor-smoke
   --seed 7 --json --no-postmortem --device cuda`` in a subprocess
   started beside the elastic run: exit 0, a passing verdict, a client
   interrupt and an MDS crash point fired, and its schedule the one
   ``schedule`` prints, twice alike, in processes that see no card.
   (d), (e), (f) and each part of (g) run under their own bound (60,
   90, 45, 60 and 60 s).  Printed beside the
   card: the gate rows, the offered and acked ops, each scenario's
   schedule length, the faults that fired, the acked objects, the heal,
   converge and invariant times and the wall time, each ramp step's
   offered and acked ops/s, p99 and verdict, and the knee; each elastic
   seam's wall, the moves and the HEALTH_OK times;
11. one launch: a torch.profiler trace of one cauchy ``encode_planar``
   call shows exactly one device kernel, B2's staged kernel, and no
   ``pack_blocks_kernel``;
12. timing: CUDA-event medians of B1 and B2 and of their plain versions at
   their headline shapes (L2 flushed before each launch), each kernel's
   share of its bound, a same-traffic yardstick (``torch.bitwise_xor`` of
   the two 8 MiB halves of a (64, 262144) uint8 tensor into 8 MiB), the
   encode step of each path split into its parts, and B1 at the w=16,
   w=32 and SHEC encode shapes with 16 MiB of input planes;
   ``ops/profiling.device_loop_slope`` of B1 at its headline shape (each
   L-step chain one CUDA graph) beside its CUDA-event median; then the
   placement entry points' wall times of one call (``PLACEMENT_REPS``;
   no warm-up for an entry point that already ran on the same inputs)
   (``do_rule_batch`` of 1,000,000 PGs at the default chunk and in one
   chunk, with a
   torch.profiler count of device kernels, kernel time, host syncs and
   the device's idle share; ``pool_mapping``; ``rebalance_diff``;
   ``bench_map``); and the mesh encode and one-erasure decode against the
   single-device codec (CUDA events on every device of the mesh, and wall
   medians), and the wall times of ``crush_batch_sharded`` and
   ``do_rule_batch`` on the 1,000,000 PGs.

Phases 2, 3, each path of phase 4, phase 5 (a)-(c), (d), (e), phase 6,
each pool of phase 7, phase 8 and each window of phase 9 are main paths:
kernel launch counts are set to 0 just before each and read just after,
every kernel of the path must have launched, and every launch must have
taken the staged path, except on the w=32 path, whose encode and 4-erasure decode take the
kept one; the placement path launches neither kernel and its
``crush_map_*`` counters must show its five batched calls, the C1 path's
its two, the scorer path's ``balance_candidates_scored`` the
candidates the round reports, and the mesh path launches neither kernel
and maps one shard per mesh slot; the store path's pool A launches B1
and not B2, its pool B launches B2, every launch staged; the control
plane launches neither, and its ``crush_map_calls`` are each mint's 2
per pool of both maps (0, 2, 4, 4, 4) and each balancer plan's 2 per
pool for its skews and 1 per pool per optimizer measurement.  Phase 9's
windows are each pool's I/O, the scrub, the recovery, the backfill and
the client windows: the ISA pool's launches B1 and not B2, the cauchy
pool's B2 and not B1, the replicated pool's neither; rados bench and RBD
B1 and not B2, CephFS B2 and not B1, RGW, the sidecar's ISA driver and
the client scrub neither, the sidecar's cauchy requests B2 and not B1;
every launch staged.  Phase 10's load window (among phase 9's), each
scenario of (b) and (c), the ramp (d) and the soak (e) are main paths
too: B1 and not B2; (f) runs in its own process; the elastic run of (g)
is a main path on a replicated pool, so neither kernel may launch, and
the chaos CLI of (g) runs a replicated pool in its own process.  Before the
last lines, one ``phase clock`` line a phase gives its seconds.  The last
lines are the card's name and power limit, one JSON object describing each
kernel (B1's and B2's launches summed over every main path), and ``{"ok": true, "device": {...}}``.  Without a CUDA device it
prints no result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
import types

import numpy as np

# the card's published rates (NVIDIA H100 SXM data sheet): device memory
# bandwidth, and the non-tensor 32-bit rate used for the XOR count
HBM_BYTES_PER_S = 3.35e12
OPS_32BIT_PER_S = 67e12

SEED = 20261016

# device clock cycles of the spin ahead of each timed call (~0.3 ms), and
# ahead of each timed encode step, whose dozens of small launches can take
# the host longer than that to enqueue
SPIN_CYCLES = 500_000
STEP_SPIN_CYCLES = 4 * SPIN_CYCLES

# one OSD tick: 256 ops of 64 KiB objects and a few ragged sizes
TICK_SIZES = [64 << 10] * 256 + [0, 100, 40000, 200 << 10, (1 << 20) + 1]

# the jerasure path: cauchy_good at the plugin's default w and packetsize
# (16 KiB chunk quantum), at the k/m of the ISA path; 128 stripes x 8 x
# 16 KiB = 16 MiB of client data per encode step
CAUCHY_PROFILE = {"plugin": "jerasure", "technique": "cauchy_good",
                  "k": "8", "m": "4", "packetsize": "2048"}
HEADLINE_STRIPES = 128

# the erasure-code slice's pools: the example profiles of Ceph's own
# documentation (erasure-code-shec.rst, erasure-code-lrc.rst) and
# reed_sol_van k=8 m=4 at the wide fields
SHEC_PROFILE = {"plugin": "shec", "k": "8", "m": "4", "c": "3"}
LRC_PROFILE = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}
WIDE_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
                "m": "4"}

# the staged kernels' column tile (csrc/gf2_stream.cuh kTile) and the
# widths at its edges: one 16-byte vector, a tile less or more a vector,
# several tiles and a vector (each a single item or a few: fewer tiles
# than the persistent grid has CTAs)
TILE = 1024
EDGE_WIDTHS = [16, TILE - 16, TILE, TILE + 16, 5 * TILE + 16]

# the packet codecs checked at their own geometry (packetsize 2048)
PACKET_CHECKS = [
    {"technique": "liberation", "k": "7", "w": "7"},
    {"technique": "blaum_roth", "k": "6", "w": "6"},
    {"technique": "liber8tion", "k": "8"},
    {"technique": "cauchy_good", "k": "8", "m": "4", "w": "16"},
]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median_ms(fn, reps: int, flush=None, spin=SPIN_CYCLES) -> float:
    """Median over ``reps`` single calls, timed with CUDA events; the L2
    cache is overwritten before each call when ``flush`` is given.  A
    device-side spin before the start event keeps the card busy while the
    host enqueues the call, so the host's launch overhead does not show
    up as idle time between the events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_kernel_ms(fn, kernel_name: str, reps: int, flush):
    """Median device time of the kernel ``kernel_name`` over ``reps``
    calls, as torch.profiler's CUDA activity trace reports it (no event or
    launch overhead); None when the trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = [getattr(e, "device_time", None) or e.cuda_time
             for e in prof.events() if kernel_name in e.name]
    return statistics.median(times) / 1e3 if times else None


def took_path(module, before: int) -> str:
    """"kept" when the wrapper's kept-path count moved since ``before``."""
    return "kept" if module.kept_launches > before else "staged"


def phase_kernel(codec, rng):
    """B1 against its plain version on the card at its check shapes and
    the ISA path's; returns max |diff|."""
    import torch

    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.ops import gf8

    cases = []
    for (k, m, npk) in [(8, 4, 2048 * 3), (8, 4, 2048 * 2 + 100),
                        (4, 2, 5000), (10, 4, 2048), (2, 1, 2048)]:
        bm = gf8.expand_bitmatrix(matrices.isa_rs_matrix(k, m))
        cases.append((f"check k{k}m{m} npk={npk}",
                      torch.from_numpy(bm).cuda(), npk))
    eng = codec.engine
    headline_npk = 4096 * 512 // 8       # packed columns of one step
    cases.append(("headline encode", eng._enc_bitmat, headline_npk))
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        src = tuple(i for i in range(12) if i not in er)[:8]
        cases.append((f"headline decode {er}", eng.decode_bitmat(src, er),
                      headline_npk))
    # the stripe tick's shape: its stripes' packed columns
    cases.append(("stripe tick encode", eng._enc_bitmat,
                  tick_stripes(8, 4096) * 4096 // 8))
    # the staged kernel's edges, and k=128 with r=64 and k=49
    for npk in EDGE_WIDTHS:
        cases.append((f"staged edge npk={npk}", eng._enc_bitmat, npk))
    for rw, kw in [(64, 128), (32, 49)]:
        bm = torch.from_numpy(
            rng.integers(0, 2, (rw, kw), dtype=np.uint8)).cuda()
        cases.append((f"staged edge r={rw} k={kw}", bm, 4 * TILE + 16))
    return max(check_b1(name, bm, npk, rng) for name, bm, npk in cases)


def phase_codec(codec, rng):
    """ISA k8m4 at 4096 x 8 x 512 B: planar encode/decode and the object
    encode/decode_concat, against the host GF reference."""
    from ceph_tpu_torch.ops import gf8

    B, k, S = 4096, 8, 512
    data = rng.integers(0, 256, (B, k, S), dtype=np.uint8)
    t0 = time.perf_counter()
    pb = codec.to_planar(data)
    parity = codec.encode_planar(pb).to_batch().cpu().numpy()
    t_enc = time.perf_counter() - t0
    cols = data.transpose(1, 0, 2).reshape(k, B * S)
    ref = gf8.gf_matmul_ref(codec.engine.coding, cols)
    ref = ref.reshape(4, B, S).transpose(1, 0, 2)
    if not np.array_equal(parity, ref):
        raise AssertionError("planar encode parity differs from host reference")
    log(f"codec: planar encode of {B}x{k}x{S} B equals host GF reference "
        f"(host clock incl. copies {t_enc * 1e3:.3f} ms)")
    full = np.concatenate([data, parity], axis=1)
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        chunks = full.copy()
        chunks[:, list(er), :] = 0
        dec = codec.decode_planar(er, codec.to_planar(chunks))
        if not np.array_equal(dec.to_batch().cpu().numpy(),
                              full[:, list(er), :]):
            raise AssertionError(f"decode_planar {er} wrong")
        log(f"codec: decode_planar erasures {er} recovers the chunks")
    obj = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    enc = codec.encode(range(12), obj)
    dchunks = np.stack([enc[i] for i in range(8)])
    if not np.array_equal(np.stack([enc[i] for i in range(8, 12)]),
                          gf8.gf_matmul_ref(codec.engine.coding, dchunks)):
        raise AssertionError("encode parity differs from host reference")
    for er in [(0,), (3, 10), (0, 5, 9, 11)]:
        avail = {i: c for i, c in enc.items() if i not in er}
        if codec.decode_concat(avail)[:len(obj)] != obj:
            raise AssertionError(f"decode_concat {er} wrong")
    log("codec: encode/decode_concat of a 4 MiB object round-trips")
    return data


def phase_stripe(codec):
    """One OSD tick at StripeInfo(8, 4096) through the at-rest planar
    entry points, against host references."""
    from ceph_tpu_torch.ec import planar_store as pstore
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c, gf8

    rng = np.random.default_rng(SEED + 1)
    sinfo = stripe.StripeInfo(8, 4096)
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in TICK_SIZES]
    res = stripe.encode_planes_multi(codec, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    n = 12
    by_len = {}
    for (planes, crcs), d in zip(res, datas):
        ns = sinfo.object_stripes(len(d))
        shards = pstore.planes_to_rows(planes.reshape(n * 8, -1))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        data_rows = buf.reshape(ns, 8, 4096).transpose(1, 0, 2).reshape(8, -1)
        want = np.vstack([data_rows,
                          gf8.gf_matmul_ref(codec.engine.coding, data_rows)])
        if not np.array_equal(shards, want):
            raise AssertionError(f"stripe shards differ for a {len(d)} B op")
        by_len.setdefault(shards.shape[1], []).append((shards, crcs))
    checked = 0
    for length, group in by_len.items():
        rows = np.vstack([s for s, _c in group])
        host = crc32c.crc32c_rows(rows)           # host table path
        got = [c for _s, crcs in group for c in crcs]
        if got != host:
            raise AssertionError(f"stripe CRCs differ at shard length {length}")
        for r in (0, len(rows) - 1):
            if crc32c.crc32c(0xFFFFFFFF, rows[r].tobytes()) != got[r]:
                raise AssertionError("stripe CRC differs from scalar crc32c")
        checked += len(rows)
    log(f"stripe: {len(datas)} ops, shards equal host reference, "
        f"{checked} shard CRCs equal host crc32c")
    for lost in [(3,), (0, 6)]:
        reqs = [({s: p[s] for s in range(n) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        if stripe.decode_planes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"decode_planes_multi lost {lost} wrong")
        log(f"stripe: decode_planes_multi with data shards {lost} lost "
            "returns the original bytes")


def to_packet_rows(batch: np.ndarray, w: int, p: int) -> np.ndarray:
    """(B, c, S) chunks -> (c*w, B*ns*p) packet rows: packet t of every
    super-block of chunk j lands in row j*w + t (jerasure's layout)."""
    b, c, s = batch.shape
    ns = s // (w * p)
    return np.ascontiguousarray(batch.reshape(b, c, ns, w, p)
                                .transpose(1, 3, 0, 2, 4)
                                .reshape(c * w, b * ns * p))


def from_packet_rows(rows: np.ndarray, b: int, s: int, w: int,
                     p: int) -> np.ndarray:
    """(c*w, B*ns*p) packet rows -> (B, c, S) chunks."""
    c = rows.shape[0] // w
    ns = s // (w * p)
    return np.ascontiguousarray(rows.reshape(c, w, b, ns, p)
                                .transpose(2, 0, 3, 1, 4).reshape(b, c, s))


def host_xor_rows(m01: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Host reference of a packet code: output row r is the XOR of the
    input rows that the 0/1 matrix m01 selects in its row r."""
    out = np.zeros((m01.shape[0], rows.shape[1]), dtype=np.uint8)
    for r in range(m01.shape[0]):
        sel = np.nonzero(m01[r])[0]
        if sel.size:
            out[r] = np.bitwise_xor.reduce(rows[sel], axis=0)
    return out


def host_packet_parity(codec, batch: np.ndarray) -> np.ndarray:
    """(B, k, S) data chunks -> (B, m, S) parity chunks on the host."""
    w, p = codec.w, codec.packetsize
    b, _k, s = batch.shape
    prow = host_xor_rows(codec._encode_bits(), to_packet_rows(batch, w, p))
    return from_packet_rows(prow, b, s, w, p)


def check_b2(name, lane, rows, blocks=None):
    """B2 against its plain version on the same operands, with the host
    table ``blocks`` or packed on the card; checks that the call took the
    staged path exactly when its rows are 16-byte aligned.  Max |diff|."""
    import torch

    from ceph_tpu_torch.ops import gf8_bytes_cuda

    kept = gf8_bytes_cuda.kept_launches
    got = gf8_bytes_cuda.bitmatrix_matmul(lane, rows, blocks)
    path = took_path(gf8_bytes_cuda, kept)
    want = gf8_bytes_cuda.bitmatrix_matmul_ref(lane, rows)
    torch.cuda.synchronize()
    diff = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if diff or not torch.equal(got, want):
        raise AssertionError(f"B2 differs from its plain version: {name}")
    n = rows.shape[1]
    aligned = (n % 16 == 0 and rows.data_ptr() % 16 == 0
               and (rows.shape[0] < 2 or rows.stride(0) % 16 == 0))
    if path != ("staged" if aligned else "kept"):
        raise AssertionError(f"B2 took the {path} path: {name}")
    log(f"kernel: B2 bit-exact, {name}, bitmat {tuple(lane.shape)} x data "
        f"{tuple(rows.shape)}, "
        f"{'host table' if blocks is not None else 'packed on the card'}, "
        f"{path} path")
    return diff


def phase_kernel_b2(codec, rng):
    """B2 against its plain version on the card at every shape of the
    jerasure slice; returns max |diff|."""
    import torch

    from ceph_tpu_torch.ec import factory, matrices
    from ceph_tpu_torch.ops import gf8

    worst = 0
    # the general bit-matrices the TPU kernel was validated with
    for (k, m, n) in [(8, 4, 16384 * 3), (8, 4, 16384 * 2 + 1000),
                      (4, 2, 5000), (10, 4, 16384)]:
        bm = torch.from_numpy(
            gf8.expand_bitmatrix(matrices.isa_rs_matrix(k, m))).cuda()
        data = torch.from_numpy(
            rng.integers(0, 256, (k, n), dtype=np.uint8)).cuda()
        worst = max(worst, check_b2(f"ISA k{k}m{m} N={n}", bm, data))
    # the lane-expanded matrices of the cauchy path at the headline width
    k, w, p = codec.k, codec.w, codec.packetsize
    n = HEADLINE_STRIPES * p
    rows = torch.from_numpy(
        rng.integers(0, 256, ((k + codec.m) * w, n + 8), dtype=np.uint8)
    ).cuda()
    enc, enc_blocks = codec._lane_and_blocks(codec._encode_bits())
    worst = max(worst, check_b2("cauchy headline encode, row stride N+8",
                                enc, rows[:k * w, :n], enc_blocks))
    headline = rows[:k * w, :n].contiguous()
    worst = max(worst, check_b2("cauchy headline encode", enc, headline,
                                enc_blocks))
    worst = max(worst, check_b2("cauchy headline encode", enc, headline))
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        src = tuple(i for i in range(k + codec.m) if i not in er)[:k]
        dec, dec_blocks = codec._lane_and_blocks(codec._decode_bits(src, er))
        sel = torch.cat([rows[s * w:(s + 1) * w, :n] for s in src])
        worst = max(worst, check_b2(f"cauchy headline decode {er}", dec, sel,
                                    dec_blocks))
    tick = torch.from_numpy(rng.integers(
        0, 256, (k * w, tick_stripes(8, 16384) * p), dtype=np.uint8)).cuda()
    worst = max(worst, check_b2("cauchy stripe tick encode", enc, tick,
                                enc_blocks))
    # a column slice off any word boundary, and ragged widths
    for n_edge in (n - 8, 1, 7, 4097):
        view = rows[:k * w, 3:3 + n_edge]
        worst = max(worst, check_b2(
            f"cauchy encode, slice at column 3, N={n_edge}", enc, view))
    # the staged kernel's edges
    for n_edge in EDGE_WIDTHS:
        worst = max(worst, check_b2(
            f"cauchy encode, staged edge N={n_edge}", enc,
            headline[:, :n_edge].contiguous(), enc_blocks))
    # the other packet codecs at their own geometry: kernel, then a planar
    # encode/decode against the host reference
    for prof in PACKET_CHECKS:
        pc = factory({"plugin": "jerasure", "packetsize": "2048", **prof})
        name = f"{pc.technique} k{pc.k}m{pc.m} w{pc.w}"
        lane, blocks = pc._lane_and_blocks(pc._encode_bits())
        batch = rng.integers(0, 256, (16, pc.k, pc.w * pc.packetsize),
                             dtype=np.uint8)
        prow = torch.from_numpy(to_packet_rows(batch, pc.w,
                                               pc.packetsize)).cuda()
        worst = max(worst, check_b2(f"{name} encode", lane, prow, blocks))
        worst = max(worst, check_b2(
            f"{name} encode, staged edge N={TILE + 16}", lane,
            prow[:, :TILE + 16].contiguous(), blocks))
        parity = pc.encode_planar(pc.to_planar(batch)).to_batch().cpu().numpy()
        if not np.array_equal(parity, host_packet_parity(pc, batch)):
            raise AssertionError(f"{name}: planar encode differs from host")
        full = np.concatenate([batch, parity], axis=1)
        er = (0, pc.k)
        got = pc.decode_planar(er, pc.to_planar(full)).to_batch()
        if not np.array_equal(got.cpu().numpy(), full[:, list(er), :]):
            raise AssertionError(f"{name}: planar decode {er} wrong")
        log(f"codec: {name} packetsize 2048 planar encode equals host "
            f"reference, decode {er} recovers the chunks")
    return worst


def phase_codec_cauchy(codec, rng):
    """cauchy_good k8m4 at 128 x 8 x 16 KiB = 16 MiB per step: planar
    encode/decode and the object encode/decode_concat, against the host
    reference.  Returns the step's data."""
    k, m, s = codec.k, codec.m, codec.w * codec.packetsize
    data = rng.integers(0, 256, (HEADLINE_STRIPES, k, s), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = codec.encode_planar(codec.to_planar(data)).to_batch()
    parity = parity.cpu().numpy()
    t_enc = time.perf_counter() - t0
    if not np.array_equal(parity, host_packet_parity(codec, data)):
        raise AssertionError("cauchy planar encode differs from host")
    log(f"codec: cauchy_good planar encode of {HEADLINE_STRIPES}x{k}x{s} B "
        f"equals the host reference (host clock incl. copies "
        f"{t_enc * 1e3:.3f} ms)")
    full = np.concatenate([data, parity], axis=1)
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        chunks = full.copy()
        chunks[:, list(er), :] = 0
        dec = codec.decode_planar(er, codec.to_planar(chunks))
        if not np.array_equal(dec.to_batch().cpu().numpy(),
                              full[:, list(er), :]):
            raise AssertionError(f"cauchy decode_planar {er} wrong")
        log(f"codec: cauchy_good decode_planar erasures {er} recovers the "
            "chunks")
    obj = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    enc = codec.encode(range(k + m), obj)
    chunk = len(enc[0])
    dchunks = np.stack([enc[i] for i in range(k)])[None]     # (1, k, chunk)
    if not np.array_equal(np.stack([enc[i] for i in range(k, k + m)]),
                          host_packet_parity(codec, dchunks)[0]):
        raise AssertionError("cauchy encode parity differs from host")
    for er in [(0,), (3, 10), (0, 5, 9, 11)]:
        avail = {i: c for i, c in enc.items() if i not in er}
        if codec.decode_concat(avail)[:len(obj)] != obj:
            raise AssertionError(f"cauchy decode_concat {er} wrong")
    log(f"codec: cauchy_good encode/decode_concat of a 4 MiB object "
        f"({chunk} B chunks) round-trips")
    return data


def phase_stripe_cauchy(codec):
    """One byte-at-rest OSD tick of the cauchy pool at StripeInfo(8,
    16384): coalesced encode (shards and CRCs against the host
    reference), decode with lost data shards and recovery rebuild."""
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c

    rng = np.random.default_rng(SEED + 4)
    k, n = codec.k, codec.get_chunk_count()
    sinfo = stripe.StripeInfo(k, codec.stripe_unit(4096))
    unit = sinfo.chunk_size
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in TICK_SIZES]
    res = stripe.encode_stripes_multi(codec, sinfo, datas,
                                      want_crcs=[True] * len(datas))
    by_len = {}
    for (shards, crcs), d in zip(res, datas):
        ns = sinfo.object_stripes(len(d))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        batch = buf.reshape(ns, k, unit)
        full = np.concatenate([batch, host_packet_parity(codec, batch)],
                              axis=1)
        want = full.transpose(1, 0, 2).reshape(n, ns * unit)
        if not np.array_equal(shards, want):
            raise AssertionError(f"cauchy shards differ for a {len(d)} B op")
        by_len.setdefault(shards.shape[1], []).append((shards, crcs))
    checked = 0
    for length, group in by_len.items():
        rows = np.vstack([sh for sh, _c in group])
        got = [c for _s, crcs in group for c in crcs]
        if got != crc32c.crc32c_rows(rows):      # host table path
            raise AssertionError(f"cauchy CRCs differ at length {length}")
        checked += len(rows)
    stripes = sum(sinfo.object_stripes(len(d)) for d in datas)
    log(f"stripe: cauchy_good tick at StripeInfo({k}, {unit}): {len(datas)} "
        f"ops, {stripes} stripes, shards equal the host reference, "
        f"{checked} shard CRCs equal host crc32c")
    for lost in [(3,), (0, 6)]:
        reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
                for (sh, _c), d in zip(res, datas)]
        if stripe.decode_stripes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"decode_stripes_multi lost {lost} wrong")
        log(f"stripe: cauchy_good decode_stripes_multi with data shards "
            f"{lost} lost returns the original bytes")
    lost = (1, 9)
    reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
            for (sh, _c), d in zip(res, datas)]
    for got, (sh, _c) in zip(stripe.reencode_stripes_multi(codec, sinfo,
                                                           reqs), res):
        if not np.array_equal(got, sh):
            raise AssertionError("reencode_stripes_multi shards differ")
    log(f"stripe: cauchy_good reencode_stripes_multi with shards {lost} "
        "lost rebuilds every shard")


def phase_default_profile_tick():
    """A small tick of Ceph's default pool profile (jerasure reed_sol_van
    k=2 m=1, bit-planar at rest) through the planar entry points."""
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.ec import planar_store as pstore
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import gf8

    codec = factory({})
    assert (codec.technique, codec.k, codec.m) == ("reed_sol_van", 2, 1)
    rng = np.random.default_rng(SEED + 5)
    sinfo = stripe.StripeInfo(2, codec.stripe_unit(4096))
    if not stripe.planar_at_rest_ok(codec, sinfo.chunk_size):
        raise AssertionError("default profile is not planar at rest")
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in [64 << 10] * 16 + [0, 5, 8192, 100000]]
    res = stripe.encode_planes_multi(codec, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    for (planes, _crcs), d in zip(res, datas):
        shards = pstore.planes_to_rows(planes.reshape(3 * 8, -1))
        ns = sinfo.object_stripes(len(d))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        rows = buf.reshape(ns, 2, sinfo.chunk_size).transpose(1, 0, 2) \
            .reshape(2, ns * sinfo.chunk_size)
        want = np.vstack([rows, gf8.gf_matmul_ref(codec.engine.coding, rows)])
        if not np.array_equal(shards, want):
            raise AssertionError("default-profile shards differ from host")
    for lost in [(0,), (1,)]:
        reqs = [({s: p[s] for s in range(3) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        if stripe.decode_planes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"default profile lost {lost} wrong")
    log(f"stripe: default profile jerasure reed_sol_van k2m1, "
        f"{len(datas)} ops through encode_planes_multi/decode_planes_multi "
        "round-trip with either data shard lost")


def b1_expected_path(rw: int, kw: int, npk: int) -> str:
    """The path B1's wrapper should pick for a fresh contiguous operand:
    staged for 16-byte rows whose lists fit the table, kept otherwise."""
    from ceph_tpu_torch.ops import gf8_cuda

    fits = gf8_cuda.list_bytes(rw, kw) <= gf8_cuda.TABLE_BYTES
    return "staged" if npk % 16 == 0 and fits else "kept"


def check_b1(name, bm, npk, rng):
    """B1 against its plain version on random planes at (bitmat, npk);
    asserts bit-exactness and the path the call took.  Max |diff|."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda

    rw, kw = (int(x) for x in bm.shape)
    planes = torch.from_numpy(
        rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
    kept = gf8_cuda.kept_launches
    got = gf8_cuda.planar_matmul(bm, planes)
    path = took_path(gf8_cuda, kept)
    want = gf8_cuda.planar_matmul_ref(bm, planes)
    torch.cuda.synchronize()
    diff = int((got.int() - want.int()).abs().max())
    if diff or not torch.equal(got, want):
        raise AssertionError(f"B1 differs from its plain version: {name}")
    if path != b1_expected_path(rw, kw, npk):
        raise AssertionError(f"B1 took the {path} path: {name}")
    log(f"kernel: B1 bit-exact, {name}, bitmat {(rw, kw)} x planes "
        f"{(kw, npk)}, {path} path (lists "
        f"{gf8_cuda.list_bytes(rw, kw)} B)")
    return diff


def tick_stripes(k: int, unit: int) -> int:
    return sum(-(-s // (k * unit)) for s in TICK_SIZES)


def phase_kernel_b1_codecs(shec, lrc, wide, rng):
    """B1 at the shapes the SHEC, LRC and wide-field paths give it, with
    the planes of one tick; returns max |diff|."""
    worst = 0
    npk = tick_stripes(8, 4096) * 4096 // 8          # SHEC at-rest planes
    worst = max(worst, check_b1("SHEC k8m4c3 encode", shec.engine._enc_bitmat,
                                npk, rng))
    for er, want in [((4,), (4,)), ((0, 1), (0, 1)), ((3, 9), (3,)),
                     ((0, 5, 11), (0, 5, 11))]:
        bm, src = shec._planar_decode_plan(er, want)
        worst = max(worst, check_b1(
            f"SHEC decode {er} want {want} ({len(src)} sources)", bm, npk,
            rng))
    npk = tick_stripes(4, 4096) * 4096 // 8
    worst = max(worst, check_b1("LRC k4m2l3 flattened encode",
                                lrc._flat_encode_bitmat(), npk, rng))
    bm, src = lrc._decode_plan_for((1,), (1,))
    worst = max(worst, check_b1(f"LRC local decode (1,) from {src}", bm, npk,
                                rng))
    for codec in wide:
        w = codec.w
        npk = tick_stripes(8, 4096) * 4096 // w
        name = f"reed_sol_van k8m4 w={w}"
        worst = max(worst, check_b1(f"{name} encode",
                                    codec.engine._enc_bitmat, npk, rng))
        for er in [(2,), (1, 4, 8, 11)]:
            src = tuple(i for i in range(12) if i not in er)[:8]
            worst = max(worst, check_b1(f"{name} decode {er}",
                                        codec.engine.decode_bitmat(src, er),
                                        npk, rng))
    return worst


def tick_datas(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in TICK_SIZES]


def relayout_bytes() -> int:
    from ceph_tpu_torch.utils.perf import KERNELS

    return KERNELS.dump()["device_kernels"].get("ec_planar_relayout_bytes", 0)


def phase_shec_tick(shec, shec_cpu):
    """One OSD tick of a SHEC k=8 m=4 c=3 pool with planes at rest, at
    StripeInfo(8, 4096): encode with CRCs, decode for erasures the plane
    engine solves and for erasures that relayout, and the recovery rebuild
    in the plane domain; every result against the original data or the
    at-rest planes, and against the port's plain version on the CPU."""
    from ceph_tpu_torch.ec import planar_store as pstore
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c, gf8

    sinfo = stripe.StripeInfo(8, shec.stripe_unit(4096))
    if not stripe.planar_at_rest_ok(shec, sinfo.chunk_size):
        raise AssertionError("SHEC k8m4c3 is not planar at rest")
    n = shec.get_chunk_count()
    datas = tick_datas(SEED + 8)
    res = stripe.encode_planes_multi(shec, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    cpu = stripe.encode_planes_multi(shec_cpu, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    for (planes, crcs), (cplanes, ccrcs), d in zip(res, cpu, datas):
        if not np.array_equal(planes, cplanes) or crcs != ccrcs:
            raise AssertionError("SHEC planes differ from the plain version")
        shards = pstore.planes_to_rows(planes.reshape(n * 8, -1))
        ns = sinfo.object_stripes(len(d))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        rows = buf.reshape(ns, 8, 4096).transpose(1, 0, 2).reshape(8, -1)
        want = np.vstack([rows, gf8.gf_matmul_ref(shec.engine.coding, rows)])
        if not np.array_equal(shards, want):
            raise AssertionError(f"SHEC shards differ for a {len(d)} B op")
        if crcs != crc32c.crc32c_rows(shards):
            raise AssertionError("SHEC shard CRCs differ from host crc32c")
    stripes = sum(sinfo.object_stripes(len(d)) for d in datas)
    log(f"stripe: SHEC k8m4c3 tick at StripeInfo(8, 4096): {len(datas)} ops, "
        f"{stripes} stripes, planes equal the host reference and the plain "
        "version, shard CRCs equal host crc32c")
    for lost, solved in [((3, 9), True), ((4,), False), ((0, 1), False)]:
        reqs = [({s: p[s] for s in range(n) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        before = relayout_bytes()
        got = stripe.decode_planes_multi(shec, sinfo, reqs)
        relayout = relayout_bytes() - before
        if got != datas:
            raise AssertionError(f"SHEC decode_planes_multi {lost} wrong")
        if (relayout == 0) != solved:
            raise AssertionError(f"SHEC decode {lost}: relayout {relayout} B")
        log(f"stripe: SHEC decode_planes_multi with shards {lost} lost "
            f"returns the original bytes ("
            + ("plane engine" if solved else f"relayout of {relayout} B")
            + ")")
    for lost, solved in [((4,), False), ((0, 5, 11), True)]:
        reqs = [({s: p[s] for s in range(n) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        before = relayout_bytes()
        got = stripe.reencode_planes_multi(shec, sinfo, reqs)
        relayout = relayout_bytes() - before
        plain = stripe.reencode_planes_multi(shec_cpu, sinfo, reqs)
        for g, c, (p, _c) in zip(got, plain, res):
            if not (np.array_equal(g, p) and np.array_equal(g, c)):
                raise AssertionError(f"SHEC reencode_planes_multi {lost}")
        if (relayout == 0) != solved:
            raise AssertionError(f"SHEC reencode {lost}: relayout {relayout}")
        log(f"stripe: SHEC reencode_planes_multi with shards {lost} lost "
            "rebuilds the at-rest planes, equal to the plain version ("
            + ("plane engine" if solved else f"relayout of {relayout} B")
            + ")")


def byte_tick(codec, codec_cpu, sinfo, datas, label, lost_sets, rebuild):
    """The byte-at-rest tick of a pool: coalesced encode with CRCs,
    decode with lost shards and the recovery rebuild, each against the
    port's plain version on the CPU (and the original bytes)."""
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c

    n = codec.get_chunk_count()
    flags = [True] * len(datas)
    res = stripe.encode_stripes_multi(codec, sinfo, datas, want_crcs=flags)
    cpu = stripe.encode_stripes_multi(codec_cpu, sinfo, datas,
                                      want_crcs=flags)
    for (sh, crcs), (csh, ccrcs) in zip(res, cpu):
        if not np.array_equal(sh, csh) or crcs != ccrcs:
            raise AssertionError(f"{label}: shards differ from plain version")
        if crcs != crc32c.crc32c_rows(sh):
            raise AssertionError(f"{label}: shard CRCs differ from host")
    stripes = sum(sinfo.object_stripes(len(d)) for d in datas)
    log(f"stripe: {label} tick at StripeInfo({sinfo.k}, {sinfo.chunk_size}): "
        f"{len(datas)} ops, {stripes} stripes, shards and CRCs equal the "
        "plain version on the CPU")
    for lost in lost_sets:
        reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
                for (sh, _c), d in zip(res, datas)]
        if stripe.decode_stripes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"{label}: decode_stripes_multi {lost}")
        log(f"stripe: {label} decode_stripes_multi with shards {lost} lost "
            "returns the original bytes")
    reqs = [({s: sh[s] for s in range(n) if s not in rebuild}, len(d))
            for (sh, _c), d in zip(res, datas)]
    for got, (sh, _c) in zip(stripe.reencode_stripes_multi(codec, sinfo,
                                                           reqs), res):
        if not np.array_equal(got, sh):
            raise AssertionError(f"{label}: reencode_stripes_multi differs")
    log(f"stripe: {label} reencode_stripes_multi with shards {rebuild} lost "
        "rebuilds every shard")


def phase_lrc_tick(lrc, lrc_cpu):
    """One byte-at-rest tick of an LRC k=4 m=2 l=3 pool (8 chunks in 3
    layers) at StripeInfo(4, 4096): one local loss, which reads only its
    l+1 group, a loss in each group, and a recovery rebuild."""
    from ceph_tpu_torch.ec import stripe

    sinfo = stripe.StripeInfo(4, lrc.stripe_unit(4096))
    byte_tick(lrc, lrc_cpu, sinfo, tick_datas(SEED + 9), "LRC k4m2l3",
              [(1,), (1, 2)], (0, 6))
    _bm, src = lrc._decode_plan_for((1,), (1,))
    if len(src) != 3 or set(src) != {0, 4, 5}:
        raise AssertionError(f"LRC local loss of chunk 1 reads {src}")
    log(f"stripe: LRC single loss of chunk 1 gathers only chunks {src}, "
        "the rest of its local group")


def phase_wide_codec(codec, codec_cpu, rng):
    """reed_sol_van k8m4 at w=16 or 32: codec encode and decode on the
    byte layout (torch matmul on bits) and the bitpack planes (B1), equal
    to each other and to the plain version, and the object
    encode/decode_concat."""
    w = codec.w
    label = f"reed_sol_van k8m4 w={w}"
    data = rng.integers(0, 256, (64, 8, 4096), dtype=np.uint8)
    byte_par = codec.encode_batch(data).cpu().numpy()
    planar_par = codec.encode_planar(codec.to_planar(data)).to_batch()
    if not np.array_equal(planar_par.cpu().numpy(), byte_par):
        raise AssertionError(f"{label}: planar and byte parity differ")
    if not np.array_equal(byte_par, codec_cpu.encode_planar(
            codec_cpu.to_planar(data)).to_batch().numpy()):
        raise AssertionError(f"{label}: parity differs from plain version")
    full = np.concatenate([data, byte_par], axis=1)
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        chunks = full.copy()
        chunks[:, list(er), :] = 0
        dec_b = codec.decode_batch(er, chunks).cpu().numpy()
        dec_p = codec.decode_planar(er, codec.to_planar(chunks)).to_batch()
        if not (np.array_equal(dec_b, full[:, list(er), :])
                and np.array_equal(dec_p.cpu().numpy(), dec_b)):
            raise AssertionError(f"{label}: decode {er} wrong")
    obj = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    enc = codec.encode(range(12), obj)
    cenc = codec_cpu.encode(range(12), obj)
    if any(not np.array_equal(enc[i], cenc[i]) for i in range(12)):
        raise AssertionError(f"{label}: encode differs from plain version")
    avail = {i: c for i, c in enc.items() if i not in (0, 5, 9, 11)}
    if codec.decode_concat(avail)[:len(obj)] != obj:
        raise AssertionError(f"{label}: decode_concat wrong")
    log(f"codec: {label} byte and planar encode/decode of 64x8x4096 B "
        "agree with each other and the plain version; a 1 MiB object "
        "round-trips")


def phase_wide_tick(codec, codec_cpu):
    from ceph_tpu_torch.ec import stripe

    sinfo = stripe.StripeInfo(8, codec.stripe_unit(4096))
    byte_tick(codec, codec_cpu, sinfo, tick_datas(SEED + 10 + codec.w),
              f"reed_sol_van k8m4 w={codec.w}", [(3,), (0, 6, 9, 11)],
              (1, 9))


def phase_one_launch(codec, data):
    """One warm cauchy ``encode_planar`` call under torch.profiler: exactly
    one device kernel, B2's staged kernel, and no ``pack_blocks_kernel``
    (the codec passes its cached host-packed table)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pb = codec.to_planar(torch.from_numpy(data).cuda())
    codec.encode_planar(pb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        codec.encode_planar(pb)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    log(f"one launch: a cauchy encode_planar call ran {len(names)} device "
        f"kernel(s): {names}")
    if len(names) != 1 or "BytesPolicy" not in names[0] \
            or any("pack_blocks" in nm for nm in names):
        raise AssertionError("a cauchy encode_planar call is not one launch "
                             f"of B2's staged kernel: {names}")


def _bound(nbytes: int, xors: float):
    """(bound ms, "bytes" or "operations") for a kernel call that must
    move ``nbytes`` and do ``xors`` 32-bit XORs."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = xors / OPS_32BIT_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), bytes_ms, ops_ms


def time_encode_step(codec, data, flush, label: str, card: str) -> float:
    """The encode step of one path on device-resident data, split into
    to_planar, encode_planar and to_batch; returns the step's ms."""
    import torch

    data_dev = torch.from_numpy(data).cuda()
    enc_ms = cuda_median_ms(
        lambda: codec.encode_planar(codec.to_planar(data_dev)).to_batch(), 10,
        flush, STEP_SPIN_CYCLES)
    pb = codec.to_planar(data_dev)
    enc_planar_ms = cuda_median_ms(lambda: codec.encode_planar(pb), 20, flush)
    to_planar_ms = cuda_median_ms(lambda: codec.to_planar(data_dev), 10, flush,
                                  STEP_SPIN_CYCLES)
    par = codec.encode_planar(pb)
    to_batch_ms = cuda_median_ms(
        lambda: par.with_planes(par.planes).to_batch(), 10, flush,
        STEP_SPIN_CYCLES)
    step_bytes = data.size
    log(f"timing: {label} encode step (to_planar + encode_planar + to_batch,"
        f" device-resident {step_bytes} B) {enc_ms:.6f} ms = "
        f"{step_bytes / enc_ms / 1e6:.3f} GB/s; encode_planar alone "
        f"{enc_planar_ms:.6f} ms = {step_bytes / enc_planar_ms / 1e6:.3f} GB/s;"
        f" to_planar alone {to_planar_ms:.6f} ms; parity to_batch alone "
        f"{to_batch_ms:.6f} ms [{card}]")
    return enc_ms


class CleanL2Flush:
    """An L2 flush that leaves the cache clean: it writes 256 MiB, then
    reads 128 MiB, so the timed call finds no dirty lines of the flush to
    write back.  (The plain flush, ``zero_`` of 256 MiB, leaves the L2
    full of dirty lines, and every call timed after it pays for writing
    back as many as its own traffic evicts.)"""

    def __init__(self):
        import torch

        self.dirty = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.clean = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")

    def zero_(self):
        self.dirty.zero_()
        self.clean.max()


def phase_clean_l2(isa, cauchy, card: str):
    """The yardstick, B1 and B2 at their headline shapes again, timed after
    the clean flush."""
    import torch

    from ceph_tpu_torch.ops import gf8_bytes_cuda, gf8_cuda

    rng = np.random.default_rng(SEED + 7)
    a = torch.from_numpy(
        rng.integers(0, 256, (64, 262144), dtype=np.uint8)).cuda()
    o = torch.empty((32, 262144), dtype=torch.uint8, device="cuda")
    lane, blocks = cauchy._lane_and_blocks(cauchy._encode_bits())
    bm = isa.engine._enc_bitmat
    flush = CleanL2Flush()
    yard = cuda_median_ms(lambda: torch.bitwise_xor(a[:32], a[32:], out=o),
                          50, flush)
    b1 = cuda_median_ms(lambda: gf8_cuda.planar_matmul(bm, a), 50, flush)
    b2 = cuda_median_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul(lane, a, blocks), 50, flush)
    log(f"timing: after a flush that leaves the L2 clean: yardstick "
        f"{yard:.6f} ms, B1 {b1:.6f} ms, B2 {b2:.6f} ms [{card}]")


def phase_yardstick(card: str) -> float:
    """The same traffic as B1 and B2 at their headline shapes, by one
    PyTorch call: ``torch.bitwise_xor`` of the two (32, 262144) halves of
    a (64, 262144) uint8 tensor into (32, 262144), 16 MiB read and 8 MiB
    written; not the kernels' function, only what bandwidth the card
    reaches for this traffic."""
    import torch

    rng = np.random.default_rng(SEED + 6)
    a = torch.from_numpy(
        rng.integers(0, 256, (64, 262144), dtype=np.uint8)).cuda()
    o = torch.empty((32, 262144), dtype=torch.uint8, device="cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_median_ms(lambda: torch.bitwise_xor(a[:32], a[32:], out=o), 50,
                        flush)
    nbytes = 3 * o.numel()
    log(f"timing: same-traffic yardstick, torch.bitwise_xor (64x262144 ->"
        f" 32x262144 uint8, {nbytes} bytes) median {ms:.6f} ms = "
        f"{nbytes / ms / 1e6:.3f} GB/s [{card}]")
    return ms


def phase_timing(codec, data, card: str, yard_ms: float):
    """B1 at the ISA headline shape, and the ISA encode step; returns the
    kernel's numbers."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda

    rng = np.random.default_rng(SEED + 2)
    bm = codec.engine._enc_bitmat
    rw, kw = (int(x) for x in bm.shape)
    npk = 4096 * 512 // 8                # packed columns of one step
    planes = torch.from_numpy(
        rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_median_ms(lambda: gf8_cuda.planar_matmul(bm, planes), 50, flush)
    plain_ms = cuda_median_ms(
        lambda: gf8_cuda.planar_matmul_ref(bm, planes), 10, flush)
    dev_ms = profiled_kernel_ms(lambda: gf8_cuda.planar_matmul(bm, planes),
                                "PlanarPolicy", 30, flush)
    nbytes = kw * npk + rw * npk + rw * kw
    xors = int(bm.sum().item()) * npk / 4        # 32-bit XORs
    bound_ms, bound_by, bytes_ms, ops_ms = _bound(nbytes, xors)
    log(f"timing: B1 headline ({rw}x{kw} x {kw}x{npk}) median {ms:.6f} ms, "
        f"plain version {plain_ms:.6f} ms, bound {bound_ms:.6f} ms"
        f" ({nbytes} bytes -> {bytes_ms:.6f} ms; {xors:.0f} XORs -> "
        f"{ops_ms:.6f} ms), {100 * bound_ms / ms:.1f} % of the bound; "
        f"same-traffic yardstick {yard_ms:.6f} ms; profiler device time of "
        "the kernel alone "
        + ("not measured" if dev_ms is None else f"{dev_ms:.6f} ms")
        + f" [{card}]")
    time_encode_step(codec, data, flush, "ISA k8m4", card)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_timing_b1_shapes(shapes, card: str):
    """B1 at the w=16, w=32 and SHEC encode shapes with 16 MiB of input
    planes each, L2 flushed as in phase_timing; returns one dict per
    shape."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda

    rng = np.random.default_rng(SEED + 11)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for label, bm in shapes:
        rw, kw = (int(x) for x in bm.shape)
        npk = (16 << 20) // kw
        planes = torch.from_numpy(
            rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
        path = b1_expected_path(rw, kw, npk)
        ms = cuda_median_ms(lambda: gf8_cuda.planar_matmul(bm, planes), 50,
                            flush)
        plain_ms = cuda_median_ms(
            lambda: gf8_cuda.planar_matmul_ref(bm, planes), 5, flush)
        nbytes = kw * npk + rw * npk + rw * kw
        bits = int(bm.sum().item())
        xors = bits * npk / 4
        bound_ms, bound_by, bytes_ms, ops_ms = _bound(nbytes, xors)
        log(f"timing: B1 {label} ({rw}x{kw} x {kw}x{npk}, {bits} set bits, "
            f"{path} path) median {ms:.6f} ms, plain version "
            f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({nbytes} bytes -> "
            f"{bytes_ms:.6f} ms; {xors:.0f} XORs -> {ops_ms:.6f} ms), "
            f"{100 * bound_ms / ms:.1f} % of the bound [{card}]")
        out.append({"shape": label, "path": path, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
    return out


def phase_timing_b2(codec, data, card: str, yard_ms: float):
    """B2 at the cauchy headline lane shape, as the codec calls it (with
    its host-packed table), and the cauchy encode step; returns the
    kernel's numbers."""
    import torch

    from ceph_tpu_torch.ops import gf8_bytes_cuda

    rng = np.random.default_rng(SEED + 3)
    m01 = codec._encode_bits()
    lane, blocks = codec._lane_and_blocks(m01)
    rw, kw = (int(x) for x in lane.shape)
    n = HEADLINE_STRIPES * codec.packetsize   # packet-row bytes of one step
    rows = torch.from_numpy(
        rng.integers(0, 256, (kw // 8, n), dtype=np.uint8)).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_median_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul(lane, rows, blocks), 50,
        flush)
    plain_ms = cuda_median_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul_ref(lane, rows), 10, flush)
    dev_ms = profiled_kernel_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul(lane, rows, blocks),
        "BytesPolicy", 30, flush)
    # the table is r*k block words and class entries, read once
    nbytes = (kw // 8) * n + (rw // 8) * n + int(blocks.numel()) * 8
    xors = int(m01.sum()) * n / 4                # 32-bit XORs of whole rows
    bound_ms, bound_by, bytes_ms, ops_ms = _bound(nbytes, xors)
    log(f"timing: B2 headline lane ({rw}x{kw} x {kw // 8}x{n}, host table) "
        f"median {ms:.6f} ms, plain version {plain_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({nbytes} bytes -> {bytes_ms:.6f} ms; "
        f"{xors:.0f} XORs -> {ops_ms:.6f} ms), "
        f"{100 * bound_ms / ms:.1f} % of the bound; same-traffic yardstick "
        f"{yard_ms:.6f} ms; profiler device time of the kernel alone "
        + ("not measured" if dev_ms is None else f"{dev_ms:.6f} ms")
        + f" [{card}]")
    time_encode_step(codec, data, flush, "cauchy_good k8m4 packetsize 2048",
                     card)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# -- placement: CRUSH and the OSDMap placement pipeline ----------------------

# bench_map's map (ceph_tpu/crush/__init__.py): root -> 39 racks -> 16
# hosts -> 16 osds, straw2 buckets and optimal tunables, 9,984 OSDs
RACKS, HOSTS_PER_RACK, OSDS_PER_HOST = 39, 16, 16
PLACEMENT_PGS = 1 << 20
LRC_PGS = CHOOSE_ARGS_PGS = 1 << 16
# PGs of (a) checked against the mapper on the CPU, and scalar rows a
# sampled check takes: sized so the script stays near half its limit
CPU_CHECK_PGS = 1 << 14
BENCH_PGS = 1_000_000
SAMPLE = 1000
# timed calls a placement entry point's wall median takes (the time
# limit again)
PLACEMENT_REPS = 1
LRC_RULE_PROFILE = {**LRC_PROFILE, "crush-locality": "rack",
                    "crush-failure-domain": "host"}


def host_of(osd):
    return osd // OSDS_PER_HOST


def rack_of(osd):
    return osd // (OSDS_PER_HOST * HOSTS_PER_RACK)


def placement_maps():
    """The replicated pool (a), the LRC pool (b) and the balancer weight
    set (c) on bench_map's map, and the second map of the rebalance:
    one host's 16 OSDs marked out and one further OSD marked down."""
    import copy

    from ceph_tpu_torch.crush.types import ChooseArg, build_three_level
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.osdmap.osdmap import (POOL_TYPE_ERASURE, OSDMap,
                                              PGPool)

    cmap, rule = build_three_level(RACKS, HOSTS_PER_RACK, OSDS_PER_HOST,
                                   numrep=3)
    lrc = factory(LRC_RULE_PROFILE)
    lrc_rule = lrc.create_rule("lrc_k4m2l3", cmap)
    c1 = c1_rule(cmap)
    root = min(cmap.buckets)
    rack_w = cmap.buckets[root].weights
    rng = np.random.default_rng(SEED + 20)
    cmap.choose_args["balancer"] = {root: ChooseArg(weight_set=[
        [int(w * f) for w, f in zip(rack_w, rng.uniform(0.5, 1.5, RACKS))]
        for _ in range(3)])}
    m = OSDMap(cmap)
    m.add_pool(PGPool(pool_id=1, size=3, min_size=2, pg_num=PLACEMENT_PGS,
                      pgp_num=PLACEMENT_PGS, crush_rule=rule, name="rbd"))
    m.add_pool(PGPool(pool_id=2, type=POOL_TYPE_ERASURE,
                      size=lrc.get_chunk_count(), min_size=5, pg_num=LRC_PGS,
                      pgp_num=LRC_PGS, crush_rule=lrc_rule, name="lrc",
                      ec_profile=dict(LRC_RULE_PROFILE)))
    m2 = copy.deepcopy(m)
    out_host = int(rng.integers(0, RACKS * HOSTS_PER_RACK))
    for osd in range(out_host * OSDS_PER_HOST,
                     (out_host + 1) * OSDS_PER_HOST):
        m2.mark_out(osd)
    down = int((out_host + 1) * OSDS_PER_HOST + rng.integers(0, 64))
    m2.mark_down(down)
    log(f"placement: {cmap.max_devices} OSDs, {len(cmap.buckets)} buckets "
        f"(max depth {cmap.max_depth()}); pool 1 replicated size 3 "
        f"pg_num {PLACEMENT_PGS} (rule {cmap.rules[rule].steps}); pool 2 "
        f"LRC k4m2l3 size {lrc.get_chunk_count()} pg_num {LRC_PGS} (rule "
        f"{cmap.rules[lrc_rule].steps}); rebalance: host {out_host} out, "
        f"osd {down} down; C1 rule {cmap.rules[c1].steps}")
    return m, m2, rule, c1


def phase_placement(m, m2, rule):
    """The placement main path on the card: (a) the whole
    replicated pool and its rebalance diff, (b) the LRC pool, (c) the
    replicated rule under the balancer weight set."""
    import torch

    up, upp = m.pool_mapping(1)
    moved, frac = m.rebalance_diff(1, m2)
    lrc_up, lrc_upp = m.pool_mapping(2)
    pps = m.pools[1].raw_pg_to_pps_batch(
        np.arange(CHOOSE_ARGS_PGS, dtype=np.uint32))
    weights = np.asarray(m.osd_weight, dtype=np.uint32)
    ca_res, ca_len = m.tensor_mapper.do_rule_batch(
        rule, pps, 3, weights, choose_args="balancer")
    torch.cuda.synchronize()
    if m.tensor_mapper.device.type != "cuda" or \
            m2.tensor_mapper.device.type != "cuda":
        raise AssertionError("placement did not run on the card")
    log(f"placement: rebalance_diff moved {len(moved)} of {PLACEMENT_PGS} "
        f"PGs ({frac:.6f})")
    return {"up": up, "upp": upp, "moved": moved, "frac": frac,
            "lrc_up": lrc_up, "lrc_upp": lrc_upp, "pps": pps,
            "ca_res": ca_res.cpu().numpy(), "ca_len": ca_len.cpu().numpy()}


def scalar_row(m, pool_id, seed):
    """The full scalar chain's up set (padded as pool_mapping pads it) and
    up primary for one PG."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osdmap.osdmap import PGid

    u, p, _a, _ap = m.pg_to_up_acting_osds(PGid(pool_id, seed))
    return list(u) + [CRUSH_ITEM_NONE] * (m.pools[pool_id].size - len(u)), p


_SCALAR_MAPS = None


def _scalar_rows_init(blobs) -> None:
    global _SCALAR_MAPS
    _SCALAR_MAPS = {k: pickle.loads(b) for k, b in blobs.items()}


def _scalar_rows(args):
    from ceph_tpu_torch.osdmap.osdmap import PGid

    key, pool_id, seeds, raw = args
    m = _SCALAR_MAPS[key]
    if raw:
        return [m.pg_raw_up(PGid(pool_id, s)) for s in seeds]
    return [scalar_row(m, pool_id, s) for s in seeds]


def scalar_row_jobs(blobs, jobs, raw: bool = False):
    """One scalar row a seed of every (map key, pool, seeds) job, the
    pickled maps in ``blobs``: the full chain's ``scalar_row``, or
    ``pg_raw_up`` with ``raw``.  Spread over the host's cores (the
    scalar chain takes milliseconds a PG where tries run out) by a pool
    of spawned workers that ends with the call; {(key, pool): {seed:
    row}}."""
    import multiprocessing
    import os

    n = max(1, min(8, os.cpu_count() or 1))
    tasks = [(key, pid, chunk.tolist(), raw) for key, pid, seeds in jobs
             for chunk in np.array_split(np.asarray(seeds),
                                         max(1, min(len(seeds), 4 * n)))]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n, initializer=_scalar_rows_init,
                  initargs=(blobs,)) as workers:
        parts = workers.map(_scalar_rows, tasks)
    out = {}
    for (key, pid, seeds, _raw), rows in zip(tasks, parts):
        out.setdefault((key, pid), {}).update(zip(seeds, rows))
    return out


def scalar_rows(m, pool_id, seeds):
    """``scalar_row`` for every seed of one pool of ``m``."""
    rows = scalar_row_jobs({0: pickle.dumps(m)}, [(0, pool_id, seeds)])
    return [rows[(0, pool_id)][int(s)] for s in seeds]


def check_placement(m, m2, rule, got):
    """Every check of the placement path, each a hard failure."""
    from ceph_tpu_torch.crush import ScalarMapper
    from ceph_tpu_torch.crush.mapper import TensorMapper
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    for mp in (m, m2):
        if mp.scalar_fallbacks:
            raise AssertionError("a pool mapped on the scalar path")
    up, lrc_up = got["up"], got["lrc_up"]
    # (a) with every OSD up and in: three OSDs on three hosts per PG
    if (up == CRUSH_ITEM_NONE).any():
        raise AssertionError("a replicated PG has fewer than 3 OSDs")
    hosts = np.sort(host_of(up), axis=1)
    if ((hosts[:, 1:] == hosts[:, :-1]).any()):
        raise AssertionError("a replicated PG has two OSDs on one host")
    # (b) eight OSDs on eight hosts, four in each of two racks
    if (lrc_up == CRUSH_ITEM_NONE).any():
        raise AssertionError("an LRC PG has fewer than 8 OSDs")
    lh = np.sort(host_of(lrc_up), axis=1)
    racks = rack_of(lrc_up)
    if (lh[:, 1:] == lh[:, :-1]).any() or \
            (racks[:, :4] != racks[:, :1]).any() or \
            (racks[:, 4:] != racks[:, 4:5]).any() or \
            (racks[:, 0] == racks[:, 4]).any():
        raise AssertionError("an LRC PG is not 4+4 hosts in two racks")
    # (c) three OSDs on three hosts per PG
    ca_res, ca_len = got["ca_res"], got["ca_len"]
    ca_hosts = np.sort(host_of(ca_res), axis=1)
    if (ca_len != 3).any() or (ca_hosts[:, 1:] == ca_hosts[:, :-1]).any():
        raise AssertionError("a choose_args PG is short or shares a host")
    # samples against the scalar chain
    for label, pool_id, rows, prim in (("replicated", 1, up, got["upp"]),
                                       ("LRC", 2, lrc_up, got["lrc_upp"])):
        seeds = rng.choice(m.pools[pool_id].pg_num, SAMPLE, replace=False)
        for s in seeds:
            want, p = scalar_row(m, pool_id, int(s))
            if rows[s].tolist() != want or int(prim[s]) != p:
                raise AssertionError(
                    f"{label} PG {s}: card {rows[s].tolist()} "
                    f"{int(prim[s])}, scalar chain {want} {p}")
    sm = ScalarMapper(m.crush)
    weights = list(m.osd_weight)
    for i in rng.choice(CHOOSE_ARGS_PGS, SAMPLE, replace=False):
        want = sm.do_rule(rule, int(got["pps"][i]), 3, weights,
                          choose_args="balancer")
        if ca_res[i, :ca_len[i]].tolist() != want:
            raise AssertionError(f"choose_args PG {i} differs from scalar")
    moved = set(got["moved"].tolist())
    for s in rng.choice(PLACEMENT_PGS, SAMPLE, replace=False):
        s = int(s)
        if (scalar_row(m, 1, s)[0] != scalar_row(m2, 1, s)[0]) != \
                (s in moved):
            raise AssertionError(f"rebalance_diff wrong about PG {s}")
    # the first PGs against the port's mapper on the CPU
    cpu = TensorMapper(m.crush, device="cpu")
    card = m.tensor_mapper
    weights = np.asarray(m.osd_weight, dtype=np.uint32)
    pps = got["pps"][:CPU_CHECK_PGS]
    c_res, c_len = cpu.do_rule_batch(rule, pps, 3, weights)
    g_res, g_len = card.do_rule_batch(rule, pps, 3, weights)
    if not (np.array_equal(c_res.numpy(), g_res.cpu().numpy())
            and np.array_equal(c_len.numpy(), g_len.cpu().numpy())
            and np.array_equal(c_res.numpy(), up[:CPU_CHECK_PGS])):
        raise AssertionError("the card's placement differs from the CPU's")
    log(f"placement: checks pass in {time.perf_counter() - t0:.3f} s: "
        f"{SAMPLE} PGs each of the replicated pool, the LRC pool, the "
        f"choose_args batch and the rebalance diff equal the scalar chain; "
        f"the first {CPU_CHECK_PGS} PGs equal TensorMapper(device='cpu'); "
        "every PG on distinct hosts (LRC: 4+4 in two racks)")


# C1 (a chooseleaf indep type-0 slot that runs out of tries keeps its
# last out device): the OSDMap repro's shape, where it fires on every PG,
# and the same rule as an erasure pool of the 9,984-OSD map
C1_SMALL_PGS = 16_384
# the repro's PGs held to the scalar chain: a seeded sample (every PG of
# the repro keeps an out OSD on the card alike)
C1_SMALL_CHECK = 4096
C1_PGS = 1 << 16
C1_SIZE = 7
# the balancer scorer round: a replicated size-3 pool on the 9,984-OSD
# map with the mgr's defaults (ceph_tpu/utils/config.py:233-238), and the
# card against device="cpu" on a 1,024-OSD map
SCORER_PGS = 1 << 16
SCORER_MOVES = 16
SCORER_DEVIATION = 0.05
SCORER_SAMPLE = 1_000_000
SMALL_SCORER_MAP = (4, 16, 16)
SMALL_SCORER_PGS = 8192


def c1_rule(cmap) -> int:
    """ROADMAP §C1's rule: ``chooseleaf indep 0 type 0`` from the root,
    with 5 leaf tries and 100 tries."""
    from ceph_tpu_torch.crush import Rule
    from ceph_tpu_torch.crush.types import (RULE_CHOOSELEAF_INDEP,
                                            RULE_EMIT,
                                            RULE_SET_CHOOSE_TRIES,
                                            RULE_SET_CHOOSELEAF_TRIES,
                                            RULE_TAKE)

    return cmap.add_rule(Rule(steps=[
        (RULE_SET_CHOOSELEAF_TRIES, 5, 0), (RULE_SET_CHOOSE_TRIES, 100, 0),
        (RULE_TAKE, min(cmap.buckets), 0), (RULE_CHOOSELEAF_INDEP, 0, 0),
        (RULE_EMIT, 0, 0)]))


def phase_c1(m2, big_rule):
    """C1 on the card: (a) ROADMAP's OSDMap repro at 16,384 PGs,
    ``C1_SMALL_CHECK`` sampled PGs against the scalar chain; (b) the same
    rule as an erasure pool of the 9,984-OSD map with one host out
    (``m2``), sampled PGs against the scalar chain; both in one pool of
    workers.  Returns the PGs of (a) and (b) with an out OSD in their up
    set."""
    import torch

    from ceph_tpu_torch.osdmap.osdmap import (POOL_TYPE_ERASURE, PGPool,
                                              build_simple_osdmap)

    t0 = time.perf_counter()
    small = build_simple_osdmap(8, 4, C1_SMALL_PGS, POOL_TYPE_ERASURE,
                                C1_SIZE)
    small.pools[1].crush_rule = c1_rule(small.crush)
    small.mark_out(1)
    small.mark_out(5)
    up, upp = small.pool_mapping(1)
    m2.add_pool(PGPool(pool_id=3, type=POOL_TYPE_ERASURE, size=C1_SIZE,
                       min_size=5, pg_num=C1_PGS, pgp_num=C1_PGS,
                       crush_rule=big_rule, name="c1"))
    big_up, big_upp = m2.pool_mapping(3)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for mp in (small, m2):
        if mp.tensor_mapper.device.type != "cuda" or mp.scalar_fallbacks:
            raise AssertionError("C1 placement did not run on the card")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    checks = (("C1 repro", 0, 1, up, upp,
               rng.choice(C1_SMALL_PGS, C1_SMALL_CHECK, replace=False)),
              ("C1 pool", 1, 3, big_up, big_upp,
               rng.choice(C1_PGS, SAMPLE, replace=False)))
    got = scalar_row_jobs({0: pickle.dumps(small), 1: pickle.dumps(m2)},
                          [(key, pid, seeds)
                           for _l, key, pid, _r, _p, seeds in checks])
    for label, key, pool_id, rows, prim, seeds in checks:
        for s in seeds:
            want, p = got[(key, pool_id)][int(s)]
            if rows[s].tolist() != want or int(prim[s]) != p:
                raise AssertionError(
                    f"{label} PG {s}: card {rows[s].tolist()} "
                    f"{int(prim[s])}, scalar chain {want} {p}")
    out_small = int(np.isin(up, [1, 5]).any(axis=1).sum())
    out_big = np.flatnonzero(np.asarray(m2.osd_weight) == 0)
    out_big = int(np.isin(big_up, out_big).any(axis=1).sum())
    log(f"C1: repro pool ({C1_SMALL_PGS} PGs, size {C1_SIZE}, 8 OSDs, "
        f"OSDs 1 and 5 out): {C1_SMALL_CHECK} sampled PGs equal the "
        f"scalar chain, "
        f"{out_small} PGs keep an out OSD; 9,984-OSD pool ({C1_PGS} PGs, "
        f"one host out): {SAMPLE} sampled PGs equal the scalar chain, "
        f"{out_big} PGs keep an out OSD; card {card_s:.3f} s, checks "
        f"{time.perf_counter() - t0:.3f} s")
    return out_small, out_big


def energy(stats) -> float:
    """The balance energy the scorer descends: sum((count - target)^2)."""
    return float(np.sum((stats.counts - stats.target) ** 2))


def scorer_map(cmap, rule, pg_num, device=None):
    from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGPool

    m = OSDMap(cmap, device=device)
    m.add_pool(PGPool(pool_id=4, size=3, min_size=2, pg_num=pg_num,
                      pgp_num=pg_num, crush_rule=rule, name="balance"))
    return m


def phase_scorer(cmap, rule, reset_counts):
    """The scorer round on the card: ``calc_pg_upmaps_vectorized`` with the
    mgr's defaults on a replicated pool of the 9,984-OSD map, counted
    from 0 just before and read just after.  Returns what the checks
    need."""
    import copy

    import torch

    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.utils.perf import KERNELS

    m = scorer_map(cmap, rule, SCORER_PGS)
    split = copy.deepcopy(m)
    before = scorer.deviation_stats(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    changes, scored = scorer.calc_pg_upmaps_vectorized(
        m, max_deviation_ratio=SCORER_DEVIATION, max_moves=SCORER_MOVES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = KERNELS.dump()["device_kernels"]
    peak = torch.cuda.max_memory_allocated()
    log(f"main path (balance scorer): counters "
        f"{json.dumps(counts, sort_keys=True)}")
    if m.tensor_mapper.device.type != "cuda":
        raise AssertionError("the scorer round did not run on the card")
    n = counts.get("balance_candidates_scored", 0)
    if n < 1000 or n != scored or counts.get("balance_score_calls", 0) < 1:
        raise AssertionError(f"the scorer round counted {n} candidates "
                             f"({scored} reported)")
    log(f"scorer: round on {cmap.max_devices} OSDs, pool of {SCORER_PGS} "
        f"PGs: {n} candidates scored in "
        f"{counts['balance_score_calls']} call(s), "
        f"{sum(len(v) for v in changes.values())} moves, wall "
        f"{wall * 1e3:.3f} ms, peak device memory {peak / 2**30:.3f} GiB")
    return m, split, before, changes, scored


def check_scorer(m, split, before, changes, rule, card: str):
    """The scorer round's checks, and its split on a fresh copy of the
    map: measurement, enumeration, scoring, sort and pick, each ended by
    a synchronise; the device scores of sampled candidates against the
    plain float64 formula, bit for bit."""
    import torch

    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.osdmap.balancer import _failure_domains

    moves = [(pg.seed, s, d) for pg, v in changes.items() for s, d in v]
    if not 0 < len(moves) <= SCORER_MOVES or \
            any(len(v) != 1 for v in changes.values()):
        raise AssertionError(f"the round made {len(moves)} moves: {changes}")
    dom = _failure_domains(m, rule)
    up0 = before.placements[4]
    for seed, src, dst in moves:
        members = [int(o) for o in up0[seed]]
        others = {dom[o] for o in members if o != src}
        if src not in members or dst in members or dom[dst] in others:
            raise AssertionError(f"illegal move of PG {seed}: {src}->{dst}"
                                 f" with members {members}")
    after = scorer.deviation_stats(m)
    e0, e1 = energy(before), energy(after)
    if not e1 < e0:
        raise AssertionError(f"the moves did not lower the energy: {e0} "
                             f"-> {e1}")
    log(f"scorer: {len(moves)} legal moves, one per PG; sum((count - "
        f"target)^2) {e0:.6f} -> {e1:.6f} under a fresh pool_mapping")

    sync = torch.cuda.synchronize
    times = {}

    def timed(label, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[label] = time.perf_counter() - t0
        return out

    st = timed("measurement", lambda: scorer.deviation_stats(split))
    domains = {4: _failure_domains(split, rule)}
    cand = timed("enumeration", lambda: scorer.generate_candidates(
        split, st, domains, SCORER_DEVIATION))
    scores = timed("scoring", lambda: scorer.score_candidates(st, cand))
    timed("sort alone", lambda: scorer.sorted_order(scores))
    picked = timed("pick (its sort and walk)",
                   lambda: scorer._pick_moves(st, cand, scores,
                                              SCORER_MOVES))
    if picked != [(pg.pool, pg.seed, s, d) for pg, v in changes.items()
                  for s, d in v]:
        raise AssertionError("the split run picked other moves")
    if not isinstance(scores, torch.Tensor) or not scores.is_cuda:
        raise AssertionError("the scores were not computed on the card")
    n = len(cand)
    rng = np.random.default_rng(SEED + 30)
    idx = np.unique(rng.integers(0, n, SCORER_SAMPLE + SCORER_SAMPLE // 10))
    if n >= SCORER_SAMPLE + SCORER_SAMPLE // 10:
        idx = idx[:SCORER_SAMPLE]
    it = torch.from_numpy(idx).cuda()
    sample = scorer.CandidateSet(*(a[it].cpu().numpy()
                                   for a in vars(cand).values()))
    plain = scorer.score_candidates(st, sample, engine="numpy")
    got = scores[it].cpu().numpy()
    if not np.array_equal(got.view(np.int64), plain.view(np.int64)):
        raise AssertionError("device scores differ from the plain formula")
    total = sum(times.values()) - times["sort alone"]
    log(f"scorer: {len(idx)} sampled device scores equal the plain float64 "
        f"formula bit for bit; {n} candidates")
    log("scorer: split of one round on a fresh copy: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in times.items())
        + f"; total {total * 1e3:.3f} ms [{card}]")


def phase_scorer_small():
    """The card's scorer against device="cpu" (the plain loops) on a
    1,024-OSD map: equal candidate sets and equal changes."""
    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.crush.types import build_three_level
    from ceph_tpu_torch.osdmap.balancer import _failure_domains

    t0 = time.perf_counter()
    cmap, rule = build_three_level(*SMALL_SCORER_MAP, numrep=3)
    maps = [scorer_map(cmap, rule, SMALL_SCORER_PGS, device=d)
            for d in (None, "cpu")]
    cands, results = [], []
    for m, engine in zip(maps, ("device", "numpy")):
        st = scorer.deviation_stats(m)
        cand = scorer.generate_candidates(
            m, st, {4: _failure_domains(m, rule)}, SCORER_DEVIATION)
        if isinstance(cand.src, np.ndarray) != (engine == "numpy"):
            raise AssertionError(f"the map on {m.device} did not run the "
                                 f"{engine} engine")
        cands.append([np.asarray(a.cpu() if engine == "device" else a)
                      for a in vars(cand).values()])
        results.append(scorer.calc_pg_upmaps_vectorized(
            m, max_deviation_ratio=SCORER_DEVIATION, max_moves=SCORER_MOVES))
    if not all(np.array_equal(a, b) for a, b in zip(*cands)):
        raise AssertionError("the card's candidates differ from the CPU's")
    (ch, n), (cch, cn) = results
    if ch != cch or n != cn or not ch:
        raise AssertionError(f"the card's changes differ from the CPU's: "
                             f"{ch} / {cch}")
    log(f"scorer: {cmap.max_devices} OSDs, {SMALL_SCORER_PGS} PGs: card and "
        f"device='cpu' give the same {len(cands[0][0])} candidates in the "
        f"same order and the same {sum(len(v) for v in ch.values())} moves "
        f"({n} candidates scored); {time.perf_counter() - t0:.3f} s")


# -------------------------------------------------------------------- mesh

MESH_STRIPES, MESH_CHUNK = 4096, 512
MESH_PATTERNS = [(0,), (5,), (8,), (11,), (0, 11), (2, 3), (9, 10),
                 (0, 4, 8), (1, 2, 3, 9)]
MESH_RMW_START, MESH_RMW_WIDTH = 128, 256


def mesh_case():
    """Every visible card when there are two or more; otherwise eight
    slots of ``cuda:0`` (a ``(2, 4)`` mesh whose copies between slots are
    no-ops, so the split and gather code still runs on the card).
    Returns the ``devices=`` argument for ``make_mesh`` (None: all cards)
    and a description of the case."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return None, f"{n} cards, one slot each"
    return ["cuda:0"] * 8, "one card: 8 slots of cuda:0"


def sync_all(devices) -> None:
    import torch

    for d in devices:
        torch.cuda.synchronize(d)


def mesh_median_ms(fn, devices, reps: int, spin=SPIN_CYCLES) -> float:
    """``cuda_median_ms`` over several cards: a spin and a start event on
    every device before the call, an end event on each after it; a call
    takes the longest of its devices' start-to-end times."""
    import torch

    fn()
    sync_all(devices)
    times = []
    for _ in range(reps):
        starts = []
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(spin)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
        fn()
        ends = []
        for d in devices:
            with torch.cuda.device(d):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ends.append(ev)
        for ev in ends:
            ev.synchronize()
        times.append(max(s.elapsed_time(e) for s, e in zip(starts, ends)))
    return statistics.median(times)


def mesh_reference(m, rule):
    """The single-device placement of the 1,000,000 ``BENCH_PGS`` the
    sharded placement is held to (computed outside the mesh's counted
    window)."""
    xs = np.arange(BENCH_PGS, dtype=np.uint32)
    weights = np.asarray(m.osd_weight, dtype=np.uint32)
    res, lens = m.tensor_mapper.do_rule_batch(rule, xs, 3, weights)
    return xs, weights, res, lens


def phase_mesh(isa, m, rule, ref):
    """The mesh main path on the card, at full width: the sharded EC
    engine (ISA k8m4, 4096 stripes x 8 x 512 B) against the single-device
    codec, ``distributed_ec_step``, the codec adapter on 4095 stripes and
    the sharded placement of 1,000,000 PGs against ``do_rule_batch``."""
    import torch

    from ceph_tpu_torch.parallel import (MeshECEngine, crush_batch_sharded,
                                         distributed_ec_step, make_mesh)
    from ceph_tpu_torch.parallel.engine import MeshCodecAdapter

    t0 = time.perf_counter()
    devices, case = mesh_case()
    mesh = make_mesh(devices=devices)
    distinct = mesh.distinct()
    if any(d.type != "cuda" for d in distinct):
        raise AssertionError(f"the mesh is not on the card: {mesh}")
    log(f"mesh: {torch.cuda.device_count()} CUDA device(s) visible; {case}; "
        f"mesh {mesh.shape} over {[str(d) for d in distinct]}")
    rng = np.random.default_rng(SEED + 30)
    eng = MeshECEngine(mesh, 8, 4, isa.engine.coding)
    data = torch.from_numpy(rng.integers(
        0, 256, (MESH_STRIPES, 8, MESH_CHUNK), dtype=np.uint8)).cuda()
    parity = eng.encode_batch(data)
    single = isa.encode_batch(data)
    if not parity.is_cuda or not torch.equal(parity, single):
        raise AssertionError("mesh encode differs from the codec's")
    chunks = torch.cat([data, single], dim=1)
    for er in MESH_PATTERNS:
        got = eng.decode_batch(er, chunks)
        if not torch.equal(got, isa.decode_batch(er, chunks)) or \
                not torch.equal(got, chunks[:, list(er)]):
            raise AssertionError(f"mesh decode {er} differs from the codec's")
    update = torch.from_numpy(rng.integers(
        0, 256, (MESH_STRIPES, 8, MESH_RMW_WIDTH), dtype=np.uint8)).cuda()
    got = eng.rmw_batch(chunks, update, MESH_RMW_START)
    patched = data.clone()
    patched[:, :, MESH_RMW_START:MESH_RMW_START + MESH_RMW_WIDTH] = update
    if not torch.equal(got, torch.cat([patched, isa.encode_batch(patched)],
                                      dim=1)):
        raise AssertionError("mesh RMW differs from a full re-encode")
    step, (placed,) = distributed_ec_step(mesh, 8, 4, MESH_STRIPES,
                                          MESH_CHUNK)
    mismatches, step_chunks = step(placed)
    example = eng.gather_stripes(placed)
    if int(mismatches) != 0 or not torch.equal(
            step_chunks, torch.cat([example, isa.encode_batch(example)], 1)):
        raise AssertionError(
            f"distributed_ec_step: {int(mismatches)} mismatches")
    # the adapter pads 4095 stripes to the data axis (two rows or more)
    amesh = make_mesh(devices=devices, shard_axis=1 if devices is None
                      else None)
    adapter = MeshCodecAdapter(isa, amesh)
    odd = data[:MESH_STRIPES - 1]
    pad = (-odd.shape[0]) % amesh.shape["data"]
    if not torch.equal(adapter.encode_batch(odd), isa.encode_batch(odd)) or \
            not torch.equal(adapter.decode_batch((3, 10), chunks[:-1]),
                            chunks[:-1, [3, 10]]):
        raise AssertionError("the mesh codec adapter differs from the codec")
    xs, weights, sres, slens = ref
    res, lens = crush_batch_sharded(mesh, m.tensor_mapper, rule, xs, 3,
                                    weights)
    if not torch.equal(res, sres) or not torch.equal(lens, slens):
        raise AssertionError("crush_batch_sharded differs from do_rule_batch")
    sync_all(distinct)
    log(f"mesh: encode, 9 erasure patterns, RMW at columns "
        f"[{MESH_RMW_START}, {MESH_RMW_START + MESH_RMW_WIDTH}), "
        f"distributed_ec_step (0 mismatches) on {MESH_STRIPES} x 8 x "
        f"{MESH_CHUNK} B equal the single-device codec byte for byte; the "
        f"adapter on mesh {amesh.shape} pads {MESH_STRIPES - 1} stripes by "
        f"{pad} and equals the codec; crush_batch_sharded of {len(xs)} PGs "
        f"over {mesh.devices.size} slots equals do_rule_batch; "
        f"{time.perf_counter() - t0:.3f} s")
    return {"mesh": mesh, "eng": eng, "data": data, "chunks": chunks,
            "slots": mesh.devices.size}


def phase_mesh_timing(isa, m, rule, ref, out, single_s: float, card: str):
    """CUDA-event medians of the mesh encode and a one-erasure decode
    against the single-device codec on the same batch, one profiled call
    of each (device kernels, kernel time, idle share), and the wall
    median of the sharded placement beside ``single_s``, the placement
    timing's median of ``do_rule_batch`` on the same PGs and weights."""
    from ceph_tpu_torch.parallel import crush_batch_sharded

    mesh, eng, data, chunks = out["mesh"], out["eng"], out["data"], \
        out["chunks"]
    devs = mesh.distinct()
    nbytes = data.numel()
    rows = [("encode", lambda: eng.encode_batch(data),
             lambda: isa.encode_batch(data)),
            ("decode (0,)", lambda: eng.decode_batch((0,), chunks),
             lambda: isa.decode_batch((0,), chunks))]
    for label, mesh_fn, single_fn in rows:
        ms = mesh_median_ms(mesh_fn, devs, 20)
        single_ms = cuda_median_ms(single_fn, 20)
        wall = wall_median_s(mesh_fn, 5, devs)
        single_wall = wall_median_s(single_fn, 5)
        log(f"timing: mesh {label} ISA k8m4 {MESH_STRIPES} x 8 x "
            f"{MESH_CHUNK} B on mesh {mesh.shape} ({len(devs)} device(s)): "
            f"CUDA-event median {ms:.6f} ms ({nbytes / ms / 1e6:.3f} GB/s "
            f"of data), single-device codec {single_ms:.6f} ms "
            f"({nbytes / single_ms / 1e6:.3f} GB/s); wall medians "
            f"{wall * 1e3:.3f} ms and {single_wall * 1e3:.3f} ms [{card}]")
        for who, fn, w in (("mesh", mesh_fn, wall),
                           ("single-device", single_fn, single_wall)):
            k, k_ms, dtoh, syncs, pwall, _top = profile_call(fn)
            log(f"timing: mesh {label}, {who} call profiled: {k} device "
                f"kernels, {k_ms:.3f} ms summed kernel time, {dtoh} DtoH "
                f"copies, {syncs} host syncs, {pwall * 1e3:.3f} ms wall; "
                f"device idle share {1 - k_ms / (w * 1e3 * len(devs)):.4f} "
                f"of the wall median summed over {len(devs)} device(s) "
                f"[{card}]")
    xs, weights, _, _ = ref
    if not (weights == 0x10000).all():
        raise AssertionError("the placement timing ran with other weights")
    s = wall_median_s(
        lambda: crush_batch_sharded(mesh, m.tensor_mapper, rule, xs, 3,
                                    weights), PLACEMENT_REPS, devs,
        warm=False)
    log(f"timing: mesh crush_batch_sharded {len(xs)} PGs over "
        f"{mesh.devices.size} slots on {len(devs)} device(s): wall median "
        f"{s * 1e3:.3f} ms = {len(xs) / s:.0f} mappings/s; do_rule_batch "
        f"{single_s * 1e3:.3f} ms = {len(xs) / single_s:.0f} mappings/s "
        f"[{card}]")


# ---------------------------------------------------------------------------
# the OSD store path: the port's batchers, messenger and stores
# ---------------------------------------------------------------------------

# ticks of TICK_SIZES through pool A (planes at rest in BlueStores); pool B
# (bytes at rest in FileStores) takes one (pool A took 4 before a slow host
# took the script past its time)
STORE_TICKS = 2
STORE_TICK_OPS = 512            # osd_batch_tick_ops: a whole tick coalesces
STORE_ERASURES = [(0,), (1, 10), (0, 1, 2, 3)]
STORE_BYTE_ERASURES = [(0,), (2, 11)]
STORE_FLIP_PEER = 5
STORE_ACK_TIMEOUT_S = 120.0


class StorePeer:
    """One shard peer: a messenger on loopback whose dispatcher applies
    every sub-write, alone or in a batch frame, as one transaction on its
    own store, and acks it on the connection it came in on."""

    def __init__(self, osd_id: int, store):
        from ceph_tpu_torch.cluster.messenger import EntityName, Messenger

        self.osd_id = osd_id
        self.store = store
        self.applied = 0
        self.messenger = Messenger(EntityName("osd", osd_id))
        self.messenger.add_dispatcher(self)

    async def ms_dispatch(self, conn, msg) -> bool:
        from ceph_tpu_torch.cluster import messages as M

        if isinstance(msg, M.MOSDECSubOpWriteBatch):
            for item in msg.items:
                self.apply(item)
            await conn.send(M.MOSDECSubOpWriteBatchReply(
                results=[(it.reqid, 0, it.shard) for it in msg.items]))
            return True
        if isinstance(msg, M.MOSDECSubOpWrite):
            self.apply(msg)
            await conn.send(M.MOSDECSubOpWriteReply(reqid=msg.reqid,
                                                     result=0))
            return True
        return False

    async def ms_handle_reset(self, conn) -> None:
        pass

    def apply(self, sub) -> None:
        from ceph_tpu_torch.cluster.store import Transaction
        from ceph_tpu_torch.ec import planar_store

        coll, oid = str(sub.pgid), sub.oid
        txn = Transaction()
        if sub.layout == planar_store.LAYOUT_PLANAR:
            txn.write_planar(coll, oid, sub.chunk_off // 8, sub.data,
                             sub.shard_size // 8)
        else:
            txn.write(coll, oid, sub.chunk_off, sub.data) \
               .truncate(coll, oid, sub.shard_size)
        txn.setattr(coll, oid, "shard", str(sub.shard).encode()) \
           .setattr(coll, oid, "size", str(sub.hinfo["size"]).encode()) \
           .setattr(coll, oid, "hinfo_crc", str(sub.hinfo["crc"]).encode()) \
           .set_version(coll, oid, sub.hinfo["version"])
        self.store.queue_transaction(txn)
        self.applied += 1


class StorePrimary:
    """The primary OSD's stand-in (the ``_FakeOSD`` of
    ``tests/test_batch_chaos.py``): the port's config, counters and clock,
    the tick compute in an executor thread as ``OSD._compute`` runs it,
    the port's three batchers, and sub-writes out through its own
    messenger; acks from the peers are counted."""

    def __init__(self, device, peer_addrs):
        from ceph_tpu_torch.chaos.clock import ChaosClock
        from ceph_tpu_torch.cluster.batcher import (EncodeBatcher,
                                                    ReadBatcher,
                                                    SubWriteBatcher)
        from ceph_tpu_torch.cluster.messenger import EntityName, Messenger
        from ceph_tpu_torch.utils import Config, PerfCounters

        self._stopped = False
        self.config = Config(osd_batch_tick_ops=STORE_TICK_OPS)
        self.perf = PerfCounters("osd.0")
        self.clock = ChaosClock.from_config(self.config)
        self.device = device
        self.osdmap = types.SimpleNamespace(epoch=1)
        self.peer_addrs = peer_addrs
        self.acked = 0
        self._tasks = set()
        self.messenger = Messenger(EntityName("osd", 0))
        self.messenger.add_dispatcher(self)
        self.encoder = EncodeBatcher(self)
        self.reader = ReadBatcher(self)
        self.subwrites = SubWriteBatcher(self)

    def _track(self, task):
        from ceph_tpu_torch.utils.tasks import track_task

        return track_task(self._tasks, task)

    def _chaos_point(self, name: str) -> None:
        pass

    async def _compute(self, fn, *args):
        import asyncio
        import functools

        return await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(fn, *args))

    async def _send_osd(self, target: int, msg) -> None:
        await self.messenger.send_message(msg, self.peer_addrs[target])

    async def ms_dispatch(self, conn, msg) -> bool:
        from ceph_tpu_torch.cluster import messages as M

        if isinstance(msg, M.MOSDECSubOpWriteBatchReply):
            self.acked += len(msg.results)
            return True
        if isinstance(msg, M.MOSDECSubOpWriteReply):
            self.acked += 1
            return True
        return False

    async def ms_handle_reset(self, conn) -> None:
        pass


async def store_write_tick(osd, codec, sinfo, datas, tick: int,
                           planar: bool, written: list):
    """One tick: every op submitted at once to ``EncodeBatcher.encode``,
    each op's twelve shards fanned out through ``SubWriteBatcher`` (one
    frame per peer), and the tick waited for until every peer acked every
    shard.  Returns (the encode windows, submit-to-applied wall, shard
    bytes)."""
    import asyncio

    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.ec import planar_store
    from ceph_tpu_torch.osdmap.osdmap import PGid

    n = codec.get_chunk_count()
    want = osd.acked + n * len(datas)
    t0 = time.perf_counter()

    async def op(i, data):
        shards, crcs, window = await osd.encoder.encode(
            codec, sinfo, data, True, planar=planar)
        if not isinstance(shards, np.ndarray):
            raise AssertionError(f"the tick answered {type(shards)}")
        pgid = PGid(1, i % 64)
        oid = f"t{tick}.o{i}"
        rows = [np.ascontiguousarray(shards[s]) for s in range(n)]
        size = rows[0].size
        subs = [M.MOSDECSubOpWrite(
            reqid=("client.smoke", tick * 100_000 + i), pgid=pgid, oid=oid,
            shard=s, data=rows[s].tobytes(), chunk_off=0, shard_size=size,
            hinfo={"size": len(data), "version": tick + 1, "crc": crcs[s]},
            epoch=1,
            layout=planar_store.LAYOUT_PLANAR if planar else None)
            for s in range(n)]
        await asyncio.gather(*(osd.subwrites.send(s, sub)
                               for s, sub in enumerate(subs)))
        written.append((str(pgid), oid, data, list(crcs)))
        return window, n * size

    got = await asyncio.gather(*(op(i, d) for i, d in enumerate(datas)))
    deadline = time.perf_counter() + STORE_ACK_TIMEOUT_S
    while osd.acked < want:
        if time.perf_counter() > deadline:
            raise AssertionError(f"tick {tick}: {osd.acked} of {want} "
                                 "sub-writes acked")
        await asyncio.sleep(0.001)
    wall = time.perf_counter() - t0
    return [w for w, _b in got], wall, sum(b for _w, b in got)


def raw_object(store, coll: str, oid: str) -> bytes:
    """The bytes a BlueStore's device holds for an object, read past the
    csum check (what the media returns)."""
    from ceph_tpu_torch.cluster.bluestore import BLOCK, SUPER_BLOCKS

    o = store._onodes[coll][oid]
    out = bytearray()
    for blkno in o.blocks:
        store._dev.seek((SUPER_BLOCKS + blkno) * BLOCK)
        out += store._dev.read(BLOCK)
    return bytes(out[:o.size])


async def store_pool(codec, sinfo, device, make_store, ticks: int,
                     planar: bool, erasures, card: str, label: str):
    """One pool of the store path: twelve peers on their stores, the
    primary, ``ticks`` write ticks, crash and remount of every store,
    then read, verify (and for planes a flipped bit), decode and
    reencode through ``ReadBatcher``."""
    import asyncio

    from ceph_tpu_torch.chaos.disk import DiskInjector
    from ceph_tpu_torch.chaos.rng import stream

    n = codec.get_chunk_count()
    peers = [StorePeer(s + 1, make_store(s)) for s in range(n)]
    for p in peers:
        p.store.mount()
    addrs = {s: await p.messenger.bind("127.0.0.1", 0)
             for s, p in enumerate(peers)}
    osd = StorePrimary(device, addrs)
    out = {"label": label}
    try:
        written: list = []
        windows, walls, nbytes = [], [], 0
        for tick in range(ticks):
            datas = tick_datas(SEED + 700 + tick)
            w, wall, b = await store_write_tick(osd, codec, sinfo, datas,
                                                tick, planar, written)
            windows.append(w)
            walls.append(wall)
            nbytes += b
        perf = {k: osd.perf.get(k) for k in (
            "osd_batch_ticks", "osd_batch_coalesced_ops",
            "osd_subwrite_batches", "osd_subwrite_batched_items")}
        per_tick = [{x[2] for x in w} for w in windows]
        if perf["osd_batch_ticks"] != ticks or \
                perf["osd_batch_coalesced_ops"] != ticks * len(TICK_SIZES) \
                or any(s != {len(TICK_SIZES)} for s in per_tick):
            raise AssertionError(f"{label}: ticks did not coalesce every op: "
                                 f"{perf}, batch sizes {per_tick}")
        if perf["osd_subwrite_batches"] < ticks * n or \
                perf["osd_subwrite_batched_items"] < \
                ticks * n * (len(TICK_SIZES) - 1):
            raise AssertionError(f"{label}: sub-writes did not leave as "
                                 f"batch frames: {perf}")
        if sum(p.applied for p in peers) != ticks * n * len(TICK_SIZES):
            raise AssertionError(f"{label}: peers applied "
                                 f"{[p.applied for p in peers]}")
        tick_s = [w[0][1] - w[0][0] for w in windows]
        out.update(perf=perf, tick_s=tick_s, walls=walls, nbytes=nbytes)
        log(f"store path ({label}): {ticks} ticks x {len(TICK_SIZES)} ops; "
            f"counters {json.dumps(perf, sort_keys=True)}; median tick "
            f"(encode window t1 - t0) {statistics.median(tick_s) * 1e3:.3f} "
            f"ms; median tick submit to all {n} peers applied "
            f"{statistics.median(walls) * 1e3:.3f} ms (the encode window "
            f"{100 * statistics.median(tick_s) / statistics.median(walls):.1f}"
            f" % of it); {nbytes / sum(walls) / 1e6:.3f} MB/s of shard "
            f"bytes into the stores [{card}]")
        # crash every store (no clean checkpoint) and remount it
        t0 = time.perf_counter()
        for p in peers:
            p.store.crash()
        for p in peers:
            p.store.mount()
        remount_s = time.perf_counter() - t0
        # read every shard of every op back and verify it against the
        # tick's crcs, one request per op
        t0 = time.perf_counter()
        rows = [[(p.store.read_planar(coll, oid) if planar
                  else p.store.read(coll, oid)) for p in peers]
                for coll, oid, _d, _c in written]
        read_s = time.perf_counter() - t0
        oks = await asyncio.gather(*(
            osd.reader.verify(r, crcs, planar=planar)
            for r, (_c, _o, _d, crcs) in zip(rows, written)))
        verify_s = time.perf_counter() - t0
        if not all(all(o) for o in oks):
            raise AssertionError(f"{label}: a stored shard failed verify")
        out.update(remount_s=remount_s, read_s=read_s, verify_s=verify_s)
        out["verify_device"] = str(osd.reader.device)
        if planar:
            # the host csum a BlueStore read pays: one crc32c_rows call
            # over the blocks of one 64 KiB op's shard
            from ceph_tpu_torch.ops.crc32c import crc32c_rows

            blocks = np.frombuffer(rows[1][0], dtype=np.uint8).reshape(
                -1, 4096)
            times = []
            for _ in range(51):
                t1 = time.perf_counter()
                crc32c_rows(blocks)
                times.append(time.perf_counter() - t1)
            out["csum_ms"] = 1e3 * statistics.median(times)
            log(f"store path ({label}): host csum of one shard's "
                f"{blocks.shape[0]} blocks in one crc32c_rows call, median "
                f"{out['csum_ms']:.3f} ms; a shard's read_planar "
                f"{1e3 * read_s / (len(rows) * n):.3f} ms on average "
                f"[{card}]")
        log(f"store path ({label}): crash + remount of {n} stores "
            f"{remount_s * 1e3:.3f} ms; read of {len(rows) * n} shards "
            f"{read_s * 1e3:.3f} ms, read and verify on "
            f"{osd.reader.device} {verify_s * 1e3:.3f} ms, every crc "
            f"equal [{card}]")
        if planar:
            coll, oid, _d, crcs = written[1]
            store = peers[STORE_FLIP_PEER].store
            bit = DiskInjector(stream(SEED, "disk:smoke")).flip_bit(
                store, coll, oid)
            try:
                store.read_planar(coll, oid)
            except IOError as e:
                eio = str(e)
            else:
                raise AssertionError(f"{label}: a flipped bit read back")
            rotted = list(rows[1])
            rotted[STORE_FLIP_PEER] = raw_object(store, coll, oid)
            got = await osd.reader.verify(rotted, crcs, planar=True)
            want = [s != STORE_FLIP_PEER for s in range(n)]
            if got != want:
                raise AssertionError(f"{label}: verify after the flip {got}")
            log(f"store path ({label}): bit {bit} of {coll}/{oid} on peer "
                f"{STORE_FLIP_PEER} flipped: the store raises ({eio}), "
                f"verify of the device bytes is false for that row only")
        # planes decode from the stored blobs, byte rows from arrays
        arrays = rows if planar else [
            [np.frombuffer(x, dtype=np.uint8) for x in r] for r in rows]
        for er in erasures:
            reqs = [({s: r[s] for s in range(n) if s not in er}, len(d))
                    for r, (_c, _o, d, _cr) in zip(arrays, written)]
            got = await asyncio.gather(*(
                osd.reader.decode(codec, sinfo, sh, size, planar=planar)
                for sh, size in reqs))
            if got != [d for _c, _o, d, _cr in written]:
                raise AssertionError(f"{label}: decode with {er} lost wrong")
        log(f"store path ({label}): ReadBatcher.decode of all "
            f"{len(written)} ops equals the client bytes with shards "
            f"{erasures} lost")
        if planar:
            lost = (4,)
            reqs = [({s: r[s] for s in range(n) if s not in lost}, len(d))
                    for r, (_c, _o, d, _cr) in zip(rows, written)]
            got = await asyncio.gather(*(
                osd.reader.reencode(codec, sinfo, sh, size, planar=True)
                for sh, size in reqs))
            for g, r in zip(got, rows):
                stored = np.stack([np.frombuffer(x, dtype=np.uint8)
                                   .reshape(8, -1) for x in r])
                if not np.array_equal(np.asarray(g), stored):
                    raise AssertionError(f"{label}: reencode differs")
            log(f"store path ({label}): ReadBatcher.reencode with shard "
                f"{lost} lost equals the stored planes of every op")
        out["read_ticks"] = (osd.perf.get("osd_read_batch_ticks"),
                             osd.perf.get("osd_read_batch_coalesced"))
    finally:
        osd._stopped = True
        await osd.messenger.shutdown()
        for p in peers:
            await p.messenger.shutdown()
            p.store.umount()
    return out


def phase_store_path(isa, cauchy, device, card: str, count_window):
    """The OSD store path: pool A (ISA k8m4 planes at rest in twelve
    BlueStores, kernel B1) and pool B (cauchy_good k8m4 bytes at rest in
    twelve FileStores, kernel B2), each through ``count_window``."""
    import asyncio
    import tempfile

    from ceph_tpu_torch.cluster.bluestore import BlueStore
    from ceph_tpu_torch.cluster.filestore import FileStore
    from ceph_tpu_torch.ec import stripe

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stores_") as tmp:
        sinfo = stripe.StripeInfo(8, 4096)
        out["A"] = count_window("store path A", lambda: asyncio.run(
            store_pool(isa, sinfo, device,
                       lambda s: BlueStore(f"{tmp}/a{s}"), STORE_TICKS,
                       True, STORE_ERASURES, card,
                       "pool A, ISA k8m4, planes in BlueStore")))
        sinfo = stripe.StripeInfo(8, 16384)
        out["B"] = count_window("store path B", lambda: asyncio.run(
            store_pool(cauchy, sinfo, device,
                       lambda s: FileStore(f"{tmp}/b{s}"), 1, False,
                       STORE_BYTE_ERASURES, card,
                       "pool B, cauchy_good k8m4, bytes in FileStore")))
    log(f"store path: phase wall {time.perf_counter() - t0:.3f} s [{card}]")
    return out


def phase_loop_slope(codec, kernel_ms: float, card: str):
    """``device_loop_slope`` on B1's headline ISA shape (the L-step chain
    as one CUDA graph), beside the CUDA-event median of phase_timing."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda
    from ceph_tpu_torch.ops.profiling import device_loop_slope

    rng = np.random.default_rng(SEED + 31)
    bm = codec.engine._enc_bitmat
    npk = 4096 * 512 // 8
    planes = torch.from_numpy(rng.integers(
        0, 256, (int(bm.shape[1]), npk), dtype=np.uint8)).cuda()

    def feedback(d, out):
        d[:1].bitwise_xor_(out[:1])
        return d

    med, best, worst = device_loop_slope(
        lambda d: gf8_cuda.planar_matmul(bm, d), feedback, planes,
        tag="b1_headline")
    log(f"timing: B1 headline device_loop_slope (L1=300, L2=1200, CUDA "
        f"graphs, L2 warm): median {med * 1e3:.6f} ms per step, best "
        f"{best * 1e3:.6f}, worst {worst * 1e3:.6f}; CUDA-event median "
        f"with the L2 flushed {kernel_ms:.6f} ms [{card}]")


def wall_median_s(fn, reps: int = 3, devices=(None,),
                  warm: bool = True) -> float:
    """Median host wall time of ``reps`` calls, each bracketed by
    ``torch.cuda.synchronize()`` of every device in ``devices`` (default:
    the current one), after one warm-up call unless ``warm`` is false
    (an entry point the script has already run on the same inputs)."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        sync_all(devices)
        t0 = time.perf_counter()
        fn()
        sync_all(devices)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_call(fn):
    """One call under torch.profiler (CUDA activity) and the CUDA sync
    debug mode: (device kernels, summed kernel ms, DtoH copies, host syncs,
    wall s of the profiled call, the four kernel names with the most
    summed time as (name, launches, ms))."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("synchronizing" in str(w.message) for w in syncs)
    kernels, kernel_us, dtoh = 0, 0.0, 0
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith("Memcpy"):
            dtoh += "DtoH" in e.name
        elif not e.name.startswith("Memset"):
            us = getattr(e, "device_time", None) or e.cuda_time
            kernels += 1
            kernel_us += us
            n, tot = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, tot + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    return (kernels, kernel_us / 1e3, dtoh, n_sync, wall,
            [(name[:90], n, us / 1e3) for name, (n, us) in top])


def phase_placement_timing(m, m2, rule, card: str):
    """Wall times of the placement entry points, and one do_rule_batch
    call profiled at the default chunk and at one chunk for the batch."""
    from ceph_tpu_torch.crush import bench_map
    from ceph_tpu_torch.crush.mapper import TensorMapper

    xs = np.arange(BENCH_PGS, dtype=np.uint32)
    weights = np.full(m.crush.max_devices, 0x10000, dtype=np.uint32)
    mappers = {"default chunk": m.tensor_mapper,
               "one chunk": TensorMapper(m.crush, chunk=BENCH_PGS)}
    out = {}
    for label, mp in mappers.items():
        # the map's own mapper ran these PGs in the mesh phase; the
        # one-chunk mapper is new
        s = wall_median_s(lambda: mp.do_rule_batch(rule, xs, 3, weights),
                          PLACEMENT_REPS, warm=label == "one chunk")
        k, k_ms, dtoh, syncs, wall, top = profile_call(
            lambda: mp.do_rule_batch(rule, xs, 3, weights))
        out[label] = s
        log(f"timing: placement do_rule_batch {BENCH_PGS} PGs, "
            f"{label} ({mp.chunk} lanes): median {s * 1e3:.3f} ms = "
            f"{BENCH_PGS / s:.0f} mappings/s; profiled call: {k} device "
            f"kernels, {k_ms:.3f} ms summed kernel time, {dtoh} DtoH "
            f"copies, {syncs} host syncs, {wall * 1e3:.3f} ms wall; device "
            f"idle share {1 - k_ms / (s * 1e3):.4f} of the median call "
            f"[{card}]")
        for name, n, ms in top:
            log(f"timing: placement {label} kernel {name}: {n} launches, "
                f"{ms:.3f} ms ({ms / k_ms:.4f} of kernel time) [{card}]")
    s = wall_median_s(lambda: m.pool_mapping(1), PLACEMENT_REPS,
                      warm=False)
    log(f"timing: placement pool_mapping pool 1 ({PLACEMENT_PGS} PGs): "
        f"median {s * 1e3:.3f} ms = {PLACEMENT_PGS / s:.0f} mappings/s "
        f"[{card}]")
    s = wall_median_s(lambda: m.rebalance_diff(1, m2), PLACEMENT_REPS,
                      warm=False)
    log(f"timing: placement rebalance_diff pool 1 (two pool_mappings of "
        f"{PLACEMENT_PGS} PGs): median {s * 1e3:.3f} ms = "
        f"{2 * PLACEMENT_PGS / s:.0f} mappings/s [{card}]")
    rate = bench_map(n_osds=RACKS * 256, n_pgs=BENCH_PGS,
                     iters=PLACEMENT_REPS)
    log(f"timing: placement bench_map(n_osds={RACKS * 256}, "
        f"n_pgs={BENCH_PGS}) {rate:.0f} mappings/s [{card}]")
    return out


# ----------------------------------------------------------- control plane

CP_REP_PGS = 1 << 16
CP_EC_PGS = 1 << 14
CP_EC_PROFILE = {"plugin": "isa", "k": "8", "m": "4"}
CP_WHOLESALE = 64
CP_SAMPLE = 1000
CP_BOUND_S = 400.0
CP_MGR_TIMEOUT_S = 10.0       # the balancer's own mon_command timeout


def cp_places(inc) -> bool:
    """The deltas whose mint reads placements (``Monitor._mint_pg_temp``'s
    own test, and ``new_down`` for its sweep)."""
    return bool(inc.new_up or inc.new_weights or inc.new_pools
                or inc.new_pg_upmap_items or inc.new_crush_hosts
                or inc.old_osds or inc.new_primary_affinity or inc.new_down)


def cp_placement_key(m, pool_id: int) -> bytes:
    """What ``pg_raw_up`` reads for every PG of one pool, upmaps aside:
    with equal keys, a PG whose own upmap entries are equal places alike
    (``_apply_upmap`` reads only the PG's own entries)."""
    import hashlib

    p = m.pools[pool_id]
    return hashlib.sha1(pickle.dumps((
        pool_id, m.max_osd, list(m.osd_exists), list(m.osd_weight),
        m.crush.rules[p.crush_rule].steps,
        sorted((b.id, list(b.items), list(b.weights))
               for b in m.crush.buckets.values()),
        (p.type, p.size, p.pg_num, p.pgp_num, p.crush_rule,
         p.hashpspool)))).digest()


def cp_seed_upmaps(m, pool_id: int, seed: int):
    """One PG's own upmap entries: the rest of its ``pg_raw_up`` input."""
    from ceph_tpu_torch.osdmap.osdmap import PGid

    pg = PGid(pool_id, seed)
    return (tuple(m.pg_upmap.get(pg, ())),
            tuple(tuple(x) for x in m.pg_upmap_items.get(pg, ())))


def cp_scalar_mint(old, new, inc, pool_id, seed, old_row, new_row):
    """The pg_temp entry the per-PG mint gives ``seed`` (None: no entry),
    from the scalar chain's rows of the old and new map."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osdmap.osdmap import PGid

    pgid = PGid(pool_id, seed)

    def live(o):
        return 0 <= o < new.max_osd and new.osd_exists[o]

    if pgid in inc.new_pg_temp:
        return None
    cur = old.pg_temp.get(pgid)
    if cur is not None and any(live(o) for o in cur):
        return None
    new_set = {o for o in new_row if o >= 0}
    donors = [o for o in old_row if live(o)]
    if not new_set or not donors or new_set & set(donors):
        return None
    if new.pools[pool_id].can_shift_osds():
        return donors + [o for o in new_row if o >= 0 and o not in donors]
    return [o if live(o) else CRUSH_ITEM_NONE for o in old_row]


class LoopWatch:
    """The longest time the event loop went without waking a 1 ms timer,
    by the step it happened in."""

    # the phase's own host work, not a daemon's
    OWN = ("setup", "wholesale pick")

    def __init__(self):
        self.step = "setup"
        self.by_step = {}

    @property
    def worst(self):
        """(seconds, step): the longest block while the daemons ran."""
        return max(((lag, step) for step, lag in self.by_step.items()
                    if step not in self.OWN), default=(0.0, ""))

    async def run(self):
        import asyncio

        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(0.001)
            lag = loop.time() - t0 - 0.001
            if lag > self.by_step.get(self.step, 0.0):
                self.by_step[self.step] = lag


async def cp_wait(pred, what: str, bound: float = 60.0) -> float:
    """Poll ``pred`` every millisecond; the seconds it took."""
    import asyncio

    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > bound:
            raise AssertionError(f"control plane: {what} after {bound} s")
        await asyncio.sleep(0.001)
    return time.perf_counter() - t0


def cp_ready(m) -> bool:
    return not m.stopped and m.is_leader and m.paxos is not None \
        and m.paxos.active


async def control_plane(dev, card: str, reset_counts, gf8_mods):
    """The path itself: see ``phase_control_plane``."""
    import asyncio
    import copy
    import os
    import tempfile

    import torch

    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.cluster.filestore import FileStore
    from ceph_tpu_torch.cluster.mgr import MgrDaemon
    from ceph_tpu_torch.cluster.mon import Monitor
    from ceph_tpu_torch.crush.types import build_three_level
    from ceph_tpu_torch.osdmap.osdmap import OSDMap
    from ceph_tpu_torch.utils import Config
    from ceph_tpu_torch.utils.perf import KERNELS

    t = {}
    # mgr defaults, with one exception: no OSD runs here, so the health
    # the balancer gates on shows PG_RECOVERING for every up OSD that
    # never sent a beacon after a placement change; with the default
    # mgr_balancer_require_clean=1 every round would be throttled
    cfg = Config(mgr_balancer_require_clean=0)
    log("control plane: mgr_balancer_require_clean=0 (no OSD daemons "
        "beacon here, so every up OSD reads as unclean after a placement "
        "change and the default gate would throttle every round)")
    cmap, _ = build_three_level(RACKS, HOSTS_PER_RACK, OSDS_PER_HOST,
                                numrep=3)
    blob = pickle.dumps(OSDMap(cmap))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mons_")
    mons, addrs, tasks = [], [], []
    mgr = None
    watch = LoopWatch()
    records, plans = [], []
    dstats = [0]
    inner_stats = scorer.deviation_stats
    # every whole-pool placement the path makes: (pool, pg_num, seconds)
    raw_calls = []
    inner_raw = OSDMap._pool_raw

    def timed_raw(self, pool_id):
        t0 = time.perf_counter()
        out = inner_raw(self, pool_id)
        raw_calls.append((pool_id, self.pools[pool_id].pg_num,
                          time.perf_counter() - t0))
        return out

    def counted_stats(*a, **k):
        dstats[0] += 1
        return inner_stats(*a, **k)

    def record_mints(mon):
        inner = mon._mint_pg_temp

        def mint(inc):
            if not cp_places(inc):
                return inner(inc)
            t0 = time.perf_counter()
            old_blob = pickle.dumps(mon.osdmap)
            before = copy.deepcopy(inc)
            calls = KERNELS.get("crush_map_calls")
            pgs = KERNELS.get("crush_map_pgs")
            minted = mon.perf.get("mon_pg_temp_minted")
            r0 = len(raw_calls)
            t1 = time.perf_counter()
            inner(inc)
            t2 = time.perf_counter()
            records.append({
                "rank": mon.rank, "epoch": inc.epoch, "old": old_blob,
                "inc": before, "out": dict(inc.new_pg_temp),
                "mint_s": t2 - t1, "record_s": t1 - t0,
                "calls": KERNELS.get("crush_map_calls") - calls,
                "pgs": KERNELS.get("crush_map_pgs") - pgs,
                "minted": mon.perf.get("mon_pg_temp_minted") - minted,
                "raw": raw_calls[r0:],
                "pools_both": sorted(set(pickle.loads(old_blob).pools)
                                     & (set(mon.osdmap.pools)
                                        | set(inc.new_pools)))})

        mon._mint_pg_temp = mint

    def new_mon(rank):
        store = FileStore(os.path.join(tmp.name, f"mon{rank}"))
        mon = Monitor(pickle.loads(blob), config=cfg, rank=rank, n_mons=3,
                      store=store, device=dev)
        record_mints(mon)
        return mon

    async def all_applied(epoch, what):
        return await cp_wait(
            lambda: all(m.osdmap.epoch >= epoch for m in mons
                        if not m.stopped), f"{what} never applied on "
            "every monitor", CP_MGR_TIMEOUT_S * 3)

    async def command(label, cmd):
        """One command through the mgr's ``mon_command``: (reply, seconds
        from submit to every live monitor applied, the mint's record)."""
        watch.step = label
        n0 = len(records)
        t0 = time.perf_counter()
        data = await mgr.mon_command(cmd, timeout=CP_MGR_TIMEOUT_S)
        mine = records[n0:]
        epoch = mine[-1]["epoch"] if mine else \
            max(m.osdmap.epoch for m in mons if not m.stopped)
        await all_applied(epoch, label)
        s = time.perf_counter() - t0
        await cp_wait(lambda: mgr.osdmap.epoch >= epoch,
                      f"the mgr never saw {label}")
        return data, s, (mine[-1] if mine else None)

    async def balancer_round(label):
        watch.step = label
        n0, p0 = len(records), len(plans)
        t0 = time.perf_counter()
        res = await mgr.balancer.tick()
        total = time.perf_counter() - t0
        if not res.get("committed") or res["moves"] <= 0 or \
                not res["skew_after"] < res["skew_before"]:
            raise AssertionError(f"{label} did not commit a better "
                                 f"balance: {res}")
        rec = records[n0:]
        if len(rec) != 1 or len(plans) != p0 + 1:
            raise AssertionError(f"{label}: {len(rec)} mints, "
                                 f"{len(plans) - p0} plans")
        await all_applied(rec[0]["epoch"], label)
        applied = time.perf_counter() - t0
        await cp_wait(lambda: mgr.osdmap.epoch >= rec[0]["epoch"],
                      f"the mgr never saw {label}")
        plan = plans[-1]
        return {"res": res, "plan": plan, "mint": rec[0], "total": total,
                "applied": applied, "commit": applied - plan["s"]}

    try:
        tasks.append(asyncio.get_running_loop().create_task(watch.run()))
        for r in range(3):
            mons.append(new_mon(r))
            addrs.append(await mons[r].start())
        for m in mons:
            m.set_monmap(addrs)
        watch.step = "election"
        t0 = time.perf_counter()
        await mons[0].begin_elections()
        await cp_wait(lambda: any(cp_ready(m) for m in mons), "no leader")
        t["election"] = time.perf_counter() - t0
        leader = next(m for m in mons if cp_ready(m))
        mgr = MgrDaemon(addrs, config=cfg, device=dev)
        inner_plan = mgr.balancer._plan

        def plan(m):
            old = pickle.dumps(m)     # before the plan mutates its copy
            t0 = time.perf_counter()
            calls = KERNELS.get("crush_map_calls")
            pgs = KERNELS.get("crush_map_pgs")
            d0 = dstats[0]
            r0 = len(raw_calls)
            out = inner_plan(m)
            torch.cuda.synchronize(dev)
            plans.append({"s": time.perf_counter() - t0,
                          "calls": KERNELS.get("crush_map_calls") - calls,
                          "pgs": KERNELS.get("crush_map_pgs") - pgs,
                          "dstats": dstats[0] - d0, "changes": out[0],
                          "raw": raw_calls[r0:],
                          "pools": len(m.pools), "old": old})
            return out

        mgr.balancer._plan = plan
        await mgr.start()
        await cp_wait(lambda: leader.osdmap.mgr_addr is not None
                      and mgr.osdmap is not None
                      and mgr.osdmap.epoch == leader.osdmap.epoch,
                      "the mgr never registered")
        log(f"control plane: 3 monitors and a mgr on {dev}, "
            f"{cmap.max_devices} OSDs up and in; election to quorum "
            f"{t['election'] * 1e3:.3f} ms, leader mon.{leader.rank}")
        scorer.deviation_stats = counted_stats
        OSDMap._pool_raw = timed_raw

        # the counted window: B1, B2 and the crush_map_* counters from 0
        for mod in gf8_mods:
            mod.launches = mod.kept_launches = 0
        reset_counts()
        t_path = time.perf_counter()
        rep, t["create rbd"], rec1 = await command(
            "create rbd", {"prefix": "osd pool create", "pool": "rbd",
                           "pool_type": "replicated", "size": 3,
                           "pg_num": CP_REP_PGS})
        ec, t["create ec"], rec2 = await command(
            "create ec", {"prefix": "osd pool create", "pool": "ec",
                          "pool_type": "erasure", "pg_num": CP_EC_PGS,
                          "ec_profile": dict(CP_EC_PROFILE)})
        round1 = await balancer_round("balancer round 1")

        # the wholesale remap: every member of 64 PGs of the replicated
        # pool onto three OSDs of three other hosts, chosen on the host
        from ceph_tpu_torch.osdmap.balancer import _failure_domains
        from ceph_tpu_torch.osdmap.osdmap import PGid

        watch.step = "wholesale pick"

        def pick(m):
            """64 PGs without upmaps or pg_temp, and for each member of
            each an OSD on another host (scalar chain, on the host)."""
            dom = _failure_domains(m, m.pools[rep].crush_rule)
            by_dom = {}
            for o, d in dom.items():
                by_dom.setdefault(d, []).append(o)
            rng = np.random.default_rng(SEED + 40)
            items, wholesale = {}, {}
            for s in rng.permutation(CP_REP_PGS).tolist():
                pg = PGid(rep, s)
                if pg in m.pg_upmap_items or pg in m.pg_temp:
                    continue
                members = m.pg_raw_up(pg)
                taken = {dom[o] for o in members}
                doms = [d for d in rng.permutation(sorted(by_dom)).tolist()
                        if d not in taken][:len(members)]
                dsts = [int(rng.choice(by_dom[d])) for d in doms]
                items[f"{rep}.{s}"] = [[a, b] for a, b in zip(members, dsts)]
                wholesale[s] = (members, dsts)
                if len(items) == CP_WHOLESALE:
                    return items, wholesale

        # off the loop: the phase's own host work must not read as a
        # monitor's loop block
        snapshot = copy.deepcopy(leader.osdmap)
        items, wholesale = await asyncio.get_running_loop().run_in_executor(
            None, pick, snapshot)
        _, t["wholesale"], rec3 = await command(
            "wholesale upmap", {"prefix": "osd pg-upmap-items",
                                "items": items})

        # failover: the leader stops; the survivors elect and the next
        # balancer round commits on the new leader
        dead = leader.rank
        watch.step = "failover"
        t0 = time.perf_counter()
        await leader.stop()
        await cp_wait(lambda: any(cp_ready(m) for m in mons),
                      "no leader after the failover", 30.0)
        t["failover election"] = time.perf_counter() - t0
        leader2 = next(m for m in mons if cp_ready(m))
        round2 = await balancer_round("balancer round 2")
        t["failover to commit"] = time.perf_counter() - t0

        # revive the stopped monitor from its store
        watch.step = "revive"
        t0 = time.perf_counter()
        revived = new_mon(dead)
        await revived.start(*addrs[dead])
        mons[dead] = revived
        revived.set_monmap(addrs)
        await revived.begin_elections()
        await cp_wait(lambda: revived.leader_rank not in (None, dead),
                      "the revived monitor found no leader", 30.0)
        await revived._request_map_sync()
        live = [m for m in mons if m is not revived]
        await cp_wait(lambda: revived.osdmap.epoch == max(
            m.osdmap.epoch for m in live), "the revived monitor never "
            "caught up", 30.0)
        t["revive catch-up"] = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        t["path"] = time.perf_counter() - t_path
        counts = KERNELS.dump()["device_kernels"]
        launches = [(mod.launches, mod.kept_launches) for mod in gf8_mods]
        scorer.deviation_stats = inner_stats
        OSDMap._pool_raw = inner_raw
        # every monitor and the mgr at one epoch (the revival can start
        # an election, whose leader may commit nothing or a clog flush)
        await cp_wait(lambda: len({m.osdmap.epoch for m in mons}
                                  | {mgr.osdmap.epoch}) == 1,
                      "the monitors and the mgr never converged", 30.0)
        leader3 = next((m for m in mons if cp_ready(m)), leader2)
        return {"t": t, "mons": mons, "mgr": mgr, "leader": leader3,
                "dead": dead, "records": records, "plans": plans,
                "rounds": (round1, round2), "recs": (rec1, rec2, rec3),
                "pools": (rep, ec), "wholesale": wholesale,
                "counts": counts, "launches": launches,
                "revived": revived, "loop": watch.worst,
                "resumes": revived.perf.get("mon_store_resumes")}
    finally:
        scorer.deviation_stats = inner_stats
        OSDMap._pool_raw = inner_raw
        for task in tasks:
            task.cancel()
        if mgr is not None:
            await mgr.stop()
        for m in mons:
            if not m.stopped:
                await m.stop()
        tmp.cleanup()


def cp_state(m):
    """What every monitor and the mgr must agree on."""
    return (m.epoch, sorted(m.pools.items()),
            sorted((pg, [tuple(x) for x in v])
                   for pg, v in m.pg_upmap_items.items()),
            sorted((pg, list(v)) for pg, v in m.pg_temp.items()),
            list(m.osd_weight), sorted(m.flags))


def check_control_plane(out, dev, card: str):
    """Every check of the control-plane path, each a hard failure."""
    import copy

    import torch

    from ceph_tpu_torch.crush.mapper import TensorMapper
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osdmap.balancer import _failure_domains
    from ceph_tpu_torch.osdmap.osdmap import PGid

    t0 = time.perf_counter()
    mons, mgr, leader = out["mons"], out["mgr"], out["leader"]
    rep, ec = out["pools"]
    # one state everywhere
    states = [cp_state(m.osdmap) for m in mons] + [cp_state(mgr.osdmap)]
    if any(st != states[0] for st in states):
        raise AssertionError("the monitors and the mgr disagree on the map")
    if out["resumes"] != 1:
        raise AssertionError(f"the revived monitor resumed "
                             f"{out['resumes']} times")
    for m in [x.osdmap for x in mons] + [mgr.osdmap]:
        if m.scalar_fallbacks or m.device != dev or \
                TensorMapper.unsupported_reason(m.crush) is not None:
            raise AssertionError("a control-plane map left the card")
    if any(n for n, _k in out["launches"]):
        raise AssertionError(f"the control plane launched B1/B2: "
                             f"{out['launches']}")
    final = leader.osdmap
    # the rounds' moves: committed as planned, and legal
    for i, rnd in enumerate(out["rounds"], 1):
        old = pickle.loads(rnd["plan"]["old"])
        changes = rnd["plan"]["changes"]
        if len(changes) != rnd["res"]["moves"] or not changes:
            raise AssertionError(f"round {i}: {rnd['res']} vs {changes}")
        committed = {pg: [tuple(p) for p in v] for pg, v in
                     rnd["mint"]["inc"].new_pg_upmap_items.items()}
        if committed != {pg: [tuple(p) for p in v]
                         for pg, v in changes.items()}:
            raise AssertionError(f"round {i} committed other items")
        for pg, pairs in changes.items():
            dom = _failure_domains(old, old.pools[pg.pool].crush_rule)
            members = old.pg_raw_up(pg)
            for src, dst in pairs:
                others = {dom[o] for o in members
                          if o != src and o != CRUSH_ITEM_NONE}
                if src not in members or dst in members or \
                        dom[dst] in others:
                    raise AssertionError(f"round {i}: illegal move of {pg}:"
                                         f" {src}->{dst}, {members}")
            if [tuple(p) for p in final.pg_upmap_items.get(pg, [])] != \
                    [tuple(p) for p in pairs]:
                raise AssertionError(f"round {i}: {pg} not as committed")
    # the wholesale commit minted exactly its 64 PGs
    rec3 = out["recs"][2]
    minted = {pg.seed: v for pg, v in rec3["out"].items() if v}
    if set(minted) != set(out["wholesale"]) or \
            rec3["minted"] != CP_WHOLESALE or \
            any(minted[s] != a + b for s, (a, b) in
                out["wholesale"].items()):
        raise AssertionError(f"the wholesale commit minted "
                             f"{sorted(minted)[:8]}...")
    # the batched calls: 2 per pool of both maps a mint, and each plan's
    # 2 per pool for its skews and 1 per pool per optimizer iteration
    want_calls = [0, 2, 4, 4, 4]
    got_calls = [r["calls"] for r in out["records"]]
    if got_calls != want_calls:
        raise AssertionError(f"mint batched calls {got_calls}, want "
                             f"{want_calls}")
    for p in out["plans"]:
        if p["calls"] != p["pools"] * (2 + p["dstats"]):
            raise AssertionError(f"a plan made {p['calls']} batched calls "
                                 f"({p['dstats']} measurements)")
    both = 2 * (CP_REP_PGS + CP_EC_PGS)
    if [r["pgs"] for r in out["records"]] != \
            [0, 2 * CP_REP_PGS, both, both, both]:
        raise AssertionError("a mint mapped other PGs than its pools'")
    counts = out["counts"]
    total = sum(got_calls) + sum(p["calls"] for p in out["plans"])
    pgs = sum(r["pgs"] for r in out["records"]) + \
        sum(p["pgs"] for p in out["plans"])
    if counts.get("crush_map_calls", 0) != total or \
            counts.get("crush_map_pgs", 0) != pgs or \
            counts.get("crush_map_pad_lanes", 0):
        raise AssertionError(f"crush counters {counts}, want {total} calls"
                             f" of {pgs} PGs and no padded lane")
    # each mint against the per-PG scalar chain: 1,000 sampled seeds of
    # every pool, every seed its delta's upmaps touched, the wholesale 64;
    # and pool_raw_up (on the card) against the same rows
    rng = np.random.default_rng(SEED + 41)
    samples = {rep: set(rng.choice(CP_REP_PGS, CP_SAMPLE,
                                   replace=False).tolist()),
               ec: set(rng.choice(CP_EC_PGS, CP_SAMPLE,
                                  replace=False).tolist())}
    # a PG's scalar row is computed once for each distinct input it has
    # across the mints' maps (most PGs keep theirs from map to map)
    blobs, wanted, checks = {}, {}, []
    for rec in out["records"]:
        old = pickle.loads(rec["old"])
        new = copy.deepcopy(old)
        new.apply_incremental(copy.deepcopy(rec["inc"]))
        blob_key = len(blobs)
        blobs[blob_key] = pickle.dumps(old)
        blobs[blob_key + 1] = pickle.dumps(new)
        for pid in rec["pools_both"]:
            seeds = set(samples[pid]) | {
                pg.seed for pg in rec["inc"].new_pg_upmap_items
                if pg.pool == pid}
            if pid == rep and rec is rec3:
                seeds |= set(out["wholesale"])
            refs = []
            for mk, mp in ((blob_key, old), (blob_key + 1, new)):
                base = cp_placement_key(mp, pid)
                ref = {}
                for sd in seeds:
                    rk = (base, pid, sd, cp_seed_upmaps(mp, pid, sd))
                    wanted.setdefault(rk, mk)
                    ref[sd] = rk
                refs.append(ref)
            checks.append((rec, old, new, refs, pid, sorted(seeds)))
    jobs = {}
    for (_base, pid, sd, _up), mk in wanted.items():
        jobs.setdefault((mk, pid), set()).add(sd)
    blobs = {mk: b for mk, b in blobs.items()
             if any(k == mk for k, _p in jobs)}
    by_job = scalar_row_jobs(blobs, [(mk, pid, sorted(sds)) for
                                     (mk, pid), sds in jobs.items()],
                             raw=True)
    row_of = {rk: by_job[(mk, rk[1])][rk[2]] for rk, mk in wanted.items()}
    scalar_s = time.perf_counter() - t0
    n_seeds = n_raw = 0
    # pool_raw_up on the card against the same rows, on the final map
    # (the last mint's new map places as it does)
    last = {c[4]: c for c in checks if c[0] is checks[-1][0]}
    for pid in (rep, ec):
        got = final.pool_raw_up(pid)
        size = got.shape[1]
        _rec, _old, _new, refs, _pid, seeds = last[pid]
        for sd in seeds:
            row = row_of[refs[1][sd]]
            if got[sd].tolist() != row + [CRUSH_ITEM_NONE] * (size - len(row)):
                raise AssertionError(f"pool_raw_up {pid}.{sd}: "
                                     f"{got[sd].tolist()} != {row}")
            n_raw += 1
    for rec, old, new, (ro, rn), pid, seeds in checks:
        for s in seeds:
            want = cp_scalar_mint(old, new, rec["inc"], pid, s,
                                  row_of[ro[s]], row_of[rn[s]])
            got = rec["out"].get(PGid(pid, s))
            if PGid(pid, s) in rec["inc"].new_pg_temp:
                continue
            if (want or None) != (got or None):
                raise AssertionError(f"mint at epoch {rec['epoch']} PG "
                                     f"{pid}.{s}: {got} != scalar {want}")
            n_seeds += 1
    # the mapper rebuild each deep copy pays (the mint's new map, the
    # balancer's scratch), on the final map
    sync = torch.cuda.synchronize
    reps = []
    for _ in range(3):
        sync()
        a = time.perf_counter()
        c = copy.deepcopy(final)
        b = time.perf_counter()
        c.tensor_mapper
        sync()
        reps.append((b - a, time.perf_counter() - b))
    copy_s = statistics.median(r[0] for r in reps)
    build_s = statistics.median(r[1] for r in reps)
    log(f"control plane: every monitor and the mgr at epoch "
        f"{final.epoch} with equal pools, upmaps, pg_temp, weights and "
        f"flags; {n_seeds} minted-or-not PGs equal the per-PG scalar mint "
        f"and {n_raw} pool_raw_up rows of the final map the scalar chain "
        f"({len(row_of)} scalar rows in {scalar_s:.3f} s on the host); "
        f"the wholesale commit minted its {CP_WHOLESALE} PGs; the revived "
        f"mon resumed from its store once; B1/B2 launches 0; checks "
        f"{time.perf_counter() - t0:.3f} s")
    return {"copy_s": copy_s, "build_s": build_s}


def phase_control_plane(card: str, reset_counts, gf8_mods, dev=None):
    """The control plane on the card (``ceph_tpu_torch/cluster/{paxos,
    mon,monclient,mgr}.py``, ``balance/``): three monitors on 127.0.0.1,
    each with its FileStore in a temporary directory, and a mgr, all on
    ``cuda:0``, on ``build_three_level(39, 16, 16)`` (9,984 OSDs up and
    in).  Through the mgr's ``mon_command``: a replicated size-3 pool of
    65,536 PGs, an ISA k8m4 pool of 16,384 PGs on the mon's ``chooseleaf
    indep 12 type host`` rule, a balancer round that commits, an explicit
    ``osd pg-upmap-items`` that moves all three members of 64 PGs onto
    three other hosts (the mint makes 64 entries), the leader stopped and
    a second round committed on the new leader, and the stopped monitor
    revived from its store.  Counted from 0 just before the first create,
    read after the revival: B1 and B2 launch 0 times; ``crush_map_calls``
    is each mint's 2 per pool in both maps (0, 2, 4, 4, 4: the first
    create's pool is new, so its mint reads no placement) plus each
    balancer plan's 2 per pool for its skews and 1 per pool per optimizer
    measurement, and no lane is padded.  ``dev`` (``cuda:0`` unless
    named) is for a rehearsal on the CPU."""
    import asyncio

    import torch

    t0 = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    out = asyncio.run(asyncio.wait_for(
        control_plane(dev, card, reset_counts, gf8_mods), CP_BOUND_S))
    counts = out["counts"]
    log(f"main path (control plane): B1 launches {out['launches'][0][0]}, "
        f"B2 launches {out['launches'][1][0]}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    extra = check_control_plane(out, dev, card)
    t = out["t"]
    r1, r2 = out["rounds"]
    rec1, rec2, rec3 = out["recs"]
    ms = lambda s: f"{s * 1e3:.3f} ms"  # noqa: E731
    lag, where = out["loop"]
    log(f"control plane [{card}]: election to quorum "
        f"{ms(t['election'])}; create rbd ({CP_REP_PGS} PGs) "
        f"{ms(t['create rbd'])} to all three applied, its mint "
        f"{ms(rec1['mint_s'])} (no placement read); create ec "
        f"({CP_EC_PGS} PGs) {ms(t['create ec'])}, mint "
        f"{ms(rec2['mint_s'])}")
    def split(rec):
        """A mint's or a plan's whole-pool placements by pool, and the
        rest (deep copy, apply, masks, scoring)."""
        by = {}
        for pid, n, sec in rec["raw"]:
            by.setdefault((pid, n), []).append(sec)
        parts = [f"pool {pid} ({n} PGs) " + "/".join(
            f"{x * 1e3:.3f}" for x in v) + " ms"
            for (pid, n), v in sorted(by.items())]
        rest = rec.get("mint_s", rec.get("s")) - sum(
            sec for _p, _n, sec in rec["raw"])
        return "; ".join(parts + [f"rest {rest * 1e3:.3f} ms"])

    for label, rec in (("create ec mint", rec2), ("wholesale mint", rec3),
                       ("round 1 mint", r1["mint"]),
                       ("round 1 plan", r1["plan"]),
                       ("round 2 mint", r2["mint"]),
                       ("round 2 plan", r2["plan"])):
        log(f"control plane [{card}]: {label}: {split(rec)}")
    for i, r in enumerate((r1, r2), 1):
        log(f"control plane [{card}]: balancer round {i}: "
            f"{r['res']['moves']} moves, skew {r['res']['skew_before']} -> "
            f"{r['res']['skew_after']}, {r['plan']['dstats']} measurements; "
            f"scorer (plan) {ms(r['plan']['s'])}, commit {ms(r['commit'])} "
            f"to all applied (mint {ms(r['mint']['mint_s'])}), round "
            f"{ms(r['applied'])}")
    log(f"control plane [{card}]: wholesale upmap of {CP_WHOLESALE} PGs "
        f"{ms(t['wholesale'])} to all applied, mint {ms(rec3['mint_s'])} "
        f"({rec3['minted']} entries); mapper rebuild per deep copy "
        f"{ms(extra['build_s'])} (the copy itself {ms(extra['copy_s'])}); "
        f"longest loop block {ms(lag)} (in {where}); failover: election "
        f"{ms(t['failover election'])}, to the next commit "
        f"{ms(t['failover to commit'])}; revived mon's catch-up "
        f"{ms(t['revive catch-up'])}; the path {t['path']:.3f} s, the "
        f"phase {time.perf_counter() - t0:.3f} s")
    # the mgr gives a command up after CP_MGR_TIMEOUT_S (then retries):
    # every commit, from submit to all three monitors applied, lands first
    slowest = max([t["create rbd"], t["create ec"], t["wholesale"],
                   r1["commit"], r2["commit"]])
    if slowest > CP_MGR_TIMEOUT_S:
        raise AssertionError(f"a commit took {slowest:.3f} s, past the "
                             f"mgr's {CP_MGR_TIMEOUT_S} s timeout")
    return out


# -- the OSD cluster ---------------------------------------------------------

OC_OSDS = 24
OC_PER_HOST = 2                 # 12 hosts, the EC pools' failure domain
OC_MONS = 3
OC_OBJECT = 4 << 20             # rados bench's default object size
OC_INFLIGHT = 16                # rados bench's default ops in flight
# name, pool type, pg_num, profile, objects, the kernel its ticks run;
# a quarter of rados bench's 32 / 16 / 16 objects of a run at full size
# (half until a slow host took the script past its time)
OC_POOLS = (
    ("isa", "erasure", 256, {"plugin": "isa", "k": "8", "m": "4"}, 8, "B1"),
    ("cauchy", "erasure", 64, CAUCHY_PROFILE, 4, "B2"),
    ("rep", "replicated", 256, None, 4, None),
)
OC_VICTIM = 5
OC_STORE_BYTES = 512 << 20      # each OSD's BlueStore device
OC_BOUND_S = 420.0              # the whole path, client windows included
OC_WAIT_S = 120.0               # each wait for a map state or clean PGs


def oc_config():
    """vstart's test timings, with failure, lease and Paxos timeouts of
    Ceph's own order (a 1 s heartbeat, 20 s grace, 10 s lease and round
    timeouts; 24 OSDs pinging 23 peers every 0.1 s would fill one event
    loop with 5,520 round trips a second): the first map advance after a pool create maps the new
    pool on the event loop, and a 12-of-12-host erasure pool takes the
    batched mapper seconds on the card (its retries are launch-bound),
    a freeze the test timings would read as dead daemons.  Client-op
    deadlines that 16 ops of 4 MiB in flight on one host's loop cannot
    miss, and every pool's map advance through the whole-pool placement,
    which the daemons of the cluster share: the per-PG scalar chain (the
    option's default for pools under 256 PGs) would walk every PG of the
    64-PG pool on every OSD at every epoch."""
    from ceph_tpu_torch.cluster.vstart import _fast_config
    from ceph_tpu_torch.utils import Config

    return Config(**{**_fast_config().show(),
                     "osd_heartbeat_interval": 1.0,
                     "osd_heartbeat_grace": 20.0,
                     "mon_osd_beacon_grace": 20.0,
                     "mon_lease_ack_timeout": 10.0,
                     "mon_paxos_timeout": 10.0,
                     "osd_client_op_timeout": 120.0,
                     "osd_map_batch_min_pgs": 1})


OC_SETTLE_S = 30.0              # for pushes still landing after clean
OC_QUIET_S = 1.0                # no launch and no recovery work, once clean
# the OSDs' recovery counters each window reports beside its launches
OC_WORK = ("osd_peering_rounds", "osd_pg_recoveries", "osd_pushes_sent",
           "osd_read_repairs")


def oc_clean(cluster) -> bool:
    """Every OSD on the mon's epoch, no PG of any OSD unclean or waiting
    to peer, and no pg_temp left in the map: clean as the cluster itself
    reports it."""
    m = cluster.mon.osdmap
    return not m.pg_temp and all(
        o.osdmap is not None and o.osdmap.epoch == m.epoch
        and not o._unclean_pgs and not o._peering_pending
        for o in cluster.osds.values())


def oc_absent(cluster, objects):
    """(pg, oid, osd) of every acting member of an object's PG that does
    not hold it.  A slot CRUSH leaves empty stays empty: the mon's
    erasure rule (``chooseleaf indep 12 type host`` with the default 50
    tries, no ``set_choose_tries``) fills all 12 slots over 12 hosts for
    most PGs, not all."""
    from ceph_tpu_torch.cluster.pg import _coll
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    m = cluster.mon.osdmap
    objecter = cluster.clients[0].objecter
    out = []
    for pool_id, oid in objects:
        pgid = objecter.object_pgid(pool_id, oid)
        _, _, acting, _ = m.pg_to_up_acting_osds(pgid)
        out += [(str(pgid), oid, o) for o in acting
                if o != CRUSH_ITEM_NONE and (
                    o not in cluster.osds or cluster.osds[o].store.stat(
                        _coll(pgid), oid) is None)]
    return out


async def oc_settle(cluster, objects, what: str) -> float:
    """Clean as the cluster reports it (``OC_WAIT_S`` at most), then up to
    ``OC_SETTLE_S`` more for the pushes of the last rounds to land: a
    primary's round ends before its pushes are applied.  Raises if an
    acting member still lacks an object after that; the seconds to
    clean."""
    import asyncio

    t = await oc_wait(lambda: oc_clean(cluster), what,
                      lambda: oc_state(cluster, objects))
    t0 = time.perf_counter()
    while oc_absent(cluster, objects):
        if time.perf_counter() - t0 > OC_SETTLE_S:
            raise AssertionError(
                f"OSD cluster: {what}, but acting members lack objects "
                f"{OC_SETTLE_S} s later: {oc_state(cluster, objects)}")
        await asyncio.sleep(0.25)
    return t


def oc_work(cluster) -> dict:
    """``OC_WORK`` summed over the running OSDs."""
    return {n: sum(o.perf.get(n) for o in cluster.osds.values())
            for n in OC_WORK}


def oc_busy(cluster) -> list:
    """The OSDs with a peering pass running or a recovery retry armed."""
    return sorted(o.osd_id for o in cluster.osds.values()
                  if (o._peering_task is not None
                      and not o._peering_task.done())
                  or o._recovery_retry_tasks)


async def oc_quiesce(cluster, objects, gf8_mods, what: str) -> float:
    """After ``oc_settle``: until no OSD runs a peering pass or holds an
    armed retry, and neither the kernels' launch counts nor ``oc_work``
    move for ``OC_QUIET_S``, the cluster clean throughout (``OC_WAIT_S``
    at most); the seconds waited.  The cluster reads clean while the
    primary that a pg_temp clear made peers its PG, and that round may
    still rebuild an object: its launches belong to the window that
    caused it, not to the next one."""
    import asyncio

    t0 = since = time.perf_counter()
    last = None
    while True:
        now = time.perf_counter()
        state = (oc_launches(gf8_mods), oc_work(cluster))
        if not oc_clean(cluster) or oc_busy(cluster) or state != last:
            last, since = state, now
        elif now - since >= OC_QUIET_S:
            return now - t0
        if now - t0 > OC_WAIT_S:
            raise AssertionError(
                f"OSD cluster: {what}, but not quiet after {OC_WAIT_S} s: "
                f"peering or retrying on {oc_busy(cluster)}, recovery work "
                f"{oc_work(cluster)}; {oc_state(cluster, objects)}")
        await asyncio.sleep(0.1)


def oc_state(cluster, objects=()) -> str:
    """What keeps the cluster from clean: epochs, pg_temp entries, the
    unclean and pending PGs by OSD, and the acting members that lack an
    object."""
    m = cluster.mon.osdmap
    unclean = {o.osd_id: sorted(str(p) for p in o._unclean_pgs)[:4]
               for o in cluster.osds.values() if o._unclean_pgs}
    pending = {o.osd_id: len(o._peering_pending)
               for o in cluster.osds.values() if o._peering_pending}
    epochs = sorted({o.osdmap.epoch for o in cluster.osds.values()
                     if o.osdmap is not None})
    absent = oc_absent(cluster, objects) if objects else []
    # each unclean PG's up and acting sets as the mon has them, and the
    # objects every OSD holds in its collection (a stray included)
    from ceph_tpu_torch.cluster.pg import _coll

    pgs = {}
    for o in cluster.osds.values():
        for pgid in list(o._unclean_pgs)[:4]:
            up, _, acting, primary = m.pg_to_up_acting_osds(pgid)
            held = {d: sorted(x.store.list_objects(_coll(pgid)))
                    for d, x in cluster.osds.items()
                    if _coll(pgid) in x.store.list_collections()}
            pgs[str(pgid)] = (list(up), list(acting), primary, held)
    minted = cluster.mon.perf.get("mon_pg_temp_minted")
    # what made the epochs: OSDs marked down and booted again, clears
    mon = {n: sum(x.perf.get(f"mon_{n}") for x in cluster.mons)
           for n in ("osd_marked_down", "osd_boot", "pg_temp_requests")}
    out = [o for o in range(m.max_osd) if m.osd_weight[o] == 0]
    return (f"mon epoch {m.epoch}, OSD epochs {epochs}, pg_temp "
            f"{dict(list(m.pg_temp.items())[:4])} ({len(m.pg_temp)}, "
            f"{minted} minted), mon {mon}, out {out}, unclean {unclean}, "
            f"pending {pending}, up "
            f"{sum(m.osd_up)}/{m.max_osd}, absent {absent[:24]} "
            f"({len(absent)}); unclean PGs (up, acting, primary, objects "
            f"by OSD): {pgs}")


async def oc_wait(pred, what: str, describe=None) -> float:
    """Poll ``pred`` every 50 ms up to ``OC_WAIT_S``; the seconds it took.
    On a timeout the error carries ``describe()``."""
    import asyncio

    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > OC_WAIT_S:
            raise AssertionError(
                f"OSD cluster: {what} after {OC_WAIT_S} s"
                + (f": {describe()}" if describe else ""))
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def oc_ops(io, objs, write: bool):
    """Every object written (or read and compared) with ``OC_INFLIGHT``
    ops in flight; (wall seconds, per-op latencies)."""
    import asyncio

    sem = asyncio.Semaphore(OC_INFLIGHT)
    lat = []

    async def one(oid, data):
        async with sem:
            t0 = time.perf_counter()
            if write:
                await io.write_full(oid, data)
            else:
                got = await io.read(oid)
                if got != data:
                    raise AssertionError(f"OSD cluster: read of {oid} "
                                         "differs from what was written")
            lat.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    await asyncio.gather(*(one(o, d) for o, d in objs.items()))
    return time.perf_counter() - t0, lat


def oc_expected(profile, stripe_unit: int, objs):
    """Each object's shards as the port's plain CPU codec gives them
    (``factory(profile, device="cpu")``), in the stripe layout the mon
    gives the pool (``stripe_unit`` composed with the codec's, as
    ``Monitor._create_pool`` does), as bytes and, for a pool that keeps
    planes at rest, as the plane blob a store holds; (the stripe unit,
    {oid: [(bytes, planes or None) per shard]})."""
    from ceph_tpu_torch.ec import factory, planar_store, stripe

    codec = factory(profile, device="cpu")
    unit = codec.stripe_unit(stripe_unit)
    sinfo = stripe.StripeInfo(codec.get_data_chunk_count(), unit)
    planar = stripe.planar_at_rest_ok(codec, unit)
    out = {}
    for oid, data in objs.items():
        rows = stripe.encode_stripes(codec, sinfo, data)
        out[oid] = [(row.tobytes(), planar_store.planes_to_blob(
            planar_store.shard_to_planes(row.tobytes())) if planar else None)
            for row in rows]
    return unit, out


def oc_filled_slots(cluster, pool_id, oids) -> int:
    """The acting slots CRUSH fills for the pool's objects: objects x
    (k+m), less the slots it leaves NONE."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    m = cluster.mon.osdmap
    objecter = cluster.clients[0].objecter
    return sum(
        sum(o != CRUSH_ITEM_NONE for o in m.pg_to_up_acting_osds(
            objecter.object_pgid(pool_id, oid))[2]) for oid in oids)


def oc_check_shards(cluster, pool_id, expected, label: str) -> int:
    """Every shard every store holds for the pool's objects equals the
    plain codec's, in the layout the store holds it in (planes or
    bytes), and there are at least as many as the slots CRUSH fills;
    ``expected`` holds ``oc_digests`` of the plain codec's shards.  The
    shards compared."""
    from ceph_tpu_torch.ec import planar_store

    seen = 0
    for o, osd in cluster.osds.items():
        st = osd.store
        for coll in st.list_collections():
            if not coll.startswith(f"pg_{pool_id}_"):
                continue
            for oid in st.list_objects(coll):
                if oid not in expected:
                    continue
                s = int(st.getattr(coll, oid, "shard"))
                want, want_planes = expected[oid][s]
                if st.object_layout(coll, oid) == planar_store.LAYOUT_PLANAR:
                    got, want = st.read_planar(coll, oid), want_planes
                else:
                    got = st.read(coll, oid)
                if hashlib.sha256(got).digest() != want:
                    raise AssertionError(
                        f"OSD cluster ({label}): osd.{o} {coll}/{oid} shard "
                        f"{s} differs from the plain codec's")
                seen += 1
    want = oc_filled_slots(cluster, pool_id, expected)
    if seen < want:
        raise AssertionError(
            f"OSD cluster ({label}): pool {pool_id}'s stores hold {seen} "
            f"shards of its objects, fewer than the {want} slots CRUSH "
            "fills")
    return seen


def oc_launches(gf8_mods):
    return tuple((m.launches, m.kept_launches) for m in gf8_mods)


# -- phase 9's client windows: rados bench, RBD, CephFS, RGW, the sidecar ---

CW_BENCH_S = 2.0                # rados bench seconds per mode (write, seq)
                                # (3 s cut to 2, with the CephFS files and
                                # RGW objects halved, when phase 9 passed
                                # its 420 s bound by 0.5 s on a slow host)
CW_BLOCK = 4 << 20              # rados bench's default block
CW_RBD_SIZE = 32 << 20          # RBD's default layout: 4 MiB objects,
CW_RBD_OBJECT = 4 << 20         # stripe_unit = object size, stripe_count 1
                                # (64 MiB cut to 32 to keep phase 9 in
                                # its bound on a slow host)
CW_RBD_DEPTH = 8                # 4 MiB writes in flight
CW_RBD_SMALL = 16               # fio randwrite 4k: 16 distinct blocks
                                # (64 took 102.5 s of a 782 s call; 32
                                # took 47.8 s of a 750 s one)
CW_RBD_SMALL_DEPTH = 8          # in flight (32 timed ops out at 120 s)
CW_FS_FILES = 4                 # CephFS files of 4 MiB on the cauchy pool
CW_FS_FILE = 4 << 20
CW_FS_DEPTH = 4                 # files in flight (16 objects of 1 MiB)
CW_FS_LAYOUT = (1 << 16, 1, 1 << 20)    # fs.py's default file layout
CW_RGW_OBJECTS = 4              # signed S3 PUT/GET of 4 MiB objects
CW_RGW_OBJECT = 4 << 20
CW_RGW_PART = 5 << 20           # S3's smallest multipart part
CW_RGW_PARTS = 3
CW_RGW_ACCOUNT = ("AKSMOKE", "smoke-secret")
CW_SIDECAR_REQUESTS = 64        # concurrent cauchy encodes
CW_SIDECAR_CHUNK = 16 << 10     # w * packetsize bytes a chunk
CW_SIDECAR_ERASURES = (1, 10)
CW_SIDECAR_SRC = ("native", "ec_sidecar")
CW_SIDECAR_BUILD = ("ceph_tpu_torch", "_build", "ec_sidecar")
# each window and whether it must launch B1, B2: the ISA pool's I/O runs
# B1, the cauchy pool's B2; RGW's replicated pool and the sidecar's ISA
# profile (the byte-layout matmul) neither
CW_WINDOWS = (("rados bench", True, False), ("rbd", True, False),
              ("cephfs", False, True), ("rgw", False, False),
              ("sidecar isa", False, False), ("sidecar cauchy", False, True),
              ("client scrub", False, False))


def cw_sidecar_build():
    """Start the two ``g++`` builds of the EC plugin shim and its driver
    from ``native/ec_sidecar/`` into ``ceph_tpu_torch/_build/ec_sidecar/``,
    side by side; (shim, driver, processes)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, *CW_SIDECAR_SRC)
    out = os.path.join(root, *CW_SIDECAR_BUILD)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libec_jax.so")
    drv = os.path.join(out, "ec_jax_driver")
    procs = [subprocess.Popen(
        ["g++", "-O2", "-fPIC", "-shared", "-o", so,
         os.path.join(src, "libec_jax.cc")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        subprocess.Popen(
        ["g++", "-O2", "-o", drv, os.path.join(src, "driver.cc"), "-ldl"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    return so, drv, procs


def cw_inputs():
    """Everything the client windows write, from the seed: the RBD image,
    its 4 KiB overwrites and the host model of the image after them, the
    CephFS files, the RGW objects and parts, the bench block and the
    sidecar's cauchy requests."""
    rng = np.random.default_rng(SEED + 1100)
    inputs = {}
    image = rng.integers(0, 256, CW_RBD_SIZE, dtype=np.uint8)
    blocks = np.sort(rng.choice(CW_RBD_SIZE >> 12, CW_RBD_SMALL,
                                replace=False))
    patches = rng.integers(0, 256, (CW_RBD_SMALL, 4096), dtype=np.uint8)
    inputs["rbd_base"] = image.tobytes()
    inputs["rbd_small"] = [(int(b) << 12, patches[i].tobytes())
                           for i, b in enumerate(blocks)]
    for b, p in zip(blocks, patches):
        image[b << 12:(b + 1) << 12] = p
    inputs["rbd_model"] = image.tobytes()
    inputs["bench_blob"] = b"\xa5" * CW_BLOCK     # rados bench's block
    inputs["fs_files"] = [
        rng.integers(0, 256, CW_FS_FILE, dtype=np.uint8).tobytes()
        for _ in range(CW_FS_FILES)]
    inputs["rgw_objects"] = {
        f"obj{i}": rng.integers(0, 256, CW_RGW_OBJECT,
                                dtype=np.uint8).tobytes()
        for i in range(CW_RGW_OBJECTS)}
    inputs["rgw_parts"] = [rng.integers(0, 256, CW_RGW_PART,
                                        dtype=np.uint8).tobytes()
                           for _ in range(CW_RGW_PARTS)]
    k = int(CAUCHY_PROFILE["k"])
    inputs["sidecar_reqs"] = rng.integers(
        0, 256, (CW_SIDECAR_REQUESTS, k, CW_SIDECAR_CHUNK), dtype=np.uint8)
    return inputs


def oc_data():
    """The OSD cluster's objects of each pool, from the seed."""
    rng = np.random.default_rng(SEED + 1000)
    return {name: {f"{name}_{i}": rng.integers(
        0, 256, OC_OBJECT, dtype=np.uint8).tobytes() for i in range(n_obj)}
        for name, _t, _pg, _p, n_obj, _k in OC_POOLS}


# the module constants a worker process takes from its parent (a
# rehearsal on the CPU sets smaller ones)
OC_WORKER_CONSTS = ("SEED", "OC_POOLS", "OC_OBJECT", "CAUCHY_PROFILE",
                    "CW_BLOCK", "CW_RBD_SIZE", "CW_RBD_OBJECT",
                    "CW_RBD_SMALL", "CW_FS_FILES", "CW_FS_FILE",
                    "CW_FS_LAYOUT", "CW_RGW_OBJECTS", "CW_RGW_OBJECT",
                    "CW_RGW_PART", "CW_RGW_PARTS", "CW_SIDECAR_REQUESTS",
                    "CW_SIDECAR_CHUNK", "CW_SIDECAR_ERASURES")


def oc_digests(shards):
    """[(bytes, planes or None)] -> the same with sha256 digests."""
    return [(hashlib.sha256(b).digest(),
             None if p is None else hashlib.sha256(p).digest())
            for b, p in shards]


def oc_expected_worker(stripe_unit: int, consts):
    """In a spawned process, while the cluster boots and runs: the plain
    CPU codec's shards (``oc_expected``) of the phase's objects and of
    the client windows' RBD and CephFS objects, as digests, and the
    sidecar's expected parity and rebuilt chunks.  The CephFS objects are
    keyed by file and object number (the inode numbers come from the
    MDS)."""
    import torch

    from ceph_tpu_torch.cluster.striper import FileLayout, StripedReader
    from ceph_tpu_torch.cluster.striper import file_to_extents
    from ceph_tpu_torch.ec import factory

    globals().update(consts)
    torch.set_num_threads(3)       # the cluster's host threads run beside
    data, inputs = oc_data(), cw_inputs()
    out = {"oc": {}}
    for name, _t, _pg, prof, _n, _k in OC_POOLS:
        if prof:
            _unit, shards = oc_expected(prof, stripe_unit, data[name])
            out["oc"][name] = {o: oc_digests(v) for o, v in shards.items()}
    model = inputs["rbd_model"]
    _unit, shards = oc_expected(dict(OC_POOLS[0][3]), stripe_unit, {
        "rbd_data.img.%016x" % i: model[i * CW_RBD_OBJECT:
                                        (i + 1) * CW_RBD_OBJECT]
        for i in range(CW_RBD_SIZE // CW_RBD_OBJECT)})
    out["rbd"] = {o: oc_digests(v) for o, v in shards.items()}
    su, sc, osz = CW_FS_LAYOUT
    layout = FileLayout(stripe_unit=su, stripe_count=sc, object_size=osz)
    objs = {}
    for i, blob in enumerate(inputs["fs_files"]):
        ex = file_to_extents("%d", layout, 0, len(blob))
        for oid, parts in StripedReader.scatter(ex, blob).items():
            buf = bytearray()
            for off, part in parts:
                buf[off:off + len(part)] = part
            objs[f"{i}/{oid}"] = bytes(buf)
    _unit, shards = oc_expected(dict(CAUCHY_PROFILE), stripe_unit, objs)
    out["fs"] = {o: oc_digests(v) for o, v in shards.items()}
    reqs = inputs["sidecar_reqs"]
    cpu = factory(dict(CAUCHY_PROFILE), device="cpu")
    parity = cpu.encode_batch(reqs).numpy()
    full = np.concatenate([reqs[:1], parity[:1]], axis=1).copy()
    want = full[0, list(CW_SIDECAR_ERASURES)].copy()
    full[0, list(CW_SIDECAR_ERASURES)] = 0
    rebuilt = cpu.decode_batch(CW_SIDECAR_ERASURES, full).numpy()[0]
    if not np.array_equal(rebuilt, want):
        raise AssertionError("sidecar: the plain codec's decode does not "
                             "rebuild the erased chunks")
    out["sidecar"] = (parity, full[0], rebuilt)
    return out


class TimedIo:
    """An IoCtx that times every ``write_full`` and ``read`` and compares
    every read with the block written: ``rados bench`` reports p50, p95
    and the maximum, and reads its block back unchecked."""

    def __init__(self, io, want: bytes):
        self._io, self._want = io, want
        self.lat = {"write": [], "read": []}

    def __getattr__(self, name):
        return getattr(self._io, name)

    async def write_full(self, oid, data, *args, **kwargs):
        t0 = time.perf_counter()
        out = await self._io.write_full(oid, data, *args, **kwargs)
        self.lat["write"].append(time.perf_counter() - t0)
        return out

    async def read(self, oid, *args, **kwargs):
        t0 = time.perf_counter()
        got = await self._io.read(oid, *args, **kwargs)
        self.lat["read"].append(time.perf_counter() - t0)
        if got != self._want:
            raise AssertionError(f"rados bench: read of {oid} differs "
                                 "from the block written")
        return got


async def cw_ops(jobs, depth: int):
    """Run the coroutine factories ``jobs`` with ``depth`` in flight;
    (wall seconds, per-op latencies, results)."""
    import asyncio

    sem = asyncio.Semaphore(depth)
    lat = []

    async def one(job):
        async with sem:
            t0 = time.perf_counter()
            res = await job()
            lat.append(time.perf_counter() - t0)
            return res

    t0 = time.perf_counter()
    res = await asyncio.gather(*(one(j) for j in jobs))
    return time.perf_counter() - t0, lat, res


async def cw_http(addr, method, path, body=b"", headers=None):
    """One HTTP/1.1 request on a fresh loopback connection: (status,
    headers, body)."""
    import asyncio

    reader, writer = await asyncio.open_connection(*addr)
    headers = dict(headers or {})
    headers["Content-Length"] = str(len(body))
    headers["Host"] = "s3.local"
    writer.write((f"{method} {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n").encode()
        + body)
    await writer.drain()
    status = int((await reader.readline()).decode().split(" ", 2)[1])
    rh = {}
    while True:
        line = (await reader.readline()).decode().strip()
        if not line:
            break
        k, v = line.split(":", 1)
        rh[k.strip().lower()] = v.strip()
    n = 0 if method == "HEAD" else int(rh.get("content-length", "0"))
    data = await reader.readexactly(n)
    writer.close()
    return status, rh, data


def cw_signed(method, path, body=b"", query=None):
    """S3 v2-lite signature headers of ``RGWFrontend.sign``."""
    from ceph_tpu_torch.cluster.rgw_http import RGWFrontend

    date = str(time.time())
    access, secret = CW_RGW_ACCOUNT
    return {"Authorization": RGWFrontend.sign(
        method, path, date, access, secret, body=body, query=query),
        "x-amz-date": date}


def cw_sidecar_request(op, profile, k, m, chunk, data, erasures=()):
    """One request of the sidecar's documented protocol, length-prefixed."""
    import struct

    prof = json.dumps(profile)
    body = (bytes([op]) + struct.pack("<H", len(prof)) + prof.encode()
            + bytes([k, m, len(erasures)]) + bytes(erasures)
            + struct.pack("<I", chunk) + data.tobytes())
    return struct.pack("<I", len(body)) + body


async def cw_sidecar_send(sock, frame):
    import asyncio
    import struct

    reader, writer = await asyncio.open_unix_connection(sock)
    writer.write(frame)
    await writer.drain()
    (n,) = struct.unpack("<I", await reader.readexactly(4))
    reply = await reader.readexactly(n)
    writer.close()
    return reply


async def client_windows(cluster, client, pools, dev, inputs, shards, out,
                         watch, window, reset_counts, store_dir, build):
    """Phase 9's client windows on the running cluster, each counted from
    0 just before and read just after: rados bench on the ISA pool, an
    RBD image on the ISA pool, CephFS with its data on the cauchy pool
    and its metadata on the replicated one, RGW's S3 frontend on the
    replicated pool, and the EC sidecar with the native shim's driver
    and 64 concurrent cauchy requests; then a deep scrub of the EC PGs
    the windows wrote.  ``inputs`` are ``cw_inputs()``, ``shards`` what
    ``oc_expected_worker`` returned."""
    import asyncio
    import os

    from ceph_tpu_torch.cluster.mds import MDSClient
    from ceph_tpu_torch.cluster.rbd import RBD
    from ceph_tpu_torch.cluster.rgw import RGW
    from ceph_tpu_torch.cluster.rgw_http import RGWFrontend
    from ceph_tpu_torch.tools import rados
    from ceph_tpu_torch.tools.ec_sidecar import Sidecar

    res = out["clients"] = {}
    wrote = {pools["isa"]: set(), pools["cauchy"]: set()}

    # rados bench at Ceph's defaults on the ISA pool: write, then seq
    watch.step = "rados bench"
    reset_counts()
    isa_io = client.ioctx(pools["isa"])
    timed = TimedIo(isa_io, inputs["bench_blob"])
    w = await rados.bench(timed, CW_BENCH_S, "write",
                          concurrency=OC_INFLIGHT, block_size=CW_BLOCK,
                          cleanup=False)
    s = await rados.bench(timed, CW_BENCH_S, "seq",
                          concurrency=OC_INFLIGHT, block_size=CW_BLOCK)
    window("rados bench")
    if len(timed.lat["read"]) != s["ops"] or \
            len(timed.lat["write"]) != w["ops"] or not s["ops"]:
        raise AssertionError("rados bench: the seq reads were not all "
                             "checked, or a mode ran no op")
    bench_oids = [o for o in await isa_io.list_objects()
                  if o.startswith("bench_")]
    if len(bench_oids) != w["ops"]:
        raise AssertionError(f"rados bench: {len(bench_oids)} objects for "
                             f"{w['ops']} writes")
    wrote[pools["isa"]].update(bench_oids)
    res["bench"] = (w, s, timed.lat)

    # RBD on the ISA pool: sequential 4 MiB writes, random 4 KiB
    # overwrites, a full read, a snapshot and its read
    watch.step = "rbd"
    reset_counts()
    rbd = RBD(client.ioctx(pools["isa"]))
    await rbd.create("img", CW_RBD_SIZE, stripe_unit=CW_RBD_OBJECT,
                     stripe_count=1, object_size=CW_RBD_OBJECT)
    img = await rbd.open("img")
    base = inputs["rbd_base"]
    seq_w = await cw_ops(
        [lambda o=o: img.write(o, base[o:o + CW_RBD_OBJECT])
         for o in range(0, CW_RBD_SIZE, CW_RBD_OBJECT)], CW_RBD_DEPTH)
    small_w = await cw_ops([lambda o=o, p=p: img.write(o, p)
                            for o, p in inputs["rbd_small"]],
                           CW_RBD_SMALL_DEPTH)
    t0 = time.perf_counter()
    got = await img.read(0, CW_RBD_SIZE)
    read_s = time.perf_counter() - t0
    if got != inputs["rbd_model"]:
        raise AssertionError("RBD: the image read differs from the host "
                             "model")
    await img.snap_create("s1")
    t0 = time.perf_counter()
    got = await img.read(0, CW_RBD_SIZE, snap_name="s1")
    snap_s = time.perf_counter() - t0
    if got != inputs["rbd_model"]:
        raise AssertionError("RBD: the snapshot read differs from the host "
                             "model")
    window("rbd")
    wrote[pools["isa"]].update(shards["rbd"])
    wrote[pools["isa"]].add("rbd_header.img")
    res["rbd"] = (seq_w[:2], small_w[:2], read_s, snap_s)

    # CephFS: an MDS rank on the cluster's device, metadata on the
    # replicated pool, data on the cauchy pool
    watch.step = "cephfs"
    reset_counts()
    t0 = time.perf_counter()
    mds = await cluster.start_mds(pools["rep"], pools["cauchy"])
    if mds.device != dev or mds._client.objecter.device != dev:
        raise AssertionError("CephFS: the MDS is off the card")
    t1 = time.perf_counter()
    while not (getattr(client.objecter.osdmap, "mds_addrs", None)
               or {}).get(0):
        if time.perf_counter() - t1 > OC_WAIT_S:
            raise AssertionError("CephFS: the MDS never reached the map")
        await client.objecter._refresh_map()
        await asyncio.sleep(0.05)
    mds_s = time.perf_counter() - t0
    fs = MDSClient(client, pools["cauchy"], meta_pool=pools["rep"])
    await fs.mkdir("/d")
    paths = [f"/d/f{i}" for i in range(CW_FS_FILES)]
    create = await cw_ops([lambda p=p: fs.create(p) for p in paths], 1)
    files = inputs["fs_files"]
    fs_w = await cw_ops([lambda p=p, d=d: fs.write(p, 0, d)
                         for p, d in zip(paths, files)], CW_FS_DEPTH)
    fs_r = await cw_ops([lambda p=p: fs.read(p) for p in paths],
                        CW_FS_DEPTH)
    if fs_r[2] != files:
        raise AssertionError("CephFS: a file read differs from what was "
                             "written")
    names = await fs.listdir("/d")
    stats = [await fs.stat(p) for p in paths]
    window("cephfs")
    if names != sorted(p.rsplit("/", 1)[1] for p in paths) or any(
            st.size != CW_FS_FILE or st.mode != "file" for st in stats):
        raise AssertionError(f"CephFS: listdir {names} or a stat is wrong")
    if any(st.layout is not None and (st.layout.stripe_unit,
                                      st.layout.stripe_count,
                                      st.layout.object_size)
           != CW_FS_LAYOUT for st in stats):
        raise AssertionError("CephFS: a file's layout is not the one its "
                             "shards were computed for")
    fs_expected = {}
    for key, want in shards["fs"].items():
        i, objno = key.split("/")
        fs_expected[f"{stats[int(i)].ino:x}.{int(objno):016x}"] = want
    wrote[pools["cauchy"]].update(fs_expected)
    res["cephfs"] = (mds_s, create[1], fs_w[:2], fs_r[:2])

    # RGW on the replicated pool, through the S3 frontend on loopback
    watch.step = "rgw"
    reset_counts()
    fe = RGWFrontend(RGW(client.ioctx(pools["rep"])),
                     accounts=dict([CW_RGW_ACCOUNT]))
    addr = await fe.start()
    try:
        st, _, _ = await cw_http(addr, "PUT", "/smoke",
                                 headers=cw_signed("PUT", "/smoke"))
        if st != 200:
            raise AssertionError(f"RGW: bucket create answered {st}")
        objs = inputs["rgw_objects"]

        async def put(key, data):
            path = f"/smoke/{key}"
            st, h, _ = await cw_http(addr, "PUT", path, data,
                                     cw_signed("PUT", path, data))
            return st, h.get("etag")

        async def get(key):
            path = f"/smoke/{key}"
            st, h, body = await cw_http(addr, "GET", path,
                                        headers=cw_signed("GET", path))
            return st, h.get("etag"), body

        puts = await cw_ops([lambda k=k, d=d: put(k, d)
                             for k, d in objs.items()], CW_RGW_OBJECTS)
        gets = await cw_ops([lambda k=k: get(k) for k in objs],
                            CW_RGW_OBJECTS)
        for (key, data), (pst, petag), (gst, getag, body) in zip(
                objs.items(), puts[2], gets[2]):
            etag = f'"{hashlib.md5(data).hexdigest()}"'
            if (pst, gst) != (200, 200) or petag != etag or \
                    getag != etag or body != data:
                raise AssertionError(f"RGW: {key} answered {pst}/{gst}, "
                                     "or its ETag or bytes differ")
        # one multipart upload of three 5 MiB parts
        t0 = time.perf_counter()
        path = "/smoke/multi"
        st, _, body = await cw_http(
            addr, "POST", path + "?uploads",
            headers=cw_signed("POST", path, query={"uploads": ""}))
        upload = body.decode().split("<UploadId>")[1].split("<")[0]
        part_etags = []
        for n, part in enumerate(inputs["rgw_parts"], 1):
            q = {"partNumber": str(n), "uploadId": upload}
            st, h, _ = await cw_http(
                addr, "PUT", f"{path}?partNumber={n}&uploadId={upload}",
                part, cw_signed("PUT", path, part, query=q))
            if st != 200 or h.get("etag") != \
                    f'"{hashlib.md5(part).hexdigest()}"':
                raise AssertionError(f"RGW: part {n} answered {st}")
            part_etags.append(h["etag"].strip('"'))
        st, _, body = await cw_http(
            addr, "POST", f"{path}?uploadId={upload}",
            headers=cw_signed("POST", path, query={"uploadId": upload}))
        want = (hashlib.md5("".join(part_etags).encode()).hexdigest()
                + f"-{CW_RGW_PARTS}")
        if st != 200 or f"&quot;{want}&quot;".encode() not in body:
            raise AssertionError(f"RGW: multipart complete answered {st}")
        st, h, body = await cw_http(addr, "GET", path,
                                    headers=cw_signed("GET", path))
        if st != 200 or h.get("etag") != f'"{want}"' or \
                body != b"".join(inputs["rgw_parts"]):
            raise AssertionError("RGW: the multipart object's ETag or "
                                 "bytes differ")
        multi_s = time.perf_counter() - t0
    finally:
        await fe.stop()
    window("rgw")
    res["rgw"] = (puts[:2], gets[:2], multi_s)

    # the EC sidecar: the native shim's driver (ISA), then concurrent
    # cauchy requests over the documented protocol
    watch.step = "sidecar"
    sock = f"{store_dir}/ec.sock"
    sidecar = Sidecar(device=dev)
    server = await asyncio.start_unix_server(sidecar.handle, path=sock)
    try:
        so, drv, procs = build
        t0 = time.perf_counter()
        for p in procs:
            text = p.communicate(timeout=120)[0].decode()
            if p.returncode:
                raise AssertionError(f"sidecar: g++ failed: {text}")
        build_s = time.perf_counter() - t0
        reset_counts()
        proc = await asyncio.create_subprocess_exec(
            drv, so, env=dict(os.environ, EC_JAX_SIDECAR=sock),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        drv_out, drv_err = await asyncio.wait_for(proc.communicate(), 120)
        window("sidecar isa")
        if proc.returncode or b'"native_seam": "ok"' not in drv_out:
            raise AssertionError(f"sidecar: the driver failed: {drv_out!r} "
                                 f"{drv_err!r}")
        driver = json.loads(drv_out.decode().strip().splitlines()[-1])
        isa_counts = (sidecar.requests, sidecar.batches)
        reqs = inputs["sidecar_reqs"]
        parity, full, rebuilt = shards["sidecar"]
        k, m = int(CAUCHY_PROFILE["k"]), int(CAUCHY_PROFILE["m"])
        reset_counts()
        t0 = time.perf_counter()
        replies = await asyncio.gather(*(
            cw_sidecar_send(sock, cw_sidecar_request(
                1, CAUCHY_PROFILE, k, m, CW_SIDECAR_CHUNK, r))
            for r in reqs))
        enc_s = time.perf_counter() - t0
        dec = await cw_sidecar_send(sock, cw_sidecar_request(
            2, CAUCHY_PROFILE, k, m, CW_SIDECAR_CHUNK, full,
            CW_SIDECAR_ERASURES))
        window("sidecar cauchy")
        requests = sidecar.requests - isa_counts[0]
        batches = sidecar.batches - isa_counts[1]
        for i, reply in enumerate(replies):
            if reply[0] != 0 or reply[1:] != parity[i].tobytes():
                raise AssertionError(f"sidecar: cauchy request {i}'s parity "
                                     "differs from the plain CPU codec's")
        if dec[0] != 0 or dec[1:] != rebuilt.tobytes():
            raise AssertionError("sidecar: the rebuilt chunks differ from "
                                 "the plain CPU codec's")
        if not batches < requests:
            raise AssertionError(f"sidecar: {batches} batches for "
                                 f"{requests} requests: no coalescing")
    finally:
        server.close()
        await server.wait_closed()
    res["sidecar"] = (build_s, driver, isa_counts, (requests, batches),
                      enc_s)

    # the EC PGs the windows wrote, deep-scrubbed by their primaries
    watch.step = "client scrub"
    reset_counts()
    t0 = time.perf_counter()
    by_osd = {}
    for pool_id, oids in wrote.items():
        for oid in oids:
            pgid = client.objecter.object_pgid(pool_id, oid)
            primary = cluster.mon.osdmap.pg_to_up_acting_osds(pgid)[3]
            by_osd.setdefault(primary, set()).add(pgid)

    async def scrub(o, pgids):
        osd = cluster.osds[o]
        return [await osd.scrub_pg(osd.pgs[p]) for p in sorted(pgids)]

    reports = [r for rs in await asyncio.gather(*(
        scrub(o, p) for o, p in by_osd.items())) for r in rs]
    window("client scrub")
    bad = [oid for r in reports for oid in r["inconsistent"]]
    if bad:
        raise AssertionError(f"client windows: deep scrub found "
                             f"{len(bad)} inconsistent objects")
    res["scrub"] = (len(reports), len(bad), time.perf_counter() - t0)

    # every EC shard of the windows' objects equals the plain CPU codec's
    watch.step = "check"
    res["shards"] = {
        "rbd": oc_check_shards(cluster, pools["isa"], shards["rbd"],
                               "rbd"),
        "cephfs": oc_check_shards(cluster, pools["cauchy"], fs_expected,
                                  "cephfs")}


async def osd_cluster(dev, card: str, reset_counts, gf8_mods, store_dir):
    """The path itself: see ``phase_osd_cluster``."""
    import concurrent.futures
    import multiprocessing

    out = {"windows": {}, "work": {}, "t": {}, "io": {}}
    t0 = time.perf_counter()
    data, inputs = oc_data(), cw_inputs()
    out["t"]["inputs"] = time.perf_counter() - t0
    cfg = oc_config()
    # the plain codec's shards are computed in a spawned process while
    # the cluster runs (on its event loop they would read as dead
    # daemons), and the sidecar's shim and driver build meanwhile
    build = cw_sidecar_build()
    workers = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        fut = workers.submit(oc_expected_worker, cfg.osd_ec_stripe_unit,
                             {k: globals()[k] for k in OC_WORKER_CONSTS})
        return await osd_cluster_run(dev, card, reset_counts, gf8_mods,
                                     store_dir, out, data, inputs, cfg,
                                     build, fut, workers)
    finally:
        workers.shutdown(wait=True, cancel_futures=True)
        for p in build[2]:
            if p.poll() is None:
                p.kill()
                p.wait()


async def osd_cluster_run(dev, card, reset_counts, gf8_mods, store_dir,
                          out, data, inputs, cfg, build, fut, workers):
    """``osd_cluster`` once the sidecar's builds and the expected shards'
    worker have started; phase 10a's load window last, on the same
    cluster (``workers`` computes its plain shards)."""
    import asyncio

    import torch

    from ceph_tpu_torch.cluster.bluestore import BlueStore
    from ceph_tpu_torch.cluster.vstart import start_cluster
    from ceph_tpu_torch.ec import factory

    units = {name: factory(prof, device="cpu").stripe_unit(
        cfg.osd_ec_stripe_unit) for name, _t, _pg, prof, _n, _k in OC_POOLS
        if prof}
    watch = LoopWatch()
    # the shard checks read every store on the loop: the phase's work
    watch.OWN = LoopWatch.OWN + ("check",)
    watch_task = asyncio.get_running_loop().create_task(watch.run())
    t0 = time.perf_counter()
    cluster = await start_cluster(
        OC_OSDS, osds_per_host=OC_PER_HOST, n_mons=OC_MONS, with_mgr=True,
        config=cfg,
        store_factory=lambda o: BlueStore(f"{store_dir}/osd{o}",
                                          size=OC_STORE_BYTES),
        device=dev)
    try:
        if any(d.device != dev for d in
               list(cluster.osds.values()) + cluster.mons + [cluster.mgr]):
            raise AssertionError("OSD cluster: a daemon is off the card")
        out["t"]["boot"] = time.perf_counter() - t0
        watch.step = "pools"
        client = await cluster.client()
        if client.objecter.device != dev:
            raise AssertionError("OSD cluster: the client is off the card")
        pools = {}
        for name, ptype, pg_num, prof, _n, _k in OC_POOLS:
            t1 = time.perf_counter()
            pid = await client.pool_create(
                name, ptype, pg_num=pg_num, size=3,
                ec_profile=dict(prof) if prof else None)
            pools[name] = pid
            out["t"][f"create {name}"] = time.perf_counter() - t1
            if prof and int(cluster.mon.osdmap.pools[pid].ec_profile[
                    "stripe_unit"]) != units[name]:
                raise AssertionError(f"OSD cluster: pool {name}'s stripe "
                                     "unit is not the one checked against")
        out["t"]["pools clean"] = await oc_wait(
            lambda: oc_clean(cluster), "PGs clean after the creates",
            lambda: oc_state(cluster))

        work0 = {}

        def reset():
            """The launch counts to 0 and the recovery work's mark."""
            reset_counts()
            work0.update(oc_work(cluster))

        def window(label):
            torch.cuda.synchronize(dev) if dev.type == "cuda" else None
            out["windows"][label] = oc_launches(gf8_mods)
            work = out["work"][label] = {
                n: v - work0.get(n, 0) for n, v in oc_work(cluster).items()}
            log(f"OSD cluster: window {label} closed "
                f"{time.perf_counter() - t0:.3f} s after the boot began; "
                f"the OSDs' recovery work in it {json.dumps(work)}")

        for name, *_rest in OC_POOLS:
            io = client.ioctx(pools[name])
            watch.step = f"write {name}"
            reset()
            w_s, w_lat = await oc_ops(io, data[name], write=True)
            watch.step = f"read {name}"
            r_s, r_lat = await oc_ops(io, data[name], write=False)
            window(name)
            out["io"][name] = (w_s, w_lat, r_s, r_lat)
        objects = [(pools[name], oid) for name in pools
                   for oid in data[name]]
        ticks = [(o.perf.get("osd_batch_ticks"),
                  o.perf.get("osd_batch_coalesced_ops"))
                 for o in cluster.osds.values()]
        out["ticks"] = (sum(a for a, _ in ticks), sum(b for _, b in ticks))
        watch.step = "scrub"
        reset()
        t1 = time.perf_counter()
        # the EC PGs that hold the phase's objects (the others are empty;
        # scrubbing all 320 took 9-18 s)
        ec_pgs = {client.objecter.object_pgid(pools[name], oid)
                  for name in ("isa", "cauchy") for oid in data[name]}

        async def scrub_primary_pgs(o):
            """One OSD deep-scrubs its primary PGs of ``ec_pgs`` in turn
            (``osd_max_scrubs`` 1); the OSDs scrub side by side."""
            reports = []
            for pgid, st in sorted(o.pgs.items()):
                if pgid in ec_pgs and st.primary == o.osd_id:
                    reports.append(await o.scrub_pg(st))
            return reports

        reports = [r for rs in await asyncio.gather(*(
            scrub_primary_pgs(o) for o in cluster.osds.values())) for r in rs]
        bad = [oid for r in reports for oid in r["inconsistent"]]
        scrubbed = len(reports)
        out["t"]["scrub"] = time.perf_counter() - t1
        window("scrub")
        if bad or scrubbed != len(ec_pgs):
            raise AssertionError(f"OSD cluster: deep scrub of {scrubbed} PGs "
                                 f"found {len(bad)} inconsistent objects")
        out["scrub"] = (scrubbed, len(bad))
        t1 = time.perf_counter()
        shards = await asyncio.wrap_future(fut)
        out["t"]["expected wait"] = time.perf_counter() - t1
        expected = shards["oc"]
        watch.step = "check"
        out["shards"] = {"written": {
            name: oc_check_shards(cluster, pools[name], expected[name],
                                  "written") for name in expected}}
        # one OSD stopped: down, out, and every PG clean again
        watch.step = "recovery"
        reset()
        epoch0 = cluster.mon.osdmap.epoch
        t1 = time.perf_counter()
        await cluster.kill_osd(OC_VICTIM)
        out["t"]["marked down"] = await oc_wait(
            lambda: not cluster.mon.osdmap.osd_up[OC_VICTIM], "never down")
        out["t"]["marked out"] = await oc_wait(
            lambda: cluster.mon.osdmap.osd_weight[OC_VICTIM] == 0,
            "never out")
        await oc_settle(cluster, objects, "PGs clean after the out")
        out["t"]["recovery"] = time.perf_counter() - t1
        out["t"]["recovery quiet"] = await oc_quiesce(
            cluster, objects, gf8_mods, "PGs clean after the out")
        out["recovery_epochs"] = cluster.mon.osdmap.epoch - epoch0
        watch.step = "reread"
        r_s, r_lat = 0.0, []
        for name, *_rest in OC_POOLS:
            s, lat = await oc_ops(client.ioctx(pools[name]), data[name],
                                  write=False)
            r_s += s
            r_lat += lat
        out["io"]["reread"] = (r_s, r_lat)
        window("recovery")
        watch.step = "check"
        out["shards"]["recovered"] = {
            name: oc_check_shards(cluster, pools[name], expected[name],
                                  "recovered") for name in expected}
        # the OSD back on a new, empty BlueStore: backfill
        watch.step = "backfill"
        reset()
        t1 = time.perf_counter()
        cluster.osd_stores[OC_VICTIM] = BlueStore(
            f"{store_dir}/osd{OC_VICTIM}-new", size=OC_STORE_BYTES)
        await cluster.revive_osd(OC_VICTIM, with_store=True)
        await oc_wait(lambda: cluster.mon.osdmap.osd_up[OC_VICTIM],
                      "never back up")
        try:
            await client.objecter.mon_command({"prefix": "osd in",
                                               "id": OC_VICTIM})
        except TimeoutError as e:
            raise AssertionError(
                f"OSD cluster: `osd in` never answered; "
                f"{oc_state(cluster, objects)}") from e
        await oc_wait(lambda: cluster.mon.osdmap.osd_weight[OC_VICTIM] > 0,
                      "never back in")
        await oc_settle(cluster, objects, "PGs clean after backfill")
        out["t"]["backfill"] = time.perf_counter() - t1
        out["t"]["backfill quiet"] = await oc_quiesce(
            cluster, objects, gf8_mods, "PGs clean after backfill")
        window("backfill")
        watch.step = "check"
        out["shards"]["backfilled"] = {
            name: oc_check_shards(cluster, pools[name], expected[name],
                                  "backfilled") for name in expected}
        victim = cluster.osds[OC_VICTIM]
        out["victim_shards"] = sum(
            len(victim.store.list_objects(c))
            for c in victim.store.list_collections() if c.startswith("pg_"))
        t1 = time.perf_counter()
        await client_windows(cluster, client, pools, dev, inputs, shards,
                             out, watch, window, reset, store_dir, build)
        out["t"]["clients"] = time.perf_counter() - t1
        out["t"]["phase 9"] = time.perf_counter() - t0
        if out["t"]["phase 9"] > OC_BOUND_S:
            raise AssertionError(
                f"OSD cluster: {out['t']['phase 9']:.1f} s past its "
                f"{OC_BOUND_S} s bound before the load window")
        t1 = time.perf_counter()
        await asyncio.wait_for(load_window(
            cluster, client, dev, workers, cfg.osd_ec_stripe_unit, out,
            watch, window, reset), LW_BOUND_S)
        out["t"]["load window"] = time.perf_counter() - t1
        out["loop_steps"] = dict(watch.by_step)
        watch.step = "teardown"
        out["map"] = (sum(o.map_advance_seconds
                          for o in cluster.osds.values()),
                      sum(o.map_advances for o in cluster.osds.values()),
                      cluster.mon.osdmap.epoch)
        out["targets"] = (client.objecter.target_seconds,
                          client.objecter.targets)
        out["loop"] = watch.worst
        last_map = pickle.dumps(cluster.osds[0].osdmap)
    finally:
        await cluster.stop()
        watch_task.cancel()
    out["t"]["path"] = time.perf_counter() - t0
    out["unshared"] = oc_unshared_advance(last_map, dev,
                                          cfg.osd_map_batch_min_pgs)
    return out


def oc_unshared_advance(map_blob: bytes, dev, batch_min: int):
    """One OSD's placement of one epoch without the cluster's shared
    cache: every pool of the last map snapshotted as an OSD's map advance
    does (``placement_snapshot``), on a copy as a full map arrives (its
    mapper not built yet); seconds."""
    from ceph_tpu_torch.osdmap.osdmap import placement_snapshot

    m = pickle.loads(map_blob).set_device(dev)
    t0 = time.perf_counter()
    for pool_id in sorted(m.pools):
        placement_snapshot(m, pool_id, batch_min)
    return time.perf_counter() - t0


def oc_pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_osd_cluster(card: str, reset_counts, gf8_mods, dev=None):
    """The OSD cluster (``ceph_tpu_torch/cluster/{osd,pg,pglog,
    backend_ec,backend_replicated,client_ops,recovery,scrub,sharded_wq,
    objecter,vstart}.py`` over the stores, messenger, batchers, monitors
    and mgr of earlier slices): ``start_cluster`` of 3 monitors, a mgr and
    24 OSDs on 12 hosts, each OSD on a BlueStore in a temporary
    directory, all on ``cuda:0``; pools ISA k8m4 (256 PGs, planes at rest,
    kernel B1), cauchy_good k8m4 (64 PGs, bytes at rest, kernel B2) and
    replicated size 3 (256 PGs); 8, 4 and 4 objects of 4 MiB (a quarter
    of rados bench's 32, 16 and 16) written and read back with up to 16
    ops in flight, the EC PGs holding them deep-scrubbed, one
    OSD stopped until it is down and out and every PG is clean, every
    object read again, the OSD revived on an empty BlueStore and
    backfilled.  Each pool's I/O, the scrub, the recovery and the
    backfill are counted windows: B1 launches on the ISA pool and not
    B2, B2 on the cauchy pool and not B1, neither on the replicated
    pool, every launch staged.  ``dev`` (``cuda:0`` unless named) is for
    a rehearsal on the CPU.  Returns the B1 and B2 launches summed over
    the windows."""
    import asyncio
    import tempfile

    import torch

    t0 = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_osds_") as tmp:
        # phase 9's own bound is checked before the load window opens
        out = asyncio.run(asyncio.wait_for(
            osd_cluster(dev, card, reset_counts, gf8_mods, tmp),
            OC_BOUND_S + LW_BOUND_S))
    wins = out["windows"]
    for label, ((b1, b1k), (b2, b2k)) in wins.items():
        log(f"main path (OSD cluster, {label}): B1 launches {b1} "
            f"({b1 - b1k} staged, {b1k} kept), B2 launches {b2} "
            f"({b2 - b2k} staged, {b2k} kept)")
        if b1k or b2k:
            raise AssertionError(f"OSD cluster ({label}): a kept launch")
    work = lambda label: json.dumps(out["work"][label])  # noqa: E731
    if wins["isa"][0][0] <= 0 or wins["isa"][1][0]:
        raise AssertionError("OSD cluster: the ISA pool's window is not "
                             f"B1 only; recovery work {work('isa')}")
    if wins["cauchy"][1][0] <= 0 or wins["cauchy"][0][0]:
        raise AssertionError("OSD cluster: the cauchy pool's window is not "
                             f"B2 only; recovery work {work('cauchy')}")
    if wins["rep"][0][0] or wins["rep"][1][0]:
        raise AssertionError("OSD cluster: the replicated pool launched an "
                             f"EC kernel; recovery work {work('rep')}")
    for label, b1_want, b2_want in CW_WINDOWS + (("load", True, False),):
        (b1, _), (b2, _) = wins[label]
        if (b1 > 0) != b1_want or (b2 > 0) != b2_want:
            raise AssertionError(
                f"client window {label}: B1 {b1}, B2 {b2} launches; "
                f"expected B1 {'some' if b1_want else 'none'}, B2 "
                f"{'some' if b2_want else 'none'}; the OSDs' recovery work "
                f"in it {work(label)}")
    ms = lambda s: f"{s * 1e3:.3f} ms"  # noqa: E731
    t = out["t"]
    for name, _pt, pg_num, _p, n_obj, kernel in OC_POOLS:
        w_s, w_lat, r_s, r_lat = out["io"][name]
        mb = n_obj * OC_OBJECT / 1e6
        log(f"OSD cluster [{card}]: pool {name} ({pg_num} PGs, "
            f"{n_obj} x {OC_OBJECT >> 10} KiB, {OC_INFLIGHT} in flight, kernel "
            f"{kernel or 'none'}): write {mb / w_s:.3f} MB/s, op latency "
            f"p50 {ms(oc_pct(w_lat, 0.5))} p99 {ms(oc_pct(w_lat, 0.99))}; "
            f"read {mb / r_s:.3f} MB/s, p50 {ms(oc_pct(r_lat, 0.5))} p99 "
            f"{ms(oc_pct(r_lat, 0.99))}")
    r_s, r_lat = out["io"]["reread"]
    total = sum(p[4] for p in OC_POOLS) * OC_OBJECT / 1e6
    ticks, tick_ops = out["ticks"]
    adv_s, advances, epochs = out["map"]
    tgt_s, tgts = out["targets"]
    lag, where = out["loop"]
    log(f"OSD cluster [{card}]: encode ticks {ticks} for {tick_ops} ops "
        f"({tick_ops / max(ticks, 1):.3f} ops a tick); deep scrub of "
        f"{out['scrub'][0]} EC PGs {t['scrub']:.3f} s, "
        f"{out['scrub'][1]} inconsistent")
    log(f"OSD cluster [{card}]: osd.{OC_VICTIM} stopped: down after "
        f"{t['marked down']:.3f} s, out after {t['marked out']:.3f} s, every "
        f"PG clean {t['recovery']:.3f} s after the stop "
        f"({out['recovery_epochs']} epochs), quiet {t['recovery quiet']:.3f} "
        f"s later; reread of all {total:.3f} MB "
        f"{total / r_s:.3f} MB/s, p50 {ms(oc_pct(r_lat, 0.5))} p99 "
        f"{ms(oc_pct(r_lat, 0.99))}; revived on an empty BlueStore, clean "
        f"after backfill in {t['backfill']:.3f} s ({out['victim_shards']} "
        f"objects back on it), quiet {t['backfill quiet']:.3f} s later")
    log(f"OSD cluster [{card}]: shards equal to the plain CPU codec's: "
        f"{json.dumps(out['shards'], sort_keys=True)}; every acting member "
        "holds every object after the recovery and the backfill")
    full_s = out["unshared"]
    log(f"OSD cluster [{card}]: map advances {advances} over {OC_OSDS} "
        f"OSDs and {epochs} epochs, {adv_s:.3f} s in all, "
        f"{adv_s / max(epochs, 1):.3f} s per epoch summed over the OSDs "
        f"sharing one placement cache; one OSD unshared, every pool of "
        f"one epoch: {full_s:.3f} s on a full map; "
        f"the client's scalar targeting {tgts} walks, {ms(tgt_s)}; "
        f"longest loop block {ms(lag)} (in {where}); boot "
        f"{t['boot']:.3f} s, pool creates "
        + ", ".join(f"{ms(t[f'create {p[0]}'])}" for p in OC_POOLS)
        + f", clean {t['pools clean']:.3f} s; the inputs from the seed "
        f"{t['inputs']:.3f} s (before the boot), the wait for the plain "
        f"codec's shards (a spawned process since before the boot) "
        f"{t['expected wait']:.3f} s; the path "
        f"{t['path']:.3f} s, the phase {time.perf_counter() - t0:.3f} s")
    cw_log(out, card)
    lw_log(out, card)
    b1 = sum(w[0][0] for w in wins.values())
    b2 = sum(w[1][0] for w in wins.values())
    return b1, b2, out["t"]["load window"]


def cw_log(out, card: str) -> None:
    """The client windows' lines: rates, latencies, the sidecar's
    coalescing, the scrub, the shard checks and the loop's blocks."""
    ms = lambda s: f"{s * 1e3:.3f} ms"  # noqa: E731
    res = out["clients"]
    w, s, lat = res["bench"]
    log(f"client windows [{card}]: rados bench (ISA pool, {CW_BLOCK >> 10} "
        f"KiB, {OC_INFLIGHT} in flight, {CW_BENCH_S} s a mode): write "
        f"{w['ops']} ops {w['mbps']:.3f} MB/s, p50 "
        f"{ms(oc_pct(lat['write'], 0.5))} p99 "
        f"{ms(oc_pct(lat['write'], 0.99))}; seq {s['ops']} ops "
        f"{s['mbps']:.3f} MB/s, p50 {ms(oc_pct(lat['read'], 0.5))} p99 "
        f"{ms(oc_pct(lat['read'], 0.99))}")
    (seq_s, _), (small_s, small_lat), read_s, snap_s = res["rbd"]
    mb = CW_RBD_SIZE / 1e6
    log(f"client windows [{card}]: RBD (ISA pool, {CW_RBD_SIZE >> 20} MiB "
        f"image, {CW_RBD_OBJECT >> 20} MiB objects): write {mb / seq_s:.3f} "
        f"MB/s ({CW_RBD_SIZE // CW_RBD_OBJECT} x {CW_RBD_OBJECT >> 20} MiB, "
        f"{CW_RBD_DEPTH} in flight); {CW_RBD_SMALL} random 4 KiB "
        f"overwrites ({CW_RBD_SMALL_DEPTH} in flight) {small_s:.3f} s, p50 {ms(oc_pct(small_lat, 0.5))} p99 "
        f"{ms(oc_pct(small_lat, 0.99))}; read {mb / read_s:.3f} MB/s; "
        f"snapshot read {mb / snap_s:.3f} MB/s")
    mds_s, create_lat, (fw_s, _), (fr_s, _) = res["cephfs"]
    mb = CW_FS_FILES * CW_FS_FILE / 1e6
    log(f"client windows [{card}]: CephFS (data on the cauchy pool, "
        f"metadata on the replicated pool; {CW_FS_FILES} x "
        f"{CW_FS_FILE >> 20} MiB files, {CW_FS_DEPTH} in flight): MDS start "
        f"{mds_s:.3f} s, create p50 {ms(oc_pct(create_lat, 0.5))}, write "
        f"{mb / fw_s:.3f} MB/s, read {mb / fr_s:.3f} MB/s")
    (put_s, put_lat), (get_s, get_lat), multi_s = res["rgw"]
    mb = CW_RGW_OBJECTS * CW_RGW_OBJECT / 1e6
    log(f"client windows [{card}]: RGW (replicated pool, signed S3 over "
        f"loopback, {CW_RGW_OBJECTS} x {CW_RGW_OBJECT >> 20} MiB): PUT "
        f"{mb / put_s:.3f} MB/s, p50 {ms(oc_pct(put_lat, 0.5))} p99 "
        f"{ms(oc_pct(put_lat, 0.99))}; GET {mb / get_s:.3f} MB/s, p50 "
        f"{ms(oc_pct(get_lat, 0.5))} p99 {ms(oc_pct(get_lat, 0.99))}; "
        f"multipart {CW_RGW_PARTS} x {CW_RGW_PART >> 20} MiB "
        f"{multi_s:.3f} s; ETags and bytes checked")
    build_s, driver, (ireq, ibat), (creq, cbat), enc_s = res["sidecar"]
    log(f"client windows [{card}]: EC sidecar: g++ builds waited "
        f"{build_s:.3f} s; native driver (ISA k8m4, 512 B chunks) "
        f"{json.dumps(driver, sort_keys=True)}, {ireq} requests in {ibat} "
        f"batches; cauchy_good k8m4 {CW_SIDECAR_REQUESTS} concurrent "
        f"encodes of {CW_SIDECAR_CHUNK >> 10} KiB chunks and one decode of "
        f"{CW_SIDECAR_ERASURES}: {creq} requests in {cbat} batches, the "
        f"encodes {ms(enc_s)}; every reply equal to the plain CPU codec's")
    pgs, bad, scrub_s = res["scrub"]
    log(f"client windows [{card}]: deep scrub of the {pgs} EC PGs the "
        f"windows wrote {scrub_s:.3f} s, {bad} inconsistent; shards equal "
        f"to the plain CPU codec's: "
        f"{json.dumps(res['shards'], sort_keys=True)}; longest loop block "
        "by window: " + ", ".join(
            f"{step} {ms(out['loop_steps'].get(step, 0.0))}"
            for step in ("rados bench", "rbd", "cephfs", "rgw", "sidecar",
                         "client scrub")) + f"; the windows "
        f"{out['t']['clients']:.3f} s")


# -- phase 10: the load driver and the chaos runner ---------------------------

LW_SPEC = "read-heavy"          # ceph_tpu_torch/load/driver.py's library
LW_PG_NUM = 256                 # Ceph's PG guidance for 24 OSDs, as phase 9's
LW_RATE = 1.2                   # ops/s a client: the spec's own offered rate
LW_BOUND_S = 150.0              # the load window: create, drive, checks
# the OSDs' counts of what fails an EC write without a map change: sub-writes
# shed past their deadline, sub-writes refused across a gap in a member's
# log, and the recovery rounds that resync such members
LW_OSD_COUNTERS = ("osd_sub_ops_shed_expired", "osd_ec_sub_write_gaps",
                   "osd_recovery_retries")
# (scenario, seed): the runner's library at its own sizes, each on a fresh
# cluster on the card; batch-smoke at the seed of the reference's tests,
# whose replay key must be the passing one of its schedule (the seed-replay
# contract; a second run of it, checked against the same key, was cut to
# keep the script in its time on a slow host)
CH_RUNS = (("batch-smoke", 31), ("thrash-ec-midwrite", SEED),
           ("bitrot-under-load", SEED))
CH_BOUND_S = 150.0              # one scenario, boot to teardown
RACE_RUN = ("batch-smoke", SEED)
RAMP_SCALES = (1, 2)            # 10d: the offered rate, then twice it
RAMP_BOUND_S = 60.0
SOAK_RUN = ("soak-mixed-crash", 17)   # the reference's soak test's seed
SOAK_BOUND_S = 90.0
# 10f: the port's load CLI on the card, as a user runs it, in a process of
# its own: the EC read-heavy, whose first window is its process's first
# work on the card (the replicated smoke-micro's process gave its time to
# 10g.2)
LOAD_CLIS = (("run", "--spec", "read-heavy", "--seed", "3",
              "--no-postmortem"),)
LOAD_CLI_BOUND_S = 45.0         # each command
# 10g: the elastic runner in process, the chaos CLI in a fresh process
ELASTIC_RUN = ("expand-drain-smoke", 7)   # the reference test's seed
ELASTIC_BOUND_S = 60.0
CHAOS_CLI_RUN = ("frontdoor-smoke", 7)    # the reference test's seed
CHAOS_CLI_BOUND_S = 60.0


def lw_spec():
    """The library's ``read-heavy`` spec at phase 9's PG count and at
    ``LW_RATE``: its profile, payloads, object space, verb mix and gates
    are the library's."""
    import dataclasses

    from ceph_tpu_torch.load.driver import builtin_specs

    return dataclasses.replace(builtin_specs()[LW_SPEC], pg_num=LW_PG_NUM,
                               rate=LW_RATE)


def lw_expected_worker(profile, stripe_unit: int, objs):
    """In the spawned worker: the plain CPU codec's shards of ``objs``
    (``oc_expected``), as digests."""
    import torch

    torch.set_num_threads(3)       # the cluster's host threads run beside
    _unit, shards = oc_expected(profile, stripe_unit, objs)
    return {o: oc_digests(v) for o, v in shards.items()}


async def load_window(cluster, client, dev, workers, stripe_unit, out,
                      watch, window, reset):
    """Phase 10a on phase 9's running cluster: ``LoadContext.create`` of
    ``lw_spec()`` (its EC pool and four client sessions), the PGs clean,
    then one ``run_load`` window counted from 0 just before and read just
    after, judged by the SLO gates from the mgr's scrape.  Every object
    the window left in the pool is then read back (a tracked object must
    hold a whole payload the window attempted) and every shard of it in
    every store held against the plain CPU codec's encode of the bytes
    read, computed in the spawned worker."""
    import asyncio

    from ceph_tpu_torch.cluster.pg import _coll
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.load.driver import LoadContext, run_load

    spec = lw_spec()
    profile = dict(spec.ec_profile)
    watch.step = "load setup"
    t0 = time.perf_counter()
    ctx = await LoadContext.create(spec, SEED, cluster=cluster)
    if any(c.objecter.device != dev for c in ctx.sessions):
        raise AssertionError("load window: a client session is off the card")
    pool = cluster.mon.osdmap.pools[ctx.pool]
    unit = factory(profile, device="cpu").stripe_unit(stripe_unit)
    if int(pool.ec_profile["stripe_unit"]) != unit or \
            pool.pg_num != LW_PG_NUM:
        raise AssertionError("load window: the pool is not the one checked")
    out["t"]["load create"] = time.perf_counter() - t0
    out["t"]["load clean"] = await oc_wait(
        lambda: oc_clean(cluster), "PGs clean after the load pool's create",
        lambda: oc_state(cluster))
    watch.step = "load window"

    def osd_sums():
        return {n: sum(osd.perf.get(n) for osd in cluster.osds.values())
                for n in LW_OSD_COUNTERS}

    before = osd_sums()
    reset()
    t1 = time.perf_counter()
    with lw_failed_ops() as failed:
        result, report = await run_load(spec, SEED, ctx=ctx,
                                        record_acked=True)
    out["t"]["load run"] = time.perf_counter() - t1
    window("load")
    osd_counts = {n: v - before[n] for n, v in osd_sums().items()}
    out["load"] = {"rows": report.as_rows(), "offered": result.offered,
                   "acked": result.acked_ops,
                   "completed": dict(result.completed),
                   "errors": dict(result.errors),
                   "read_misses": result.read_misses,
                   "late": len(result.late_acks),
                   "elapsed": result.elapsed, "plan_key": result.plan_key,
                   "osd": osd_counts,
                   "failed": [(kind, errno, verb, oid, str(
                       client.objecter.object_pgid(ctx.pool, oid)))
                              for kind, errno, verb, oid in failed]}
    if not report.passed:
        raise AssertionError(
            f"load window: SLO gates failed {report.failures()}; "
            f"offered {result.offered}, acked {result.acked_ops}, errors "
            f"{result.errors}; recovery work {out['work']['load']}")
    watch.step = "load check"
    t1 = time.perf_counter()
    oids = sorted({o for osd in cluster.osds.values()
                   for coll in osd.store.list_collections()
                   if coll.startswith(f"pg_{ctx.pool}_")
                   for o in osd.store.list_objects(coll)} & (
        {f"obj{r}" for r in range(spec.objects)}
        | {f"mob{r}" for r in range(spec.objects)}))
    io = ctx.io(0)
    got = {}
    for oid in oids:
        got[oid] = await io.read(oid, timeout=60)
        if oid.startswith("obj") and \
                got[oid] not in result.attempted.get(oid, ()):
            raise AssertionError(f"load window: {oid} holds bytes no write "
                                 "of the window attempted")
    expected = await asyncio.wrap_future(workers.submit(
        lw_expected_worker, profile, stripe_unit, got))
    out["load"]["objects"] = len(oids)
    out["load"]["shards"] = oc_check_shards(cluster, ctx.pool, expected,
                                            "load window")
    out["load"]["pgs"] = len({_coll(client.objecter.object_pgid(ctx.pool, o))
                              for o in oids})
    out["t"]["load check"] = time.perf_counter() - t1
    await ctx.close()


LW_VERBS = ("write_full", "write", "read", "append", "remove")


@contextlib.contextmanager
def lw_failed_ops():
    """Record each failed client op of the load window as (error,
    errno, IoCtx method, object): the driver counts its errors by type
    only.  The errno is the exception's, else the OSD's result code that
    the client's message carries (``read(obj0) -> -5: ...``), with the
    OSD's reason after it.  A read or remove of an absent object is a
    miss, not an error, as the driver counts it."""
    import re

    from ceph_tpu_torch.cluster.objecter import IoCtx

    failed = []
    real = {name: getattr(IoCtx, name) for name in LW_VERBS}

    def wrap(name, fn):
        async def call(self, oid, *args, **kwargs):
            try:
                return await fn(self, oid, *args, **kwargs)
            except FileNotFoundError:
                raise
            except (IOError, OSError, TimeoutError) as e:
                code = re.search(r"-> (-?\d+)(?:: (.*))?", str(e))
                errno = e.errno if e.errno is not None else (
                    int(code.group(1)) if code else None)
                why = (code.group(2) or "")[:80] if code else str(e)[:80]
                failed.append((f"{type(e).__name__} {why}".strip(), errno,
                               name, oid))
                raise
        return call

    for name, fn in real.items():
        setattr(IoCtx, name, wrap(name, fn))
    try:
        yield failed
    finally:
        for name, fn in real.items():
            setattr(IoCtx, name, fn)


def lw_log(out, card: str) -> None:
    """Phase 10a's lines: the gates, the offered and acked ops."""
    res, t = out["load"], out["t"]
    spec = lw_spec()
    for row in res["rows"]:
        log(f"load window [{card}]: gate {row['gate']}: value "
            f"{row['value']}, threshold {row['threshold']}, "
            f"{'pass' if row['passed'] else 'FAIL'} ({row['source']}"
            + (f"; {row['note']}" if row["note"] else "") + ")")
    log(f"load window [{card}]: spec {spec.name} ({spec.clients} clients "
        f"over {spec.sessions} sessions, {spec.rate} ops/s each for "
        f"{spec.duration} s, {spec.arrival}; zipf {spec.zipf_alpha} over "
        f"{spec.objects} objects, {spec.payload} B payloads; verbs "
        f"{dict(spec.verbs)}; pool jerasure reed_sol_van k2m1, "
        f"{LW_PG_NUM} PGs): offered {res['offered']} ops, acked "
        f"{res['acked']} {json.dumps(res['completed'], sort_keys=True)}, "
        f"errors {json.dumps(res['errors'], sort_keys=True)}, read misses "
        f"{res['read_misses']}, late acks {res['late']}, failed ops "
        f"(error, errno, verb, object, PG) {res['failed']}, OSD counts "
        f"{json.dumps(res['osd'], sort_keys=True)}; "
        f"{res['acked'] / max(t['load run'], 1e-9):.3f} acked ops/s over "
        f"the run's {t['load run']:.3f} s ({res['elapsed']:.3f} s between "
        f"the scrapes); plan {res['plan_key'][:16]}; {res['objects']} "
        f"objects in {res['pgs']} PGs read back, {res['shards']} shards "
        f"equal to the plain CPU codec's; pool create {t['load create']:.3f}"
        f" s, clean {t['load clean']:.3f} s, checks {t['load check']:.3f} s;"
        f" phase 10a {t['load window']:.3f} s")


class ChaosClock:
    """Wraps the scenario runner's heal, converge and judge seams to time
    them and to check the cluster's device; the runner itself is
    unchanged."""

    SEAMS = ("heal_cluster", "_converge", "judge_invariants")

    def __init__(self, mod, dev, seams=SEAMS):
        self.mod, self.dev, self.t = mod, dev, {}
        self.real = {n: getattr(mod, n) for n in seams}

    def __enter__(self):
        for name, fn in self.real.items():
            setattr(self.mod, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mod, name, fn)

    def _timed(self, name, fn):
        async def timed(cluster, *args, **kwargs):
            if any(d.device != self.dev for d in
                   list(cluster.osds.values()) + cluster.mons):
                raise AssertionError(f"chaos: a daemon is off {self.dev}")
            t0 = time.perf_counter()
            try:
                return await fn(cluster, *args, **kwargs)
            finally:
                self.t[name] = time.perf_counter() - t0
        return timed


def phase_chaos(card: str, reset_counts, gf8_mods, dev=None):
    """Phase 10b: ``run_scenario`` of each of ``CH_RUNS`` on its own fresh
    cluster, every daemon on ``dev`` (``cuda:0`` unless named, for a
    rehearsal), each run its own counted window; every verdict passes,
    B1 launches in each and B2 in none, and each replay key equals a
    passing verdict's on the schedule built from the seed (the seed-replay
    contract).  The runner's durability invariant reads back
    every acked object and checks its crc before the cluster stops.
    Returns the B1 and B2 launches summed."""
    import asyncio
    import tempfile

    import torch

    from ceph_tpu_torch.chaos import scenario as sc_mod
    from ceph_tpu_torch.chaos.integrity import integrity_scenarios

    dev = dev or torch.device("cuda", 0)
    lib = {**sc_mod.builtin_scenarios(),
           "bitrot-under-load": integrity_scenarios()["bitrot-under-load"]}
    b1_sum, b2_sum = 0, 0
    for name, seed in CH_RUNS:
        sc = lib[name]
        reset_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp, \
                ChaosClock(sc_mod, dev) as clock:
            v = asyncio.run(asyncio.wait_for(sc_mod.run_scenario(
                sc, seed, tmpdir=tmp, device=dev), CH_BOUND_S))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        (b1, b1k), (b2, b2k) = oc_launches(gf8_mods)
        sched = sc_mod.build_schedule(sc, seed)
        want = sc_mod.Verdict(name=name, seed=seed, schedule=sched,
                              passed=True, failures=[]).replay_key()
        faults = {k: n for k, n in sorted(v.counters.items())
                  if k not in ("epochs_generated", "storm_wall_ms")}
        log(f"chaos [{card}]: {name} seed {seed}: "
            f"{'PASS' if v.passed else 'FAIL'}, schedule of {len(sched)} "
            f"events, faults fired {json.dumps(faults)}, {v.acked_objects} "
            f"acked objects, {v.counters.get('epochs_generated', 0)} epochs "
            f"in {v.counters.get('storm_wall_ms', 0) / 1e3:.3f} s of rounds; "
            f"heal {clock.t.get('heal_cluster', 0.0):.3f} s, converge after "
            f"it {clock.t.get('_converge', 0.0):.3f} s, invariants "
            f"{clock.t.get('judge_invariants', 0.0):.3f} s; wall "
            f"{wall:.3f} s; B1 launches {b1} ({b1 - b1k} staged, {b1k} "
            f"kept), B2 launches {b2} ({b2 - b2k} staged, {b2k} kept)")
        if not v.passed:
            raise AssertionError(f"chaos: {name} seed {seed} failed: "
                                 f"{v.failures}")
        if v.replay_key() != want:
            raise AssertionError(f"chaos: {name} seed {seed}'s replay key is "
                                 "not its schedule's passing one")
        if b1 <= 0 or b2:
            raise AssertionError(f"chaos: {name} launched B1 {b1}, B2 {b2} "
                                 "times; expected B1 only")
        b1_sum += b1
        b2_sum += b2
    return b1_sum, b2_sum


def phase_race(card: str, reset_counts, gf8_mods, dev=None):
    """Phase 10c: ``race_run`` of the shrunk ``RACE_RUN`` scenario on
    ``dev`` (``cuda:0`` unless named) under the perturbed loop with the
    race tracker armed, a counted window; the verdict passes and the
    tracker convicts nothing, B1 launches and B2 does not.  Returns the
    B1 and B2 launches."""
    import torch

    from ceph_tpu_torch.analysis import racecheck

    dev = dev or torch.device("cuda", 0)
    name, seed = RACE_RUN
    reset_counts()
    t0 = time.perf_counter()
    verdict, report, digest = racecheck.race_run(name, seed, shrink=True,
                                                 device=dev)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    (b1, b1k), (b2, b2k) = oc_launches(gf8_mods)
    log(f"race run [{card}]: {name} seed {seed} shrunk: "
        f"{'PASS' if verdict.passed else 'FAIL'}, {verdict.acked_objects} "
        f"acked objects, faults {json.dumps(verdict.counters)}; tracker "
        f"{report['reads']} reads, {report['writes']} writes, "
        f"{report['ticks']} ticks, {len(report['findings'])} convictions; "
        f"trace {digest[:16]}; wall {wall:.3f} s; B1 launches {b1} "
        f"({b1k} kept), B2 launches {b2} ({b2k} kept)")
    if not verdict.passed:
        raise AssertionError(f"race run: {name} failed: {verdict.failures}")
    if report["findings"]:
        raise AssertionError(f"race run: convictions {report['findings']}")
    if racecheck.TRACKER is not racecheck.NULL_RACE:
        raise AssertionError("race run: the tracker was left installed")
    if b1 <= 0 or b2:
        raise AssertionError(f"race run: launched B1 {b1}, B2 {b2} times; "
                             "expected B1 only")
    return b1, b2


def phase_ramp(card: str, reset_counts, gf8_mods, dev=None):
    """Phase 10d: ``ramp`` of ``lw_spec()`` (``read-heavy`` at 256 PGs) at
    ``RAMP_SCALES`` on ``dev`` (``cuda:0`` unless named), called as a user
    calls it (it boots its own cluster), a counted window under
    ``RAMP_BOUND_S``; the artifact goes to a temporary directory and reads
    back as written.  It carries the reference's trust stamps and the
    card's name and power limit, and a step passed every gate (the knee).
    B1 launches, B2 does not.  Returns the B1 and B2 launches."""
    import asyncio
    import tempfile

    import torch

    from ceph_tpu_torch.load import ramp as rampmod

    dev = dev or torch.device("cuda", 0)
    spec = lw_spec()
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ramp_") as tmp:
        doc = asyncio.run(asyncio.wait_for(rampmod.ramp(
            spec, SEED, scales=RAMP_SCALES, tmpdir=tmp, device=dev),
            RAMP_BOUND_S))
        path = rampmod.write_artifact(
            doc, out=os.path.join(tmp, f"{rampmod.ARTIFACT_PREFIX}01.json"))
        with open(path) as f:
            if json.load(f) != json.loads(json.dumps(doc)):
                raise AssertionError("ramp: the artifact does not read "
                                     "back as written")
    wall = time.perf_counter() - t0
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    (b1, b1k), (b2, b2k) = oc_launches(gf8_mods)
    for step in doc["steps"]:
        acked = step["acked_ops_scraped"]
        log(f"ramp [{card}]: {spec.name} at {spec.pg_num} PGs, scale "
            f"{step['scale']:g}: offered {step['offered_ops_s']} ops/s "
            f"({step['offered_ops']} ops), acked "
            f"{'-' if acked is None else f'{acked / spec.duration:.3f}'} "
            f"ops/s (scraped), p99 {step['p99_ms']} ms, "
            f"{'ALL PASS' if step['passed'] else 'FAIL ' + ','.join(g['gate'] for g in step['failed_gates'])}")
    for line in rampmod.format_table(doc).splitlines():
        log(f"ramp [{card}]: {line}")
    log(f"ramp [{card}]: artifact card {doc['card']!r}; wall {wall:.3f} s "
        f"of its {RAMP_BOUND_S:g} s bound; B1 launches {b1} ({b1k} kept), "
        f"B2 launches {b2} ({b2k} kept)")
    stamps = {k: doc[k] for k in ("mode", "vs_baseline", "session_only",
                                  "load_sensitive_host")}
    if stamps != {"mode": "cluster_vstart", "vs_baseline": None,
                  "session_only": True, "load_sensitive_host": True}:
        raise AssertionError(f"ramp: trust stamps {stamps}")
    if doc["knee"] is None:
        raise AssertionError("ramp: no step passed every gate")
    want_card = card if dev.type == "cuda" else "cpu"
    if doc["card"] != want_card:
        raise AssertionError(f"ramp: the artifact names {doc['card']!r}, "
                             f"not {want_card!r}")
    if b1 <= 0 or b2:
        raise AssertionError(f"ramp: launched B1 {b1}, B2 {b2} times; "
                             "expected B1 only")
    return b1, b2


def phase_soak(card: str, reset_counts, gf8_mods, dev=None):
    """Phase 10e: ``run_soak`` of ``SOAK_RUN`` on a fresh cluster on
    ``dev`` (``cuda:0`` unless named), a counted window under
    ``SOAK_BOUND_S``: the reference's soak test's checks (the verdict
    passes, a crash point fired, objects were acked, the schedule is the
    seed's).  B1 launches, B2 does not.  Returns the B1 and B2
    launches."""
    import asyncio
    import tempfile

    import torch

    from ceph_tpu_torch.chaos.scenario import build_schedule
    from ceph_tpu_torch.load import soak as soak_mod

    dev = dev or torch.device("cuda", 0)
    name, seed = SOAK_RUN
    sk = soak_mod.builtin_soaks()[name]
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as tmp, \
            ChaosClock(soak_mod, dev, ("heal_cluster", "wait_converged",
                                       "judge_invariants")) as clock:
        v = asyncio.run(asyncio.wait_for(soak_mod.run_soak(
            sk, seed, tmpdir=tmp, device=dev), SOAK_BOUND_S))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    (b1, b1k), (b2, b2k) = oc_launches(gf8_mods)
    log(f"soak [{card}]: {name} seed {seed}: "
        f"{'PASS' if v.passed else 'FAIL'}, schedule of {len(v.schedule)} "
        f"events, faults fired {json.dumps(dict(sorted(v.counters.items())))}"
        f", {v.acked_objects} acked objects; heal "
        f"{clock.t.get('heal_cluster', 0.0):.3f} s, converge after it "
        f"{clock.t.get('wait_converged', 0.0):.3f} s, invariants "
        f"{clock.t.get('judge_invariants', 0.0):.3f} s; wall {wall:.3f} s "
        f"of its {SOAK_BOUND_S:g} s bound; B1 launches {b1} ({b1k} kept), "
        f"B2 launches {b2} ({b2k} kept)")
    if not v.passed:
        raise AssertionError(f"soak: {name} seed {seed} failed: "
                             f"{v.failures}")
    if v.counters.get("crash_points_fired", 0) < 1:
        raise AssertionError("soak: no crash point fired")
    if v.acked_objects <= 0:
        raise AssertionError("soak: no object was acked")
    if build_schedule(sk.schedule_shell(), seed) != v.schedule:
        raise AssertionError("soak: the schedule is not the seed's")
    if b1 <= 0 or b2:
        raise AssertionError(f"soak: launched B1 {b1}, B2 {b2} times; "
                             "expected B1 only")
    return b1, b2


def phase_load_cli(card: str, extra_args=()):
    """Phase 10f: the port's load CLI, ``python -m
    ceph_tpu_torch.tools.load`` with each of ``LOAD_CLIS`` (and
    ``extra_args``, for a rehearsal), each in a subprocess from the
    checkout's root under ``LOAD_CLI_BOUND_S``: each exits 0 and prints
    ``ALL GATES PASS``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    for args in LOAD_CLIS:
        args = args + tuple(extra_args)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.load", *args],
            cwd=root, env=env, capture_output=True, text=True,
            timeout=LOAD_CLI_BOUND_S)
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        log(f"load CLI [{card}]: {' '.join(args)}: exit {res.returncode}, "
            f"{lines[0] if lines else 'no output'}; wall {wall:.3f} s of "
            f"its {LOAD_CLI_BOUND_S:g} s bound")
        if res.returncode != 0 or "ALL GATES PASS" not in res.stdout:
            raise AssertionError(f"load CLI: {' '.join(args)}: exit "
                                 f"{res.returncode}: {res.stdout[-2000:]} "
                                 f"{res.stderr[-2000:]}")


class ElasticClock:
    """Wraps the elastic runner's seams to time each call and to see the
    cluster through them: its daemons' device, the OSDs up when the
    rebalance starts (the grown ones booted) and the map when the
    invariants are judged (the grown ones drained and purged).  The
    runner itself is unchanged."""

    SEAMS = ("drive", "_reshape_wait", "_optimize_until_dry",
             "_wait_health_ok", "heal_cluster", "wait_converged",
             "judge_invariants")

    def __init__(self, mod, dev):
        self.mod, self.dev = mod, dev
        self.real = {n: getattr(mod, n) for n in self.SEAMS}
        self.calls, self.seen = [], {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        for name, fn in self.real.items():
            setattr(self.mod, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mod, name, fn)

    def _look(self, name, cluster):
        if any(d.device != self.dev for d in
               list(cluster.osds.values()) + cluster.mons):
            raise AssertionError(f"elastic: a daemon is off {self.dev}")
        m = cluster.mon.osdmap
        if name == "_optimize_until_dry" and "grown_up" not in self.seen:
            self.seen["grown_up"] = sorted(
                o for o in cluster.osds if m.osd_up[o])
        if name == "judge_invariants":
            self.seen["after"] = (sorted(cluster.osds), m.max_osd,
                                  [bool(e) for e in m.osd_exists])

    async def _watch(self, name, cluster):
        """Every 5 s that ``name`` runs, print the mon's health: what a
        wait for HEALTH_OK is waiting on."""
        import asyncio

        while True:
            await asyncio.sleep(5.0)
            mon = cluster.mon
            m = mon.osdmap
            h = mon._health_data()
            beacons = {o: mon.osd_unclean.get(o) for o in range(m.max_osd)
                       if m.osd_exists[o]}
            log(f"elastic: {name} still running: {h['status']} "
                f"{json.dumps(h['checks'], default=str)[:400]}; epoch "
                f"{m.epoch}, placement epoch {mon._placement_epoch}, up "
                f"{[o for o in range(m.max_osd) if m.osd_up[o]]}, daemons "
                f"{sorted(cluster.osds)}, (unclean, beacon epoch) by OSD "
                f"{beacons}, pg_temp {len(m.pg_temp)}, upmap items "
                f"{len(m.pg_upmap_items)}")

    def _timed(self, name, fn):
        async def timed(first, *args, **kwargs):
            import asyncio

            watch = None
            if name != "drive":
                self._look(name, first)
                watch = asyncio.get_event_loop().create_task(
                    self._watch(name, first))
            t0 = time.perf_counter()
            out = None
            try:
                out = await fn(first, *args, **kwargs)
                return out
            finally:
                if watch is not None:
                    watch.cancel()
                note = (out.get("phase") if name == "_reshape_wait" and out
                        else out[0] if name == "_optimize_until_dry" and out
                        else f"{out:.3f} s" if name == "_wait_health_ok"
                        and out is not None else "")
                self.calls.append((name, t0 - self.t0,
                                   time.perf_counter() - t0, note))
        return timed


def phase_elastic(card: str, reset_counts, gf8_mods, dev=None):
    """Phase 10g.1: ``run_elastic`` of ``ELASTIC_RUN`` (the tier-1
    ``expand-drain-smoke``: grow 3 -> 6 OSDs under a load window through
    the mgr's reshape op, rebalance, drain back) on a fresh cluster on
    ``dev`` (``cuda:0`` unless named), a counted window under
    ``ELASTIC_BOUND_S``.  The reference test's check (the verdict
    passes), its plan the seed's, a committed move, and the grown OSDs
    booted and then drained out of the map.  Its pool is replicated, so
    neither B1 nor B2 may launch.  Returns the B1 and B2 launches."""
    import asyncio

    import torch

    from ceph_tpu_torch.chaos import balance

    dev = dev or torch.device("cuda", 0)
    name, seed = ELASTIC_RUN
    sc = balance.elastic_scenarios(0.03)[name]
    reset_counts()
    t0 = time.perf_counter()
    with ElasticClock(balance, dev) as clock:
        v = asyncio.run(asyncio.wait_for(balance.run_elastic(
            sc, seed, device=dev), ELASTIC_BOUND_S))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    (b1, b1k), (b2, b2k) = oc_launches(gf8_mods)
    plan = balance.build_elastic_plan(sc, seed)
    want = [{"round": i, "action": p["phase"],
             "args": {k: x for k, x in p.items() if k != "phase"}}
            for i, p in enumerate(plan)]
    for call, start, took, note in sorted(clock.calls, key=lambda c: c[1]):
        log(f"elastic [{card}]: {call} at {start:.3f} s took {took:.3f} s"
            + (f" ({note})" if note != "" else ""))
    grown_up = clock.seen.get("grown_up", [])
    after = clock.seen.get("after", ([], 0, []))
    c = v.counters
    log(f"elastic [{card}]: {name} seed {seed}: "
        f"{'PASS' if v.passed else 'FAIL'}, plan of {len(plan)} phases "
        f"(load key {plan[0]['plan_key'][:12]}), moves committed "
        f"{c.get('moves_committed')}, slots moved {c.get('moved_slots')} "
        f"of an optimal {c.get('optimal_slots')}, HEALTH_OK "
        f"{c.get('health_ok_after_grow_ms')} ms after the grow and "
        f"{c.get('health_ok_after_drain_ms')} ms after the drain; OSDs up "
        f"at the rebalance {grown_up}, at the judge {after[0]} of "
        f"max_osd {after[1]}; {v.acked_objects} acked objects; wall "
        f"{wall:.3f} s of its {ELASTIC_BOUND_S:g} s bound; B1 launches {b1} "
        f"({b1k} kept), B2 launches {b2} ({b2k} kept)")
    if not v.passed:
        raise AssertionError(f"elastic: {name} seed {seed} failed: "
                             f"{v.failures}")
    if v.schedule != want:
        raise AssertionError("elastic: the verdict's plan is not the seed's")
    if c.get("moves_committed", 0) < 1:
        raise AssertionError("elastic: no move was committed")
    grown = list(range(sc.osds, sc.osds + sc.grow))
    if grown_up != list(range(sc.osds)) + grown:
        raise AssertionError(f"elastic: OSDs up at the rebalance {grown_up}"
                             f", not the {sc.osds} booted and {grown} grown")
    if after[0] != list(range(sc.osds)) or any(after[2][o] for o in grown):
        raise AssertionError(f"elastic: the grown OSDs {grown} were not "
                             f"drained and purged: {after}")
    if b1 or b2:
        raise AssertionError(f"elastic: launched B1 {b1}, B2 {b2} times on "
                             "a replicated pool")
    return b1, b2


def chaos_cli_start(extra_args=("--device", "cuda")):
    """Start phase 10g.2's processes from the checkout's root: the port's
    chaos CLI as a user runs it, ``python -m ceph_tpu_torch.tools.chaos
    run`` of ``CHAOS_CLI_RUN`` with ``--json --no-postmortem`` and
    ``extra_args``, and beside it ``schedule`` of the same scenario and
    seed twice, in processes that see no card.  Each fresh process pays
    the host's ``import torch`` (about 10 s on the card's host), so they
    start together, and beside 10g.1; ``phase_chaos_cli`` collects
    them."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    name, seed = CHAOS_CLI_RUN
    base = [sys.executable, "-m", "ceph_tpu_torch.tools.chaos"]
    scen = ["--scenario", name, "--seed", str(seed)]
    args = ["run"] + scen + ["--json", "--no-postmortem"] + list(extra_args)

    def start(argv, env):
        return subprocess.Popen(base + argv, cwd=root, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    procs = [start(args, env)] + [
        start(["schedule"] + scen, dict(env, CUDA_VISIBLE_DEVICES=""))
        for _ in range(2)]
    return {"t0": t0, "args": args, "scen": scen, "procs": procs}


def phase_chaos_cli(card: str, started):
    """Phase 10g.2: collect ``chaos_cli_start``'s processes, each under
    ``CHAOS_CLI_BOUND_S`` from their start: the ``run`` exits 0 with a
    passing verdict, the reference test's seams fired (a client
    interrupt and an MDS crash point), and its schedule is the one
    ``schedule`` prints; the two ``schedule`` processes print one
    plan."""
    t0, args, scen = started["t0"], started["args"], started["scen"]
    outs, walls = [], []
    try:
        for p in started["procs"]:
            left = max(0.0, t0 + CHAOS_CLI_BOUND_S - time.perf_counter())
            try:
                out, err = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"chaos CLI: {' '.join(p.args[3:])} "
                                     f"past its {CHAOS_CLI_BOUND_S:g} s "
                                     "bound")
            outs.append((p.returncode, out, err))
            walls.append(time.perf_counter() - t0)
    finally:
        for p in started["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    (rc, out, err), plans = outs[0], outs[1:]
    for prc, pout, perr in plans:
        if prc != 0:
            raise AssertionError(f"chaos CLI: schedule exit {prc}: "
                                 f"{perr[-2000:]}")
    log(f"chaos CLI [{card}]: schedule {' '.join(scen)}, twice, with no "
        f"card visible: exit 0, {len(json.loads(plans[0][1]))} events; "
        f"collected {max(walls[1:]):.3f} s after their start")
    if plans[0][1] != plans[1][1]:
        raise AssertionError("chaos CLI: two schedules of one seed differ")
    try:
        v = json.loads(out)
    except ValueError:
        v = None
    c = (v or {}).get("counters", {})
    log(f"chaos CLI [{card}]: {' '.join(args)}: exit {rc}, "
        f"{'no verdict' if v is None else 'PASS' if v['passed'] else 'FAIL'}"
        f", {(v or {}).get('acked_objects')} acked objects, seams fired "
        f"{json.dumps(dict(sorted(c.items())))}; wall {walls[0]:.3f} s of "
        f"its {CHAOS_CLI_BOUND_S:g} s bound")
    if rc != 0 or v is None or not v["passed"]:
        raise AssertionError(f"chaos CLI: {' '.join(args)}: exit {rc}: "
                             f"{out[-2000:]} {err[-2000:]}")
    if c.get("interrupt_points_fired", 0) < 1 or \
            c.get("mds_crash_points_fired", 0) < 1:
        raise AssertionError(f"chaos CLI: the seams did not fire: {c}")
    if v["schedule"] != json.loads(plans[0][1]):
        raise AssertionError("chaos CLI: the run's schedule is not the one "
                             "schedule prints")


def card_name() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.ops import _build, gf8_bytes_cuda, gf8_cuda
    from ceph_tpu_torch.utils.perf import KERNELS

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))
        log(f"phase clock (so far): {name} "
            f"{marks[-1][1] - marks[-2][1]:.3f} s")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(_build.build_logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.3f} s")
    for stem, text in _build.build_logs.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = ("staged" if "staged_kernel" in line else
                          "pack" if "pack_blocks" in line else "kept")
            elif "registers" in line or "spill" in line:
                log(f"build: {stem} {kernel} kernel: {line.strip()}")
    card = card_name()
    for name, mod in (("B1", gf8_cuda), ("B2", gf8_bytes_cuda)):
        ctas, threads, smem = mod.staged_config()
        log(f"build: {name} staged kernel: persistent grid of {ctas} CTAs x "
            f"{threads} threads, {smem} bytes of dynamic shared memory per "
            "CTA")
    rng = np.random.default_rng(SEED)
    isa = factory({"plugin": "isa", "k": "8", "m": "4"})
    cauchy = factory(CAUCHY_PROFILE)
    shec, shec_cpu = (factory(SHEC_PROFILE, device=d) for d in (None, "cpu"))
    lrc, lrc_cpu = (factory(LRC_PROFILE, device=d) for d in (None, "cpu"))
    wide = {w: tuple(factory({**WIDE_PROFILE, "w": str(w)}, device=d)
                     for d in (None, "cpu")) for w in (16, 32)}
    for codec in [isa, cauchy, shec, lrc] + [c for c, _ in wide.values()]:
        assert codec.device.type == "cuda"
    assert {layer.erasure_code.device.type for layer in lrc.layers} == \
        {"cuda"}
    mark("build and codecs")
    b1_err = phase_kernel(isa, rng)
    b1_err = max(b1_err, phase_kernel_b1_codecs(
        shec, lrc, [c for c, _ in wide.values()], rng))
    b2_err = phase_kernel_b2(cauchy, rng)
    mark("kernel checks")

    def reset_counts():
        for mod in (gf8_cuda, gf8_bytes_cuda):
            mod.launches = 0
            mod.kept_launches = 0
        KERNELS.reset()

    def path_counts(name, mod):
        return (f"{name} launches {mod.launches} ({mod.launches - mod.kept_launches}"
                f" staged, {mod.kept_launches} kept)")

    # main path of the ISA slice: counts from 0 just before, read just after
    reset_counts()
    data = phase_codec(isa, rng)
    phase_stripe(isa)
    torch.cuda.synchronize()
    b1_launches = gf8_cuda.launches
    isa_kept = gf8_cuda.kept_launches + gf8_bytes_cuda.kept_launches
    log(f"main path (ISA): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
    if b1_launches <= 0:
        raise AssertionError("the ISA path never launched kernel B1")
    if isa_kept:
        raise AssertionError("an ISA main-path launch took the kept path")
    mark("ISA path")

    # main path of the jerasure slice
    reset_counts()
    cdata = phase_codec_cauchy(cauchy, rng)
    phase_stripe_cauchy(cauchy)
    phase_default_profile_tick()
    torch.cuda.synchronize()
    b2_launches = gf8_bytes_cuda.launches
    j_b1 = gf8_cuda.launches
    j_kept = gf8_cuda.kept_launches + gf8_bytes_cuda.kept_launches
    log(f"main path (jerasure): {path_counts('B2', gf8_bytes_cuda)}, "
        f"{path_counts('B1', gf8_cuda)}; counters "
        f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
    if b2_launches <= 0:
        raise AssertionError("the jerasure path never launched kernel B2")
    if j_b1 <= 0:
        raise AssertionError("the default-profile tick never launched B1")
    if j_kept:
        raise AssertionError("a jerasure main-path launch took the kept path")
    b1_launches += j_b1
    mark("jerasure path")

    # the main paths of the erasure-code slice: SHEC planar at rest, LRC
    # and reed_sol_van at w=16 and w=32 byte at rest, all on B1; each
    # counted from 0 just before and read just after
    paths = [
        ("SHEC k8m4c3", lambda: phase_shec_tick(shec, shec_cpu), False),
        ("LRC k4m2l3", lambda: phase_lrc_tick(lrc, lrc_cpu), False),
    ] + [(f"reed_sol_van k8m4 w={w}",
          (lambda c=c, cc=cc: (phase_wide_codec(c, cc, rng),
                               phase_wide_tick(c, cc))), w == 32)
         for w, (c, cc) in wide.items()]
    for label, run, kept_expected in paths:
        reset_counts()
        run()
        torch.cuda.synchronize()
        log(f"main path ({label}): {path_counts('B1', gf8_cuda)}, "
            f"{path_counts('B2', gf8_bytes_cuda)}; counters "
            f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
        if gf8_cuda.launches <= 0:
            raise AssertionError(f"the {label} path never launched kernel B1")
        if gf8_bytes_cuda.launches:
            raise AssertionError(f"the {label} path launched kernel B2")
        if bool(gf8_cuda.kept_launches) != kept_expected:
            raise AssertionError(
                f"the {label} path took the kept path "
                f"{gf8_cuda.kept_launches} times")
        b1_launches += gf8_cuda.launches
    mark("erasure-code paths")

    # the placement main path: CRUSH and the OSDMap pipeline,
    # torch ops only (no hand-written kernel on this path)
    pmap, pmap2, crush_rule, crush_c1 = placement_maps()
    reset_counts()
    placed = phase_placement(pmap, pmap2, crush_rule)
    torch.cuda.synchronize()
    counts = KERNELS.dump()["device_kernels"]
    log(f"main path (placement): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    want = {"crush_map_calls": 5,
            "crush_map_pgs": 3 * PLACEMENT_PGS + LRC_PGS + CHOOSE_ARGS_PGS,
            "crush_map_pad_lanes": 0}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"placement counters are not {want}")
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the placement path launched an EC kernel")
    check_placement(pmap, pmap2, crush_rule, placed)
    mark("placement")

    # the C1 path: ROADMAP's repro and a 9,984-OSD erasure pool on
    # chooseleaf indep type 0, counted from 0 just before, read just after
    reset_counts()
    phase_c1(pmap2, crush_c1)
    torch.cuda.synchronize()
    counts = KERNELS.dump()["device_kernels"]
    log(f"main path (C1): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    want = {"crush_map_calls": 2, "crush_map_pgs": C1_SMALL_PGS + C1_PGS}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"C1 counters are not {want}")
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the C1 path launched an EC kernel")
    mark("C1")

    # the balancer scorer path (its own counted window inside)
    scored_map, split, before, changes, _ = phase_scorer(
        pmap.crush, crush_rule, reset_counts)
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the scorer path launched an EC kernel")
    check_scorer(scored_map, split, before, changes, crush_rule, card)
    del scored_map, split, before
    phase_scorer_small()
    mark("scorer")

    # the mesh path: the sharded EC engine and the sharded placement over
    # every visible card (or eight slots of one), counted from 0 just
    # before and read just after; the single-device placement it is held
    # to runs first, outside the window
    mesh_ref = mesh_reference(pmap, crush_rule)
    reset_counts()
    mesh_out = phase_mesh(isa, pmap, crush_rule, mesh_ref)
    sync_all(mesh_out["mesh"].distinct())
    counts = KERNELS.dump()["device_kernels"]
    log(f"main path (mesh): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the mesh path launched an EC kernel")
    if counts.get("crush_map_calls", 0) != mesh_out["slots"]:
        raise AssertionError("the sharded placement did not map one shard "
                             "per mesh slot")
    mark("mesh")

    # the OSD store path: the port's batchers, messenger and stores on
    # codecs and a verify device named by index (the ticks run in executor
    # threads); each pool its own counted window
    store_dev = torch.device("cuda", 0)
    store_isa = factory({"plugin": "isa", "k": "8", "m": "4"},
                        device=store_dev)
    store_cauchy = factory(CAUCHY_PROFILE, device=store_dev)
    store_counts = {}

    def store_window(label, run):
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        log(f"main path ({label}): {path_counts('B1', gf8_cuda)}, "
            f"{path_counts('B2', gf8_bytes_cuda)}; counters "
            f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
        store_counts[label] = (gf8_cuda.launches, gf8_cuda.kept_launches,
                               gf8_bytes_cuda.launches,
                               gf8_bytes_cuda.kept_launches)
        return res

    store_out = phase_store_path(store_isa, store_cauchy, store_dev, card,
                                 store_window)
    if any(not o["verify_device"].startswith("cuda")
           for o in store_out.values()):
        raise AssertionError("a store-path verify tick ran off the card")
    a_b1, a_b1_kept, a_b2, a_b2_kept = store_counts["store path A"]
    b_b1, b_b1_kept, b_b2, b_b2_kept = store_counts["store path B"]
    if a_b1 <= 0:
        raise AssertionError("store path A never launched kernel B1")
    if a_b2:
        raise AssertionError("store path A launched kernel B2")
    if b_b2 <= 0:
        raise AssertionError("store path B never launched kernel B2")
    if a_b1_kept or a_b2_kept or b_b1_kept or b_b2_kept:
        raise AssertionError("a store-path launch took the kept path")
    b1_launches += a_b1 + b_b1
    b2_launches += a_b2 + b_b2
    mark("store path")

    # the control plane: monitors and mgr on the card, its own counted
    # window inside (no EC kernel may launch there)
    phase_control_plane(card, reset_counts, (gf8_cuda, gf8_bytes_cuda))
    mark("control plane")

    # the OSD cluster: each pool's I/O, the scrub, the recovery and the
    # backfill its own counted window inside
    oc_b1, oc_b2, load_s = phase_osd_cluster(card, reset_counts,
                                             (gf8_cuda, gf8_bytes_cuda))
    b1_launches += oc_b1
    b2_launches += oc_b2
    mark("OSD cluster")

    # the chaos runner and the race run, each scenario on a fresh cluster
    # and its own counted window (10a, the load window, ran on phase 9's
    # cluster, its window among phase 9's)
    for run in (phase_chaos, phase_race):
        ch_b1, ch_b2 = run(card, reset_counts, (gf8_cuda, gf8_bytes_cuda))
        b1_launches += ch_b1
        b2_launches += ch_b2
    mark("chaos and race runs")
    # the ramp, the soak and the elastic run, each on a fresh cluster and
    # its own counted window; the load and chaos CLIs in processes of
    # their own
    for run in (phase_ramp, phase_soak):
        ch_b1, ch_b2 = run(card, reset_counts, (gf8_cuda, gf8_bytes_cuda))
        b1_launches += ch_b1
        b2_launches += ch_b2
    phase_load_cli(card)
    # 10g: the chaos CLI's processes start first and run beside the
    # elastic run (they launch nothing in this process's counts)
    cli = chaos_cli_start()
    ch_b1, ch_b2 = phase_elastic(card, reset_counts,
                                 (gf8_cuda, gf8_bytes_cuda))
    b1_launches += ch_b1
    b2_launches += ch_b2
    phase_chaos_cli(card, cli)
    mark("ramp, soak, load CLI, elastic run and chaos CLI")
    log(f"phase clock (so far): phase 10 "
        f"{load_s + marks[-1][1] - marks[-3][1]:.3f} s (the load window "
        f"{load_s:.3f} s inside the OSD cluster's)")

    phase_one_launch(cauchy, cdata)
    yard_ms = phase_yardstick(card)
    t1 = phase_timing(isa, data, card, yard_ms)
    phase_loop_slope(isa, t1["ms"], card)
    t2 = phase_timing_b2(cauchy, cdata, card, yard_ms)
    phase_timing_b1_shapes(
        [("reed_sol_van k8m4 w=16 encode", wide[16][0].engine._enc_bitmat),
         ("reed_sol_van k8m4 w=32 encode", wide[32][0].engine._enc_bitmat),
         ("SHEC k8m4c3 encode", shec.engine._enc_bitmat)], card)
    phase_clean_l2(isa, cauchy, card)
    placement_s = phase_placement_timing(pmap, pmap2, crush_rule, card)
    phase_mesh_timing(isa, pmap, crush_rule, mesh_ref, mesh_out,
                      placement_s["default chunk"], card)
    mark("timing")
    for (_, a), (name, b) in zip(marks, marks[1:]):
        log(f"phase clock: {name} {b - a:.3f} s")
    log(f"phase clock: total {marks[-1][1] - marks[0][1]:.3f} s")
    log(card)
    kernels = [{
        "name": "B1 planar GF(2) matmul",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf8_planar.cu",
        "replaces": "ceph_tpu/ops/gf8_pallas.py:165",
        "launches": b1_launches,
        "max_abs_err": b1_err,
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": None,
    }, {
        "name": "B2 GF(2) bit-matrix map on raw bytes",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf8_bytes.cu",
        "replaces": "ceph_tpu/ops/gf8_pallas.py:58",
        "launches": b2_launches,
        "max_abs_err": b2_err,
        "ms": t2["ms"],
        "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"],
        "bound_by": t2["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
