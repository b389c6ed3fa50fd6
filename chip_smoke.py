#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together, ``sm_90a``) and print the build time;
3. hold each kernel against its plain-torch twin on the card: the fused
   MIS-2 passes at the Laplace3D_100 and Elasticity3D_60 shapes and the
   sliced passes at the four slabs of Powerlaw_1M (random state, sentinel
   and dead worklist slots, all three priorities; the decide also without
   a mask, as the hybrid loop calls it for ``mis2``); the
   unfused passes over pre-gathered rows of a pow2-padded worklist at the
   two paper graphs' shapes (dead slots past ``count``); the ELL SpMV on
   the three graphs' matrices, the hash-pack at V = 1M in the TPU
   kernel's form and in the coloring's (ids 0..V-1, int64 words) for
   three rounds, two launches each, and the run-sum kernel on the
   Laplace3D_100 level-0 Galerkin stage-2 stream and on a stream of long
   runs, two launches each, all bitwise;
4. the MIS-2 path: ``repro_torch.mis2`` and ``repro_torch.coarsen(method=
   "two_phase")`` with ``engine=None`` on laplace3d(8), Laplace3D_100 and
   Elasticity3D_60 against the reference's digests, one launch of the
   persistent ``resident_fixed_point`` kernel per MIS-2 solve (its body
   carries the fused passes; the standalone fused kernels are not
   launched) and no host sync inside it, the ``dense`` engine's equal
   digest;
5. the AMG path on Laplace3D_100: ``amg_setup`` with ``engine=None``
   (the ``resident`` engine: the per-level setup on the card, two-phase
   aggregation) with explicit R and matrix-free, and the ``host`` engine
   with explicit R as the same-call baseline: level sizes and digests
   against the reference's, the two engines' P, R and diagonals equal,
   three run-sum launches a resident level (the prolongator's A P0 and
   the Galerkin product's two stages), AMG-preconditioned CG (tol 1e-6,
   float32 coarse LU on the card) within one iteration of the reference,
   and the SpMV / transposed-SpMV launches one V-cycle issues times the
   cycles; the device-to-host copies inside a traced resident setup's
   prolongator, Galerkin and pack phases (``torch.profiler``), each a
   shape scalar; the transposed SpMV on level 0's P then against its twin
   and against the SpMV of the explicit R, bitwise;
6. the cluster-GS path: ``cluster_gs_setup`` with ``engine=None`` (the
   ``resident`` engine: coarse graph and packing on the card) on
   Elasticity3D_60 and Laplace3D_100 (labels and coarse-coloring digests
   against the reference's, the packed rows equal to the ``host``
   engine's, set up in the same call), GS-preconditioned CG on both (tol
   1e-6, ``b = default_rng(0).standard_normal(V)``, one SpMV launch per
   iteration plus one) within one iteration of the reference's, the
   device-to-host copies of a traced resident setup's coarse-graph and
   pack phases, ``color(laplace3d(8))``, and one launch of the Luby
   persistent kernel a coloring;
7. the hybrid path on Powerlaw_1M (``powerlaw_graph(1_000_000, 8.0,
   exponent=2.5, seed=42)``, whose padded ELL would take 120 GB): the
   graph digest and the layout, ``Graph.ell`` raising
   ``LayoutOverflowError``, ``mis2`` with ``engine=None`` taking
   ``cuda_hybrid`` (size, rounds, digest and traffic integers against the
   reference's ``pallas_hybrid``), ``coarsen`` two-phase and basic,
   ``color(engine="luby_hybrid")``, one launch of the hybrid persistent
   kernel a MIS-2 solve and of the Luby one a coloring; then
   ``cuda_hybrid`` on Laplace3D_100 and Elasticity3D_60 against the
   ``mis2`` anchors;
8. the host-driven path and the Fig. 2 chain: ``mis2`` with the
   ``compacted`` and ``cuda_compacted`` engines on laplace3d(8),
   Laplace3D_100 and Elasticity3D_60 against the ``mis2`` anchors (two
   host syncs and, for ``cuda_compacted``, one launch of each unfused
   kernel a round), ``cuda_compacted`` without worklists on
   Laplace3D_100, ``coarsen(mis2_engine="cuda_compacted")`` on
   Laplace3D_100, and every ``ABLATION_CHAIN`` entry through
   ``engine=None`` on the two paper graphs (engine chosen, anchors, warm
   wall times, speed-up over ``baseline_bell``);
9. distance-k MIS and the multilevel partition on Laplace3D_100:
   ``misk`` with k = 1, 2, 3 on both engines (``dense``, ``resident``;
   equal digests, ``engine=None`` taking ``dense``; one launch of the misk
   kernel and no host sync a solve) and ``partition(·, 8)``
   (parts digest, edge cut, levels and per-level history) against the
   reference's (``tools/reference_misk_partition.py``), the partition's
   coarsening launching the persistent MIS-2 kernel;
10. the batched pipelines: fleet A, the reference's own batch benchmark
   (``benchmarks/batch_throughput.py``, full size: ``laplace3d(6, 8, 10,
   12)`` and ``random_uniform_graph(n, 6.0, seed=s)`` for n = 1,000 /
   2,000 / 5,000 / 10,000, four copies each, seeds 0-15), through
   ``mis2_batch``, ``color_batch``, ``coarsen_batch`` (``two_phase`` and
   ``basic``) against the reference's anchors
   (``tools/reference_batch.py``), and ``amg_setup_batch`` on the same fleet
   as matrices (``er_laplacian`` for the random graphs) against the
   reference's and, member by member, against ``amg_setup``; fleet B, the
   subdomains of a domain-decomposed problem (64 x ``laplace3d(32)`` and 64
   x ``random_uniform_graph(20_000, 6.0, seed=100+i)``, two buckets, 3.4M
   vertices), through ``mis2_batch``, ``color_batch`` and
   ``coarsen_batch(two_phase)``, each member equal to the single-graph
   ``mis2`` / ``color`` / ``coarsen``; the batched wall time against the
   loop of single-graph calls (graphs/s); every result's ``provenance``
   (its digest the result's, a batch's shared by its members, platform
   ``gpu``); the batched fixed points launched (the batched MIS-2 and Luby
   kernels); the batched hash-pack form (``round_priorities_batched``,
   which no path launches since its arithmetic runs inside the batched
   Luby kernel) against its twin on fleet B's two buckets, bitwise;
11. time each kernel (CUDA events, L2 flushed before each launch), its twin
   and, where one exists, the PyTorch library call computing the same
   function, beside its bound (bytes, float32 flops or the integer
   instructions of the §V-A hashes, whichever takes longest; the
   hash-pack's two forms also after a read flush, beside the event pair's
   floor under each flush); the
   end-to-end wall times of ``mis2`` (``engine=None`` and the host-driven
   engines) / ``coarsen``
   (and on Powerlaw_1M of the hybrid ``mis2`` / ``coarsen`` / ``color``),
   of the setup phases of both multilevel engines (and of the
   Elasticity3D_60 cluster-GS setup's coarse graph, on each), of one
   V-cycle, one GS apply on each paper graph and each CG solve, and three
   warm calls of each ``misk`` and of the partition of phase 9, and
   ``round_priorities_batched`` on fleet B's larger bucket;
12. the distributed engines: four spawned ranks on the one card (gloo; a
   one-rank NCCL group inside the same world drives the NCCL path) run
   ``mis2`` with ``distributed`` and ``distributed_single_gather``,
   ``coarsen(method="two_phase_distributed")`` and ``coarsen(method=
   "two_phase", mis2_engine="distributed")`` on Laplace3D_100 and
   Elasticity3D_60 at P = 4 and on Laplace3D_100 at P = 3 (1,000,000 rows
   pad to 1,000,002) and P = 1; every rank gives the anchors, the counted
   T/M gather bytes equal ``collective_bytes_per_iteration`` x rounds and
   the registry's ``dist.collective_bytes``, one launch of each sliced
   kernel a rank a round (single-gather: one ``fused_refresh_columns``);
   the wall time per call beside the single-device ``engine=None`` call;
13. the serving layer (``repro_torch.serve``): pool S, the reference's
   serve benchmark at full size (``benchmarks/serve_throughput.py``: 160
   requests over 8 graphs), batched against serialized, every digest the
   direct ``dense`` call's, no cold shape and no ``nvcc`` after the
   warm-up; pool M, 128 requests of seeded kinds (``mis2``, ``color``,
   ``coarsen``, ``amg_setup``) over subdomains at fleet B's sizes, each
   equal to its direct call; the large requests (Laplace3D_100 ``mis2``,
   ``coarsen``, ``amg_setup``, Elasticity3D_60 ``mis2``, Powerlaw_1M
   ``mis2`` on ``cuda_hybrid``) against the anchors, and an ELL-bound
   explicit engine on Powerlaw_1M shed with ``LayoutInfeasible``; ten
   streaming deltas on Laplace3D_100, each repair equal to a from-scratch
   ``mis2``; a persistent tier restarted with one corrupt entry dropped,
   and a seeded fault plan's exact retry / fallback / injected counts;
   every response carries its own provenance;
14. the resident fixed point as one dispatch: the persistent kernel against
   its twin on laplace3d(8), Laplace3D_100 and Elasticity3D_60 (capped at
   1, 2 and 4 rounds, uncapped, and under the active mask of a two-phase
   coarsening's phase 2), bitwise T, equal rounds and live count; the
   anchors through ``engine=None`` with no host sync and one dispatch (one
   launch) a solve; a profiled solve whose only kernel is the persistent
   one and whose device-to-host copies follow it; five warm calls of the
   paper graphs' ``mis2`` and ``coarsen`` beside the times before the
   kernel; and ``tools/check_shape_torch.py``'s five gates on the card;
15. the hybrid MIS-2 fixed point and the Luby loops as one dispatch each:
   the hybrid persistent kernel against its twin on the hybrid layouts of
   Powerlaw_1M, Laplace3D_100 and Elasticity3D_60 (capped at 1, 2 and 4
   rounds, uncapped, and under the phase-2 mask of a two-phase coarsening),
   bitwise T, equal rounds, live count and per-slab rows; the Luby kernel
   against its twins on the same graphs (padded ELL and hybrid layout) and
   on the two cluster-GS coarse graphs, capped at 1-3 rounds and uncapped,
   bitwise colors and equal rounds; the anchors through the facade, each
   with no host sync and one launch a solve; each kernel timed beside its
   bound and its twin, and the walls beside the times before the kernels;
16. the coarsening's label joins as one dispatch each: ``root_join``,
   ``phase2_join`` and ``phase3_fixed_point`` against their twins on
   Laplace3D_100, Elasticity3D_60 (padded ELL) and Powerlaw_1M (hybrid
   layout), on the label states of a real two-phase and basic coarsening
   (caught at the wrappers) and on seeded ones (heavy rows of Powerlaw_1M
   unaggregated), every output bitwise and equal on a second launch, one
   launch a call and no host sync inside one
   (``torch.cuda.set_sync_debug_mode("error")``); the coarsening anchors
   through the facade with one launch of each join; each kernel timed
   beside its bound and its twin; the walls of five warm calls of
   ``coarsen`` (both methods) on the three graphs, ``cluster_gs_setup`` on
   Elasticity3D_60, ``amg_setup`` on Laplace3D_100 and ``partition(·, 8)``
   on both paper graphs, beside the times before the kernels;
17. ``misk``, the batched MIS-2 and Luby fixed points and the streaming
   repair as one dispatch each: the misk kernel against both engines'
   twins on Laplace3D_100 and Elasticity3D_60 (k = 1, 2, 3; capped at 1
   and 2 rounds and uncapped), the batched resident kernel against its
   twin on fleet A's ten buckets and fleet B's two (every row, capped at 1
   and 2 rounds, and the phase-2 mask of a real two-phase coarsening,
   caught at the pipeline), the seeded resident kernel against its twin on
   the seeds of Laplace3D_100 streaming deltas (phase 13's stream), the
   batched Luby kernel against its twin on both fleets' buckets (capped at
   1 and 2 rounds and uncapped): every output bitwise and equal on a
   second launch, one launch a call and no host sync inside one
   (``torch.cuda.set_sync_debug_mode("error")``); ``misk`` and the batched
   calls through the facade with one launch a solve or a bucket and
   ``host_syncs`` 0; each kernel timed beside its bound and its twin; the
   walls of five warm calls beside the times before the kernels;
18. the batched coarsening's joins on the join kernels, ``repro.api``'s
   surface and the examples: ``coarsen_batch`` (``two_phase`` and
   ``basic``) on both fleets, fleet A against the reference's anchors, every
   fleet B member against its single-graph ``coarsen`` (labels, roots,
   phase marks, iterations), fleet A's ``amg_setup_batch`` anchor, and
   each bucket's launches (two batched MIS-2 solves and one launch of each
   join, or one solve and one ``root_join`` with the cleanup inside); the
   reference's engine names (``pallas_resident`` on Laplace3D_100,
   ``pallas_hybrid`` on Powerlaw_1M, ``coarsen(method="mis2_agg")``) on
   the anchors with the canonical engine in ``provenance``, and
   ``using_backend(Backend())`` leaving them there; the four port
   examples (``examples/torch/``) at the reference examples' default
   sizes, each record a JSON line; every join call of both fleets' buckets
   against its twin (bitwise, equal on a second launch, one launch and no
   host sync inside it); the walls of five warm ``coarsen_batch`` calls
   beside the times before, and the device events of one traced call
   (``tools/profile_torch.py`` in a child process).
19. the static analyzer on the card's tree: ``repro_torch.lint.check``
   over ``src/repro_torch``, every Python file and every CUDA source
   (``kernels/csrc/*.cu`` and ``*.cuh``), with the committed
   ``tools/lint_baseline_torch.json``; its counts per rule and the CUDA
   files read on a JSON line; fails on a live finding, a baseline problem,
   or a source ``kernels/_build.py`` compiles that was not linted.
20. the two persistent kernels redesigned in slice 20 at each cap of their
   loops: ``mis2`` and ``coarsen(two_phase)`` on the paper graphs against
   the anchors (launching both); ``resident_fixed_point`` on Laplace3D_100
   and Elasticity3D_60 at every ``max_iters`` from 0 to one past its
   rounds, ``phase3_fixed_point`` on the phase-3 state of a real two-phase
   coarsening of the three graphs at every ``rounds`` from 0 to one past
   the twin's (at most four), each bitwise against its twin capped the
   same and timed at each cap: the prologue's and each round's cost, with
   the twin's live rows a round.  Phases 11, 16 and 17 time the resident
   kernels and phase 3 against the least bytes the function needs (each
   input read once, each output written once), the count the earlier design
   was held to beside it (``bound_ms_design``).

The launch counts of each path are set to 0 just before it and read just
after (phase 12: in each rank, summed).  Prints JSON lines, the ``kernels`` table, the ``nvidia-smi`` line,
and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, float32 outside tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # H100 SXM: SMs x INT32 lanes x boost clock
# SASS instructions of one §V-A tuple, the round's f(it + 1) hoisted: the
# hashed branch of minprop_ell.cu's per-vertex pass, from id + 1 to the
# packing (tools/bench_minprop.py --sass; hash_pack's step of 4 tuples,
# f(it + 1) hoisted there too, takes 36 a tuple with its loads, stores and
# index math, and round_priorities' 40)
INSTR_PER_HASH = 33

# the reference's anchors (the JAX package, compacted_resident engine)
ANCHORS = {
    "laplace3d(8)": dict(n=8, kind="laplace3d", digest=None,
                         mis2=(55, 6, "4dfc7dee5f0f7c7f"),
                         coarsen=(82, None, "dfda3c0aa9776009")),
    "Laplace3D_100": dict(n=100, kind="laplace3d", digest="80bd83539a0c899d",
                          entries=6_940_000,
                          mis2=(90_207, 10, "2dbbb0f6ed5c9ac0"),
                          coarsen=(147_865, 18, "e11aa9fbaab77f88")),
    "Elasticity3D_60": dict(n=60, kind="elasticity3d",
                            digest="810c4e3742f42ece", entries=50_757_768,
                            mis2=(4_878, 10, "ef26deaefd9afee5"),
                            coarsen=(9_434, 20, "aa49f95af32b7e4f")),
}
PAPER_GRAPHS = ("Laplace3D_100", "Elasticity3D_60")

# the reference's host multilevel engine on Laplace3D_100 (JAX on CPU):
# amg_setup(engine="host", aggregation="two_phase"), level (n, nnz) and A_l
# digests, and CG iterations with b = default_rng(0).standard_normal(V),
# tol 1e-6, float32 coarse LU (both restriction modes)
AMG_L100 = dict(
    levels=[(1_000_000, 6_940_000), (147_865, 5_123_153), (4_241, 342_205),
            (59, 2_281)],
    digests=["1c4f4f7368dbb198", "e670e5232c038a8b", "3b48321836b33e6b",
             "8815a1a409a1ae65"],
    cg_iterations=14)
# cluster_gs_setup(engine="host"): clusters, labels digest, coarse colors
# and their digest, and GS-preconditioned CG iterations (tol 1e-6, b =
# default_rng(0).standard_normal(V); tools/reference_gs_cg.py)
CLUSTER_GS = {
    "Elasticity3D_60": dict(clusters=9_434, digest="aa49f95af32b7e4f",
                            colors=13, colors_digest="a569e43161f155f3",
                            cg_iterations=28),
    "Laplace3D_100": dict(clusters=147_865, digest="e11aa9fbaab77f88",
                          colors=10, colors_digest="14544e81b327e426",
                          cg_iterations=115),
}
COLOR_L8 = (5, "3f45a9cfe50afa1e")
# the reference's misk (its dense and resident engines agree) and
# partition(·, 8) on Laplace3D_100 (JAX on the CPU,
# tools/reference_misk_partition.py): k -> (size, rounds, digest)
MISK_L100 = {1: (303_652, 5, "becd69374ff06b3d"),
             2: (90_270, 6, "5529f8a677cf037c"),
             3: (43_462, 7, "595623d529e0495d")}
PARTITION_L100 = dict(
    parts=8, edge_cut=68_545, levels=5, digest="bd7cffe49f41a935",
    history=[(147_865, 1_798_969), (14_048, 217_086), (1_066, 16_306),
             (82, 1_010)])
FUSED = ("fused_refresh_columns", "fused_decide")
CG_TOL = 1e-6

# fleet A: the reference's batch benchmark at full size
# (benchmarks/batch_throughput.py:24-41, quick=False): laplace3d meshes,
# then random_uniform_graph(n, 6.0, seed) / er_laplacian(n, 6.0, seed)
FLEET_A = dict(meshes=(6, 8, 10, 12), ns=(1_000, 2_000, 5_000, 10_000),
               copies=4)
# the reference's batched calls on fleet A (JAX on the CPU,
# tools/reference_batch.py): fleet_anchor of the ordered member digests and
# the bucket shapes; for amg_setup of the level digests of the leading
# members whose hierarchy the reference builds (the meshes and the n =
# 1,000 copies: its two-phase coarsening of the wide coarse ER levels does
# not return) and of their own batch's bucket shapes
FLEET_A_ANCHORS = {"mis2": "54bfa723e4c1c123", "color": "60c0a44dddfb9eaa",
                   "coarsen_two_phase": "0bb7b314f4cef3a8",
                   "coarsen_basic": "e1a287a0fb2be420",
                   "amg_setup": "da2fd134ee18a18c"}
FLEET_A_AMG_MEMBERS = 8
# fleet B: the subdomains of a domain-decomposed setup, two buckets:
# (copies, laplace3d n) and (copies, random graph V, degree, first seed)
FLEET_B = dict(laplace=(64, 32), random=(64, 20_000, 6.0, 100))

# the reference's pallas_hybrid path on powerlaw_graph(1_000_000, 8.0,
# exponent=2.5, seed=42) (JAX on the CPU, Pallas in interpret mode)
POWERLAW_1M = dict(
    args=(1_000_000, 8.0), kw=dict(exponent=2.5, seed=42),
    digest="a93fce7cfeb3773f", entries=8_979_266, max_degree=24_065,
    ell_bytes=120_325_000_000, spill_cap=64, widths=(8, 16, 32, 64),
    slab_rows=(750_669, 171_383, 52_017, 17_077), spill_rows=8_854,
    spill_entries=1_598_927,
    mis2=(135_109, 10, "45c80367656d7482"),
    slice_rows_processed=[5_258_959, 1_158_292, 346_608, 108_782],
    spill_passes=20, row_bytes_total=442_545_552,
    two_phase=(183_951, 17, "ab870d9f4a61bf55"),
    basic=(135_109, 10, "406787ed01a9ed03"),
    color=(36, 80, "f50cd95ad8b0addc"))
TIMED_SLABS = (8, 16, 32, 64)

# ABLATION_CHAIN["baseline_bell"] (fixed priorities) on the three graphs:
# the reference's dense engine (JAX on the CPU); the other entries give
# the ANCHORS' mis2 sets
FIXED_MIS2 = {"laplace3d(8)": (54, 6, "b3d3b74da8f85b2d"),
              "Laplace3D_100": (90_222, 13, "fc5670c01ec4a228"),
              "Elasticity3D_60": (4_871, 14, "bdd9a343060ad454")}
# the reference's compacted engine on laplace3d(8): pow2 bucket pairs
COMPACTED_L8_COMPILES = 5
# the engine engine=None takes for each chain entry
CHAIN_ENGINES = {"baseline_bell": "compacted", "+rand_priority": "compacted",
                 "+worklists": "compacted_resident",
                 "+packed_status": "compacted_resident",
                 "+simd_ell": "cuda_resident"}

KERNELS = {   # name -> (TPU kernel replaced, CUDA source)
    "fused_refresh_columns": ("src/repro/kernels/minprop_ell/kernel.py:216",
                              "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    "fused_decide": ("src/repro/kernels/minprop_ell/kernel.py:254",
                     "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    "spmv": ("src/repro/kernels/spmv_ell/kernel.py:38",
             "src/repro_torch/kernels/csrc/spmv_ell.cu"),
    "spmv_t": ("src/repro/kernels/spmv_ell/kernel.py:85",
               "src/repro_torch/kernels/csrc/spmv_ell.cu"),
    "hash_pack": ("src/repro/kernels/hash_priority/kernel.py:31",
                  "src/repro_torch/kernels/csrc/hash_pack.cu"),
    # the batched coloring's form of the same kernel (the reference vmaps
    # the plain hash there); its arithmetic runs inside
    # luby_fixed_point_batched
    "round_priorities_batched": (
        "src/repro/kernels/hash_priority/kernel.py:31",
        "src/repro_torch/kernels/csrc/hash_pack.cu"),
    "sliced_refresh_columns": ("src/repro/kernels/minprop_ell/kernel.py:375",
                               "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    "sliced_decide": ("src/repro/kernels/minprop_ell/kernel.py:409",
                      "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    "refresh_columns": ("src/repro/kernels/minprop_ell/kernel.py:96",
                        "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    "decide": ("src/repro/kernels/minprop_ell/kernel.py:445",
               "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    # no TPU kernel: the reference sums these runs with XLA's segment_sum
    "run_sums": ("none (XLA segment_sum, src/repro/multilevel/galerkin.py:68)",
                 "src/repro_torch/kernels/csrc/run_sums.cu"),
    # no TPU kernel of its own: the reference's jitted while_loop around
    # kernels 1-2 and compact_worklist, whose bodies it runs
    "resident_fixed_point": (
        "none (the lax.while_loop of src/repro/core/mis2.py:641 over "
        "src/repro/kernels/minprop_ell/kernel.py:216 and :254)",
        "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    # likewise around the sliced kernels 3-4 and the spill's segment passes
    "hybrid_fixed_point": (
        "none (the lax.while_loop of src/repro/core/mis2_hybrid.py:51-113 "
        "over src/repro/kernels/minprop_ell/kernel.py:375 and :409 and the "
        "spill's XLA segment reductions)",
        "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    # the Luby round loops (XLA), with kernel 9's hash inside
    "luby_fixed_point": (
        "none (the lax.while_loops of src/repro/core/coloring.py:107-128 "
        "and :163-194; its priorities are "
        "src/repro/kernels/hash_priority/kernel.py:31's arithmetic)",
        "src/repro_torch/kernels/csrc/luby.cu"),
    # the coarsening's jitted label joins (XLA)
    "root_join": (
        "none (the jitted joins of src/repro/core/aggregation.py:64-79, "
        ":144-158 and :246-278, and the cleanup loops :161-181 and "
        ":281-301)", "src/repro_torch/kernels/csrc/joins.cu"),
    "phase2_join": (
        "none (the jitted src/repro/core/aggregation.py:184-200 and "
        ":304-329)", "src/repro_torch/kernels/csrc/joins.cu"),
    "phase3_fixed_point": (
        "none (the lax.while_loops of src/repro/core/aggregation.py:203-229 "
        "and :371-402 with :332-368)", "src/repro_torch/kernels/csrc/joins.cu"),
    # the distance-k loops (XLA), both engines
    "misk_fixed_point": (
        "none (the lax.while_loops of src/repro/core/misk.py:29-59 and "
        ":81-119)", "src/repro_torch/kernels/csrc/misk.cu"),
    # the resident fixed point over a bucket, and from a seeded T
    "resident_fixed_point_batched": (
        "none (src/repro/batch/pipeline.py:60-65, the vmapped lax.while_loop "
        "of src/repro/core/mis2.py:106-155)",
        "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    "resident_fixed_point_seeded": (
        "none (the lax.while_loop of src/repro/core/mis2.py:192-236)",
        "src/repro_torch/kernels/csrc/minprop_ell.cu"),
    # the batched Luby loop, kernel 9's hash inside
    "luby_fixed_point_batched": (
        "none (the host loop of src/repro/batch/pipeline.py:123-161 over the "
        "jitted round :68-71; its priorities are "
        "src/repro/kernels/hash_priority/kernel.py:31's arithmetic)",
        "src/repro_torch/kernels/csrc/luby.cu"),
}
# the standalone kernels the main path no longer launches: their bodies (or,
# for hash_pack, its arithmetic) run inside a persistent kernel; each is
# still held against its twin (phase 3) and timed (phase 11);
# fused_refresh_columns stays on phase 12's single-gather path and the
# sliced kernels on its distributed rounds
CARRIED_BY = {"fused_refresh_columns": "resident_fixed_point",
              "fused_decide": "resident_fixed_point",
              "sliced_refresh_columns": "hybrid_fixed_point",
              "sliced_decide": "hybrid_fixed_point",
              "hash_pack": "luby_fixed_point",
              "round_priorities_batched": "luby_fixed_point_batched"}
# the standalone kernels a later phase still launches, and where
STILL_LAUNCHED = {"fused_refresh_columns": "phase 12's single-gather rounds",
                  "sliced_refresh_columns": "phase 12's distributed rounds",
                  "sliced_decide": "phase 12's distributed rounds"}
# wall ms of five warm calls before the persistent kernel (PERF.md section
# 5, tools/profile_torch.py; NVIDIA H100 80GB HBM3, 700 W)
WALL_BEFORE_MS = {
    "Laplace3D_100": {"mis2": [5.36, 5.40, 6.17, 6.40, 6.62],
                      "coarsen": [19.96, 21.78, 26.73, 26.88, 27.65]},
    "Elasticity3D_60": {"mis2": [5.15, 5.79, 5.93, 6.17, 6.66],
                        "coarsen": [75.45, 75.67, 76.41, 79.17, 80.58]},
}
RESIDENT = "resident_fixed_point"
HYBRID = "hybrid_fixed_point"
LUBY = "luby_fixed_point"
MISK = "misk_fixed_point"
BATCHED = "resident_fixed_point_batched"
SEEDED = "resident_fixed_point_seeded"
LUBY_BATCHED = "luby_fixed_point_batched"
# wall ms of five warm calls before the hybrid and Luby persistent kernels
# (PERF.md section 5, tools/profile_torch.py; NVIDIA H100 80GB HBM3, 700 W)
WALL_BEFORE_ONE_DISPATCH_MS = {
    "Powerlaw_1M mis2": [43.80, 49.21, 50.76, 50.93, 59.62],
    "Powerlaw_1M coarsen_two_phase": [176.98, 177.38, 188.39, 189.61, 193.63],
    "Powerlaw_1M coarsen_basic": [64.86, 72.08, 72.91, 73.54, 75.06],
    "Powerlaw_1M color": [364.46, 370.92, 371.44, 376.46, 514.90],
    "Elasticity3D_60 cluster_gs_setup": [585.7, 591.0, 592.4, 607.6, 705.8],
}
JOINS = ("root_join", "phase2_join", "phase3_fixed_point")
# wall ms of five warm calls on the tree before the join kernels (PERF.md
# section 5: tools/profile_torch.py, that tree and this one in one call;
# NVIDIA H100 80GB HBM3, 700 W)
WALL_BEFORE_JOINS_MS = {
    "Laplace3D_100 coarsen_two_phase": [15.40, 15.85, 16.38, 16.64, 16.91],
    "Elasticity3D_60 coarsen_two_phase": [71.64, 71.88, 72.13, 74.01, 75.56],
    "Powerlaw_1M coarsen_two_phase": [43.66, 45.55, 46.22, 57.75, 61.89],
    "Powerlaw_1M coarsen_basic": [10.86, 11.64, 11.88, 11.91, 11.95],
    "Elasticity3D_60 cluster_gs_setup": [552.21, 565.47, 585.73, 618.17,
                                         719.03],
    "Laplace3D_100 amg_setup": [131.80, 133.83, 137.91, 145.13, 153.37],
    "Laplace3D_100 partition8": [110.02, 115.49, 124.22, 142.73, 143.39],
    "Elasticity3D_60 partition8": [143.52, 146.33, 160.96, 161.78, 170.38],
}
SLICED = ("sliced_refresh_columns", "sliced_decide")
UNFUSED = ("refresh_columns", "decide")
# run-sum launches a resident AMG level: A P0 and the two Galerkin stages
RUN_SUMS_PER_LEVEL = 3
# the largest device-to-host copy a resident setup phase may make: shape
# scalars and per-color geometry, never a matrix
SCALAR_COPY_BYTES = 4096


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Launches:
    """The wrappers' launch counters, read as one dict."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self) -> None:
        for m in self.modules:
            m.reset_launches()

    def read(self) -> dict:
        out = {}
        for m in self.modules:
            out.update(m.LAUNCHES)
        return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch as rt
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels import _build
    from repro_torch.kernels.hash_priority import ops as hash_ops
    from repro_torch.kernels.hash_priority import ref as hash_ref
    from repro_torch.kernels.joins import ops as join_ops
    from repro_torch.kernels.joins import ref as join_ref
    from repro_torch.kernels.luby import ops as luby_ops
    from repro_torch.kernels.luby import ref as luby_ref
    from repro_torch.kernels.minprop_ell import ops, ref
    from repro_torch.kernels.misk import ops as misk_ops
    from repro_torch.kernels.misk import ref as misk_ref
    from repro_torch.kernels.run_sums import ops as run_ops
    from repro_torch.kernels.run_sums import ref as run_ref
    from repro_torch.kernels.spmv_ell import ops as spmv_ops
    from repro_torch.kernels.spmv_ell import ref as spmv_ref

    launches = Launches(ops, spmv_ops, hash_ops, run_ops, luby_ops, join_ops,
                        misk_ops)
    provenance_checked = checking_provenance(rt)
    path_launches = {k: 0 for k in KERNELS}

    def add_path(counts: dict) -> None:
        for k, n in counts.items():
            path_launches[k] += n

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()}})
    for log in _build.BUILD_LOGS.values():     # registers, spills
        for ln in log.splitlines():
            if "ptxas" in ln:
                print(ln)

    # -- graphs -----------------------------------------------------------------
    graphs = {}
    for label, a in ANCHORS.items():
        t0 = time.perf_counter()
        gen = getattr(rt.graphs, a["kind"])
        g = rt.Graph(gen(a["n"]), device=dev)
        ell = g.ell
        gen_s = time.perf_counter() - t0
        if a["digest"] is not None:
            check(g.digest == a["digest"],
                  f"{label}: graph digest {g.digest} != {a['digest']}")
            check(g.num_entries == a["entries"],
                  f"{label}: {g.num_entries} entries != {a['entries']}")
        graphs[label] = g
        emit({"phase": "graph", "graph": label, "V": g.num_vertices,
              "entries": g.num_entries, "ell_width": ell.width,
              "digest": g.digest, "setup_s": gen_s})
    pl_want = POWERLAW_1M
    t0 = time.perf_counter()
    pl = rt.Graph(rt.graphs.powerlaw_graph(*pl_want["args"], **pl_want["kw"]),
                  device=dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyb = pl.hybrid()
    hybrid_s = time.perf_counter() - t0
    layout = dict(digest=pl.digest, entries=pl.num_entries,
                  max_degree=pl.max_degree, ell_bytes=pl.ell_bytes_estimate(),
                  spill_cap=hyb.spill_cap, widths=hyb.slice_widths,
                  slab_rows=hyb.slice_num_rows,
                  spill_rows=hyb.num_spill_rows,
                  spill_entries=hyb.num_spill_entries)
    for k, got in layout.items():
        check(got == pl_want[k], f"Powerlaw_1M: {k} {got} != {pl_want[k]}")
    emit({"phase": "graph", "graph": "Powerlaw_1M", "V": pl.num_vertices,
          **layout, "padded_bytes": hyb.padded_bytes,
          "padding_ratio": hyb.padding_ratio, "generate_s": gen_s,
          "hybrid_s": hybrid_s})

    # -- 3. kernels against their twins ------------------------------------------
    rng = np.random.default_rng(20221)
    errs = {k: 0.0 for k in KERNELS}
    checks = 0
    for label in PAPER_GRAPHS:
        ell = graphs[label].ell
        v = ell.num_vertices
        count = int(v * 0.6)
        wl_np = rng.permutation(v).astype(np.int32)   # real rows past count
        wl_np[rng.random(v) < 0.05] = v               # sentinels inside
        args = (ell.neighbors.reshape(-1), torch.from_numpy(wl_np).to(dev),
                torch.tensor([count], dtype=torch.int32, device=dev))
        checks += _hold_round_pair(torch, ops, ref, "fused", label,
                                   _random_state(torch, rng, v, dev), args,
                                   id_bits(v), rng, errs)
        checks += _hold_unfused_pair(torch, ops, ref, label, ell, rng, errs)
    for label in ANCHORS:
        # the ELL SpMV on the graph's matrix: two launches, twin, bitwise
        a_ell = graphs[label].ell_matrix
        x = torch.from_numpy(rng.standard_normal(a_ell.num_rows).astype(
            np.float32)).to(dev)
        y1 = spmv_ops.spmv(a_ell.cols, a_ell.vals, x)
        y2 = spmv_ops.spmv(a_ell.cols, a_ell.vals, x)
        yr = spmv_ref.spmv_ref(a_ell.cols, a_ell.vals, x)
        torch.cuda.synchronize()
        check(_bits_equal(y1, y2), f"spmv not run-to-run equal ({label})")
        check(_bits_equal(y1, yr), f"spmv != twin ({label})")
        check(bool(torch.isfinite(y1).all()), f"spmv not finite ({label})")
        errs["spmv"] = max(errs["spmv"], _max_abs_err(y1, yr))
        checks += 1
    for sl in hyb.slices:
        if sl.width not in TIMED_SLABS:
            continue
        r_rows = sl.num_rows
        count = int(r_rows * 0.6)
        wl_np = np.full(r_rows, r_rows, dtype=np.int32)   # the loop's form
        wl_np[:count] = rng.permutation(r_rows)[:count]
        wl_np[:count][rng.random(count) < 0.05] = r_rows  # sentinels inside
        args = (sl.rows, sl.neighbors.reshape(-1),
                torch.from_numpy(wl_np).to(dev),
                torch.tensor([count], dtype=torch.int32, device=dev))
        state = _random_state(torch, rng, pl.num_vertices, dev)
        checks += _hold_round_pair(
            torch, ops, ref, "sliced", f"Powerlaw_1M width {sl.width}",
            state, args, id_bits(pl.num_vertices), rng, errs)
        checks += _hold_unmasked_decide(
            torch, ops, ref, f"Powerlaw_1M width {sl.width}", state, args,
            id_bits(pl.num_vertices), rng, errs)
    vids = torch.arange(1_000_000, dtype=torch.int32, device=dev)
    hb = id_bits(1_000_000)
    for rnd in range(3):
        itd = torch.tensor([rnd], dtype=torch.int32, device=dev)
        # the TPU kernel's form (ids read, uint32 words) and the coloring's
        # (ids 0..V-1, nothing read, words widened to int64)
        for form, kernel, twin in (
                ("hash_pack", lambda: hash_ops.hash_pack(vids, itd, hb),
                 lambda: hash_ref.hash_pack_ref(vids, itd, hb)),
                ("round_priorities",
                 lambda: hash_ops.round_priorities(1_000_000, itd, hb),
                 lambda: hash_ref.round_priorities_ref(1_000_000, itd, hb))):
            h1, h2, hr = kernel(), kernel(), twin()
            torch.cuda.synchronize()
            check(torch.equal(h1, h2) and torch.equal(h1, hr),
                  f"hash_pack ({form}) != twin or not run-to-run equal "
                  f"(round {rnd})")
            errs["hash_pack"] = max(errs["hash_pack"],
                                    _max_abs_err_u32(h1, hr))
            checks += 1
    # the run-sum kernel on the stream of the L100 level-0 Galerkin product's
    # stage 2 and on one of long runs: two launches each, twin, bitwise
    stage2 = _stage2_stream(torch, rt, graphs["Laplace3D_100"])
    streams = {"Laplace3D_100 level-0 stage 2": stage2,
               "long runs": _long_run_stream(torch, np, dev)}
    for what, stream in streams.items():
        s1, s2 = run_ops.run_sums(*stream), run_ops.run_sums(*stream)
        sr = run_ref.run_sums_ref(*stream)
        torch.cuda.synchronize()
        check(all(_same_bits(x, y) for x, y in zip(s1, s2)),
              f"run_sums not run-to-run equal ({what})")
        check(all(_same_bits(x, y) for x, y in zip(s1, sr)),
              f"run_sums != twin ({what})")
        check(bool(s1[2].any()), f"run_sums kept no run ({what})")
        errs["run_sums"] = max(errs["run_sums"], _max_abs_err(s1[1], sr[1]))
        checks += 1
    emit({"phase": "kernels_vs_twins", "checks": checks, "max_abs_err": errs,
          "run_sums_streams": {k: {"n": int(v[0].numel()),
                                   "runs": int(v[2].numel())}
                               for k, v in streams.items()}})
    del streams

    # -- 4. the MIS-2 path -----------------------------------------------------
    launches.reset()
    main_path = {}
    for label, a in ANCHORS.items():
        g = graphs[label]
        before = launches.read()
        r = rt.mis2(g)
        after_mis2 = launches.read()
        agg = rt.coarsen(g, method="two_phase")
        after_coarsen = launches.read()
        size, iters, digest = a["mis2"]
        check(r.engine == "cuda_resident", f"{label}: engine {r.engine}")
        check((r.size, r.iterations, r.digest) == (size, iters, digest),
              f"{label}: mis2 {(r.size, r.iterations, r.digest)} != "
              f"{(size, iters, digest)}")
        check(r.converged, f"{label}: mis2 did not converge")
        nagg, agg_iters, agg_digest = a["coarsen"]
        check((agg.num_aggregates, agg.digest) == (nagg, agg_digest),
              f"{label}: coarsen {(agg.num_aggregates, agg.digest)} != "
              f"{(nagg, agg_digest)}")
        check(agg_iters is None or agg.iterations == agg_iters,
              f"{label}: coarsen MIS-2 iterations {agg.iterations} != "
              f"{agg_iters}")
        check(agg.engine == "cuda_resident", f"{label}: {agg.engine}")
        check(r.host_syncs == 0, f"{label}: {r.host_syncs} host syncs")
        check(after_mis2[RESIDENT] - before[RESIDENT] == 1,
              f"{label}: {RESIDENT} launched "
              f"{after_mis2[RESIDENT] - before[RESIDENT]} times in a solve")
        check(after_coarsen[RESIDENT] - after_mis2[RESIDENT] in (1, 2),
              f"{label}: {RESIDENT} launched "
              f"{after_coarsen[RESIDENT] - after_mis2[RESIDENT]} times in "
              "coarsen's two MIS-2 phases")
        for k in FUSED:
            check(after_coarsen[k] == before[k],
                  f"{label}: the standalone {k} was launched on the path")
        main_path[label] = {
            "mis2": {"size": r.size, "iterations": r.iterations,
                     "digest": r.digest, "host_syncs": r.host_syncs,
                     "first_call_s": r.wall_time_s},
            "coarsen": {"aggregates": agg.num_aggregates,
                        "mis2_iterations": agg.iterations,
                        "digest": agg.digest, "first_call_s": agg.wall_time_s},
        }
    counts = launches.read()
    add_path(counts)
    check(counts[RESIDENT] > 0, f"{RESIDENT} was never launched on the MIS-2 "
          "path")
    for label in ANCHORS:
        rd = rt.mis2(graphs[label], engine="dense")
        check(rd.digest == ANCHORS[label]["mis2"][2],
              f"{label}: dense digest {rd.digest}")
        main_path[label]["dense_digest"] = rd.digest
    emit({"phase": "mis2_path", "launches": counts, "graphs": main_path})

    # -- 5. the AMG path on Laplace3D_100 -------------------------------------
    l100 = graphs["Laplace3D_100"]
    a100 = l100.ell_matrix
    b100 = _rhs(torch, np, l100)

    def matvec(x):
        return rt.graphs.ops.spmv_ell(a100, x)

    launches.reset()
    amg = {}
    n_coarse = len(AMG_L100["levels"]) - 1
    # engine=None takes resident on the card; host with R is the same-call
    # baseline, held to the same anchors
    for key, engine, explicit in (("R", None, True),
                                  ("matrix_free", None, False),
                                  ("host_R", "host", True)):
        before = launches.read()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        s = rt.amg_setup(l100, aggregation="two_phase", engine=engine,
                         explicit_restriction=explicit)
        peak = torch.cuda.max_memory_allocated() - held
        mid = launches.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rt.solvers.cg(matvec, b100, precond=s.as_precond(), tol=CG_TOL)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        after = launches.read()
        want_engine = engine or "resident"
        check(s.engine == want_engine
              and s.hierarchy.coarse_dtype == "float32"
              and s.hierarchy.coarse_kind == "lu",
              f"AMG {key}: {s.engine} {s.hierarchy.coarse_dtype}")
        check(s.level_sizes == AMG_L100["levels"],
              f"AMG {key}: levels {s.level_sizes}")
        check(s.level_digests == AMG_L100["digests"],
              f"AMG {key}: digests {s.level_digests}")
        resident = want_engine == "resident"
        check(s.dispatches == (7 * n_coarse if resident else 0),
              f"AMG {key}: {s.dispatches} stage calls")
        got_runs = mid["run_sums"] - before["run_sums"]
        check(got_runs == (RUN_SUMS_PER_LEVEL * n_coarse if resident else 0),
              f"AMG {key}: run_sums launched {got_runs} times over "
              f"{n_coarse} levels")
        check(res.converged, f"AMG {key}: CG did not converge")
        check(abs(res.iterations - AMG_L100["cg_iterations"]) <= 1,
              f"AMG {key}: CG {res.iterations} iterations, reference "
              f"{AMG_L100['cg_iterations']}")
        check(bool(np.isfinite(res.x).all()), f"AMG {key}: x not finite")
        cycles = res.iterations + 1
        want_spmv = cycles * (1 + n_coarse * (7 if explicit else 6))
        want_spmv_t = 0 if explicit else cycles * n_coarse
        got_spmv = after["spmv"] - mid["spmv"]
        got_spmv_t = after["spmv_t"] - mid["spmv_t"]
        check((got_spmv, got_spmv_t) == (want_spmv, want_spmv_t),
              f"AMG {key}: spmv/spmv_t launched {(got_spmv, got_spmv_t)}, "
              f"one V-cycle x {cycles} cycles gives "
              f"{(want_spmv, want_spmv_t)}")
        check(mid[RESIDENT] - before[RESIDENT] > 0,
              f"AMG {key}: aggregation launched no MIS-2 kernel")
        amg[key] = {"engine": s.engine, "levels": s.level_sizes,
                    "digests": s.level_digests, "dispatches": s.dispatches,
                    "run_sums": got_runs, "setup_s": s.wall_time_s,
                    "setup_peak_memory_bytes": peak,
                    "timings": s.timings, "cg_iterations": res.iterations,
                    "residual": res.residual_norm, "solve_s": solve_s,
                    "spmv": got_spmv, "spmv_t": got_spmv_t, "setup": s}
    counts = launches.read()
    add_path(counts)
    check(counts["run_sums"] > 0, "run_sums never launched on the AMG path")
    # the two engines' hierarchies, array for array
    for lr, lh in zip(amg["R"]["setup"].hierarchy.levels,
                      amg["host_R"]["setup"].hierarchy.levels):
        pairs = [(lr.diag, lh.diag)] + [
            (x, y) for m, n in ((lr.a_ell, lh.a_ell), (lr.p_ell, lh.p_ell),
                                (lr.r_ell, lh.r_ell)) if m is not None
            for x, y in zip(m, n)]
        check(all(_same_bits(x, y) for x, y in pairs),
              f"AMG level {lr.n}: resident and host arrays differ")
    # device-to-host copies inside a traced resident setup's phases
    traced, copies = _dtoh_in_phases(torch, lambda: rt.amg_setup(
        l100, aggregation="two_phase"))
    check(traced.level_digests == AMG_L100["digests"],
          "AMG traced setup: digests")
    _check_scalar_copies(copies, {"multilevel.prolongator",
                                  "multilevel.galerkin", "multilevel.pack"},
                         "AMG")
    emit({"phase": "amg_path", "launches": counts, "dtoh": copies,
          **{k: {kk: vv for kk, vv in v.items() if kk != "setup"}
             for k, v in amg.items()}})
    # level 0's P: the transposed SpMV against its twin and the explicit R
    lv0_free = amg["matrix_free"]["setup"].hierarchy.levels[0]
    lv0 = amg["R"]["setup"].hierarchy.levels[0]
    p0, t0p, r0 = lv0_free.p_ell, lv0_free.p_t, lv0.r_ell
    xr = torch.from_numpy(rng.standard_normal(p0.num_rows).astype(
        np.float32)).to(dev)
    z1 = spmv_ops.spmv_t(p0.vals, t0p, xr)
    z2 = spmv_ops.spmv_t(p0.vals, t0p, xr)
    zt = spmv_ref.spmv_t_ref(p0.vals, t0p.perm, t0p.offsets, xr, t0p.max_len)
    zr = spmv_ops.spmv(r0.cols, r0.vals, xr)
    torch.cuda.synchronize()
    check(_bits_equal(z1, z2), "spmv_t not run-to-run equal")
    check(_bits_equal(z1, zt), "spmv_t != twin")
    check(_bits_equal(z1, zr), "spmv_t(P) != spmv(R)")
    errs["spmv_t"] = _max_abs_err(z1, zt)
    emit({"phase": "spmv_t_vs_twin", "P": list(p0.cols.shape),
          "num_out": t0p.num_out, "nnz": int(t0p.perm.numel()),
          "max_len": t0p.max_len, "bitwise": True})

    # -- 6. the cluster-GS path -------------------------------------------------
    launches.reset()
    gs, gs_host = {}, {}
    for label, want in CLUSTER_GS.items():
        # engine=None takes resident on the card; host is the same-call
        # baseline, held to the same anchors and giving the same rows
        for engine, out in ((None, gs), ("host", gs_host)):
            before = launches.read()
            c = rt.cluster_gs_setup(graphs[label], aggregation="two_phase",
                                    engine=engine)
            after = launches.read()
            got = dict(clusters=c.num_clusters, digest=c.digest,
                       colors=c.num_colors, colors_digest=c.colors_digest)
            check(c.engine == (engine or "resident"),
                  f"{label}: cluster GS engine {c.engine}")
            check(all(got[k] == want[k] for k in got),
                  f"{label}: cluster GS ({c.engine}) {got} != {want}")
            check(after[LUBY] - before[LUBY] == 1,
                  f"{label}: {LUBY} launched {after[LUBY] - before[LUBY]} "
                  f"times in a coloring of {c.color_rounds} rounds")
            out[label] = {**got, "engine": c.engine,
                          "color_rounds": c.color_rounds,
                          "setup_s": c.wall_time_s, "timings": c.timings,
                          "steps": c.preconditioner.num_steps, "setup": c}
        rows = [x.preconditioner.color_rows
                for x in (gs[label]["setup"], gs_host[label]["setup"])]
        check(len(rows[0]) == len(rows[1]) and all(
            torch.equal(x, y) for x, y in zip(*rows)),
            f"{label}: resident packed rows != host's")
    traced, gs_copies = _dtoh_in_phases(torch, lambda: rt.cluster_gs_setup(
        graphs["Elasticity3D_60"], aggregation="two_phase"))
    check(traced.colors_digest == CLUSTER_GS["Elasticity3D_60"][
        "colors_digest"], "cluster GS traced setup: colors digest")
    _check_scalar_copies(gs_copies, {"multilevel.coarse_graph",
                                     "multilevel.pack"}, "cluster GS")
    gs_rhs = {label: _rhs(torch, np, graphs[label]) for label in CLUSTER_GS}
    gs_cg = {}
    for label, want in CLUSTER_GS.items():
        a_l = graphs[label].ell_matrix
        before = launches.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rt.solvers.cg(lambda x, a=a_l: rt.graphs.ops.spmv_ell(a, x),
                            gs_rhs[label],
                            precond=gs[label]["setup"].as_precond(),
                            tol=CG_TOL)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        after = launches.read()
        want_it = want["cg_iterations"]
        check(res.converged and abs(res.iterations - want_it) <= 1,
              f"{label}: cluster GS CG {res.iterations} iterations (anchor "
              f"{want_it}), converged={res.converged}")
        check(after["spmv"] - before["spmv"] == res.iterations + 1,
              f"{label}: cluster GS CG launched spmv "
              f"{after['spmv'] - before['spmv']} times in {res.iterations} "
              "iterations (one per iteration plus one expected)")
        check(bool(np.isfinite(res.x).all()), f"{label}: GS-CG x not finite")
        gs_cg[label] = {"iterations": res.iterations,
                        "residual": res.residual_norm, "solve_s": solve_s,
                        "spmv": after["spmv"] - before["spmv"]}
    c8 = rt.color(graphs["laplace3d(8)"])
    check((c8.num_colors, c8.digest) == COLOR_L8,
          f"color(laplace3d(8)): {(c8.num_colors, c8.digest)}")
    counts = launches.read()
    add_path(counts)
    check(counts[LUBY] > 0, f"{LUBY} never launched")
    emit({"phase": "cluster_gs_path", "launches": counts, "cg": gs_cg,
          "dtoh_Elasticity3D_60": gs_copies,
          "color_laplace3d(8)": {"colors": c8.num_colors,
                                 "digest": c8.digest, "rounds": c8.rounds},
          **{k: {kk: vv for kk, vv in v.items() if kk != "setup"}
             for k, v in gs.items()},
          "host": {k: {kk: vv for kk, vv in v.items() if kk != "setup"}
                   for k, v in gs_host.items()}})
    # -- 7. the hybrid path on Powerlaw_1M ----------------------------------------
    launches.reset()
    hybrid = _hybrid_path(torch, rt, pl, graphs, launches)
    counts = launches.read()
    add_path(counts)
    for k in (HYBRID, LUBY):
        check(counts[k] > 0, f"{k} was never launched on the hybrid path")
    for k in (*SLICED, "hash_pack"):
        check(counts[k] == 0, f"the standalone {k} was launched on the "
              "hybrid path")
    emit({"phase": "hybrid_path", "launches": counts, **hybrid})

    # -- 8. the host-driven path and the Fig. 2 chain -------------------------------
    launches.reset()
    compacted = _compacted_path(torch, rt, graphs, launches)
    counts = launches.read()
    add_path(counts)
    for k in UNFUSED:
        check(counts[k] > 0, f"{k} was never launched on the host-driven path")
    emit({"phase": "compacted_path", "launches": counts, **compacted})

    # -- 9. distance-k MIS and the multilevel partition -------------------------
    launches.reset()
    misk_part = _misk_partition_path(rt, np, l100, launches)
    counts = launches.read()
    add_path(counts)
    for k in (RESIDENT, MISK):
        check(counts[k] > 0, f"{k} was never launched on the misk and "
              "partition path")
    emit({"phase": "misk_partition_path", "launches": counts, **misk_part})

    # -- 10. the batched pipelines ---------------------------------------------
    launches.reset()
    batch = _batch_path(torch, rt, dev, launches)
    counts = batch.pop("launches")
    add_path(counts)
    for k in (BATCHED, LUBY_BATCHED, RESIDENT, "run_sums"):
        check(counts[k] > 0, f"{k} was never launched on the batch path")
    check(counts["round_priorities_batched"] == 0,
          "the standalone round_priorities_batched was launched on the batch "
          "path")
    batch_a = batch.pop("fleet_a")
    batch_b = batch.pop("fleet_b")
    batch["round_priorities_batched_vs_twin"] = _hold_batched_priorities(
        torch, hash_ops, hash_ref, batch_b, errs)
    emit({"phase": "batch_path", "launches": counts, **batch})

    # -- 11. timing -----------------------------------------------------------------
    timing = {}
    for label in PAPER_GRAPHS:
        timing[label] = _time_kernels(torch, graphs[label], ops, ref, id_bits)
        timing[label].update(_time_unfused(torch, graphs[label], ops, ref,
                                           id_bits))
        timing[label]["spmv"] = _time_spmv(torch, graphs[label].ell_matrix,
                                           spmv_ops, spmv_ref, rng)
        timing[label][RESIDENT] = _time_resident(torch, graphs[label], ops,
                                                 ref, id_bits)
        e2e = {}
        g = graphs[label]
        for what, call in (
                ("mis2", lambda g=g: rt.mis2(g)),
                ("mis2_compacted", lambda g=g: rt.mis2(g, engine="compacted")),
                ("mis2_cuda_compacted",
                 lambda g=g: rt.mis2(g, engine="cuda_compacted")),
                ("coarsen", lambda g=g: rt.coarsen(g, method="two_phase"))):
            walls, res = [], None
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            e2e[what] = {"wall_ms": walls, "iterations": res.iterations}
            if what.startswith("mis2"):
                e2e[what]["host_syncs"] = res.host_syncs
        timing[label]["end_to_end"] = e2e
        emit({"phase": "timing", "graph": label, **timing[label]})
    spmv_t_time = _time_spmv_t(torch, lv0_free, r0, spmv_ops, spmv_ref, rng)
    hash_time = _time_hash_pack(torch, vids, hash_ops, hash_ref, id_bits)
    solve = {
        "v_cycle_ms": {k: _wall_ms(torch, lambda s=amg[k]["setup"]:
                                   s.as_precond()(b100))
                       for k in amg},
        "gs_apply_ms": {k: _wall_ms(torch, lambda k=k: gs[k][
            "setup"].as_precond()(gs_rhs[k])) for k in gs},
        "gs_steps": {k: gs[k]["steps"] for k in gs},
        "cg_amg_s": {k: amg[k]["solve_s"] for k in amg},
        "cg_cluster_gs_s": {k: gs_cg[k]["solve_s"] for k in gs_cg},
        "amg_setup_s": {k: amg[k]["setup_s"] for k in amg},
        "amg_setup_phases_s": {k: amg[k]["timings"] for k in amg},
        "cluster_gs_setup_s": {k: gs[k]["setup_s"] for k in gs},
        "cluster_gs_setup_phases_s": {k: gs[k]["timings"] for k in gs},
        "cluster_gs_host_setup_s": {k: gs_host[k]["setup_s"]
                                    for k in gs_host},
        "cluster_gs_host_setup_phases_s": {k: gs_host[k]["timings"]
                                           for k in gs_host},
        "coarse_graph_Elasticity3D_60": _time_coarse_graph(
            torch, rt, graphs["Elasticity3D_60"],
            gs["Elasticity3D_60"]["setup"]),
    }
    run_time = _time_run_sums(torch, stage2, run_ops, run_ref)
    del stage2
    emit({"phase": "timing_solve", "spmv_t": spmv_t_time,
          "hash_pack": hash_time, "run_sums": run_time, **solve})
    sliced_time = _time_sliced(torch, hyb, ops, ref, id_bits)
    pl_e2e = {what: _wall_ms(torch, call) for what, call in (
        *((f"cuda_hybrid_{label}", lambda g=graphs[label]: rt.mis2(
            g, engine="cuda_hybrid")) for label in PAPER_GRAPHS),
        ("mis2", lambda: rt.mis2(pl)),
        ("coarsen_two_phase", lambda: rt.coarsen(pl, method="two_phase")),
        ("coarsen_basic", lambda: rt.coarsen(pl, method="basic")),
        ("color", lambda: rt.color(pl, engine="luby_hybrid")))}
    emit({"phase": "timing_hybrid", "graph": "Powerlaw_1M",
          "slabs": sliced_time, "end_to_end_wall_ms": pl_e2e})
    batched_time = _time_batched_priorities(torch, batch_b, hash_ops,
                                            hash_ref)
    emit({"phase": "timing_batched_priorities", **batched_time})
    emit({"phase": "timing_misk_partition", "graph": "Laplace3D_100",
          "wall_ms": {
              **{f"misk k={k} {e}": _wall_ms(
                  torch, lambda k=k, e=e: rt.misk(l100, k=k, engine=e))
                 for k in MISK_L100 for e in ("dense", "resident")},
              "partition": _wall_ms(
                  torch, lambda: rt.partition(l100, PARTITION_L100["parts"]))}})

    # -- 12. the distributed engines ---------------------------------------------
    distributed = _distributed_path(torch, np, rt, graphs)
    dist_counts = distributed.pop("launches")
    add_path(dist_counts)
    for k in (*SLICED, "fused_refresh_columns"):
        check(dist_counts.get(k, 0) > 0,
              f"{k} was never launched on the distributed path")
    emit({"phase": "distributed_path", "card": smi, "launches": dist_counts,
          **distributed})

    # -- 13. the serving layer ------------------------------------------------------
    launches.reset()
    serving = _serving_path(torch, np, rt, dev, graphs, pl, launches)
    serve_counts = serving.pop("launches")
    add_path(serve_counts)
    for k in (RESIDENT, HYBRID, BATCHED, LUBY_BATCHED, SEEDED, "run_sums"):
        check(serve_counts[k] > 0, f"{k} was never launched by the server")
    emit({"phase": "serving_path", "card": smi, "launches": serve_counts,
          **serving})
    # -- 14. the resident fixed point as one dispatch --------------------------
    t0 = time.perf_counter()
    one = _resident_one_dispatch(torch, rt, ops, ref, id_bits, graphs,
                                 launches, errs)
    one_counts = one.pop("launches")
    add_path(one_counts)
    check(one_counts[RESIDENT] > 0, f"{RESIDENT} was never launched in "
          "phase 14")
    emit({"phase": "resident_one_dispatch", "card": smi,
          "launches": one_counts, "seconds": time.perf_counter() - t0, **one})
    # -- 15. the hybrid MIS-2 and Luby fixed points as one dispatch each -----
    t0 = time.perf_counter()
    two = _hybrid_luby_one_dispatch(torch, rt, ops, ref, luby_ops, luby_ref,
                                    id_bits, graphs, pl, gs, launches, errs)
    two_counts = two.pop("launches")
    add_path(two_counts)
    for k in (HYBRID, LUBY):
        check(two_counts[k] > 0, f"{k} was never launched in phase 15")
    emit({"phase": "hybrid_luby_one_dispatch", "card": smi,
          "launches": two_counts, "seconds": time.perf_counter() - t0,
          **two})
    # -- 16. the coarsening's label joins as one dispatch each -------------
    t0 = time.perf_counter()
    joins = _joins_one_dispatch(torch, np, rt, join_ops, join_ref, graphs,
                                pl, launches, errs)
    join_counts = joins.pop("launches")
    add_path(join_counts)
    for k in JOINS:
        check(join_counts[k] > 0, f"{k} was never launched in phase 16")
    emit({"phase": "joins_one_dispatch", "card": smi,
          "launches": join_counts, "seconds": time.perf_counter() - t0,
          **joins})
    # -- 17. misk, the batched fixed points and the repair as one dispatch --
    t0 = time.perf_counter()
    more = _batched_misk_one_dispatch(
        torch, np, rt, ops, ref, misk_ops, misk_ref, luby_ops, luby_ref,
        graphs, batch_a, batch_b, launches, errs)
    more_counts = more.pop("launches")
    add_path(more_counts)
    for k in (MISK, BATCHED, LUBY_BATCHED, SEEDED):
        check(more_counts[k] > 0, f"{k} was never launched in phase 17")
    emit({"phase": "batched_misk_one_dispatch", "card": smi,
          "launches": more_counts, "seconds": time.perf_counter() - t0,
          **more})
    # -- 18. the batched joins on the join kernels, the surface, examples ----
    t0 = time.perf_counter()
    last = _batched_joins_surface(torch, np, rt, join_ops, join_ref, graphs,
                                  pl, batch_a, batch_b, launches, errs)
    last_counts = last.pop("launches")
    add_path(last_counts)
    for k in (*JOINS, BATCHED):
        check(last_counts[k] > 0, f"{k} was never launched in phase 18")
    emit({"phase": "batched_joins_surface", "card": smi,
          "launches": last_counts, "seconds": time.perf_counter() - t0,
          **last})
    del batch_a, batch_b
    # -- 19. the static analyzer over the port's Python and CUDA sources ------
    t0 = time.perf_counter()
    lint = _lint_sources(_build)
    emit({"phase": "lint", "card": smi, "seconds": time.perf_counter() - t0,
          **lint})
    # -- 20. the redesigned persistent kernels at each cap of their loops -----
    t0 = time.perf_counter()
    caps = _redesigned_caps(torch, rt, ops, ref, join_ops, join_ref, id_bits,
                            graphs, pl, launches, errs)
    cap_counts = caps.pop("launches")
    add_path(cap_counts)
    for k in (RESIDENT, "phase3_fixed_point"):
        check(cap_counts[k] > 0, f"{k} was never launched in phase 20")
    emit({"phase": "redesigned_caps", "card": smi, "launches": cap_counts,
          "seconds": time.perf_counter() - t0, **caps})
    for k in KERNELS:
        check(k in CARRIED_BY or path_launches[k] > 0,
              f"{k} was never launched on a path")
    new_sites = {"distributed (phase 12)": dist_counts,
                 "serving (phase 13)": serve_counts,
                 "one dispatch (phase 14)": one_counts,
                 "one dispatch (phase 15)": two_counts,
                 "one dispatch (phase 16)": join_counts,
                 "one dispatch (phase 17)": more_counts,
                 "batched joins (phase 18)": last_counts,
                 "redesigned caps (phase 20)": cap_counts}

    main_shape = {
        "fused_refresh_columns": ("Elasticity3D_60 round 0",
                                  timing["Elasticity3D_60"]
                                  ["fused_refresh_columns"]),
        "fused_decide": ("Elasticity3D_60 round 0",
                         timing["Elasticity3D_60"]["fused_decide"]),
        "spmv": ("Laplace3D_100 A [1M, 7]", timing["Laplace3D_100"]["spmv"]),
        "spmv_t": ("Laplace3D_100 level-0 P", spmv_t_time),
        "hash_pack": ("V = 1M, the TPU kernel's form (ids read, uint32 "
                      "words)", hash_time),
        **{k: ("Powerlaw_1M 8-wide slab round 0", sliced_time[8][k])
           for k in SLICED},
        **{k: ("Laplace3D_100 round 0", timing["Laplace3D_100"][k])
           for k in UNFUSED},
        "run_sums": ("Laplace3D_100 level-0 Galerkin stage 2", run_time),
        "round_priorities_batched": (
            f"fleet B bucket {batched_time['shape']}", batched_time),
        RESIDENT: ("Elasticity3D_60, a whole mis2 solve ("
                   f"{timing['Elasticity3D_60'][RESIDENT]['rounds']} "
                   "rounds)", timing["Elasticity3D_60"][RESIDENT]),
        HYBRID: ("Powerlaw_1M, a whole mis2 solve ("
                 f"{two['timing'][HYBRID]['Powerlaw_1M']['rounds']} rounds)",
                 two["timing"][HYBRID]["Powerlaw_1M"]),
        LUBY: ("Powerlaw_1M hybrid layout, a whole color loop ("
               f"{two['timing'][LUBY]['Powerlaw_1M hybrid']['rounds']} "
               "rounds)", two["timing"][LUBY]["Powerlaw_1M hybrid"]),
        "root_join": ("Powerlaw_1M hybrid layout, phase 1 of coarsen("
                      "two_phase)", joins["timing"]["root_join"][
                          "Powerlaw_1M root_join"]),
        "phase2_join": ("Powerlaw_1M hybrid layout, coarsen(two_phase)",
                        joins["timing"]["phase2_join"][
                            "Powerlaw_1M phase2_join"]),
        "phase3_fixed_point": ("Elasticity3D_60, coarsen(two_phase)",
                               joins["timing"]["phase3_fixed_point"][
                                   "Elasticity3D_60 phase3_fixed_point"]),
        MISK: ("Elasticity3D_60, a whole misk(k=2) solve ("
               f"{more['timing'][MISK]['Elasticity3D_60 k=2']['rounds']} "
               "rounds)", more["timing"][MISK]["Elasticity3D_60 k=2"]),
        BATCHED: (f"fleet B bucket {more['timing'][BATCHED]['shape']}, a "
                  "whole mis2_batch solve", more["timing"][BATCHED]),
        SEEDED: ("Laplace3D_100, a streaming delta's repair", more[
            "timing"][SEEDED]),
        LUBY_BATCHED: (f"fleet B bucket "
                       f"{more['timing'][LUBY_BATCHED]['shape']}, a whole "
                       "color_batch loop", more["timing"][LUBY_BATCHED]),
    }
    kernels_line = []
    for k, (replaces, source) in KERNELS.items():
        shape, main = main_shape[k]
        entry = {
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[k],
            "max_abs_err": errs[k], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": shape,
        }
        if k in ("fused_refresh_columns", "fused_decide", "spmv", *UNFUSED,
                 RESIDENT):
            entry["by_graph"] = {g: timing[g][k] for g in PAPER_GRAPHS}
        if k in (HYBRID, LUBY):
            entry["by_graph"] = two["timing"][k]
        if k in JOINS:
            entry["by_graph"] = joins["timing"][k]
        if k in (RESIDENT, "phase3_fixed_point"):
            entry["by_cap"] = caps[k]
        if k == MISK:
            entry["by_graph"] = more["timing"][MISK]
        if k in CARRIED_BY:
            entry["carried_by"] = CARRIED_BY[k]
            entry["note"] = (
                f"the main path runs this body inside {CARRIED_BY[k]} (one "
                "launch a solve), so the standalone kernel's launches fell: "
                "it is held against its twin in phase 3 and timed in phase "
                "11" + (f", and {STILL_LAUNCHED[k]} launch it"
                        if k in STILL_LAUNCHED else ""))
        if k == "hash_pack":
            entry.update(by_form=hash_time["by_form"],
                         ms_read_flush=hash_time["ms_read_flush"],
                         floor_ms=hash_time["floor_ms"])
        if k in SLICED:
            entry["by_slab"] = {f"width {w}": sliced_time[w][k]
                                for w in TIMED_SLABS}
        sites = {site: c[k] for site, c in new_sites.items() if c.get(k)}
        if sites:
            entry["new_sites"] = sites
        kernels_line.append(entry)
    emit({"provenance_checked": provenance_checked})
    emit({"kernels": kernels_line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def _lint_sources(build) -> dict:
    """Phase 19: ``repro_torch.lint`` over the package, Python and CUDA;
    fails on a live finding, a baseline problem, or a compiled source the
    analyzer did not read."""
    from repro_torch.lint import check as lint_check

    res = lint_check([ROOT / "src" / "repro_torch"],
                     baseline=ROOT / "tools" / "lint_baseline_torch.json",
                     repo_root=ROOT)
    check(res.ok, "repro_torch.lint: " + "; ".join(
        [f.render() for f in res.findings] + res.baseline_problems))
    read = {Path(p).name for p in res.cuda_files}
    # every source a library is built from or hashed with
    compiled = {p.name for p in build.CSRC.glob("*.cu*")}
    check(compiled <= read, f"CUDA sources not linted: {compiled - read}")
    return {"counts": res.counts(),
            "cuda_files": sorted(read),
            "python_files": sum(not f.is_root for f in res.project.files),
            "kernels": len(res.project.cuda_kernels()),
            "suppressed": [f"{f.rule} {f.path}:{f.line}"
                           for f in res.suppressed]}


def _misk_partition_path(rt, np, g, launches) -> dict:
    """``misk`` (k = 1, 2, 3, both engines and ``engine=None``; one launch
    of the misk kernel and no host sync a solve) and ``partition(g, 8)``
    against the reference's Laplace3D_100 anchors; the partition's
    coarsening must launch the persistent MIS-2 kernel."""
    out = {"numpy": np.__version__, "misk": {}}
    for k, want in MISK_L100.items():
        for engine in ("dense", "resident", None):
            before = launches.read()[MISK]
            r = rt.misk(g, k=k, engine=engine)
            check(launches.read()[MISK] - before == 1,
                  f"misk k={k} {engine}: {launches.read()[MISK] - before} "
                  "launches")
            name = engine or "dense"
            got = (r.size, r.iterations, r.digest)
            check(got == want, f"misk k={k} {engine}: {got} != {want}")
            check(r.converged and r.engine == f"misk{k}_{name}",
                  f"misk k={k} {engine}: converged {r.converged}, engine "
                  f"{r.engine}")
            check(r.host_syncs == 0,
                  f"misk k={k} {engine}: {r.host_syncs} host syncs in "
                  f"{r.iterations} rounds")
            if engine is not None:
                out["misk"][f"k={k} {engine}"] = dict(
                    size=r.size, iterations=r.iterations, digest=r.digest,
                    host_syncs=r.host_syncs, first_call_s=r.wall_time_s)
    want = PARTITION_L100
    before = launches.read()
    p = rt.partition(g, want["parts"])
    after = launches.read()
    got = dict(parts=p.num_parts, edge_cut=p.edge_cut, levels=p.levels,
               digest=p.digest, history=[tuple(h) for h in p.history])
    check(got == want, f"partition: {got} != {want}")
    check(p.converged and p.parts.shape == (g.num_vertices,),
          f"partition: converged {p.converged}, parts {p.parts.shape}")
    check(int(p.parts.min()) >= 0 and int(p.parts.max()) < want["parts"],
          "partition: a part id out of range")
    loads = np.bincount(p.parts, minlength=want["parts"])
    out["partition"] = dict(got, first_call_s=p.wall_time_s,
                            loads=loads.tolist(),
                            launches={RESIDENT: after[RESIDENT]
                                      - before[RESIDENT]})
    return out


def fleet_anchor(members: list, bucket_shapes: list) -> str:
    """One digest over the ordered per-member digests (strings, or lists of
    level digests) and the bucket shapes, as ``tools/reference_batch.py``
    computes it."""
    import hashlib

    text = json.dumps([members, [list(s) for s in bucket_shapes]])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def fleet_a(rt, dev) -> tuple[list, list]:
    """Fleet A's structures and matrices on ``dev``, in the benchmark's
    order: the meshes, then each size's copies with seeds counting from 0."""
    gen = rt.graphs
    specs = [("laplace3d", m, None) for m in FLEET_A["meshes"]]
    seeds = iter(range(len(FLEET_A["ns"]) * FLEET_A["copies"]))
    specs += [("random", n, next(seeds)) for n in FLEET_A["ns"]
              for _ in range(FLEET_A["copies"])]
    graphs = [rt.Graph(gen.laplace3d(m).graph if kind == "laplace3d" else
                       gen.random_uniform_graph(m, 6.0, seed=s), device=dev)
              for kind, m, s in specs]
    mats = [rt.Graph(gen.laplace3d(m) if kind == "laplace3d" else
                     gen.er_laplacian(m, 6.0, seed=s), device=dev)
            for kind, m, s in specs]
    return graphs, mats


def fleet_b(rt, dev) -> list:
    """Fleet B's structures on ``dev``: the Laplace subdomains (one CSR,
    a handle each), then the random ones."""
    copies, n = FLEET_B["laplace"]
    lap = rt.graphs.laplace3d(n).graph
    graphs = [rt.Graph(lap, device=dev) for _ in range(copies)]
    copies, v, deg, seed = FLEET_B["random"]
    graphs += [rt.Graph(rt.graphs.random_uniform_graph(v, deg, seed=seed + i),
                        device=dev) for i in range(copies)]
    return graphs


PROVENANCE_KINDS = {"amg": "amg_setup"}


def _check_provenance(kind: str, r) -> None:
    """A facade result's provenance: its kind, the card's platform, the
    result's own digest; a batch's record shared by its members."""
    p = r.provenance
    check(p is not None, f"{kind}: no provenance")
    check((p.kind, p.backend, p.digest) == (PROVENANCE_KINDS.get(kind, kind),
                                            "gpu", r.digest),
          f"{kind}: provenance {(p.kind, p.backend, p.digest)}, digest "
          f"{r.digest}")
    check(p.span.get("name") == f"api.{p.kind}" and p.engine,
          f"{kind}: provenance span {p.span.get('name')}, engine {p.engine}")
    if hasattr(r, "results"):
        check(all(m.provenance is p for m in r.results),
              f"{kind}: a member's provenance is not the batch's")


def checking_provenance(rt) -> dict:
    """Wrap each facade entry of ``rt`` so that every result any phase gets
    is checked by :func:`_check_provenance`; returns the count a kind."""
    seen: dict = {}
    for kind in ("mis2", "misk", "coarsen", "color", "partition",
                 "amg_setup", "amg", "cluster_gs_setup", "mis2_batch",
                 "color_batch", "coarsen_batch", "amg_setup_batch"):
        def wrapped(*args, _fn=getattr(rt, kind), _kind=kind, **kw):
            r = _fn(*args, **kw)
            _check_provenance(_kind, r)
            seen[_kind] = seen.get(_kind, 0) + 1
            return r
        setattr(rt, kind, wrapped)
    return seen


def _mis2_key(r):
    return (r.digest, r.iterations, r.converged)


def _color_key(r):
    return (r.digest, r.rounds, r.num_colors, r.converged)


def _coarsen_key(r):
    return (r.digest, r.num_aggregates, r.iterations, r.converged)


def _batch_path(torch, rt, dev, launches) -> dict:
    """Phase 10: fleets A and B through the batched calls (the launches of
    these calls alone are the path's), then every member against the
    single-graph call on the card, and the batched against the looped wall
    time.  Returns the phase's record, with ``launches`` and the stacked
    fleets (``fleet_a``, ``fleet_b``, for the kernels' twin checks and
    timing)."""
    t0 = time.perf_counter()
    ga, ma = fleet_a(rt, dev)
    gb = fleet_b(rt, dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch_a, mats_a, batch_b = (rt.GraphBatch(ga), rt.GraphBatch(ma),
                                rt.GraphBatch(gb))
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    calls = {
        "mis2": (rt.mis2_batch, lambda g: rt.mis2(g), _mis2_key),
        "color": (rt.color_batch, lambda g: rt.color(g), _color_key),
        "coarsen_two_phase": (
            lambda b: rt.coarsen_batch(b, method="two_phase"),
            lambda g: rt.coarsen(g, method="two_phase"), _coarsen_key),
        "coarsen_basic": (
            lambda b: rt.coarsen_batch(b, method="basic"),
            lambda g: rt.coarsen(g, method="basic"), _coarsen_key),
        "amg_setup": (rt.amg_setup_batch, lambda a: rt.amg_setup(a),
                      lambda r: (r.level_digests, r.level_sizes)),
    }
    fleets = {"A": (batch_a, ga, list(calls)),
              "B": (batch_b, gb, ["mis2", "color", "coarsen_two_phase"])}

    def operands(fleet, name):     # (stack, members) of a call
        if name == "amg_setup":
            return mats_a, ma
        return fleets[fleet][0], fleets[fleet][1]

    # the path: every batched call once (fleet A's AMG on its matrices)
    first = {(fleet, name): calls[name][0](operands(fleet, name)[0])
             for fleet, (_, _, names) in fleets.items() for name in names}
    torch.cuda.synchronize()
    counts = launches.read()
    out = {"generate_s": gen_s, "stack_s": stack_s, "fleets": {}}
    for fleet, (batch, graphs, names) in fleets.items():
        rec = {"graphs": len(graphs), "bucket_shapes": batch.bucket_shapes,
               "stats": batch.stats(), "calls": {}}
        for name in names:
            batched, single, key = calls[name]
            stack, members = operands(fleet, name)
            br = first[fleet, name]
            check(br.converged, f"fleet {fleet} {name}: a member did not "
                  "converge")
            if fleet == "A":
                if name == "amg_setup":
                    k = FLEET_A_AMG_MEMBERS
                    anchor = fleet_anchor(
                        [r.level_digests for r in br.results[:k]],
                        rt.GraphBatch(stack.graphs[:k]).bucket_shapes)
                else:
                    anchor = fleet_anchor(br.digests, br.bucket_shapes)
                check(anchor == FLEET_A_ANCHORS[name],
                      f"fleet A {name}: anchor {anchor} != "
                      f"{FLEET_A_ANCHORS[name]}")
            batched_ms = _wall_ms(torch, lambda: batched(stack), reps=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            singles = [single(g) for g in members]
            torch.cuda.synchronize()
            loop_ms = (time.perf_counter() - t0) * 1e3
            for i, (r, s1) in enumerate(zip(br, singles)):
                check(key(r) == key(s1), f"fleet {fleet} {name} member {i}:"
                      f" batched {key(r)} != single {key(s1)}")
            n = len(members)
            rec["calls"][name] = {
                "engine": br.engine, "digest": br.digest,
                "first_call_s": br.wall_time_s,
                "batched_wall_ms": batched_ms, "loop_wall_ms": loop_ms,
                "graphs_per_s_batched": n / (min(batched_ms) / 1e3),
                "graphs_per_s_loop": n / (loop_ms / 1e3),
                "host_syncs": br.provenance.metrics.get("mis2.host_syncs"),
                "iterations": [r.iterations for r in br][:8]}
        out["fleets"][fleet] = rec
    out["launches"] = counts
    out["fleet_a"], out["fleet_b"] = batch_a, batch_b
    return out


def _hold_batched_priorities(torch, hash_ops, hash_ref, batch, errs) -> dict:
    """``round_priorities_batched`` on each bucket of ``batch`` for three
    rounds: two launches run-to-run equal and equal to the twin, bitwise."""
    out = {}
    for bucket in batch.buckets:
        for rnd in (0, 1, 2**31 - 1):
            itd = torch.tensor([rnd], dtype=torch.int32,
                               device=bucket.id_bits.device)
            call = (bucket.rows, itd, bucket.id_bits)
            k1, k2 = (hash_ops.round_priorities_batched(*call),
                      hash_ops.round_priorities_batched(*call))
            tw = hash_ref.round_priorities_batched_ref(*call)
            torch.cuda.synchronize()
            check(torch.equal(k1, k2) and torch.equal(k1, tw),
                  f"round_priorities_batched != twin or not run-to-run "
                  f"equal (bucket {bucket.shape}, round {rnd})")
            errs["round_priorities_batched"] = max(
                errs["round_priorities_batched"], _max_abs_err_u32(k1, tw))
        out[f"{bucket.size} x {bucket.rows} x {bucket.width}"] = {
            "rounds": 3, "slots": bucket.size * bucket.rows}
    return out


def _time_batched_priorities(torch, batch, hash_ops, hash_ref,
                             reps: int = 50) -> dict:
    """One round's priorities of fleet B's first bucket: ``B * rows``
    hashes, an int64 word written a slot (the ``[B]`` bits and the round
    read once)."""
    bucket = batch.buckets[0]
    n = bucket.size * bucket.rows
    it = torch.ones(1, dtype=torch.int32, device=bucket.id_bits.device)
    call = (bucket.rows, it, bucket.id_bits)
    res = _timed(torch, lambda: hash_ops.round_priorities_batched(*call),
                 lambda: hash_ref.round_priorities_batched_ref(*call), None,
                 nbytes=8 * n + 4 * bucket.size + 4, hashes=n, reps=reps)
    return {**res, "n": n, "shape": f"{bucket.size} x {bucket.rows}",
            "ms_read_flush": _event_ms(
                torch, lambda: hash_ops.round_priorities_batched(*call),
                reps, clean=True)}


def _stage2_stream(torch, rt, g):
    """The sorted stream of the Laplace3D_100 level-0 Galerkin product's
    stage 2, ``(keys, vals, starts)``: the run-sum kernel's input on the
    AMG path, from the level's aggregation, prolongator and stage 1."""
    from repro_torch.multilevel import galerkin as gal
    from repro_torch.multilevel.prolongator import _prolongator_device

    a = g.ell_matrix
    v = a.num_rows
    agg = rt.coarsen(g, method="two_phase")
    p = _prolongator_device(a, agg.labels, agg.num_aggregates,
                            2.0 / 3.0)[:3]
    q = gal._coo_rows_repack_device(
        *gal._spgemm_stage1_device(*a, *p, v), v, v)
    return gal._sorted_runs(*gal._stage2_candidates(*p, *q, v))


def _long_run_stream(torch, np, dev):
    """A sorted stream of 2,000 runs of 1 to 20,000 entries (standard
    normal values, a tenth of them ±0.0)."""
    rng = np.random.default_rng(7)
    lens = rng.integers(1, 20_001, 2_000)
    keys = np.repeat(np.arange(2_000, dtype=np.int64) * 3, lens)
    vals = rng.standard_normal(len(keys))
    vals[rng.random(len(keys)) < 0.1] = -0.0
    starts = np.r_[0, np.cumsum(lens)[:-1]].astype(np.int64)
    return tuple(torch.from_numpy(x).to(dev) for x in (keys, vals, starts))


def _same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (float64 compared as int64 words)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _dtoh_in_phases(torch, call):
    """``call()`` traced by ``torch.profiler`` (CPU + CUDA); returns its
    result and the device-to-host copies whose launch lies inside a
    ``multilevel.*`` profiler range (the resident setup's phases): count,
    largest and total bytes, count by range.  The copies are matched to
    their launches through the trace's correlation ids."""
    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
               e["name"]) for e in events
              if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("multilevel.")]
    copies = {e["args"].get("correlation"): e["args"].get("bytes")
              for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in str(e.get("name", ""))}
    sizes, by_range = [], {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") != "cuda_runtime" or corr not in copies:
            continue
        ts = float(e["ts"])
        for lo, hi, name in ranges:
            if lo <= ts <= hi:
                sizes.append(copies[corr])
                by_range[name] = by_range.get(name, 0) + 1
                break
    return out, {"range_names": sorted({r[2] for r in ranges}),
                 "dtoh_in_trace": len(copies),
                 "count": len(sizes), "by_range": by_range,
                 "max_bytes": max((x for x in sizes if x is not None),
                                  default=None),
                 "total_bytes": sum(x for x in sizes if x is not None),
                 "sizes_missing": sum(x is None for x in sizes)}


def _check_scalar_copies(copies: dict, want_ranges: set, what: str) -> None:
    """Every device-to-host copy inside the setup phases is a shape scalar
    (at most SCALAR_COPY_BYTES), and the trace saw the phases and copies."""
    check(want_ranges <= set(copies["range_names"]),
          f"{what}: the trace's phase ranges are {copies['range_names']}")
    check(copies["count"] > 0 and copies["sizes_missing"] == 0,
          f"{what}: no sized device-to-host copy in the phases: {copies}")
    check((copies["max_bytes"] or 0) <= SCALAR_COPY_BYTES,
          f"{what}: a {copies['max_bytes']}-byte device-to-host copy inside "
          f"the setup phases: {copies}")


def _time_run_sums(torch, stream, run_ops, run_ref, reps: int = 20) -> dict:
    """The run-sum kernel on a sorted stream beside its twin and the
    ``index_add_`` yardstick (the same sums, added in no fixed order): the
    stream's values read once (8 B each), per run its start and head key
    read and its key, sum and keep flag written (33 B)."""
    keys, vals, starts = stream
    n, runs = int(keys.numel()), int(starts.numel())
    lens = torch.diff(starts, append=torch.tensor([n], device=starts.device))
    max_len = int(lens.max())
    run_id = torch.repeat_interleave(torch.arange(runs, device=keys.device),
                                     lens)
    out = _timed(torch, lambda: run_ops.run_sums(keys, vals, starts),
                 lambda: run_ref.run_sums_ref(keys, vals, starts, max_len),
                 lambda: torch.zeros(runs, dtype=torch.float64,
                                     device=keys.device).index_add_(
                     0, run_id, vals),
                 nbytes=8 * n + 33 * runs, reps=reps, plain_reps=3)
    return {**out, "n": n, "runs": runs, "max_run": max_len}


def _time_coarse_graph(torch, rt, g, setup) -> dict:
    """The coarse graph of a cluster-GS setup (its labels) built on the
    card (resident) and on the host (host), and its Luby coloring: wall
    ms, each ending in a synchronize."""
    import numpy as np

    from repro_torch.core.coloring import _color_graph_impl
    from repro_torch.graphs.ops import coarse_graph_from_labels
    from repro_torch.multilevel import galerkin as gal

    labels, nagg = setup.labels, setup.num_clusters
    v = g.num_vertices
    lab = torch.from_numpy(labels.astype(np.int64)).to(g.device)

    def device():
        keys = gal._coarse_graph_keys_device(*g.ell, lab, v)
        return rt.Graph(gal._coarse_graph_ell_device(keys, v, nagg))

    coarse = device()
    return {"resident_ms": _wall_ms(torch, device),
            "host_ms": _wall_ms(torch, lambda: rt.Graph(
                coarse_graph_from_labels(g.csr, labels, nagg),
                device=g.device).ell, reps=1),
            "color_ms": _wall_ms(torch, lambda: _color_graph_impl(coarse)),
            "coarse_entries": coarse.num_entries}


def _random_state(torch, rng, v: int, dev):
    """Random T (some IN, some OUT), M (some OUT) and active over ``v``
    vertices, on ``dev``."""
    import numpy as np

    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m[rng.random(v) < 0.2] = 0xFFFFFFFF
    return (torch.from_numpy(t.view(np.int32)).to(dev),
            torch.from_numpy(m.view(np.int32)).to(dev),
            torch.from_numpy(rng.random(v) < 0.9).to(dev))


def _hold_round_pair(torch, ops, ref, prefix: str, where: str, state, args,
                     b: int, rng, errs: dict) -> int:
    """One ``{prefix}_refresh_columns`` and one ``{prefix}_decide`` launch
    against their twins on the same state, for each priority, bitwise;
    ``args`` follow ``t, m[, active]`` in the kernels' signatures.  Returns
    the number of checks."""
    t, m, active = state
    refresh, decide = f"{prefix}_refresh_columns", f"{prefix}_decide"
    checks = 0
    for priority in ("xorshift_star", "xorshift", "fixed"):
        it = torch.tensor([int(rng.integers(0, 12))], dtype=torch.int32,
                          device=t.device)
        kw = dict(priority=priority, b=b)
        mk, mr = m.clone(), m.clone()
        getattr(ops, refresh)(t, mk, *args, it, **kw)
        getattr(ref, refresh + "_ref")(t, mr, *args, it, **kw)
        torch.cuda.synchronize()
        check(torch.equal(mk, mr), f"{refresh} != twin ({where}, {priority})")
        check(not torch.equal(mk, m), f"{refresh} wrote nothing")
        errs[refresh] = max(errs[refresh], _max_abs_err_u32(mk, mr))
        tk, tr = t.clone(), t.clone()
        getattr(ops, decide)(tk, mk, active, *args, it, **kw)
        getattr(ref, decide + "_ref")(tr, mk, active, *args, it, **kw)
        torch.cuda.synchronize()
        check(torch.equal(tk, tr), f"{decide} != twin ({where}, {priority})")
        check(not torch.equal(tk, t), f"{decide} wrote nothing")
        errs[decide] = max(errs[decide], _max_abs_err_u32(tk, tr))
        checks += 2
    return checks


def _hold_unmasked_decide(torch, ops, ref, where: str, state, args, b: int,
                          rng, errs: dict) -> int:
    """One ``sliced_decide`` launch without a mask (``active=None``, on the
    word ``active ? M : IN``, as the hybrid loop calls it without one)
    against its twin, bitwise, for each priority.  Returns the number of
    checks."""
    t, m, active = state
    word = torch.where(active, m, 0).to(torch.int32)
    for priority in ("xorshift_star", "xorshift", "fixed"):
        it = torch.tensor([int(rng.integers(0, 12))], dtype=torch.int32,
                          device=t.device)
        kw = dict(priority=priority, b=b)
        tk, tr = t.clone(), t.clone()
        ops.sliced_decide(tk, word, None, *args, it, **kw)
        ref.sliced_decide_ref(tr, word, None, *args, it, **kw)
        torch.cuda.synchronize()
        check(torch.equal(tk, tr), f"sliced_decide without a mask != twin "
              f"({where}, {priority})")
        check(not torch.equal(tk, t), "sliced_decide wrote nothing")
        errs["sliced_decide"] = max(errs["sliced_decide"],
                                    _max_abs_err_u32(tk, tr))
    return 3


def _hold_unfused_pair(torch, ops, ref, where: str, ell, rng,
                       errs: dict) -> int:
    """One ``refresh_columns`` and one ``decide`` launch against their twins
    on the pre-gathered rows of a pow2-padded worklist (``count`` of ``W``
    slots live, the dead ones gathering row V-1 as the driver's clamp
    does), random T (some IN, some OUT), M and active, bitwise.  Returns
    the number of checks."""
    import numpy as np

    v = ell.num_vertices
    dev = ell.neighbors.device
    w = 1 << (v - 1).bit_length()
    count = int(v * 0.6)
    wl = np.full(w, v - 1, dtype=np.int64)
    wl[:count] = rng.permutation(v)[:count]
    rows = torch.from_numpy(wl).to(dev)
    wl_nbrs = ell.neighbors[rows].contiguous()
    t, m, active = _random_state(torch, rng, v, dev)
    t_rows = t[rows].contiguous()
    mk = ops.refresh_columns_rows(t, wl_nbrs, count)
    mr = ref.refresh_columns_ref(t, wl_nbrs, count)
    tk = ops.decide_rows(t_rows, m, active, wl_nbrs, count)
    tr = ref.decide_ref(t_rows, m, active, wl_nbrs, count)
    torch.cuda.synchronize()
    check(torch.equal(mk, mr), f"refresh_columns != twin ({where})")
    check(bool((mk[:count] != -1).any()), "refresh_columns wrote only OUT")
    check(torch.equal(tk, tr), f"decide != twin ({where})")
    check(not torch.equal(tk, t_rows), "decide decided nothing")
    errs["refresh_columns"] = max(errs["refresh_columns"],
                                  _max_abs_err_u32(mk, mr))
    errs["decide"] = max(errs["decide"], _max_abs_err_u32(tk, tr))
    return 2


def _rhs(torch, np, g):
    """The solves' right-hand side: ``default_rng(0).standard_normal(V)``,
    float32, on the graph's device."""
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        g.num_vertices).astype(np.float32)).to(g.device)


def _bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def _max_abs_err_u32(a, b) -> int:
    import torch

    wa = a.to(torch.int64) & 0xFFFFFFFF
    wb = b.to(torch.int64) & 0xFFFFFFFF
    return int((wa - wb).abs().max().item())


def _wall_ms(torch, call, reps: int = 3) -> list[float]:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _event_ms(torch, fn, n: int, restore=None,
              clean: bool = False) -> float:
    """Median of ``n`` launches of ``fn``, each alone between CUDA events,
    after ``restore()`` and an L2 flush: a 256 MB write, which leaves the
    L2 full of dirty lines whose write-back the launch pays, or, with
    ``clean``, a 256 MB read."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    evs = []
    for _ in range(n):
        if restore is not None:
            restore()
        if clean:
            flush.sum()
        else:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in evs)
    return times[len(times) // 2]


def _timed(torch, kernel, twin, library, nbytes: int, flops: int = 0,
           hashes: int = 0, restore=None, reps: int = 50,
           plain_reps: int = 5) -> dict:
    """Times of the kernel, its twin and the library call, beside the least
    time the card could take: the bytes over the memory rate, the float32
    flops over the float32 rate, or the integer instructions of ``hashes``
    §V-A tuples over the INT32 rate, whichever is longest."""
    _event_ms(torch, kernel, 3, restore)             # warm-up
    ms = _event_ms(torch, kernel, reps, restore)
    plain_ms = _event_ms(torch, twin, plain_reps, restore)
    library_ms = None
    if library is not None:
        _event_ms(torch, library, 3)
        library_ms = _event_ms(torch, library, reps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(flops / FP32_FLOP_PER_S,
                 hashes * INSTR_PER_HASH / INT32_OPS_PER_S) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "hashes": hashes,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_share": bound_ms / ms}


def _csr_of(torch, cols, vals, mask, num_cols: int):
    """The same matrix as a torch CSR tensor (the library call's input)."""
    rows = mask.sum(dim=1)
    crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64,
                       device=cols.device)
    crow[1:] = torch.cumsum(rows, 0)
    with warnings.catch_warnings():          # the "beta" notice
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, cols[mask].to(torch.int64), vals[mask],
            (cols.shape[0], num_cols), check_invariants=False)


def _time_spmv(torch, a_ell, spmv_ops, spmv_ref, rng) -> dict:
    """``y = A x`` on the graph's matrix: cols + vals read once, x once at
    the distinct columns (all of them), y written once; 2 flops a slot."""
    import numpy as np

    v, d = a_ell.cols.shape
    x = torch.from_numpy(rng.standard_normal(v).astype(np.float32)).to(
        a_ell.cols.device)
    csr = _csr_of(torch, a_ell.cols, a_ell.vals, a_ell.mask, v)
    nnz = int(a_ell.mask.sum())
    return {**_timed(
        torch, lambda: spmv_ops.spmv(a_ell.cols, a_ell.vals, x),
        lambda: spmv_ref.spmv_ref(a_ell.cols, a_ell.vals, x),
        lambda: torch.mv(csr, x), nbytes=8 * v * d + 4 * v + 4 * v,
        flops=2 * nnz), "V": v, "D": d, "nnz": nnz}


def _time_spmv_t(torch, lvl, r_ell, spmv_ops, spmv_ref, rng) -> dict:
    """``y = P^T r`` on level 0: perm, offsets and P's vals at the real
    slots read once, r once, y written once; 2 flops an entry.  The library
    call multiplies the transposed CSR (the explicit R) by r."""
    import numpy as np

    p, t = lvl.p_ell, lvl.p_t
    rows = p.num_rows
    x = torch.from_numpy(rng.standard_normal(rows).astype(np.float32)).to(
        p.cols.device)
    csr = _csr_of(torch, r_ell.cols, r_ell.vals, r_ell.mask, rows)
    nnz = int(t.perm.numel())
    return {**_timed(
        torch, lambda: spmv_ops.spmv_t(p.vals, t, x),
        lambda: spmv_ref.spmv_t_ref(p.vals, t.perm, t.offsets, x, t.max_len),
        lambda: torch.mv(csr, x),
        nbytes=4 * nnz + 4 * (t.num_out + 1) + 4 * nnz + 4 * rows
        + 4 * t.num_out, flops=2 * nnz),
        "rows": rows, "D": p.cols.shape[1], "num_out": t.num_out,
        "nnz": nnz}


def _time_hash_pack(torch, vids, hash_ops, hash_ref, id_bits,
                    reps: int = 50) -> dict:
    """One round's priorities of V ids, V hashes, in two forms (under
    ``by_form``): the TPU kernel's (``hash_pack``: ids read, uint32 words
    written; the form ``replaces`` names, so the top-level numbers) and the
    coloring's (``round_priorities``: nothing read, int64 words written),
    each after the write flush (``ms``) and after the read flush
    (``ms_read_flush``).  ``floor_ms``: one launch of a 1-element torch
    ``add_`` timed the same way, the event pair's floor under each flush."""
    n = vids.shape[0]
    it = torch.ones(1, dtype=torch.int32, device=vids.device)
    b = id_bits(n)
    forms = {
        "hash_pack": (lambda: hash_ops.hash_pack(vids, it, b),
                      lambda: hash_ref.hash_pack_ref(vids, it, b), 8 * n + 4),
        "round_priorities": (lambda: hash_ops.round_priorities(n, it, b),
                             lambda: hash_ref.round_priorities_ref(n, it, b),
                             8 * n + 4),
    }
    by_form = {k: {**_timed(torch, kernel, twin, None, nbytes=nbytes,
                            hashes=n, reps=reps),
                   "ms_read_flush": _event_ms(torch, kernel, reps,
                                              clean=True)}
               for k, (kernel, twin, nbytes) in forms.items()}
    one = torch.zeros(1, dtype=torch.int32, device=vids.device)
    _event_ms(torch, lambda: one.add_(1), 3)                 # warm-up
    floor = {"write_flush": _event_ms(torch, lambda: one.add_(1), reps),
             "read_flush": _event_ms(torch, lambda: one.add_(1), reps,
                                     clean=True)}
    return {**by_form["hash_pack"], "n": n, "by_form": by_form,
            "floor_ms": floor}


def _time_kernels(torch, g, ops, ref, id_bits, reps: int = 50,
                  plain_reps: int = 5) -> dict:
    """Each fused MIS-2 kernel and its twin at the resident loop's round-0
    state: every row live, every tuple undecided, the state it writes
    restored before each launch."""
    ell = g.ell
    v, d = ell.neighbors.shape
    dev = ell.neighbors.device
    nbrs_flat = ell.neighbors.reshape(-1)
    b = id_bits(v)
    kw = dict(priority="xorshift_star", b=b)
    t0 = torch.ones(v, dtype=torch.int32, device=dev)
    m0 = torch.full((v,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(v, dtype=torch.bool, device=dev)
    wl = torch.arange(v, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), v, dtype=torch.int32, device=dev)
    it = torch.zeros(1, dtype=torch.int32, device=dev)
    m_ready = m0.clone()
    ops.fused_refresh_columns(t0, m_ready, nbrs_flat, wl, cnt, it, **kw)
    m = m0.clone()
    t = t0.clone()
    # distinct neighbour words a round-0 pass reads (every row is live)
    n_distinct = int(torch.unique(nbrs_flat).numel())
    ids = 4 * v * d
    # refresh: wl + ids + T at distinct neighbours + M written + count, it
    refresh_bytes = 4 * v + ids + 4 * n_distinct + 4 * v + 8
    # decide: wl + ids + own T + M, active at distinct neighbours + T written
    decide_bytes = 4 * v + ids + 4 * v + 5 * n_distinct + 4 * v + 8
    # hashes, one per undecided vertex: every distinct neighbour (refresh),
    # every live row (decide)
    cases = {
        "fused_refresh_columns": (
            lambda: ops.fused_refresh_columns(t0, m, nbrs_flat, wl, cnt, it,
                                              **kw),
            lambda: ref.fused_refresh_columns_ref(t0, m, nbrs_flat, wl, cnt,
                                                  it, **kw),
            lambda: m.copy_(m0), refresh_bytes, n_distinct),
        "fused_decide": (
            lambda: ops.fused_decide(t, m_ready, active, nbrs_flat, wl, cnt,
                                     it, **kw),
            lambda: ref.fused_decide_ref(t, m_ready, active, nbrs_flat, wl,
                                         cnt, it, **kw),
            lambda: t.copy_(t0), decide_bytes, v),
    }
    out = {}
    for k, (kernel, twin, restore, nbytes, hashes) in cases.items():
        out[k] = {**_timed(torch, kernel, twin, None, nbytes, hashes=hashes,
                           restore=restore, reps=reps, plain_reps=plain_reps),
                  "V": v, "D": d}
    return out


def _resident_bytes(v: int, d: int, trace) -> tuple[int, int]:
    """The least bytes and §V-A hashes of a resident solve at the rounds
    run (``trace``: each round's live counts, M worklist then undecided):
    the mask read and T and M written once; a round's refresh reads its
    live rows' D ids and the T words they point at (at most V of them) and
    writes their M; its decide reads its undecided rows' D ids and own T,
    the M words and mask bytes at their neighbours (at most V) and writes
    their T.  The worklists, their counts and any scratch are the design's,
    not the function's, and are not counted.  The hashes: one tuple an
    undecided row a round (the refresh and the decide hash the same one)."""
    nbytes = v + 8 * v
    hashes = 0
    for n2, n1 in trace:
        nbytes += 4 * n2 * d + 4 * min(n2 * d, v) + 4 * n2
        nbytes += 4 * n1 * d + 4 * n1 + 5 * min(n1 * d, v) + 4 * n1
        hashes += n1
    return nbytes, hashes


def _resident_bytes_design(v: int, d: int, trace) -> tuple[int, int]:
    """The bound the slice-17 design was held to (printed beside the least
    bytes of :func:`_resident_bytes`): round 0's state written (T, M, both
    lists) from the mask; a round's per-vertex pass at wide rows (T read,
    the tuples written), the refresh (its list, the rows' ids, the words
    they point at, at most V of them, M written), the decide (its list, the
    rows' ids and own T, M and the mask at the neighbours, at most V, T
    written) and both lists' compaction (each list and the word it keys
    read, the survivors written); the hashes: the undecided rows twice a
    round (refresh and decide)."""
    nbytes = v + 16 * v
    hashes = 0
    wide = d >= 16
    for i, (n2, n1) in enumerate(trace):
        nxt = trace[i + 1] if i + 1 < len(trace) else (0, 0)
        if wide:
            nbytes += 8 * v
        nbytes += 4 * n2 + 4 * n2 * d + 4 * min(n2 * d, v) + 4 * n2
        nbytes += 4 * n1 + 4 * n1 * d + 4 * n1 + 5 * min(n1 * d, v) + 4 * n1
        nbytes += 8 * n1 + 8 * n2 + 4 * (nxt[0] + nxt[1])
        hashes += 2 * n1
    return nbytes, hashes


def _design_bound(rec: dict, nbytes: int, hashes: int) -> dict:
    """``rec`` (a :func:`_timed` record) with the bound of the earlier
    design's count beside its own: ``bound_ms_design`` and its share."""
    ms = max(nbytes / HBM_BYTES_PER_S,
             hashes * INSTR_PER_HASH / INT32_OPS_PER_S) * 1e3
    return {**rec, "bytes_design": nbytes, "hashes_design": hashes,
            "bound_ms_design": ms, "bound_share_design": ms / rec["ms"]}


def _time_resident(torch, g, ops, ref, id_bits, reps: int = 20,
                   plain_reps: int = 3) -> dict:
    """A whole ``mis2`` solve of the persistent kernel (every row active)
    and of its twin, beside the bytes of the solve's passes at the rounds
    it ran (:func:`_resident_bytes`, from the twin's live counts)."""
    ell = g.ell
    v, d = ell.neighbors.shape
    dev = ell.neighbors.device
    nbrs_flat = ell.neighbors.reshape(-1)
    active = torch.ones(v, dtype=torch.bool, device=dev)
    kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=128)
    t, m = (torch.empty(v, dtype=torch.int32, device=dev) for _ in range(2))
    tt, mt = (torch.empty(v, dtype=torch.int32, device=dev) for _ in range(2))
    trace = []
    ref.resident_fixed_point_ref(tt, mt, active, nbrs_flat, trace=trace,
                                 **kw)
    nbytes, hashes = _resident_bytes(v, d, trace)
    return {**_design_bound(_timed(
        torch, lambda: ops.resident_fixed_point(t, m, active, nbrs_flat, **kw),
        lambda: ref.resident_fixed_point_ref(tt, mt, active, nbrs_flat, **kw),
        None, nbytes, hashes=hashes, reps=reps, plain_reps=plain_reps),
        *_resident_bytes_design(v, d, trace)),
        "V": v, "D": d, "rounds": len(trace),
        "live_counts": [list(x) for x in trace]}


def _phase2_masks(rt, graphs, mis2_engine=None) -> dict:
    """The active mask of each graph's second MIS-2 solve in a two-phase
    coarsening (the rows phase 1 left unaggregated) on ``mis2_engine``,
    caught at the aggregation's ``run_mis2``."""
    from repro_torch.core import aggregation

    inner = aggregation.run_mis2
    masks = {}
    for label, g in graphs.items():
        seen = []

        def spy(gh, active, *a, **k):
            seen.append(active)
            return inner(gh, active, *a, **k)

        aggregation.run_mis2 = spy
        try:
            rt.coarsen(g, method="two_phase", mis2_engine=mis2_engine)
        finally:
            aggregation.run_mis2 = inner
        check(len(seen) == 2 and seen[1] is not None,
              f"{label}: coarsen made {len(seen)} MIS-2 solves")
        masks[label] = seen[1].contiguous()
    return masks


def _profiled_solve(torch, rt, g) -> dict:
    """The device events of one ``cuda_resident`` fixed point and of one
    ``mis2`` facade call, traced (``torch.profiler``, read from its chrome
    trace as ``_dtoh_in_phases`` reads it): the fixed point's only kernel
    must be the persistent one, and every device-to-host copy of either
    must start after that kernel ends."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.mis2 import resident_ell_fixed_point
    from repro_torch.core.tuples import id_bits

    ell = g.ell
    v = ell.num_vertices
    act = torch.ones(v, dtype=torch.bool, device=ell.neighbors.device)
    kw = dict(priority="xorshift_star", max_iters=128, b=id_bits(v))
    path = ROOT / "build" / "chip_smoke_solve_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {}
    for what, call in (
            ("fixed_point", lambda: resident_ell_fixed_point(ell.neighbors,
                                                             act, **kw)),
            ("mis2", lambda: rt.mis2(g))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        dev = sorted((e for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy",
                                          "gpu_memset")),
                     key=lambda e: float(e["ts"]))
        listed = [{"name": str(e["name"])[:80], "cat": e["cat"],
                   "us": float(e.get("dur", 0))} for e in dev]
        kernels = [e for e in dev if e["cat"] == "kernel"]
        copies = [e for e in dev if e["cat"] == "gpu_memcpy"
                  and "DtoH" in str(e["name"])]
        resident = [e for e in kernels if RESIDENT in str(e["name"])]
        check(len(resident) == 1, f"{what}: {len(resident)} persistent "
              f"kernels in one solve; device events {listed}")
        end = float(resident[0]["ts"]) + float(resident[0].get("dur", 0))
        check(all(float(c["ts"]) >= end for c in copies),
              f"{what}: a device-to-host copy before the solve ended: "
              f"{listed}")
        out[what] = {"device_events": listed, "kernels": len(kernels),
                     "dtoh": len(copies)}
    check(out["fixed_point"]["kernels"] == 1,
          f"the fixed point ran {out['fixed_point']['kernels']} kernels")
    return out


def _profile_in_child() -> dict:
    """:func:`_profiled_solve` on Laplace3D_100 in a spawned process, whose
    profiler is its first: in this process, after the earlier phases'
    traces and ranks, the profiler saw no device events (measured on one
    H100).  Raises what the child's check raised."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_profile_rank, args=(tmp,), nprocs=1, join=True)
        with open(f"{tmp}/profile.json") as fh:
            rec = json.load(fh)
    check("error" not in rec, rec.get("error", ""))
    return rec


def _profile_rank(rank: int, tmp: str) -> None:
    """The spawned process of :func:`_profile_in_child`: writes the
    profiled solve's record, or the failed check's message, as JSON."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt

    a = ANCHORS["Laplace3D_100"]
    g = rt.Graph(getattr(rt.graphs, a["kind"])(a["n"]), device="cuda")
    try:
        rec = _profiled_solve(torch, rt, g)
    except SmokeFailure as e:
        rec = {"error": str(e)}
    with open(f"{tmp}/profile.json", "w") as fh:
        json.dump(rec, fh)


def _resident_one_dispatch(torch, rt, ops, ref, id_bits, graphs,
                           launches, errs) -> dict:
    """Phase 14: the persistent kernel against its twin, then the anchors
    through ``engine=None`` (one dispatch and no host sync a solve; the
    phase's ``launches``), a profiled solve, the warm walls beside the
    times before the kernel, and the execution-shape gates on the card."""
    import contextlib
    import importlib.util
    import io

    out = {"vs_twin": {}}
    masks = _phase2_masks(rt, graphs)
    for label, g in graphs.items():
        ell = g.ell
        v = ell.num_vertices
        nbrs_flat = ell.neighbors.reshape(-1)
        every = torch.ones(v, dtype=torch.bool, device=nbrs_flat.device)
        for mi, act, case in ((1, every, "1 round"), (2, every, "2 rounds"),
                              (4, every, "4 rounds"), (128, every, "all"),
                              (128, masks[label], "phase-2 mask")):
            kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=mi)
            tk, sk = ops.resident_fixed_point(
                torch.empty(v, dtype=torch.int32, device=nbrs_flat.device),
                torch.empty(v, dtype=torch.int32, device=nbrs_flat.device),
                act, nbrs_flat, **kw)
            tr, sr = ref.resident_fixed_point_ref(
                torch.empty_like(tk), torch.empty_like(tk), act, nbrs_flat,
                **kw)
            torch.cuda.synchronize()
            got, want = sk.tolist(), sr.tolist()
            errs[RESIDENT] = max(errs[RESIDENT], _max_abs_err_u32(tk, tr))
            check(torch.equal(tk, tr) and got == want,
                  f"{label} ({case}): {RESIDENT} {got} != twin {want}, "
                  f"{int((tk != tr).sum())} words differ")
            out["vs_twin"][f"{label} {case}"] = {
                "rows_active": int(act.sum()), "rounds": got[0],
                "live": got[1], "bitwise": True}
    launches.reset()
    anchors = {}
    for label in PAPER_GRAPHS:
        g = graphs[label]
        a = ANCHORS[label]
        before = launches.read()
        with rt.obs.capture() as cap:
            r = rt.mis2(g)
        mid = launches.read()
        with rt.obs.capture() as cap_agg:
            agg = rt.coarsen(g, method="two_phase")
        after = launches.read()
        check((r.engine, r.size, r.iterations, r.digest) == (
            "cuda_resident", *a["mis2"]), f"{label}: mis2 {r.digest}")
        check((agg.num_aggregates, agg.iterations, agg.digest) ==
              a["coarsen"], f"{label}: coarsen {agg.digest}")
        solves = cap_agg.value("mis2.resident_dispatches")
        check(r.host_syncs == 0 and cap.value("mis2.host_syncs") == 0
              and cap_agg.value("mis2.host_syncs") == 0,
              f"{label}: host syncs inside a resident solve")
        check(cap.value("mis2.resident_dispatches") == 1
              and mid[RESIDENT] - before[RESIDENT] == 1,
              f"{label}: mis2 took more than one dispatch")
        check(solves == after[RESIDENT] - mid[RESIDENT] == 2,
              f"{label}: coarsen's {solves} solves made "
              f"{after[RESIDENT] - mid[RESIDENT]} launches")
        anchors[label] = {
            "mis2": [r.size, r.iterations, r.digest, r.host_syncs],
            "coarsen": [agg.num_aggregates, agg.iterations, agg.digest],
            "coarsen_solves": solves}
    out["anchors"] = anchors
    out["launches"] = launches.read()
    out["profile_Laplace3D_100"] = _profile_in_child()
    out["wall_ms"] = {
        label: {what: {"now": _wall_ms(torch, call, reps=5),
                       "before": WALL_BEFORE_MS[label][what]}
                for what, call in (
                    ("mis2", lambda g=graphs[label]: rt.mis2(g)),
                    ("coarsen", lambda g=graphs[label]: rt.coarsen(
                        g, method="two_phase")))}
        for label in PAPER_GRAPHS}
    spec = importlib.util.spec_from_file_location(
        "check_shape_torch", ROOT / "tools" / "check_shape_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["--device", "cuda"])
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(ln, flush=True)
    check(rc == 0 and sum(ln.startswith("PASS") for ln in lines) == 5,
          f"execution-shape gates: rc {rc}")
    out["gates"] = lines
    return out


def _hybrid_bytes(hyb, trace) -> tuple[int, int]:
    """Bytes and §V-A hashes of a hybrid solve at the rounds run
    (``trace``: each round's per-slab lists, ``((M list, n2), (undecided
    list, n1))``, and the heavy rows its spill passes visit, from the twin):
    round 0's state written (T, M, both lists of every slab) from the mask;
    a round's sliced refresh over each M list (its list, the rows' global
    ids and ids, the words they point at, at most V of them, M written), the
    sliced decide over each undecided list (its list, global ids and ids,
    own T, M at the neighbours (no mask), at most V, T written), the spill's
    refresh over its live heavy rows (each row's id and own T, its entries'
    segments and columns, the words they point at, at most V, M written),
    its decide over its undecided heavy rows (each row's id, own T and M,
    its entries' segments and columns, M at them, at most V, T written), and
    each list's survivors written by the compaction (the slots and words it
    keys on were read by the passes); the hashes: the undecided rows, slab
    and heavy, twice a round (refresh and decide)."""
    v = hyb.num_vertices
    widths = hyb.slice_widths
    entries = hyb.spill_seg.long().bincount(minlength=hyb.num_spill_rows)
    nbytes = v + 8 * v + 8 * sum(hyb.slice_num_rows)
    hashes = 0
    for i, (lists, heavy_live, heavy_und) in enumerate(trace):
        nxt = trace[i + 1][0] if i + 1 < len(trace) else None
        for s, (d, ((_, n2), (_, n1))) in enumerate(zip(widths, lists)):
            nbytes += 8 * n2 + 4 * n2 * d + 4 * min(n2 * d, v) + 4 * n2
            nbytes += 12 * n1 + 4 * n1 * d + 4 * min(n1 * d, v) + 4 * n1
            if nxt is not None:
                nbytes += 4 * (nxt[s][0][1] + nxt[s][1][1])
            hashes += 2 * n1
        hl, hu = int(heavy_live.sum()), int(heavy_und.sum())
        el, eu = int(entries[heavy_live].sum()), int(entries[heavy_und].sum())
        nbytes += 12 * hl + 8 * el + 4 * min(el, v)
        nbytes += 16 * hu + 8 * eu + 4 * min(eu, v)
        hashes += 2 * hu
    return nbytes, hashes


def _luby_bytes(maps, spill, trace) -> tuple[int, int]:
    """Bytes and §V-A hashes of a Luby loop at the rounds run (``trace``:
    each round's starting colors, from the twin): both color buffers
    written once; a round, at each row map's rows still uncolored (the
    least a round must visit), the row's own color, its D ids and mask
    bytes, the colors they point at (at most V) and its new color (and
    its global id in a slab), and at the spill's heavy rows still
    uncolored, the row's id, own color and new color, its entries'
    segments and columns and the colors they point at; one hash a row
    still uncolored."""
    v = trace[0].shape[0] if trace else 0
    nbytes, hashes = 8 * v, 0
    seg_rows = heavy = None
    if spill[0].shape[0]:
        heavy = spill[0].to(spill[1].device).long()
        seg_rows = heavy[spill[1].long()]
    for colors in trace:
        unc = colors < 0
        for rows, d in maps:
            u = int(unc.sum() if rows is None else unc[rows.long()].sum())
            nbytes += u * (8 + 4 * d + d) + 4 * min(u * d, v)
            nbytes += 0 if rows is None else 4 * u
        if seg_rows is not None:
            eu = int(unc[seg_rows].sum())
            nbytes += 8 * eu + 4 * min(eu, v) + 12 * int(unc[heavy].sum())
        hashes += int(unc.sum())
    return nbytes, hashes


def _hybrid_luby_one_dispatch(torch, rt, ops, ref, luby_ops, luby_ref,
                              id_bits, graphs, pl, gs, launches, errs) -> dict:
    """Phase 15: the hybrid and Luby persistent kernels against their twins,
    the anchors through the facade (one launch and no host sync a solve;
    the phase's ``launches``), each kernel timed beside its bound and its
    twin, and the walls beside the times before the kernels."""
    from repro_torch.graphs.ops import coarse_graph_from_labels

    dev = pl.device
    out = {"hybrid_vs_twin": {}, "luby_vs_twin": {}}
    hybrid_graphs = {"Powerlaw_1M": pl,
                     **{label: graphs[label] for label in PAPER_GRAPHS}}
    masks = _phase2_masks(rt, hybrid_graphs, mis2_engine="cuda_hybrid")

    def hybrid_args(g):
        hyb = g.hybrid()
        return hyb, [(sl.rows, sl.neighbors.reshape(-1))
                     for sl in hyb.slices], (
            hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)

    def empty(v):
        return (torch.empty(v, dtype=torch.int32, device=dev),
                torch.empty(v, dtype=torch.int32, device=dev))

    for label, g in hybrid_graphs.items():
        hyb, slabs, spill = hybrid_args(g)
        v = hyb.num_vertices
        for mi, act, case in ((1, None, "1 round"), (2, None, "2 rounds"),
                              (4, None, "4 rounds"), (128, None, "all"),
                              (128, masks[label], "phase-2 mask")):
            kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=mi)
            tk, sk, ak = ops.hybrid_fixed_point(*empty(v), act, slabs, spill,
                                                **kw)
            tr, sr, ar = ref.hybrid_fixed_point_ref(*empty(v), act, slabs,
                                                    spill, **kw)
            torch.cuda.synchronize()
            got = [sk.tolist(), ak.tolist()]
            want = [sr.tolist(), ar.tolist()]
            errs[HYBRID] = max(errs[HYBRID], _max_abs_err_u32(tk, tr))
            check(torch.equal(tk, tr) and got == want,
                  f"{label} ({case}): {HYBRID} {got} != twin {want}, "
                  f"{int((tk != tr).sum())} words differ")
            out["hybrid_vs_twin"][f"{label} {case}"] = {
                "rows_active": v if act is None else int(act.sum()),
                "rounds": got[0][0], "live": got[0][1],
                "slice_rows_processed": got[1], "bitwise": True}
    coarse = {}
    for label in CLUSTER_GS:
        setup = gs[label]["setup"]
        coarse[f"{label} cluster-GS coarse"] = rt.Graph(
            coarse_graph_from_labels(graphs[label].csr, setup.labels,
                                     setup.num_clusters), device=dev)
    layouts = {"Powerlaw_1M hybrid": (pl, True),
               **{label: (graphs[label], False) for label in PAPER_GRAPHS},
               **{f"{label} hybrid": (graphs[label], True)
                  for label in PAPER_GRAPHS},
               **{label: (g, False) for label, g in coarse.items()}}

    def luby_args(g, hybrid):
        if hybrid:
            hyb = g.hybrid()
            return "hybrid", ([(sl.rows, sl.neighbors, sl.mask)
                               for sl in hyb.slices],
                              (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols),
                              hyb.num_vertices)
        return "ell", (g.ell.neighbors, g.ell.mask)

    def luby(form, args, twin=False, **kw):
        if form == "hybrid":
            fn = (luby_ref.luby_fixed_point_hybrid_ref if twin
                  else luby_ops.luby_fixed_point_hybrid)
        else:
            fn = (luby_ref.luby_fixed_point_ref if twin
                  else luby_ops.luby_fixed_point)
        return fn(*args, **kw)

    for label, (g, hybrid) in layouts.items():
        form, args = luby_args(g, hybrid)
        for mr in (1, 2, 3, 256):
            ck, rk = luby(form, args, max_rounds=mr)
            cr, rr = luby(form, args, twin=True, max_rounds=mr)
            torch.cuda.synchronize()
            errs[LUBY] = max(errs[LUBY], _max_abs_err(ck, cr))
            check(torch.equal(ck, cr) and torch.equal(rk, rr),
                  f"{label} (max_rounds {mr}): {LUBY} rounds {rk.tolist()} "
                  f"!= twin {rr.tolist()}, {int((ck != cr).sum())} colors "
                  "differ")
            out["luby_vs_twin"][f"{label} max_rounds={mr}"] = {
                "rounds": int(rk.item()), "colors": int(ck.max().item()) + 1,
                "uncolored": int((ck < 0).sum()), "bitwise": True}
    # the anchors through the facade: one launch and no host sync a solve
    launches.reset()
    anchors = {}
    want = POWERLAW_1M

    def solve(call):
        before = launches.read()
        with rt.obs.capture() as cap:
            res = call()
        after = launches.read()
        got = {k: after[k] - before[k] for k in (HYBRID, LUBY)}
        return res, got, cap

    r, got, cap = solve(lambda: rt.mis2(pl))
    check((r.engine, r.size, r.iterations, r.digest) == (
        "cuda_hybrid", *want["mis2"]) and r.host_syncs == 0
        and cap.value("mis2.host_syncs") == 0 and got == {HYBRID: 1, LUBY: 0},
        f"Powerlaw_1M mis2: {r.engine} {r.digest} syncs {r.host_syncs} "
        f"launches {got}")
    for k in ("slice_rows_processed", "spill_passes", "row_bytes_total"):
        check(r.collectives[k] == want[k], f"Powerlaw_1M mis2: {k}")
    anchors["Powerlaw_1M mis2"] = [r.size, r.iterations, r.digest,
                                   r.host_syncs, got]
    for method in ("two_phase", "basic"):
        a, got, cap = solve(lambda m=method: rt.coarsen(pl, method=m))
        solves = cap.value("mis2.resident_dispatches")
        check((a.num_aggregates, a.iterations, a.digest) == want[method]
              and cap.value("mis2.host_syncs") == 0
              and got == {HYBRID: solves, LUBY: 0} and solves >= 1,
              f"Powerlaw_1M coarsen({method}): {a.digest} launches {got} "
              f"for {solves} solves")
        anchors[f"Powerlaw_1M coarsen({method})"] = [
            a.num_aggregates, a.iterations, a.digest, solves, got]
    c, got, _ = solve(lambda: rt.color(pl, engine="luby_hybrid"))
    check((c.num_colors, c.rounds, c.digest) == want["color"]
          and c.host_syncs == 0 and got == {HYBRID: 0, LUBY: 1},
          f"Powerlaw_1M color: {c.digest} syncs {c.host_syncs} launches {got}")
    anchors["Powerlaw_1M color"] = [c.num_colors, c.rounds, c.digest,
                                    c.host_syncs, got]
    for label in PAPER_GRAPHS:
        rh, got, cap = solve(lambda g=graphs[label]: rt.mis2(
            g, engine="cuda_hybrid"))
        check((rh.size, rh.iterations, rh.digest) == ANCHORS[label]["mis2"]
              and rh.host_syncs == 0 and cap.value("mis2.host_syncs") == 0
              and got == {HYBRID: 1, LUBY: 0},
              f"{label} cuda_hybrid: {rh.digest} launches {got}")
        anchors[f"{label} cuda_hybrid"] = [rh.size, rh.iterations, rh.digest,
                                           rh.host_syncs, got]
    c8, got, _ = solve(lambda: rt.color(graphs["laplace3d(8)"]))
    check((c8.num_colors, c8.digest) == COLOR_L8 and c8.host_syncs == 0
          and got == {HYBRID: 0, LUBY: 1},
          f"color(laplace3d(8)): {c8.digest} launches {got}")
    anchors["color(laplace3d(8))"] = [c8.num_colors, c8.digest, c8.rounds,
                                      c8.host_syncs, got]
    for label, w in CLUSTER_GS.items():
        cg, got, _ = solve(lambda g=graphs[label]: rt.cluster_gs_setup(
            g, aggregation="two_phase"))
        check((cg.num_colors, cg.colors_digest) == (w["colors"],
                                                    w["colors_digest"])
              and got[LUBY] == 1,
              f"{label} cluster GS: colors {cg.colors_digest} launches {got}")
        anchors[f"{label} cluster_gs_setup"] = [cg.num_colors,
                                                cg.colors_digest,
                                                cg.color_rounds, got]
    out["anchors"] = anchors
    out["launches"] = launches.read()
    # each kernel beside its bound and its twin
    timing = {HYBRID: {}, LUBY: {}}
    for label, g in hybrid_graphs.items():
        hyb, slabs, spill = hybrid_args(g)
        v = hyb.num_vertices
        kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=128)
        trace = []
        ref.hybrid_fixed_point_ref(*empty(v), None, slabs, spill, trace=trace,
                                   **kw)
        nbytes, hashes = _hybrid_bytes(hyb, trace)
        state, twin_state = empty(v), empty(v)
        timing[HYBRID][label] = {**_timed(
            torch, lambda: ops.hybrid_fixed_point(*state, None, slabs, spill,
                                                  **kw),
            lambda: ref.hybrid_fixed_point_ref(*twin_state, None, slabs,
                                               spill, **kw),
            None, nbytes, hashes=hashes, reps=20, plain_reps=3),
            "V": v, "widths": list(hyb.slice_widths),
            "spill_entries": hyb.num_spill_entries, "rounds": len(trace)}
    for label in ("Powerlaw_1M hybrid", *PAPER_GRAPHS):
        g, hybrid = layouts[label]
        form, args = luby_args(g, hybrid)
        trace = []
        luby(form, args, twin=True, max_rounds=256, trace=trace)
        if form == "hybrid":
            maps = [(rows, nb.shape[1]) for rows, nb, _ in args[0]]
            nbytes, hashes = _luby_bytes(maps, args[1], trace)
        else:
            nbytes, hashes = _luby_bytes(
                [(None, args[0].shape[1])],
                (torch.empty(0, dtype=torch.int32, device=dev),) * 3, trace)
        timing[LUBY][label] = {**_timed(
            torch, lambda: luby(form, args, max_rounds=256),
            lambda: luby(form, args, twin=True, max_rounds=256), None,
            nbytes, hashes=hashes, reps=20, plain_reps=3),
            "rounds": len(trace)}
        del trace
    out["timing"] = timing
    out["wall_ms"] = {
        what: {"now": _wall_ms(torch, call, reps=5),
               "before": WALL_BEFORE_ONE_DISPATCH_MS.get(what)}
        for what, call in (
            ("Powerlaw_1M mis2", lambda: rt.mis2(pl)),
            ("Powerlaw_1M coarsen_two_phase",
             lambda: rt.coarsen(pl, method="two_phase")),
            ("Powerlaw_1M coarsen_basic",
             lambda: rt.coarsen(pl, method="basic")),
            ("Powerlaw_1M color", lambda: rt.color(pl, engine="luby_hybrid")),
            *((f"{label} cluster_gs_setup",
               lambda g=graphs[label]: rt.cluster_gs_setup(
                   g, aggregation="two_phase")) for label in CLUSTER_GS))}
    return out


JOIN_OF = {"root_join": "root_join", "cleanup_join": "root_join",
           "phase2_join": "phase2_join",
           "phase3_fixed_point": "phase3_fixed_point"}


def _join_calls(rt, join_ops, g, method: str) -> list:
    """The join wrapper calls of one ``coarsen(method=...)`` on ``g``, as
    ``(wrapper, args, kwargs)`` with every tensor cloned: the label states
    a real coarsening reaches."""
    return _caught_joins(join_ops, lambda: rt.coarsen(g, method=method))


def _caught_joins(join_ops, call) -> list:
    """The join wrapper calls ``call()`` makes, as ``(wrapper, args,
    kwargs)`` with every tensor argument cloned."""
    inner = {k: getattr(join_ops, k) for k in JOIN_OF}
    seen = []

    def spy(name):
        def call(*args, **kw):
            seen.append((name, tuple(a.clone() if hasattr(a, "clone") else a
                                     for a in args), dict(kw)))
            return inner[name](*args, **kw)
        return call

    for k in JOIN_OF:
        setattr(join_ops, k, spy(k))
    try:
        call()
    finally:
        for k, fn in inner.items():
            setattr(join_ops, k, fn)
    return seen


def _random_join_calls(torch, np, rng, layout, dev) -> list:
    """Join calls on label states drawn from ``rng``: random roots (with
    and without the cleanup), random labels for the cleanup and phase 3
    (a third to nine tenths unlabeled, ids from a fifth of V), a random
    second set for phase 2; on a layout with a spill, every other heavy
    row unlabeled, and in one phase-3 state all of them."""
    v = layout.v
    heavy = layout.spill[0].long()

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def labels(frac, all_heavy=False):
        lab = np.where(rng.random(v) < frac,
                       rng.integers(0, max(v // 5, 1), v), -1)
        lab = tensor(lab.astype(np.int32))
        lab[heavy if all_heavy else heavy[::2]] = -1
        return lab

    def phase():
        return tensor(rng.integers(0, 3, v).astype(np.uint8))

    roots = tensor(rng.random(v) < 0.05)
    nagg = torch.tensor([v // 5], dtype=torch.int32, device=dev)
    return [
        ("root_join", (layout, roots), {"cleanup_rounds": 0}),
        ("root_join", (layout, roots), {"cleanup_rounds": 4}),
        ("cleanup_join", (layout, labels(0.6), phase()), {}),
        ("phase2_join", (layout, labels(0.5), phase(),
                         tensor(rng.random(v) < 0.3), nagg),
         {"min_secondary": 2}),
        ("phase2_join", (layout, labels(0.7), phase(),
                         tensor(rng.random(v) < 0.3), nagg),
         {"min_secondary": 3}),
        ("phase3_fixed_point", (layout, labels(0.5), phase()), {}),
        ("phase3_fixed_point", (layout, labels(0.1), phase()), {}),
        ("phase3_fixed_point", (layout, labels(0.7, all_heavy=True),
                                phase()), {}),
    ]


def _rows_in(layout, un) -> tuple[list, int, int]:
    """Per map, its rows where the bool ``[V]`` ``un`` holds, and the heavy
    rows where it holds and their entries."""
    per_map = [int(un.sum()) if rows is None else int(un[rows.long()].sum())
               for rows, _, _ in layout.maps]
    rows, seg, _ = layout.spill
    if not rows.shape[0]:
        return per_map, 0, 0
    heavy_un = un[rows.long()]
    return per_map, int(heavy_un.sum()), int(heavy_un[seg.long()].sum())


def _join_bytes(join_ref, name: str, args, kw, design: bool = False) -> int:
    """The least bytes a join moves (``_luby_bytes`` counts the same way):
    its [V] inputs read and outputs written once; a pass over rows reads
    their D ids (and mask bytes where it tests them), a slab row's global
    id, and the words its ids point at (at most V a pass); a pass over the
    spill reads its heavy rows' ids and their entries' segments and
    columns and the words those point at.  The rounds are the twin's
    (``trace``), each over the rows unlabeled at its start.  Phase 3's
    rows also read the size of each label they hold, each distinct label's
    once a round (at most the labels that round starts with); ``design``:
    the count the slice-16 design was held to, one size a slot like a label
    (at most V)."""
    layout = args[0]
    v = layout.v
    maps = [(rows is not None, nb.shape[0], nb.shape[1])
            for rows, nb, _ in layout.maps]
    h, e = layout.spill[0].shape[0], layout.spill[2].shape[0]

    def rows_pass(counts, heavy, entries, mask: bool, gathers: int = 1,
                  sizes: int = 0):
        b, slots = 0, entries
        for (slab, _, d), n in zip(maps, counts):
            b += n * (4 * d + (d if mask else 0) + (4 if slab else 0))
            b += gathers * 4 * min(n * d, v)
            slots += n * d
        b += 4 * heavy + 8 * entries + gathers * 4 * min(entries, v)
        return b + 4 * min(slots, sizes)

    every = [r for _, r, _ in maps]
    trace = []
    if name in ("root_join", "cleanup_join"):
        twin = getattr(join_ref, name + "_ref")
        twin(*args, **kw, trace=trace)
        nbytes = 5 * v                    # labels and marks written
        nbytes += v + rows_pass(every, h, e, False) if name == "root_join" \
            else 5 * v                    # the roots, or labels and marks
        for labels in trace:
            nbytes += rows_pass(*_rows_in(layout, labels < 0), False)
        return nbytes
    if name == "phase2_join":
        labels, in_set2 = args[1], args[3]
        return (12 * v + 8     # in: labels, marks, the set, nagg; out: labels,
                               # marks, roots2, nagg
                + rows_pass(*_rows_in(layout, in_set2), True)
                + rows_pass(*_rows_in(layout, labels < 0), False))
    join_ref.phase3_fixed_point_ref(*args, **kw, trace=trace)
    nbytes = 10 * v                       # labels and marks, in and out
    for labels in trace:                  # the labels and the sizes
        listed = _rows_in(layout, labels < 0)
        if design:
            nbytes += rows_pass(*listed, True, 2)
        else:
            distinct = int(labels[labels >= 0].unique().numel())
            nbytes += rows_pass(*listed, True, 1, distinct)
    return nbytes


def _hold_join(torch, join_ops, join_ref, name: str, args, kw, what: str,
               errs: dict):
    """The join wrapper ``name`` twice with
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
    call), each one launch of its kernel, its outputs bitwise equal to each
    other's and to the twin's.  Returns the first call's outputs."""
    kernel = JOIN_OF[name]
    wrapper = getattr(join_ops, name)
    torch.cuda.synchronize()
    before = dict(join_ops.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wrapper(*args, **kw)
        again = wrapper(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = dict(join_ops.LAUNCHES)
    want = getattr(join_ref, name + "_ref")(*args, **kw)
    torch.cuda.synchronize()
    check({k: after[k] - before[k] for k in after}
          == {k: 2 * (k == kernel) for k in after},
          f"{what}: {name} launched {after} from {before}")
    same = [torch.equal(x, y) and torch.equal(x, z)
            for x, y, z in zip(got, again, want)]
    check(all(same), f"{what} {name}: outputs {same} equal twin and rerun")
    errs[kernel] = max(errs[kernel], max(
        _max_abs_err(x, y) for x, y in zip(got, want)))
    return got


def _joins_one_dispatch(torch, np, rt, join_ops, join_ref, graphs, pl,
                        launches, errs) -> dict:
    """Phase 16: each join kernel against its twin on the label states of
    real coarsenings and on seeded ones, one launch a call and no host sync
    inside it; the coarsening anchors through the facade with one launch of
    each join; each kernel timed beside its bound and its twin; the walls
    of the calls that coarsen beside the times before the kernels."""
    dev = pl.device
    rng = np.random.default_rng(2026)
    cases = {"Laplace3D_100": graphs["Laplace3D_100"],
             "Elasticity3D_60": graphs["Elasticity3D_60"], "Powerlaw_1M": pl}
    out = {"vs_twin": {}}
    timed = {}
    for label, g in cases.items():
        calls = [(f"{m} {i}", c) for m in ("two_phase", "basic")
                 for i, c in enumerate(_join_calls(rt, join_ops, g, m))]
        layout = calls[0][1][1][0]
        calls += [(f"seeded {i}", c) for i, c in enumerate(
            _random_join_calls(torch, np, rng, layout, dev))]
        for case, (name, args, kw) in calls:
            kernel = JOIN_OF[name]
            got = _hold_join(torch, join_ops, join_ref, name, args, kw,
                             f"{label} {case}", errs)
            rec = {"kw": kw, "bitwise": True,
                   "unlabeled_after": int((got[0] < 0).sum())}
            if name != "root_join":   # per map, heavy rows, their entries
                rec["unlabeled_before"] = _rows_in(layout, args[1] < 0)
            out["vs_twin"][f"{label} {case} {name}"] = rec
            if case.startswith("two_phase") or (
                    case.startswith("basic") and name == "root_join"):
                key = f"{kernel} {kw.get('cleanup_rounds', '')}".strip()
                timed.setdefault(label, {})[key] = (name, args, kw)
    # the anchors through the facade, one launch of each join
    launches.reset()
    anchors = {}
    for label, method, want in (
            ("Laplace3D_100", "two_phase", ANCHORS["Laplace3D_100"]["coarsen"]),
            ("Elasticity3D_60", "two_phase",
             ANCHORS["Elasticity3D_60"]["coarsen"]),
            ("Powerlaw_1M", "two_phase", POWERLAW_1M["two_phase"]),
            ("Powerlaw_1M", "basic", POWERLAW_1M["basic"])):
        before = launches.read()
        a = rt.coarsen(cases[label], method=method)
        after = launches.read()
        got = {k: after[k] - before[k] for k in join_ops.LAUNCHES}
        check((a.num_aggregates, a.iterations, a.digest) == want,
              f"{label} coarsen({method}): {a.digest} != {want}")
        check(got == ({"root_join": 1, "phase2_join": 1,
                       "phase3_fixed_point": 1} if method == "two_phase"
                      else {"root_join": 1, "phase2_join": 0,
                            "phase3_fixed_point": 0}),
              f"{label} coarsen({method}): join launches {got}")
        anchors[f"{label} coarsen({method})"] = [
            a.num_aggregates, a.iterations, a.digest, got]
    out["anchors"] = anchors
    out["launches"] = launches.read()
    # each kernel beside its bound and its twin, at a real coarsening's state
    timing = {k: {} for k in JOINS}
    for label, per in timed.items():
        for key, (name, args, kw) in per.items():
            kernel = JOIN_OF[name]
            timing[kernel][f"{label} {key}".strip()] = _timed(
                torch, lambda n=name, a=args, k=kw: getattr(join_ops, n)(
                    *a, **k),
                lambda n=name, a=args, k=kw: getattr(join_ref, n + "_ref")(
                    *a, **k),
                None, _join_bytes(join_ref, name, args, kw), reps=20,
                plain_reps=3)
            if kernel == "phase3_fixed_point":
                timing[kernel][f"{label} {key}".strip()] = _design_bound(
                    timing[kernel][f"{label} {key}".strip()],
                    _join_bytes(join_ref, name, args, kw, design=True), 0)
    out["timing"] = timing
    l100, e60 = graphs["Laplace3D_100"], graphs["Elasticity3D_60"]
    out["wall_ms"] = {
        what: {"now": _wall_ms(torch, call, reps=5),
               "before": WALL_BEFORE_JOINS_MS.get(what)}
        for what, call in (
            *((f"{label} coarsen_{m}", lambda g=g, m=m: rt.coarsen(
                g, method=m)) for label, g in cases.items()
              for m in ("two_phase", "basic")),
            ("Elasticity3D_60 cluster_gs_setup",
             lambda: rt.cluster_gs_setup(e60, aggregation="two_phase")),
            ("Laplace3D_100 amg_setup",
             lambda: rt.amg_setup(l100, aggregation="two_phase")),
            ("Laplace3D_100 partition8", lambda: rt.partition(l100, 8)),
            ("Elasticity3D_60 partition8", lambda: rt.partition(e60, 8)))}
    return out


def _redesigned_caps(torch, rt, ops, ref, join_ops, join_ref, id_bits,
                     graphs, pl, launches, errs) -> dict:
    """Phase 20: the main path's ``mis2`` and ``coarsen(two_phase)`` on
    the paper graphs against the anchors (the phase's ``launches``); then
    ``resident_fixed_point`` on both paper graphs (every row active) at
    each cap of ``max_iters`` from 0 to one past the rounds it runs, and
    ``phase3_fixed_point`` at the state a real two-phase coarsening of
    Laplace3D_100, Elasticity3D_60 and Powerlaw_1M gives it at each cap of
    its rounds (0 to one past the twin's, at most four): each held to its
    twin capped the same (T bitwise with the rounds and live count; labels
    and marks bitwise), then timed (CUDA events, L2 flushed, median of 10).
    The gap between two caps is one round's cost, cap 0 the prologue's;
    the twin's trace gives each round's live rows (phase 3: unlabeled rows
    per map and heavy rows)."""
    launches.reset()
    for label in PAPER_GRAPHS:
        g, a = graphs[label], ANCHORS[label]
        r = rt.mis2(g)
        agg = rt.coarsen(g, method="two_phase")
        check((r.size, r.iterations, r.digest) == a["mis2"],
              f"{label}: mis2 {r.digest}")
        check((agg.num_aggregates, agg.iterations, agg.digest) ==
              a["coarsen"], f"{label}: coarsen {agg.digest}")
    out = {"launches": launches.read(), RESIDENT: {},
           "phase3_fixed_point": {}}
    for label in PAPER_GRAPHS:
        ell = graphs[label].ell
        v = ell.num_vertices
        nb = ell.neighbors.reshape(-1)
        every = torch.ones(v, dtype=torch.bool, device=nb.device)

        def state():
            return (torch.empty(v, dtype=torch.int32, device=nb.device),
                    torch.empty(v, dtype=torch.int32, device=nb.device))

        trace = []
        ref.resident_fixed_point_ref(*state(), every, nb,
                                     priority="xorshift_star", b=id_bits(v),
                                     max_iters=128, trace=trace)
        by_cap = {}
        for cap in range(len(trace) + 2):
            kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=cap)
            tk, sk = ops.resident_fixed_point(*state(), every, nb, **kw)
            tr, sr = ref.resident_fixed_point_ref(*state(), every, nb, **kw)
            torch.cuda.synchronize()
            got, want = sk.tolist(), sr.tolist()
            errs[RESIDENT] = max(errs[RESIDENT], _max_abs_err_u32(tk, tr))
            check(torch.equal(tk, tr) and got == want,
                  f"{label} max_iters={cap}: {RESIDENT} {got} != twin {want}")
            t, m = state()
            by_cap[cap] = _event_ms(torch, lambda: ops.resident_fixed_point(
                t, m, every, nb, **kw), 10)
        out[RESIDENT][label] = _per_round(by_cap, {
            "rounds": len(trace), "live_counts": [list(x) for x in trace]})
    for label, g in (("Laplace3D_100", graphs["Laplace3D_100"]),
                     ("Elasticity3D_60", graphs["Elasticity3D_60"]),
                     ("Powerlaw_1M", pl)):
        _, args, _ = next(c for c in _join_calls(rt, join_ops, g, "two_phase")
                          if c[0] == "phase3_fixed_point")
        layout = args[0]
        trace = []
        join_ref.phase3_fixed_point_ref(*args, trace=trace)
        by_cap = {}
        for cap in range(min(len(trace) + 1, join_ref.JOIN_ROUNDS) + 1):
            got = join_ops._phase3_on_card(*args, rounds=cap)
            every_round = join_ref.JOIN_ROUNDS
            join_ref.JOIN_ROUNDS = cap
            try:
                want = join_ref.phase3_fixed_point_ref(*args)
            finally:
                join_ref.JOIN_ROUNDS = every_round
            torch.cuda.synchronize()
            errs["phase3_fixed_point"] = max(
                errs["phase3_fixed_point"],
                max(_max_abs_err(x, y) for x, y in zip(got, want)))
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"{label} rounds={cap}: phase3_fixed_point != twin")
            by_cap[cap] = _event_ms(torch, lambda: join_ops._phase3_on_card(
                *args, rounds=cap), 10)
        rows = [_rows_in(layout, lab < 0) for lab in trace]
        out["phase3_fixed_point"][label] = _per_round(by_cap, {
            "rounds": len(trace), "unlabeled_per_map": [x[0] for x in rows],
            "unlabeled_heavy": [x[1] for x in rows],
            "unlabeled_heavy_entries": [x[2] for x in rows]})
    return out


def _per_round(by_cap: dict, rec: dict) -> dict:
    """``rec`` with each cap's ms, the prologue's (cap 0) and each round's
    (the gap to the cap before) in µs."""
    caps = sorted(by_cap)
    return {**rec, "ms_by_cap": {str(c): by_cap[c] for c in caps},
            "prologue_us": by_cap[caps[0]] * 1e3,
            "round_us": [(by_cap[b] - by_cap[a]) * 1e3
                         for a, b in zip(caps, caps[1:])]}


# wall ms of five warm calls before the one-dispatch misk and batched loops
# (PERF.md section 5, tools/profile_torch.py; NVIDIA H100 80GB HBM3, 700 W)
WALL_BEFORE_BATCHED_MS = {
    "Laplace3D_100 misk2": [8.13, 8.30, 8.49, 8.51, 8.73],
    "Elasticity3D_60 misk2": [20.60, 20.60, 20.63, 20.95, 21.01],
    "fleet A mis2_batch": [56.67, 59.26, 74.88, 81.76, 82.87],
    "fleet A coarsen_batch": [151.69, 156.91, 189.39, 190.06, 198.31],
    "fleet A color_batch": [164.16, 171.28, 173.82, 175.56, 188.21],
    "fleet B mis2_batch": [62.22, 62.52, 63.71, 64.12, 65.25],
    "fleet B coarsen_batch": [171.42, 171.82, 172.04, 177.68, 178.18],
    "fleet B color_batch": [214.78, 215.30, 216.55, 219.62, 220.04],
}
MISK_UNCAPPED = 256
# the streaming deltas of phase 13 whose repair seeds phase 17 holds
REPAIR_SEEDS = 3


def _hold_one_dispatch(torch, kernel, twin, key: str, counters: dict,
                       what: str, errs: dict) -> list:
    """``kernel()`` twice with ``torch.cuda.set_sync_debug_mode("error")``
    (no host sync inside a call), each exactly one launch of ``key`` among
    ``counters``, its outputs bitwise equal to each other's and to
    ``twin()``'s.  Returns the first call's outputs."""
    torch.cuda.synchronize()
    before = dict(counters)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernel()
        again = kernel()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = dict(counters)
    want = twin()
    torch.cuda.synchronize()
    check({k: after[k] - before[k] for k in after}
          == {k: 2 * (k == key) for k in after},
          f"{what}: launches {after} from {before}")
    same = [torch.equal(x, y) and torch.equal(x, z)
            for x, y, z in zip(got, again, want)]
    check(all(same), f"{what}: {key} outputs {same} equal twin and rerun")
    errs[key] = max(errs[key], max(_max_abs_err_u32(x, z)
                                   for x, z in zip(got, want)))
    return got


def _misk_bytes(v: int, d: int, k: int, trace, live: int) -> int:
    """Bytes of a misk solve at the rounds run (``trace``: each round's
    undecided count, from the twin; ``live``: the count left): T and the
    first list written; a round's refresh (the list read, T written at its
    rows), k min hops (the ``[V, D]`` ids, the words they point at, at
    most V of them, M written), k near hops (the ids; the first reads T and
    M^k at them, the others the flags, at most V each; the flags written)
    and the compaction (the list, T and the flag at its rows, the survivors
    written)."""
    nbytes = 8 * v
    for i, n in enumerate(trace):
        kept = trace[i + 1] if i + 1 < len(trace) else live
        nbytes += 8 * n
        nbytes += k * (4 * v * d + 4 * v + 4 * v)
        nbytes += (4 * v * d + 8 * v + v) + (k - 1) * (4 * v * d + 2 * v)
        nbytes += 9 * n + 4 * kept
    return nbytes


def _fleet_phase2_masks(rt, batch) -> dict:
    """Each bucket's active mask of the second MIS-2 solve in a two-phase
    ``coarsen_batch`` (the rows phase 1 left unaggregated), caught at the
    pipeline's fixed point: bucket index -> mask."""
    from repro_torch.batch import pipeline

    inner = pipeline._fixed_point
    seen: dict = {}

    def spy(bucket, active, options):
        seen.setdefault(id(bucket), []).append(active.clone())
        return inner(bucket, active, options)

    pipeline._fixed_point = spy
    try:
        rt.coarsen_batch(batch, method="two_phase")
    finally:
        pipeline._fixed_point = inner
    masks = {}
    for i, bucket in enumerate(batch.buckets):
        calls = seen.get(id(bucket), [])
        check(len(calls) == 2, f"bucket {bucket.shape}: {len(calls)} solves")
        masks[i] = calls[1]
    return masks


def _repair_seeds(torch, np, rt, ops, g) -> list:
    """The seeded fixed points of the first streaming deltas of phase 13
    (``STREAM`` on Laplace3D_100), caught at the wrapper: ``(t_init,
    nbrs_flat, kw)`` each (a delta whose region grows solves again)."""
    from repro_torch.serve import StreamSession

    inner = ops.resident_fixed_point_seeded
    seeds = []

    def spy(t, m, nbrs_flat, **kw):
        seeds.append((t.clone(), nbrs_flat, kw))
        return inner(t, m, nbrs_flat, **kw)

    sess = StreamSession(g.csr)
    v = g.num_vertices
    rng = np.random.default_rng(STREAM["seed"])
    ops.resident_fixed_point_seeded = spy
    try:
        for _ in range(REPAIR_SEEDS):
            adds = rng.integers(0, v, size=(STREAM["adds"], 2))
            adds = adds[adds[:, 0] != adds[:, 1]]
            rows, cols = sess._keys // v, sess._keys % v
            offd = np.flatnonzero(rows != cols)
            pick = rng.choice(offd, size=STREAM["removes"], replace=False)
            sess.apply_delta(adds, np.stack([rows[pick], cols[pick]],
                                            axis=1))
            check(sess.last_repair.mode == "repair", "stream: not a repair")
    finally:
        ops.resident_fixed_point_seeded = inner
    check(len(seeds) >= REPAIR_SEEDS, f"{len(seeds)} repair solves")
    return seeds


def _batched_misk_one_dispatch(torch, np, rt, ops, ref, misk_ops, misk_ref,
                               luby_ops, luby_ref, graphs, batch_a, batch_b,
                               launches, errs) -> dict:
    """Phase 17: the misk, batched resident, seeded resident and batched
    Luby kernels against their twins, one launch a call and no host sync
    inside one; ``misk`` and the batched calls through the facade (one
    launch a solve or a bucket, ``host_syncs`` 0); each kernel timed beside
    its bound and its twin; the walls beside the times before."""
    out = {"misk_vs_twin": {}, "batched_vs_twin": {}, "seeded_vs_twin": {},
           "luby_batched_vs_twin": {}}
    dev = graphs["Laplace3D_100"].device
    fleets = {"A": batch_a, "B": batch_b}
    # the path, counted: the facade calls and the streaming deltas, one
    # launch a solve or a bucket, no host sync
    launches.reset()
    anchors = {}
    l100 = graphs["Laplace3D_100"]
    seeds = _repair_seeds(torch, np, rt, ops, l100)
    for k_, want in MISK_L100.items():
        for engine in ("dense", "resident"):
            before = launches.read()
            with rt.obs.capture() as cap:
                r = rt.misk(l100, k=k_, engine=engine)
            got = {k: launches.read()[k] - before[k] for k in (MISK,)}
            check((r.size, r.iterations, r.digest) == want
                  and r.host_syncs == 0 and got == {MISK: 1}
                  and cap.value("mis2.host_syncs") == 0
                  and cap.value("mis2.resident_dispatches")
                  == (engine == "resident"),
                  f"misk k={k_} {engine}: {r.digest} syncs {r.host_syncs} "
                  f"launches {got}")
            anchors[f"Laplace3D_100 misk k={k_} {engine}"] = [
                r.size, r.iterations, r.digest, r.host_syncs, got]
    for f, batch in fleets.items():
        nb = batch.num_buckets
        for name, call, key, per in (
                ("mis2", rt.mis2_batch, BATCHED, 1),
                ("color", rt.color_batch, LUBY_BATCHED, 1),
                ("coarsen_two_phase",
                 lambda b: rt.coarsen_batch(b, method="two_phase"), BATCHED,
                 2)):
            before = launches.read()
            res = call(batch)
            got = launches.read()[key] - before[key]
            syncs = res.provenance.metrics.get("mis2.host_syncs", 0)
            check(got == per * nb and syncs == 0,
                  f"fleet {f} {name}: {got} launches of {key} for {nb} "
                  f"buckets, {syncs} host syncs")
            if f == "A":
                anchor = fleet_anchor(res.digests, res.bucket_shapes)
                check(anchor == FLEET_A_ANCHORS[name],
                      f"fleet A {name}: anchor {anchor}")
            anchors[f"fleet {f} {name}"] = [res.digest, got, syncs]
    out["anchors"] = anchors
    out["launches"] = launches.read()
    # misk: the kernel against both engines' twins
    for label in PAPER_GRAPHS:
        nb = graphs[label].ell.neighbors
        for k in (1, 2, 3):
            for cap in (1, 2, MISK_UNCAPPED):
                kw = dict(k=k, priority="xorshift_star", max_iters=cap)
                got = _hold_one_dispatch(
                    torch, lambda kw=kw: misk_ops.misk_fixed_point(nb, **kw),
                    lambda kw=kw: misk_ref.misk_dense_fixed_point_ref(nb,
                                                                      **kw),
                    MISK, misk_ops.LAUNCHES, f"{label} misk k={k} cap {cap}",
                    errs)
                if cap == MISK_UNCAPPED:
                    want = misk_ref.misk_resident_fixed_point_ref(nb, **kw)
                    check(all(torch.equal(x, y) for x, y in zip(got, want)),
                          f"{label} misk k={k}: resident twin differs")
                rounds, live = got[1].tolist()
                out["misk_vs_twin"][f"{label} k={k} cap {cap}"] = {
                    "rounds": rounds, "live": live,
                    "size": int((got[0] == 0).sum()), "bitwise": True}
    # the batched resident kernel on every bucket of both fleets
    masks = {f: _fleet_phase2_masks(rt, b) for f, b in fleets.items()}

    def batched(bucket, act, cap, twin=False, trace=None):
        n = bucket.size * bucket.rows
        fn = ref.resident_fixed_point_batched_ref if twin \
            else ops.resident_fixed_point_batched
        extra = {} if trace is None else {"trace": trace}
        return fn(torch.empty(n, dtype=torch.int32, device=dev),
                  torch.empty(n, dtype=torch.int32, device=dev), act,
                  bucket.flat_neighbors32.view(-1), priority="xorshift_star",
                  bits=bucket.id_bits, rows=bucket.rows, max_iters=cap,
                  **extra)

    for f, batch in fleets.items():
        for i, bucket in enumerate(batch.buckets):
            valid = bucket.row_valid.view(-1)
            for case, act, cap in (("1 round", valid, 1),
                                   ("2 rounds", valid, 2),
                                   ("all", valid, 128),
                                   ("phase-2 mask", masks[f][i], 128)):
                got = _hold_one_dispatch(
                    torch, lambda a=act, c=cap: batched(bucket, a, c),
                    lambda a=act, c=cap: batched(bucket, a, c, twin=True),
                    BATCHED, ops.LAUNCHES,
                    f"fleet {f} bucket {bucket.shape} ({case})", errs)
                out["batched_vs_twin"][
                    f"fleet {f} {bucket.size} x {bucket.shape} {case}"] = {
                    "rows_active": int(act.sum()),
                    "rounds": got[1].tolist()[0],
                    "member_rounds": sorted(set(got[2].tolist())),
                    "bitwise": True}
    # the seeded resident kernel on the repair seeds of phase 13's stream
    for j, (t_init, nbrs_flat, kw) in enumerate(seeds):
        got = _hold_one_dispatch(
            torch, lambda t=t_init, kw=kw: ops.resident_fixed_point_seeded(
                t.clone(), torch.empty_like(t), nbrs_flat, **kw),
            lambda t=t_init, kw=kw: ref.resident_fixed_point_seeded_ref(
                t.clone(), torch.empty_like(t), nbrs_flat, **kw),
            SEEDED, ops.LAUNCHES, f"Laplace3D_100 repair {j}", errs)
        out["seeded_vs_twin"][f"Laplace3D_100 repair solve {j}"] = {
            "rows_reseeded": int(((t_init != 0) & (t_init != -1)).sum()),
            "rounds": got[1].tolist()[0], "bitwise": True}
    # the batched Luby kernel on every bucket of both fleets
    def luby_args(bucket):
        n = bucket.size * bucket.rows
        return (bucket.flat_neighbors32, bucket.mask.view(n, bucket.width),
                bucket.row_valid.view(-1), bucket.id_bits, bucket.rows)

    for f, batch in fleets.items():
        for bucket in batch.buckets:
            args = luby_args(bucket)
            luby_ops.luby_fixed_point_batched(*args, max_rounds=1)  # table
            for cap in (1, 2, 256):
                got = _hold_one_dispatch(
                    torch, lambda c=cap: luby_ops.luby_fixed_point_batched(
                        *args, max_rounds=c),
                    lambda c=cap: luby_ref.luby_fixed_point_batched_ref(
                        *args, max_rounds=c),
                    LUBY_BATCHED, luby_ops.LAUNCHES,
                    f"fleet {f} bucket {bucket.shape} (max_rounds {cap})",
                    errs)
                out["luby_batched_vs_twin"][
                    f"fleet {f} {bucket.size} x {bucket.shape} cap {cap}"] = {
                    "rounds": int(got[2].item()),
                    "done": int((got[1] >= 0).sum()), "bitwise": True}
    # each kernel beside its bound and its twin
    timing = {MISK: {}}
    for label in PAPER_GRAPHS:
        nb = graphs[label].ell.neighbors
        v, d = nb.shape
        for k in (2,):
            kw = dict(k=k, priority="xorshift_star", max_iters=MISK_UNCAPPED)
            trace = []
            _, stats = misk_ref.misk_dense_fixed_point_ref(nb, trace=trace,
                                                           **kw)
            live = stats.tolist()[1]
            timing[MISK][f"{label} k={k}"] = {**_timed(
                torch, lambda kw=kw: misk_ops.misk_fixed_point(nb, **kw),
                lambda kw=kw: misk_ref.misk_dense_fixed_point_ref(nb, **kw),
                None, _misk_bytes(v, d, k, trace, live), hashes=sum(trace),
                reps=20, plain_reps=3), "rounds": len(trace),
                "undecided": trace}
    bucket = max(batch_b.buckets, key=lambda b: b.size * b.rows * b.width)
    valid = bucket.row_valid.view(-1)
    trace = []
    batched(bucket, valid, 128, twin=True, trace=trace)
    nbytes, hashes = _resident_bytes(bucket.size * bucket.rows, bucket.width,
                                     trace)
    timing[BATCHED] = {**_design_bound(_timed(
        torch, lambda: batched(bucket, valid, 128),
        lambda: batched(bucket, valid, 128, twin=True), None, nbytes,
        hashes=hashes, reps=20, plain_reps=3), *_resident_bytes_design(
            bucket.size * bucket.rows, bucket.width, trace)),
        "shape": f"{bucket.size} x {bucket.rows} x {bucket.width}",
        "rounds": len(trace)}
    t_init, nbrs_flat, kw = seeds[0]
    trace = []
    ref.resident_fixed_point_seeded_ref(t_init.clone(), torch.empty_like(
        t_init), nbrs_flat, trace=trace, **kw)
    nbytes, hashes = _resident_bytes(l100.num_vertices, l100.ell.width,
                                     trace)
    timing[SEEDED] = {**_design_bound(_timed(
        torch, lambda: ops.resident_fixed_point_seeded(
            t_init.clone(), torch.empty_like(t_init), nbrs_flat, **kw),
        lambda: ref.resident_fixed_point_seeded_ref(
            t_init.clone(), torch.empty_like(t_init), nbrs_flat, **kw),
        None, nbytes, hashes=hashes, reps=20, plain_reps=3),
        *_resident_bytes_design(l100.num_vertices, l100.ell.width, trace)),
        "rounds": len(trace), "undecided_first": trace[0][1] if trace else 0}
    args = luby_args(bucket)
    trace = []
    luby_ref.luby_fixed_point_batched_ref(*args, max_rounds=256, trace=trace)
    nbytes, hashes = _luby_bytes(
        [(None, bucket.width)],
        (torch.empty(0, dtype=torch.int32, device=dev),) * 3, trace)
    timing[LUBY_BATCHED] = {**_timed(
        torch, lambda: luby_ops.luby_fixed_point_batched(*args,
                                                         max_rounds=256),
        lambda: luby_ref.luby_fixed_point_batched_ref(*args, max_rounds=256),
        None, nbytes, hashes=hashes, reps=20, plain_reps=3),
        "shape": f"{bucket.size} x {bucket.rows} x {bucket.width}",
        "rounds": len(trace)}
    del trace
    out["timing"] = timing
    e60 = graphs["Elasticity3D_60"]
    out["wall_ms"] = {
        what: {"now": _wall_ms(torch, call, reps=5),
               "before": WALL_BEFORE_BATCHED_MS.get(what)}
        for what, call in (
            ("Laplace3D_100 misk2", lambda: rt.misk(l100, k=2)),
            ("Elasticity3D_60 misk2", lambda: rt.misk(e60, k=2)),
            *((f"fleet {f} {name}", lambda b=b, c=c: c(b))
              for f, b in fleets.items()
              for name, c in (("mis2_batch", rt.mis2_batch),
                              ("coarsen_batch", rt.coarsen_batch),
                              ("color_batch", rt.color_batch))))}
    return out


# wall ms of five warm calls and device events of one traced call on the
# tree before the batched coarsening's phase-1/2 joins ran on the join
# kernels (PERF.md section 5: tools/profile_torch.py, that tree and this one
# in one call; NVIDIA H100 80GB HBM3, 700 W)
WALL_BEFORE_BATCH_JOINS_MS = {
    "fleet A coarsen_batch": [22.28, 22.95, 24.01, 24.14, 24.41],
    "fleet A coarsen_batch(basic)": [8.09, 8.43, 10.30, 10.61, 12.10],
    "fleet B coarsen_batch": [53.40, 54.63, 58.36, 60.06, 62.78],
    "fleet B coarsen_batch(basic)": [23.84, 24.02, 24.57, 24.84, 25.61],
}
EVENTS_BEFORE_BATCH_JOINS = {"Fleet_A coarsen_batch": 862,
                             "Fleet_A coarsen_batch_basic": 326,
                             "Fleet_B coarsen_batch": 170,
                             "Fleet_B coarsen_batch_basic": 64}
# the join and batched MIS-2 launches a bucket of each coarsen_batch method
BUCKET_LAUNCHES = {
    "two_phase": {BATCHED: 2, "root_join": 1, "phase2_join": 1,
                  "phase3_fixed_point": 1},
    "basic": {BATCHED: 1, "root_join": 1, "phase2_join": 0,
              "phase3_fixed_point": 0},
}
# the port's examples at the reference examples' default sizes: name -> argv
EXAMPLES = {"quickstart": ["32"], "amg_solve": ["--n", "32"],
            "cluster_gs_precond": ["--n", "16"],
            "partition_demo": ["--n", "24"]}


def _run_example(name: str, argv: list) -> dict:
    """``examples/torch/<name>.py``'s ``main(argv)`` (its own asserts
    inside), on the card: its returned record."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def _profile_batch_coarsening() -> dict:
    """``tools/profile_torch.py`` on both fleets' ``coarsen_batch`` (both
    methods) in a child process, whose profiler is its first (see
    :func:`_profile_in_child`): one record a call."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "profile_torch.py"),
         "--graphs", "Fleet_A", "Fleet_B", "--calls", "coarsen_batch",
         "coarsen_batch_basic"], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    check(proc.returncode == 0, f"profile_torch.py failed: "
          f"{proc.stderr[-2000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        rec = json.loads(line)
        if "call" in rec:
            out[f"{rec['graph']} {rec['call']}"] = {
                k: rec[k] for k in ("wall_ms", "device_ms", "device_events",
                                    "idle_share", "peak_memory_bytes",
                                    "kernels")}
    check(len(out) == 4, f"profile_torch.py gave {sorted(out)}")
    return out


def _batched_joins_surface(torch, np, rt, join_ops, join_ref, graphs, pl,
                           batch_a, batch_b, launches, errs) -> dict:
    """Phase 18: the batched coarsening through the facade (fleet A's
    anchors, every fleet B member against its single-graph ``coarsen``,
    fleet A's ``amg_setup_batch`` anchor, the launches a bucket), its joins
    against their twins on the label states of both fleets' buckets, the
    reference's engine names and the default backend on the anchors, the
    four port examples, and the batched coarsening's walls and device
    events beside the times before."""
    dev = pl.device
    fleets = {"A": batch_a, "B": batch_b}
    out = {"anchors": {}, "vs_twin": {}, "examples": {}}
    l100 = graphs["Laplace3D_100"]
    # the path, counted: the batched coarsening, the surface, the examples
    launches.reset()
    for f, batch in fleets.items():
        nb = batch.num_buckets
        for method, per in BUCKET_LAUNCHES.items():
            before = launches.read()
            res = rt.coarsen_batch(batch, method=method)
            after = launches.read()
            got = {k: after[k] - before[k] for k in per}
            check(got == {k: n * nb for k, n in per.items()},
                  f"fleet {f} coarsen_batch({method}): launches {got} for "
                  f"{nb} buckets")
            check(res.converged and res.engine == f"{method}_batched",
                  f"fleet {f} coarsen_batch({method}): {res.engine}, "
                  f"converged {res.converged}")
            rec = [res.digest, got]
            if f == "A":
                anchor = fleet_anchor(res.digests, res.bucket_shapes)
                check(anchor == FLEET_A_ANCHORS[f"coarsen_{method}"],
                      f"fleet A coarsen_batch({method}): anchor {anchor}")
                rec.append(anchor)
            else:
                for i, (g, r) in enumerate(zip(batch.graphs, res)):
                    s1 = rt.coarsen(g, method=method)
                    check(_coarsen_key(r) == _coarsen_key(s1)
                          and np.array_equal(r.roots, s1.roots)
                          and np.array_equal(r.phase, s1.phase),
                          f"fleet B coarsen_batch({method}) member {i}: "
                          f"{_coarsen_key(r)} != single {_coarsen_key(s1)}")
                rec.append(f"{len(res)} members equal their coarsen")
            out["anchors"][f"fleet {f} coarsen_batch({method})"] = rec
    _, mats_a = fleet_a(rt, dev)
    br = rt.amg_setup_batch(mats_a)
    k = FLEET_A_AMG_MEMBERS
    anchor = fleet_anchor([r.level_digests for r in br.results[:k]],
                          rt.GraphBatch(mats_a[:k]).bucket_shapes)
    check(anchor == FLEET_A_ANCHORS["amg_setup"],
          f"fleet A amg_setup_batch: anchor {anchor}")
    out["anchors"]["fleet A amg_setup_batch"] = [br.digest, anchor]
    del mats_a, br
    # the reference's engine names, and the default backend
    surface = {}
    for label, g, engine, want in (
            ("Laplace3D_100", l100, "pallas_resident",
             ANCHORS["Laplace3D_100"]["mis2"]),
            ("Powerlaw_1M", pl, "pallas_hybrid", POWERLAW_1M["mis2"])):
        r = rt.mis2(g, engine=engine)
        canonical = rt.api.get_engine_spec("mis2", engine).name
        check((r.size, r.iterations, r.digest) == want
              and r.engine == canonical == r.provenance.engine,
              f"{label} mis2(engine={engine!r}): {r.digest} {r.engine}")
        surface[f"{label} mis2 {engine}"] = [r.size, r.iterations, r.digest,
                                             r.provenance.engine]
    a = rt.coarsen(l100, method="mis2_agg")
    check((a.num_aggregates, a.iterations, a.digest)
          == ANCHORS["Laplace3D_100"]["coarsen"]
          and a.provenance.engine == "two_phase",
          f"Laplace3D_100 coarsen(method='mis2_agg'): {a.digest}")
    surface["Laplace3D_100 coarsen mis2_agg"] = [
        a.num_aggregates, a.iterations, a.digest, a.provenance.engine]
    default = rt.api.get_default_backend()
    with rt.api.using_backend(rt.Backend()):
        r = rt.mis2(l100)
        placed = rt.Graph(rt.graphs.laplace3d(8)).device.type
    check(rt.api.get_default_backend() is default
          and (r.size, r.iterations, r.digest)
          == ANCHORS["Laplace3D_100"]["mis2"] and placed == "cuda"
          and r.provenance.backend == "gpu",
          f"using_backend(Backend()): {r.digest} on {placed}")
    surface["using_backend(Backend()) Laplace3D_100 mis2"] = [
        r.size, r.iterations, r.digest, placed]
    out["surface"] = surface
    for name, argv in EXAMPLES.items():
        t0 = time.perf_counter()
        rec = _run_example(name, argv)
        check(rec["provenance"]["platform"] == "gpu",
              f"example {name}: provenance {rec['provenance']}")
        rec["seconds"] = time.perf_counter() - t0
        emit({"phase": "example", "argv": argv, **rec})
        out["examples"][name] = rec["seconds"]
    out["launches"] = launches.read()
    # the joins against their twins on every bucket's label states
    for f, batch in fleets.items():
        for method in BUCKET_LAUNCHES:
            calls = _caught_joins(join_ops, lambda b=batch, m=method:
                                  rt.coarsen_batch(b, method=m))
            per = sum(n > 0 for k, n in BUCKET_LAUNCHES[method].items()
                      if k in JOIN_OF)
            check(len(calls) == per * batch.num_buckets,
                  f"fleet {f} {method}: {len(calls)} join calls")
            for i, (name, args, kw) in enumerate(calls):
                bucket = batch.buckets[i // per]
                what = f"fleet {f} {method} bucket {i // per} {name}"
                got = _hold_join(torch, join_ops, join_ref, name, args, kw,
                                 what, errs)
                out["vs_twin"][what] = {
                    "shape": [bucket.size, bucket.rows, bucket.width],
                    "padded_rows": int(bucket.size * bucket.rows
                                       - bucket.num_vertices.sum()),
                    "kw": kw, "unlabeled_after": int((got[0] < 0).sum()),
                    "bitwise": True}
    # walls (five warm calls) and, in a child process, device events
    out["wall_ms"] = {}
    for f, batch in fleets.items():
        for method in BUCKET_LAUNCHES:
            what = f"fleet {f} coarsen_batch" + (
                "" if method == "two_phase" else f"({method})")
            out["wall_ms"][what] = {
                "now": _wall_ms(torch, lambda b=batch, m=method:
                                rt.coarsen_batch(b, method=m), reps=5),
                "before": WALL_BEFORE_BATCH_JOINS_MS.get(what)}
    profiled = _profile_batch_coarsening()
    out["device"] = {
        what: {**rec, "events_before": EVENTS_BEFORE_BATCH_JOINS.get(what)}
        for what, rec in profiled.items()}
    return out


def _time_unfused(torch, g, ops, ref, id_bits, reps: int = 50,
                  plain_reps: int = 5) -> dict:
    """The unfused kernels and their twins at the host-driven round 0:
    every row live in a pow2 bucket (dead slots gathering row V-1), T
    after the row refresh, M after the column refresh; each launch writes
    a new output, so nothing is restored.  ``ms_read_flush``: the kernel
    after a 256 MB read flush, not the write flush of ``ms``."""
    from repro_torch.core.hashing import PRIORITY_FNS
    from repro_torch.core.tuples import narrow, pack

    ell = g.ell
    v, d = ell.neighbors.shape
    dev = ell.neighbors.device
    w = 1 << (v - 1).bit_length()
    rows = torch.arange(w, device=dev).clamp(max=v - 1)
    wl_nbrs = ell.neighbors[rows].contiguous()
    vids = torch.arange(v, device=dev)
    t = narrow(pack(PRIORITY_FNS["xorshift_star"](0, vids), vids, id_bits(v)))
    m = ops.refresh_columns_rows(t, wl_nbrs, v)[:v].contiguous()
    t_rows = t[rows].contiguous()
    active = torch.ones(v, dtype=torch.bool, device=dev)
    n_distinct = int(torch.unique(ell.neighbors).numel())
    ids = 4 * v * d                  # the live rows' ids, read once
    # refresh: ids + T at distinct ids + [W] output written
    refresh_bytes = ids + 4 * n_distinct + 4 * w
    # decide: ids + t_rows + M and active at distinct ids + output written
    decide_bytes = ids + 4 * w + 5 * n_distinct + 4 * w
    cases = {
        "refresh_columns": (
            lambda: ops.refresh_columns_rows(t, wl_nbrs, v),
            lambda: ref.refresh_columns_ref(t, wl_nbrs, v), refresh_bytes),
        "decide": (
            lambda: ops.decide_rows(t_rows, m, active, wl_nbrs, v),
            lambda: ref.decide_ref(t_rows, m, active, wl_nbrs, v),
            decide_bytes),
    }
    return {k: {**_timed(torch, kernel, twin, None, nbytes, reps=reps,
                         plain_reps=plain_reps),
                "ms_read_flush": _event_ms(torch, kernel, reps, clean=True),
                "V": v, "D": d, "W": w, "count": v}
            for k, (kernel, twin, nbytes) in cases.items()}


def _compacted_path(torch, rt, graphs, launches) -> dict:
    """Phase 8: the host-driven engines against the ``mis2`` anchors, the
    no-worklist ablation, coarsening on ``cuda_compacted``, and the Fig. 2
    chain through ``engine=None``."""
    import numpy as np

    out = {}
    others = [k for k in KERNELS if k not in UNFUSED and k in launches.read()]
    for label, a in ANCHORS.items():
        g = graphs[label]
        res = {}
        for engine in ("compacted", "cuda_compacted"):
            before = launches.read()
            r = rt.mis2(g, engine=engine)
            after = launches.read()
            got = (r.size, r.iterations, r.digest)
            check(got == a["mis2"], f"{label}: {engine} {got} != {a['mis2']}")
            check(r.converged, f"{label}: {engine} did not converge")
            check(r.host_syncs == 2 * r.iterations,
                  f"{label}: {engine} {r.host_syncs} host syncs in "
                  f"{r.iterations} rounds")
            want = r.iterations if engine == "cuda_compacted" else 0
            for k in UNFUSED:
                check(after[k] - before[k] == want,
                      f"{label}: {engine} launched {k} "
                      f"{after[k] - before[k]} times in {r.iterations} rounds")
            check(all(after[k] == before[k] for k in others),
                  f"{label}: {engine} launched another kernel")
            res[engine] = {"size": r.size, "iterations": r.iterations,
                           "digest": r.digest, "host_syncs": r.host_syncs,
                           "num_compiles": r.num_compiles,
                           "first_call_s": r.wall_time_s}
        nc = {e: res[e]["num_compiles"] for e in res}
        check(nc["compacted"] == nc["cuda_compacted"],
              f"{label}: num_compiles {nc}")
        if label == "laplace3d(8)":
            check(nc["compacted"] == COMPACTED_L8_COMPILES,
                  f"laplace3d(8): num_compiles {nc['compacted']} != "
                  f"{COMPACTED_L8_COMPILES}")
        out[label] = res
    l100 = graphs["Laplace3D_100"]
    before = launches.read()
    r = rt.mis2(l100, engine="cuda_compacted",
                options=rt.Mis2Options(worklists=False))
    after = launches.read()
    got = (r.size, r.iterations, r.digest)
    check(got == ANCHORS["Laplace3D_100"]["mis2"] and r.num_compiles == 1,
          f"Laplace3D_100: cuda_compacted without worklists {got} "
          f"({r.num_compiles} compiles)")
    check(all(after[k] - before[k] == r.iterations for k in UNFUSED),
          "Laplace3D_100: cuda_compacted without worklists launches")
    out["Laplace3D_100"]["cuda_compacted_no_worklists"] = {
        "size": r.size, "iterations": r.iterations, "digest": r.digest,
        "num_compiles": r.num_compiles}
    before = launches.read()
    agg = rt.coarsen(l100, method="two_phase", mis2_engine="cuda_compacted")
    after = launches.read()
    got = (agg.num_aggregates, agg.iterations, agg.digest)
    check(got == ANCHORS["Laplace3D_100"]["coarsen"],
          f"Laplace3D_100: coarsen on cuda_compacted {got}")
    check(all(after[k] - before[k] == agg.iterations for k in UNFUSED),
          "Laplace3D_100: coarsen on cuda_compacted launches")
    out["Laplace3D_100"]["coarsen_cuda_compacted"] = {
        "aggregates": agg.num_aggregates, "mis2_iterations": agg.iterations,
        "digest": agg.digest, "first_call_s": agg.wall_time_s}
    r = rt.mis2(graphs["laplace3d(8)"],
                options=rt.ABLATION_CHAIN["baseline_bell"])
    check((r.size, r.iterations, r.digest) == FIXED_MIS2["laplace3d(8)"],
          f"laplace3d(8): baseline_bell {(r.size, r.iterations, r.digest)}")
    chain = {}
    for label in PAPER_GRAPHS:
        g = graphs[label]
        rows = {}
        for entry, opts in rt.ABLATION_CHAIN.items():
            r = rt.mis2(g, options=opts)
            want = FIXED_MIS2[label] if opts.priority == "fixed" \
                else ANCHORS[label]["mis2"]
            got = (r.size, r.iterations, r.digest)
            check(r.engine == CHAIN_ENGINES[entry],
                  f"{label} {entry}: engine {r.engine}")
            check(got == want and r.converged,
                  f"{label} {entry}: {got} != {want}")
            walls = _wall_ms(torch, lambda g=g, o=opts: rt.mis2(g, options=o))
            rows[entry] = {"engine": r.engine, "digest": r.digest,
                           "size": r.size, "iterations": r.iterations,
                           "host_syncs": r.host_syncs, "wall_ms": walls}
        base = float(np.median(rows["baseline_bell"]["wall_ms"]))
        for row in rows.values():
            row["speedup_vs_baseline_bell"] = base / float(
                np.median(row["wall_ms"]))
        chain[label] = rows
    out["fig2_chain"] = chain
    return out


def _hybrid_path(torch, rt, pl, graphs, launches) -> dict:
    """Phase 7: the hybrid path on Powerlaw_1M against the reference's
    anchors, and ``cuda_hybrid`` on the two paper graphs."""
    want = POWERLAW_1M
    try:
        _ = pl.ell
        raise SmokeFailure("Powerlaw_1M: Graph.ell did not raise")
    except rt.graphs.LayoutOverflowError as e:
        check("cuda_hybrid" in str(e), f"overflow message: {e}")
    check("csr_to_ell" not in pl.conversions, "Powerlaw_1M built an ELL")
    out = {}

    def one_launch_a_solve(cap, before, after, what):
        got = after[HYBRID] - before[HYBRID]
        solves = cap.value("mis2.resident_dispatches")
        check(got == solves >= 1 and cap.value("mis2.host_syncs") == 0,
              f"{what}: {HYBRID} launched {got} times in {solves} solves, "
              f"{cap.value('mis2.host_syncs')} host syncs")

    before = launches.read()
    with rt.obs.capture() as cap:
        r = rt.mis2(pl)
    after = launches.read()
    check(r.engine == "cuda_hybrid", f"Powerlaw_1M: engine {r.engine}")
    check((r.size, r.iterations, r.digest) == want["mis2"],
          f"Powerlaw_1M: mis2 {(r.size, r.iterations, r.digest)} != "
          f"{want['mis2']}")
    check(r.converged, "Powerlaw_1M: mis2 did not converge")
    col = r.collectives
    for k in ("slice_rows_processed", "spill_passes", "row_bytes_total",
              "spill_entries"):
        check(col[k] == want[k], f"Powerlaw_1M: {k} {col[k]} != {want[k]}")
    one_launch_a_solve(cap, before, after, "Powerlaw_1M mis2")
    check(after["fused_decide"] == before["fused_decide"],
          "Powerlaw_1M mis2 launched a fused kernel")
    out["mis2"] = {"engine": r.engine, "size": r.size,
                   "iterations": r.iterations, "digest": r.digest,
                   "host_syncs": r.host_syncs, "collectives": col,
                   "first_call_s": r.wall_time_s,
                   "launches": {k: after[k] - before[k] for k in after}}
    for method in ("two_phase", "basic"):
        before = launches.read()
        with rt.obs.capture() as cap:
            a = rt.coarsen(pl, method=method)
        after = launches.read()
        got = (a.num_aggregates, a.iterations, a.digest)
        check(a.engine == "cuda_hybrid", f"Powerlaw_1M coarsen: {a.engine}")
        check(got == want[method],
              f"Powerlaw_1M: coarsen({method}) {got} != {want[method]}")
        one_launch_a_solve(cap, before, after, f"Powerlaw_1M coarsen({method})")
        out[f"coarsen_{method}"] = {
            "aggregates": a.num_aggregates, "mis2_iterations": a.iterations,
            "digest": a.digest, "first_call_s": a.wall_time_s}
    before = launches.read()
    c = rt.color(pl, engine="luby_hybrid")
    after = launches.read()
    got = (c.num_colors, c.rounds, c.digest)
    check(got == want["color"], f"Powerlaw_1M: color {got} != {want['color']}")
    check(after[LUBY] - before[LUBY] == 1 and c.host_syncs == 0,
          f"Powerlaw_1M color: {after[LUBY] - before[LUBY]} launches of "
          f"{LUBY}, {c.host_syncs} host syncs (one and none expected)")
    out["color"] = {"colors": c.num_colors, "rounds": c.rounds,
                    "digest": c.digest, "host_syncs": c.host_syncs,
                    "first_call_s": c.wall_time_s}
    check("csr_to_ell" not in pl.conversions, "Powerlaw_1M built an ELL")
    for label in PAPER_GRAPHS:
        g = graphs[label]
        before = launches.read()
        with rt.obs.capture() as cap:
            rh = rt.mis2(g, engine="cuda_hybrid")
        after = launches.read()
        got = (rh.size, rh.iterations, rh.digest)
        check(got == ANCHORS[label]["mis2"],
              f"{label}: cuda_hybrid {got} != {ANCHORS[label]['mis2']}")
        one_launch_a_solve(cap, before, after, f"{label} cuda_hybrid")
        out[f"cuda_hybrid_{label}"] = {
            "size": rh.size, "iterations": rh.iterations,
            "digest": rh.digest, "slice_widths": list(
                g.hybrid().slice_widths), "first_call_s": rh.wall_time_s}
    return out


def _time_sliced(torch, hyb, ops, ref, id_bits, reps: int = 50,
                 plain_reps: int = 5) -> dict:
    """Each sliced kernel and its twin on every slab at the hybrid loop's
    round-0 state: every row live, every tuple undecided, M of the whole
    graph refreshed before the decide, the decide without a mask as
    ``mis2`` calls it; the state each writes restored before each
    launch."""
    v = hyb.num_vertices
    dev = hyb.spill_rows.device
    b = id_bits(v)
    kw = dict(priority="xorshift_star", b=b)
    t0 = torch.ones(v, dtype=torch.int32, device=dev)
    m0 = torch.full((v,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(v, dtype=torch.bool, device=dev)
    it = torch.zeros(1, dtype=torch.int32, device=dev)
    m_ready = m0.clone()
    for sl in hyb.slices:        # round 0's refresh of every row
        r = sl.num_rows
        ops.sliced_refresh_columns(
            t0, m_ready, sl.rows, sl.neighbors.reshape(-1),
            torch.arange(r, dtype=torch.int32, device=dev),
            torch.full((1,), r, dtype=torch.int32, device=dev), it, **kw)
    ref.spill_refresh_columns(t0, m_ready, hyb.spill_rows, hyb.spill_seg,
                              hyb.spill_cols, active, it, **kw)
    out = {}
    for sl in hyb.slices:
        if sl.width not in TIMED_SLABS:
            continue
        r, w = sl.num_rows, sl.width
        nbrs_flat = sl.neighbors.reshape(-1)
        wl = torch.arange(r, dtype=torch.int32, device=dev)
        cnt = torch.full((1,), r, dtype=torch.int32, device=dev)
        slab = (sl.rows, nbrs_flat, wl, cnt, it)
        m, t = m0.clone(), t0.clone()
        n_distinct = int(torch.unique(nbrs_flat).numel())
        # refresh: wl + slab rows + ids + T at distinct ids + M written
        refresh_bytes = 4 * r + 4 * r + 4 * r * w + 4 * n_distinct + 4 * r + 8
        # decide without a mask: wl + slab rows + ids + own T + M at
        # distinct ids + T written
        decide_bytes = (4 * r + 4 * r + 4 * r * w + 4 * r + 4 * n_distinct
                        + 4 * r + 8)
        # hashes, one per undecided vertex: every distinct id (refresh),
        # every live row (decide)
        cases = {
            "sliced_refresh_columns": (
                lambda: ops.sliced_refresh_columns(t0, m, *slab, **kw),
                lambda: ref.sliced_refresh_columns_ref(t0, m, *slab, **kw),
                lambda: m.copy_(m0), refresh_bytes, n_distinct),
            "sliced_decide": (
                lambda: ops.sliced_decide(t, m_ready, None, *slab, **kw),
                lambda: ref.sliced_decide_ref(t, m_ready, None, *slab, **kw),
                lambda: t.copy_(t0), decide_bytes, r),
        }
        out[w] = {}
        for k, (kernel, twin, restore, nbytes, hashes) in cases.items():
            out[w][k] = {**_timed(torch, kernel, twin, None, nbytes,
                                  hashes=hashes, restore=restore, reps=reps,
                                  plain_reps=plain_reps),
                         "R": r, "W": w, "distinct_ids": n_distinct}
    return out


# ---------------------------------------------------------------------------
# 12. the distributed engines: spawned gloo ranks, each on the one card
# ---------------------------------------------------------------------------

#: the world of ranks phase 12 spawns, and the groups made inside it:
#: (backend, ranks) -> the graphs run there.  NCCL refuses two ranks on one
#: card, so the multi-rank groups are gloo; the one-rank group is NCCL
DIST_WORLD = 4
DIST_GROUPS = {("gloo", 4): PAPER_GRAPHS, ("gloo", 3): ("Laplace3D_100",),
               ("nccl", 1): ("Laplace3D_100",)}
DIST_CALLS = ("mis2 distributed", "mis2 distributed_single_gather",
              "coarsen two_phase_distributed",
              "coarsen two_phase mis2_engine=distributed")


def _dist_call(rt, name: str, g, be):
    kind, rest = name.split(" ", 1)
    if kind == "mis2":
        return rt.mis2(g, engine=rest, backend=be)
    if rest == "two_phase_distributed":
        return rt.coarsen(g, method="two_phase_distributed", backend=be)
    return rt.coarsen(g, method="two_phase", mis2_engine="distributed",
                      backend=be)


def _dist_rank(rank: int, tmp: str, device: str) -> None:
    """One spawned rank of phase 12: every group it belongs to, every
    call on every graph of the group (each run twice), one JSON record a
    call."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.core import dist as core_dist
    from repro_torch.graphs.csr import CSRGraph
    from repro_torch.kernels import _build
    from repro_torch.kernels.minprop_ell import ops

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=DIST_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    groups = {}
    for backend, p in DIST_GROUPS:
        if backend == "nccl" and not cuda:
            continue
        groups[(backend, p)] = dist.group.WORLD if p == DIST_WORLD else \
            dist.new_group(list(range(p)), backend=backend)
    graphs = {}
    for label in PAPER_GRAPHS:
        arrays = np.load(f"{tmp}/{label}.npz")
        graphs[label] = rt.Graph(CSRGraph(arrays["indptr"],
                                          arrays["indices"]), device=dev)
    records = []
    for (backend, p), group in groups.items():
        if rank >= p:
            continue
        be = rt.Backend(device=dev, group=group)
        for label in DIST_GROUPS[(backend, p)]:
            g = graphs[label]
            for name in DIST_CALLS:
                # twice: the first call in a process pays the first launch
                # of each kernel instance; the record is the second's
                walls, digests = [], []
                for _ in range(2):
                    dist.barrier(group=group)
                    ops.reset_launches()
                    core_dist.reset_collective_bytes()
                    with rt.obs.capture() as cap:
                        if cuda:
                            torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        r = _dist_call(rt, name, g, be)
                        if cuda:
                            torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                    digests.append(r.digest)
                rec = {"group": f"{backend} P={p}", "rank": rank,
                       "graph": label, "call": name, "wall_ms": walls[1],
                       "first_call_wall_ms": walls[0],
                       "digest": r.digest if digests[0] == digests[1]
                       else f"first call {digests[0]}",
                       "iterations": r.iterations,
                       "launches": dict(ops.LAUNCHES),
                       "collective_bytes": dict(core_dist.COLLECTIVE_BYTES),
                       "provenance": [r.provenance.backend,
                                      r.provenance.digest]}
                if name.startswith("mis2"):
                    variant = "single_gather" if name.endswith("gather") \
                        else "two_gather"
                    rec.update(size=r.size, collectives=r.collectives,
                               host_syncs=r.host_syncs,
                               registry_bytes=cap.value(
                                   "dist.collective_bytes",
                                   {"variant": variant}))
                else:
                    rec["size"] = r.num_aggregates
                records.append(rec)
    with open(f"{tmp}/rank{rank}.json", "w") as fh:
        json.dump({"records": records, "nvcc_runs": _build.NVCC_RUNS["count"]},
                  fh)
    dist.barrier()
    dist.destroy_process_group()


def _distributed_path(torch, np, rt, graphs, device: str = "cuda") -> dict:
    """Phase 12: spawn ``DIST_WORLD`` ranks (the kernels are built; each rank
    loads them), hold every rank's every call to the anchors, the counted
    T/M gather bytes to the model and the registry, the launches to one of
    each sliced kernel a rank a round (single-gather: one whole-graph
    refresh a round); beside them, the single-device ``engine=None``
    call's wall time.  Each call runs twice in a row; the launches, bytes
    and wall time are the second's, the first's wall time is reported
    apart (it pays each kernel instance's first launch in the process).  Returns the record with the ranks' summed launches
    under ``launches``."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core.dist import collective_bytes_per_iteration

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for label in PAPER_GRAPHS:
            csr = graphs[label].csr
            np.savez(f"{tmp}/{label}.npz", indptr=np.asarray(csr.indptr),
                     indices=np.asarray(csr.indices))
        t0 = time.perf_counter()
        mp.spawn(_dist_rank, args=(tmp, device), nprocs=DIST_WORLD,
                 join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_WORLD):
            with open(f"{tmp}/rank{r}.json") as fh:
                ranks.append(json.load(fh))
    launches = {}
    walls: dict = {}
    first_walls: dict = {}
    checked = 0
    for rk in ranks:
        check(rk["nvcc_runs"] == 0, "a rank built a kernel library")
        for rec in rk["records"]:
            a = ANCHORS[rec["graph"]]
            where = f"{rec['group']} rank {rec['rank']} {rec['graph']} " \
                    f"{rec['call']}"
            want = a["mis2"] if rec["call"].startswith("mis2") \
                else a["coarsen"]
            got = (rec["size"], rec["iterations"], rec["digest"])
            check(got == want, f"{where}: {got} != {want}")
            check(rec["provenance"] == ["gpu" if device == "cuda" else "cpu",
                                        rec["digest"]],
                  f"{where}: provenance {rec['provenance']}")
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
            it = rec["iterations"]
            lc = rec["launches"]
            if rec["call"].startswith("mis2"):
                single = rec["call"].endswith("single_gather")
                p = int(rec["group"].split("P=")[1])
                model = collective_bytes_per_iteration(
                    graphs[rec["graph"]].num_vertices, p,
                    single)["result_bytes_per_iteration"] * it
                col = rec["collectives"]
                check(rec["collective_bytes"]["tuples"] == model ==
                      col["result_bytes_total"] == rec["registry_bytes"],
                      f"{where}: gathered {rec['collective_bytes']['tuples']}"
                      f" B, model {model}, registry {rec['registry_bytes']}")
                check(lc["sliced_decide"] == it
                      and lc["sliced_refresh_columns"] == (0 if single
                                                           else it)
                      and lc["fused_refresh_columns"] == (it if single
                                                          else 0),
                      f"{where}: launches {lc} over {it} rounds")
                check(rec["host_syncs"] == it + 1, f"{where}: host syncs")
            else:
                check(lc["sliced_decide"] > 0, f"{where}: no sliced decide")
            key = f"{rec['group']} {rec['graph']} {rec['call']}"
            walls.setdefault(key, []).append(rec["wall_ms"])
            first_walls.setdefault(key, []).append(rec["first_call_wall_ms"])
            checked += 1
    for key in {f"{b} P={p} {label}"
                for (b, p), labels in DIST_GROUPS.items()
                if b != "nccl" or device == "cuda" for label in labels}:
        b, pp, label = key.split(" ")
        n = sum(1 for rk in ranks for rec in rk["records"]
                if rec["group"] == f"{b} {pp}" and rec["graph"] == label)
        check(n == int(pp[2:]) * len(DIST_CALLS), f"{key}: {n} records")
    single_device = {}
    for label in PAPER_GRAPHS:
        g = graphs[label]
        single_device[label] = {
            "mis2 engine=None": _wall_ms(torch, lambda g=g: rt.mis2(g)),
            "coarsen engine=None": _wall_ms(torch, lambda g=g: rt.coarsen(g))}
    return {"launches": launches, "records_checked": checked,
            "collective_bytes_by_kind": {
                f"{rec['group']} {rec['graph']} {rec['call']}":
                    rec["collective_bytes"]
                for rec in ranks[0]["records"]},
            "wall_ms_per_rank": walls,
            "first_call_wall_ms_per_rank": first_walls,
            "single_device_wall_ms": single_device,
            "spawn_and_run_s": spawn_s,
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# 13. the serving layer
# ---------------------------------------------------------------------------

#: pool S: the reference's serve benchmark at full size
#: (benchmarks/serve_throughput.py:36-96, quick=False): the meshes and the
#: (V, degree) random graphs (seeds 0-4), 160 requests from default_rng(0)
SERVE_POOL_S = dict(meshes=(6, 8, 10),
                    uniforms=((500, 6.0), (1_200, 8.0), (2_000, 8.0),
                              (800, 16.0), (300, 5.0)), requests=160)
#: pool M: subdomains at fleet B's sizes, 128 requests of seeded kinds
SERVE_POOL_M = dict(laplace=(8, 32), random=(8, 20_000, 6.0, 100),
                    requests=128, seed=1)
#: the streaming deltas on Laplace3D_100 (fixed priority)
STREAM = dict(deltas=10, adds=100, removes=100, seed=23)


def _pool_s(rt, dev) -> list:
    want = SERVE_POOL_S
    pool = [rt.Graph(rt.graphs.laplace3d(n), device=dev)
            for n in want["meshes"]]
    pool += [rt.Graph(rt.graphs.random_uniform_graph(v, d, seed=i),
                      device=dev) for i, (v, d) in enumerate(want["uniforms"])]
    return pool


def _workload(np, pool, n: int, rng) -> list:
    """The reference's ``_workload`` with no resubmission: its stream, RNG
    draws included (a draw for the resubmit test once a graph is seen)."""
    stream = []
    for _ in range(n):
        if stream:
            rng.random()
        stream.append(pool[int(rng.integers(len(pool)))])
    return stream


def _own_provenance(r, platform: str) -> None:
    p = r.provenance
    check(p is not None and p.digest == r.digest and p.backend == platform,
          f"served {type(r).__name__}: provenance {p}")


def _serving_path(torch, np, rt, dev, graphs, pl, launches) -> dict:
    """Phase 13: pools S and M, the large requests, the streaming deltas,
    the persistent tier and the fault counts; every response held to its
    direct call or anchor and carrying its own provenance.  ``launches``
    (reset by the caller) ends with the served path's launches: those of
    the direct calls the responses are held to are moved to the record's
    ``direct_launches``."""
    import tempfile

    from repro_torch import serve
    from repro_torch.serve import (Fault, FaultPlan, LayoutInfeasible,
                                   RetryPolicy, Server, ServerConfig)

    platform = "gpu" if dev.type == "cuda" else "cpu"
    direct_launches: dict = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def direct_call(fn, *args, **kw):
        """A direct facade call (a referent), its launches kept apart."""
        before = launches.read()
        r = fn(*args, **kw)
        for k, n in launches.read().items():
            direct_launches[k] = direct_launches.get(k, 0) + n - before[k]
        return r

    out: dict = {}
    t_phase = time.perf_counter()
    # -- pool S: batched against serialized -----------------------------------
    pool = _pool_s(rt, dev)
    stream = _workload(np, pool, SERVE_POOL_S["requests"],
                       np.random.default_rng(0))
    for g in pool:                          # formats built outside the clock
        direct_call(rt.mis2, g, engine="dense")
    sync()
    t0 = time.perf_counter()
    serial = [direct_call(rt.mis2, g, engine="dense").digest
              for g in stream]
    sync()
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = Server(ServerConfig(max_batch=8,
                              warm_buckets=serve.warm_buckets_for(pool),
                              cache_bytes=0))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    futs = [srv.submit("mis2", g) for g in stream]
    srv.flush()
    results = [f.result() for f in futs]
    sync()
    batched_s = time.perf_counter() - t0
    for r, d in zip(results, serial):
        check(r.digest == d, f"pool S: served {r.digest} != direct {d}")
        _own_provenance(r, platform)
    st = srv.server_stats()
    check(st["compiles"]["runtime_cold"] == 0, f"pool S: {st['compiles']}")
    check(st["compiles"]["nvcc_since_warm"] == 0, "pool S: nvcc after warm")
    check(st["fallbacks"] == 0 and st["retries"] == 0, "pool S: fallbacks")
    out["pool_s"] = {
        "requests": len(stream), "graphs": len(pool),
        "warm_buckets": len(srv.config.warm_buckets), "warm_s": warm_s,
        "serialized_rps": len(stream) / serial_s,
        "batched_rps": len(stream) / batched_s,
        "batched_over_serialized": serial_s / batched_s,
        "dispatches": st["dispatches"], "dedup_hits": st["dedup_hits"],
        "batched_graphs": st["batched_graphs"]}

    # -- pool M: subdomain requests of seeded kinds ------------------------------
    lap_n, lap = SERVE_POOL_M["laplace"]
    rn, rv, rd, rseed = SERVE_POOL_M["random"]
    structs = [rt.Graph(rt.graphs.laplace3d(lap), device=dev)
               for _ in range(lap_n)]
    structs += [rt.Graph(rt.graphs.random_uniform_graph(rv, rd,
                                                        seed=rseed + i),
                         device=dev) for i in range(rn)]
    mats = structs[:lap_n] + [
        rt.Graph(rt.graphs.er_laplacian(rv, rd, seed=rseed + i), device=dev)
        for i in range(rn)]
    kinds = serve.KINDS
    rng = np.random.default_rng(SERVE_POOL_M["seed"])
    reqs = [(kinds[int(rng.integers(len(kinds)))],
             int(rng.integers(len(structs))))
            for _ in range(SERVE_POOL_M["requests"])]
    srv = Server(ServerConfig(max_batch=8,
                              warm_buckets=serve.warm_buckets_for(structs)))
    t0 = time.perf_counter()
    futs = [srv.submit(k, mats[i] if k == "amg_setup" else structs[i])
            for k, i in reqs]
    srv.flush()
    results = [f.result() for f in futs]
    sync()
    served_s = time.perf_counter() - t0
    direct_fn = {"mis2": rt.mis2, "color": rt.color, "coarsen": rt.coarsen,
                 "amg_setup": rt.amg_setup}
    direct: dict = {}
    for (k, i), r in zip(reqs, results):
        if (k, i) not in direct:
            direct[(k, i)] = direct_call(
                direct_fn[k], mats[i] if k == "amg_setup" else structs[i])
        want = direct[(k, i)]
        check(r.digest == want.digest, f"pool M {k}[{i}]: {r.digest} != "
                                       f"{want.digest}")
        if k == "amg_setup":
            check(r.level_digests == want.level_digests,
                  f"pool M amg_setup[{i}]: level digests")
        _own_provenance(r, platform)
    st = srv.server_stats()
    check(st["fallbacks"] == 0 and st["retries"] == 0, "pool M: fallbacks")
    check(st["compiles"]["nvcc_since_warm"] == 0, "pool M: nvcc after warm")
    out["pool_m"] = {"requests": len(reqs),
                     "by_kind": {k: sum(1 for kk, _ in reqs if kk == k)
                                 for k in kinds},
                     "served_s": served_s, "direct_calls": len(direct),
                     "dispatches": st["dispatches"],
                     "batched_graphs": st["batched_graphs"],
                     "cache_hits": st["cache"]["hits"],
                     "dedup_hits": st["dedup_hits"],
                     "runtime_cold": st["compiles"]["runtime_cold"]}

    # -- large requests, and one shed before it queues ----------------------------
    l100, e60 = graphs["Laplace3D_100"], graphs["Elasticity3D_60"]
    srv = Server(ServerConfig(max_batch=8))
    large = {"Laplace3D_100 mis2": srv.submit("mis2", l100),
             "Laplace3D_100 coarsen": srv.submit("coarsen", l100),
             "Laplace3D_100 amg_setup": srv.submit("amg_setup", l100),
             "Elasticity3D_60 mis2": srv.submit("mis2", e60),
             "Powerlaw_1M mis2": srv.submit("mis2", pl)}
    queued = len(srv.batcher)
    shed = srv.submit("mis2", pl, engine="cuda_resident")
    check(shed.done() and isinstance(shed.exception(), LayoutInfeasible),
          f"Powerlaw_1M cuda_resident not shed: {shed}")
    check(len(srv.batcher) == queued, "the shed request was queued")
    t0 = time.perf_counter()
    srv.flush()
    got = {k: f.result() for k, f in large.items()}
    sync()
    large_s = time.perf_counter() - t0
    for key, r in got.items():
        label, kind = key.split(" ")
        _own_provenance(r, platform)
        if kind == "amg_setup":
            check([tuple(x) for x in r.level_sizes] == AMG_L100["levels"]
                  and r.level_digests == AMG_L100["digests"],
                  f"{key}: {r.level_sizes} {r.level_digests}")
            continue
        if label == "Powerlaw_1M":
            want = POWERLAW_1M["mis2"]
            check(r.engine == "cuda_hybrid", f"{key} served on {r.engine}")
        else:
            want = ANCHORS[label][kind]
        size = r.size if kind == "mis2" else r.num_aggregates
        check((size, r.iterations, r.digest) == want,
              f"{key}: {(size, r.iterations, r.digest)} != {want}")
    st = srv.server_stats()
    check(st["fallbacks"] == 0, "large requests: fallbacks")
    out["large"] = {"wall_s": large_s,
                    "engines": {k: getattr(r, "engine", None)
                                for k, r in got.items()},
                    "shed": type(shed.exception()).__name__,
                    "single_dispatches": st["single_dispatches"]}

    # -- streaming deltas on Laplace3D_100 ---------------------------------------
    sess = srv.open_stream(l100)
    v = l100.num_vertices
    rng = np.random.default_rng(STREAM["seed"])
    fixed = rt.Mis2Options(priority="fixed")
    repair_ms, scratch_ms, regions = [], [], []
    for _ in range(STREAM["deltas"]):
        adds = rng.integers(0, v, size=(STREAM["adds"], 2))
        adds = adds[adds[:, 0] != adds[:, 1]]
        rows, cols = sess._keys // v, sess._keys % v
        offd = np.flatnonzero(rows != cols)
        pick = rng.choice(offd, size=STREAM["removes"], replace=False)
        removes = np.stack([rows[pick], cols[pick]], axis=1)
        sync()
        t0 = time.perf_counter()
        r = sess.apply_delta(adds, removes)
        sync()
        repair_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        scratch = direct_call(rt.mis2, sess.graph, options=fixed)
        sync()
        scratch_ms.append((time.perf_counter() - t0) * 1e3)
        check(r.digest == scratch.digest,
              f"stream: repaired {r.digest} != scratch {scratch.digest}")
        check(sess.last_repair.mode == "repair", "stream: not a repair")
        _own_provenance(r, platform)
        regions.append(sess.last_repair.reactivated)
    out["stream"] = {"deltas": STREAM["deltas"], "repair_ms": repair_ms,
                     "scratch_ms": scratch_ms, "reactivated": regions,
                     "scratch_engine": scratch.engine}

    # -- persistence and faults ---------------------------------------------------
    items = [(k, g) for k in ("mis2", "color", "coarsen") for g in pool[:3]]
    with tempfile.TemporaryDirectory() as d:
        plan = FaultPlan(seed=3, sites={
            "persist_corrupt": Fault("corrupt", count=1)})
        s1 = Server(ServerConfig(persist_dir=d, faults=plan))
        first = [s1.request(k, g) for k, g in items]
        check(s1.persist.stats.writes == len(items), "persist: writes")
        s1.stop()
        s2 = Server(ServerConfig(persist_dir=d))
        again = [s2.request(k, g) for k, g in items]
        ps = s2.persist.stats
        check([r.digest for r in again] == [r.digest for r in first],
              "persist: rehydrated digests")
        check((ps.hits, ps.corrupt, s2.stats.dispatches) ==
              (len(items) - 1, 1, 1),
              f"persist: hits {ps.hits}, corrupt {ps.corrupt}, "
              f"dispatches {s2.stats.dispatches}")
        out["persist"] = {"entries": len(items), **ps.as_dict(),
                          "dispatches_after_restart": s2.stats.dispatches}
    g = pool[3]
    ref = direct_call(rt.mis2, g)
    want = ref.digest
    plan = FaultPlan(seed=7, sites={
        "engine": Fault("error", count=2, transient=True)})
    s3 = Server(ServerConfig(faults=plan, cache_bytes=0, retry=RetryPolicy(
        max_attempts=3, base_backoff_s=0.0)))
    r3 = s3.request("mis2", g)
    plan2 = FaultPlan(seed=7, sites={
        "engine": Fault("error", count=1, transient=False)})
    s4 = Server(ServerConfig(faults=plan2, cache_bytes=0))
    r4 = s4.request("mis2", g)
    counts = {"transient": (s3.stats.retries, s3.stats.fallbacks,
                            dict(plan.fired)),
              "persistent": (s4.stats.retries, s4.stats.fallbacks,
                             dict(plan2.fired))}
    check(counts == {"transient": (2, 0, {"engine": 2}),
                     "persistent": (0, 1, {"engine": 1})},
          f"fault counts {counts}")
    check(r3.digest == want and r4.digest == want
          and r4.engine == ref.engine,
          "faults: a degraded answer differs or left the card's engine")
    out["faults"] = {k: {"retries": a, "fallbacks": b, "injected": c}
                     for k, (a, b, c) in counts.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    served = launches.read()
    out["launches"] = {k: n - direct_launches.get(k, 0)
                       for k, n in served.items()}
    out["direct_launches"] = direct_launches
    return out

if __name__ == "__main__":
    sys.exit(main())
