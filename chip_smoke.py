#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`wittgenstein_tpu_torch`) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. device and build: the card's name and power limit, then the CUDA
   kernels built from ``wittgenstein_tpu_torch/csrc`` with nvcc, with
   each kernel's registers and shared memory;
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the path that runs it (route at both paths' shapes):
   bit-equal outputs, and both timed with the profiler and CUDA events.
   A kernel's time (``ms``, ``kernel_us``) is cold: the L2 is flushed
   before each call, as the path leaves it; ``kernel_us_warm`` repeats
   the call on inputs the L2 still holds;
3. the Handel path: the reference-default Handel (2048 nodes, 204 down)
   through `Runner.run_ms` for 1000 ms, launch counters reset just
   before; it must converge (live frac_done > 0.99) with zero drops,
   clamps and evictions, and launch route, merge and score once per
   simulated ms;
3b. the GSF path: `GSFSignature(node_count=4096)` with its defaults,
   seed 0, for 600 ms, counters reset just before; live frac_done >
   0.99 with zero drops and clamps, and route, gsf_merge and gsf_score
   launched once per simulated ms;
4. against the reference: the Handel path's state at 200 ms matches the
   JAX package's golden digest, and a second run of seed 0 to 200 ms
   matches it;
4b. the GSF path's state at 600 ms matches the JAX golden digest, and a
   second run of seed 0 to 150 ms the path's state there;
5. the benchmark headline (`bench_torch.py`'s path): 16 seeds of the
   2048-node Handel in one batch on the seed-folded engine
   (`core/batched.scan_chunk_batched`, superstep K=2, phase hints,
   t0_mod=0), five 200-ms chunks, counters reset just before; every
   seed's state at 200 ms matches the JAX golden digests; mean live
   frac_done > 0.99 with zero drops, clamps and evictions, and route
   launched once a K=2 window (500), merge once a ms (1000), score on
   the verification ms (250), each launch for all 16 seeds;
5b. a second batched run to 200 ms matches the first seed by seed, and
   the first run's seed 0 at 1000 ms the dense path's state of phase 3;
6. PingPong on the per-ms engine: `PingPong(1000)`, seed 0, through
   `Runner.run_ms` in 8 steps of 100 ms, counters reset just before;
   the reference's curve (80 < pongs@100 < 400, 500 < pongs@300 <=
   1000, pongs@800 == 1000, monotone), zero drops, broadcast drops and
   clamps, and route launched once a simulated ms (800);
6b. the PingPong run matches the JAX golden digest at 800 ms, and a
   second run of seed 0 the first one at 400 ms;
6c. the harness: `run_multiple_times(PingPong(1000), 16, chunk=200)` on
   the seed batch at K=2, counters reset just before: every run stopped
   with 1000 pongs and zero drops and clamps, route launched once a
   window for all seeds; a 200-ms run of the same 16 seeds matches the
   JAX golden digests of `jax.vmap(scan_chunk(PingPong(1000), 200,
   superstep=2))`, and seed 0 at its stop time the per-ms run of 6b;
6d. the spill buffer: the JAX engine tests' probe (a unicast with delay
   500 past horizon 64) through `Runner.run_ms` with 8 spill slots
   delivers at exactly 511 with route launched twice a ms (the drain,
   then the sends); with 2 slots and 4 such sends, 2 are dropped and
   the 2 lowest senders' deliver (got [0, 1, 1, 0]); two seeds of the
   first through the harness at K = 1 deliver at 511 each;
7. GSF on a seed batch: `GSFSignature(node_count=4096)`, seeds 0-3 in
   one batch to 100 ms in one chunk (cut from 600, then 150, for
   time), (a) on the harness's engine at
   K=1 (`network.scan_chunk` on the batch, `tools/bench_suite.py`'s GSF
   line) and (b) on the seed-folded engine (`scan_chunk_batched`, K=2),
   counters reset just before each: every seed's state equals the JAX
   golden digests, zero drops and clamps, route once a window (100,
   50), gsf_merge and gsf_score once a ms (100) for all 4 seeds;
8. the fast-forward engine, each run beside the dense run of its path
   in this process: (a) the headline on `fast_forward_chunk_batched`
   (K=2, no phase hints) to 200 ms, every seed equal to its golden, the
   kernels launched once a stepped window (route) or stepped ms (merge,
   score); (b) `PingPong(1000)` through `Runner(fast_forward=True)` in
   100-ms calls to 800 ms and (c) 16 PingPong seeds through
   `fast_forward_chunk(seed_axis=True, superstep=2)` to 200 ms, each
   equal to its golden, with the JAX engine's skip counts, and (b)
   skipping something;
9. tier 3: cardinal Handel at 65,536 nodes (`tier3_params`), one seed on
   the seed-folded engine (K=2, phase hints) in 200-ms chunks,
   counters reset just before: equal to the JAX golden digests at 200
   and 1,000 ms, then on until live frac_done > 0.99 (by 2,000 ms),
   zero drops, clamps and evictions, route once a window and no K2 or
   K3;
10. tier 2: exact Handel at 32,768 nodes with hashed emission, no
   snapshot pool, two q_sig pieces and two ring sub-planes
   (`tier2_params`, `TIER2_BOX_SPLIT`), one seed as in 9 in 100-ms
   chunks to 200 ms (400 until the chaos phase X came): equal to the
   JAX golden digests at 100 and 200 ms, zero drops, clamps and
   evictions, route once a window per sub-plane (200), merge every ms
   and score on the verification ms per piece (400, 100);
11. an attack: `Handel(**reference_default_params(1024),
   byzantine_suicide=True)`, seed 0, 200 ms through `Runner.run_ms`:
   equal to its JAX golden, honest blacklists filled, the kernels once
   a ms;
S. SanFermin at 32,768 nodes, `tools/bench_suite.py`'s line
   (``SanFermin(node_count=32768, inbox_cap=16)``, two ring
   sub-planes), one seed at K=2 in one 350-ms chunk (the bench line
   runs on to 6,000; cut from 1,000 ms, then 500, for time, still past
   the first reply timeouts at 301): equal to the
   JAX golden at 350 ms, zero drops and clamps, route once a window per
   sub-plane;
C. `SanFerminCappos()` (2,048 nodes), one seed, 100 ms at K=2 (cut
   from 200 for time, PR 10, its golden regenerated): equal to its JAX
   golden;
D. Dfinity with 10,000 attesters (bench_suite's line, 10,111 nodes),
   one seed: dense to 400 ticks at K=2, equal to its JAX golden; then
   fast-forwarded from tick 0 in 400-tick chunks to 12,000 ticks (120
   simulated s): equal to the golden at 400 and to the JAX run's at
   12,000, every chunk's skip counts the JAX engine's, zero unicast and
   arena drops, heads within 1 (the JAX run stops at height 2, short of
   bench_suite's 30: the port is held to the JAX run);
Q. `bench.py` `bench_quiet`'s lines, 4 seeds in one batch, 300 ms in
   100-ms `network.scan_chunk` chunks at K=2 (`bench_torch.py` runs
   1,000 in 200-ms chunks; cut for time, to 400 and then 300, its
   goldens regenerated; P2PFlood's flood completes by 300): Dfinity (31
   nodes) dense
   and fast-forwarded (the JAX engine's skip counts chunk by chunk),
   P2PFlood (`quiet_params`, 256 nodes) dense; every seed equal to its
   golden.

K. Casper IMD's reference configuration, `CasperIMD()` (83 nodes,
   20-ms ticks, the WF byzantine producer), seeds 0-7 in one batch
   through `run_multiple_times` in 600-tick chunks at the proved K
   (2) to 1,200 ticks (24 simulated s, three slots; cut from 4,000,
   then 2,000, for time): every seed equal to its JAX
   golden at 600 and 1,200 ticks,
   zero unicast, broadcast and arena drops, heads within 2;
E. ETHPoW, `try_miner`'s batch at one hash-power point (10 miners, the
   selfish miner at 0.40, 1-s latency, 8,192 blocks), seeds 1-5 in one
   batch through `run_multiple_times` in one 1,500-tick chunk at K=2
   (cut from 3,000 ticks to 2,000, then 1,500, for time): every leaf
   equal to the JAX golden (`thr` float for float), `try_miner`'s CSV
   row the JAX run's, zero drops;
   its ops a tick at 8,192 blocks equal to those at 1,024 within 1%.

B. one point of Handel's Byzantine-fraction sweep through its driver,
   ``handel_scenarios.byz_suicide_sweep(ratios=(0.25,), nodes=4096,
   seeds=4)`` (1,024 attackers, threshold 0.99 x live, stored emission
   lists; its 4 seeds in one batch through `run_multiple_times`, chunk
   250, each ms's phase hints from its time): the CSV text, the stop
   times and every seed's leaves there equal the JAX run's, zero drops
   and clamps, every honest node's blacklist non-empty; route once a
   K=2 window, merge every ms, score on the verification ms;
P. the P2P signature protocols, seeds 0-3 in one batch each:
   ``HandelEth2()`` (64 nodes) with the distance latency dense to 600
   ms at K=2, then fast-forwarded to 1,100 (6,100, past the second
   aggregation's start, cut for time), equal to its JAX goldens at both
   and the JAX engine's skip counts; ``P2PHandel(**scenario_params(100,
   20))``
   fast-forwarded in 500-ms calls until every seed is done (6,000 ms),
   equal to the JAX run there with its skip counts; and
   ``OptimisticP2PSignature(**main_params())`` (1,000 nodes) dense at
   K=2 until every seed is done (400 ms), equal to the JAX run there,
   every node done with at least 501 signatures, zero drops.

L. the two scenario drivers that run on the measured city latency with
   its jitter, at the JAX package's own configurations: (a)
   ``p2phandel_scenarios.basic_stats(P2PHandel(**default_params(100,
   20)), seeds=4)`` (120 nodes placed by city; seeds 0-3 in one
   `run_multiple_times` batch, chunk 500, K=2, until every seed is
   done): the stats dict, the stop times and every seed's leaves equal
   the JAX run's; (b) ``optimistic_scenarios.node_scaling(seeds=2)``:
   at ``counts=(1024,)``, its ladder's largest point, the JAX run
   overflows its inboxes and its harness refuses (as at every point of
   the ladder), and the port must refuse with the same count of dropped
   and clamped messages; at ``counts=(64,)``, which completes, the CSV
   text, the stop times and every seed's leaves equal the JAX run's,
   every node done with at least `threshold` signatures; zero drops and
   clamps in both completed runs, route
   launched once a K=2 window.  K1 is timed on a batch captured from
   every tenth of (a)'s windows in its first 3,000 ms (the busiest);
A. the last three protocols, four seeds in one batch each:
   ``ENRGossiping()`` (50 nodes, 8 joiner slots) dense at K=1 to 250 ms
   (cut for time), and tests/test_enr.py's churn configuration (40
   nodes, a joiner every 500 ms), seeds 22-25 to 750 ms, where the step
   hint must report the join and the capability change that the JAX
   batch's state schedules, ``Slush()`` and ``Snowflake()`` (100 nodes)
   fast-forwarded at K=1 in 250-ms calls until every node has decided
   (the stop time and every call's skip counts the JAX engine's), and
   ``Paxos()`` (3 + 3) dense at K=1 until `cont_if` stops every seed;
   each equal to its JAX golden, zero drops;
G32. GSF at the reference's scale: ``GSFSignature(node_count=32768)``
   with its defaults (L 16, W 1,024, H 512, 53 rounds; a 7.1-GB
   snapshot pool written in place), seed 0, dense through
   `Runner.run_ms` in two 50-ms calls: every leaf equal to the JAX
   golden at 50 and 100 ms, zero drops and clamps, route, gsf_merge and
   gsf_score once a ms; its build and run peak memory, wall and ops a
   ms logged, and K1 timed on a batch captured from its next ms;
O. the obs planes on the card, the twins of the JAX package's route
   tests with the kernel on: ``PingPong(node_count=64)``, seed 0, under
   the metrics plane (stat_each_ms 4, 24 ms), the flight recorder (40
   ms) and the audit plane (``Runner(audit=)``, 40 ms): each carry and
   state equal to the JAX planes' (``tests/torch_parity.py
   obs-golden``), the audit clean, route once a ms;
X. the chaos plane and the memo plane's freeze synthesis
   (``tests/torch_parity.py chaos-goldens``): X1 the headline (16 seeds
   of the 2048-node reference-default Handel, seed-folded engine, K=2,
   phase hints) wrapped in `ChaosProtocol` to 200 ms under churn of 32
   nodes up at init in every seed (40-120 ms), a partition of nodes
   0-1,023 (60-140), 200 per mille loss on every link (20-160) and +3
   ms on the links from the first half to the second (100-180): every
   seed equal to the JAX golden at 100 and 200 ms, the schedule equal to
   the golden's, route once a window, merge every ms, score on the
   verification ms, the faulted `impact_summary` beside the plain
   headline's at 200 ms (phase 5), K1's window at 100 ms (inside every
   fault) replayed against its plain version; X2 `PingPong(1000)`, 16
   seeds, under tests/test_checkpoint.py:111's schedule scaled to 1,000
   nodes, in 40-ms chunks at the proved K: `checkpoint.save` at 40 ms
   (inside an outage and the partition; 6.4 GB, uncompressed, in
   memory), `checkpoint.load` into a fresh state, on to 120 ms, equal
   to the uninterrupted run on the card and to the JAX golden at 120
   ms; X3 `PingPong(1000)`, 16 seeds, fixed 10-ms latency, 240 ms in
   40-ms chunks under the metrics, audit and trace planes (one pass a
   chunk, `planes_chunk`): at each chunk boundary `memo.build_probe`
   marks the quiet runs, and for each, `frozen_final` and
   `frozen_carries` equal the state and the three carries of stepping
   its remaining chunks (at least one frozen).  ``--only-chaos`` builds
   the kernels and runs phase X alone.

The determinism reruns run under a plane each and are held to the same
goldens: the headline's (5b) under the metrics plane (its totals
cross-checked against the state with `cross_check_metrics`), the
PingPong rerun (6b) under the flight recorder (its events against the
state's counters), the GSF rerun (4b) under the audit plane (clean).
Each plane's chunk makes no more synchronising calls than the engine's
alone over SYNC_MS ms (`torch.cuda.set_sync_debug_mode("warn")`).

Each of S-A logs its wall, its peak allocated memory and its PyTorch
ops a simulated ms or tick (torch.profiler, host side, over OPS_MS more
ms, one more fast-forwarded chunk, or for K the slot boundary after its
run and 10 ticks after that), and checks route's launches.  K1 is also
timed against its plain version on a batch taken from S's, D's, Q's
P2PFlood, K's and E's
windows, and on B's, Optimistic's and L(a)'s (`capture_route`: of all
their windows, S's first sub-plane,
the one with the most valid messages; K and E send only broadcasts, so
their windows bin none), right after each path.

Phase 2 holds merge and score at B's shapes (4 x 4,096 rows through
their vmap rules), and route, merge and score at the headline's too:
route with R 16 on a K=2 window, merge and score through their vmap
rules at 32,768 rows; and route on PingPong's batches: one K=2 window
of pongs at R 16 (H 1024, N 1000, C 32, F 1, 2 x 1000 messages a seed,
1% valid, all to the witness) and a spill drain of 4096 entries, half
selected, at R 1; and route, gsf_merge and gsf_score at the GSF batch's
(R 4: one ms of sends, and 4 x 4096 rows through the vmap rules);
and at the scale lines': route on a K=2 window of tier 3 (H 256, N
65,536, C 12, F 2: the rank tables in device scratch) and of one tier-2
sub-plane (N 16,384 of 32,768), merge and score on one tier-2 q_sig
piece (16,384 rows, W 1,024), merge's gather (16-byte or word by word)
recorded; and gsf_merge and gsf_score at G32's shapes (32,768 rows, Q
16, S 16, W 1,024, the planes drawn on the card; gsf_score's branch,
its kernel's template argument, logged).  ``--memory-seeds R`` also
builds each scale line with R seeds and reports its peak device memory
over its first chunk.

It prints one JSON line per kernel, the ``{"kernels": [...]}`` summary,
the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  ``--profile MS`` also profiles MS
simulated ms of each path with `torch.profiler` (Handel and the
headline from t=600, the headline's MS rounded up to its 20-ms schedule,
GSF and the GSF batch at K=1 and K=2 from t=300, PingPong from t=0, the
busiest stretches), reports the device us a simulated ms of each path's
kernels by name, and writes the tables to ``--profile-file``,
``--profile-gsf-file``, ``--profile-headline-file``,
``--profile-pingpong-file``, ``--profile-gsf-batch-file`` (K=2's
beside it, ``_k2`` added to its name), ``--profile-t3-file`` (from
t=600) and ``--profile-t2-file`` (from t=200), and S (from t=300), D
and Q's two batches (from 0) to ``--profile-protocols-prefix`` with
the path's name and ``.txt`` appended, and G32 (from t=50) to
``--profile-gsf32k-file``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

N_NODES = 2048
MAIN_MS = 1000
GOLDEN_MS = 200
GSF_NODES = 4096
GSF_MS = 600
GSF_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_gsf4096_600ms.json")
HEADLINE_SEEDS = 16
HEADLINE_MS = 1000
HEADLINE_CHUNK = 200
HEADLINE_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                               "golden_handel2048_r16_k2_200ms.json")
PP_NODES = 1000
PP_MS = 800
PP_SEEDS = 16
PP_CHUNK = 200
PP_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_pingpong1000_800ms.json")
PP_HARNESS_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                                 "golden_pingpong1000_r16_k2_200ms.json")
SPILL_MS = 520
GSF_SEEDS = 4
GSF_BATCH_MS = 100
GSF_CHUNK = 100
GSF_BATCH_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                                "golden_gsf4096_r4_100ms.json")
FF_MS = 200
FF_STATS = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_pingpong1000_ff_stats.json")
T3_NODES = 65536
T3_CHUNK = 200
T3_MS = 2000            # the tier-3 line's run length (BENCH_NOTES.md:1208)
T3_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_cardinal65536_k2.json")
T2_NODES = 32768
T2_CHUNK = 100
T2_MS = 200
T2_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_tier2_32768.json")
ATTACK_NODES = 1024
ATTACK_MS = 200
ATTACK_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                             "golden_handel1024_suicide_200ms.json")
SF_NODES = 32768
SF_CHUNK = 350
SF_MS = 350             # the golden's first checkpoint (bench_torch runs on)
SF_BOX_SPLIT = 2
SF_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_sanfermin32768_box2.json")
CAPPOS_MS = 100
CAPPOS_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                             "golden_cappos2048_100ms.json")
D_CHUNK = 200
D_TICKS = 400
D_FF_CHUNK = 400
D_FF_TICKS = 12000      # 120 simulated s in 10-ms ticks
D_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_dfinity10k_400ticks.json")
Q_SEEDS = 4
Q_CHUNK = 100
Q_MS = 300
QD_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_dfinity31_r4_300ticks.json")
QP_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_p2pflood256_r4_300ms.json")
K_SEEDS = 8
K_CHUNK = 600
K_TICKS = 1200          # 24 simulated s, 3 slots (BASELINE's 5 h cut)
K_OPS_TICKS = 10        # ticks 1,202-1,212, WF ticks after a slot boundary
K_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_casper83_r8_1200ticks.json")
E_RUNS = 5
E_CHUNK = 1500
E_TICKS = 1500          # 15 simulated s
E_OPS_TICKS = 4         # ticks 0-4 at 8,192 and at 1,024 blocks
E_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_ethpow10_r5_1500ticks.json")
BYZ_NODES = 4096
BYZ_SEEDS = 4
BYZ_RATIO = 0.25
BYZ_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_handel4096_byz_suicide_r4.json")
P_SEEDS = 4
ETH2_CHUNK = 200
ETH2_MS = 600
ETH2_FF_CHUNK = 500
ETH2_FF_MS = 1100       # 6,100 (past the second start) cut for time
ETH2_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                           "golden_handeleth2_64_r4.json")
P2PH_CHUNK = 500
P2PH_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                           "golden_p2phandel120_r4.json")
OPT_CHUNK = 100
OPT_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_optimistic1000_r4.json")
CITY_P2PH_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                                "golden_p2phandel_city120_r4.json")
CITY_OPT_NODES = 64     # completes; every ladder point (128-1,024) refuses
CITY_OPT_REFUSED = 1024
CITY_OPT_SEEDS = 2
CITY_OPT_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                               "golden_optimistic_city_r2.json")
A_SEEDS = 4
ENR_CHUNK = 250
ENR_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_enr58_r4.json")
ENR_CHURN_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                                "golden_enr48_churn_r4.json")
AV_CHUNK = 250
AV_GOLDEN = {name: os.path.join("wittgenstein_tpu_torch", "data",
                                f"golden_{name.lower()}100_r4.json")
             for name in ("Slush", "Snowflake")}
PAXOS_CHUNK = 250
PAXOS_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                            "golden_paxos6_r4.json")
G32_NODES = 32768
G32_MS = (50, 100)      # the golden's checkpoints, Runner.run_ms calls
G32_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_gsf32768_100ms.json")
OBS_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_obs_pingpong64.json")
X_CHUNK = 100           # X1: the faulted headline in 100-ms chunks
X_MS = (100, 200)       # the golden's checkpoints
X_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_headline_chaos_200ms.json")
X_CHURN = 32
X2_CHUNK = 40
X2_MS = 120
X2_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                         "golden_pingpong1000_r16_chaos_120ms.json")
X3_CHUNK = 40
X3_MS = 240
HEADLINE_STAT_MS = 20   # the headline's instrumented rerun: one row a period
PP_TRACE_CAP = 8192     # the PingPong rerun's event ring
SYNC_MS = 20            # simulated ms over which a plane's syncs are counted
OPS_MS = 2              # simulated ms over which a path's ops are counted
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
WARMUP, ITERS = 2, 10   # 3 and 20 before PR 10 (cut for time)
PLAIN_BUDGET_S = 0.25


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing


def call_ms(fn, reset=None, iters=None):
    """Mean ms of one call of fn() over `iters` calls after the warm-up
    (WARMUP calls, one for a shortened count), with CUDA events around
    each call (ITERS unless given): the device's view of a call, host
    launch overhead included where the device waits for it.  `reset`
    (untimed) restores inputs that fn updates in place."""
    import torch
    iters = iters or ITERS
    for _ in range(WARMUP if iters == ITERS else 1):
        if reset:
            reset()
        fn()
    total = 0.0
    for _ in range(iters):
        if reset:
            reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def kernel_device_us(events, match=None):
    """Summed device time (us) of the CUDA kernels among profiler
    `events` whose name contains `match` (all kernels if None)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and
               (match is None or match in e.key))


def device_ms(fn, match=None, reset=None, iters=None, by_name=None):
    """Mean device ms per call of fn() from `torch.profiler`: the time of
    the CUDA kernels named like `match` (all of fn's kernels if None),
    over `iters` calls after the warm-up (as `call_ms`); the time of
    `reset`'s own kernels is measured the same way and taken off.  A
    call of a few µs can stay at or below the noise of the reset's time:
    then, with `by_name`, the call is timed by its kernels named like
    it, and the fallback is logged.  Only the device's activity is
    recorded: recording the host's ops too leaves the kernels' times as
    they are and costs seconds a case where a plain version issues
    thousands of small ops (`kernel_ab.py --host-events`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    iters = iters or ITERS

    def run(with_fn):
        for _ in range(WARMUP if iters == ITERS else 1):
            if reset:
                reset()
            fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if reset:
                    reset()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        return kernel_device_us(prof.key_averages(), match)
    # The profiler now and then delivers none of a window's device
    # events, and a call of a few µs can come out at or below the noise
    # of the reset measured apart: such a measurement is taken again,
    # twice at most.
    for _ in range(3):
        total = run(True)
        if total > 0 and reset and match is None:
            total -= run(False)
        if total > 0:
            break
    if total <= 0 and by_name:
        log(f"the call's time is within the noise of its reset's; timed "
            f"by its kernels named like {by_name!r}")
        return device_ms(fn, by_name, reset, iters)
    if total <= 0:
        fail(f"the profiler saw no device time for {match or 'the call'}")
    return total / iters / 1e3


def plain_iters(fn, reset=None):
    """How many calls to time a plain version over: ITERS, fewer where one
    call is slow (about PLAIN_BUDGET_S of calls, at least 3).  Plain
    versions run 100-10,000x their kernels' times; at the scale lines'
    shapes one call is 0.1 s."""
    import torch
    if reset:
        reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(ITERS, int(PLAIN_BUDGET_S /
                                 (time.perf_counter() - t0))))


_FLUSH = []


def l2_flush():
    """Write a 96 MB buffer, twice the H100's 50 MB L2, then read another:
    the next kernel finds its inputs in device memory, as on the path,
    where each simulated ms writes the ring (Handel) or copies the
    111 MB pool (GSF) between two calls.  The read leaves the L2 clean,
    so the kernel is not charged for writing the buffer back."""
    import torch
    if not _FLUSH:
        _FLUSH.extend(torch.empty(96 << 20, dtype=torch.uint8,
                                  device="cuda") for _ in range(2))
    _FLUSH[0].zero_()
    _FLUSH[1].max()


def cold(reset=None):
    """An untimed reset that runs `reset` and then flushes the L2."""
    def fn():
        if reset:
            reset()
        l2_flush()
    return fn


def max_abs_err(plain, kern):
    """The largest absolute difference over the output pairs, computed
    where the outputs are (on the card, not on a host copy of GB-sized
    rings)."""
    err = 0
    for a, b in zip(plain, kern):
        if a.numel():
            d = (a.long() - b.to(a.device).long()).abs().max()
            err = max(err, int(d))
    return err


# ---------------------------------------------------------- kernel cases


def route_case(dev, rng, hz=256, n=N_NODES, c=12, out_deg=21, r=1,
               hot=0.05, full_rows=8):
    """A path's shapes (Handel: R 1, F 3, H 256, N 2048, C 12 and M =
    2048 x 21 messages; GSF: H 512, N 4096, C 16, M = 4096 x 22; the
    headline: R 16 and one K=2 window, M = 2 x 2048 x 21 a seed);
    part-full cells and `full_rows` rows of full ones, a share `hot` of
    the messages sent to four hot cells that overflow, invalid messages
    interleaved.  At R 1 the draws are those of a one-seed case with 1-D
    message vectors.  The ring's planes are drawn on the device, from a
    generator seeded by `rng`: at R 16 or at the GSF batch's shapes they
    hold 0.5-0.7 G values, seconds of draws on the host."""
    import torch
    f = 3
    m = n * out_deg
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 62)))

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)

    def plane(high, shape):
        return torch.randint(0, high, shape, generator=gen,
                             dtype=torch.int32, device=dev)
    data = plane(1 << 20, (r, f, hz, n, c))
    src = plane(n, (r, hz, n, c))
    size = plane(300, (r, hz, n, c))
    count = rng.integers(0, 4, (r, hz, n))
    count[:, :full_rows] = c
    count = i32(count)
    arrival = rng.integers(0, hz, (r, m)) + 3 * hz      # rows wrap
    dest = rng.integers(0, n, (r, m))
    to_hot = rng.random((r, m)) < hot                   # overflowing cells
    arrival[to_hot], dest[to_hot] = 100, rng.integers(0, 4, to_hot.sum())
    msg = [i32(a) for a in (arrival, dest, rng.integers(0, n, (r, m)),
                            rng.integers(1, 300, (r, m)))]
    payload = i32(rng.integers(0, 1 << 20, (r, m, f)))
    valid = torch.tensor(rng.random((r, m)) < 0.7, device=dev)
    return [data, src, size, count], msg + [payload, valid]


def route_bytes(ring, msg, count_after):
    """Least bytes this batch needs: `valid` (bool) of every message,
    the arrival and dest of the valid ones, F + 2 words read and F + 2
    written per accepted message, the touched count cells read and
    written, the drop counters written."""
    import torch
    data = ring[0]
    r, f, hz, n = data.shape[:4]
    arrival, dest, _, _, _, valid = msg
    seed = torch.arange(r, device=valid.device)[:, None].expand_as(valid)
    cells = torch.unique(((seed * hz + arrival.long() % hz) * n +
                          dest)[valid])
    accepted = int((count_after - ring[3]).sum())
    return (valid.numel() * valid.element_size() + 8 * int(valid.sum()) +
            4 * (2 * accepted * (f + 2) + 2 * cells.numel() + r))


def route_pingpong_case(dev, rng, kind, r):
    """PingPong's batches at its ring's shapes (H 1024, N 1000, C 32, F
    1), the ring empty but for a few counts as PingPong leaves it:
    ``window``, one K=2 window of pongs (M = 2 x 1000 a seed, 1% valid,
    all to the witness, rel in [2, H]); ``drain``, a spill drain of S =
    4096 entries, half selected, rel in [1, H-2], to any node."""
    import torch
    hz, n, c, f, t = 1024, PP_NODES, 32, 1, 4096 + 6
    if kind == "window":
        m, lo, hi, share, dests = 2 * n, 2, hz + 1, 0.01, 1
    else:
        m, lo, hi, share, dests = 4096, 1, hz - 1, 0.5, n

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)
    ring = [torch.zeros((r, f, hz, n, c), dtype=torch.int32, device=dev),
            torch.zeros((r, hz, n, c), dtype=torch.int32, device=dev),
            torch.zeros((r, hz, n, c), dtype=torch.int32, device=dev),
            i32(rng.integers(0, 3, (r, hz, n)))]
    msg = [i32(t + rng.integers(lo, hi, (r, m))),
           i32(rng.integers(0, dests, (r, m))),
           i32(rng.integers(0, n, (r, m))), i32(rng.integers(1, 9, (r, m))),
           i32(rng.integers(0, 2, (r, m, f))),
           torch.tensor(rng.random((r, m)) < share, device=dev)]
    return ring, msg


def phase_route(dev, rng, make=route_case, phases=True, **shape):
    import torch
    from wittgenstein_tpu_torch.ops.route import bin_into_ring, \
        bin_into_ring_plain
    ring, msg = make(dev, rng, **shape)
    plain = [t.clone() for t in ring]
    kern = [t.clone() for t in ring]
    dp = bin_into_ring_plain(*plain, *msg)
    dk = bin_into_ring(*kern, *msg)
    torch.cuda.synchronize()
    err = max_abs_err(plain + [dp], kern + [dk])
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"route kernel differs from its plain version (max err {err})")
    nbytes = route_bytes(ring, msg, kern[3])
    work = [t.clone() for t in ring]

    def reset():
        work[3].copy_(ring[3])

    def kern_fn():
        bin_into_ring(*work, *msg)

    def plain_fn():
        bin_into_ring_plain(*work, *msg)
    # Each phase alone, cold, by its kernel's name (where `phases`: the
    # Handel, headline and scale windows); then the whole call cold:
    # every device op of the wrapper, the reset's own ops measured alone
    # and taken off.  Warm, both phases by the prefix of their names:
    # taking off the count copy's time there left a spread wider than
    # the call.
    out = {}
    if phases:
        out["phases_us"] = {
            k: device_ms(kern_fn, k, cold(reset)) * 1e3
            for k in ("route_bucket_kernel", "route_rank_kernel")}
    plain_n = plain_iters(plain_fn, reset)
    # A batch with no valid message (Casper's and ETHPoW's windows: they
    # only broadcast) is the two launches' floor, inside the noise of
    # the reset's time: timed by its kernels' names at once.
    whole = (device_ms(kern_fn, "route_", cold(reset))
             if not bool(msg[-1].any()) else
             device_ms(kern_fn, None, cold(reset), by_name="route_"))
    return dict(out, err=err, ms=whole,
                warm_ms=device_ms(kern_fn, "route_", reset),
                plain_ms=device_ms(plain_fn, None, reset, plain_n),
                call_ms=call_ms(kern_fn, reset),
                plain_call_ms=call_ms(plain_fn, reset, plain_n),
                nbytes=nbytes,
                drops=int(dk.sum()))


def merge_case(dev, rng, m=N_NODES):
    """Main-path shapes: M 2048, Q 16, S 12, W 64 (or M `m`, W m / 32);
    a queue 70% full, 60% of inbox slots valid, planted (sender, level)
    duplicates within the inbox and against the queue."""
    import numpy as np
    import torch
    q, s, w = 16, 12, m // 32
    q_from = np.where(rng.random((m, q)) < 0.7,
                      rng.integers(0, m, (m, q)), -1)
    q_lvl = rng.integers(0, 12, (m, q))
    src = rng.integers(0, m, (m, s))
    level = rng.integers(0, 12, (m, s))
    pick = rng.random((m, s))
    prev = rng.integers(0, s, (m, s)) % np.maximum(np.arange(s), 1)
    dup = (pick < 0.3) & (np.arange(s) > 0)
    rows = np.nonzero(dup)
    src[rows] = src[rows[0], prev[rows]]
    level[rows] = level[rows[0], prev[rows]]
    qq = rng.integers(0, q, (m, s))
    hit = (pick >= 0.3) & (pick < 0.6) & (np.take_along_axis(
        q_from, qq, 1) >= 0)
    rows = np.nonzero(hit)
    src[rows] = q_from[rows[0], qq[rows]]
    level[rows] = q_lvl[rows[0], qq[rows]]

    def i32(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def bits(*shape):
        return torch.tensor(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32), device=dev)
    return [i32(q_from), i32(q_lvl), i32(rng.integers(0, 2 * m, (m, q))),
            torch.tensor(rng.random((m, q)) < 0.2, device=dev), bits(m, q, w),
            i32(src), i32(level), i32(rng.integers(0, 2 * m, (m, s))),
            torch.tensor(rng.random((m, s)) < 0.6, device=dev),
            bits(m, s, w)]


def merge_bytes(args):
    """Least bytes: every queue and inbox column read once, the Q sig
    rows kept per node read (of its Q + S candidates' rows), the new
    columns and sig plane written, the eviction count written."""
    q_sig = args[4]
    cols_in = sum(t.numel() * t.element_size()
                  for i, t in enumerate(args) if i not in (4, 9))
    cols_out = sum(t.numel() * t.element_size() for t in args[:4])
    return cols_in + cols_out + 2 * q_sig.numel() * q_sig.element_size() + 4


def phase_merge(dev, rng, seeds=None, make=merge_case):
    """K2 at the Handel path's shapes (or `make`'s); with `seeds`, that
    many cases in one batch through `merge_queue`'s vmap rule (one
    launch at seeds x 2048 rows, the headline's), against the plain
    version on the folded rows.  Records whether the kernel gathered
    the sig rows 16 bytes at a time or word by word."""
    import torch
    from wittgenstein_tpu_torch.ops.merge import (fold_seeds, merge_queue,
                                                  merge_queue_plain)
    if seeds is None:
        args = flat = make(dev, rng)

        def kern_fn():
            return merge_queue(*args)
    else:
        args = [torch.stack(a) for a in
                zip(*(make(dev, rng) for _ in range(seeds)))]
        flat = [fold_seeds(a, 0, seeds) for a in args]

        def kern_fn():
            return torch.func.vmap(merge_queue)(*args)

    def plain_fn():
        return merge_queue_plain(*flat, seeds=seeds)
    plain = plain_fn()
    word = merge_queue.word_launches
    kern = [k.reshape(p.shape) for k, p in zip(kern_fn(), plain)]
    torch.cuda.synchronize()
    gather = "word" if merge_queue.word_launches > word else "vector"
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"merge kernel differs from its plain version (max err {err})")
    nbytes = merge_bytes(flat) + 4 * ((seeds or 1) - 1)
    plain_n = plain_iters(plain_fn)
    return dict(err=err, gather=gather,
                ms=device_ms(kern_fn, "merge_kernel", cold()),
                warm_ms=device_ms(kern_fn, "merge_kernel"),
                plain_ms=device_ms(plain_fn, iters=plain_n),
                call_ms=call_ms(kern_fn),
                plain_call_ms=call_ms(plain_fn, iters=plain_n), nbytes=nbytes,
                evicted=int(kern[5].sum()))


def phase_score(dev, rng, seeds=None, args=None, m=N_NODES):
    """K3 at the Handel path's shapes (M `m` rows; or on `args`, one
    call's); with `seeds`, a batch through `score_queue`'s vmap rule (the
    node ids unbatched, as in the step), against the plain version on
    the folded rows."""
    import numpy as np
    import torch
    from wittgenstein_tpu_torch.ops.merge import fold_seeds
    from wittgenstein_tpu_torch.ops.score import score_queue, \
        score_queue_plain
    q, w = 16, m // 32
    lead = () if seeds is None else (seeds,)

    def bits(*shape):
        return torch.tensor(rng.integers(0, 2 ** 32, lead + shape,
                                         dtype=np.uint32).view(np.int32),
                            device=dev)
    if args is None:
        args = [bits(m, q, w),
                torch.tensor(rng.integers(0, 12, lead + (m, q)),
                             dtype=torch.int32, device=dev),
                torch.arange(m, dtype=torch.int32, device=dev),
                bits(m, w), bits(m, w), bits(m, w)]
    q, w = args[0].shape[-2:]
    if seeds is None:
        flat = args

        def kern_fn():
            return score_queue(*args)
    else:
        dims = (0, 0, None, 0, 0, 0)
        flat = [fold_seeds(a, d, seeds) for a, d in zip(args, dims)]

        def kern_fn():
            return torch.func.vmap(score_queue, in_dims=dims)(*args)

    def plain_fn():
        return score_queue_plain(*flat)
    plain = plain_fn()
    kern = [k.reshape(p.shape) for k, p in zip(kern_fn(), plain)]
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"score kernel differs from its plain version (max err {err})")
    # Inputs: sig plane, levels, ids, three rows; outputs: three int32
    # and one bool [M, Q]; M = all rows of the batch.
    m = flat[2].numel()
    nbytes = 4 * (m * q * w + m * q + m + 3 * m * w + 3 * m * q) + m * q
    plain_n = plain_iters(plain_fn)
    return dict(err=err, ms=device_ms(kern_fn, "score_kernel", cold()),
                warm_ms=device_ms(kern_fn, "score_kernel"),
                plain_ms=device_ms(plain_fn, iters=plain_n),
                call_ms=call_ms(kern_fn),
                plain_call_ms=call_ms(plain_fn, iters=plain_n), nbytes=nbytes)


def phase_route_headline(dev, rng):
    """K1 on one K=2 window of the headline: R 16, M = 2 x 2048 x 21."""
    return phase_route(dev, rng, out_deg=2 * 21, r=HEADLINE_SEEDS)


def phase_merge_headline(dev, rng):
    return phase_merge(dev, rng, seeds=HEADLINE_SEEDS)


def phase_score_headline(dev, rng):
    return phase_score(dev, rng, seeds=HEADLINE_SEEDS)


def phase_merge_byz(dev, rng):
    """K2 at phase B's shapes: 4 seeds x 4,096 rows (W 128) through the
    vmap rule."""
    return phase_merge(dev, rng, seeds=BYZ_SEEDS,
                       make=lambda dev, rng: merge_case(dev, rng,
                                                        m=BYZ_NODES))


def phase_score_byz(dev, rng):
    return phase_score(dev, rng, seeds=BYZ_SEEDS, m=BYZ_NODES)


def phase_route_gsf(dev, rng):
    return phase_route(dev, rng, hz=512, n=GSF_NODES, c=16, out_deg=22,
                       phases=False)


def phase_route_pingpong(dev, rng):
    """K1 on one K=2 window of PingPong's pongs for 16 seeds."""
    return phase_route(dev, rng, route_pingpong_case, kind="window",
                       r=PP_SEEDS, phases=False)


def phase_route_drain(dev, rng):
    """K1 on a spill drain's batch."""
    return phase_route(dev, rng, route_pingpong_case, kind="drain", r=1,
                       phases=False)


def gsf_merge_case(dev, rng, m=GSF_NODES):
    """GSF shapes: M 4096, Q 16, S 16, W 128, L 13 (or M `m`, W m / 32,
    L log2(m) + 1); a queue 70% full (30% individuals), 60% of inbox
    slots valid, planted same-sender and same-(sender, level) duplicates
    and superseded queue entries, a got_indiv row consuming a third of
    the senders' individuals (past 4,096 rows a hash of (node, sender):
    the [M, M] draw would be GBs); the masks derived as
    `models/gsf._receive` derives them.  The sig planes are drawn on the
    card past 4,096 rows."""
    import numpy as np
    import torch
    q, s, w, levels = 16, 16, m // 32, m.bit_length()
    q_from = np.where(rng.random((m, q)) < 0.7, rng.integers(0, m, (m, q)),
                      -1)
    q_lvl = rng.integers(0, levels, (m, q))
    q_indiv = rng.random((m, q)) < 0.3
    src = rng.integers(0, m, (m, s))
    level = rng.integers(0, levels, (m, s))
    pick = rng.random((m, s))
    prev = rng.integers(0, s, (m, s)) % np.maximum(np.arange(s), 1)
    rows = np.nonzero((pick < 0.3) & (np.arange(s) > 0))
    src[rows] = src[rows[0], prev[rows]]
    rows = np.nonzero((pick < 0.15) & (np.arange(s) > 0))
    level[rows] = level[rows[0], prev[rows]]
    qq = rng.integers(0, q, (m, s))
    rows = np.nonzero((pick >= 0.3) & (pick < 0.5) &
                      (np.take_along_axis(q_from, qq, 1) >= 0))
    src[rows] = q_from[rows[0], qq[rows]]
    level[rows] = q_lvl[rows[0], qq[rows]]
    valid = rng.random((m, s)) < 0.6
    if m <= GSF_NODES:
        got_of_src = np.take_along_axis(rng.random((m, m)) < 1 / 3, src, 1)
    else:
        key = np.arange(m)[:, None] * 0x9E3779B1 + src * 0x85EBCA77
        got_of_src = (key >> 7) % 3 == 0
    same = src[:, :, None] == src[:, None, :]
    later = np.triu(np.ones((s, s), bool), 1)[None]
    earlier = np.tril(np.ones((s, s), bool), -1)[None]
    dup = (same & (level[:, :, None] == level[:, None, :]) &
           valid[:, None, :] & later).any(2)
    agg_ok = valid & ~dup
    sup = ((q_from[:, :, None] == src[:, None, :]) &
           (q_lvl[:, :, None] == level[:, None, :]) &
           ~q_indiv[:, :, None] & agg_ok[:, None, :]).any(2)
    ex_keep = (q_from >= 0) & ~sup
    dup_ind = (same & valid[:, None, :] & earlier).any(2)
    ind_ok = valid & ~dup_ind & ~got_of_src

    def i32(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def b(a):
        return torch.tensor(a, device=dev)

    def bits(*shape):
        if m > GSF_NODES:
            return card_bits(dev, rng, shape)
        return torch.tensor(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32), device=dev)
    return [i32(q_from), i32(q_lvl), b(q_indiv), b(ex_keep), bits(m, q, w),
            i32(src), i32(level), b(agg_ok), b(ind_ok), bits(m, s, w)], levels


def card_bits(dev, rng, shape):
    """Random int32 words of `shape` drawn on the card (GB-sized planes;
    the seed from `rng`)."""
    import torch
    g = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                         dtype=torch.int32, device=dev)


def gsf_merge_bytes(args, kern, levels):
    """Least bytes: every queue and inbox column read once, the sig rows
    kept from the queue or the inbox aggregates read (an individual's
    one-bit row is made from its sender id, already counted), the new
    columns, sig plane, got_add rows and kept counts written."""
    import torch
    q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok, ind_ok, \
        sig_all = args
    m, q, w = q_sig.shape
    s = src.shape[1]
    c = q + 2 * s
    # The kernel's keys (csrc/gsf_merge.cu), to know which rows it keeps.
    u_from = torch.cat([torch.where(ex_keep, q_from, -1),
                        torch.where(agg_ok, src, -1),
                        torch.where(ind_ok, src, -1)], 1)
    u_lvl = torch.cat([q_lvl, level, level], 1)
    pos = torch.arange(c, device=q_from.device)[None, :]
    tier = torch.where(pos >= q + s, 2, torch.where(
        torch.cat([q_indiv, torch.zeros_like(agg_ok),
                   torch.ones_like(ind_ok)], 1), 0, 1))
    key = torch.where(u_from >= 0, (tier * (levels + 1) + torch.where(
        tier == 1, u_lvl, 0)) * c + pos, 0x7FFFFF00 + pos)
    order = torch.sort(key, 1).indices[:, :q]
    rows_read = int((order < q + s).sum())
    cols_in = sum(t.numel() * t.element_size()
                  for i, t in enumerate(args) if i not in (4, 9))
    cols_out = sum(t.numel() * t.element_size()
                   for i, t in enumerate(kern) if i != 3)
    return cols_in + cols_out + 4 * w * (rows_read + m * q)


def phase_gsf_merge(dev, rng, seeds=None, m=GSF_NODES):
    """K5 at the GSF path's shapes (or at `m` rows); with `seeds`, that
    many cases in one batch through `gsf_merge`'s vmap rule (one launch
    at seeds x 4096 rows, the GSF batch's), against the plain version on
    the folded rows."""
    import torch
    from wittgenstein_tpu_torch.ops.gsf_merge import gsf_merge, \
        gsf_merge_plain
    from wittgenstein_tpu_torch.ops.merge import fold_seeds
    if seeds is None:
        args, levels = gsf_merge_case(dev, rng, m)
        flat = args

        def kern_fn():
            return gsf_merge(*args, levels)
    else:
        cases = [gsf_merge_case(dev, rng) for _ in range(seeds)]
        levels = cases[0][1]
        args = [torch.stack(a) for a in zip(*(c[0] for c in cases))]
        flat = [fold_seeds(a, 0, seeds) for a in args]

        def kern_fn():
            return torch.func.vmap(gsf_merge, in_dims=(0,) * 10 + (None,))(
                *args, levels)

    def plain_fn():
        return gsf_merge_plain(*flat, levels)
    plain = plain_fn()
    kern = [k.reshape(p.shape) for k, p in zip(kern_fn(), plain)]
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"gsf_merge kernel differs from its plain version (max err "
             f"{err})")
    plain_n = plain_iters(plain_fn)
    return dict(err=err, ms=device_ms(kern_fn, "gsf_merge_kernel", cold()),
                warm_ms=device_ms(kern_fn, "gsf_merge_kernel"),
                plain_ms=device_ms(plain_fn, iters=plain_n),
                call_ms=call_ms(kern_fn),
                plain_call_ms=call_ms(plain_fn, iters=plain_n),
                nbytes=gsf_merge_bytes(flat, kern, levels),
                admitted_individuals=int((kern[4] != 0).sum()))


def phase_gsf_score(dev, rng, seeds=None, m=GSF_NODES):
    """K4 at the GSF path's shapes (or at `m` rows, W m / 32, the levels
    of m nodes); with `seeds`, a batch through `gsf_score`'s vmap rule
    (the node ids unbatched, as in the step), against the plain version
    on the folded rows.  Past 4,096 rows the planes are drawn on the
    card, and the kernel's branch (its template argument: the staged
    bulk-copy path or the ordinary loads) is read from the profiler's
    kernel name and logged."""
    import numpy as np
    import torch
    from wittgenstein_tpu_torch.ops.merge import fold_seeds
    from wittgenstein_tpu_torch.ops.score import gsf_score, gsf_score_plain
    q, w = 16, m // 32
    lead = () if seeds is None else (seeds,)

    def bits(*shape):
        if m > GSF_NODES:
            return card_bits(dev, rng, lead + shape)
        return torch.tensor(rng.integers(0, 2 ** 32, lead + shape,
                                         dtype=np.uint32).view(np.int32),
                            device=dev)
    args = [bits(m, q, w),
            torch.tensor(rng.integers(0, m.bit_length(), lead + (m, q)),
                         dtype=torch.int32, device=dev),
            torch.arange(m, dtype=torch.int32, device=dev),
            bits(m, w), bits(m, w)]
    if seeds is None:
        flat = args

        def kern_fn():
            return gsf_score(*args)
    else:
        dims = (0, 0, None, 0, 0)
        flat = [fold_seeds(a, d, seeds) for a, d in zip(args, dims)]

        def kern_fn():
            return torch.func.vmap(gsf_score, in_dims=dims)(*args)

    def plain_fn():
        return gsf_score_plain(*flat)
    plain = plain_fn()
    kern = [k.reshape(p.shape) for k, p in zip(kern_fn(), plain)]
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"gsf_score kernel differs from its plain version (max err "
             f"{err})")
    # Inputs: sig plane, levels, ids, two rows; outputs: four int32 and
    # two bool [M, Q]; M = all rows of the batch.
    m = flat[2].numel()
    nbytes = 4 * (m * q * w + m * q + m + 2 * m * w + 4 * m * q) + 2 * m * q
    # The wrapper launches one kernel: timed by its name, as the others,
    # so the flush's own spread is never subtracted.
    plain_n = plain_iters(plain_fn)
    branch = kernel_names(kern_fn, "gsf_score_kernel")
    log(f"gsf_score at M {m}, W {w}: kernel {branch}")
    return dict(err=err, ms=device_ms(kern_fn, "gsf_score_kernel", cold()),
                warm_ms=device_ms(kern_fn, "gsf_score_kernel"),
                plain_ms=device_ms(plain_fn, iters=plain_n),
                call_ms=call_ms(kern_fn),
                plain_call_ms=call_ms(plain_fn, iters=plain_n), nbytes=nbytes,
                branch=branch)


def kernel_names(fn, match):
    """The names of the CUDA kernels like `match` that one call of fn()
    launches, from torch.profiler (the template arguments included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and match in e.key})


def window_case(dev, rng, hz, n, c, f, m, lo=0, n_dest=None):
    """One K=2 window of sends at a scale path's shapes, drawn on the
    card (the ring is GBs): counts part full with eight full rows, the
    window's two rows cleared, arrivals t + [2, H], dests in [lo, lo +
    n_dest) of which those outside [0, N) (another sub-plane's) are
    invalid, 70% valid."""
    import torch
    g = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))
    t = 600

    def ints(a, b, shape):
        return torch.randint(a, b, shape, generator=g, dtype=torch.int32,
                             device=dev)
    ring = [ints(0, 1 << 20, (1, f, hz, n, c)), ints(0, n, (1, hz, n, c)),
            ints(0, 300, (1, hz, n, c)), ints(0, 4, (1, hz, n))]
    ring[3][:, :8] = c
    ring[3][:, t % hz:t % hz + 2] = 0
    dest = lo + ints(0, n_dest or n, (1, m))
    msg = [t + ints(2, hz + 1, (1, m)), dest, ints(0, n, (1, m)),
           ints(1, 300, (1, m)), ints(0, 1 << 20, (1, m, f)),
           (torch.rand((1, m), generator=g, device=dev) < 0.7) &
           (dest >= 0) & (dest < n)]
    return ring, msg


def phase_route_t3(dev, rng):
    """K1 at the tier-3 line's shapes: cardinal 65,536 nodes (H 256, C
    12, F 2), one K=2 window of 2 x 65,536 x 26 sends.  H*N is 16.8 M
    cells, so a bucket is 8,192 cells and its rank tables live in device
    scratch, not shared memory."""
    return phase_route(dev, rng, window_case, hz=256, n=T3_NODES, c=12,
                       f=2, m=2 * T3_NODES * 26)


def phase_route_t2(dev, rng):
    """K1 on one sub-plane of the tier-2 line's split ring: 16,384 of the
    32,768 nodes (H 256, C 12, F 3) and a K=2 window of 2 x 32,768 x 25
    sends, those to the other sub-plane shifted out of range."""
    ns = T2_NODES // 2
    return phase_route(dev, rng, window_case, hz=256, n=ns, c=12, f=3,
                       m=2 * T2_NODES * 25, lo=-ns, n_dest=T2_NODES)


def piece_case(dev, rng):
    """K2 on one q_sig piece of the tier-2 line: 16,384 rows (32,768
    nodes in two pieces), Q 16, S 12, W 1,024, 16 levels; the queue 70%
    full, 60% of inbox slots valid, planted duplicates within the inbox
    and against the queue (as `merge_case`), drawn on the card."""
    import torch
    m, q, s, w, n = T2_NODES // 2, 16, 12, T2_NODES // 32, T2_NODES
    g = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))

    def ints(a, b, shape):
        return torch.randint(a, b, shape, generator=g, dtype=torch.int32,
                             device=dev)

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev)
    q_from = torch.where(rand((m, q)) < 0.7, ints(0, n, (m, q)), -1)
    q_lvl = ints(0, 16, (m, q))
    src, level = ints(0, n, (m, s)), ints(0, 16, (m, s))
    pick = rand((m, s))
    cols = torch.arange(s, device=dev)
    prev = (ints(0, s, (m, s)) % cols.clamp_min(1)).long()
    dup = (pick < 0.3) & (cols > 0)
    src, level = (torch.where(dup, x.gather(1, prev), x)
                  for x in (src, level))
    qq = ints(0, q, (m, s)).long()
    hit = (pick >= 0.3) & (pick < 0.6) & (q_from.gather(1, qq) >= 0)
    src = torch.where(hit, q_from.gather(1, qq), src)
    level = torch.where(hit, q_lvl.gather(1, qq), level)
    return [q_from, q_lvl, ints(0, 2 * n, (m, q)), rand((m, q)) < 0.2,
            ints(-2 ** 31, 2 ** 31 - 1, (m, q, w)), src, level,
            ints(0, 2 * n, (m, s)), rand((m, s)) < 0.6,
            ints(-2 ** 31, 2 ** 31 - 1, (m, s, w))]


def phase_merge_t2(dev, rng):
    return phase_merge(dev, rng, make=piece_case)


def phase_score_t2(dev, rng):
    """K3 on the second q_sig piece of the tier-2 line: 16,384 rows of
    ids 16,384-32,767, Q 16, W 1,024, levels 0-15 (a level range spans
    up to 512 words)."""
    import torch
    m, q, w = T2_NODES // 2, 16, T2_NODES // 32
    g = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))

    def ints(a, b, shape):
        return torch.randint(a, b, shape, generator=g, dtype=torch.int32,
                             device=dev)
    args = [ints(-2 ** 31, 2 ** 31 - 1, (m, q, w)), ints(0, 16, (m, q)),
            m + torch.arange(m, dtype=torch.int32, device=dev)] + [
        ints(-2 ** 31, 2 ** 31 - 1, (m, w)) for _ in range(3)]
    return phase_score(dev, rng, args=args)


def phase_route_gsf_r4(dev, rng):
    """K1 on one ms of the GSF batch's sends: R 4, M = 4096 x 22 a seed."""
    return phase_route(dev, rng, hz=512, n=GSF_NODES, c=16, out_deg=22,
                       r=GSF_SEEDS, phases=False)


def phase_gsf_merge_r4(dev, rng):
    return phase_gsf_merge(dev, rng, seeds=GSF_SEEDS)


def phase_gsf_score_r4(dev, rng):
    return phase_gsf_score(dev, rng, seeds=GSF_SEEDS)


def phase_gsf_merge_32k(dev, rng):
    """K5 at GSF 32k's shapes: M 32,768, Q 16, S 16, W 1,024, L 16."""
    return phase_gsf_merge(dev, rng, m=G32_NODES)


def phase_gsf_score_32k(dev, rng):
    """K4 at GSF 32k's shapes: M 32,768, Q 16, W 1,024 (3 rows of 4 KB a
    stage: past the kernel's 5-KB stage, so the unstaged branch)."""
    return phase_gsf_score(dev, rng, m=G32_NODES)


#: K1 cases taken from the paths' own batches (`capture_route`), by
#: kernel entry name: (ring, messages) as the wrapper received them
ROUTE_CASES = {}


@contextlib.contextmanager
def capture_route(name, calls):
    """While active, of the route calls numbered in `calls` (0-based,
    counted from entry; one call a window and ring sub-plane) keep the
    one with the most valid messages in ROUTE_CASES[name]: its ring and
    messages cloned before the kernel writes.  Each of those calls reads
    its valid count back (the host waits for the card there, as the
    host-bound paths mostly do anyway); the launch counter counts every
    call once, as without the capture."""
    from wittgenstein_tpu_torch.core import network
    orig = network.bin_into_ring
    seen, best = [0], [-1]

    def wrapper(*args):
        if seen[0] in calls:
            n_valid = int(args[-1].sum())
            if n_valid > best[0]:
                best[0] = n_valid
                ROUTE_CASES.pop(name, None)
                ROUTE_CASES[name] = ([t.clone() for t in args[:4]],
                                     [t.clone() for t in args[4:]])
        seen[0] += 1
        return orig(*args)
    network.bin_into_ring = wrapper
    try:
        yield
    finally:
        network.bin_into_ring = orig


def phase_route_captured(name):
    """Phase-2 timing of K1 on the case captured from a path."""
    def phase(dev, rng):
        return phase_route(dev, rng, lambda dev, rng: ROUTE_CASES.pop(name),
                           phases=False)
    return phase


#: kernel entries of the ``kernels`` line: (name, wrapper key, path,
#: source, TPU kernel it replaces, phase-2 case)
KERNELS = [
    ("route", "route", "handel", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route),
    ("merge", "merge", "handel", "wittgenstein_tpu_torch/csrc/merge.cu",
     "wittgenstein_tpu/ops/pallas_merge.py:55", phase_merge),
    ("score", "score", "handel", "wittgenstein_tpu_torch/csrc/score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:46", phase_score),
    ("route_gsf", "route", "gsf", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_gsf),
    ("gsf_merge", "gsf_merge", "gsf",
     "wittgenstein_tpu_torch/csrc/gsf_merge.cu",
     "wittgenstein_tpu/ops/pallas_gsf_merge.py:51", phase_gsf_merge),
    ("gsf_score", "gsf_score", "gsf",
     "wittgenstein_tpu_torch/csrc/gsf_score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:94", phase_gsf_score),
    ("route_headline", "route", "headline",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_headline),
    ("merge_headline", "merge", "headline",
     "wittgenstein_tpu_torch/csrc/merge.cu",
     "wittgenstein_tpu/ops/pallas_merge.py:55", phase_merge_headline),
    ("score_headline", "score", "headline",
     "wittgenstein_tpu_torch/csrc/score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:46", phase_score_headline),
    ("route_pingpong", "route", "pingpong_harness",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_pingpong),
    ("route_drain", "route", "spill", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_drain),
    ("route_gsf_r4", "route", "gsf_batch",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_gsf_r4),
    ("gsf_merge_r4", "gsf_merge", "gsf_batch",
     "wittgenstein_tpu_torch/csrc/gsf_merge.cu",
     "wittgenstein_tpu/ops/pallas_gsf_merge.py:51", phase_gsf_merge_r4),
    ("gsf_score_r4", "gsf_score", "gsf_batch",
     "wittgenstein_tpu_torch/csrc/gsf_score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:94", phase_gsf_score_r4),
    ("route_t3", "route", "t3", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_t3),
    ("route_t2", "route", "t2", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_t2),
    ("merge_t2", "merge", "t2", "wittgenstein_tpu_torch/csrc/merge.cu",
     "wittgenstein_tpu/ops/pallas_merge.py:55", phase_merge_t2),
    ("score_t2", "score", "t2", "wittgenstein_tpu_torch/csrc/score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:46", phase_score_t2),
    ("route_sanfermin", "route", "sanfermin",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_sanfermin")),
    ("route_dfinity", "route", "dfinity",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_dfinity")),
    ("route_p2pflood", "route", "quiet_p2pflood",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_p2pflood")),
    ("route_casper", "route", "casper",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_casper")),
    ("route_ethpow", "route", "ethpow",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_ethpow")),
    ("route_byz", "route", "byz", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_byz")),
    ("merge_byz", "merge", "byz", "wittgenstein_tpu_torch/csrc/merge.cu",
     "wittgenstein_tpu/ops/pallas_merge.py:55", phase_merge_byz),
    ("score_byz", "score", "byz", "wittgenstein_tpu_torch/csrc/score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:46", phase_score_byz),
    ("route_optimistic", "route", "optimistic",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_optimistic")),
    ("route_p2phandel_city", "route", "p2phandel_city",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_p2phandel_city")),
    ("gsf_merge_32k", "gsf_merge", "gsf32k",
     "wittgenstein_tpu_torch/csrc/gsf_merge.cu",
     "wittgenstein_tpu/ops/pallas_gsf_merge.py:51", phase_gsf_merge_32k),
    ("gsf_score_32k", "gsf_score", "gsf32k",
     "wittgenstein_tpu_torch/csrc/gsf_score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:94", phase_gsf_score_32k),
    ("route_gsf32k", "route", "gsf32k",
     "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154",
     phase_route_captured("route_gsf32k")),
]
#: the kernel entries whose case is captured from their path's run
#: (`capture_route`) and timed right after it, not in phase 2
CAPTURED = ("route_sanfermin", "route_dfinity", "route_p2pflood",
            "route_casper", "route_ethpow", "route_byz",
            "route_optimistic", "route_p2phandel_city", "route_gsf32k")
#: the launches each path's run must make, by wrapper (others: none).
#: The per-ms paths launch each kernel once a simulated ms; the headline
#: bins once a K=2 window, merges every ms and scores on the
#: verification ms (t = 1 mod pairing 4), each launch for all seeds.
#: The scale lines run one seed at K=2 with phase hints: T3 (cardinal)
#: bins once a window and has no K2 or K3 (its count follows its stop
#: time, set when it has run); T2 bins once a window per
#: ring sub-plane (2) and merges every ms and scores on the verification
#: ms once per q_sig piece (2).  The attacked Handel runs per ms.
#: PingPong bins its pongs once a ms; the spill probe bins twice a ms
#: (the drain, then the sends).  The PingPong harness bins once a K=2
#: window for all seeds, so its count follows its stop time (set when
#: it has run).  The GSF batch bins once a window (K=1, then K=2) and
#: merges and scores every ms, each launch for all 4 seeds.  A
#: fast-forward run launches on the ms it steps only: the counts of
#: those paths follow their skip counts (set when they have run).
#: SanFermin bins once a K=2 window per ring sub-plane (2); Dfinity, its
#: quiet batch and P2PFlood's once a window.
PATH_LAUNCHES = {
    "handel": {"route": MAIN_MS, "merge": MAIN_MS, "score": MAIN_MS},
    "gsf": {"route": GSF_MS, "gsf_merge": GSF_MS, "gsf_score": GSF_MS},
    "headline": {"route": HEADLINE_MS // 2, "merge": HEADLINE_MS,
                 "score": HEADLINE_MS // 4},
    "pingpong": {"route": PP_MS},
    "spill": {"route": 2 * SPILL_MS},
    "gsf_batch": {"route": GSF_BATCH_MS, "gsf_merge": GSF_BATCH_MS,
                  "gsf_score": GSF_BATCH_MS},
    "gsf_batch_k2": {"route": GSF_BATCH_MS // 2, "gsf_merge": GSF_BATCH_MS,
                     "gsf_score": GSF_BATCH_MS},
    "t2": {"route": 2 * (T2_MS // 2), "merge": 2 * T2_MS,
           "score": 2 * (T2_MS // 4)},
    "attack": {"route": ATTACK_MS, "merge": ATTACK_MS,
               "score": ATTACK_MS},
    "sanfermin": {"route": SF_BOX_SPLIT * (SF_MS // 2)},
    "dfinity": {"route": D_TICKS // 2},
    "gsf32k": {"route": G32_MS[-1], "gsf_merge": G32_MS[-1],
               "gsf_score": G32_MS[-1]},
    "obs_metrics": {"route": 24},
    "obs_trace": {"route": 40},
    "obs_audit": {"route": 40},
    "chaos_headline": {"route": X_MS[-1] // 2, "merge": X_MS[-1],
                       "score": X_MS[-1] // 4},
    "chaos_checkpoint": {"route": (2 * X2_MS - X2_CHUNK) // 2},
    "chaos_freeze": {"route": X3_MS // 2}}


# ------------------------------------------------------------- main path


def counters():
    from wittgenstein_tpu_torch.ops.gsf_merge import gsf_merge
    from wittgenstein_tpu_torch.ops.merge import merge_queue
    from wittgenstein_tpu_torch.ops.route import bin_into_ring
    from wittgenstein_tpu_torch.ops.score import gsf_score, score_queue
    return {"route": bin_into_ring, "merge": merge_queue,
            "score": score_queue, "gsf_merge": gsf_merge,
            "gsf_score": gsf_score}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def check_digest(what, got, want):
    bad = sorted(k for k in set(got) | set(want)
                 if got.get(k) != want.get(k))
    if bad:
        fail(f"{what} differs from the JAX golden in {len(bad)} leaves, "
             f"first {bad[:5]}")


def drive(proto, ms, mid=None):
    """Run `proto` from seed 0 for `ms` ms through `Runner.run_ms`, every
    launch counter set to 0 just before.  Returns the run's numbers,
    the launch counts, the final state as numpy dicts and, with `mid`,
    the state digest at `mid` ms (taken outside the timed wall)."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    net, ps = proto.init(0)
    runner = Runner(proto)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    wall, mid_digest = 0.0, None
    for part in ((mid, ms - mid) if mid else (ms,)):
        t0 = time.perf_counter()
        net, ps = runner.run_ms(net, ps, part)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        if mid_digest is None and mid:
            mid_digest = convert.state_digest(*convert.to_numpy(net, ps))
    launches = read_counters()
    down = net.nodes.down
    frac = float((net.nodes.done_at[~down] > 0).float().mean())
    res = dict(wall_s=wall, sim_ms_per_s=ms / wall, frac_done=frac,
               dropped=int(net.dropped), clamped=int(net.clamped),
               bc_dropped=int(net.bc_dropped), evicted=int(ps.evicted),
               time=int(net.time),
               msg_sent=int(net.nodes.msg_sent.sum()),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    return res, launches, convert.to_numpy(net, ps), mid_digest


def check_launches(path, launches):
    """The path's kernels launched as PATH_LAUNCHES says, the others
    not at all."""
    for name, count in launches.items():
        want = PATH_LAUNCHES[path].get(name, 0)
        if count != want:
            fail(f"{path} path: kernel {name} launched {count} times, "
                 f"want {want}")


def main_path(dev):
    """1000 ms of the reference-default Handel, seed 0, through the
    entry points a user calls."""
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    return drive(Handel(**reference_default_params(N_NODES), device=dev),
                 MAIN_MS, GOLDEN_MS)


def gsf_path(dev):
    """600 ms of `GSFSignature(node_count=4096)` with its defaults, seed
    0, through the entry points a user calls."""
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    return drive(GSFSignature(node_count=GSF_NODES, device=dev), GSF_MS,
                 GSF_MS // 4)


def determinism(what, proto, ms, want, audit=None):
    """Seed 0 again, to `ms` ms: its state digest equals `want`, the
    first run's at `ms`.  With `audit` (an `obs.AuditSpec`) the rerun
    runs under the audit plane, which must be clean and issue no more
    synchronising calls than the engine without it."""
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    runner = Runner(proto, audit=audit)
    net, ps = runner.run_ms(*proto.init(0), ms)
    check_digest(f"{what} seed 0 run twice, at {ms} ms",
                 convert.state_digest(*convert.to_numpy(net, ps)), want)
    log(f"{what} determinism: two runs of seed 0 identical at {ms} ms")
    if audit is not None:
        from wittgenstein_tpu_torch.core.network import scan_chunk
        from wittgenstein_tpu_torch.obs import scan_chunk_audit
        report = runner.audit_report()
        if not report.clean or "ring_conservation" not in report.claimed:
            fail(f"{what} rerun's audit is not clean: {report.format()}")
        log(f"{what} rerun under the audit plane: {report.format()}; "
            f"totals {report.totals_dict()}")
        check_syncs(what, scan_chunk(proto, SYNC_MS),
                    plane_result(scan_chunk_audit(proto, SYNC_MS, audit)),
                    (net, ps), ms)


def golden_and_determinism(dev, mid_digest):
    """The Handel path's state at 200 ms (`mid_digest`) against the JAX
    golden digest; seed 0 run again to 200 ms equals it."""
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    path = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_handel2048_200ms.json")
    with open(path) as f:
        golden = json.load(f)
    if golden["ms"] != GOLDEN_MS:
        fail(f"golden file is for {golden['ms']} ms, not {GOLDEN_MS}")
    check_digest(f"state at {GOLDEN_MS} ms", mid_digest, golden["leaves"])
    log(f"golden: all {len(golden['leaves'])} leaves match the JAX "
        f"reference at {GOLDEN_MS} ms")
    determinism("Handel", Handel(**reference_default_params(N_NODES),
                                 device=dev), GOLDEN_MS, mid_digest)


def gsf_golden_and_determinism(dev, final_np, mid_digest):
    """The GSF path's state at 600 ms against the JAX golden digest;
    seed 0 run again to 150 ms equals the path's state there
    (`mid_digest`)."""
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    with open(GSF_GOLDEN) as f:
        golden = json.load(f)
    if golden["ms"] != GSF_MS:
        fail(f"GSF golden file is for {golden['ms']} ms, not {GSF_MS}")
    check_digest(f"GSF state at {GSF_MS} ms",
                 convert.state_digest(*final_np), golden["leaves"])
    log(f"GSF golden: all {len(golden['leaves'])} leaves match the JAX "
        f"reference at {GSF_MS} ms (JAX counts {golden['counts']})")
    from wittgenstein_tpu_torch.obs import AuditSpec
    determinism("GSF", GSFSignature(node_count=GSF_NODES, device=dev),
                GSF_MS // 4, mid_digest, audit=AuditSpec())


def headline_init(dev):
    """The headline's protocol and batch: 16 seeds of the 2048-node
    reference-default Handel, as `bench_torch.py` builds them."""
    import torch
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    proto = Handel(**reference_default_params(N_NODES), device=dev)
    return proto, init_batched(proto, torch.arange(HEADLINE_SEEDS))


def headline_run(dev, golden=None, ms=HEADLINE_MS, metrics=None):
    """The benchmark headline through `bench_torch.py`'s path: `ms` in
    200-ms chunks of `scan_chunk_batched` (superstep 2, t0_mod 0), every
    launch counter set to 0 just before.  With `golden` (the JAX
    package's per-seed digests at 200 ms) every seed's state is checked
    after the first chunk, outside the timed wall.  With `metrics` (an
    `obs.MetricsSpec`) the chunks run under the metrics plane
    (`scan_chunk_batched_metrics`), their carries kept in
    ``res["carries"]`` with the final state.  Returns the run's numbers,
    the launch counts, each seed's final digest and, with `golden`, each
    seed's digest at 200 ms."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.obs import scan_chunk_batched_metrics
    proto, (nets, ps) = headline_init(dev)
    impact = None
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves((nets, ps)))
    if metrics is None:
        run = scan_chunk_batched(proto, HEADLINE_CHUNK, t0_mod=0,
                                 superstep=2)
    else:
        run = plane_result(scan_chunk_batched_metrics(
            proto, HEADLINE_CHUNK, metrics, superstep=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    wall, first, carries, walls = 0.0, None, [], []
    for i in range(ms // HEADLINE_CHUNK):
        t0 = time.perf_counter()
        nets, ps = run(nets, ps, t=i * HEADLINE_CHUNK)
        if metrics is not None:
            carries.append(run.carry)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        wall += walls[-1]
        if golden is not None and i == 0:
            first = check_headline_golden(golden, nets, ps)
            from wittgenstein_tpu_torch.chaos import impact_summary
            impact = impact_summary(nets)
    launches = read_counters()
    frac = [float((nets.nodes.done_at[r][~nets.nodes.down[r]] > 0)
                  .float().mean()) for r in range(HEADLINE_SEEDS)]
    res = dict(wall_s=wall, chunk_walls_s=walls, sim_ms_per_s=ms / wall,
               agg_sim_ms_per_s=HEADLINE_SEEDS * ms / wall,
               frac_done=sum(frac) / len(frac), frac_done_min=min(frac),
               dropped=int(nets.dropped.sum()),
               clamped=int(nets.clamped.sum()),
               bc_dropped=int(nets.bc_dropped.sum()),
               evicted=int(ps.evicted.sum()), time=nets.time.tolist(),
               msg_sent=int(nets.nodes.msg_sent.sum()),
               state_bytes=state_bytes,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    if impact is not None:
        res[f"impact_{HEADLINE_CHUNK}ms"] = impact
    if metrics is not None:
        res["carries"], res["state"] = carries, (nets, ps)
    return (res, launches, convert.seed_digests(*convert.to_numpy(nets, ps)),
            first)


def check_headline_golden(golden, nets, ps):
    """Every seed against the JAX golden digests; returns their digests."""
    from wittgenstein_tpu_torch import convert
    got = convert.seed_digests(*convert.to_numpy(nets, ps))
    for r, (g, w) in enumerate(zip(got, golden["seeds"])):
        check_digest(f"headline seed {r} at {golden['ms']} ms", g, w)
    log(f"headline golden: all {len(got)} seeds match the JAX reference "
        f"at {golden['ms']} ms, {len(got[0])} leaves each")
    return got


def headline_determinism(dev, first, digests, dense_final_np):
    """A second headline run to 200 ms: every seed equals the first run's
    state there (`first`); the first run's seed 0 at 1000 ms (`digests`)
    equals the dense path's state of phase 3."""
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.obs import (MetricsFrame, MetricsSpec,
                                            scan_chunk_batched_metrics)
    spec = MetricsSpec(stat_each_ms=HEADLINE_STAT_MS)
    res, _, again, _ = headline_run(dev, ms=HEADLINE_CHUNK, metrics=spec)
    bad = [r for r, (a, b) in enumerate(zip(first, again)) if a != b]
    if bad:
        fail(f"headline run twice differs in seeds {bad}")
    log(f"headline determinism: two runs identical at {HEADLINE_CHUNK} ms "
        f"(second run, under the metrics plane, wall {res['wall_s']:.3f} "
        "s)")
    frame = MetricsFrame.from_carries(spec, res["carries"])
    check_metrics_totals("headline rerun", frame, *res["state"],
                         HEADLINE_SEEDS * HEADLINE_CHUNK)
    proto, _ = headline_init(dev)
    check_syncs("headline", scan_chunk_batched(proto, SYNC_MS, superstep=2),
                plane_result(scan_chunk_batched_metrics(proto, SYNC_MS, spec,
                                                        superstep=2)),
                res["state"], HEADLINE_CHUNK)
    if digests[0] != convert.state_digest(*dense_final_np):
        fail("headline seed 0 differs from the dense path's state at "
             f"{HEADLINE_MS} ms")
    log(f"headline seed 0 equals the dense path's state at {HEADLINE_MS} ms")


def pingpong_run(dev, ms=PP_MS, trace=None):
    """`PingPong(1000)`, seed 0, through `Runner.run_ms` in 100-ms steps
    to `ms`, every launch counter set to 0 just before; with `trace` (an
    `obs.TraceSpec`) under the flight recorder (``Runner(trace=)``, its
    frame and final state kept in ``res``).  Returns the run's numbers
    (the pong curve among them), the launch counts, the state digest
    after each step and the final state as numpy dicts."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=PP_NODES, device=dev)
    net, ps = proto.init(0)
    runner = Runner(proto, trace=trace)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    curve, digests, wall = [], {}, 0.0
    for t in range(100, ms + 1, 100):
        t0 = time.perf_counter()
        net, ps = runner.run_ms(net, ps, 100)
        curve.append(int(ps.pongs))
        wall += time.perf_counter() - t0
        digests[t] = convert.state_digest(*convert.to_numpy(net, ps))
    launches = read_counters()
    res = dict(wall_s=wall, sim_ms_per_s=ms / wall, pongs=curve,
               dropped=int(net.dropped), bc_dropped=int(net.bc_dropped),
               clamped=int(net.clamped), time=int(net.time),
               msg_sent=int(net.nodes.msg_sent.sum()),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    if trace is not None:
        res["frame"], res["state"] = runner.trace_frame(), (net, ps)
    return res, launches, digests, convert.to_numpy(net, ps)


def check_pingpong(res):
    """tests/test_pingpong.py's curve, and nothing dropped or clamped."""
    c = res["pongs"]
    if not (80 < c[0] < 400 and 500 < c[2] <= 1000 and c[-1] == PP_NODES
            and c == sorted(c)):
        fail(f"PingPong's pong curve is off the reference's: {c}")
    if res["dropped"] or res["bc_dropped"] or res["clamped"]:
        fail(f"PingPong drops/broadcast drops/clamps must be 0: {res}")


def pingpong_golden_and_determinism(dev, res, digests):
    """The first run's curve and state at 800 ms against the JAX golden;
    seed 0 again to 400 ms equals the first run there."""
    with open(PP_GOLDEN) as f:
        golden = json.load(f)
    if golden["ms"] != PP_MS:
        fail(f"PingPong golden is for {golden['ms']} ms, not {PP_MS}")
    if res["pongs"] != golden["counts"]["pongs"]:
        fail(f"PingPong curve {res['pongs']} differs from the JAX run's "
             f"{golden['counts']['pongs']}")
    check_digest(f"PingPong state at {PP_MS} ms", digests[PP_MS],
                 golden["leaves"])
    log(f"PingPong golden: all {len(golden['leaves'])} leaves match the "
        f"JAX reference at {PP_MS} ms, curve {res['pongs']}")
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    from wittgenstein_tpu_torch.obs import TraceSpec, scan_chunk_trace
    spec = TraceSpec(capacity=PP_TRACE_CAP)
    rres, _, again, _ = pingpong_run(dev, PP_MS // 2, trace=spec)
    if again[PP_MS // 2] != digests[PP_MS // 2]:
        fail("PingPong seed 0 run twice differs")
    log(f"PingPong determinism: two runs of seed 0 identical at "
        f"{PP_MS // 2} ms (the second under the flight recorder)")
    check_trace_accounting("PingPong rerun", rres["frame"], *rres["state"],
                           PP_NODES)
    proto = PingPong(node_count=PP_NODES, device=dev)
    check_syncs("PingPong", scan_chunk(proto, SYNC_MS),
                plane_result(scan_chunk_trace(proto, SYNC_MS, spec)),
                rres["state"], PP_MS // 2)


def pingpong_harness(dev, dense_digests):
    """`run_multiple_times(PingPong(1000), 16, chunk=200)` until every
    run is done, counters set to 0 just before; then the same 16 seeds
    for one 200-ms chunk against the JAX golden digests; seed 0 at its
    stop time against the per-ms run's state at that ms."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.harness import run_multiple_times
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=PP_NODES, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    out = run_multiple_times(proto, PP_SEEDS, chunk=PP_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    stop = out.stopped_at.tolist()
    res = dict(wall_s=wall, sim_ms=max(stop), stopped_at=stop,
               agg_sim_ms_per_s=sum(stop) / wall,
               pongs=out.pstates.pongs.tolist(),
               dropped=int(out.nets.dropped.sum()),
               bc_dropped=int(out.nets.bc_dropped.sum()),
               clamped=int(out.nets.clamped.sum()),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    if min(stop) <= 0 or res["pongs"] != [PP_NODES] * PP_SEEDS:
        fail(f"PingPong harness: every run must stop with {PP_NODES} "
             f"pongs: {res}")
    if res["dropped"] or res["bc_dropped"] or res["clamped"]:
        fail(f"PingPong harness drops/clamps must be 0: {res}")
    PATH_LAUNCHES["pingpong_harness"] = {"route": max(stop) // 2}
    seed0 = convert.seed_digests(*convert.to_numpy(out.nets, out.pstates),
                                 seeds=[0])[0]
    if stop[0] not in dense_digests or seed0 != dense_digests[stop[0]]:
        fail(f"PingPong harness seed 0 at {stop[0]} ms differs from the "
             "per-ms run's state")
    log(f"PingPong harness seed 0 equals the per-ms run at {stop[0]} ms")
    del out
    with open(PP_HARNESS_GOLDEN) as f:
        golden = json.load(f)
    if golden["ms"] != PP_CHUNK or len(golden["seeds"]) != PP_SEEDS:
        fail(f"PingPong harness golden is for {len(golden['seeds'])} seeds "
             f"at {golden['ms']} ms, not {PP_SEEDS} at {PP_CHUNK}")
    first = run_multiple_times(proto, PP_SEEDS, max_time=PP_CHUNK,
                               chunk=PP_CHUNK)
    got = convert.seed_digests(*convert.to_numpy(first.nets,
                                                 first.pstates))
    for r, (g, w) in enumerate(zip(got, golden["seeds"])):
        check_digest(f"PingPong harness seed {r} at {PP_CHUNK} ms", g, w)
    log(f"PingPong harness golden: all {PP_SEEDS} seeds match the JAX "
        f"reference at {PP_CHUNK} ms, {len(got[0])} leaves each")
    return res, launches


class SpillProbe:
    """The JAX engine tests' probe (tests/test_engine.py `OneShot`) with
    a spill buffer: 4 nodes, fixed 10-ms latency, horizon 64; node 0
    (every node i, with `all_send`, to i + 1) sends one unicast at t = 0
    with delay 500, far past the ring; every node counts what it gets
    and notes when it first got something."""

    def __init__(self, dev, spill_cap, all_send=False):
        from wittgenstein_tpu_torch.core.latency import NetworkFixedLatency
        from wittgenstein_tpu_torch.core.state import EngineConfig
        self.dev, self.all_send = dev, all_send
        self.latency = NetworkFixedLatency(10)
        self.cfg = EngineConfig(n=4, horizon=64, inbox_cap=4,
                                payload_words=2, out_deg=1, bcast_slots=2,
                                spill_cap=spill_cap)

    def init(self, seed):
        import torch
        from wittgenstein_tpu_torch.core.builders import NodeBuilder
        from wittgenstein_tpu_torch.core.state import init_net
        seed = torch.tensor(seed, dtype=torch.int32, device=self.dev)
        n = self.cfg.n
        return init_net(self.cfg, NodeBuilder().build(seed, n, self.dev),
                        seed), {
            "got": torch.zeros(n, dtype=torch.int32, device=self.dev),
            "when": torch.full((n,), -1, dtype=torch.int32,
                               device=self.dev)}

    def step(self, pstate, nodes, inbox, t):
        import torch
        from wittgenstein_tpu_torch.core.state import empty_outbox
        n, dev = self.cfg.n, self.dev
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        sender = (ids >= 0) if self.all_send else (ids == 0)
        dest = (ids + 1) % n if self.all_send else torch.ones_like(ids)
        out = empty_outbox(self.cfg, dev).replace(
            dest=torch.where(sender & (t == 0), dest, -1)[:, None],
            size=torch.full((n, 1), 7, dtype=torch.int32, device=dev),
            delay=torch.full((n, 1), 500, dtype=torch.int32, device=dev))
        got = inbox.valid.sum(1, dtype=torch.int32)
        return {"got": pstate["got"] + got,
                "when": torch.where((got > 0) & (pstate["when"] < 0), t,
                                    pstate["when"])}, nodes, out


def spill_path(dev):
    """The spill scenarios of the JAX engine and route tests on the card:
    exact delivery through 8 slots (counters reset just before; route
    twice a ms), the 4-into-2 overflow, and two seeds of the first
    through the harness at K = 1."""
    from wittgenstein_tpu_torch.core.harness import run_multiple_times
    from wittgenstein_tpu_torch.core.network import Runner
    proto = SpillProbe(dev, 8)
    net, p = proto.init(0)
    reset_counters()
    t0 = time.perf_counter()
    net, p = Runner(proto).run_ms(net, p, SPILL_MS)
    res = dict(when=p["when"].tolist(), got=p["got"].tolist(),
               wall_s=time.perf_counter() - t0, clamped=int(net.clamped),
               sp_dropped=int(net.sp_dropped), dropped=int(net.dropped),
               parked=int((net.sp_arrival >= 0).sum()))
    launches = read_counters()
    if res["when"][1] != 511 or sum(res["got"]) != 1 or res["clamped"] or \
            res["sp_dropped"] or res["dropped"] or res["parked"]:
        fail(f"spill: the far send must deliver at exactly 511: {res}")
    over = SpillProbe(dev, 2, all_send=True)
    net, p = Runner(over).run_ms(*over.init(0), SPILL_MS)
    res["overflow_got"] = p["got"].tolist()
    if int(net.sp_dropped) != 2 or res["overflow_got"] != [0, 1, 1, 0]:
        fail(f"spill overflow: want sp_dropped 2 and got [0, 1, 1, 0], have "
             f"{int(net.sp_dropped)} and {res['overflow_got']}")
    before = read_counters()["route"]
    multi = run_multiple_times(proto, 2, max_time=SPILL_MS, chunk=10)
    res["harness_when"] = multi.pstates["when"][:, 1].tolist()
    res["harness_route_launches"] = read_counters()["route"] - before
    if res["harness_when"] != [511, 511] or \
            res["harness_route_launches"] != 2 * SPILL_MS:
        fail(f"spill harness at K = 1: want delivery at 511 in both seeds "
             f"and route twice a ms for both: {res}")
    return res, launches


def load_golden(path, ms, seeds):
    with open(path) as f:
        golden = json.load(f)
    if golden["ms"] != ms or len(golden["seeds"]) != seeds:
        fail(f"{path} is for {len(golden['seeds'])} seeds at {golden['ms']} "
             f"ms, not {seeds} at {ms}")
    return golden


def check_seed_goldens(what, nets, ps, golden):
    from wittgenstein_tpu_torch import convert
    got = convert.seed_digests(*convert.to_numpy(nets, ps))
    for r, (g, w) in enumerate(zip(got, golden["seeds"])):
        check_digest(f"{what} seed {r} at {golden['ms']} ms", g, w)
    log(f"{what}: all {len(got)} seeds match the JAX reference at "
        f"{golden['ms']} ms, {len(got[0])} leaves each")


def gsf_batch_run(dev, k):
    """GSF 4096, seeds 0-3 in one batch, to 100 ms in one chunk: K=1
    on the harness's engine (`network.scan_chunk` on the batch), K=2 on
    the seed-folded engine (`scan_chunk_batched`); counters set to 0
    just before the run, the peak taken from before the batch is built.
    Every seed is checked against the JAX golden digests after the
    timed wall."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    golden = load_golden(GSF_BATCH_GOLDEN, GSF_BATCH_MS, GSF_SEEDS)
    proto = GSFSignature(node_count=GSF_NODES, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nets, ps = init_batched(proto, torch.arange(GSF_SEEDS))
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves((nets, ps)))
    run = (scan_chunk(proto, GSF_CHUNK) if k == 1 else
           scan_chunk_batched(proto, GSF_CHUNK, superstep=k))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    for i in range(GSF_BATCH_MS // GSF_CHUNK):
        nets, ps = run(nets, ps, t=i * GSF_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    frac = [float((nets.nodes.done_at[r][~nets.nodes.down[r]] > 0)
                  .float().mean()) for r in range(GSF_SEEDS)]
    res = dict(superstep=k, wall_s=wall, sim_ms_per_s=GSF_BATCH_MS / wall,
               agg_sim_ms_per_s=GSF_SEEDS * GSF_BATCH_MS / wall,
               frac_done=frac,
               dropped=int(nets.dropped.sum()),
               clamped=int(nets.clamped.sum()),
               evicted=int(ps.evicted.sum()), time=nets.time.tolist(),
               state_bytes=state_bytes,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    if res["dropped"] or res["clamped"]:
        fail(f"GSF batch at K={k}: drops and clamps must be 0: {res}")
    check_seed_goldens(f"GSF batch at K={k}", nets, ps, golden)
    return res, launches


def oracle_ms(proto, nets, ps, t):
    """Host ms of one read of the fast-forward oracle (`next_work` and
    its `int`) with the card idle: the oracle's own ops and one
    synchronisation, the mean of ITERS reads.  In the loop a read also
    waits for whatever of the window the card has not finished."""
    import torch
    from wittgenstein_tpu_torch.core.network import next_work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        int(next_work(proto, nets, ps, t))
    return (time.perf_counter() - t0) / ITERS * 1e3


def ff_headline(dev, dense_wall):
    """Path F(a): the headline's 16 seeds on `fast_forward_chunk_batched`
    (K=2, no phase hints) to 200 ms, beside the dense headline chunk
    (phase hints, as `bench_torch.py` runs it: `dense_wall` is phase 5's
    first 200-ms chunk); counters set to 0 just before the fast-forward
    run.  Every seed equals the JAX golden digests at 200 ms."""
    import torch
    from wittgenstein_tpu_torch.core.batched import \
        fast_forward_chunk_batched
    golden = load_golden(HEADLINE_GOLDEN, FF_MS, HEADLINE_SEEDS)
    proto, (nets, ps) = headline_init(dev)
    run = fast_forward_chunk_batched(proto, FF_MS, superstep=2)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    nets, ps, stats = run(nets, ps, t=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    stepped = FF_MS - stats["skipped_ms"]
    PATH_LAUNCHES["ff_headline"] = {"route": stepped // 2, "merge": stepped,
                                    "score": stepped}
    res = dict(wall_s=wall, dense_wall_s=dense_wall, **stats,
               skip_rate=stats["skipped_ms"] / FF_MS, stepped_ms=stepped,
               oracle_ms=oracle_ms(proto, nets, ps, FF_MS),
               dropped=int(nets.dropped.sum()),
               clamped=int(nets.clamped.sum()),
               evicted=int(ps.evicted.sum()))
    check_seed_goldens("fast-forwarded headline", nets, ps, golden)
    return res, launches


def ff_pingpong(dev, dense_wall):
    """Path F(b): `PingPong(1000)`, seed 0, through `Runner(fast_forward=
    True)` in 100-ms calls to 800 ms, counters set to 0 just before;
    its state equals the JAX golden, its skip counts the JAX engine's,
    and something is skipped.  `dense_wall` is phase 6's run of the same
    calls on the dense engine."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    with open(PP_GOLDEN) as f:
        golden = json.load(f)
    with open(FF_STATS) as f:
        want = json.load(f)["runner"]
    proto = PingPong(node_count=PP_NODES, device=dev)
    net, ps = proto.init(0)
    runner = Runner(proto, fast_forward=True)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(PP_MS // 100):
        net, ps = runner.run_ms(net, ps, 100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    stats = runner.ff_stats()
    check_digest(f"fast-forwarded PingPong at {PP_MS} ms",
                 convert.state_digest(*convert.to_numpy(net, ps)),
                 golden["leaves"])
    got = {k: stats[k] for k in ("skipped_ms", "jump_count")}
    if got != {k: want[k] for k in got}:
        fail(f"fast-forwarded PingPong skips {got}, the JAX engine "
             f"{want}")
    if not stats["skipped_ms"] > 0:
        fail("fast-forwarded PingPong skipped nothing")
    PATH_LAUNCHES["ff_pingpong"] = {"route": PP_MS - stats["skipped_ms"]}
    log(f"fast-forwarded PingPong equals the JAX golden at {PP_MS} ms and "
        f"skips as the JAX engine does: {got}")
    return dict(wall_s=wall, dense_wall_s=dense_wall, **stats,
                skip_rate=stats["skipped_ms"] / PP_MS,
                oracle_ms=oracle_ms(proto, net, ps, PP_MS),
                pongs=int(ps.pongs)), launches


def ff_pingpong_batch(dev):
    """Path F(c): 16 PingPong(1000) seeds through `fast_forward_chunk(
    seed_axis=True, superstep=2)` to 200 ms, beside the dense K=2 chunk
    on a fresh batch; counters set to 0 just before the fast-forward
    run.  Every seed equals the JAX golden digests, the skip counts the
    JAX engine's."""
    import torch
    from wittgenstein_tpu_torch.core.network import fast_forward_chunk, \
        scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    golden = load_golden(PP_HARNESS_GOLDEN, PP_CHUNK, PP_SEEDS)
    with open(FF_STATS) as f:
        want = json.load(f)["seed_axis"]
    proto = PingPong(node_count=PP_NODES, device=dev)
    nets, ps = init_batched(proto, torch.arange(PP_SEEDS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nets, ps = scan_chunk(proto, PP_CHUNK, superstep=2)(nets, ps, t=0)
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    del nets, ps
    nets, ps = init_batched(proto, torch.arange(PP_SEEDS))
    run = fast_forward_chunk(proto, PP_CHUNK, seed_axis=True, superstep=2)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    nets, ps, stats = run(nets, ps, t=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    check_seed_goldens("fast-forwarded PingPong batch", nets, ps, golden)
    if stats != {k: want[k] for k in stats}:
        fail(f"fast-forwarded PingPong batch skips {stats}, the JAX engine "
             f"{want}")
    PATH_LAUNCHES["ff_pingpong_batch"] = {
        "route": (PP_CHUNK - stats["skipped_ms"]) // 2}
    return dict(wall_s=wall, dense_wall_s=dense_wall, **stats,
                skip_rate=stats["skipped_ms"] / PP_CHUNK,
                oracle_ms=oracle_ms(proto, nets, ps, PP_CHUNK)), launches


def scale_init(dev, line, seeds=1):
    """A scale line's protocol and seed batch: ``t3``, cardinal mode at
    65,536 nodes (`tier3_params`); ``t2``, exact mode at 32,768 nodes
    with the tier-2 switches (`tier2_params`, ring sub-planes
    `TIER2_BOX_SPLIT`)."""
    import dataclasses

    import torch
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.handel import (
        TIER2_BOX_SPLIT, Handel, tier2_params, tier3_params)
    if line == "t3":
        proto = Handel(**tier3_params(T3_NODES), device=dev)
    else:
        proto = Handel(**tier2_params(T2_NODES), device=dev)
        proto.cfg = dataclasses.replace(proto.cfg,
                                        box_split=TIER2_BOX_SPLIT)
    return proto, init_batched(proto, torch.arange(seeds))


def scale_run(dev, line):
    """A scale line through the seed-folded engine (K=2, phase hints,
    t0_mod 0), one seed, in chunks, every launch counter set to 0 just
    before; peak memory while the state is built (`init_batched` holds
    it and one seed's copy) and over the run, apart.  After
    each chunk that ends on a golden checkpoint the state is checked
    against the JAX digests, outside the timed wall.  T3 runs past its
    last golden until its live frac_done passes 0.99, which must happen
    by T3_MS (its launch count follows the stop); T2 runs to T2_MS.
    Zero drops, clamps and evictions for both."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.ops.merge import merge_queue
    path, chunk, ms = ((T3_GOLDEN, T3_CHUNK, T3_MS) if line == "t3" else
                       (T2_GOLDEN, T2_CHUNK, T2_MS))
    with open(path) as f:
        golden = json.load(f)["ms"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    proto, (nets, ps) = scale_init(dev, line)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves((nets, ps)))
    run = scan_chunk_batched(proto, chunk, t0_mod=0, superstep=2)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    word = merge_queue.word_launches
    live = ~nets.nodes.down[0]
    last = max(map(int, golden))
    walls = []
    for t in range(chunk, ms + 1, chunk):
        t0 = time.perf_counter()
        nets, ps = run(nets, ps, t=t - chunk)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        want = golden.get(str(t))
        if want is not None:
            got = convert.seed_digests(*convert.to_numpy(nets, ps))[0]
            check_digest(f"{line} at {t} ms", got,
                         want.get("leaves") or want["seeds"][0])
            log(f"{line} golden: all {len(got)} leaves match the JAX "
                f"reference at {t} ms (JAX counts {want['counts']})")
        frac = float((nets.nodes.done_at[0][live] > 0).float().mean())
        if line == "t3" and t >= last and frac > 0.99:
            break
    wall = sum(walls)
    launches = read_counters()
    if line == "t3":
        PATH_LAUNCHES["t3"] = {"route": t // 2}
    res = dict(wall_s=wall, chunk_walls_s=walls, sim_ms=t,
               sim_ms_per_s=t / wall, frac_done=frac,
               dropped=int(nets.dropped.sum()),
               clamped=int(nets.clamped.sum()),
               evicted=int(ps.evicted.sum()), time=int(nets.time[0]),
               msg_sent=int(nets.nodes.msg_sent.sum()),
               merge_word_launches=merge_queue.word_launches - word,
               state_bytes=state_bytes, init_peak_mem_bytes=init_peak,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    if res["dropped"] or res["clamped"] or res["evicted"]:
        fail(f"{line}: drops, clamps and evictions must be 0: {res}")
    if line == "t3" and not res["frac_done"] > 0.99:
        fail(f"t3 did not converge by {t} ms: live frac_done "
             f"{res['frac_done']}")
    return res, launches


def scale_memory(dev, line, seeds, ms):
    """Peak device memory of a scale line at `seeds` seeds
    (`--memory-seeds`): while the batch is built (`init_batched` holds
    the batch and one seed's state), and over its first `ms` ms."""
    import torch
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    proto, (nets, ps) = scale_init(dev, line, seeds)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nets, ps = scan_chunk_batched(proto, ms, t0_mod=0)(nets, ps, t=0)
    torch.cuda.synchronize()
    res = dict(seeds=seeds, ms=ms, wall_s=time.perf_counter() - t0,
               init_peak_mem_bytes=init_peak,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               dropped=int(nets.dropped.sum()),
               evicted=int(ps.evicted.sum()))
    log(f"{line} at {seeds} seeds: {json.dumps(res)}")
    return res


def attack_run(dev):
    """`Handel(**reference_default_params(1024), byzantine_suicide=True)`
    (the attacker controls its 102 down nodes), seed 0, through
    `Runner.run_ms` for ATTACK_MS ms, counters set to 0 just before:
    every leaf equal to the JAX golden, the suicide plants seen (honest
    blacklists filled), kernels once a ms."""
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    from wittgenstein_tpu_torch.ops import bitset
    with open(ATTACK_GOLDEN) as f:
        golden = json.load(f)
    if golden["ms"] != ATTACK_MS:
        fail(f"attack golden is for {golden['ms']} ms, not {ATTACK_MS}")
    proto = Handel(**reference_default_params(ATTACK_NODES),
                   byzantine_suicide=True, device=dev)
    res, launches, final_np, _ = drive(proto, ATTACK_MS)
    check_digest(f"attacked Handel at {ATTACK_MS} ms",
                 convert.state_digest(*final_np), golden["leaves"])
    net, ps = convert.from_reference(*final_np, "cpu")
    res["blacklisted"] = int(bitset.popcount(ps.blacklist).sum())
    if not res["blacklisted"] > 0:
        fail("byzantine_suicide planted nothing that was caught")
    log(f"attacked Handel: all {len(golden['leaves'])} leaves match the "
        f"JAX reference at {ATTACK_MS} ms")
    return res, launches


# ---------------------------------------------- the obs planes, GSF 32k


class plane_result:
    """A plane's chunk ``run(net, pstate, t) -> (net, pstate, carry)``
    as an engine chunk returning ``(net, pstate)``; the last carry is
    kept in `.carry`."""

    def __init__(self, run):
        self.run, self.carry = run, None

    def __call__(self, net, pstate, t=None):
        net, pstate, self.carry = self.run(net, pstate, t)
        return net, pstate


def sync_count(fn):
    """The synchronising CUDA calls fn() makes: the warnings
    `torch.cuda.set_sync_debug_mode("warn")` raises during it."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def check_syncs(what, plain, plane, state, t):
    """A plane adds no host read inside a chunk: the same SYNC_MS-ms
    chunk from a copy of `state` (at time `t`) with the plane (`plane`)
    issues no more synchronising calls than without it (`plain`).  Each
    is run once untimed first, so that neither is charged with the
    caching allocator's first growth (a cudaMalloc can synchronise)."""
    import torch
    from torch.utils import _pytree as pytree
    counts = []
    for fn in (plain, plane, plain, plane):
        copy = pytree.tree_map(torch.clone, state)
        counts.append(sync_count(lambda: fn(*copy, t=t)))
        del copy
    counts = counts[2:]
    if counts[1] > counts[0]:
        fail(f"{what}: the plane's chunk made {counts[1]} synchronising "
             f"calls over {SYNC_MS} ms, the engine's alone {counts[0]}")
    log(f"{what}: {counts[1]} synchronising calls over {SYNC_MS} ms under "
        f"the plane, {counts[0]} without")


def state_totals(net):
    """The audit plane's TOTALS (msg_sent, msg_received, drop_count,
    done_count) of a state or a seed batch, read from it."""
    import numpy as np
    nodes = net.nodes
    drops = sum(int(getattr(net, k).sum()) for k in
                ("dropped", "bc_dropped", "clamped", "sp_dropped"))
    return np.array([int(nodes.msg_sent.sum()),
                     int(nodes.msg_received.sum()), drops,
                     int(((~nodes.down) & (nodes.done_at > 0)).sum())])


def check_metrics_totals(what, frame, net, ps, samples):
    """`obs.cross_check_metrics` of a metrics frame against the totals
    the audit plane samples at a run's last window, which are its final
    state's (`state_totals`); every executed ms of every seed sampled."""
    import numpy as np
    from wittgenstein_tpu_torch.obs import (AuditReport, AuditSpec,
                                            cross_check_metrics)
    report = AuditReport(spec=AuditSpec(), counts=np.zeros(8, np.int64),
                         first=None, totals=state_totals(net))
    bad = cross_check_metrics(report, frame)
    totals = frame.totals()
    if bad or totals["samples"] != samples:
        fail(f"{what}: the metrics plane disagrees with the state: {bad}, "
             f"samples {totals['samples']} (want {samples})")
    log(f"{what} under the metrics plane: cross_check_metrics clean, "
        f"totals {totals}")


def check_trace_accounting(what, frame, net, ps, n):
    """A flight-recorder frame against its run's state: not truncated,
    one deliver event a received message, one send event an attempted
    unicast and one a sendAll (which counts n sends)."""
    if frame.dropped:
        fail(f"{what}: the trace dropped {frame.dropped} events")
    sends = frame.filter(kinds=["send"]).column("dst")
    uni, bc = int((sends >= 0).sum()), int((sends < 0).sum())
    counts = frame.counts()
    if counts.get("deliver", 0) != int(net.nodes.msg_received.sum()) or \
            uni + n * bc != int(net.nodes.msg_sent.sum()):
        fail(f"{what}: the trace's events {counts} disagree with the "
             f"state's counters")
    log(f"{what} under the flight recorder: {frame.n_events} events "
        f"{counts}, equal to the state's counters, high water "
        f"{frame.high_water}")


def gsf32k_run(dev):
    """Path G32: `GSFSignature(node_count=32768)` with its defaults
    (L 16, W 1,024, H 512, 53 rounds), seed 0, dense through
    `Runner.run_ms` in two 50-ms calls, counters set to 0 just before:
    equal to the JAX golden at 50 and 100 ms (outside the timed wall),
    zero drops and clamps, K1, K4 and K5 once a ms.  Peak memory while
    the state is built and over the run apart, wall, and ops a ms over
    two more ms; then a K1 case is captured from one more ms."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner, scan_chunk
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    with open(G32_GOLDEN) as f:
        golden = json.load(f)["ms"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proto = GSFSignature(node_count=G32_NODES, device=dev)
    net, ps = proto.init(0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(x.numel() * x.element_size()
                      for x in pytree.tree_leaves((net, ps)))
    torch.cuda.reset_peak_memory_stats()
    runner = Runner(proto)
    reset_counters()
    # Each checkpoint's state is copied to the host before the next call
    # writes it in place; its 15 GB are hashed on a thread meanwhile.
    hasher = concurrent.futures.ThreadPoolExecutor(1)
    walls, t, copy_s, digests = [], 0, 0.0, {}
    for stop in G32_MS:
        t0 = time.perf_counter()
        net, ps = runner.run_ms(net, ps, stop - t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t = stop
        t0 = time.perf_counter()
        digests[t] = hasher.submit(convert.state_digest,
                                   *convert.to_numpy(net, ps))
        copy_s += time.perf_counter() - t0
    launches = read_counters()
    t0 = time.perf_counter()
    for t_, digest in digests.items():
        want = golden[str(t_)]
        check_digest(f"GSF {G32_NODES} at {t_} ms", digest.result(),
                     want["leaves"])
        log(f"GSF {G32_NODES} golden: all {len(want['leaves'])} leaves "
            f"match the JAX reference at {t_} ms (JAX counts "
            f"{want['counts']})")
    hasher.shutdown()
    check_s = copy_s + time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated()
    wall = sum(walls)
    res = dict(wall_s=wall, chunk_walls_s=walls, sim_ms=t,
               sim_ms_per_s=t / wall, ms_per_sim_ms=1e3 * wall / t,
               build_s=build_s, golden_check_s=check_s,
               state_bytes=state_bytes, init_peak_mem_bytes=init_peak,
               peak_mem_bytes=run_peak, evicted=int(ps.evicted),
               frac_done=float((net.nodes.done_at[~net.nodes.down] > 0)
                               .float().mean()),
               msg_sent=int(net.nodes.msg_sent.sum()), **counts_of(net))
    window = scan_chunk(proto, OPS_MS)
    res["aten_ops_per_ms"] = ops_per_ms(lambda: window(net, ps, t=t),
                                        OPS_MS)
    with capture_route("route_gsf32k", {0}):
        scan_chunk(proto, 1)(net, ps, t=t + OPS_MS)
    if res["dropped"] or res["clamped"] or res["bc_dropped"]:
        fail(f"GSF {G32_NODES}: drops and clamps must be 0: {res}")
    return res, launches


def obs_run(dev):
    """Phase O: `PingPong(node_count=64)`, seed 0, under each plane on
    the card, the twins of tests/test_pallas_route.py:200 and :211 (the
    planes with the routing kernel on), counters set to 0 just before
    each: the metrics plane (stat_each_ms 4) over 24 ms of
    `scan_chunk_metrics`, the flight recorder over 40 ms of
    `scan_chunk_trace`, the audit through ``Runner(audit=).run_ms`` to
    40 ms.  Each carry and state equals the JAX golden made on the CPU
    (`tests/torch_parity.py obs-golden`); the audit is clean."""
    import numpy as np
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    from wittgenstein_tpu_torch.obs import (AuditSpec, MetricsSpec,
                                            TraceSpec, scan_chunk_metrics,
                                            scan_chunk_trace)
    with open(OBS_GOLDEN) as f:
        golden = json.load(f)
    proto = PingPong(node_count=64, device=dev)
    out = {}
    for plane in ("metrics", "trace", "audit"):
        want = golden[plane]
        net, ps = proto.init(0)
        reset_counters()
        t0 = time.perf_counter()
        if plane == "metrics":
            spec = MetricsSpec(stat_each_ms=4)
            net, ps, carry = scan_chunk_metrics(proto, want["ms"], spec)(
                net, ps)
        elif plane == "trace":
            net, ps, carry = scan_chunk_trace(proto, want["ms"],
                                              TraceSpec())(net, ps)
        else:
            runner = Runner(proto, audit=AuditSpec())
            net, ps = runner.run_ms(net, ps, want["ms"])
            carry = runner.audit_carries[-1]
            report = runner.audit_report()
            if not report.clean or \
                    "ring_conservation" not in report.claimed:
                fail(f"phase O: the audit is not clean: {report.format()}")
        wall = time.perf_counter() - t0
        launches = read_counters()
        got = {f.name: getattr(carry, f.name).cpu().numpy()
               for f in dataclasses.fields(carry)}
        if plane == "trace":
            got = {"cursor": int(got["cursor"]),
                   "dropped": int(got["dropped"]),
                   "buf": convert.leaf_digest(got["buf"].astype(np.int32)),
                   "down": convert.leaf_digest(got["down"].astype(bool))}
        else:
            got = {k: v.tolist() for k, v in got.items()}
        if got != want["carry"]:
            fail(f"phase O: the {plane} carry differs from the JAX "
                 f"plane's: {got} against {want['carry']}")
        check_digest(f"phase O {plane} state at {want['ms']} ms",
                     convert.state_digest(*convert.to_numpy(net, ps)),
                     want["leaves"])
        log(f"phase O: the {plane} plane's carry and the state at "
            f"{want['ms']} ms equal the JAX golden ({wall:.2f} s)")
        out[f"obs_{plane}"] = (dict(ms=want["ms"], wall_s=wall), launches)
    return out



# ---------------------------------------------- the chaos and memo planes

def chaos_headline_schedule(down):
    """Phase X1's fault schedule as JSON from the batch's entry down
    flags ([R, N]; `tests/torch_parity.py` `chaos_headline_schedule`,
    whose golden records it): churn of the first `churn` nodes up at
    init in every seed, down 40-120 ms; nodes [0, n/2) in partition 1
    from 60 to 140 ms; 200 per mille loss on every link from 20 to 160
    ms; +3 ms from the first half to the second from 100 to 180 ms."""
    import numpy as np
    live = ~np.asarray(down).any(0)
    n = live.shape[0]
    h = n // 2
    return {"churn": [[int(v), 40, 120]
                      for v in np.flatnonzero(live)[:X_CHURN]],
            "partitions": [[60, 140, 1, 0, h]],
            "loss": [[20, 160, 200, 0, n, 0, n]],
            "delay": [[100, 180, 3, 0, h, h, n]]}


def checkpoint_chaos_schedule():
    """Phase X2's schedule: tests/test_checkpoint.py:111's, its node
    ranges scaled from 64 nodes to PP_NODES."""
    n = PP_NODES
    return {"churn": [[3, 20, 60], [5, 40, 100]],
            "partitions": [[30, 90, 1, 0, n // 2]],
            "loss": [[0, 120, 250, 0, n, 0, n]]}


def states_equal(a, b) -> bool:
    """Two port states (or carries) equal leaf for leaf, on the card."""
    import torch
    from torch.utils import _pytree as pytree
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def route_replay(name):
    """The K1 call captured as ROUTE_CASES[name] (`capture_route`) run
    again on copies of its ring through the kernel and its plain
    version: equal outputs and drop counts.  The replay's launch is not
    counted."""
    import torch
    from wittgenstein_tpu_torch.ops.route import (bin_into_ring,
                                                  bin_into_ring_plain)
    ring, msg = ROUTE_CASES.pop(name)
    plain = [t.clone() for t in ring]
    kern = [t.clone() for t in ring]
    launches = bin_into_ring.launches
    dk = bin_into_ring(*kern, *msg)
    bin_into_ring.launches = launches
    dp = bin_into_ring_plain(*plain, *msg)
    err = max_abs_err(plain + [dp], kern + [dk])
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"{name}: the route kernel differs from its plain version "
             f"(max err {err})")
    return int(msg[-1].sum())


def chaos_headline_run(dev, plain_impact):
    """X1 (module docstring): the faulted headline in 100-ms chunks of
    `scan_chunk_batched` (K=2, phase hints), counters set to 0 just
    before; every seed against the JAX golden at 100 and 200 ms (outside
    the timed wall); K1's window at 100 ms captured and replayed against
    its plain version."""
    import torch
    from wittgenstein_tpu_torch.chaos import (ChaosProtocol, FaultSchedule,
                                              impact_summary)
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    with open(X_GOLDEN) as f:
        golden = json.load(f)
    proto, (nets, ps) = headline_init(dev)
    sched = chaos_headline_schedule(nets.nodes.down.cpu().numpy())
    if sched != golden["schedule"]:
        fail(f"X1: the schedule built from the batch's init differs from "
             f"the golden's: {sched} against {golden['schedule']}")
    cp = ChaosProtocol(proto, FaultSchedule.from_json(sched))
    run = scan_chunk_batched(cp, X_CHUNK, t0_mod=0, superstep=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    wall = 0.0
    with capture_route("route_chaos", {X_CHUNK // 2}):
        for t in range(0, X_MS[-1], X_CHUNK):
            t0 = time.perf_counter()
            nets, ps = run(nets, ps, t=t)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            want = golden["ms"][str(t + X_CHUNK)]
            check_seed_goldens("X1 faulted headline", nets, ps,
                               {"ms": t + X_CHUNK, "seeds": want["seeds"]})
    launches = read_counters()
    n_valid = route_replay("route_chaos")
    impact = impact_summary(nets)
    log(f"X1: K1 on the window at {X_CHUNK} ms ({n_valid} messages) "
        "equals its plain version")
    if impact != want["impact"]:
        fail(f"X1: impact {impact} differs from the JAX run's "
             f"{want['impact']}")
    log(f"X1 impact at {X_MS[-1]} ms: faulted {impact}, plain (phase 5) "
        f"{plain_impact}; launches route {launches['route']}, merge "
        f"{launches['merge']}, score {launches['score']}")
    res = dict(wall_s=wall, sim_ms_per_s=X_MS[-1] / wall,
               agg_sim_ms_per_s=HEADLINE_SEEDS * X_MS[-1] / wall,
               schedule=cp.chaos_schedule.counts(),
               transitions=len(cp.chaos_schedule.transition_times()),
               faulted=impact, plain=plain_impact,
               dropped=int(nets.dropped.sum()),
               clamped=int(nets.clamped.sum()),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    return res, launches


def chaos_checkpoint_run(dev):
    """X2 (module docstring): the run saved at 40 ms into an in-memory
    .npz (uncompressed: the 16 seeds' ring is 6.4 GB) goes on
    uninterrupted to 120 ms; a fresh state loaded from the file goes on
    to 120 ms too.  Counters set to 0 just before.  The two equal on the
    card, and the resumed one equals the JAX golden at 120 ms."""
    import io

    import torch
    from wittgenstein_tpu_torch.chaos import (ChaosProtocol, FaultSchedule,
                                              impact_summary)
    from wittgenstein_tpu_torch.core.network import (pick_superstep,
                                                     scan_chunk)
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    from wittgenstein_tpu_torch.utils import checkpoint
    with open(X2_GOLDEN) as f:
        golden = json.load(f)
    sched = checkpoint_chaos_schedule()
    if sched != golden["schedule"]:
        fail(f"X2: schedule {sched} differs from the golden's "
             f"{golden['schedule']}")
    cp = ChaosProtocol(PingPong(node_count=PP_NODES, device=dev),
                       FaultSchedule.from_json(sched))
    k = pick_superstep(cp, X2_CHUNK, t0=0)
    if k != 2:
        fail(f"X2: the gate proves K={k} under the schedule, want 2")
    run = scan_chunk(cp, X2_CHUNK, superstep=k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    straight = run(*init_batched(cp, torch.arange(PP_SEEDS)), t=0)
    torch.cuda.synchronize()
    c0 = time.perf_counter()
    buf = io.BytesIO()
    checkpoint.save(buf, *straight, meta={"time": X2_CHUNK},
                    compress=False)
    size = buf.tell()
    save_s = time.perf_counter() - c0
    for t in range(X2_CHUNK, X2_MS, X2_CHUNK):
        straight = run(*straight, t=t)
    torch.cuda.synchronize()
    c0 = time.perf_counter()
    buf.seek(0)
    net, ps, meta = checkpoint.load(buf, cp, seed=0, device=dev)
    del buf
    torch.cuda.synchronize()
    load_s = time.perf_counter() - c0
    if meta != {"time": X2_CHUNK} or net.time.tolist() != \
            [X2_CHUNK] * PP_SEEDS:
        fail(f"X2: the checkpoint restored meta {meta}, times "
             f"{net.time.tolist()}")
    resumed = (net, ps)
    for t in range(X2_CHUNK, X2_MS, X2_CHUNK):
        resumed = run(*resumed, t=t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    if not states_equal(straight, resumed):
        fail("X2: the resumed run differs from the uninterrupted one")
    del straight
    check_seed_goldens("X2 resumed PingPong", *resumed,
                       {"ms": X2_MS, "seeds":
                        golden["ms"][str(X2_MS)]["seeds"]})
    res = dict(superstep=k, wall_s=wall, save_s=save_s, load_s=load_s,
               checkpoint_bytes=size, impact=impact_summary(resumed[0]),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    log(f"X2: resumed at {X2_CHUNK} ms from a {size / 1e9:.2f}-GB "
        f"checkpoint (save {save_s:.2f} s, load {load_s:.2f} s); equal to "
        f"the uninterrupted run and the JAX golden at {X2_MS} ms")
    return res, launches


def planes_chunk(proto, chunk, k, specs):
    """``run(net, pstate, t) -> (net, pstate, {plane: carry})``: `chunk`
    ms at K=`k` under the metrics, audit and trace planes at once (their
    builders' steps in one engine pass: the audit and trace taps both
    ride `step_kms`, each writing only its own cell, and the metrics
    recorder samples after each window), so each carry is the one its
    own plane's chunk records (`specs`: their specs by plane)."""
    from wittgenstein_tpu_torch.core.network import step_kms
    from wittgenstein_tpu_torch.obs.audit import (audit_tap, fold_window,
                                                  init_audit)
    from wittgenstein_tpu_torch.obs.plane import init_metrics, record_step
    from wittgenstein_tpu_torch.obs.trace import init_trace, trace_tap
    mspec, aspec, tspec = specs["metrics"], specs["audit"], specs["trace"]

    def run(net, pstate, t):
        t0 = t
        mc = init_metrics(mspec, chunk, net.time)
        ac, tc = init_audit(aspec, net), init_trace(tspec, net.nodes.down)
        for _ in range(chunk // k):
            acell, tcell = [None], [tc, None]
            taps = (audit_tap(proto, aspec, acell),
                    trace_tap(proto, tspec, tcell))

            def tap(ti, n, out):
                for f in taps:
                    f(ti, n, out)
            net, pstate = step_kms(proto, net, pstate, k, t=t, tap=tap)
            ac = fold_window(aspec, proto.cfg, ac, acell[0], net, k, t)
            tc = tcell[0]
            mc = record_step(mspec, mc, net, t0, t + k, n_steps=k)
            t += k
        return net, pstate, {"metrics": mc, "audit": ac, "trace": tc}

    return run


def chaos_freeze_run(dev):
    """X3 (module docstring): the spec's chunks stepped under the three
    planes in one pass a chunk (`planes_chunk`; before any run is quiet,
    whose carries nothing compares, without them), counters set to 0
    just before.  A run first quiet at boundary b is copied there; its
    `frozen_final` must equal the state at 240 ms, and at every later
    boundary the freeze of its current state the first; each boundary's
    `frozen_carries` must equal the stepped carries of the chunks after
    it."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch import obs
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.memo import (build_probe, frozen_carries,
                                             frozen_final)
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    spec = ScenarioSpec(protocol="PingPong",
                        params={"node_count": PP_NODES},
                        latency_model="NetworkFixedLatency(10)",
                        seeds=tuple(range(PP_SEEDS)), sim_ms=X3_MS,
                        chunk_ms=X3_CHUNK, superstep=2,
                        obs=("metrics", "audit", "trace")).validate()
    proto = spec.build_protocol(device=dev)
    cfg, chunk = proto.cfg, spec.chunk_ms
    n_chunks = spec.sim_ms // chunk
    run = planes_chunk(proto, chunk, spec.superstep, {
        "metrics": obs.MetricsSpec(stat_each_ms=spec.stat_each_ms),
        "audit": obs.AuditSpec(),
        "trace": obs.TraceSpec(capacity=spec.trace_capacity)})
    plain = scan_chunk(proto, chunk, superstep=spec.superstep)
    probe = build_probe(proto)

    def lane(tree, r):
        return pytree.tree_map(lambda x: x[r:r + 1], tree)

    state = init_batched(proto, torch.arange(PP_SEEDS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    first, synth, carries, frozen_at = {}, [], [], []
    for b in range(n_chunks):
        quiet = [r for r, w in enumerate(probe(*state).tolist())
                 if w >= spec.sim_ms]
        frozen_at.append(len(quiet))
        for r in quiet:
            one = lane(state, r)
            if r not in first:
                first[r] = frozen_final(
                    cfg, pytree.tree_map(torch.clone, one), spec.sim_ms)
            elif not states_equal(frozen_final(cfg, one, spec.sim_ms),
                                  first[r]):
                fail(f"X3: run {r}'s freeze at {b * chunk} ms differs "
                     "from its first")
            synth.append((r, b, frozen_carries(spec, cfg, one, b * chunk,
                                               n_chunks - b)))
        if first:
            *state, got = run(*state, t=b * chunk)
        else:
            # no run is frozen yet: no carry of this chunk is compared
            state, got = plain(*state, t=b * chunk), None
        carries.append(got)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    if not first:
        fail("X3: no run froze")
    for r, fin in first.items():
        if not states_equal(fin, lane(state, r)):
            fail(f"X3: run {r}'s frozen_final differs from stepping")
    carries = [c and pytree.tree_map(lambda x: x.cpu(), c)
               for c in carries]
    for r, b, fc in synth:
        for c in range(n_chunks - b):
            for plane in spec.obs:
                if not states_equal(lane(carries[b + c][plane], r),
                                    fc[plane][c]):
                    fail(f"X3: run {r}'s {plane} carry of chunk {b + c}, "
                         f"synthesized at {b * chunk} ms, differs from "
                         "stepping")
    log(f"X3: {len(first)} of {PP_SEEDS} runs frozen (quiet runs at each "
        f"boundary: {frozen_at}); {len(synth)} tails synthesized, each "
        "equal to stepping its chunks under the three planes")
    res = dict(superstep=spec.superstep, wall_s=wall,
               frozen_runs=len(first), quiet_at_boundary=frozen_at,
               tails_checked=len(synth),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    return res, launches


def chaos_phase(dev, plain_impact):
    """Phase X: X1, X2 and X3, each with its launches; K1 on X1's
    window."""
    out = {"chaos_headline": chaos_headline_run(dev, plain_impact),
           "chaos_checkpoint": chaos_checkpoint_run(dev),
           "chaos_freeze": chaos_freeze_run(dev)}
    for key, (res, launches) in out.items():
        log(f"{key}: {json.dumps(res)} launches {launches}")
        check_launches(key, launches)
    return out

# ------------------------------------- SanFermin, Dfinity and P2PFlood

def ops_per_ms(window, ms):
    """Top-level PyTorch ops a simulated ms of `window()` (`ms`
    simulated ms), counted by torch.profiler on the host side only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        window()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.cpu_parent is None
               and e.name.startswith("aten::")) / ms


def ops_at(proto, k, nets, ps, t):
    """`ops_per_ms` of OPS_MS more simulated ms at K=`k` from time `t`,
    run on a copy of the state (the engine writes the ring in place)."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch.core.network import scan_chunk
    window = scan_chunk(proto, OPS_MS, superstep=k)
    copy = pytree.tree_map(torch.clone, (nets, ps))
    return ops_per_ms(lambda: window(*copy, t=t), OPS_MS)


def counts_of(net, ps=None):
    """A state's drop and clamp counters (summed over a batch), and for
    a Dfinity state its arena's drops and its head heights' range."""
    out = {k: int(getattr(net, k).sum()) for k in
           ("dropped", "clamped", "bc_dropped", "sp_dropped")}
    if ps is not None and hasattr(ps, "arena"):
        heights = ps.arena.height.gather(-1, ps.head.long())
        out.update(arena_dropped=int(ps.arena.dropped.sum()),
                   height_max=int(heights.max()),
                   height_min=int(heights.min()))
    return out


def chunked(run, state, t0, t1, chunk, check=None, ff=False):
    """`run` (a chunk function of `chunk` ms) from t0 to t1 in calls;
    the host waits for the card after each, and `check(t, state,
    stats)` runs outside the timed wall.  Returns the state, the wall
    and, fast-forwarded, each call's skip counts."""
    import torch
    wall, stats = 0.0, []
    for t in range(t0, t1, chunk):
        c0 = time.perf_counter()
        state = run(*state, t=t)
        if ff:
            *state, st = state
            stats.append(st)
        torch.cuda.synchronize()
        wall += time.perf_counter() - c0
        if check:
            check(t + chunk, state, stats)
    return tuple(state), wall, stats


def sanfermin_run(dev):
    """Path S: `tools/bench_suite.py`'s SanFermin line,
    ``SanFermin(node_count=32768, inbox_cap=16)`` with two ring
    sub-planes, seed 0, one run at the proved K (2) in 350-ms
    `network.scan_chunk` calls to SF_MS, counters set to 0 just before:
    equal to the JAX golden at its checkpoints (outside the timed wall), zero
    drops and clamps, route once a window per sub-plane.  A K1 case is
    captured from its windows."""
    import dataclasses

    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import (pick_superstep,
                                                     scan_chunk)
    from wittgenstein_tpu_torch.models.sanfermin import SanFermin
    n, ms, chunk = SF_NODES, SF_MS, SF_CHUNK
    with open(SF_GOLDEN) as f:
        golden = json.load(f)["ms"]
    proto = SanFermin(node_count=n, inbox_cap=16, device=dev)
    proto.cfg = dataclasses.replace(proto.cfg, box_split=SF_BOX_SPLIT)
    k = pick_superstep(proto, chunk, t0=0)
    if k != 2:
        fail(f"SanFermin: the gate proves K={k}, want 2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = proto.init(0)
    reset_counters()

    def check(t, state, _):
        want = golden.get(str(t))
        if want is not None:
            check_digest(f"SanFermin {n} at {t} ms", convert.state_digest(
                *convert.to_numpy(*state)), want["leaves"])
            log(f"SanFermin golden: all {len(want['leaves'])} leaves match "
                f"the JAX reference at {t} ms (JAX counts {want['counts']})")
    # sub-plane 0 of every window
    with capture_route("route_sanfermin", set(range(0, ms, 2))):
        (net, ps), wall, _ = chunked(scan_chunk(proto, chunk, superstep=k),
                                     state, 0, ms, chunk, check)
    launches = read_counters()
    res = dict(superstep=k, wall_s=wall, sim_ms_per_s=ms / wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               done_frac=float(ps.done.float().mean()),
               **counts_of(net))
    window = scan_chunk(proto, OPS_MS, superstep=k)
    res["aten_ops_per_ms"] = ops_per_ms(lambda: window(net, ps, t=ms),
                                        OPS_MS)
    if res["dropped"] or res["clamped"]:
        fail(f"SanFermin: drops and clamps must be 0: {res}")
    return res, launches


def cappos_run(dev):
    """Path C: `SanFerminCappos()` at its default 2,048 nodes, seed 0,
    one CAPPOS_MS `network.scan_chunk` call at the proved K (2),
    counters set to 0 just before: equal to the JAX golden there."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import (pick_superstep,
                                                     scan_chunk)
    from wittgenstein_tpu_torch.models.sanfermin import SanFerminCappos
    with open(CAPPOS_GOLDEN) as f:
        golden = json.load(f)
    proto = SanFerminCappos(device=dev)
    k = pick_superstep(proto, CAPPOS_MS, t0=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = proto.init(0)
    reset_counters()
    (net, ps), wall, _ = chunked(scan_chunk(proto, CAPPOS_MS, superstep=k),
                                 state, 0, CAPPOS_MS, CAPPOS_MS)
    launches = read_counters()
    check_digest(f"Cappos at {CAPPOS_MS} ms", convert.state_digest(
        *convert.to_numpy(net, ps)), golden["leaves"])
    log(f"Cappos golden: all {len(golden['leaves'])} leaves match the JAX "
        f"reference at {CAPPOS_MS} ms")
    res = dict(superstep=k, wall_s=wall, sim_ms_per_s=CAPPOS_MS / wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **counts_of(net))
    window = scan_chunk(proto, OPS_MS, superstep=k)
    res["aten_ops_per_ms"] = ops_per_ms(
        lambda: window(net, ps, t=CAPPOS_MS), OPS_MS)
    PATH_LAUNCHES["cappos"] = {"route": CAPPOS_MS // k}
    return res, launches


def dfinity_run(dev):
    """Path D: `tools/bench_suite.py`'s Dfinity line (10,111 nodes,
    `tracked_10k_params`), seed 0.  Dense: 200-tick `network.scan_chunk`
    calls at the proved K (2) to 400 ticks, equal to the JAX golden;
    then again from tick 0 in 400-tick `fast_forward_chunk` calls
    (K=2) to 12,000 ticks (120 simulated s): equal to the same golden
    at tick 400 and to the JAX run's at 12,000, every call's skip counts
    the JAX engine's, zero unicast and arena drops, heads within 1 and
    the JAX run's highest head.  Counters set to 0 before each run; a
    K1 case is captured from the dense run's windows."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import (
        fast_forward_chunk, pick_superstep, scan_chunk)
    from wittgenstein_tpu_torch.models.dfinity import (Dfinity,
                                                       tracked_10k_params)
    ticks, ff_ticks = D_TICKS, D_FF_TICKS
    with open(D_GOLDEN) as f:
        golden = json.load(f)
    proto = Dfinity(**tracked_10k_params(), device=dev)
    k = pick_superstep(proto, D_CHUNK, t0=0, max_k=2)
    if k != 2:
        fail(f"Dfinity: the gate proves K={k}, want 2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = proto.init(0)
    reset_counters()
    with capture_route("route_dfinity", set(range(ticks // k))):
        (net, ps), wall, _ = chunked(scan_chunk(proto, D_CHUNK, superstep=k),
                                     state, 0, ticks, D_CHUNK)
    launches = read_counters()
    check_digest(f"Dfinity at {ticks} ticks", convert.state_digest(
        *convert.to_numpy(net, ps)), golden["leaves"])
    log(f"Dfinity golden: all {len(golden['leaves'])} leaves match the JAX "
        f"reference at {ticks} ticks (JAX counts {golden['counts']})")
    dense = dict(superstep=k, wall_s=wall, sim_ticks_per_s=ticks / wall,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 **counts_of(net, ps))
    window = scan_chunk(proto, OPS_MS, superstep=k)
    dense["aten_ops_per_ms"] = ops_per_ms(
        lambda: window(net, ps, t=ticks), OPS_MS)
    del net, ps, state

    want_ff = golden["fast_forward"]

    def check(t, state, stats):
        want = {ticks: golden["leaves"], ff_ticks: want_ff["leaves"]}.get(t)
        if want is not None:
            check_digest(f"fast-forwarded Dfinity at {t} ticks",
                         convert.state_digest(*convert.to_numpy(*state)),
                         want)
            log(f"fast-forwarded Dfinity equals the JAX golden at {t} "
                f"ticks")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = proto.init(0)
    reset_counters()
    run = fast_forward_chunk(proto, ticks, superstep=k)
    (net, ps), ff_wall, stats = chunked(run, state, 0, ff_ticks, ticks,
                                        check, ff=True)
    ff_launches = read_counters()
    if stats != want_ff["chunks"]:
        fail(f"fast-forwarded Dfinity skips {stats}, the JAX engine "
             f"{want_ff['chunks']}")
    skipped = sum(s["skipped_ms"] for s in stats)
    PATH_LAUNCHES["dfinity_ff"] = {"route": (ff_ticks - skipped) // k}
    ff = dict(superstep=k, wall_s=ff_wall, dense_wall_s=wall,
              sim_ticks=ff_ticks, sim_ticks_per_s=ff_ticks / ff_wall,
              skipped_ms=skipped, jump_count=sum(s["jump_count"]
                                                 for s in stats),
              skip_rate=skipped / ff_ticks,
              peak_mem_bytes=torch.cuda.max_memory_allocated(),
              **counts_of(net, ps))
    ff["aten_ops_per_ms"] = ops_per_ms(
        lambda: run(net, ps, t=ff_ticks), ticks)
    # bench_suite also asks for a highest head of 30 by 120 s; the JAX
    # run of this line stops at the height its golden records, and the
    # port is held to that run.
    if ff["dropped"] or ff["arena_dropped"] or \
            ff["height_max"] - ff["height_min"] > 1 or \
            ff["height_max"] != want_ff["counts"]["height_max"]:
        fail(f"Dfinity at {ff_ticks} ticks: want zero drops and arena drops, "
             f"heads within 1 and the JAX run's highest head "
             f"{want_ff['counts']['height_max']}: {ff}")
    log(f"Dfinity at {ff_ticks} ticks: highest head {ff['height_max']} "
        f"and {ff['bc_dropped']} broadcasts dropped, as in the JAX run "
        f"(bench_suite asks for a highest head of 30)")
    return (dense, launches), (ff, ff_launches)


def quiet_run(dev, line, n=None, golden_path=None):
    """Path Q: `bench.py` `bench_quiet`'s lines, 4 seeds in one batch,
    Q_MS in Q_CHUNK-ms `network.scan_chunk` calls on `init_batched` at
    the proved K (2), counters set to 0 just before: ``dfinity``, the
    reference default (31 nodes), dense and then fast-forwarded
    (`fast_forward_chunk(seed_axis=True)`, the JAX engine's skip counts
    chunk by chunk); ``p2pflood``, `quiet_params` (256 nodes), dense and
    its K1 case captured.  Every seed equal to its JAX golden."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import (
        fast_forward_chunk, pick_superstep, scan_chunk)
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.dfinity import Dfinity
    from wittgenstein_tpu_torch.models.p2pflood import P2PFlood, quiet_params
    if line == "dfinity":
        proto = Dfinity(device=dev)
        golden = load_golden(golden_path or QD_GOLDEN, Q_MS, Q_SEEDS)
    else:
        proto = P2PFlood(**quiet_params(n or 256), device=dev)
        golden = load_golden(golden_path or QP_GOLDEN, Q_MS, Q_SEEDS)
    k = pick_superstep(proto, Q_CHUNK, t0=0, max_k=2)
    seeds = torch.arange(Q_SEEDS)
    out = {}
    runs = ("dense", "ff") if line == "dfinity" else ("dense",)
    for mode in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_batched(proto, seeds)
        reset_counters()
        ff = mode == "ff"
        run = (fast_forward_chunk(proto, Q_CHUNK, seed_axis=True,
                                  superstep=k) if ff else
               scan_chunk(proto, Q_CHUNK, superstep=k))
        calls = set(range(Q_MS // k)) if line == "p2pflood" else set()
        with capture_route(f"route_{line}", calls):
            (nets, ps), wall, stats = chunked(run, state, 0, Q_MS, Q_CHUNK,
                                              ff=ff)
        launches = read_counters()
        check_seed_goldens(f"{line} x {Q_SEEDS} seeds ({mode})", nets, ps,
                           golden)
        res = dict(superstep=k, wall_s=wall,
                   agg_sim_ms_per_s=Q_SEEDS * Q_MS / wall,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   **counts_of(nets, ps))
        key = f"quiet_{line}" + ("_ff" if ff else "")
        if ff:
            want = golden["fast_forward"]["chunks"]
            if stats != want:
                fail(f"fast-forwarded {line} batch skips {stats}, the JAX "
                     f"engine {want}")
            skipped = sum(s["skipped_ms"] for s in stats)
            res.update(skipped_ms=skipped, skip_rate=skipped / Q_MS,
                       jump_count=sum(s["jump_count"] for s in stats))
            PATH_LAUNCHES[key] = {"route": (Q_MS - skipped) // k}
        else:
            PATH_LAUNCHES[key] = {"route": Q_MS // k}
        # ops of one more chunk (fast-forwarded) or a dense OPS_MS window
        window = run if ff else scan_chunk(proto, OPS_MS, superstep=k)
        res["aten_ops_per_ms"] = ops_per_ms(
            lambda: window(nets, ps, t=Q_MS), Q_CHUNK if ff else OPS_MS)
        if res["dropped"] or res["clamped"]:
            fail(f"{line} batch: drops and clamps must be 0: {res}")
        out[key] = (res, launches)
    return out


# ------------------------------------------------------ Casper and ETHPoW

def chain_counts(nets, ps, r):
    """Run r's highest head, head skew, blocks and (Casper) attestations,
    and its engine and arena drops."""
    heights = ps.arena.height[r].gather(0, ps.head[r].long())
    out = {"height_max": int(heights.max()),
           "head_skew": int(heights.max() - heights.min()),
           "blocks": int(ps.arena.n[r]) - 1,
           "arena_dropped": int(ps.arena.dropped[r]),
           **{k: int(getattr(nets, k)[r]) for k in
              ("dropped", "clamped", "bc_dropped")}}
    if hasattr(ps, "att_n"):
        out["attestations"] = int(ps.att_n[r])
    return out


def harness_run(proto, runs, ticks, chunk, first_seed, on_chunk):
    """`run_multiple_times(proto, runs, ...)` with no run stopping (as
    `try_miner` runs it), counters set to 0 just before; `on_chunk(t,
    nets, ps)` checks each chunk outside the timed wall.  Returns the
    result, the wall, the peak allocated bytes and the launches."""
    import torch
    from wittgenstein_tpu_torch.core.harness import run_multiple_times
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    spent = [0.0]

    def hook(t, nets, ps):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        on_chunk(t, nets, ps)
        spent[0] += time.perf_counter() - c0
    t0 = time.perf_counter()
    res = run_multiple_times(proto, runs, max_time=ticks, chunk=chunk,
                             first_seed=first_seed,
                             cont_if=lambda net, ps: net.time >= 0,
                             on_chunk=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - spent[0]
    return res, wall, torch.cuda.max_memory_allocated(), read_counters()


def casper_run(dev):
    """Path K: Casper IMD's reference configuration, ``CasperIMD()`` (83
    nodes: observer, WF byzantine producer, one honest producer, 4 x 20
    attesters; 20-ms ticks; the distance latency), seeds 0-7 in one
    batch through `run_multiple_times` in 600-tick chunks at the K the
    gate proves, counters set to 0 just before: every seed equal to its
    JAX golden at 600 and 1,200 ticks, zero unicast, broadcast and
    arena drops and heads within 2 where the JAX seeds show it; each
    seed's highest head, skew, blocks and attestations logged.  A K1
    case is captured from its windows."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import (pick_superstep,
                                                     scan_chunk)
    from wittgenstein_tpu_torch.models.casper import CasperIMD
    with open(K_GOLDEN) as f:
        golden = json.load(f)["ticks"]
    proto = CasperIMD(device=dev)
    k = pick_superstep(proto, K_CHUNK, t0=0)

    def check(t, nets, ps):
        want = golden[str(t)]
        got = convert.seed_digests(*convert.to_numpy(nets, ps))
        for r, (g, w) in enumerate(zip(got, want["seeds"])):
            check_digest(f"Casper seed {r} at {t} ticks", g, w)
        counts = [chain_counts(nets, ps, r) for r in range(K_SEEDS)]
        for r, (c, w) in enumerate(zip(counts, want["counts"])):
            if c["dropped"] or c["clamped"] or c["bc_dropped"] or \
                    c["arena_dropped"] or (
                        w["height_max"] - w["height_min"] <= 2 and
                        c["head_skew"] > 2):
                fail(f"Casper seed {r} at {t} ticks: {c}")
        summary = [(c["height_max"], c["head_skew"], c["blocks"],
                    c["attestations"]) for c in counts]
        log(f"Casper: all {K_SEEDS} seeds match the JAX reference at {t} "
            f"ticks, {len(got[0])} leaves each; per seed (highest head, "
            f"skew, blocks, attestations) "
            f"{summary}")
    # broadcasts only: every window bins no message; keep the first
    with capture_route("route_casper", {0}):
        res, wall, peak, launches = harness_run(proto, K_SEEDS, K_TICKS,
                                                K_CHUNK, 0, check)
    nets, ps = res.nets, res.pstates
    PATH_LAUNCHES["casper"] = {"route": K_TICKS // k}
    out = dict(superstep=k, wall_s=wall, sim_ticks=K_TICKS,
               agg_sim_ticks_per_s=K_SEEDS * K_TICKS / wall,
               peak_mem_bytes=peak, **counts_of(nets, ps))
    # the slot boundary at 1,200 (a build, reevaluations), then WF ticks
    event = scan_chunk(proto, k, superstep=k)
    out["aten_ops_per_tick_slot_boundary"] = ops_per_ms(
        lambda: event(nets, ps, t=K_TICKS), k)
    nets, ps = event(nets, ps, t=K_TICKS)
    window = scan_chunk(proto, K_OPS_TICKS, superstep=k)
    out["aten_ops_per_tick"] = ops_per_ms(
        lambda: window(nets, ps, t=K_TICKS + k), K_OPS_TICKS)
    return out, launches


def ethpow_run(dev):
    """Path E: `try_miner`'s batch at one point, ``ETHPoW(10 miners,
    ETHSelfishMiner at 0.40, NetworkFixedLatency(1000), capacity
    8192)``, seeds 1-5 in one batch through `run_multiple_times` in
    one 1,500-tick chunk at the proved K, counters set to 0 just before:
    every leaf equal to the JAX golden at 1,500 ticks (`thr`, stored raw
    there, float for float), `try_miner`'s row equal to the golden's,
    zero unicast and arena drops.  The ops a tick at
    8,192 blocks equal those at 1,024 within 1% (ticks 0-20 of the same
    seeds).  A K1 case is captured from its windows."""
    import numpy as np
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import (pick_superstep,
                                                     scan_chunk)
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.ethpow import ETHPoW, miner_row
    with open(E_GOLDEN) as f:
        golden = json.load(f)
    if golden["ticks"] != E_TICKS or len(golden["seeds"]) != E_RUNS:
        fail(f"{E_GOLDEN} is not {E_RUNS} runs at {E_TICKS} ticks")
    params = dict(number_of_miners=10, byz_class_name="ETHSelfishMiner",
                  byz_mining_ratio=0.40,
                  network_latency_name="NetworkFixedLatency(1000)")
    proto = ETHPoW(**params, capacity=8192, device=dev)
    k = pick_superstep(proto, E_CHUNK, t0=0)

    def check(t, nets, ps):
        if t != E_TICKS:
            return
        net_np, ps_np = convert.to_numpy(nets, ps)
        thr = ps_np.pop("thr")
        got = convert.seed_digests(net_np, ps_np)
        for r, (g, w) in enumerate(zip(got, golden["seeds"])):
            check_digest(f"ETHPoW seed {r + 1} at {t} ticks", g, w)
        want_thr = np.asarray(golden["thr"], np.float32)
        if not np.array_equal(thr, want_thr):
            fail(f"ETHPoW thr {thr.tolist()}, the JAX run's "
                 f"{want_thr.tolist()}")
        counts = [chain_counts(nets, ps, r) for r in range(E_RUNS)]
        if any(c["dropped"] or c["clamped"] or c["arena_dropped"]
               for c in counts):
            fail(f"ETHPoW drops: {counts}")
        summary = [(c["height_max"], c["head_skew"], c["blocks"])
                   for c in counts]
        log(f"ETHPoW: all {E_RUNS} seeds match the JAX reference at {t} "
            f"ticks, {len(got[0])} leaves each and the {thr.size} floats of "
            f"thr; per seed (highest head, skew, blocks) "
            f"{summary}")
    with capture_route("route_ethpow", {0}):
        res, wall, peak, launches = harness_run(proto, E_RUNS, E_TICKS,
                                                E_CHUNK, 1, check)
    nets, ps = res.nets, res.pstates
    hours = E_TICKS * proto.tick_ms / 3.6e6
    row, line = miner_row(ps, E_RUNS, hours, "ETHSelfishMiner", 0.40,
                          params["network_latency_name"])
    want = golden["row"]
    if {k2: row[k2] for k2 in want} != want:
        fail(f"ETHPoW try_miner row {row}, the JAX run's {want}")
    log(f"ETHPoW try_miner row equals the JAX run's: {line}")
    PATH_LAUNCHES["ethpow"] = {"route": E_TICKS // k}
    out = dict(superstep=k, wall_s=wall, sim_ticks=E_TICKS,
               agg_sim_ticks_per_s=E_RUNS * E_TICKS / wall,
               peak_mem_bytes=peak, csv_row=line, **counts_of(nets, ps))
    window = scan_chunk(proto, OPS_MS, superstep=k)
    out["aten_ops_per_tick"] = ops_per_ms(
        lambda: window(nets, ps, t=E_TICKS), OPS_MS)
    seeds = torch.arange(1, E_RUNS + 1)
    for cap in (8192, 1024):
        small = ETHPoW(**params, capacity=cap, device=dev)
        state = init_batched(small, seeds)
        head = scan_chunk(small, E_OPS_TICKS, superstep=k)
        out[f"aten_ops_per_tick_{cap}"] = ops_per_ms(
            lambda: head(*state, t=0), E_OPS_TICKS)
    a, b = out["aten_ops_per_tick_8192"], out["aten_ops_per_tick_1024"]
    if abs(a - b) > 0.01 * b:
        fail(f"ETHPoW ops a tick grow with the arena: {a} at 8,192 blocks, "
             f"{b} at 1,024")
    return out, launches


# ------------------------- the scenario drivers and the P2P signatures


def _captured_harness(module, call):
    """``call()`` with `module`'s `run_multiple_times` captured: its
    return value and the last `run_multiple_times` result."""
    got = {}
    orig = module.run_multiple_times

    def capture(*a, **kw):
        got["res"] = orig(*a, **kw)
        return got["res"]
    module.run_multiple_times = capture
    try:
        out = call()
    finally:
        module.run_multiple_times = orig
    return out, got["res"]


def byz_counts(nets, ps):
    """Per seed of a Handel batch: drops, clamps, evictions, the live
    done fraction and the honest nodes with a non-empty blacklist."""
    live = ~nets.nodes.down
    frac = ((nets.nodes.done_at > 0) & live).sum(1) / live.sum(1)
    caught = ((ps.blacklist != 0).any(-1) & live).sum(1)
    return [{"dropped": int(nets.dropped[r]), "clamped": int(nets.clamped[r]),
             "evicted": int(ps.evicted[r]), "frac_done": float(frac[r]),
             "honest_blacklisted": int(caught[r])}
            for r in range(nets.time.shape[0])]


def byz_run(dev, n=BYZ_NODES, golden_path=BYZ_GOLDEN):
    """Path B: one point of Handel's Byzantine-fraction sweep through
    the entry point a user calls, ``handel_scenarios.byz_suicide_sweep(
    ratios=(0.25,), nodes=4096, seeds=4, device=dev)``: the sweep's 4
    seeds in one batch through `run_multiple_times` (chunk 250, max_time
    8,000, stored emission lists), counters set to 0 just before.  Its
    CSV text, every seed's stop time, leaf digests there and counters
    equal the JAX run's (the sweep's `run_multiple_times` result is
    captured); zero drops and clamps, honest blacklists non-empty.  A
    K1 case is captured from its windows at 100, 150, 200 and 250 ms
    (each capture clones the 1.2 GB ring)."""
    import tempfile

    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.scenarios import handel_scenarios as hs
    with open(golden_path) as f:
        golden = json.load(f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with capture_route("route_byz", {50, 75, 100, 125}), \
            tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        csv, res = _captured_harness(hs, lambda: hs.byz_suicide_sweep(
            ratios=(BYZ_RATIO,), nodes=n, seeds=BYZ_SEEDS, out_dir=d,
            device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counters()
    nets, ps = res.nets, res.pstates
    c0 = time.perf_counter()
    if str(csv) != golden["csv"]:
        fail(f"byz_suicide_sweep CSV {str(csv)!r}, the JAX run's "
             f"{golden['csv']!r}")
    stopped = [int(x) for x in res.stopped_at]
    if stopped != golden["stopped_at"]:
        fail(f"byz_suicide_sweep stops at {stopped}, the JAX run at "
             f"{golden['stopped_at']}")
    digests = convert.seed_digests(*convert.to_numpy(nets, ps))
    for r, (g, w) in enumerate(zip(digests, golden["seeds"])):
        check_digest(f"byz_suicide_sweep seed {r} at {stopped[r]} ms", g, w)
    counts = byz_counts(nets, ps)
    if counts != golden["counts"] or any(
            c["dropped"] or c["clamped"] or not c["honest_blacklisted"]
            for c in counts):
        fail(f"byz_suicide_sweep counts {counts}, the JAX run's "
             f"{golden['counts']} (want zero drops and clamps and "
             "non-empty honest blacklists)")
    log(f"byz_suicide_sweep at {n} nodes: the CSV row, the stop times and "
        f"all {BYZ_SEEDS} seeds' {len(digests[0])} leaves match the JAX "
        f"reference: {str(csv).splitlines()[1]} (checked in "
        f"{time.perf_counter() - c0:.1f} s)")
    sim = max(stopped)
    proto = hs.Handel(**hs.default_params(nodes=n, dead_ratio=BYZ_RATIO,
                                          byzantine_suicide=True),
                      device=dev)
    verify = sum(proto.phase_hints(t % proto.schedule_lcm)["verify"]
                 for t in range(sim))
    PATH_LAUNCHES["byz"] = {"route": sim // 2, "merge": sim, "score": verify}
    out = dict(superstep=2, wall_s=wall, sim_ms=sim,
               agg_sim_ms_per_s=BYZ_SEEDS * sim / wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               csv_row=str(csv).splitlines()[1],
               **counts_of(nets), honest_blacklisted=sum(
                   c["honest_blacklisted"] for c in counts))
    # a whole pairing period of ms (one verification ms in four)
    c0 = time.perf_counter()
    window = scan_chunk(proto, 4, superstep=2, timed_hints=True)
    out["aten_ops_per_ms"] = ops_per_ms(lambda: window(nets, ps, t=sim), 4)
    out["ops_window_s"] = time.perf_counter() - c0
    return out, launches


def eth2_run(dev, golden_path=ETH2_GOLDEN):
    """Path P, HandelEth2: ``HandelEth2()`` (64 nodes, pairing 3, level
    wait 100, period 50, 4 hash values) with the distance latency, seeds
    0-3 in one batch: dense to ETH2_MS in ETH2_CHUNK-ms
    `network.scan_chunk` calls at the proved K (2), then
    fast-forwarded (`fast_forward_chunk(seed_axis=True, superstep=2)`)
    in ETH2_FF_CHUNK-ms calls to ETH2_FF_MS (1,100 ms; 6,100, past the
    second aggregation's start, took 50-56 s on the card and was cut
    for time, to 1,600 and then 1,100: the CPU tests cover the start); every seed equal to its
    JAX golden at both times, every call's skip counts the JAX
    engine's, every node at the golden's height.  Counters set to 0
    before each run."""
    import torch
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch.core.network import (
        fast_forward_chunk, pick_superstep, scan_chunk)
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.handeleth2 import HandelEth2
    with open(golden_path) as f:
        golden = json.load(f)
    proto = HandelEth2(network_latency_name="NetworkLatencyByDistanceWJitter",
                       device=dev)
    k = pick_superstep(proto, ETH2_CHUNK, t0=0)
    if k != 2:
        fail(f"HandelEth2: the gate proves K={k}, want 2 (as JAX)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_batched(proto, torch.arange(P_SEEDS))
    reset_counters()
    (nets, ps), wall, _ = chunked(scan_chunk(proto, ETH2_CHUNK, superstep=k),
                                  state, 0, ETH2_MS, ETH2_CHUNK)
    launches = read_counters()
    check_seed_goldens(f"HandelEth2 x {P_SEEDS} seeds (dense)", nets, ps,
                       dict(golden["dense"]))
    PATH_LAUNCHES["eth2"] = {"route": ETH2_MS // k}
    dense = dict(superstep=k, wall_s=wall,
                 agg_sim_ms_per_s=P_SEEDS * ETH2_MS / wall,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 **counts_of(nets))
    # on a copy: the window updates the ring in place
    window = scan_chunk(proto, OPS_MS, superstep=k)
    copy = pytree.tree_map(torch.clone, (nets, ps))
    dense["aten_ops_per_ms"] = ops_per_ms(
        lambda: window(*copy, t=ETH2_MS), OPS_MS)
    del copy

    reset_counters()
    run = fast_forward_chunk(proto, ETH2_FF_CHUNK, seed_axis=True,
                             superstep=k)
    (nets, ps), ff_wall, stats = chunked(run, (nets, ps), ETH2_MS,
                                         ETH2_FF_MS, ETH2_FF_CHUNK, ff=True)
    ff_launches = read_counters()
    want = golden["fast_forward"]
    if stats != want["chunks"]:
        fail(f"fast-forwarded HandelEth2 skips {stats}, the JAX engine "
             f"{want['chunks']}")
    check_seed_goldens(f"HandelEth2 x {P_SEEDS} seeds (fast-forwarded)",
                       nets, ps, dict(want))
    skipped = sum(s["skipped_ms"] for s in stats)
    span = ETH2_FF_MS - ETH2_MS
    PATH_LAUNCHES["eth2_ff"] = {"route": (span - skipped) // k}
    ff = dict(superstep=k, wall_s=ff_wall, sim_ms=span,
              agg_sim_ms_per_s=P_SEEDS * span / ff_wall, skipped_ms=skipped,
              skip_rate=skipped / span,
              jump_count=sum(s["jump_count"] for s in stats),
              heights=sorted(set(ps.height.flatten().tolist())),
              peak_mem_bytes=torch.cuda.max_memory_allocated(),
              **counts_of(nets))
    heights = sorted({h for c in want["counts"] for h in c["heights"]})
    if dense["dropped"] or dense["clamped"] or ff["dropped"] or \
            ff["clamped"] or ff["heights"] != heights:
        fail(f"HandelEth2: want zero drops and clamps and every node at "
             f"height {heights}: {dense} {ff}")
    return {"eth2": (dense, launches), "eth2_ff": (ff, ff_launches)}


def until_stopped(run, state, chunk, cont, limit):
    """`run` (a chunk function) from t=0 in calls until `cont` holds for
    no seed of the batch; the host waits for the card after each.
    Returns the state, the stop time, the wall and each call's skip
    counts (fast-forwarded chunks)."""
    import torch
    t, wall, stats = 0, 0.0, []
    while True:
        c0 = time.perf_counter()
        if not bool(torch.func.vmap(cont)(*state).any()):
            wall += time.perf_counter() - c0
            return state, t, wall, stats
        if t >= limit:
            fail(f"the batch is still running at {t} ms")
        state = run(*state, t=t)
        if len(state) == 3:
            *state, st = state
            stats.append(st)
        torch.cuda.synchronize()
        wall += time.perf_counter() - c0
        t += chunk


def p2phandel_run(dev, golden_path=P2PH_GOLDEN):
    """Path P, P2PHandel: ``P2PHandel(**scenario_params(100, 20))`` (the
    P2PHandelParameters defaults of `p2phandel_scenarios.default_params(
    100, 20)`, the distance latency in place of the city one), seeds 0-3
    in one batch, fast-forwarded in P2PH_CHUNK-ms calls
    (`fast_forward_chunk(seed_axis=True, superstep=2)`) until
    `cont_if_p2phandel` stops every seed: the stop time, every call's
    skip counts and every seed's leaves the JAX run's there, zero drops
    and clamps.  Counters set to 0 just before; a K1 case captured."""
    import torch
    from wittgenstein_tpu_torch.core.network import fast_forward_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.p2phandel import (P2PHandel,
                                                         cont_if_p2phandel,
                                                         scenario_params)
    with open(golden_path) as f:
        golden = json.load(f)
    proto = P2PHandel(**scenario_params(), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_batched(proto, torch.arange(P_SEEDS))
    reset_counters()
    run = fast_forward_chunk(proto, P2PH_CHUNK, seed_axis=True, superstep=2)
    (nets, ps), sim, wall, stats = until_stopped(
        run, state, P2PH_CHUNK, cont_if_p2phandel, golden["ms"])
    launches = read_counters()
    if sim != golden["ms"] or stats != golden["chunks"]:
        fail(f"P2PHandel stops at {sim} ms skipping {stats}; the JAX run "
             f"at {golden['ms']} skipping {golden['chunks']}")
    check_seed_goldens(f"P2PHandel x {P_SEEDS} seeds (fast-forwarded)",
                       nets, ps, golden)
    skipped = sum(s["skipped_ms"] for s in stats)
    PATH_LAUNCHES["p2phandel"] = {"route": (sim - skipped) // 2}
    out = dict(superstep=2, wall_s=wall, sim_ms=sim,
               agg_sim_ms_per_s=P_SEEDS * sim / wall, skipped_ms=skipped,
               skip_rate=skipped / sim,
               jump_count=sum(s["jump_count"] for s in stats),
               done_max=int(nets.nodes.done_at.max()),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **counts_of(nets))
    if out["dropped"] or out["clamped"]:
        fail(f"P2PHandel drops and clamps must be 0: {out}")
    return out, launches


def optimistic_run(dev, golden_path=OPT_GOLDEN):
    """Path P, OptimisticP2PSignature: its `main` configuration
    (`main_params()`: 1,000 nodes, threshold 501, 13 peers, pairing 3)
    with the distance latency, seeds 0-3 in one batch, dense in
    OPT_CHUNK-ms `network.scan_chunk` calls at the proved K (2) until
    `cont_if_optimistic` stops every seed: the stop time and every
    seed's leaves the JAX run's there, and `test_optimistic_run`'s
    checks: every node done, cardinality at least 501, zero drops and
    clamps.  Counters set to 0 just before; a K1 case captured from its
    windows at 60, 100, 140 and 180 ms (the ring is 1.2 GB)."""
    import torch
    from wittgenstein_tpu_torch.core.network import (pick_superstep,
                                                     scan_chunk)
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.optimistic import (
        OptimisticP2PSignature, cont_if_optimistic, main_params)
    from wittgenstein_tpu_torch.ops import bitset
    with open(golden_path) as f:
        golden = json.load(f)
    proto = OptimisticP2PSignature(**main_params(), device=dev)
    k = pick_superstep(proto, OPT_CHUNK, t0=0)
    if k != 2:
        fail(f"OptimisticP2PSignature: the gate proves K={k}, want 2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_batched(proto, torch.arange(P_SEEDS))
    reset_counters()
    with capture_route("route_optimistic", {30, 50, 70, 90}):
        (nets, ps), sim, wall, _ = until_stopped(
            scan_chunk(proto, OPT_CHUNK, superstep=k), state, OPT_CHUNK,
            cont_if_optimistic, golden["ms"])
    launches = read_counters()
    if sim != golden["ms"]:
        fail(f"OptimisticP2PSignature stops at {sim} ms, the JAX run at "
             f"{golden['ms']}")
    check_seed_goldens(f"OptimisticP2PSignature x {P_SEEDS} seeds", nets,
                       ps, golden)
    PATH_LAUNCHES["optimistic"] = {"route": sim // k}
    card = bitset.popcount(ps.received)
    out = dict(superstep=k, wall_s=wall, sim_ms=sim,
               agg_sim_ms_per_s=P_SEEDS * sim / wall,
               min_cardinality=int(card.min()),
               all_done=bool((nets.nodes.done_at > 0).all() and ps.done.all()),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **counts_of(nets))
    window = scan_chunk(proto, OPS_MS, superstep=k)
    out["aten_ops_per_ms"] = ops_per_ms(lambda: window(nets, ps, t=sim),
                                        OPS_MS)
    if not out["all_done"] or out["min_cardinality"] < proto.threshold or \
            out["dropped"] or out["clamped"]:
        fail(f"OptimisticP2PSignature: want every node done with at least "
             f"{proto.threshold} signatures and zero drops: {out}")
    return out, launches


# ------------------------------------------- L: the city-latency scenarios


def _seed_counts(nets):
    """Per seed of a batch: drops, clamps and the latest doneAt."""
    return [{"dropped": int(nets.dropped[r]), "clamped": int(nets.clamped[r]),
             "done_max": int(nets.nodes.done_at[r].max())}
            for r in range(nets.time.shape[0])]


def _check_harness_golden(what, res, golden, counts):
    """The stop times, every seed's leaves and counts of a
    `run_multiple_times` result equal to the JAX run's."""
    from wittgenstein_tpu_torch import convert
    stopped = [int(x) for x in res.stopped_at]
    if stopped != golden["stopped_at"]:
        fail(f"{what} stops at {stopped}, the JAX run at "
             f"{golden['stopped_at']}")
    digests = convert.seed_digests(*convert.to_numpy(res.nets, res.pstates))
    if len(digests) != len(golden["seeds"]):
        fail(f"{what}: {len(digests)} seeds, the golden has "
             f"{len(golden['seeds'])}")
    for r, (g, w) in enumerate(zip(digests, golden["seeds"])):
        check_digest(f"{what} seed {r} at {stopped[r]} ms", g, w)
    if counts != golden["counts"]:
        fail(f"{what} counts {counts}, the JAX run's {golden['counts']}")
    log(f"{what}: the stop times and all {len(digests)} seeds' "
        f"{len(digests[0])} leaves match the JAX reference")
    return max(stopped)


def city_p2phandel_run(dev, golden_path=CITY_P2PH_GOLDEN):
    """Path L(a): the JAX package's P2PHandel scenario as a researcher
    runs it, ``p2phandel_scenarios.basic_stats(P2PHandel(
    **default_params(100, 20)), seeds=4)``: 120 nodes placed by city,
    the city latency with its jitter, the P2PHandelParameters defaults;
    seeds 0-3 in one `run_multiple_times` batch (chunk 500, the proved
    K) until `cont_if_p2phandel` stops every seed, counters set to 0
    just before.  The stats dict, the stop times and every seed's leaves
    there equal the JAX run's; zero drops and clamps.  A K1 case is
    captured from every tenth window of its first 3,000 ms (the
    busiest; each capture reads the card)."""
    import torch
    from wittgenstein_tpu_torch.core.network import pick_superstep
    from wittgenstein_tpu_torch.scenarios import p2phandel_scenarios as psc
    with open(golden_path) as f:
        golden = json.load(f)
    proto = psc.P2PHandel(**psc.default_params(100, 20), device=dev)
    k = pick_superstep(proto, 500, t0=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with capture_route("route_p2phandel_city", set(range(0, 3000 // k, 10))):
        t0 = time.perf_counter()
        stats, res = _captured_harness(
            psc, lambda: psc.basic_stats(proto, len(golden["seeds"])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counters()
    if stats != golden["stats"]:
        fail(f"P2PHandel (cities) stats {stats}, the JAX run's "
             f"{golden['stats']}")
    nets, ps = res.nets, res.pstates
    counts = _seed_counts(nets)
    sim = _check_harness_golden("P2PHandel (cities) basic_stats", res,
                                golden, counts)
    PATH_LAUNCHES["p2phandel_city"] = {"route": sim // k}
    out = dict(superstep=k, wall_s=wall, sim_ms=sim,
               agg_sim_ms_per_s=len(counts) * sim / wall, stats=stats,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **counts_of(nets))
    if out["dropped"] or out["clamped"]:
        fail(f"P2PHandel (cities) drops and clamps must be 0: {out}")
    out["aten_ops_per_ms"] = ops_at(proto, k, nets, ps, sim)
    return out, launches


def city_optimistic_run(dev, n=CITY_OPT_NODES, seeds=CITY_OPT_SEEDS,
                        refused=CITY_OPT_REFUSED,
                        golden_path=CITY_OPT_GOLDEN):
    """Path L(b): ``optimistic_scenarios.node_scaling`` (cities, the
    city jitter, threshold 99%, 4 connections, pairing 3), 2 seeds in
    one `run_multiple_times` batch.  At its ladder's largest point,
    ``counts=(1024,)``, the JAX package's own run overflows the 192-slot
    inboxes and its harness refuses (as at every point of the ladder,
    128-1,024 nodes): the port must refuse with the same count of
    dropped and clamped messages.  At ``counts=(64,)``, which completes,
    counters set to 0 just before: the CSV text, the stop times and
    every seed's leaves equal the JAX run's; every node done with at
    least `threshold` signatures, zero drops and clamps."""
    import tempfile

    import torch
    from wittgenstein_tpu_torch.core.network import pick_superstep
    from wittgenstein_tpu_torch.ops import bitset
    from wittgenstein_tpu_torch.scenarios import optimistic_scenarios as osc
    with open(golden_path) as f:
        golden = json.load(f)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        if refused:
            c0 = time.perf_counter()
            count = None
            try:
                osc.node_scaling(counts=(refused,), seeds=seeds, out_dir=d,
                                 device=dev)
            except RuntimeError as e:
                head = str(e).split(" messages dropped/clamped", 1)[0]
                count = int(head) if head.isdigit() else str(e)
            want = golden["refused"]["dropped_or_clamped"]
            if count != want:
                fail(f"optimistic node_scaling({refused}): the port gives "
                     f"{count!r}, the JAX run refuses with {want} messages "
                     "dropped or clamped")
            log(f"optimistic node_scaling({refused}) refuses as the JAX run "
                f"does: {count} messages dropped or clamped")
            out["refused"] = {"nodes": refused, "dropped_or_clamped": count,
                              "wall_s": time.perf_counter() - c0}
        proto = osc.OptimisticP2PSignature(**osc.default_params(n),
                                           device=dev)
        k = pick_superstep(proto, 500, t0=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        csv, res = _captured_harness(osc, lambda: osc.node_scaling(
            counts=(n,), seeds=seeds, out_dir=d, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counters()
    if str(csv) != golden["csv"]:
        fail(f"optimistic_scenarios.node_scaling CSV {str(csv)!r}, the JAX "
             f"run's {golden['csv']!r}")
    nets, ps = res.nets, res.pstates
    counts = _seed_counts(nets)
    card = bitset.popcount(ps.received).min(-1).values
    for r, c in enumerate(counts):
        c["min_cardinality"] = int(card[r])
        c["all_done"] = bool(ps.done[r].all())
    sim = _check_harness_golden(f"Optimistic {n} (cities) node_scaling",
                                res, golden, counts)
    PATH_LAUNCHES["optimistic_city"] = {"route": sim // k}
    out.update(superstep=k, wall_s=wall, sim_ms=sim,
               agg_sim_ms_per_s=seeds * sim / wall,
               csv_row=str(csv).splitlines()[1],
               min_cardinality=int(card.min()),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **counts_of(nets))
    if not all(c["all_done"] for c in counts) or \
            out["min_cardinality"] < proto.threshold or out["dropped"] or \
            out["clamped"]:
        fail(f"Optimistic (cities): want every node done with at least "
             f"{proto.threshold} signatures and zero drops: {out}")
    out["aten_ops_per_ms"] = ops_at(proto, k, nets, ps, sim)
    return out, launches


# --------------------------------------- A: ENR, Slush, Snowflake, Paxos


def _a_result(what, proto, nets, ps, sim, wall, k, golden, stats=()):
    """A phase-A path's record after its goldens held: wall, memory,
    ops a simulated ms (one more window of OPS_MS, on a copy), counts."""
    import torch
    out = dict(superstep=k, wall_s=wall, sim_ms=sim,
               agg_sim_ms_per_s=nets.time.shape[0] * sim / wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               **counts_of(nets))
    if stats:
        skipped = sum(s["skipped_ms"] for s in stats)
        out.update(skipped_ms=skipped, skip_rate=skipped / sim,
                   jump_count=sum(s["jump_count"] for s in stats))
    if out["dropped"] or out["clamped"]:
        fail(f"{what}: drops and clamps must be 0: {out}")
    out["aten_ops_per_ms"] = ops_at(proto, k, nets, ps, sim)
    return out


def enr_run(dev, key="enr", golden_path=ENR_GOLDEN):
    """Path A, ENR: ``ENRGossiping(**params)`` with the golden's params,
    its four seeds in one batch, dense in ENR_CHUNK-ms `network.scan_chunk`
    calls to the golden's ms, counters set to 0 just before: every seed
    equal to its JAX golden, zero drops, and the step hint reporting a
    joiner or a capability change at the golden's ms and no other.
    ENR_GOLDEN is ``ENRGossiping()`` (50 nodes, 8 joiner slots, the
    distance latency) to 250 ms (cut for time from 1,000: the first
    records gossip; no joiner comes up and no change falls due there);
    ENR_CHURN_GOLDEN is tests/test_enr.py's churn configuration (40
    nodes, a joiner every 500 ms, quick exits), seeds 22-25 to 750 ms,
    which hold a join, a capability change and an exit, so that the
    joiners' links, `p2p.disconnect` and the capability draw run on
    the card.  Churn
    changes liveness in the step, so K=1."""
    import torch
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.enr import ENRGossiping
    with open(golden_path) as f:
        golden = json.load(f)
    proto = ENRGossiping(**golden["params"], device=dev)
    hinted = {"join_ms": [], "change_ms": []}

    def step_hint(p, inbox, t):
        hint = ENRGossiping.step_hint(proto, p, inbox, t)
        for name, on in zip(("join_ms", "change_ms"), hint[1:]):
            if on:
                hinted[name].append(t)
        return hint
    proto.step_hint = step_hint
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = golden["first_seed"]
    state = init_batched(proto, torch.arange(first,
                                             first + len(golden["seeds"])))
    reset_counters()
    (nets, ps), wall, _ = chunked(scan_chunk(proto, ENR_CHUNK), state, 0,
                                  golden["ms"], ENR_CHUNK)
    launches = read_counters()
    del proto.step_hint             # the ops window below is not the run
    what = f"{proto!r} x {len(golden['seeds'])} seeds"
    check_seed_goldens(what, nets, ps, golden)
    if hinted != golden["hint"]:
        fail(f"{what}: the step hint reports {hinted}, the JAX batch's "
             f"state {golden['hint']}")
    if golden["params"] and not all(hinted.values()):
        fail(f"{what}: the churn batch must see a joiner and a capability "
             f"change: {hinted}")
    log(f"{what}: the step hint reports joiners at {hinted['join_ms']} and "
        f"capability changes at {hinted['change_ms']} ms, as the JAX "
        "batch's state has them")
    PATH_LAUNCHES[key] = {"route": golden["ms"]}
    out = _a_result(what, proto, nets, ps, golden["ms"], wall, 1, golden)
    out.update(hinted, live=[int(x) for x in (~nets.nodes.down).sum(1)])
    return out, launches


def avalanche_run(dev, name):
    """Path A, Slush or Snowflake: ``Slush()`` / ``Snowflake()`` (100
    nodes, K 7, the distance latency), seeds 0-3 in one batch,
    fast-forwarded (`fast_forward_chunk(seed_axis=True)`, K=1 as the
    JAX engine runs it) in AV_CHUNK-ms calls until every node of every
    seed has decided, counters set to 0 just before: the stop time,
    every call's skip counts and every seed's leaves the JAX run's
    there, zero drops."""
    import torch
    from wittgenstein_tpu_torch.core.network import fast_forward_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models import avalanche
    with open(AV_GOLDEN[name]) as f:
        golden = json.load(f)
    proto = getattr(avalanche, name)(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_batched(proto, torch.arange(len(golden["seeds"])))
    reset_counters()
    run = fast_forward_chunk(proto, AV_CHUNK, seed_axis=True)
    (nets, ps), sim, wall, stats = until_stopped(
        run, state, AV_CHUNK, lambda net, p: ~p.decided.all(), golden["ms"])
    launches = read_counters()
    if sim != golden["ms"] or stats != golden["chunks"]:
        fail(f"{name} stops at {sim} ms skipping {stats}; the JAX run at "
             f"{golden['ms']} skipping {golden['chunks']}")
    check_seed_goldens(f"{name} x {len(golden['seeds'])} seeds "
                       "(fast-forwarded)", nets, ps, golden)
    PATH_LAUNCHES[name.lower()] = {
        "route": sim - sum(s["skipped_ms"] for s in stats)}
    return _a_result(name, proto, nets, ps, sim, wall, 1, golden,
                     stats), launches


def paxos_run(dev, golden_path=PAXOS_GOLDEN):
    """Path A, Paxos: ``Paxos()`` (3 acceptors, 3 proposers, timeout
    1,000, the distance latency), seeds 0-3 in one batch, dense in
    PAXOS_CHUNK-ms `network.scan_chunk` calls (K=1, the step hint
    walking only the inbox slots that hold a message) until `cont_if`
    stops every seed, counters set to 0 just before: the stop time and
    every seed's leaves the JAX run's there, one agreed value a seed,
    zero drops."""
    import torch
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.paxos import Paxos
    with open(golden_path) as f:
        golden = json.load(f)
    proto = Paxos(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_batched(proto, torch.arange(len(golden["seeds"])))
    reset_counters()
    (nets, ps), sim, wall, _ = until_stopped(
        scan_chunk(proto, PAXOS_CHUNK), state, PAXOS_CHUNK, proto.cont_if(),
        golden["ms"])
    launches = read_counters()
    if sim != golden["ms"]:
        fail(f"Paxos stops at {sim} ms, the JAX run at {golden['ms']}")
    check_seed_goldens(f"Paxos x {len(golden['seeds'])} seeds", nets, ps,
                       golden)
    va = ps.value_accepted[:, proto.a:]
    if not bool((va == va[:, :1]).all() & (va >= 0).all()):
        fail(f"Paxos: every proposer of a seed must accept one value: {va}")
    PATH_LAUNCHES["paxos"] = {"route": sim}
    return _a_result("Paxos", proto, nets, ps, sim, wall, 1,
                     golden), launches



#: kernel names (substrings of the profiler's keys) whose device time
#: a simulated ms `--profile` reports for each path
PROFILE_KERNELS = {
    "handel": {"route": "route_", "merge": "merge_kernel",
               "score": "score_kernel"},
    "gsf": {"route": "route_", "gsf_merge": "gsf_merge_kernel",
            "gsf_score": "gsf_score_kernel"}}
PROFILE_KERNELS["headline"] = PROFILE_KERNELS["handel"]
PROFILE_KERNELS["pingpong"] = {"route": "route_"}
PROFILE_KERNELS["gsf_batch"] = PROFILE_KERNELS["gsf"]
PROFILE_KERNELS["t2"] = PROFILE_KERNELS["handel"]
for _path in ("sanfermin", "dfinity", "quiet_dfinity", "quiet_p2pflood"):
    PROFILE_KERNELS[_path] = {"route": "route_"}
PROFILE_KERNELS["t3"] = {"route": "route_"}


def dense_window(proto, start, ms):
    """A closure that runs `ms` simulated ms of `proto` from t = `start`
    (seed 0, `Runner.run_ms`), the run to `start` done here."""
    from wittgenstein_tpu_torch.core.network import Runner
    runner = Runner(proto)
    net, ps = runner.run_ms(*proto.init(0), start)
    return lambda: runner.run_ms(net, ps, ms)


def headline_window(dev, start, ms):
    """The same for the headline batch, in phase-specialized chunks."""
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    proto, (nets, ps) = headline_init(dev)
    run = scan_chunk_batched(proto, HEADLINE_CHUNK, t0_mod=0)
    for t in range(0, start, HEADLINE_CHUNK):
        nets, ps = run(nets, ps, t=t)
    window = scan_chunk_batched(proto, ms, t0_mod=0)
    return lambda: window(nets, ps, t=start)


def gsf_batch_window(dev, start, ms, k):
    """The same for the GSF batch (4 seeds) at K=1 (`scan_chunk`) or on
    the seed-folded engine at K=k (`start` and `ms` multiples of k)."""
    import torch
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    proto = GSFSignature(node_count=GSF_NODES, device=dev)
    nets, ps = init_batched(proto, torch.arange(GSF_SEEDS))

    def chunk(n):
        return (scan_chunk(proto, n) if k == 1 else
                scan_chunk_batched(proto, n, superstep=k))
    nets, ps = chunk(start)(nets, ps, t=0)
    window = chunk(ms)
    return lambda: window(nets, ps, t=start)


def scale_window(dev, line, start, ms):
    """The same for a scale line, one seed, in phase-specialized
    chunks."""
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    proto, (nets, ps) = scale_init(dev, line)
    nets, ps = scan_chunk_batched(proto, start, t0_mod=0)(nets, ps, t=0)
    window = scan_chunk_batched(proto, ms, t0_mod=0)
    return lambda: window(nets, ps, t=start)


def protocol_window(dev, path, start, ms):
    """The same for S, D and Q's batches: dense `network.scan_chunk` at
    K=2 from init to `start`, then a window of `ms`."""
    import dataclasses

    import torch
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.dfinity import (Dfinity,
                                                       tracked_10k_params)
    from wittgenstein_tpu_torch.models.p2pflood import P2PFlood, quiet_params
    from wittgenstein_tpu_torch.models.sanfermin import SanFermin
    if path == "sanfermin":
        proto = SanFermin(node_count=SF_NODES, inbox_cap=16, device=dev)
        proto.cfg = dataclasses.replace(proto.cfg, box_split=SF_BOX_SPLIT)
        state = proto.init(0)
    elif path == "dfinity":
        proto = Dfinity(**tracked_10k_params(), device=dev)
        state = proto.init(0)
    else:
        proto = (Dfinity(device=dev) if path == "quiet_dfinity" else
                 P2PFlood(**quiet_params(), device=dev))
        state = init_batched(proto, torch.arange(Q_SEEDS))
    if start:
        state = scan_chunk(proto, start, superstep=2)(*state, t=0)
    window = scan_chunk(proto, ms, superstep=2)
    return lambda: window(*state, t=start)


def profile(label, window, start, ms, path, kernels):
    """torch.profiler over `window()`, `ms` simulated ms from t =
    `start`; the table goes to `path`.  Returns the device-busy share,
    the PyTorch ops a simulated ms and the device us a simulated ms of
    each of `kernels` (name -> substring of its kernels' names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = kernel_device_us(ka)
    # PyTorch ops the step issued: top-level aten calls, not the ones
    # they make inside (a cast's copy, a where's broadcast).
    ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
              and e.cpu_parent is None and e.name.startswith("aten::"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{label}: {ms} simulated ms from t={start}, wall "
                f"{wall:.6f} s, device time {dev_us / 1e6:.6f} s, aten ops "
                f"{ops}\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    busy = dev_us / 1e6 / wall
    per_ms = {k: kernel_device_us(ka, match) / ms
              for k, match in kernels.items()}
    log(f"profile {label}: {ms} ms from t={start}, wall "
        f"{wall:.6f} s, device busy {dev_us / 1e6:.6f} s "
        f"({100 * busy:.1f}%), {ops / ms:.0f} aten ops a simulated ms, "
        f"device {dev_us / ms:.2f} us a simulated ms, of which kernels "
        f"(us) {json.dumps(per_ms)}")
    return dict(wall_s=wall, device_s=dev_us / 1e6, busy=busy,
                aten_ops_per_ms=ops / ms, device_us_per_ms=dev_us / ms,
                kernel_us_per_ms=per_ms, ms=ms, start=start)


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="MS")
    ap.add_argument("--profile-file", default="profile.txt")
    ap.add_argument("--profile-gsf-file", default="profile_gsf.txt")
    ap.add_argument("--profile-headline-file",
                    default="profile_headline.txt")
    ap.add_argument("--profile-pingpong-file",
                    default="profile_pingpong.txt")
    ap.add_argument("--profile-gsf-batch-file",
                    default="profile_gsf_batch.txt")
    ap.add_argument("--profile-t3-file", default="profile_t3.txt")
    ap.add_argument("--profile-t2-file", default="profile_t2.txt")
    ap.add_argument("--profile-protocols-prefix", default="profile_")
    ap.add_argument("--profile-gsf32k-file", default="profile_gsf32k.txt")
    ap.add_argument("--memory-seeds", type=int, default=0, metavar="R")
    ap.add_argument("--only-chaos", action="store_true",
                    help="build, then phase X alone, without the "
                    "summary lines")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    try:
        from wittgenstein_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port package ({e}); run from the root of "
             "a checkout")
    dev = torch.device("cuda")
    start = time.perf_counter()

    def done(phase):
        log(f"phase {phase} done at {time.perf_counter() - start:.1f} s")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_build.BUILD_INFO.get('seconds', 0.0):.1f} s), "
        f"{_build.BUILD_INFO['lib']}")
    for src, report in sorted(_build.BUILD_INFO.get("ptxas", {}).items()):
        for line in report.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                log(f"ptxas {src}: {line.strip()}")

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    results = {}

    def kernel_case(name):
        """Run a kernel entry's case against its plain version and log
        its times."""
        phase = next(e[5] for e in KERNELS if e[0] == name)
        t0 = time.perf_counter()
        results[name] = r = phase(dev, rng)
        r["case_s"] = time.perf_counter() - t0
        log(f"kernel {name} ({time.perf_counter() - t0:.1f} s): bit-equal "
            f"to its plain version; device "
            f"{r['ms'] * 1e3:.2f} us cold, {r['warm_ms'] * 1e3:.2f} us warm"
            f" vs plain {r['plain_ms'] * 1e3:.2f} us;"
            f" per call {r['call_ms'] * 1e3:.2f} us vs plain "
            f"{r['plain_call_ms'] * 1e3:.2f} us"
            + (f"; phases {r['phases_us']}" if "phases_us" in r else ""))
    if args.only_chaos:
        t0 = time.perf_counter()
        for key, (res_, _) in chaos_phase(dev, None).items():
            log(f"{key}: {json.dumps(res_)}")
        log(f"phase X: {time.perf_counter() - t0:.1f} s")
        done("X")
        return 0
    for name, *_ in KERNELS:
        if name not in CAPTURED:
            kernel_case(name)

    done("2")
    # 3. the Handel path
    res, launches, final_np, mid_digest = main_path(dev)
    log(f"Handel path: {json.dumps(res)} launches {launches}")
    if not res["frac_done"] > 0.99:
        fail(f"Handel did not converge: live frac_done {res['frac_done']}")
    if res["dropped"] or res["clamped"] or res["bc_dropped"] or \
            res["evicted"]:
        fail(f"drops/clamps/evictions must be 0: {res}")
    check_launches("handel", launches)

    done("3")

    # 3b. the GSF path
    gres, glaunches, gfinal_np, gmid_digest = gsf_path(dev)
    log(f"GSF path: {json.dumps(gres)} launches {glaunches}")
    if not gres["frac_done"] > 0.99:
        fail(f"GSF did not converge: live frac_done {gres['frac_done']}")
    if gres["dropped"] or gres["clamped"] or gres["bc_dropped"]:
        fail(f"GSF drops/clamps must be 0: {gres}")
    check_launches("gsf", glaunches)

    done("3b")

    # 4. against the reference
    golden_and_determinism(dev, mid_digest)
    gsf_golden_and_determinism(dev, gfinal_np, gmid_digest)

    done("4")

    # 5. the benchmark headline, 16 seeds in one batch
    hres, hlaunches, hdigests, hfirst = headline_run(
        dev, load_golden(HEADLINE_GOLDEN, HEADLINE_CHUNK, HEADLINE_SEEDS))
    log(f"headline: {json.dumps(hres)} launches {hlaunches}")
    if not hres["frac_done"] > 0.99:
        fail(f"headline did not converge: mean live frac_done "
             f"{hres['frac_done']}")
    if hres["dropped"] or hres["clamped"] or hres["bc_dropped"] or \
            hres["evicted"]:
        fail(f"headline drops/clamps/evictions must be 0: {hres}")
    check_launches("headline", hlaunches)

    done("5")

    # 5b. against the reference and the dense path
    headline_determinism(dev, hfirst, hdigests, final_np)

    done("5b")

    # 6. PingPong on the per-ms engine
    pres, plaunches, pdigests, _ = pingpong_run(dev)
    log(f"PingPong path: {json.dumps(pres)} launches {plaunches}")
    check_pingpong(pres)
    check_launches("pingpong", plaunches)

    done("6")

    # 6b. against the reference
    pingpong_golden_and_determinism(dev, pres, pdigests)

    done("6b")

    # 6c. the harness, 16 seeds at K=2
    hpres, hplaunches = pingpong_harness(dev, pdigests)
    log(f"PingPong harness: {json.dumps(hpres)} launches {hplaunches}")
    check_launches("pingpong_harness", hplaunches)

    done("6c")

    # 6d. the spill buffer
    sres, slaunches = spill_path(dev)
    log(f"spill: {json.dumps(sres)} launches {slaunches}")
    check_launches("spill", slaunches)
    done("6d")

    # 7. GSF on a seed batch, at K=1 and on the seed-folded engine at K=2
    gbres, gblaunches = gsf_batch_run(dev, 1)
    log(f"GSF batch, K=1: {json.dumps(gbres)} launches {gblaunches}")
    check_launches("gsf_batch", gblaunches)
    gb2res, gb2launches = gsf_batch_run(dev, 2)
    log(f"GSF batch, K=2: {json.dumps(gb2res)} launches {gb2launches}")
    check_launches("gsf_batch_k2", gb2launches)
    done("7")

    # 8. the fast-forward engine, beside the dense runs of its paths
    fares, falaunches = ff_headline(dev, hres["chunk_walls_s"][0])
    log(f"fast-forwarded headline: {json.dumps(fares)} launches "
        f"{falaunches}")
    check_launches("ff_headline", falaunches)
    fbres, fblaunches = ff_pingpong(dev, pres["wall_s"])
    log(f"fast-forwarded PingPong: {json.dumps(fbres)} launches "
        f"{fblaunches}")
    check_launches("ff_pingpong", fblaunches)
    fcres, fclaunches = ff_pingpong_batch(dev)
    log(f"fast-forwarded PingPong batch: {json.dumps(fcres)} launches "
        f"{fclaunches}")
    check_launches("ff_pingpong_batch", fclaunches)
    done("8")

    # 9-10. Handel's scale lines, one seed each on the seed-folded engine
    t3res, t3launches = scale_run(dev, "t3")
    log(f"tier 3 (cardinal {T3_NODES}): {json.dumps(t3res)} launches "
        f"{t3launches}")
    check_launches("t3", t3launches)
    done("9")
    t2res, t2launches = scale_run(dev, "t2")
    log(f"tier 2 (exact {T2_NODES}, hashed, pool-free, 2 q_sig pieces, 2 "
        f"ring sub-planes): {json.dumps(t2res)} launches {t2launches}")
    check_launches("t2", t2launches)
    done("10")

    # 11. an attack mode against its golden
    ares, alaunches = attack_run(dev)
    log(f"attacked Handel: {json.dumps(ares)} launches {alaunches}")
    check_launches("attack", alaunches)
    done("11")

    # S. SanFermin 32k, bench_suite's line, and K1 on its window
    sfres, sflaunches = sanfermin_run(dev)
    log(f"SanFermin {SF_NODES}: {json.dumps(sfres)} launches {sflaunches}")
    check_launches("sanfermin", sflaunches)
    kernel_case("route_sanfermin")
    done("S")

    # C. SanFerminCappos at its default 2,048 nodes
    cres, claunches = cappos_run(dev)
    log(f"Cappos 2048: {json.dumps(cres)} launches {claunches}")
    check_launches("cappos", claunches)
    done("C")

    # D. Dfinity 10k validators, dense and fast-forwarded
    (dres, dlaunches), (dfres, dflaunches) = dfinity_run(dev)
    log(f"Dfinity 10k, dense: {json.dumps(dres)} launches {dlaunches}")
    log(f"Dfinity 10k, fast-forwarded: {json.dumps(dfres)} launches "
        f"{dflaunches}")
    check_launches("dfinity", dlaunches)
    check_launches("dfinity_ff", dflaunches)
    kernel_case("route_dfinity")
    done("D")

    # Q. bench.py's quiet lines, 4 seeds each
    quiet = {**quiet_run(dev, "dfinity"), **quiet_run(dev, "p2pflood")}
    for key, (qres, qlaunches) in quiet.items():
        log(f"{key}: {json.dumps(qres)} launches {qlaunches}")
        check_launches(key, qlaunches)
    kernel_case("route_p2pflood")
    done("Q")

    # K. Casper IMD's reference configuration, 8 seeds
    kres, klaunches = casper_run(dev)
    log(f"Casper IMD {K_SEEDS} seeds: {json.dumps(kres)} launches "
        f"{klaunches}")
    check_launches("casper", klaunches)
    kernel_case("route_casper")
    done("K")

    # E. ETHPoW, try_miner's selfish-mining batch at one point
    eres, elaunches = ethpow_run(dev)
    log(f"ETHPoW {E_RUNS} runs: {json.dumps(eres)} launches {elaunches}")
    check_launches("ethpow", elaunches)
    kernel_case("route_ethpow")
    done("E")

    # B. one point of Handel's Byzantine-fraction sweep at 4,096 nodes
    t0 = time.perf_counter()
    bres, blaunches = byz_run(dev)
    log(f"byz_suicide_sweep {BYZ_NODES} x {BYZ_SEEDS} seeds: "
        f"{json.dumps(bres)} launches {blaunches}")
    check_launches("byz", blaunches)
    kernel_case("route_byz")
    done("B")

    # P. HandelEth2, P2PHandel and OptimisticP2PSignature, 4 seeds each
    protos = eth2_run(dev)
    protos["p2phandel"] = p2phandel_run(dev)
    protos["optimistic"] = optimistic_run(dev)
    for key, (pres_, plaunches_) in protos.items():
        log(f"{key}: {json.dumps(pres_)} launches {plaunches_}")
        check_launches(key, plaunches_)
    kernel_case("route_optimistic")
    bp_wall = time.perf_counter() - t0
    log(f"phases B and P: {bp_wall:.1f} s")
    done("P")

    # L. the P2PHandel and Optimistic scenarios on the city latency
    t0 = time.perf_counter()
    lat = {"p2phandel_city": city_p2phandel_run(dev),
           "optimistic_city": city_optimistic_run(dev)}
    for key, (lres_, llaunches_) in lat.items():
        log(f"{key}: {json.dumps(lres_)} launches {llaunches_}")
        check_launches(key, llaunches_)
    kernel_case("route_p2phandel_city")
    done("L")

    # A. ENR, Slush, Snowflake and Paxos, 4 seeds each
    committee = {"enr": enr_run(dev),
                 "enr_churn": enr_run(dev, "enr_churn", ENR_CHURN_GOLDEN),
                 **{name.lower(): avalanche_run(dev, name)
                    for name in ("Slush", "Snowflake")},
                 "paxos": paxos_run(dev)}
    for key, (cres_, claunches_) in committee.items():
        log(f"{key}: {json.dumps(cres_)} launches {claunches_}")
        check_launches(key, claunches_)
    la_wall = time.perf_counter() - t0
    log(f"phases L and A: {la_wall:.1f} s")
    done("A")

    # G32. GSF at the reference's 32,768 nodes, and K1 on its window
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    g32res, g32launches = gsf32k_run(dev)
    log(f"GSF {G32_NODES}: {json.dumps(g32res)} launches {g32launches}")
    check_launches("gsf32k", g32launches)
    kernel_case("route_gsf32k")
    g32_wall = time.perf_counter() - t0 + sum(
        results[k]["case_s"] for k in ("gsf_merge_32k", "gsf_score_32k"))
    log(f"phase G32 with its phase-2 kernel cases: {g32_wall:.1f} s")
    done("G32")

    # O. PingPong 64 under each obs plane, held to the JAX planes
    obs = obs_run(dev)
    for key, (ores, olaunches) in obs.items():
        log(f"{key}: {json.dumps(ores)} launches {olaunches}")
        check_launches(key, olaunches)
    done("O")

    # X. the chaos plane on the headline, a checkpoint across an outage,
    # lane freezing
    t0 = time.perf_counter()
    chaos = chaos_phase(dev, hres[f"impact_{HEADLINE_CHUNK}ms"])
    x_wall = time.perf_counter() - t0
    log(f"phase X: {x_wall:.1f} s")
    done("X")

    memory = {}
    if args.memory_seeds:
        memory = {line: scale_memory(dev, line, args.memory_seeds, ms)
                  for line, ms in (("t3", T3_CHUNK), ("t2", T2_CHUNK))}
        done("memory")

    profiles = {}
    if args.profile:
        from wittgenstein_tpu_torch.models.gsf import GSFSignature
        from wittgenstein_tpu_torch.models.handel import (
            Handel, reference_default_params)
        handel = Handel(**reference_default_params(N_NODES), device=dev)
        profiles["handel"] = profile(
            "Handel 2048 nodes", dense_window(handel, 600, args.profile),
            600, args.profile, args.profile_file, PROFILE_KERNELS["handel"])
        profiles["gsf"] = profile(
            "GSFSignature 4096 nodes",
            dense_window(GSFSignature(node_count=GSF_NODES, device=dev), 300,
                         args.profile),
            300, args.profile, args.profile_gsf_file, PROFILE_KERNELS["gsf"])
        # The headline's window is whole schedule periods (20 ms).
        hms = -(-args.profile // handel.schedule_lcm) * handel.schedule_lcm
        profiles["headline"] = profile(
            f"headline {HEADLINE_SEEDS} seeds x {N_NODES} nodes",
            headline_window(dev, 600, hms), 600, hms,
            args.profile_headline_file, PROFILE_KERNELS["headline"])
        if profiles["headline"]["aten_ops_per_ms"] > \
                profiles["handel"]["aten_ops_per_ms"]:
            fail("the headline issues more PyTorch ops a simulated ms than "
                 "the dense one-seed path")
        from wittgenstein_tpu_torch.models.pingpong import PingPong
        profiles["pingpong"] = profile(
            f"PingPong {PP_NODES} nodes",
            dense_window(PingPong(node_count=PP_NODES, device=dev), 0,
                         args.profile),
            0, args.profile, args.profile_pingpong_file,
            PROFILE_KERNELS["pingpong"])
        # K=1, then K=2 (the window rounded up to whole K=2 windows; its
        # table beside K=1's, "_k2" added to the file name).
        for k, key in ((1, "gsf_batch"), (2, "gsf_batch_k2")):
            gms = -(-args.profile // k) * k
            root, ext = os.path.splitext(args.profile_gsf_batch_file)
            profiles[key] = profile(
                f"GSFSignature {GSF_NODES} nodes x {GSF_SEEDS} seeds, K={k}",
                gsf_batch_window(dev, 300, gms, k), 300, gms,
                root + ("_k2" if k == 2 else "") + ext,
                PROFILE_KERNELS["gsf_batch"])
        for line, start, label, path in (
                ("t3", 600, f"tier 3, cardinal {T3_NODES} nodes",
                 args.profile_t3_file),
                ("t2", 200, f"tier 2, exact {T2_NODES} nodes",
                 args.profile_t2_file)):
            profiles[line] = profile(label, scale_window(dev, line, start,
                                                         hms),
                                     start, hms, path, PROFILE_KERNELS[line])
        # S from t=300 (the first reply timeouts fire at 301), D and Q
        # from 0 (the beacon kick, the floods); windows of whole K=2
        # windows
        pms = -(-args.profile // 2) * 2
        for path, start, label in (
                ("sanfermin", 300, f"SanFermin {SF_NODES} nodes"),
                ("dfinity", 0, "Dfinity 10,111 nodes"),
                ("quiet_dfinity", 0, f"Dfinity 31 nodes x {Q_SEEDS} seeds"),
                ("quiet_p2pflood", 0,
                 f"P2PFlood 256 nodes x {Q_SEEDS} seeds")):
            profiles[path] = profile(
                label, protocol_window(dev, path, start, pms), start, pms,
                f"{args.profile_protocols_prefix}{path}.txt",
                PROFILE_KERNELS[path])
        profiles["gsf32k"] = profile(
            f"GSFSignature {G32_NODES} nodes",
            dense_window(GSFSignature(node_count=G32_NODES, device=dev), 50,
                         args.profile),
            50, args.profile, args.profile_gsf32k_file,
            PROFILE_KERNELS["gsf"])
        done("profile")

    path_ms = {"handel": MAIN_MS, "gsf": GSF_MS, "headline": HEADLINE_MS,
               "pingpong": PP_MS, "pingpong_harness": hpres["sim_ms"],
               "spill": SPILL_MS, "gsf_batch": GSF_BATCH_MS,
               "gsf_batch_k2": GSF_BATCH_MS, "ff_headline": FF_MS,
               "ff_pingpong": PP_MS, "ff_pingpong_batch": PP_CHUNK,
               "t3": t3res["sim_ms"], "t2": T2_MS, "attack": ATTACK_MS,
               "sanfermin": SF_MS, "cappos": CAPPOS_MS, "dfinity": D_TICKS,
               "dfinity_ff": D_FF_TICKS, "quiet_dfinity": Q_MS,
               "quiet_dfinity_ff": Q_MS, "quiet_p2pflood": Q_MS,
               "casper": K_TICKS, "ethpow": E_TICKS,
               "byz": bres["sim_ms"], "eth2": ETH2_MS,
               "eth2_ff": ETH2_FF_MS - ETH2_MS,
               **{k: v[0]["sim_ms"] for k, v in protos.items()
                  if k in ("p2phandel", "optimistic")},
               **{k: v[0]["sim_ms"] for k, v in lat.items()},
               **{k: v[0]["sim_ms"] for k, v in committee.items()},
               "gsf32k": G32_MS[-1],
               **{k: v[0]["ms"] for k, v in obs.items()}}
    path_launches = {"handel": launches, "gsf": glaunches,
                     "headline": hlaunches, "pingpong": plaunches,
                     "pingpong_harness": hplaunches, "spill": slaunches,
                     "gsf_batch": gblaunches, "gsf_batch_k2": gb2launches,
                     "ff_headline": falaunches, "ff_pingpong": fblaunches,
                     "ff_pingpong_batch": fclaunches, "t3": t3launches,
                     "t2": t2launches, "attack": alaunches,
                     "sanfermin": sflaunches, "cappos": claunches,
                     "dfinity": dlaunches, "dfinity_ff": dflaunches,
                     **{k: v[1] for k, v in quiet.items()},
                     "casper": klaunches, "ethpow": elaunches,
                     "byz": blaunches,
                     **{k: v[1] for k, v in protos.items()},
                     **{k: v[1] for k, v in lat.items()},
                     **{k: v[1] for k, v in committee.items()},
                     "gsf32k": g32launches,
                     **{k: v[1] for k, v in obs.items()},
                     **{k: v[1] for k, v in chaos.items()}}
    kernels = []
    for name, key, path, source, replaces, _ in KERNELS:
        r = results[name]
        bound_ms = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        n_launch = path_launches[path][key]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launch,
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
               "bound_by": "bytes", "library_ms": None, "path": path,
               "launches_by_path": {p: path_launches[p][key]
                                    for p in path_launches},
               "launches_per_ms": n_launch / path_ms[path],
               "kernel_us": r["ms"] * 1e3,
               "kernel_us_warm": r["warm_ms"] * 1e3,
               "plain_us": r["plain_ms"] * 1e3,
               "bound_us": bound_ms * 1e3, "library_us": None,
               "bytes": r["nbytes"], "call_ms": r["call_ms"],
               "plain_call_ms": r["plain_call_ms"]}
        for extra in ("phases_us", "gather", "branch", "case_s"):
            if extra in r:
                rec[extra] = r[extra]
        print(json.dumps(rec), flush=True)
        kernels.append(rec)
    print(json.dumps({"kernels": kernels, "main_path": res,
                      "gsf_path": gres, "headline_path": hres,
                      "pingpong_path": pres, "pingpong_harness": hpres,
                      "spill_path": sres, "gsf_batch_path": gbres,
                      "gsf_batch_k2_path": gb2res,
                      "ff_headline_path": fares, "ff_pingpong_path": fbres,
                      "ff_pingpong_batch_path": fcres,
                      "t3_path": t3res, "t2_path": t2res,
                      "attack_path": ares, "sanfermin_path": sfres,
                      "cappos_path": cres, "dfinity_path": dres,
                      "dfinity_ff_path": dfres,
                      **{f"{k}_path": v[0] for k, v in quiet.items()},
                      "casper_path": kres, "ethpow_path": eres,
                      "byz_path": bres,
                      **{f"{k}_path": v[0] for k, v in protos.items()},
                      "phases_bp_wall_s": bp_wall,
                      **{f"{k}_path": v[0] for k, v in lat.items()},
                      **{f"{k}_path": v[0] for k, v in committee.items()},
                      "phases_la_wall_s": la_wall,
                      "gsf32k_path": g32res, "phase_g32_wall_s": g32_wall,
                      **{f"{k}_path": v[0] for k, v in obs.items()},
                      **{f"{k}_path": v[0] for k, v in chaos.items()},
                      "phase_x_wall_s": x_wall,
                      "memory": memory,
                      "profiles": profiles}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
