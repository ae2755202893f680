#!/usr/bin/env python3
"""Benchmark lines of the PyTorch/CUDA port (`wittgenstein_tpu_torch`),
timed under the measurement protocol of `utils/measure.timed_chunks`.

The headline (``--proto handel``, the default) is the reference-default
Handel (`bench.py`'s `_handel_setup`), a batch of seeds on the
seed-folded engine (`core/batched.scan_chunk_batched`, superstep K=2,
phase-specialized chunks entered at t0_mod=0); every run must converge
(mean live frac_done > 0.99) with zero drops, clamps and evictions, as
`bench.py` asserts (bench.py:529-541).  ``--proto pingpong`` is
`bench.py`'s quiet-protocol line (`bench_quiet`, bench.py:700-790):
PingPong, 256 nodes and 4 seeds by default, in 200-ms chunks of
`network.scan_chunk` on the seed batch at the largest K the gate proves
(2: the witness pongs itself); its check is progress (pongs, summed over
the seeds) > 0, with drops and broadcast drops reported.  ``--proto
gsf`` is `tools/bench_suite.py`'s GSF line (`bench_gsf`):
`GSFSignature(node_count=4096)` with its defaults, 4 seeds, 2,500 ms in
250-ms chunks of `network.scan_chunk` on the seed batch at K=1; every
run must reach frac_done > 0.99 with zero drops and clamps.

The headline's scale switches map as `bench.py`'s environment does
(bench.py:389-438): ``--mode cardinal`` (``WTPU_BENCH_MODE``, queue_cap
16 past 32,768 nodes), and for exact mode ``--emission``, ``--pool``,
``--state-split`` (``WTPU_BENCH_EMISSION/POOL/STATE_SPLIT``);
``--box-split`` (``WTPU_BENCH_BOX_SPLIT``) splits the ring of either.
More seeds than ``--seed-batch`` (16) run as `bench.py`'s microbatched
line (`bench_handel_microbatched`, bench.py:633-698): sequential
batches of ``--seed-batch`` seeds, one timed window over all of them,
each batch checked inside it, the batch walls reported as spread.

``--fast-forward`` is `bench.py`'s ``WTPU_FAST_FORWARD=1``: the headline
runs `core/batched.fast_forward_chunk_batched` (K=2, no phase hints:
the two do not compose) and PingPong `network.fast_forward_chunk` on the
seed batch; the line then carries ``fast_forward``, ``skipped_ms``,
``jump_count`` and ``skip_rate`` of one repetition (bench.py:81-96).
GSF, SanFermin and OptimisticP2PSignature have no fast-forward oracle
and refuse it.

``--proto dfinity`` and ``--proto p2pflood`` are `bench_quiet`'s other
two lines (4 seeds, 1,000 ms in 200-ms chunks of `network.scan_chunk`
on the seed batch at the proved K, 2): Dfinity at the reference default
(31 nodes, 10-ms ticks) and ``P2PFlood(256, dead 25, peers 8, 1-ms
delays)`` (`models/p2pflood.quiet_params`), each checked for progress.
``--proto dfinity --attesters 10000`` is `tools/bench_suite.py`'s
Dfinity line (10 block producers, 100 attesters a round, 10,111 nodes):
one run, 12,000 ticks (120 simulated s) in 2,000-tick chunks, zero
unicast and arena drops, heads within one height, the highest at least
30.  ``--proto sanfermin`` is bench_suite's SanFermin line:
``SanFermin(node_count=32768, inbox_cap=16)`` with two ring sub-planes,
one run, 6,000 ms in 500-ms chunks at the proved K (2), zero drops and
at most 2% of the nodes stranded.

``--proto casper`` is Casper IMD's reference configuration
(``CasperIMD()``: 83 nodes, 20-ms ticks; ``--attesters`` sets the
attesters a round), 8 seeds by default, ``--ticks`` (4,000 by default)
in 1,000-tick chunks of `network.scan_chunk` on the seed batch at the
proved K, checked for progress and zero unicast and arena drops, with
the heads' height range, the blocks and the attestations reported.
``--proto ethpow`` is `try_miner`'s batch at one hash-power point:
``ETHPoW`` with ``--nodes`` miners (10), ``--miner`` (ETHSelfishMiner)
at ``--pow`` (0.40) of the hash power, 1-s fixed latency and 8,192
blocks, ``--runs`` seeds numbered from 1 (5), ``--ticks`` (3,000) in
1,000-tick chunks at the proved K; it prints `try_miner`'s CSV header
and row for the final state before the JSON line.  For both a tick is a
simulated step (20 and 10 ms), and ``--ticks`` is ``--ms``.

``--proto handeleth2``, ``p2phandel`` and ``optimistic`` are
`chip_smoke.py` phase P's configurations, 4 seeds each in chunks of
`network.scan_chunk` on the seed batch at the proved K (2), or
fast-forwarded with ``--fast-forward`` (HandelEth2, P2PHandel):
``HandelEth2(64)`` with the distance latency to 6,100 ms (past the
second aggregation's start) in 100-ms chunks, its check every live
node's running aggregation complete; ``P2PHandel`` with ``--nodes``
signers (100) and a fifth of that relaying, the P2PHandelParameters
defaults and the distance latency, to 6,000 ms in 500-ms chunks;
``OptimisticP2PSignature`` at its `main` configuration (1,000 nodes,
threshold 501) to 400 ms in 100-ms chunks.  Each checks progress and
zero drops and clamps.

    python3 bench_torch.py                      # 2048 nodes x 16 seeds, cuda
    python3 bench_torch.py --device cpu --nodes 64 --seeds 2 --ms 200
    python3 bench_torch.py --proto pingpong     # 256 nodes x 4 seeds, cuda
    python3 bench_torch.py --proto gsf          # 4096 nodes x 4 seeds, cuda
    python3 bench_torch.py --proto dfinity      # 31 nodes x 4 seeds
    python3 bench_torch.py --proto dfinity --attesters 10000 --reps 1
    python3 bench_torch.py --proto p2pflood     # 256 nodes x 4 seeds
    python3 bench_torch.py --proto sanfermin --reps 1   # 32768 nodes
    python3 bench_torch.py --proto casper --ticks 15000 --reps 1
    python3 bench_torch.py --proto ethpow --ticks 30000 --reps 1
    python3 bench_torch.py --proto handeleth2 --fast-forward --reps 1
    python3 bench_torch.py --proto p2phandel --fast-forward --reps 1
    python3 bench_torch.py --proto optimistic   # 1000 nodes x 4 seeds
    python3 bench_torch.py --fast-forward       # the headline, fast-forward
    python3 bench_torch.py --mode cardinal --nodes 65536 --seeds 1
    python3 bench_torch.py --nodes 32768 --seeds 1 --emission hashed \
        --pool 0 --state-split 2 --box-split 2  # exact mode, tier 2
    python3 bench_torch.py --seeds 256          # 16 batches of 16 seeds

After the timed reps, as `bench.py` does, un-timed passes of the obs
planes add their blocks to the line (bench.py:98-265), each
bit-identical on the trajectory and never failing the line (a failed
pass reports itself in its block): ``engine_metrics`` (the metrics
plane over the line's span on up to 4 seeds in intervals of a tenth
of it, the seed-folded engine where it takes the protocol;
``--no-metrics`` drops it), ``audit`` (the invariant
monitors on seed 0; ``--no-audit`` drops it) and, with ``--trace``,
``trace`` (the flight recorder on seed 0, a ``--trace-cap``-row ring,
65,536 by default, which must hold one event a simulated ms).
``--chaos '<FaultSchedule JSON>'`` adds `bench.py`'s ``chaos`` block
(``WTPU_CHAOS``, bench.py:267-320): the schedule is parsed and validated
against the protocol's node count and the line's span before the timed
reps (a malformed or out-of-range schedule exits non-zero there); after
them seed 0 runs under `chaos.ChaosProtocol` on the dense audited
engine at K=1, then a fault-free twin, and the block carries
``schedule`` (event counts), ``transitions``, ``audit`` (the faulted
run's verdict), ``faulted`` and ``baseline`` (`chaos.impact_summary`).

``--history PATH`` appends the line to a bench-history ledger
(`obs/regress.BenchHistory`, the rows `cli/bench_suite.py` writes):
stage ``{proto}_{N}n``, the config digest of every argument that
selects the measured program (`history_config`), the line's
``value``/``wall_*`` measures; `python -m wittgenstein_tpu_torch.cli.regress
PATH` then gates the newest line against the same host's earlier ones.

Prints one JSON line in `bench.py`'s shape: ``metric``
(``{proto}_{N}n_{R}seeds_agg_sim_ms_per_sec``, ``_cardinal`` and
``_ff`` appended as `bench.py` appends them), ``value`` (aggregate
simulated ms per second over all seeds), ``platform`` (``cuda`` or
``cpu``), ``engine`` (``batched``, ``fast_forward``, ``vmapped`` as
`bench_quiet` names the seed-batched dense engine, or ``scan`` for the
one-run lines), ``superstep``, the
card's name and power limit, and the measurement's walls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def card(platform):
    """The card's name and power limit as nvidia-smi reports them."""
    if platform != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


#: The headline's superstep (bench.py's _handel_setup and bench_quiet).
SUPERSTEP = 2
#: per protocol: default node count, seed count, simulated ms and chunk
#: (bench.py's _handel_setup and bench_quiet, bench_suite's bench_gsf)
DEFAULTS = {"handel": (2048, 16, 1000, 200), "pingpong": (256, 4, 1000, 200),
            "gsf": (4096, 4, 2500, 250), "dfinity": (None, 4, 1000, 200),
            "p2pflood": (256, 4, 1000, 200),
            "sanfermin": (32768, 1, 6000, 500),
            "casper": (None, 8, 4000, 1000), "ethpow": (10, 5, 3000, 1000),
            "handeleth2": (64, 4, 6100, 100), "p2phandel": (100, 4, 6000, 500),
            "optimistic": (1000, 4, 400, 100)}
#: `--proto dfinity --attesters A`, bench_suite's line: one seed, 12,000
#: ticks (the 120 simulated s its docstring and height check describe)
#: in 2,000-tick chunks
DFINITY_TRACKED = (1, 12000, 2000)


def handel_params(args):
    """The Handel parameters of `bench.py`'s `_handel_setup` for these
    flags (bench.py:369-438): the reference-default scenario, cardinal
    mode's queue_cap 16 past 32,768 nodes, exact mode's switches."""
    from wittgenstein_tpu_torch.models.handel import reference_default_params
    params = dict(reference_default_params(args.nodes), mode=args.mode)
    if args.mode == "cardinal" and args.nodes > 32768:
        params["queue_cap"] = 16
    if args.mode == "exact":
        if args.emission:
            params["emission_mode"] = args.emission
        if args.pool is not None:
            params["snapshot_pool"] = args.pool == 1
        if args.state_split:
            params["state_split"] = args.state_split
    return params


def handel_line(args, seeds):
    """The headline's protocol, chunk runner and check."""
    import dataclasses

    from wittgenstein_tpu_torch.core.batched import (
        fast_forward_chunk_batched, scan_chunk_batched)
    from wittgenstein_tpu_torch.models.handel import Handel
    proto = Handel(**handel_params(args), device=args.device)
    if args.box_split > 1:
        proto.cfg = dataclasses.replace(proto.cfg, box_split=args.box_split)
    if args.fast_forward:
        run = fast_forward_chunk_batched(proto, args.chunk,
                                         superstep=SUPERSTEP)
    else:
        run = scan_chunk_batched(proto, args.chunk, t0_mod=0,
                                 superstep=SUPERSTEP)

    def check(nets, ps):
        done_at = nets.nodes.done_at.cpu().numpy()
        downs = nets.nodes.down.cpu().numpy()
        counts = {k: int(getattr(nets, k).sum()) for k in
                  ("dropped", "bc_dropped", "clamped")}
        counts["evicted"] = int(ps.evicted.sum())
        frac_done = float(np.mean([(done_at[i][~downs[i]] > 0).mean()
                                   for i in range(len(done_at))]))
        if not frac_done > 0.99:
            raise AssertionError(f"Handel did not converge: {frac_done:.3f}")
        if any(counts.values()):
            raise AssertionError(f"drops, clamps or evictions: {counts}")
        return {"frac_done": frac_done, **counts}
    return proto, run, check, "batched", SUPERSTEP


def quiet_runner(proto, args):
    """The chunk runner of a quiet line at the largest K the gate proves
    up to SUPERSTEP: `network.scan_chunk`, or `fast_forward_chunk` on
    the state's layout with ``--fast-forward``."""
    from wittgenstein_tpu_torch.core.network import (
        fast_forward_chunk, pick_superstep, scan_chunk)
    k = pick_superstep(proto, args.chunk, t0=0, max_k=SUPERSTEP)
    if args.fast_forward:
        return fast_forward_chunk(proto, args.chunk,
                                  seed_axis=not args.single, superstep=k), k
    return scan_chunk(proto, args.chunk, superstep=k), k


def pingpong_line(args, seeds):
    """`bench_quiet("pingpong")`'s protocol, chunk runner and check."""
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=args.nodes, device=args.device)
    run, k = quiet_runner(proto, args)

    def check(nets, ps):
        progress = int(ps.pongs.sum())
        if not progress > 0:
            raise AssertionError("pingpong made no progress")
        return {"progress": progress, "dropped": int(nets.dropped.sum()),
                "bc_dropped": int(nets.bc_dropped.sum())}
    return proto, run, check, "vmapped", k


def gsf_line(args, seeds):
    """`tools/bench_suite.py`'s `bench_gsf`: protocol, chunk runner (K=1,
    as `run_config` runs it by default) and check."""
    from wittgenstein_tpu_torch.core.network import scan_chunk
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    proto = GSFSignature(node_count=args.nodes, device=args.device)
    run = scan_chunk(proto, args.chunk)

    def check(nets, ps):
        frac = float((nets.nodes.done_at > 0).float().mean())
        counts = {k: int(getattr(nets, k).sum()) for k in
                  ("dropped", "clamped")}
        if not frac > 0.99:
            raise AssertionError(f"GSF did not converge: {frac:.3f}")
        if any(counts.values()):
            raise AssertionError(f"drops or clamps: {counts}")
        return {"frac_done": frac, **counts}
    return proto, run, check, "vmapped", 1


def dfinity_line(args, seeds):
    """`bench_quiet("dfinity")`: the reference-default Dfinity (31 nodes;
    the count is role-derived, `--nodes` does not apply), its check
    progress (the highest block) > 0.  With ``--attesters A``,
    `tools/bench_suite.py`'s `bench_dfinity`: 10 block producers and A
    attesters in 100-attester committees, one run, and its check: zero
    unicast and arena drops, heads within one height, and a highest
    head of 30 per 120 simulated s (its 30 at 120 s)."""
    from wittgenstein_tpu_torch.models.dfinity import (Dfinity,
                                                       tracked_10k_params)
    if args.attesters:
        proto = Dfinity(**dict(
            tracked_10k_params(), attesters_count=args.attesters,
            attesters_per_round=min(100, args.attesters // 4)),
            device=args.device)
    else:
        proto = Dfinity(device=args.device)
    args.nodes = proto.node_count
    run, k = quiet_runner(proto, args)
    ticks = max(1, -(-args.ms // args.chunk)) * args.chunk
    min_height = ticks * proto.tick_ms * 30 // 120_000

    def check(nets, ps):
        heights = ps.arena.height.gather(-1, ps.head.long()).cpu()
        out = {"progress": int(heights.max()),
               "dropped": int(nets.dropped.sum()),
               "bc_dropped": int(nets.bc_dropped.sum()),
               "arena_dropped": int(ps.arena.dropped.sum()),
               "height_min": int(heights.min())}
        if not out["progress"] > 0:
            raise AssertionError("dfinity made no progress")
        if args.attesters:
            if out["dropped"] or out["arena_dropped"]:
                raise AssertionError(f"drops: {out}")
            if out["progress"] - out["height_min"] > 1:
                raise AssertionError(f"nodes disagree: {out}")
            if out["progress"] < min_height:
                raise AssertionError(f"height {out['progress']} < "
                                     f"{min_height} after {args.ms} ticks")
        return out
    return proto, run, check, "scan" if args.single else "vmapped", k


def p2pflood_line(args, seeds):
    """`bench_quiet("p2pflood")`: `quiet_params(nodes)` (a tenth down, 8
    peers, 1-ms delays), its check progress (nodes done) > 0."""
    from wittgenstein_tpu_torch.models.p2pflood import P2PFlood, quiet_params
    proto = P2PFlood(**quiet_params(args.nodes), device=args.device)
    run, k = quiet_runner(proto, args)

    def check(nets, ps):
        progress = int((nets.nodes.done_at > 0).sum())
        if not progress > 0:
            raise AssertionError("p2pflood made no progress")
        return {"progress": progress, "dropped": int(nets.dropped.sum()),
                "bc_dropped": int(nets.bc_dropped.sum())}
    return proto, run, check, "vmapped", k


def sanfermin_line(args, seeds):
    """`tools/bench_suite.py`'s `bench_sanfermin`: ``SanFermin(
    node_count=nodes, inbox_cap=16)`` with two ring sub-planes, one run
    at the proved K, and its check: zero drops, at most 2% of the nodes
    stranded (not done)."""
    import dataclasses

    from wittgenstein_tpu_torch.models.sanfermin import SanFermin
    proto = SanFermin(node_count=args.nodes, inbox_cap=16, device=args.device)
    proto.cfg = dataclasses.replace(proto.cfg, box_split=2)
    run, k = quiet_runner(proto, args)

    def check(nets, ps):
        done_at = nets.nodes.done_at.cpu().numpy()
        finished = done_at[done_at > 0]
        out = {"dropped": int(nets.dropped.sum()),
               "clamped": int(nets.clamped.sum()),
               "stranded_pct": round(100 * (1 - finished.size /
                                            done_at.size), 2),
               "done_mean_ms": round(float(finished.mean()), 1)
               if finished.size else None}
        if out["dropped"]:
            raise AssertionError(f"dropped={out['dropped']}")
        if out["stranded_pct"] > 2:
            raise AssertionError(f"stranded={out['stranded_pct']}%")
        return out
    return proto, run, check, "scan", k


def casper_line(args, seeds):
    """Casper IMD's reference configuration (`CasperIMD()`, the
    attesters a round from ``--attesters``), its check progress (the
    highest head) > 0 with zero unicast and arena drops."""
    from wittgenstein_tpu_torch.models.casper import CasperIMD
    kw = {} if args.attesters is None else {
        "attesters_per_round": args.attesters}
    proto = CasperIMD(**kw, device=args.device)
    args.nodes = proto.node_count
    run, k = quiet_runner(proto, args)

    def check(nets, ps):
        heights = ps.arena.height.gather(-1, ps.head.long()).cpu()
        out = {"progress": int(heights.max()),
               "head_skew": int((heights.max(-1).values -
                                 heights.min(-1).values).max()),
               "blocks": int((ps.arena.n - 1).sum()),
               "attestations": int(ps.att_n.sum()),
               "dropped": int(nets.dropped.sum()),
               "bc_dropped": int(nets.bc_dropped.sum()),
               "arena_dropped": int(ps.arena.dropped.sum())}
        if not out["progress"] > 0:
            raise AssertionError("casper made no progress")
        if out["dropped"] or out["arena_dropped"]:
            raise AssertionError(f"drops: {out}")
        return out
    return proto, run, check, "vmapped", k


def ethpow_line(args, seeds):
    """`try_miner`'s batch at one point (the module docstring), its
    check zero unicast and arena drops (a short run may mine no block);
    the CSV row of the final state is kept in ``args.csv``."""
    from wittgenstein_tpu_torch.models.ethpow import (CSV_HEADER, ETHPoW,
                                                      miner_row)
    latency = "NetworkFixedLatency(1000)"
    proto = ETHPoW(number_of_miners=args.nodes, byz_class_name=args.miner,
                   byz_mining_ratio=args.pow, network_latency_name=latency,
                   capacity=8192, device=args.device)
    args.first_seed = 1
    run, k = quiet_runner(proto, args)
    ticks = max(1, -(-args.ms // args.chunk)) * args.chunk
    hours = ticks * proto.tick_ms / 3.6e6

    def check(nets, ps):
        row, line = miner_row(ps, seeds, hours, args.miner, args.pow,
                              latency)
        args.csv = [CSV_HEADER, line]
        out = {"blocks": int((ps.arena.n - 1).sum()),
               "dropped": int(nets.dropped.sum()),
               "bc_dropped": int(nets.bc_dropped.sum()),
               "arena_dropped": int(ps.arena.dropped.sum()),
               "revenue_ratio": row["revenue_ratio"],
               "uncle_rate": row["uncle_rate"], "csv_row": line}
        if out["dropped"] or out["arena_dropped"]:
            raise AssertionError(f"drops: {out}")
        return out
    return proto, run, check, "vmapped", k


def handeleth2_line(args, seeds):
    """``HandelEth2(node_count=nodes)`` with the distance latency
    (`chip_smoke.py` phase P's configuration), its check zero drops and
    clamps and, from 1,000 ms on, the first aggregation (height 1,001,
    which completes in its first second) holding the whole live
    committee at every live node."""
    from wittgenstein_tpu_torch.models.handeleth2 import R, HandelEth2
    from wittgenstein_tpu_torch.ops import bitset
    proto = HandelEth2(node_count=args.nodes,
                       network_latency_name="NetworkLatencyByDistanceWJitter",
                       device=args.device)
    run, k = quiet_runner(proto, args)
    ticks = max(1, -(-args.ms // args.chunk)) * args.chunk

    def check(nets, ps):
        live = ~nets.nodes.down
        card = bitset.popcount(ps.inc[:, :, 1001 % R]).sum(-1)
        out = {"progress": int(card[live].min()),
               "heights": sorted(set(ps.height.flatten().tolist())),
               "dropped": int(nets.dropped.sum()),
               "clamped": int(nets.clamped.sum())}
        if out["dropped"] or out["clamped"]:
            raise AssertionError(f"drops or clamps: {out}")
        if 1000 <= ticks < 18000 and \
                out["progress"] < int(live.sum(1).min()):
            raise AssertionError(f"aggregation incomplete: {out}")
        return out
    return proto, run, check, "vmapped", k


def p2phandel_line(args, seeds):
    """``P2PHandel(**scenario_params(nodes, nodes // 5))`` (phase P's
    configuration at 100 signers and 20 relays), its check progress
    (nodes holding more than their own signature) > 0 with zero drops
    and clamps; the node count in the metric is signers and relays."""
    from wittgenstein_tpu_torch.models.p2phandel import (P2PHandel,
                                                         scenario_params)
    from wittgenstein_tpu_torch.ops import bitset
    proto = P2PHandel(**scenario_params(args.nodes, args.nodes // 5),
                      device=args.device)
    args.nodes = proto.node_count
    run, k = quiet_runner(proto, args)

    def check(nets, ps):
        out = {"progress": int((bitset.popcount(ps.verified) > 1).sum()),
               "done": int((nets.nodes.done_at > 0).sum()),
               "dropped": int(nets.dropped.sum()),
               "clamped": int(nets.clamped.sum())}
        if not out["progress"] > 0:
            raise AssertionError("p2phandel made no progress")
        if out["dropped"] or out["clamped"]:
            raise AssertionError(f"drops or clamps: {out}")
        return out
    return proto, run, check, "vmapped", k


def optimistic_line(args, seeds):
    """``OptimisticP2PSignature(**main_params(node_count=nodes,
    threshold=nodes // 2 + 1))`` (phase P's configuration at 1,000
    nodes), its check progress (nodes done) > 0 with zero drops and
    clamps."""
    from wittgenstein_tpu_torch.models.optimistic import (
        OptimisticP2PSignature, main_params)
    proto = OptimisticP2PSignature(**main_params(
        node_count=args.nodes, threshold=args.nodes // 2 + 1),
        device=args.device)
    run, k = quiet_runner(proto, args)

    def check(nets, ps):
        out = {"progress": int(ps.done.sum()),
               "dropped": int(nets.dropped.sum()),
               "clamped": int(nets.clamped.sum())}
        if not out["progress"] > 0:
            raise AssertionError("optimistic made no progress")
        if out["dropped"] or out["clamped"]:
            raise AssertionError(f"drops or clamps: {out}")
        return out
    return proto, run, check, "vmapped", k


def ff_step(run, clock, chunk):
    """A fast-forward chunk as the measurement's step, its skip counts
    kept (`bench.py`'s `_ff_step_wrapper`)."""
    def step(nets, ps):
        nets, ps, stats = run(nets, ps, t=clock["t"])
        clock["t"] += chunk
        step.stats.append(stats)
        return nets, ps

    step.stats = []
    return step


def ff_stats(stats, steps, chunk):
    """The skip counts of the last repetition (every repetition's are the
    same: the runs are deterministic), as `bench.py`'s `_ff_stats`."""
    tail = stats[-steps:]
    skipped = sum(s["skipped_ms"] for s in tail)
    return {"fast_forward": True, "skipped_ms": skipped,
            "jump_count": sum(s["jump_count"] for s in tail),
            "skip_rate": round(skipped / max(1, steps * chunk), 3)}


def microbatched(step, init, steps, seeds, seed_batch, chunk, check):
    """`bench.py`'s `bench_handel_microbatched` measurement: one warm-up
    chunk, then one timed window over ``seeds / seed_batch`` sequential
    batches (`init` takes the first seed), each checked inside the
    window; the aggregate rate over all seeds and the batch walls."""
    import time
    nets, ps = init(0)
    nets, ps = step(nets, ps)
    nets.time.cpu()
    walls, facts = [], []
    t0 = time.perf_counter()
    for b in range(seeds // seed_batch):
        tb = time.perf_counter()
        nets, ps = init(b * seed_batch)
        for _ in range(steps):
            nets, ps = step(nets, ps)
        facts.append(check(nets, ps))       # inside the window
        walls.append(time.perf_counter() - tb)
    wall = time.perf_counter() - t0
    return {"value": round(seeds * steps * chunk / wall, 1),
            "total_seeds": seeds, "seed_batch": seed_batch,
            "microbatches": len(walls), "wall_total_s": round(wall, 4),
            "batch_wall_median_s": round(float(np.median(walls)), 4),
            "batch_wall_min_s": round(min(walls), 4),
            "batch_wall_max_s": round(max(walls), 4),
            "crosscheck": "per_batch_materialization", **facts[-1]}


#: seeds of the metrics pass at most (`bench.py`'s WTPU_METRICS_SEEDS
#: default)
METRICS_SEEDS = 4


def engine_metrics(proto, seeds, total_ms, fast_forward=False):
    """The un-timed metrics pass of the line's ``engine_metrics`` block
    (`bench.py`'s `_collect_engine_metrics`, bench.py:98-147): after the
    timed reps, bit-identical on the trajectory, so the block describes
    the runs the bench timed.  The seed-folded engine where the batched
    builders take the protocol (or its fast-forward twin), else the
    dense one, on the first ``min(seeds, METRICS_SEEDS)`` seeds, in
    intervals of a tenth of the span (even).  Never raises: a failed
    pass reports itself in the block."""
    import torch

    from wittgenstein_tpu_torch import obs
    from wittgenstein_tpu_torch.core.network import fast_forward_ok
    from wittgenstein_tpu_torch.core.state import init_batched
    try:
        each = max(2, (total_ms // 10) & ~1)
        spec = obs.MetricsSpec(stat_each_ms=each)
        mseeds = min(seeds, METRICS_SEEDS)
        ms = total_ms + (total_ms % 2)
        nets, ps = init_batched(proto, torch.arange(mseeds))
        try:
            run = (obs.fast_forward_chunk_batched_metrics if fast_forward
                   else obs.scan_chunk_batched_metrics)(proto, ms, spec)
        except ValueError:
            if fast_forward and fast_forward_ok(proto):
                run = obs.fast_forward_chunk_metrics(proto, ms, spec,
                                                     seed_axis=True)
            else:
                run = obs.scan_chunk_metrics(proto, ms, spec)
        mc = run(nets, ps)[-1]
        return obs.engine_metrics_block(obs.MetricsFrame.from_carry(spec, mc),
                                        extra={"metrics_seeds": mseeds})
    except Exception as e:      # noqa: BLE001 — the bench line must emit
        print(f"bench: engine-metrics pass failed: {type(e).__name__}: "
              f"{e!s:.300}", file=sys.stderr)
        return {"error": f"{type(e).__name__}: {e!s:.200}"}


def engine_trace(proto, total_ms, cap, fast_forward=False):
    """The un-timed flight-recorder pass of the line's ``trace`` block
    (`bench.py`'s `_collect_engine_trace`, bench.py:158-190): seed 0,
    the dense traced engine (or its fast-forward twin).  Never raises:
    a failed pass reports itself in the block."""
    from wittgenstein_tpu_torch import obs
    from wittgenstein_tpu_torch.core.network import fast_forward_ok
    try:
        spec = obs.TraceSpec(capacity=cap)
        net, ps = proto.init(0)
        if fast_forward and fast_forward_ok(proto):
            tc = obs.fast_forward_chunk_trace(proto, total_ms, spec)(
                net, ps)[-1]
        else:
            tc = obs.scan_chunk_trace(proto, total_ms, spec)(net, ps)[-1]
        return obs.trace_block(obs.TraceFrame.from_carry(spec, tc),
                               extra={"trace_seeds": 1})
    except Exception as e:      # noqa: BLE001 — the bench line must emit
        print(f"bench: flight-recorder pass failed: {type(e).__name__}: "
              f"{e!s:.300}", file=sys.stderr)
        return {"error": f"{type(e).__name__}: {e!s:.200}"}


def engine_audit(proto, total_ms, fast_forward=False):
    """The un-timed audit pass of the line's ``audit`` block (`bench.py`'s
    `_collect_engine_audit`, bench.py:226-258): seed 0, the dense
    audited engine (or its fast-forward twin); a violated verdict is
    loud in the block and on stderr.  Never raises: a failed pass
    reports itself in the block."""
    from wittgenstein_tpu_torch import obs
    from wittgenstein_tpu_torch.core.network import fast_forward_ok
    try:
        variant = ({"fast_forward": True}
                   if fast_forward and fast_forward_ok(proto) else {})
        report, _ = obs.audit_variant(proto, total_ms, variant,
                                      obs.AuditSpec())
        if not report.clean:
            print(f"bench: AUDIT VIOLATIONS in the instrumented pass:\n"
                  f"{report.format()}", file=sys.stderr)
        return obs.audit_block(report, extra={"audit_seeds": 1})
    except Exception as e:      # noqa: BLE001 — the bench line must emit
        print(f"bench: invariant-audit pass failed: {type(e).__name__}: "
              f"{e!s:.300}", file=sys.stderr)
        return {"error": f"{type(e).__name__}: {e!s:.200}"}


def obs_blocks(args, proto, total_ms):
    """The ``engine_metrics``, ``trace`` and ``audit`` blocks the flags
    ask for, in `bench.py`'s order (bench.py:150-265): metrics and audit
    unless switched off (``--no-metrics``, ``--no-audit``), the trace
    with ``--trace``, whose ring must hold one event a simulated ms
    (checked before the timed reps, `check_trace_cap`)."""
    out = {}
    if args.metrics:
        out["engine_metrics"] = engine_metrics(proto, args.seeds, total_ms,
                                               args.fast_forward)
    if args.trace:
        out["trace"] = engine_trace(proto, total_ms, args.trace_cap,
                                    args.fast_forward)
    if args.audit:
        out["audit"] = engine_audit(proto, total_ms, args.fast_forward)
    return out


def chaos_block(proto, sched, total_ms):
    """The un-timed chaos pass of the line's ``chaos`` block (`bench.py`'s
    `_collect_chaos`, bench.py:267-313): seed 0 under `ChaosProtocol` on
    the dense audited engine at K=1, then its fault-free twin.  A
    violated verdict is loud on stderr.  Never raises: a failed pass
    reports itself in the block."""
    from wittgenstein_tpu_torch import obs
    from wittgenstein_tpu_torch.chaos import ChaosProtocol, impact_summary
    try:
        spec = obs.AuditSpec()
        report, (nets, _) = obs.audit_variant(
            ChaosProtocol(proto, sched), total_ms, {"superstep": 1}, spec)
        _, (nets0, _) = obs.audit_variant(proto, total_ms,
                                          {"superstep": 1}, spec)
        if not report.clean:
            print(f"bench: AUDIT VIOLATIONS under the chaos schedule:\n"
                  f"{report.format()}", file=sys.stderr)
        return {"schedule": sched.counts(),
                "transitions": len(sched.transition_times()),
                "audit": obs.audit_block(report),
                "faulted": impact_summary(nets),
                "baseline": impact_summary(nets0)}
    except Exception as e:      # noqa: BLE001 — the bench line must emit
        print(f"bench: chaos pass failed: {type(e).__name__}: "
              f"{e!s:.300}", file=sys.stderr)
        return {"error": f"{type(e).__name__}: {e!s:.200}",
                "schedule": sched.counts()}


def check_trace_cap(args, total_ms):
    """`bench.py`'s `_check_trace_cap` (bench.py:193-213): a ring smaller
    than one event row a simulated ms truncates from the first busy
    stretch, so ``--trace`` refuses it before the timed reps."""
    if args.trace and args.trace_cap < total_ms:
        raise ValueError(
            f"--trace with --trace-cap {args.trace_cap} over {total_ms} "
            "simulated ms cannot hold even one event row per ms: the "
            "ring would truncate silently from the first busy interval. "
            f"Fix: raise --trace-cap to >= {total_ms} (the default "
            "65536 fits most bench spans), lower --ms, or drop --trace")


def history_config(args, engine, k) -> dict:
    """What selects the measured program of a line: the history row's
    config digest covers it, so two lines of different configurations
    never baseline each other."""
    keys = ("proto", "nodes", "seeds", "ms", "chunk", "mode", "emission",
            "pool", "state_split", "box_split", "seed_batch", "attesters",
            "miner", "pow", "fast_forward", "metrics", "trace",
            "trace_cap", "audit", "chaos")
    return {**{key: getattr(args, key) for key in keys}, "engine": engine,
            "superstep": k}


def append_history(path, args, out):
    """One bench-history row for the line `out` (module docstring)."""
    from wittgenstein_tpu_torch.obs import ledger, regress
    regress.BenchHistory(path).append(
        stage=f"{args.proto}_{args.nodes}n",
        measures=regress.stage_measures(out), round_id=str(time.time_ns()),
        config_digest=ledger.digest(history_config(args, out["engine"],
                                                   out["superstep"])),
        backend=out["platform"], metric=out["metric"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--proto", choices=sorted(DEFAULTS), default="handel")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--ms", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast-forward", action="store_true")
    ap.add_argument("--mode", choices=("exact", "cardinal"), default="exact")
    ap.add_argument("--emission", choices=("stored", "hashed"), default=None)
    ap.add_argument("--pool", type=int, choices=(0, 1), default=None)
    ap.add_argument("--state-split", type=int, default=None)
    ap.add_argument("--box-split", type=int, default=1)
    ap.add_argument("--seed-batch", type=int, default=16)
    ap.add_argument("--attesters", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None, dest="ms")
    ap.add_argument("--runs", type=int, default=None, dest="seeds")
    ap.add_argument("--miner", default="ETHSelfishMiner")
    ap.add_argument("--pow", type=float, default=0.40)
    ap.add_argument("--no-metrics", dest="metrics", action="store_false")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-cap", type=int, default=1 << 16)
    ap.add_argument("--no-audit", dest="audit", action="store_false")
    ap.add_argument("--chaos", default=None, metavar="JSON")
    ap.add_argument("--history", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    args.first_seed = 0
    if args.attesters and args.proto not in ("dfinity", "casper"):
        ap.error("--attesters is Dfinity's and Casper's")
    if args.fast_forward and args.proto in ("gsf", "sanfermin",
                                            "optimistic"):
        ap.error(f"{args.proto} has no fast-forward oracle "
                 "(next_action_time)")
    scale = (args.mode != "exact" or args.emission or args.pool is not None
             or args.state_split or args.box_split > 1)
    if scale and args.proto != "handel":
        ap.error("--mode, --emission, --pool, --state-split and "
                 "--box-split are Handel's")
    nodes, n_seeds, ms, args.chunk = DEFAULTS[args.proto]
    if args.attesters and args.proto == "dfinity":
        n_seeds, ms, args.chunk = DFINITY_TRACKED
    args.nodes = nodes if args.nodes is None else args.nodes
    args.seeds = n_seeds if args.seeds is None else args.seeds
    args.ms = ms if args.ms is None else args.ms
    if args.proto in ("casper", "ethpow", "handeleth2", "p2phandel",
                      "optimistic"):
        args.chunk = min(args.chunk, args.ms)
    # bench_suite's single-seed lines run one unbatched state
    args.single = args.proto == "sanfermin" or (
        args.proto == "dfinity" and bool(args.attesters))
    if args.single and args.seeds != 1:
        ap.error("the SanFermin and --attesters lines run one seed")

    import torch

    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.utils.measure import timed_chunks

    line = {"handel": handel_line, "pingpong": pingpong_line,
            "gsf": gsf_line, "dfinity": dfinity_line,
            "p2pflood": p2pflood_line,
            "sanfermin": sanfermin_line, "casper": casper_line,
            "ethpow": ethpow_line, "handeleth2": handeleth2_line,
            "p2phandel": p2phandel_line,
            "optimistic": optimistic_line}[args.proto]
    micro = args.proto == "handel" and args.seeds > args.seed_batch
    if micro and args.seeds % args.seed_batch:
        ap.error(f"--seeds {args.seeds} is not a multiple of --seed-batch "
                 f"{args.seed_batch}")
    batch = args.seed_batch if micro else args.seeds
    proto, run, check, engine, k = line(args, batch)
    platform = proto.device.type
    seeds = torch.arange(batch)
    chunk = args.chunk
    steps = max(1, -(-args.ms // chunk))
    check_trace_cap(args, steps * chunk)
    sched = None
    if args.chaos:
        from wittgenstein_tpu_torch.chaos import FaultSchedule
        try:
            sched = FaultSchedule.from_json(args.chaos).validate(
                n=proto.cfg.n, sim_ms=steps * chunk)
        except ValueError as e:
            ap.error(f"--chaos: {e}")
    clock = {"t": 0}

    def init(first=0):
        clock["t"] = 0
        if args.single:
            return proto.init(first)
        return init_batched(proto, seeds + first + args.first_seed)

    def step(nets, ps):
        # The batch's time is kept on the host: no read-back per chunk.
        nets, ps = run(nets, ps, t=clock["t"])
        clock["t"] += chunk
        return nets, ps

    if args.fast_forward:
        step, engine = ff_step(run, clock, chunk), "fast_forward"
    if micro:
        res = microbatched(step, init, steps, args.seeds, args.seed_batch,
                           chunk, check)
        n_batches = args.seeds // args.seed_batch
    else:
        res = timed_chunks(step, init, steps, args.seeds, chunk, check,
                           reps=args.reps)
        n_batches = 1
    agg = res.pop("value")
    res.pop("unit", None)
    if args.fast_forward:
        res.update(ff_stats(step.stats, steps * n_batches, chunk))
    suffix = ("" if args.mode == "exact" else f"_{args.mode}") + \
        ("_ff" if args.fast_forward else "")
    out = {"metric": f"{args.proto}_{args.nodes}n_{args.seeds}seeds_agg_"
                     f"sim_ms_per_sec{suffix}",
           "value": agg, "unit": "sim_ms/s", "platform": platform,
           "engine": engine, "superstep": k,
           "sim_ms": steps * chunk, "chunk": chunk,
           "device": (torch.cuda.get_device_name(proto.device)
                      if platform == "cuda" else platform),
           "card": card(platform), **res,
           **obs_blocks(args, proto, steps * chunk)}
    if sched is not None:
        out["chaos"] = chaos_block(proto, sched, steps * chunk)
    for row in getattr(args, "csv", ()):
        print(row, flush=True)
    print(json.dumps(out), flush=True)
    if args.history:
        append_history(args.history, args, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
