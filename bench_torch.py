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

``--fast-forward`` is `bench.py`'s ``WTPU_FAST_FORWARD=1``: the headline
runs `core/batched.fast_forward_chunk_batched` (K=2, no phase hints:
the two do not compose) and PingPong `network.fast_forward_chunk` on the
seed batch; the line then carries ``fast_forward``, ``skipped_ms``,
``jump_count`` and ``skip_rate`` of one repetition (bench.py:81-96).
GSF has no fast-forward oracle and refuses it.

    python3 bench_torch.py                      # 2048 nodes x 16 seeds, cuda
    python3 bench_torch.py --device cpu --nodes 64 --seeds 2 --ms 200
    python3 bench_torch.py --proto pingpong     # 256 nodes x 4 seeds, cuda
    python3 bench_torch.py --proto gsf          # 4096 nodes x 4 seeds, cuda
    python3 bench_torch.py --fast-forward       # the headline, fast-forward

Prints one JSON line in `bench.py`'s shape: ``metric``
(``{proto}_{N}n_{R}seeds_agg_sim_ms_per_sec``), ``value`` (aggregate
simulated ms per second over all seeds), ``platform`` (``cuda`` or
``cpu``), ``engine`` (``batched``, ``fast_forward``, or ``vmapped`` as
`bench_quiet` names the seed-batched dense engine), ``superstep``, the
card's name and power limit, and the measurement's walls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

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
            "gsf": (4096, 4, 2500, 250)}


def handel_line(args, seeds):
    """The headline's protocol, chunk runner and check."""
    from wittgenstein_tpu_torch.core.batched import (
        fast_forward_chunk_batched, scan_chunk_batched)
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    proto = Handel(**reference_default_params(args.nodes),
                   device=args.device)
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
                                   for i in range(seeds)]))
        if not frac_done > 0.99:
            raise AssertionError(f"Handel did not converge: {frac_done:.3f}")
        if any(counts.values()):
            raise AssertionError(f"drops, clamps or evictions: {counts}")
        return {"frac_done": frac_done, **counts}
    return proto, run, check, "batched", SUPERSTEP


def pingpong_line(args, seeds):
    """`bench_quiet("pingpong")`'s protocol, chunk runner and check."""
    from wittgenstein_tpu_torch.core.network import (
        fast_forward_chunk, pick_superstep, scan_chunk)
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=args.nodes, device=args.device)
    k = pick_superstep(proto, args.chunk, t0=0, max_k=SUPERSTEP)
    if args.fast_forward:
        run = fast_forward_chunk(proto, args.chunk, seed_axis=True,
                                 superstep=k)
    else:
        run = scan_chunk(proto, args.chunk, superstep=k)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--proto", choices=sorted(DEFAULTS), default="handel")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--ms", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast-forward", action="store_true")
    args = ap.parse_args(argv)
    if args.fast_forward and args.proto == "gsf":
        ap.error("GSF has no fast-forward oracle (next_action_time)")
    nodes, n_seeds, ms, args.chunk = DEFAULTS[args.proto]
    args.nodes = nodes if args.nodes is None else args.nodes
    args.seeds = n_seeds if args.seeds is None else args.seeds
    args.ms = ms if args.ms is None else args.ms

    import torch

    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.utils.measure import timed_chunks

    line = {"handel": handel_line, "pingpong": pingpong_line,
            "gsf": gsf_line}[args.proto]
    proto, run, check, engine, k = line(args, args.seeds)
    platform = proto.device.type
    seeds = torch.arange(args.seeds)
    chunk = args.chunk
    steps = max(1, -(-args.ms // chunk))
    clock = {"t": 0}

    def init():
        clock["t"] = 0
        return init_batched(proto, seeds)

    def step(nets, ps):
        # The batch's time is kept on the host: no read-back per chunk.
        nets, ps = run(nets, ps, t=clock["t"])
        clock["t"] += chunk
        return nets, ps

    if args.fast_forward:
        step, engine = ff_step(run, clock, chunk), "fast_forward"
    res = timed_chunks(step, init, steps, args.seeds, chunk, check,
                       reps=args.reps)
    agg = res.pop("value")
    res.pop("unit")
    if args.fast_forward:
        res.update(ff_stats(step.stats, steps, chunk))
    out = {"metric": f"{args.proto}_{args.nodes}n_{args.seeds}seeds_agg_"
                     "sim_ms_per_sec",
           "value": agg, "unit": "sim_ms/s", "platform": platform,
           "engine": engine, "superstep": k,
           "sim_ms": steps * chunk, "chunk": chunk,
           "device": (torch.cuda.get_device_name(proto.device)
                      if platform == "cuda" else platform),
           "card": card(platform), **res}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
