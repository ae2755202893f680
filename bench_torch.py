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
the seeds) > 0, with drops and broadcast drops reported.

    python3 bench_torch.py                      # 2048 nodes x 16 seeds, cuda
    python3 bench_torch.py --device cpu --nodes 64 --seeds 2 --ms 200
    python3 bench_torch.py --proto pingpong     # 256 nodes x 4 seeds, cuda

Prints one JSON line in `bench.py`'s shape: ``metric``
(``{proto}_{N}n_{R}seeds_agg_sim_ms_per_sec``), ``value`` (aggregate
simulated ms per second over all seeds), ``platform`` (``cuda`` or
``cpu``), ``engine`` (``batched``, or ``vmapped`` as `bench_quiet`
names the seed-batched dense engine), ``superstep``, the card's name and
power limit, and the measurement's walls.
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


#: The chunk length of both lines and the headline's superstep
#: (bench.py's _handel_setup and bench_quiet).
CHUNK_MS = 200
SUPERSTEP = 2
#: per protocol: default node count and seed count
DEFAULTS = {"handel": (2048, 16), "pingpong": (256, 4)}


def handel_line(args, seeds):
    """The headline's protocol, chunk runner and check."""
    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    proto = Handel(**reference_default_params(args.nodes),
                   device=args.device)
    run = scan_chunk_batched(proto, CHUNK_MS, t0_mod=0,
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
    from wittgenstein_tpu_torch.core.network import pick_superstep, \
        scan_chunk
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=args.nodes, device=args.device)
    k = pick_superstep(proto, CHUNK_MS, t0=0, max_k=SUPERSTEP)
    run = scan_chunk(proto, CHUNK_MS, superstep=k)

    def check(nets, ps):
        progress = int(ps.pongs.sum())
        if not progress > 0:
            raise AssertionError("pingpong made no progress")
        return {"progress": progress, "dropped": int(nets.dropped.sum()),
                "bc_dropped": int(nets.bc_dropped.sum())}
    return proto, run, check, "vmapped", k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--proto", choices=sorted(DEFAULTS), default="handel")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--ms", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    nodes, n_seeds = DEFAULTS[args.proto]
    args.nodes = nodes if args.nodes is None else args.nodes
    args.seeds = n_seeds if args.seeds is None else args.seeds

    import torch

    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.utils.measure import timed_chunks

    line = handel_line if args.proto == "handel" else pingpong_line
    proto, run, check, engine, k = line(args, args.seeds)
    platform = proto.device.type
    seeds = torch.arange(args.seeds)
    steps = max(1, -(-args.ms // CHUNK_MS))
    clock = {"t": 0}

    def init():
        clock["t"] = 0
        return init_batched(proto, seeds)

    def step(nets, ps):
        # The batch's time is kept on the host: no read-back per chunk.
        nets, ps = run(nets, ps, t=clock["t"])
        clock["t"] += CHUNK_MS
        return nets, ps

    res = timed_chunks(step, init, steps, args.seeds, CHUNK_MS, check,
                       reps=args.reps)
    agg = res.pop("value")
    res.pop("unit")
    out = {"metric": f"{args.proto}_{args.nodes}n_{args.seeds}seeds_agg_"
                     "sim_ms_per_sec",
           "value": agg, "unit": "sim_ms/s", "platform": platform,
           "engine": engine, "superstep": k,
           "sim_ms": steps * CHUNK_MS, "chunk": CHUNK_MS,
           "device": (torch.cuda.get_device_name(proto.device)
                      if platform == "cuda" else platform),
           "card": card(platform), **res}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
