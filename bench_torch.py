#!/usr/bin/env python3
"""Benchmark headline of the PyTorch/CUDA port (`wittgenstein_tpu_torch`):
the reference-default Handel (`bench.py`'s `_handel_setup`), a batch of
seeds on the seed-folded engine (`core/batched.scan_chunk_batched`,
superstep K=2, phase-specialized chunks entered at t0_mod=0), timed
under the measurement protocol of `utils/measure.timed_chunks`.

    python3 bench_torch.py                      # 2048 nodes x 16 seeds, cuda
    python3 bench_torch.py --device cpu --nodes 64 --seeds 2 --ms 200

Prints one JSON line in `bench.py`'s shape: ``metric``
(``handel_{N}n_{R}seeds_agg_sim_ms_per_sec``), ``value`` (aggregate
simulated ms per second over all seeds), ``platform`` (``cuda`` or
``cpu``), ``engine`` (``batched``), ``superstep``, the card's name and
power limit, and the measurement's walls.  Every run must converge (mean
live frac_done > 0.99) with zero drops, clamps and evictions, as
`bench.py` asserts (bench.py:529-541).
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


#: The headline's chunk length and superstep (bench.py's _handel_setup).
CHUNK_MS = 200
SUPERSTEP = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--ms", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
    from wittgenstein_tpu_torch.core.state import init_batched
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    from wittgenstein_tpu_torch.utils.measure import timed_chunks

    proto = Handel(**reference_default_params(args.nodes),
                   device=args.device)
    platform = proto.device.type
    seeds = torch.arange(args.seeds)
    run = scan_chunk_batched(proto, CHUNK_MS, t0_mod=0,
                             superstep=SUPERSTEP)
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

    def check(nets, ps):
        done_at = nets.nodes.done_at.cpu().numpy()
        downs = nets.nodes.down.cpu().numpy()
        counts = {k: int(getattr(nets, k).sum()) for k in
                  ("dropped", "bc_dropped", "clamped")}
        counts["evicted"] = int(ps.evicted.sum())
        frac_done = float(np.mean([(done_at[i][~downs[i]] > 0).mean()
                                   for i in range(args.seeds)]))
        if not frac_done > 0.99:
            raise AssertionError(f"Handel did not converge: {frac_done:.3f}")
        if any(counts.values()):
            raise AssertionError(f"drops, clamps or evictions: {counts}")
        return {"frac_done": frac_done, **counts}

    res = timed_chunks(step, init, steps, args.seeds, CHUNK_MS, check,
                       reps=args.reps)
    agg = res.pop("value")
    res.pop("unit")
    out = {"metric": f"handel_{args.nodes}n_{args.seeds}seeds_agg_sim_ms_"
                     "per_sec",
           "value": agg, "unit": "sim_ms/s", "platform": platform,
           "engine": "batched", "superstep": SUPERSTEP,
           "sim_ms": steps * CHUNK_MS, "chunk": CHUNK_MS,
           "device": (torch.cuda.get_device_name(proto.device)
                      if platform == "cuda" else platform),
           "card": card(platform), **res}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
