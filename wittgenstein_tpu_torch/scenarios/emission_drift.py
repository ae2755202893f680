"""Stored vs hashed emission-order drift — the port of
`wittgenstein_tpu/scenarios/emission_drift.py`.

The stored emission mode keeps the reference's per-(sender, level)
emission lists sorted by the rank each receiver gives the sender; the
hashed mode (the path past 32,768 nodes, with no O(N^2) emission state)
sends in a keyed permutation of each level instead.  This driver runs
one configuration in both modes, a batch of seeds each, and reports the
live nodes' doneAt distribution (mean, p50, p90, p99, max, completion
fraction) and the relative drift.  Run:

    python -m wittgenstein_tpu_torch.scenarios.emission_drift [out_dir] \\
        [nodes] [seeds]

Results land in ``<out_dir>/emission_drift_<nodes>n.csv`` and print as
one JSON line per mode.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .. import convert
from ..core.harness import run_multiple_times
from ..models.handel import Handel, cont_if_handel
from ..tools.csvf import CSVFormatter
from .handel_scenarios import default_params


def run_mode(mode, nodes=2048, seeds=32, max_time=6000, chunk=250,
             first_seed=0, attack=None, dead_ratio=None,
             seed_batch=None, *, device=None):
    """One emission mode (wittgenstein_tpu/scenarios/emission_drift.py:
    32-87); `attack` in (None, "byzantine_suicide", "hidden_byzantine")
    turns the dead fraction into attackers.  `seed_batch` caps the
    batch: more seeds run as sequential batches of that many, which
    gives the same results as one batch (every run is a function of its
    seed alone)."""
    kw = {} if dead_ratio is None else {"dead_ratio": dead_ratio}
    params = default_params(nodes=nodes, **kw)
    if attack:
        params[attack] = True
    params["emission_mode"] = mode
    proto = Handel(**params, device=device)
    sb = seeds if seed_batch is None else min(seed_batch, seeds)
    assert seeds % sb == 0
    t0 = time.perf_counter()
    ld_parts, evicted = [], 0
    for b in range(seeds // sb):
        res = run_multiple_times(proto, run_count=sb, max_time=max_time,
                                 chunk=chunk, cont_if=cont_if_handel,
                                 first_seed=first_seed + b * sb)
        net_np, ps_np = convert.to_numpy(res.nets, res.pstates)
        done_at = net_np["nodes"]["done_at"]
        down = net_np["nodes"]["down"]
        ld_parts += [done_at[i][~down[i]] for i in range(sb)]
        evicted += int(ps_np["evicted"].sum())
    wall = time.perf_counter() - t0
    live_done = np.concatenate(ld_parts)
    finished = live_done[live_done > 0]
    frac = finished.size / live_done.size
    nan = float("nan")

    def q(p):
        return float(np.percentile(finished, p)) if finished.size else nan
    return {
        "mode": mode, "nodes": nodes, "seeds": seeds,
        "frac_done": round(frac, 4),
        "mean_ms": round(float(finished.mean()), 1) if finished.size
        else nan,
        "p50_ms": round(q(50), 1), "p90_ms": round(q(90), 1),
        "p99_ms": round(q(99), 1),
        "max_ms": float(finished.max()) if finished.size else nan,
        "evicted": evicted,
        "wall_s": round(wall, 1),
    }


def compare(nodes=2048, seeds=32, max_time=6000, out_dir=".", attack=None,
            dead_ratio=None, seed_batch=None, *, device=None):
    """Both modes on one configuration
    (wittgenstein_tpu/scenarios/emission_drift.py:90-117)."""
    if seed_batch is None and nodes >= 8192:
        # The JAX package's rule: keep the stored [R, N, N] emission
        # lists under ~768 MB a batch, the JAX runtime's ~1 GB
        # single-buffer limit (268 MB a seed at 8,192 nodes).  The
        # limit is the JAX runtime's; the port keeps the rule so that
        # both packages split a run the same way.
        seed_batch = max(1, (768 << 20) // (4 * nodes * nodes))
        while seeds % seed_batch:
            seed_batch -= 1
    csv = CSVFormatter(["mode", "nodes", "seeds", "frac_done", "mean_ms",
                        "p50_ms", "p90_ms", "p99_ms", "max_ms", "evicted",
                        "wall_s"])
    rows = {}
    for mode in ("stored", "hashed"):
        r = run_mode(mode, nodes=nodes, seeds=seeds, max_time=max_time,
                     attack=attack, dead_ratio=dead_ratio,
                     seed_batch=seed_batch, device=device)
        r["attack"] = attack or "none"
        rows[mode] = r
        csv.add(**r)                 # unknown keys are ignored by add()
        print(json.dumps(r))
    drift_mean = rows["hashed"]["mean_ms"] / rows["stored"]["mean_ms"] - 1
    drift_p90 = rows["hashed"]["p90_ms"] / rows["stored"]["p90_ms"] - 1
    print(json.dumps({"attack": attack or "none", "nodes": nodes,
                      "drift_mean_pct": round(100 * drift_mean, 2),
                      "drift_p90_pct": round(100 * drift_p90, 2)}))
    suffix = f"_{attack}" if attack else ""
    os.makedirs(out_dir, exist_ok=True)
    csv.save(f"{out_dir}/emission_drift_{nodes}n{suffix}.csv")
    return rows


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    nodes = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    seeds = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    compare(nodes=nodes, seeds=seeds, out_dir=out)
