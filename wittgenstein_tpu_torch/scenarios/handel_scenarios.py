"""Handel experiment sweeps — the port of
`wittgenstein_tpu/scenarios/handel_scenarios.py` (HandelScenarios.java).

The reference's default scenario: 2048 nodes, 10% dead, threshold
0.99 * live, pairing 4 ms, level wait 50 ms, period 20 ms, fast path
10, the cities builder.  Sweeps: node-count scaling, Tor fraction,
desynchronized start, period, the two Byzantine attacks, fail-silent
errors, extra cycles and the fast-path peer count.  Every sweep point
runs a batch of seeds at once (`core/harness.run_multiple_times`) and
the results land in a CSV file (and, for some sweeps, a PNG, which
needs matplotlib; `gen_anim`'s GIF needs PIL).  The CSV means are
computed on the host from the runs' `done_at` arrays, as the JAX
package computes them, so the text is the same; `wall_s` is the one
column that differs by nature.

Every entry point takes ``device=`` (``cuda`` unless the caller asks
for another).  Run as ``python -m
wittgenstein_tpu_torch.scenarios.handel_scenarios [out_dir]`` for a
small smoke sweep on the card.
"""

from __future__ import annotations

import time

import numpy as np

from .. import convert
from ..core import builders
from ..core.harness import run_multiple_times
from ..models.handel import Handel, cont_if_handel
from ..tools.csvf import CSVFormatter
from ..tools.graph import Graph, Series


def default_params(nodes=2048, dead_ratio=0.10, **overrides):
    """HandelScenarios.defaultParams
    (wittgenstein_tpu/scenarios/handel_scenarios.py:28-39)."""
    dead = int(nodes * dead_ratio)
    params = dict(node_count=nodes, nodes_down=dead,
                  threshold=int(0.99 * (nodes - dead)),
                  pairing_time=4, level_wait_time=50,
                  dissemination_period_ms=20, fast_path=10,
                  node_builder_name=builders.registry_name(
                      "cities", True, 0.0),
                  network_latency_name="NetworkLatencyByDistanceWJitter")
    params.update(overrides)
    return params


def _run_point(params, seeds, max_time=4000, chunk=250, *, device=None):
    """One sweep point: `seeds` runs in one batch until every live node
    is done or `max_time` (wittgenstein_tpu/scenarios/
    handel_scenarios.py:42-71).  Nothing may be evicted from the bounded
    verification queue outside the attack scenarios."""
    proto = Handel(**params, device=device)
    t0 = time.perf_counter()
    res = run_multiple_times(proto, run_count=seeds, max_time=max_time,
                             chunk=chunk, cont_if=cont_if_handel)
    wall = time.perf_counter() - t0
    net_np, ps_np = convert.to_numpy(res.nets, res.pstates)
    evicted = int(ps_np["evicted"].sum())
    if not (params.get("hidden_byzantine") or params.get("byzantine_suicide")):
        assert evicted == 0, \
            f"{evicted} queue evictions in a non-byzantine scenario: " \
            "queue_cap is undersized for this config"
    done_at = net_np["nodes"]["done_at"]
    down = net_np["nodes"]["down"]
    per_run_done = [done_at[i][~down[i]] for i in range(seeds)]
    return {
        "avg_done_ms": float(np.mean([d.mean() for d in per_run_done])),
        "max_done_ms": float(np.max([d.max() for d in per_run_done])),
        "frac_done": float(np.mean([(d > 0).mean() for d in per_run_done])),
        "wall_s": wall,
        "msg_sent_avg": float(net_np["nodes"]["msg_sent"].mean()),
        "bytes_sent_avg": float(net_np["nodes"]["bytes_sent"].mean()),
    }


def node_scaling(counts=(128, 256, 512, 1024, 2048), seeds=4, out_dir=".",
                 *, device=None):
    """Node-count scaling (wittgenstein_tpu/scenarios/
    handel_scenarios.py:74-93); writes a CSV and a PNG."""
    csv = CSVFormatter(["nodes", "avg_done_ms", "max_done_ms", "wall_s",
                        "msg_sent_avg"])
    g = Graph("Handel: time to aggregate vs node count", "nodes",
              "avg doneAt (ms)")
    s = Series("avg doneAt")
    for n in counts:
        r = _run_point(default_params(nodes=n), seeds, device=device)
        csv.add(nodes=n, **{k: round(v, 1) for k, v in r.items()
                            if k in csv.columns})
        s.add(n, r["avg_done_ms"])
        print(f"nodes={n}: {r}")
    g.add_series(s)
    csv.save(f"{out_dir}/handel_node_scaling.csv")
    g.save(f"{out_dir}/handel_node_scaling.png")
    return csv


def tor_sweep(fractions=(0.0, 0.1, 0.33), nodes=256, seeds=4, out_dir=".",
              *, device=None):
    """Tor-like extra-latency fraction sweep
    (wittgenstein_tpu/scenarios/handel_scenarios.py:96-113).  Tor adds
    500 ms per endpoint, so the ring's horizon is 2,048 ms."""
    csv = CSVFormatter(["tor", "avg_done_ms", "max_done_ms"])
    for tor in fractions:
        name = builders.registry_name("random", True, tor)
        r = _run_point(default_params(nodes=nodes, node_builder_name=name,
                                      horizon=2048), seeds,
                       max_time=8000, device=device)
        csv.add(tor=tor, avg_done_ms=round(r["avg_done_ms"], 1),
                max_done_ms=round(r["max_done_ms"], 1))
        print(f"tor={tor}: {r}")
    csv.save(f"{out_dir}/handel_tor.csv")
    return csv


def desync_sweep(starts=(0, 50, 200), nodes=256, seeds=4, out_dir=".",
                 *, device=None):
    """Desynchronized start sweep
    (wittgenstein_tpu/scenarios/handel_scenarios.py:116-127)."""
    csv = CSVFormatter(["desync_ms", "avg_done_ms", "max_done_ms"])
    for d in starts:
        r = _run_point(default_params(nodes=nodes,
                                      desynchronized_start=d), seeds,
                       device=device)
        csv.add(desync_ms=d, avg_done_ms=round(r["avg_done_ms"], 1),
                max_done_ms=round(r["max_done_ms"], 1))
        print(f"desync={d}: {r}")
    csv.save(f"{out_dir}/handel_desync.csv")
    return csv


def period_sweep(periods=(10, 20, 50), nodes=256, seeds=4, out_dir=".",
                 *, device=None):
    """Dissemination period sweep
    (wittgenstein_tpu/scenarios/handel_scenarios.py:130-141)."""
    csv = CSVFormatter(["period_ms", "avg_done_ms", "bytes_sent_avg"])
    for p in periods:
        r = _run_point(default_params(nodes=nodes,
                                      dissemination_period_ms=p), seeds,
                       device=device)
        csv.add(period_ms=p, avg_done_ms=round(r["avg_done_ms"], 1),
                bytes_sent_avg=round(r["bytes_sent_avg"], 1))
        print(f"period={p}: {r}")
    csv.save(f"{out_dir}/handel_period.csv")
    return csv


def byz_suicide_sweep(ratios=(0.0, 0.1, 0.25, 0.5), nodes=256, seeds=4,
                      out_dir=".", *, device=None):
    """byzantineSuicide attack sweep: Byzantine ratio vs the honest
    nodes' time to aggregate, threshold 0.99 * live
    (wittgenstein_tpu/scenarios/handel_scenarios.py:144-161)."""
    csv = CSVFormatter(["byz_ratio", "avg_done_ms", "max_done_ms",
                        "frac_done"])
    for ratio in ratios:
        params = default_params(nodes=nodes, dead_ratio=ratio,
                                byzantine_suicide=ratio > 0)
        r = _run_point(params, seeds, max_time=8000, device=device)
        csv.add(byz_ratio=ratio, avg_done_ms=round(r["avg_done_ms"], 1),
                max_done_ms=round(r["max_done_ms"], 1),
                frac_done=round(r["frac_done"], 3))
        print(f"byz_suicide ratio={ratio}: {r}")
    csv.save(f"{out_dir}/handel_byz_suicide.csv")
    return csv


def hidden_byz_sweep(ratios=(0.0, 0.1, 0.25, 0.5), nodes=256, seeds=4,
                     out_dir=".", *, device=None):
    """hiddenByzantine attack sweep
    (wittgenstein_tpu/scenarios/handel_scenarios.py:164-179)."""
    csv = CSVFormatter(["byz_ratio", "avg_done_ms", "max_done_ms",
                        "frac_done"])
    for ratio in ratios:
        params = default_params(nodes=nodes, dead_ratio=ratio,
                                hidden_byzantine=ratio > 0)
        r = _run_point(params, seeds, max_time=8000, device=device)
        csv.add(byz_ratio=ratio, avg_done_ms=round(r["avg_done_ms"], 1),
                max_done_ms=round(r["max_done_ms"], 1),
                frac_done=round(r["frac_done"], 3))
        print(f"hidden_byz ratio={ratio}: {r}")
    csv.save(f"{out_dir}/handel_hidden_byz.csv")
    return csv


def log_errors(error_rate=0.2, counts=(32, 64, 128, 256), seeds=4,
               out_dir=".", *, device=None):
    """Fail-silent error-rate node scaling
    (wittgenstein_tpu/scenarios/handel_scenarios.py:182-205); writes a
    CSV and a PNG."""
    csv = CSVFormatter(["nodes", "error_rate", "avg_done_ms",
                        "msg_sent_avg", "frac_done"])
    g = Graph(f"Handel under {int(error_rate * 100)}% fail-silent errors",
              "nodes", "avg doneAt (ms)")
    s = Series(f"errors={int(error_rate * 100)}%")
    for n in counts:
        r = _run_point(default_params(nodes=n, dead_ratio=error_rate),
                       seeds, max_time=8000, device=device)
        csv.add(nodes=n, error_rate=error_rate,
                avg_done_ms=round(r["avg_done_ms"], 1),
                msg_sent_avg=round(r["msg_sent_avg"], 1),
                frac_done=round(r["frac_done"], 3))
        s.add(n, r["avg_done_ms"])
        print(f"errors={error_rate} nodes={n}: {r}")
    g.add_series(s)
    csv.save(f"{out_dir}/handel_errors.csv")
    g.save(f"{out_dir}/handel_errors.png")
    return csv


def extra_cycle_sweep(cycles=(10, 15, 20, 30, 40, 50), nodes=256, seeds=4,
                      dead_ratio=0.10, out_dir=".", *, device=None):
    """extraCycle sweep
    (wittgenstein_tpu/scenarios/handel_scenarios.py:208-225)."""
    csv = CSVFormatter(["extra_cycle", "avg_done_ms", "msg_sent_avg",
                        "frac_done"])
    for ec in cycles:
        r = _run_point(default_params(nodes=nodes, dead_ratio=dead_ratio,
                                      extra_cycle=ec), seeds,
                       max_time=8000, device=device)
        csv.add(extra_cycle=ec, avg_done_ms=round(r["avg_done_ms"], 1),
                msg_sent_avg=round(r["msg_sent_avg"], 1),
                frac_done=round(r["frac_done"], 3))
        print(f"extra_cycle={ec}: {r}")
    csv.save(f"{out_dir}/handel_extra_cycle.csv")
    return csv


def contacted_node_sweep(fast_paths=(0, 5, 10, 20, 40), nodes=256, seeds=4,
                         dead_ratio=0.10, out_dir=".", *, device=None):
    """Fast-path peer-count sweep
    (wittgenstein_tpu/scenarios/handel_scenarios.py:228-251); writes a
    CSV and a PNG."""
    csv = CSVFormatter(["fast_path", "avg_done_ms", "msg_sent_avg",
                        "frac_done"])
    g = Graph("Handel: time vs fast-path peer count", "fast path peers",
              "avg doneAt (ms)")
    s = Series("avg doneAt")
    for fp in fast_paths:
        r = _run_point(default_params(nodes=nodes, dead_ratio=dead_ratio,
                                      fast_path=fp), seeds, max_time=8000,
                       device=device)
        csv.add(fast_path=fp, avg_done_ms=round(r["avg_done_ms"], 1),
                msg_sent_avg=round(r["msg_sent_avg"], 1),
                frac_done=round(r["frac_done"], 3))
        s.add(fp, r["avg_done_ms"])
        print(f"fast_path={fp}: {r}")
    g.add_series(s)
    csv.save(f"{out_dir}/handel_fastpath.csv")
    g.save(f"{out_dir}/handel_fastpath.png")
    return csv


def gen_anim(nodes=256, out_path="handel.gif", frames=20, frame_ms=50,
             *, device=None):
    """Animated GIF of aggregation progress (wittgenstein_tpu/scenarios/
    handel_scenarios.py:254-276, HandelScenarios.genAnim); needs PIL."""
    from ..core.network import Runner
    from ..ops import bitset
    from ..tools.node_drawer import NodeDrawer
    params = default_params(nodes=nodes, node_builder_name=None)
    proto = Handel(**params, device=device)
    runner = Runner(proto)
    net, ps = proto.init(0)
    drawer = NodeDrawer(vmin=1, vmax=nodes)
    for _ in range(frames):
        net, ps = runner.run_ms(net, ps, frame_ms)
        vals = bitset.popcount(ps.last_agg | ps.ver_ind).cpu().numpy()
        drawer.draw(net.nodes, vals)
        if bool((net.nodes.done_at[~net.nodes.down] > 0).all()):
            break
    drawer.save_gif(out_path, ms_per_frame=120)
    return out_path


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    node_scaling(counts=(128, 256), seeds=2, out_dir=out)
    tor_sweep(fractions=(0.0, 0.33), nodes=128, seeds=2, out_dir=out)
