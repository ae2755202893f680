"""OptimisticP2PSignature sweeps — the port of
`wittgenstein_tpu/scenarios/optimistic_scenarios.py`
(OptimisticP2PSignatureScenarios.java).

BasicStats (doneAt and msgReceived min/avg/max over live nodes) over a
doubling node-count ladder, with the reference's default parameters:
threshold 99% of the nodes, pairing 3 ms, 4 connections, nodes placed by
city and the measured city latency with its jitter.  Each ladder point
runs its seeds in one batch (`core/harness.run_multiple_times`) and the
CSV text is the JAX package's.

Every entry point takes ``device=`` (``cuda`` unless the caller asks
for another).  Run as ``python -m
wittgenstein_tpu_torch.scenarios.optimistic_scenarios [out_dir]`` for a
small smoke sweep on the card.
"""

from __future__ import annotations

from ..core import builders
from ..core.harness import run_multiple_times
from ..models.optimistic import OptimisticP2PSignature, cont_if_optimistic
from ..tools.csvf import CSVFormatter
from ..utils import stats as stats_mod


def default_params(nodes, **overrides):
    """defaultParams
    (wittgenstein_tpu/scenarios/optimistic_scenarios.py:19-28)."""
    params = dict(node_count=nodes, threshold=int(nodes * 0.99),
                  pairing_time=3, connection_count=4,
                  node_builder_name=builders.registry_name(
                      "cities", True, 0.0),
                  network_latency_name="NetworkLatencyByCityWJitter")
    params.update(overrides)
    return params


def basic_stats(proto, seeds, max_time=60_000, chunk=500):
    """BasicStats of one ladder point
    (wittgenstein_tpu/scenarios/optimistic_scenarios.py:31-40)."""
    res = run_multiple_times(
        proto, run_count=seeds, max_time=max_time, chunk=chunk,
        cont_if=cont_if_optimistic,
        stats_getters=(stats_mod.simple_stats("doneAt", "done_at"),
                       stats_mod.simple_stats("msgReceived",
                                              "msg_received")))
    d, m = res.stats["doneAt"], res.stats["msgReceived"]
    return {"done_min": d["min"], "done_avg": d["avg"], "done_max": d["max"],
            "msg_min": m["min"], "msg_avg": m["avg"], "msg_max": m["max"]}


def node_scaling(counts=(128, 256, 512, 1024), seeds=2, out_dir=".", *,
                 device=None):
    """Behaviour as the node count grows
    (wittgenstein_tpu/scenarios/optimistic_scenarios.py:43-55)."""
    csv = CSVFormatter(["nodes", "done_avg", "done_max", "msg_avg"])
    for n in counts:
        proto = OptimisticP2PSignature(**default_params(n), device=device)
        r = basic_stats(proto, seeds)
        csv.add(nodes=n, done_avg=round(r["done_avg"], 1),
                done_max=round(r["done_max"], 1),
                msg_avg=round(r["msg_avg"], 1))
        print(f"{n} nodes: {r}")
    csv.save(f"{out_dir}/optimistic_scaling.csv")
    return csv


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    node_scaling(counts=(128, 256), seeds=2, out_dir=out)
