"""P2PHandel experiment sweeps — the port of
`wittgenstein_tpu/scenarios/p2phandel_scenarios.py`
(P2PHandelScenarios.java).

The reference's configuration: the P2PHandelParameters defaults
(threshold 99% of the signers, 40 connections, pairing 100 ms, a send
every 1,000 ms), nodes placed by city and the measured city latency with
its jitter.  `basic_stats` collects BasicStats (doneAt and msgReceived
min/avg/max over live nodes, bytesReceived avg) for one sweep point,
its seeds in one batch (`core/harness.run_multiple_times`);
`strategy_sweep` compares the send strategies and `node_scaling` the
node counts, each into a CSV file whose text is the JAX package's.

Every entry point takes ``device=`` (``cuda`` unless the caller asks
for another).  Run as ``python -m
wittgenstein_tpu_torch.scenarios.p2phandel_scenarios [out_dir]`` for a
small smoke sweep on the card.
"""

from __future__ import annotations

from ..core import builders
from ..core.harness import run_multiple_times
from ..models.p2phandel import (ALL, CMP_ALL, CMP_DIFF, DIF, P2PHandel,
                                cont_if_p2phandel)
from ..tools.csvf import CSVFormatter
from ..utils import stats as stats_mod

STRATEGY_NAMES = {ALL: "all", DIF: "dif", CMP_ALL: "cmp_all",
                  CMP_DIFF: "cmp_diff"}


def default_params(signers=100, relays=20, dead_ratio=0.0, **overrides):
    """The default P2PHandel configuration
    (wittgenstein_tpu/scenarios/p2phandel_scenarios.py:26-36);
    threshold = 99% of signers."""
    params = dict(signing_node_count=signers, relaying_node_count=relays,
                  threshold=int(signers * 0.99), connection_count=40,
                  pairing_time=100, sigs_send_period=1000,
                  node_builder_name=builders.registry_name(
                      "cities", True, 0.0),
                  network_latency_name="NetworkLatencyByCityWJitter")
    params.update(overrides)
    return params


def basic_stats(proto, seeds, max_time=60_000, chunk=500):
    """BasicStats of one sweep point
    (wittgenstein_tpu/scenarios/p2phandel_scenarios.py:39-53)."""
    res = run_multiple_times(
        proto, run_count=seeds, max_time=max_time, chunk=chunk,
        cont_if=cont_if_p2phandel,
        stats_getters=(stats_mod.simple_stats("doneAt", "done_at"),
                       stats_mod.simple_stats("msgReceived", "msg_received"),
                       stats_mod.simple_stats("bytesReceived",
                                              "bytes_received")))
    d, m, b = (res.stats["doneAt"], res.stats["msgReceived"],
               res.stats["bytesReceived"])
    return {"done_min": d["min"], "done_avg": d["avg"], "done_max": d["max"],
            "msg_min": m["min"], "msg_avg": m["avg"], "msg_max": m["max"],
            "bytes_avg": b["avg"]}


def strategy_sweep(signers=64, relays=8, seeds=2, out_dir=".",
                   strategies=(ALL, DIF, CMP_ALL, CMP_DIFF), *, device=None):
    """The send strategies {all, dif, cmp_all, cmp_diff} side by side
    (wittgenstein_tpu/scenarios/p2phandel_scenarios.py:56-74)."""
    csv = CSVFormatter(["strategy", "done_avg", "msg_avg", "bytes_avg"])
    for strat in strategies:
        proto = P2PHandel(**default_params(signers, relays,
                                           send_sigs_strategy=strat),
                          device=device)
        r = basic_stats(proto, seeds)
        csv.add(strategy=STRATEGY_NAMES[strat],
                done_avg=round(r["done_avg"], 1),
                msg_avg=round(r["msg_avg"], 1),
                bytes_avg=round(r["bytes_avg"], 1))
        print(f"strategy={STRATEGY_NAMES[strat]}: {r}")
    csv.save(f"{out_dir}/p2phandel_strategies.csv")
    return csv


def node_scaling(counts=(64, 128, 256), relay_ratio=0.2, seeds=2,
                 out_dir=".", *, device=None):
    """Node-count scaling
    (wittgenstein_tpu/scenarios/p2phandel_scenarios.py:77-89)."""
    csv = CSVFormatter(["signers", "done_avg", "done_max", "msg_avg"])
    for n in counts:
        proto = P2PHandel(**default_params(n, max(1, int(n * relay_ratio))),
                          device=device)
        r = basic_stats(proto, seeds)
        csv.add(signers=n, done_avg=round(r["done_avg"], 1),
                done_max=round(r["done_max"], 1),
                msg_avg=round(r["msg_avg"], 1))
        print(f"signers={n}: {r}")
    csv.save(f"{out_dir}/p2phandel_scaling.csv")
    return csv


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    strategy_sweep(out_dir=out, strategies=(ALL, DIF))
    node_scaling(counts=(64, 128), out_dir=out)
