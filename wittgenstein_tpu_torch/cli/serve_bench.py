"""Cold-vs-warm submit->result latency of the request plane; the port of
`tools/serve_bench.py`.

ONE in-process `serve.Service`, the same `ScenarioSpec` shape submitted
twice:

  cold: a fresh registry, the first build of the chunk programs (the
        kernel library may still come from the on-disk build cache of
        `ops/_build.py`; the ``compile_cache`` field says which
        happened: ``miss`` when the library was built during this call,
        ``hit`` when it was loaded or already loaded, ``off`` off the
        card);
  warm: a second request with different seeds: the same compile key, a
        registry HIT.

Output: one JSON line on stdout with both latencies and the registry
counters (the root tool's keys), and on the card the card's name and
power limit (``card``, as `nvidia-smi` reports them).

Usage: python -m wittgenstein_tpu_torch.cli.serve_bench [nodes] [sim_ms]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time


def timed_submit(svc, spec):
    """submit -> drain -> result, one wall-clock number (the latency a
    synchronous client of the manual-drain service observes)."""
    t0 = time.perf_counter()
    sub = svc.submit(spec.to_json())
    svc.run_pending()
    res = svc.result(sub["id"])
    wall = time.perf_counter() - t0
    assert res["status"] == "done", res
    assert res["audit"]["clean"], res["audit"]
    return wall, res


def card(device) -> str | None:
    """The card's name and power limit as nvidia-smi reports them (None
    off the card)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.serve_bench",
        description="cold vs warm submit->result latency of one Service")
    ap.add_argument("nodes", nargs="?", type=int, default=64)
    ap.add_argument("sim_ms", nargs="?", type=int, default=240)
    ap.add_argument("--device", default=None,
                    help="the device the service runs on (default cuda)")
    args = ap.parse_args(argv)

    from ..core.state import resolve_device
    from ..ops import _build
    from ..serve import ScenarioSpec, Scheduler, Service
    from ..server.core import load_models
    load_models()
    dev = resolve_device(args.device)
    n, sim_ms = args.nodes, args.sim_ms
    built_before = "seconds" in _build.BUILD_INFO
    svc = Service(scheduler=Scheduler(device=dev), auto=False)
    # largest chunk <= 120 that divides the requested span
    chunk = max(d for d in range(1, min(sim_ms, 120) + 1)
                if sim_ms % d == 0)
    spec = ScenarioSpec(protocol="PingPong", params={"node_count": n},
                        seeds=(0,), sim_ms=sim_ms, chunk_ms=chunk,
                        obs=("metrics", "audit"))
    cold_s, _ = timed_submit(svc, spec)
    warm_s, _ = timed_submit(svc, dataclasses.replace(spec, seeds=(1,)))
    svc.close()
    reg = svc.registry_stats()
    assert reg["hits"] >= 1, reg        # the warm leg must be a HIT
    built = "seconds" in _build.BUILD_INFO and not built_before
    out = {
        "metric": f"serve_warm_submit_latency_ms_pingpong_{n}n",
        "value": round(1e3 * warm_s, 1),
        "unit": "ms",
        "cold_ms": round(1e3 * cold_s, 1),
        "warm_ms": round(1e3 * warm_s, 1),
        "cold_over_warm": round(cold_s / max(warm_s, 1e-9), 1),
        "sim_ms": sim_ms,
        "registry": reg,
        "compile_cache": ("off" if dev.type != "cuda" else
                          "miss" if built else "hit"),
        "platform": dev.type,
    }
    if dev.type == "cuda":
        out["card"] = card(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
