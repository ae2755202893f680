"""Tracing and profiling hooks — the port of
`wittgenstein_tpu/utils/profiling.py` (the replacement of the
reference's observability surface, SURVEY.md §5.1: per-node counters,
protocol counters and the wall-clock print of ProgressPerTime).

The counters live in `NodeState`; this module adds a profiler trace
context and the one-line run report.  `trace` records a
`torch.profiler` trace (CPU and, on a card, CUDA activity) and exports
it as a Chrome trace, where the JAX module starts `jax.profiler`.

Usage::

    from wittgenstein_tpu_torch.utils.profiling import (run_report,
                                                         timed, trace)
    with trace("/tmp/wtpu-trace"):          # open in Perfetto
        net, ps = runner.run_ms(net, ps, 1000)
    print(run_report(net, wall_s))
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A `torch.profiler` trace around a stretch of simulation, written
    to ``log_dir/trace.json`` (Chrome trace format) at exit; no-op when
    `log_dir` is None (the tests, CI)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed():
    """Wall-clock context: ``with timed() as t: ...; t()`` -> seconds of
    the BLOCK (frozen at exit — the "Simulation execution time"
    measurement, ProgressPerTime.java:111)."""
    box = {"end": None}
    t0 = time.perf_counter()

    def elapsed():
        return (box["end"] or time.perf_counter()) - t0

    try:
        yield elapsed
    finally:
        box["end"] = time.perf_counter()


def _host(x) -> np.ndarray:
    """A tensor (or number) as a numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_report(net, wall_s: float | None = None, ff: dict | None = None,
               trace: dict | None = None,
               audit: dict | None = None) -> str:
    """One-line run summary from the engine counters
    (wittgenstein_tpu/utils/profiling.py:48-129), the same text the
    JAX package prints for the same state: simulated time, per-node
    message/byte traffic over live nodes (the StatsHelper getters, which
    guard the all-down case), drop/clamp health, and sim-ms-per-second
    when `wall_s` is given.  `ff` is a run's skip accounting
    (`Runner(fast_forward=True).ff_stats()`), `trace` its flight
    recorder's (`Runner(trace=...).trace_stats()`), `audit` its
    verdict (`Runner(audit=...).audit_stats()`); each adds its part as
    the JAX report does, a truncated trace and a violated audit
    loudly.  Reads the device."""
    from . import stats
    nodes = net.nodes
    live = int((~_host(nodes.down)).sum())
    t = int(_host(net.time))
    msg_r = stats.msg_received_stats(nodes)
    msg_s = stats.msg_sent_stats(nodes)
    by_s = stats.bytes_sent_stats(nodes)
    done = int(stats.done_count(nodes)["count"])
    parts = [
        f"sim={t}ms",
        f"live={live}",
        # max over an empty live set is the -inf sentinel; report 0.
        f"msgRecv avg={float(msg_r['avg']):.1f} "
        f"max={max(0.0, float(msg_r['max'])):.0f}",
        f"msgSent avg={float(msg_s['avg']):.1f}",
        f"bytesSent avg={float(by_s['avg']):.0f}",
        f"done={done}/{live}",
        f"dropped={int(_host(net.dropped))}"
        f"+{int(_host(net.bc_dropped))}bc",
        f"clamped={int(_host(net.clamped))}",
    ]
    if ff is not None:
        skipped = int(_host(ff["skipped_ms"]).reshape(-1)[0])
        jumps = int(_host(ff["jump_count"]).reshape(-1)[0])
        parts.append(f"ff skipped={skipped}ms jumps={jumps} "
                     f"skip_rate={skipped / max(1, t):.3f}")
    if trace is not None:
        tr = (f"trace events={int(trace['events'])} "
              f"hw={int(trace['high_water'])}/{int(trace['capacity'])}")
        if int(trace["dropped"]) > 0:
            tr += (f" TRUNCATED dropped={int(trace['dropped'])} "
                   "(raise TraceSpec.capacity)")
        parts.append(tr)
    if audit is not None:
        if audit["total"] == 0:
            parts.append(f"audit clean "
                         f"({len(audit['invariants'])} invariants)")
        else:
            per = ",".join(f"{k}={v}"
                           for k, v in audit["violations"].items() if v)
            au = f"!! AUDIT VIOLATIONS total={audit['total']} [{per}]"
            first = audit.get("first")
            if first:
                au += (f" first=(ms {first['ms']} {first['invariant']} "
                       f"index={first['index']})")
            parts.append(au)
    if wall_s is not None and wall_s > 0:
        parts.append(f"wall={wall_s:.2f}s ({t / wall_s:.0f} sim-ms/s)")
    return "Simulation execution time: " + " ".join(parts)
