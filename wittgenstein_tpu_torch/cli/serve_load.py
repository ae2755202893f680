"""Multi-tenant load generator for the serve request plane; the port of
`tools/serve_load.py` (its arguments, exit codes and JSON keys, with
``--device``, default ``cuda``; worker processes of ``--workers`` run on
the same device).

Hundreds of concurrent mixed-compile-key `ScenarioSpec`s across >= 3
tenants hammer ONE auto-draining `serve.Service` from client threads —
the shape a production deployment actually sees — and the run records
the tenancy plane's honest numbers (the `tenancy` block of the JAX
tool's line):

  * p50/p99 submit->result latency per tenant and overall (wall clock
    from the client's submit call to its poll observing "done");
  * rejection rate: 429-equivalent `AdmissionError`s per tenant
    (clients back off `retry_after_s` and retry, bounded — the
    admission-control round trip, not a crash);
  * preemption count (scheduler chunk-boundary yields) and per-tenant
    completion counts (zero starvation is asserted: every tenant's
    every request eventually completes);
  * compile amortization: completed requests per program build — the
    coalescing story under tenancy (tenancy fields are NOT in the
    compile key, so mixed tenants still share programs).

Tenant mix (weights/budgets exercise every tenancy mechanism):
  interactive — weight 4, short single-seed specs, deadline-carrying;
  campaign    — weight 1, BOUNDED queue (max_queued; the 429 source),
                wider multi-seed specs;
  batch       — weight 2, unbounded, mixed spans.

Usage: python -m wittgenstein_tpu_torch.cli.serve_load [--requests N]
       [--out PATH] [--stream] [--kill-after S] [--timeline DIR]
       [--device cuda|cpu]
       (default 120 requests; --out writes the JSON line to a file
       as well as stdout; --stream adds the long-poll partial-metrics
       smoke check: one spec streamed boundary by boundary over
       `/w/batch/stream`-equivalent `Service.stream`, asserting one
       delta per chunk; --kill-after S hard-stops the clients after S
       seconds and reports the `/w/batch/health` snapshot taken at
       the kill — the crash-safety observability block under real
       load: uptime, queue depths, journal lag, quarantine count,
       watchdog trips, chunk-wall EMA; --timeline DIR turns the host
       flight recorder ON — span JSONL per process under DIR plus one
       merged Perfetto timeline.json where the request-lifecycle host
       spans and one probe request's device trace-ring/metrics lanes
       render together)
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import threading
import time

from ..serve import AdmissionError, ScenarioSpec, Scheduler, Service

#: the three compile keys of the mix (latency_model is program-
#: affecting) — mixed keys make the DRR/preemption path do real work
LATENCIES = (None, "NetworkFixedLatency(10)", "NetworkFixedLatency(30)")


def tenant_specs(name: str, count: int):
    """The tenant's request list (deterministic — seeds/spans derive
    from the request index, so two runs of the generator submit the
    same work)."""
    out = []
    for i in range(count):
        lat = LATENCIES[i % len(LATENCIES)]
        if name == "interactive":
            out.append(ScenarioSpec(
                protocol="PingPong", params={"node_count": 64},
                seeds=(i,), sim_ms=80, chunk_ms=40, obs=("metrics",),
                latency_model=lat, tenant=name, priority=2,
                deadline_ms=60_000))
        elif name == "campaign":
            out.append(ScenarioSpec(
                protocol="PingPong", params={"node_count": 64},
                seeds=(100 + 2 * i, 101 + 2 * i), sim_ms=160,
                chunk_ms=40, obs=("metrics",), latency_model=lat,
                tenant=name))
        else:
            out.append(ScenarioSpec(
                protocol="PingPong", params={"node_count": 64},
                seeds=(500 + i,), sim_ms=120 if i % 2 else 80,
                chunk_ms=40, obs=("metrics",), latency_model=lat,
                tenant=name))
    return out


def drive_tenant(svc, specs, rec, poll_s=0.02, max_attempts=50,
                 stop=None):
    """One tenant's client thread: submit each spec (backing off on
    429s), poll to completion, record the submit->result wall.  A set
    `stop` event (--kill-after) abandons the remaining work — the
    hard-stop shape a killed client population actually has."""
    for spec in specs:
        if stop is not None and stop.is_set():
            return
        t0 = time.perf_counter()
        rid = None
        for _ in range(max_attempts):
            try:
                rid = svc.submit(spec.to_json())["id"]
                break
            except AdmissionError as e:
                rec["rejected"] += 1
                time.sleep(min(e.retry_after_s, 0.5))
                if stop is not None and stop.is_set():
                    return
        if rid is None:
            rec["gave_up"] += 1
            continue
        while True:
            st = svc.status(rid)
            if st["status"] in ("done", "error"):
                break
            if stop is not None and stop.is_set():
                return
            time.sleep(poll_s)
        if st["status"] == "done":
            rec["done"] += 1
            rec["lat_ms"].append(1e3 * (time.perf_counter() - t0))
        else:
            rec["errors"] += 1


def stream_smoke(svc) -> dict:
    """The --stream check: submit one multi-chunk spec to the
    auto-draining service and LONG-POLL its per-chunk totals until
    eof; a healthy stream yields exactly sim_ms/chunk_ms boundary
    entries with monotone times and per-chunk deltas.  Returns the
    JSON block (``ok`` False on any shortfall)."""
    spec = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                        seeds=(0,), sim_ms=160, chunk_ms=40,
                        obs=("metrics",), tenant="stream")
    rid = svc.submit(spec.to_json())["id"]
    chunks, polls = [], 0
    after = None
    t0 = time.perf_counter()
    while True:
        out = svc.stream(rid, after_ms=after, timeout_s=10.0)
        polls += 1
        chunks += out["chunks"]
        after = out["next_after_ms"]
        if out["eof"] or polls > 64:
            break
    wall = time.perf_counter() - t0
    times = [c["t_ms"] for c in chunks]
    want = spec.sim_ms // spec.chunk_ms
    ok = (times == sorted(set(times)) and len(chunks) == want
          and all("delta" in c and "totals" in c for c in chunks)
          and out["eof"])
    return {"ok": ok, "chunks": len(chunks), "expected": want,
            "polls": polls, "wall_s": round(wall, 3),
            "final_totals": chunks[-1]["totals"] if chunks else None}


def fleet_tenants() -> dict:
    """The tenancy policies of the mix, shared by the single-process
    scheduler and the fleet front tier so both runs refuse/weight the
    same way."""
    return {"interactive": {"weight": 4},
            "campaign": {"weight": 1, "max_queued": 4,
                         "retry_after_s": 0.2},
            "batch": {"weight": 2}}


def timeline_probe(sch, timeline_dir) -> dict:
    """The device-merge exercise behind --timeline: run ONE probe
    request with the trace ring and metrics plane compiled in
    (`keep_carries=True` keeps the raw per-chunk carries on the
    finished record), rebuild its device Perfetto lanes, and merge
    them with every span log under `timeline_dir` into one
    ``timeline.json`` — host queue->compile->launch->chunks->settle
    over wall time next to the engine's simulated-time lanes."""
    import glob
    import os

    from ..obs.decode import TraceFrame
    from ..obs.export import (MetricsFrame, spans_to_perfetto, to_perfetto,
                              trace_to_perfetto)
    from ..obs.spans import read_spans
    from ..obs.spec import MetricsSpec
    from ..obs.trace import TraceSpec

    spec = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                        seeds=(7,), sim_ms=120, chunk_ms=40,
                        obs=("metrics", "trace"), tenant="batch")
    rid = sch.submit(spec, keep_carries=True, label="timeline-probe")
    deadline = time.time() + 120.0
    while time.time() < deadline:
        sch.run_pending()
        req = sch.peek(rid)
        if req is not None and req.status in ("done", "error"):
            break
        time.sleep(0.02)
    device = []
    req = sch.peek(rid)
    if req is not None and req.status == "done" and req.final_carries:
        carries = req.final_carries
        if "metrics" in carries:
            mf = MetricsFrame.from_carries(
                MetricsSpec(stat_each_ms=spec.stat_each_ms),
                carries["metrics"])
            device.append(to_perfetto(mf))
        if "trace" in carries:
            tf = TraceFrame.from_carries(
                TraceSpec(capacity=spec.trace_capacity),
                carries["trace"])
            device.append(trace_to_perfetto(tf))
    rows = []
    files = sorted(glob.glob(os.path.join(timeline_dir, "**",
                                          "spans*.jsonl"),
                             recursive=True))
    for f in files:
        rows.extend(read_spans(f))
    out = os.path.join(timeline_dir, "timeline.json")
    trace = spans_to_perfetto(rows, device=device, path=out)
    return {"path": out, "span_logs": len(files), "spans": len(rows),
            "device_lanes": len(device), "probe_rid": rid,
            "events": len(trace["traceEvents"])}


def fleet_load_once(workers: int, per: int, *, base_dir,
                    lease_ttl_s: float = 10.0,
                    ready_timeout_s: float = 300.0,
                    timeline=None, device=None) -> dict:
    """One fleet measurement: spawn `workers` worker processes over a
    fresh fleet directory, wait until every worker has published a
    stats snapshot (measuring steady-state submit->result throughput,
    not worker cold-start), then run the SAME three-tenant client mix
    through a `FleetService` front tier and report per-worker-count
    latency/throughput/builds."""
    import glob
    import os

    from ..serve import FleetService
    from ..serve.fleet import (aggregate_worker_stats, fleet_paths,
                               spawn_worker)

    d = os.path.join(base_dir, f"fleet-{workers}w")
    svc = FleetService(d, tenants=fleet_tenants())
    tdir = None
    if timeline is not None:
        # one span-log dir per worker count: the same worker ids recur
        # across the sweep, and two counts appending into one file
        # would interleave unrelated runs on one timeline
        tdir = os.path.join(timeline, f"{workers}w")
        os.makedirs(tdir, exist_ok=True)
    procs = [spawn_worker(d, f"w{i}", lease_ttl_s=lease_ttl_s,
                          idle_exit_s=4.0, max_wall_s=900.0,
                          timeline=tdir, device=device)
             for i in range(workers)]
    stats_glob = os.path.join(fleet_paths(d)["stats_dir"],
                              "worker-*.json")
    t_ready = time.time()
    while len(glob.glob(stats_glob)) < workers:
        if time.time() - t_ready > ready_timeout_s:
            for p in procs:
                p.terminate()
            raise RuntimeError(
                f"fleet-load: only {len(glob.glob(stats_glob))}/"
                f"{workers} workers became ready in "
                f"{ready_timeout_s:.0f}s; see worker logs in {d}")
        if all(p.poll() is not None for p in procs):
            raise RuntimeError(
                f"fleet-load: every worker exited before becoming "
                f"ready; see worker logs in {d}")
        time.sleep(0.1)
    recs = {name: {"submitted": per, "done": 0, "errors": 0,
                   "rejected": 0, "gave_up": 0, "lat_ms": []}
            for name in ("interactive", "campaign", "batch")}
    t0 = time.perf_counter()
    threads = [threading.Thread(
        target=drive_tenant, args=(svc, tenant_specs(n, per), recs[n]),
        kwargs={"poll_s": 0.1}, name=f"fleet-load-{n}")
        for n in recs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    # let the workers idle-exit so their FINAL stats snapshots (the
    # build counters) are on disk before aggregating
    deadline = time.time() + 60.0
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if p.poll() is None:
            p.terminate()
    agg = aggregate_worker_stats(d)
    all_lat = sorted(x for r in recs.values() for x in r["lat_ms"])
    done_total = sum(r["done"] for r in recs.values())
    builds = agg["registry"].get("misses", 0)
    return {
        "workers": workers,
        "completed": done_total,
        "submitted": 3 * per,
        "errors": sum(r["errors"] + r["gave_up"] for r in recs.values()),
        "rejections_429": sum(r["rejected"] for r in recs.values()),
        "wall_s": round(wall, 2),
        "throughput_rps": round(done_total / max(wall, 1e-9), 3),
        "p50_ms": pct(all_lat, 0.50),
        "p99_ms": pct(all_lat, 0.99),
        "program_builds": builds,
        "requests_per_build": round(done_total / max(1, builds), 1),
        "repacked": agg["resilience"].get("repacked", 0),
        "worker_deduped": agg["counters"].get("deduped", 0),
        "per_tenant": {n: {"completed": r["done"],
                           "rejected_429": r["rejected"],
                           "p50_ms": pct(sorted(r["lat_ms"]), 0.50),
                           "p99_ms": pct(sorted(r["lat_ms"]), 0.99)}
                       for n, r in recs.items()},
        "per_worker": {w: {k: blk.get(k) for k in
                           ("claimed", "processed", "deduped")}
                       | {"builds": (blk.get("registry") or {}
                                     ).get("misses")}
                       for w, blk in agg["workers"].items()},
    }


def fleet_load(worker_counts, requests: int, *, base_dir=None,
               timeline=None, device=None) -> dict:
    """The --workers sweep: the same request mix at each worker count
    (fresh fleet directory each — no cross-run dedup), with the
    scaling ratios (submit->result throughput at N
    workers vs 1) computed when 1 is in the sweep."""
    import tempfile

    base = base_dir or tempfile.mkdtemp(prefix="wtpu-serve-fleet-")
    per = max(1, requests // 3)
    by = {}
    for w in worker_counts:
        print(f"fleet-load: measuring {w} worker(s)...", flush=True,
              file=sys.stderr)
        by[str(w)] = fleet_load_once(w, per, base_dir=base,
                                     timeline=timeline, device=device)
    block = {"schema": 1, "requests": 3 * per, "by_workers": by,
             "dir": base}
    if "1" in by:
        base_rps = by["1"]["throughput_rps"]
        block["speedup_vs_1"] = {
            w: round(b["throughput_rps"] / max(base_rps, 1e-9), 2)
            for w, b in by.items() if w != "1"}
        block["requests_per_build_vs_1"] = {
            w: round(b["requests_per_build"]
                     / max(by["1"]["requests_per_build"], 1e-9), 2)
            for w, b in by.items() if w != "1"}
    return block


def pct(sorted_vals, q):
    """Upper nearest-rank percentile (ceil, not floor: a floored p99
    over ~100 samples would read ~p98 and hide the one true tail
    outlier — the number this tool exists to report)."""
    import math
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1,
            math.ceil(q * (len(sorted_vals) - 1)))
    return round(sorted_vals[i], 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.serve_load",
        description="multi-tenant serve load generator (tenancy bench)")
    ap.add_argument("--requests", type=int, default=120,
                    help="total requests across the 3 tenants "
                         "(default 120)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON line here")
    ap.add_argument("--stream", action="store_true",
                    help="add the long-poll partial-metrics smoke "
                         "check (one spec streamed chunk by chunk)")
    ap.add_argument("--workers", default=None, metavar="N[,M...]",
                    help="fleet scaling sweep (serve/fleet.py): run "
                         "the same request mix through a FleetService "
                         "front tier at each worker-process count "
                         "(e.g. '1,2,4') and report per-count p50/p99, "
                         "aggregate submit->result throughput and "
                         "requests-per-build; a fresh fleet directory "
                         "per count keeps the runs independent")
    ap.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="base directory for the --workers sweep "
                         "(default: a temp dir)")
    ap.add_argument("--kill-after", type=float, default=None,
                    metavar="S",
                    help="hard-stop the client threads after S "
                         "seconds and report the /w/batch/health "
                         "snapshot taken at the kill (the crash-"
                         "safety observability exercise; completion "
                         "checks are skipped — a killed run cannot "
                         "promise completion)")
    ap.add_argument("--timeline", default=None, metavar="DIR",
                    help="turn the host-plane flight recorder ON: "
                         "span JSONL per process under DIR, plus one "
                         "merged Perfetto timeline.json (host "
                         "lifecycle spans + one probe request's "
                         "device metrics/trace lanes; with --workers, "
                         "a span log per worker process per count)")
    ap.add_argument("--device", default=None,
                    help="the device the scheduler (or the fleet's "
                         "workers) run on (default cuda)")
    args = ap.parse_args(argv)
    from ..core.state import resolve_device
    from ..server.core import load_models
    load_models()
    dev = resolve_device(args.device)

    if args.workers is not None:
        try:
            counts = [int(x) for x in args.workers.split(",") if x]
            if not counts or any(c < 1 for c in counts):
                raise ValueError(args.workers)
        except ValueError:
            print(f"config error: --workers wants a comma list of "
                  f"positive ints, got {args.workers!r}",
                  file=sys.stderr)
            return 2
        if args.timeline is not None:
            import os
            os.makedirs(args.timeline, exist_ok=True)
        block = fleet_load(counts, args.requests,
                           base_dir=args.fleet_dir,
                           timeline=args.timeline, device=str(dev))
        if args.timeline is not None:
            # render the workers' span logs (all counts) onto one
            # merged Perfetto timeline; the per-count subdirs keep
            # distinct pids per worker per count
            import glob
            import os

            from ..obs.export import spans_to_perfetto
            from ..obs.spans import read_spans
            rows = []
            for f in sorted(glob.glob(os.path.join(
                    args.timeline, "**", "spans*.jsonl"),
                    recursive=True)):
                rows.extend(read_spans(f))
            tpath = os.path.join(args.timeline, "timeline.json")
            spans_to_perfetto(rows, path=tpath)
            block["timeline"] = {"path": tpath, "spans": len(rows)}
        worst_p99 = max((b["p99_ms"] or 0)
                        for b in block["by_workers"].values())
        line = json.dumps({"metric": "serve_fleet_p99_ms",
                           "value": worst_p99, "unit": "ms",
                           "fleet": block,
                           "platform": dev.type})
        print(line)
        if args.out:
            pathlib.Path(args.out).write_text(line + "\n")
        bad = {w: b for w, b in block["by_workers"].items()
               if b["errors"] or b["completed"] < b["submitted"]}
        if bad:
            print(f"fleet-load: incomplete counts {sorted(bad)}",
                  file=sys.stderr)
            return 1
        return 0

    per = max(1, args.requests // 3)
    ins = None
    if args.timeline is not None:
        import os

        from ..serve.instrument import Instrumentation
        os.makedirs(args.timeline, exist_ok=True)
        ins = Instrumentation(
            span_path=os.path.join(args.timeline, "spans-serve.jsonl"),
            worker="serve")
    sch = Scheduler(
        tenants=fleet_tenants(),
        quantum_chunks=2,
        instrument=ins, device=dev)
    svc = Service(scheduler=sch, auto=True)
    recs = {name: {"submitted": per, "done": 0, "errors": 0,
                   "rejected": 0, "gave_up": 0, "lat_ms": []}
            for name in ("interactive", "campaign", "batch")}
    t0 = time.perf_counter()
    stop = threading.Event() if args.kill_after is not None else None
    threads = [threading.Thread(target=drive_tenant,
                                args=(svc, tenant_specs(n, per), recs[n]),
                                kwargs={"stop": stop},
                                name=f"load-{n}")
               for n in recs]
    for t in threads:
        t.start()
    health_at_kill = None
    if stop is not None:
        # the --kill-after exercise: snapshot /w/batch/health UNDER
        # load at the kill instant, then hard-stop the clients — the
        # health block is what an operator's probe would have seen
        # just before the process died
        time.sleep(max(0.0, args.kill_after))
        health_at_kill = svc.health()
        stop.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stream_block = stream_smoke(svc) if args.stream else None
    timeline_block = (timeline_probe(sch, args.timeline)
                      if args.timeline is not None else None)
    svc.close()

    ten = svc.tenancy_stats()
    reg = svc.registry_stats()
    all_lat = sorted(x for r in recs.values() for x in r["lat_ms"])
    done_total = sum(r["done"] for r in recs.values())
    starved = [n for n, r in recs.items() if r["done"] < r["submitted"]
               and not r["errors"] and not r["gave_up"]]
    tenancy = {
        "schema": 1,
        "requests": 3 * per,
        "completed": done_total,
        "rejections_429": sum(r["rejected"] for r in recs.values()),
        "preemptions": ten["preemptions"],
        "p50_ms": pct(all_lat, 0.50),
        "p99_ms": pct(all_lat, 0.99),
        "program_builds": reg["misses"],
        "requests_per_build": round(done_total / max(1, reg["misses"]),
                                    1),
        "chunk_wall_ema_s": ten["chunk_wall_ema_s"],
        "per_tenant": {
            n: {"submitted": r["submitted"], "completed": r["done"],
                "rejected_429": r["rejected"], "errors": r["errors"],
                "gave_up": r["gave_up"],
                "p50_ms": pct(sorted(r["lat_ms"]), 0.50),
                "p99_ms": pct(sorted(r["lat_ms"]), 0.99),
                "weight": ten["tenants"].get(n, {}).get("weight")}
            for n, r in recs.items()},
    }
    out = {
        "metric": "serve_load_p99_ms",
        "value": tenancy["p99_ms"],
        "unit": "ms",
        "wall_total_s": round(wall, 2),
        "tenancy": tenancy,
        "registry": reg,
        "health": svc.health(),
        "platform": dev.type,
    }
    if health_at_kill is not None:
        out["killed_after_s"] = args.kill_after
        out["health_at_kill"] = health_at_kill
    if stream_block is not None:
        out["stream"] = stream_block
    if timeline_block is not None:
        out["timeline"] = timeline_block
    line = json.dumps(out)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    if stream_block is not None and not stream_block["ok"]:
        print(f"STREAM smoke failed: {stream_block}", file=sys.stderr)
        return 1
    if health_at_kill is not None:
        # a killed run cannot promise completion: the health snapshot
        # IS the product; starvation/error gates apply only to full
        # runs
        return 0
    if starved:
        print(f"STARVATION: tenant(s) {starved} did not complete their "
              "requests", file=sys.stderr)
        return 1
    errs = sum(r["errors"] + r["gave_up"] for r in recs.values())
    if errs:
        print(f"{errs} request(s) errored or gave up", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
