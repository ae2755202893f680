"""The benchmark suite's smoke stages, one JSON line each; the port of
`tools/bench_suite.py`.

Stages (the JAX stages' own specs):
  * serve_smoke   — 2 coalesced requests through an in-process
                    `serve.Service`: artifacts and per-request ledger
                    rows asserted;
  * spans_smoke   — one instrumented request with the host flight
                    recorder on: the lifecycle span set complete and
                    ordered, ``/w/batch/metrics`` round-tripped over
                    real HTTP with monotone counters across scrapes;
  * chaos_smoke   — PingPong under a churn + partition + loss schedule:
                    K=1 against K=2 bit-identity, a clean audit, the
                    ``node_down``/``node_up`` trace kinds, a real impact
                    and one ledger row round-tripped;
  * memo_smoke    — a chaos-axis grid run twice (plain and with
                    `run_grid(memo=True)`): the saved prefix chunks
                    equal the fork plan's prediction and every state
                    and the reports are bit-identical;
  * catalog_smoke — one request through a catalog-attached scheduler:
                    the first launch round-trips one durable catalog
                    row, the registry and working-set gauges land on a
                    real-HTTP scrape, ``/w/batch/programs`` serves the
                    report;
  * analysis_smoke — the analysis plane's ``--source`` pass (the
                    determinism, host-plane and shared-memory rules
                    against the checked-in budgets) as a subprocess,
                    the invocation CI uses; its wall under 60 s.

The suite's four throughput lines (``pingpong_1000n``, ``gsf_4096n``,
``sanfermin_32768n``, ``dfinity_10k_validators``) are `bench_torch.py`'s
(`bench_torch.py --history PATH` appends their history rows); the
other JAX stages (trace, audit, matrix, tenancy, crash, fleet and
search smoke) are not ported yet (ROADMAP.md A14d).

A stage that fails emits an ``"error"`` line instead of killing the
suite (the root tool's convention: the exit code stays 0; the gate and
the caller read the lines).  Every emitted line appends a provenance
row to the run ledger (``WTPU_LEDGER=0`` skips) and a row to the
bench-history ledger (``--history``, default
``reports/bench_history.jsonl``; ``--no-history`` or ``WTPU_HISTORY=0``
skips), keyed on (stage, config digest, backend, host fingerprint);
``--check-regressions`` gates the round against same-host baselines
with the median/MAD detector (`obs/regress.py`) and exits 1 on a
regression, 2 on a configuration error.

Usage: python -m wittgenstein_tpu_torch.cli.bench_suite [config ...]
       [--history PATH] [--no-history] [--check-regressions]
       [--device cuda|cpu]
Output: one JSON line per stage on stdout.
"""

from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent.parent


def bench_serve_smoke(dev):
    """Request-plane smoke stage: an in-process `serve.Service`, 2
    coalesced requests (one compile key, different seeds) through submit
    -> drain -> result, artifacts and per-request ledger rows asserted
    against an isolated temp ledger."""
    import dataclasses
    import os
    import tempfile

    from ..obs import ledger
    from ..serve import ScenarioSpec, Scheduler, Service

    spec = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                        seeds=(0,), sim_ms=120, chunk_ms=120,
                        obs=("metrics", "audit"))
    fd, tmp = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        svc = Service(scheduler=Scheduler(ledger_path=tmp, device=dev),
                      auto=False)
        a = svc.submit(spec.to_json())
        b = svc.submit(dataclasses.replace(spec, seeds=(1,)).to_json())
        assert a["compile_key"] == b["compile_key"], "must coalesce"
        svc.run_pending()
        ra, rb = svc.result(a["id"]), svc.result(b["id"])
        assert ra["status"] == "done" and rb["status"] == "done"
        assert ra["audit"]["clean"] and rb["audit"]["clean"]
        assert ra["engine_metrics"]["totals"]["msg_sent"] > 0
        assert ra["summary"]["done_count"] > 0
        json.dumps(ra), json.dumps(rb)      # one-line-JSON embeddable
        rows = ledger.read_all(tmp)
        assert len(rows) == 2, rows
        assert all(r.audit_clean for r in rows)
        assert rows[0].config_digest == spec.digest()
        reg = svc.registry_stats()
        assert reg["misses"] >= 1
        return {"metric": "serve_smoke_requests", "value": 2,
                "unit": "requests", "registry": reg,
                "audit_clean": True, "ledger_rows": len(rows),
                "platform": dev.type}
    finally:
        os.unlink(tmp)


#: the chaos_smoke stage's schedule (the JAX stage's; transitions all
#: even: the K=2 cross-variant pin needs window-aligned times)
CHAOS_SMOKE_SCHEDULE = {
    "churn": [[3, 20, 60], [5, 40, 100]],
    "partitions": [[30, 90, 1, 0, 32]],
    "loss": [[0, 120, 250, 0, 64, 0, 64]],
}


def bench_chaos_smoke(dev):
    """Chaos-plane smoke stage: PingPong under a churn + mid-run
    partition + message-loss schedule — K=1 against K=2 bit-identity, a
    clean audit over the faulted trajectory, the ``node_down`` /
    ``node_up`` trace kinds, a real impact against the fault-free run,
    and one `RunManifest` ledger row round-tripped (isolated file)."""
    import dataclasses
    import os
    import tempfile

    from ..chaos import ChaosProtocol, FaultSchedule
    from ..models.pingpong import PingPong
    from ..obs import ledger
    from ..obs.audit import AuditSpec
    from ..obs.audit_report import audit_block, audit_variant
    from ..obs.decode import TraceFrame
    from ..obs.diff import first_divergence
    from ..obs.trace import TraceSpec, scan_chunk_trace

    proto = PingPong(node_count=64, device=dev)
    sched = FaultSchedule.from_json(CHAOS_SMOKE_SCHEDULE).validate(
        n=64, sim_ms=120)
    cp = ChaosProtocol(proto, sched)

    # cross-variant bit-identity under faults (the chaos contract)
    div = first_divergence(cp, {"superstep": 1}, {"superstep": 2}, 120)
    assert div is None, f"chaos cross-variant divergence:\n{div.format()}"

    # clean audit verdict over the FAULTED trajectory + impact
    report, (nets, _) = audit_variant(cp, 120, {"superstep": 1},
                                      AuditSpec())
    assert report.clean, report.format()
    blk = audit_block(report)
    _, (nets0, _) = audit_variant(proto, 120, {"superstep": 1},
                                  AuditSpec())
    lost = (int(nets0.nodes.msg_received.sum()) -
            int(nets.nodes.msg_received.sum()))
    assert lost > 0, "the schedule had no observable impact"

    # churn drives the node_down/node_up trace kinds at their exact ms
    tspec = TraceSpec(capacity=4096)
    _, _, tc = scan_chunk_trace(cp, 120, tspec)(*cp.init(0))
    counts = TraceFrame.from_carry(tspec, tc).counts()
    assert counts.get("node_down") == 2 and counts.get("node_up") == 2, \
        counts

    res = {"metric": "chaos_smoke_lost_msgs", "value": lost,
           "unit": "messages", "sim_ms": 120, "superstep": 1,
           "audit": blk, "schedule": sched.counts(),
           "trace_counts": {k: counts[k]
                            for k in ("node_down", "node_up")},
           "platform": dev.type}
    spec = _stage_spec("chaos_smoke")
    fd, tmp = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        mani = ledger.manifest_from_spec(res, spec, label="chaos_smoke")
        assert ledger.append(mani, tmp) == tmp, "ledger append failed"
        rows = ledger.read_all(tmp)
        assert len(rows) == 1 and rows[0].audit_clean, rows
        assert rows[0].config_digest == spec.digest()
        assert dataclasses.asdict(rows[0]) == dataclasses.asdict(mani), \
            "ledger round-trip mismatch"
    finally:
        os.unlink(tmp)
    res["ledger_round_trip"] = "ok"
    json.dumps(res)                         # one-line-JSON embeddable
    return res


#: the memo_smoke stage's grid (the JAX stage's): a chaos-axis sweep
#: whose clean/loss cells share a 3-chunk honest prefix per seed -> 2
#: fork groups, predicted prefix_chunks_saved = 2 x 1 x 3 = 6
MEMO_SMOKE_GRID = {
    "name": "memo_smoke",
    "base": {"protocol": "PingPong", "params": {"node_count": 64},
             "latency_model": "NetworkFixedLatency(10)",
             "seeds": [0], "sim_ms": 240, "chunk_ms": 40,
             "obs": ["metrics", "audit"]},
    "axes": [
        {"name": "seed", "field": "seeds", "values": [[0], [1]]},
        {"name": "chaos", "field": "fault_schedule",
         "values": [None, {"loss": [[120, 240, 400, 0, 64, 0, 64]]}],
         "labels": ["clean", "loss"]},
    ],
}

#: report keys that honestly differ between a memoized and an
#: unmemoized run of the SAME grid (wall clock, builds, scheduler
#: counters, the memo/fork provenance itself)
MEMO_VOLATILE_KEYS = ("wall_s", "program_builds", "registry",
                      "resilience", "resume", "memo")


def _memo_norm_report(rep: dict) -> dict:
    import copy
    d = copy.deepcopy(rep)
    for k in MEMO_VOLATILE_KEYS:
        d.pop(k, None)
    for row in d["cells"]:
        row.pop("forked_from", None)
    return d


def bench_memo_smoke(dev):
    """Memoized-supersteps smoke stage: a chaos-axis grid whose cells
    share an honest prefix runs plain and with `run_grid(memo=True)`;
    `prefix_chunks_saved` equals the fork plan's prediction, every
    forked cell's final state equals the unmemoized run's, the two
    `MatrixReport`s are equal outside MEMO_VOLATILE_KEYS, and forked
    ledger rows carry `forked_from`."""
    import os
    import tempfile

    import torch
    from torch.utils import _pytree as pytree

    from ..matrix import SweepGrid, plan, run_grid
    from ..memo import plan_prefixes
    from ..obs import ledger
    from ..serve import Scheduler

    grid = SweepGrid.from_json(MEMO_SMOKE_GRID)
    mplan = plan(grid)
    predicted = plan_prefixes(mplan).predicted_chunks_saved
    assert predicted == 6, predicted
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_grid(grid, Scheduler(
            ledger_path=os.path.join(tmp, "ref.jsonl"), device=dev),
            plan_=mplan)
        mem = run_grid(grid, Scheduler(
            ledger_path=os.path.join(tmp, "memo.jsonl"), device=dev),
            plan_=mplan, memo=True)
        blk = mem.report.data["memo"]
        assert blk["prefix_chunks_saved"] == predicted > 0, blk
        assert blk["forked_cells"] == 4 and blk["fork_vetoed"] == 0, blk
        assert _memo_norm_report(mem.report.to_json()) == \
            _memo_norm_report(ref.report.to_json()), \
            "memoized report differs from the unmemoized run"
        for cid, st in mem.states.items():
            for a, b in zip(pytree.tree_leaves(st),
                            pytree.tree_leaves(ref.states[cid])):
                assert torch.equal(a, b), cid
        rows = ledger.read_all(os.path.join(tmp, "memo.jsonl"))
        forked = [r for r in rows
                  if (r.extra or {}).get("forked_from")]
        assert len(forked) == 4, [r.run for r in rows]
        assert all(r.extra["forked_from"]["fork_ms"] == 120
                   for r in forked)
    return {"metric": "memo_smoke_prefix_chunks_saved",
            "value": blk["prefix_chunks_saved"], "unit": "chunks",
            "memo": blk, "grid_digest": grid.grid_digest(),
            "cells": len(mplan.cells), "platform": dev.type}


def _serve_http(sch, dev):
    """A manual-drain HTTP server over `sch` on a free loopback port,
    serving on a daemon thread: ``(httpd, base_url)``."""
    import threading

    from ..server.http import make_server
    httpd = make_server(port=0, batch_auto=False, scheduler=sch,
                        device=dev)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def bench_spans_smoke(dev):
    """Host-plane observability smoke stage: one instrumented request
    with the flight recorder on — the lifecycle span set present and
    ordered, and ``/w/batch/metrics`` round-tripped over real HTTP, two
    scrapes bracketing the run with every counter and histogram series
    monotone across them."""
    import time
    import urllib.request

    from ..obs.metrics import parse_exposition
    from ..serve import ScenarioSpec, Scheduler
    from ..serve.instrument import LIFECYCLE, Instrumentation

    ins = Instrumentation(worker="smoke")
    sch = Scheduler(quantum_chunks=2, instrument=ins, device=dev)
    spec = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                        seeds=(0,), sim_ms=120, chunk_ms=40,
                        obs=("metrics",))
    httpd, base = _serve_http(sch, dev)

    def scrape():
        with urllib.request.urlopen(f"{base}/w/batch/metrics",
                                    timeout=10) as resp:
            ctype = resp.headers.get("Content-Type", "")
            assert ctype.startswith("text/plain"), ctype
            return parse_exposition(resp.read().decode())

    t0 = time.perf_counter()
    try:
        m0 = scrape()
        rid = sch.submit(spec)
        sch.run_pending()
        req = sch.request(rid)
        assert req.status == "done", req.error
        m1 = scrape()
    finally:
        httpd.shutdown()
        httpd.server_close()
    wall = time.perf_counter() - t0
    rows = ins.spans.snapshot()
    first = {}
    for r in rows:
        first.setdefault(r["name"], r["t0"])
    missing = [n for n in LIFECYCLE if n not in first]
    assert not missing, f"lifecycle spans missing: {missing}"
    order = [first[n] for n in LIFECYCLE]
    assert order == sorted(order), \
        f"lifecycle spans out of order: {list(zip(LIFECYCLE, order))}"
    assert any(r["name"] == "serve.settle" and r.get("rid") == rid
               for r in rows), "settle span lost its request id"
    # every counter sample and histogram series must be >= across the
    # run; gauges may move either way
    mono = [k for k in m0 if k.endswith("_total")
            or "_bucket{" in k or k.endswith("_sum")
            or k.endswith("_count")]
    regressed = {k: (m0[k], m1.get(k)) for k in mono
                 if m1.get(k, 0) < m0[k]}
    assert not regressed, f"metrics regressed across scrapes: {regressed}"
    assert m1["wtpu_serve_submits_total"] \
        == m0["wtpu_serve_submits_total"] + 1, (m0, m1)
    phases = sch.health_stats().get("phases", {})
    assert "serve.queue_wait" in phases, phases
    return {"metric": "spans_smoke_spans", "value": len(rows),
            "unit": "spans", "wall_s": round(wall, 2),
            "lifecycle": list(LIFECYCLE),
            "metrics_series": len(m1),
            "phases": phases, "platform": dev.type}


def bench_catalog_smoke(dev):
    """Program-observatory smoke stage: one request through a
    catalog-attached scheduler — the first launch round-trips one
    durable catalog row (compile key, backend, first-launch wall, the
    memory block, each kernel's launches), the registry and
    working-set gauges land on a real-HTTP ``/w/batch/metrics`` scrape,
    and ``/w/batch/programs`` serves the report.  On the card the row
    carries ``temp_bytes`` and the scrape ``wtpu_program_temp_ratio``;
    on the CPU the row has no ``temp_bytes`` (the memory block's soft
    degradation) and the stage asserts the fields the CPU has."""
    import os
    import tempfile
    import time
    import urllib.request

    from ..obs.metrics import parse_exposition
    from ..obs.programs import ProgramCatalog, read_catalog
    from ..serve import ScenarioSpec, Scheduler
    from ..serve.instrument import Instrumentation

    spec = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                        seeds=(0,), sim_ms=120, chunk_ms=40,
                        obs=("metrics",))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "programs.jsonl")
        ins = Instrumentation(worker="catalog_smoke")
        sch = Scheduler(instrument=ins, catalog=ProgramCatalog(path=path),
                        device=dev)
        httpd, base = _serve_http(sch, dev)
        t0 = time.perf_counter()
        try:
            rid = sch.submit(spec)
            sch.run_pending()
            req = sch.request(rid)
            assert req.status == "done", req.error
            with urllib.request.urlopen(f"{base}/w/batch/metrics",
                                        timeout=10) as resp:
                m = parse_exposition(resp.read().decode())
            with urllib.request.urlopen(f"{base}/w/batch/programs",
                                        timeout=10) as resp:
                rep = json.loads(resp.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
        wall = time.perf_counter() - t0
        # the cold build left exactly one durable, fully-populated row
        rows = read_catalog(path)
    assert len(rows) == 1, [r.get("key") for r in rows]
    row = rows[0]
    for field in ("key", "plane", "backend", "compile_wall_s",
                  "lower_wall_s", "memory", "cost", "build_wall_s",
                  "arg_leaves", "batch"):
        assert field in row, (field, sorted(row))
    assert row["compile_wall_s"] > 0 and row["build_wall_s"] > 0, row
    assert row["backend"] == dev.type, row
    mem = row["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0, mem
    launches = row["cost"]["launches"]
    assert set(launches) == {"route", "merge", "score", "gsf_merge",
                             "gsf_score"}, launches
    # registry gauges and the program table on the real-HTTP scrape
    assert m.get("wtpu_programs_cataloged") == 1, m
    assert m.get("wtpu_registry_misses", 0) >= 1, m
    assert any(k.startswith("wtpu_program_argument_bytes{") for k in m), \
        sorted(k for k in m if k.startswith("wtpu_"))
    # the /w/batch/programs report names the program in its top table
    assert rep["count"] == 1 and rep["top_compile"], rep
    assert rep["top_compile"][0]["key"] == row["key"], rep["top_compile"]
    ratio_series = [k for k in m if k.startswith("wtpu_program_temp_ratio{")]
    if dev.type == "cuda":
        # the card measures the first launch's working set; PingPong's
        # 120 ms in 40-ms chunks at K=1 bins once a ms
        assert mem["temp_bytes"] > 0, mem
        assert launches["route"] == 40, launches
        assert ratio_series, sorted(k for k in m if k.startswith("wtpu_"))
        assert rep["drift"][0]["temp_ratio"] > 0, rep["drift"]
    else:
        assert "temp_bytes" not in mem and not ratio_series, (mem, m)
    return {"metric": "catalog_smoke_programs", "value": len(rows),
            "unit": "programs", "wall_s": round(wall, 2),
            "compile_wall_s": round(row["compile_wall_s"], 3),
            "ratio_series": len(ratio_series),
            "temp_ratio": rep["drift"][0].get("temp_ratio"),
            "launches": launches, "platform": dev.type}


def bench_analysis_smoke(dev):
    """Analysis smoke stage: the whole ``--source`` pass as a
    subprocess, the same invocation CI uses, so a budget regression or a
    rule crash fails this stage.  The metric is the scan's wall (under
    the 60-s smoke bound).  The source rules run no chunk: `dev` is
    unused and the line's platform is the CPU, as the JAX stage's is."""
    import os
    import subprocess
    import tempfile
    import time

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "wittgenstein_tpu_torch.analysis",
             "--source", "--json", out],
            cwd=str(REPO), capture_output=True, text=True, timeout=300)
        wall = time.monotonic() - t0
        assert proc.returncode == 0, \
            f"--source analysis failed:\n{proc.stdout}{proc.stderr}"
        with open(out) as fh:
            payload = json.load(fh)
    assert payload["ok"], payload
    assert wall < 60.0, f"source scan took {wall:.1f}s (budget 60s)"
    return {"metric": "analysis_smoke_wall_s",
            "value": round(wall, 2), "unit": "s",
            "schema": payload["schema"], "rules": payload["rules"],
            "n_findings": len(payload["findings"]),
            "platform": "cpu"}


CONFIGS = {
    "serve_smoke": bench_serve_smoke,
    "chaos_smoke": bench_chaos_smoke,
    "memo_smoke": bench_memo_smoke,
    "spans_smoke": bench_spans_smoke,
    "catalog_smoke": bench_catalog_smoke,
    "analysis_smoke": bench_analysis_smoke,
}

# The error path must emit the SAME metric name as the success path, or
# a consumer keying on it never sees the failure line.
METRIC_NAMES = {"serve_smoke": "serve_smoke_requests",
                "chaos_smoke": "chaos_smoke_lost_msgs",
                "memo_smoke": "memo_smoke_prefix_chunks_saved",
                "spans_smoke": "spans_smoke_spans",
                "catalog_smoke": "catalog_smoke_programs",
                "analysis_smoke": "analysis_smoke_wall_s"}


def _stage_spec(name):
    """Each stage's static config as a `ScenarioSpec` (the JAX suite's
    table for these stages, so the two packages' history rows share
    config digests); None for a stage the table does not list
    (spans_smoke and analysis_smoke, as in the JAX suite)."""
    from ..serve.spec import ScenarioSpec
    table = {
        "serve_smoke": dict(
            protocol="PingPong", params={"node_count": 64}, seeds=(0,),
            sim_ms=120, chunk_ms=120, obs=("metrics", "audit"),
            superstep=1),
        "chaos_smoke": dict(
            protocol="PingPong", params={"node_count": 64}, seeds=(0,),
            sim_ms=120, chunk_ms=120, obs=("audit",), superstep=1,
            fault_schedule=CHAOS_SMOKE_SCHEDULE),
        # the stage runs a whole grid twice; the digested config is the
        # grid's base cell
        "memo_smoke": dict(
            protocol="PingPong", params={"node_count": 64},
            latency_model="NetworkFixedLatency(10)", seeds=(0,),
            sim_ms=240, chunk_ms=40, obs=("metrics", "audit"),
            superstep=1),
        "catalog_smoke": dict(
            protocol="PingPong", params={"node_count": 64}, seeds=(0,),
            sim_ms=120, chunk_ms=40, obs=("metrics",), superstep=1),
    }
    cfg = table.get(name)
    return None if cfg is None else ScenarioSpec(**cfg)


def _append_ledger(name, res):
    """One provenance row per emitted line; the config digest is the
    stage's `ScenarioSpec` digest (`obs.ledger.append_from_spec`),
    unlisted stages fall back to the env capture.  ``WTPU_LEDGER=0``
    skips.  Never raises into the suite loop."""
    import os
    if os.environ.get("WTPU_LEDGER", "1") == "0":
        return
    from ..obs import ledger
    spec = _stage_spec(name)
    if spec is not None:
        ledger.append_from_spec(res, spec, label=name, stage=name,
                                engine=res.get("engine", "vmapped"))
    else:
        ledger.append_from_env(res, label=name, stage=name,
                               engine="vmapped")


def _append_history(history, name, res, round_id):
    """One history row per emitted line (the regression gate's input);
    error lines append with empty measures."""
    from ..obs import regress
    spec = _stage_spec(name)
    history.append(
        stage=name, measures=regress.stage_measures(res),
        round_id=round_id,
        config_digest=spec.digest() if spec is not None else None,
        backend=res.get("platform"), metric=res.get("metric"))


def main(argv=None) -> int:
    import argparse
    import os
    import time

    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.bench_suite",
        description="the benchmark suite's smoke stages (one JSON line "
        "per stage); appends a bench-history row per stage and can gate "
        "the round against same-host baselines")
    ap.add_argument("stages", nargs="*", metavar="config",
                    help=f"stages to run (default: all; known: "
                    f"{', '.join(CONFIGS)})")
    ap.add_argument("--history",
                    default=str(REPO / "reports" / "bench_history.jsonl"),
                    help="bench-history ledger path (default: "
                    "reports/bench_history.jsonl)")
    ap.add_argument("--no-history", action="store_true",
                    help="skip history appends (WTPU_HISTORY=0 does "
                    "the same)")
    ap.add_argument("--check-regressions", action="store_true",
                    help="after the round, run the median/MAD gate "
                    "(obs/regress.py) over the history and exit 1 on "
                    "a regression")
    ap.add_argument("--device", default=None,
                    help="the device the stages run on (default cuda)")
    args = ap.parse_args(argv)

    from ..core.state import resolve_device
    from ..server.core import load_models
    load_models()
    dev = resolve_device(args.device)
    names = args.stages or list(CONFIGS)
    write_history = not args.no_history and \
        os.environ.get("WTPU_HISTORY", "1") != "0"
    hist = None
    round_id = str(time.time_ns())
    if write_history:
        from ..obs.regress import BenchHistory
        hist = BenchHistory(args.history)
    for name in names:
        metric = METRIC_NAMES.get(name, f"{name}_agg_sim_ms_per_sec")
        try:
            res = CONFIGS[name](dev)
        except Exception as e:                  # noqa: BLE001 — per-stage
            res = {"metric": metric,
                   "error": f"{type(e).__name__}: {e!s:.300}"}
        _append_ledger(name, res)
        if hist is not None:
            _append_history(hist, name, res, round_id)
        print(json.dumps(res), flush=True)
    if args.check_regressions:
        if hist is None:
            print("bench_suite: --check-regressions needs history "
                  "appends on", file=sys.stderr)
            return 2
        from ..obs import regress
        code, findings, summary = regress.gate(args.history,
                                               round_id=round_id)
        print(json.dumps({"metric": "regression_gate", "exit": code,
                          **summary}), flush=True)
        if findings:
            print(regress.format_findings(findings), file=sys.stderr)
        return code
    return 0


if __name__ == "__main__":
    sys.exit(main())
