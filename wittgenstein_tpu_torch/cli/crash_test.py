"""Kill-anywhere recovery harness — the crash-only serve acceptance pin;
the port of `tools/crash_test.py` (its arguments, exit codes and JSON
keys, with ``--device``, default ``cuda``, handed to every child
process and fleet worker).

The chaos plane injects faults INSIDE the simulation; this
tool injects the one fault the simulation cannot model: the serving
process itself dying.  It runs a multi-group chaos-axis matrix
campaign in a SUBPROCESS with the full crash-safety stack ON —
durable submission journal + chunk-boundary group checkpoints +
per-cell ledger rows — SIGKILLs the child at N seeded-random wall
offsets (anywhere: mid-import, queued-but-unlaunched, mid-chunk,
between groups), resumes after every kill, drives the final attempt
to completion, and asserts the resulting `MatrixReport` is
BIT-IDENTICAL to an uninterrupted run's outside the honestly
run-local keys (wall clock, measured builds, scheduler counters,
resume accounting) — the chaos plane's determinism discipline applied
to the serving process.

SIGKILL, not SIGTERM: nothing gets to flush, which is exactly the
contract under test — every durable fact must already be on disk when
the ack/boundary that promised it returned.

Usage:
    python -m wittgenstein_tpu_torch.cli.crash_test [--kills N] [--seed S]
        [--dir D] [--min-delay S] [--max-delay S] [--out P]
        [--device cuda|cpu]
    python -m wittgenstein_tpu_torch.cli.crash_test --child --dir D
        [--resume]                                            (internal)

Exit codes: 0 bit-identical recovery, 1 divergence (diff printed),
2 config/environment error.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pathlib
import random
import signal
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

#: the campaign under test (the JAX harness's grid): a chaos axis (2 compile keys — one group runs
#: under churn) x 3 seeds = 6 cells, several chunks each, driven in
#: 2-cell waves so kills land between groups, mid-group and mid-chunk
CRASH_GRID = {
    "name": "crash_test",
    "base": {"protocol": "PingPong", "params": {"node_count": 64},
             "seeds": [0], "sim_ms": 120, "chunk_ms": 40,
             "obs": ["metrics", "audit"]},
    "axes": [
        {"name": "chaos", "field": "fault_schedule",
         "values": [{"churn": [[3, 20, 60]]}, None],
         "labels": ["churn", "none"]},
        {"name": "seed", "field": "seeds", "values": [[0], [1], [2]]},
    ],
}

#: report keys that HONESTLY differ between an uninterrupted run and a
#: kill+resume run of the same grid (run-local accounting); everything
#: else is the bit-identity target
VOLATILE_KEYS = ("wall_s", "program_builds", "registry", "resilience",
                 "resume", "memo")

#: the search campaign under test (--search): the checked-in boundary
#: question's single-seed half — a 16-step loss ladder the coarse
#: bracket + bisection answers in ~6 probes, several chunks each, so
#: kills land mid-prefix, mid-probe and between bisection rounds
SEARCH_SPEC = {
    "name": "crash_search",
    "grid": {
        "name": "crash_search_grid",
        "base": {"protocol": "PingPong", "params": {"node_count": 32},
                 "seeds": [0], "sim_ms": 160, "chunk_ms": 40,
                 "obs": ["metrics", "audit"],
                 "latency_model": "NetworkFixedLatency(50)"},
        "axes": [
            {"name": "loss", "field": "fault_schedule",
             "values": [{"loss": [[40, 160, p, 0, 32, 0, 32]]}
                        for p in range(0, 160, 10)],
             "labels": ["p%03d" % p for p in range(0, 160, 10)]},
        ],
    },
    "axis": "loss",
    "predicate": {"field": "summary.done_frac", "op": ">=",
                  "value": 0.99},
    "coarse": 4,
}

#: `SearchReport` keys that HONESTLY differ between an uninterrupted
#: search and a kill+resume one: wall clock, the accounting block
#: (memo/table/resume counters are attempt-local), and the simulated-
#: chunk tally (a resumed probe only re-simulates its remainder, and a
#: ledger-served probe simulates nothing) — which drags the derived
#: savings ratio along.  Probe SEQUENCE, verdicts, brackets and
#: boundaries are the bit-identity target.
SEARCH_VOLATILE_KEYS = ("wall_s", "accounting", "chunks_simulated",
                        "probe_savings_ratio")


def normalize_report(rep: dict) -> dict:
    """A report's crash-invariant projection (VOLATILE_KEYS note)."""
    d = copy.deepcopy(rep)
    for k in VOLATILE_KEYS:
        d.pop(k, None)
    for row in d.get("cells", ()):
        row.pop("resumed_from_ms", None)
    return d


def normalize_search_report(rep: dict) -> dict:
    """A `SearchReport`'s crash-invariant projection
    (SEARCH_VOLATILE_KEYS note).  Per-cell provenance — which prefix a
    probe forked from, where a resume restarted it — is run-local the
    same way `resumed_from_ms` is for matrix rows."""
    d = copy.deepcopy(rep)
    for k in SEARCH_VOLATILE_KEYS:
        d.pop(k, None)
    for row in d.get("cells", ()):
        row.pop("resumed_from_ms", None)
        row.pop("forked_from", None)
    return d


# ------------------------------------------------------------------ child


def child_main(d: str, resume: bool, timeline=None, device=None) -> int:
    """One campaign attempt inside the kill zone: run (or resume) the
    grid with journal + checkpoints + ledger under `d`, then write the
    full report to ``d/report.json`` via `MatrixReport.save` (atomic:
    write-temp + fsync + os.replace — a kill mid-write must not leave
    a torn report for the parent to misread).  `timeline` turns the
    host flight recorder ON — one span log per ATTEMPT (pid-named:
    a SIGKILL tears only a file's tail, never its middle)."""
    from ..matrix import SweepGrid, run_grid
    from ..serve import Scheduler
    from ..server.core import load_models
    load_models()

    ins = None
    if timeline is not None:
        from ..serve.instrument import Instrumentation
        os.makedirs(timeline, exist_ok=True)
        wid = f"attempt-{os.getpid()}"
        ins = Instrumentation(
            span_path=os.path.join(timeline, f"spans-{wid}.jsonl"),
            worker=wid)
    grid = SweepGrid.from_json(CRASH_GRID)
    sch = Scheduler(ledger_path=os.path.join(d, "ledger.jsonl"),
                    checkpoint_dir=os.path.join(d, "ck"),
                    journal_dir=os.path.join(d, "journal"),
                    instrument=ins, device=device)
    run = run_grid(grid, sch, max_wave=2, keep_states=(),
                   resume=resume)
    # MatrixReport.save is the atomic (write-temp + fsync +
    # os.replace) path — a kill mid-write must not leave a torn
    # report for the parent to misread
    run.report.save(os.path.join(d, "report.json"))
    return 0 if run.report.clean else 1


def search_child_main(d: str, resume: bool, device=None) -> int:
    """One SEARCH attempt inside the kill zone (--search): run (or
    resume) `SEARCH_SPEC` with journal + checkpoints + ledger + a
    cross-run memo table under `d`, then atomically write the
    `SearchReport` to ``d/report.json``.  The probe sequence re-derives
    purely from the spec digest, so every resumed attempt walks the
    SAME sequence and serves already-settled probes from their ledger
    rows."""
    from ..matrix import SearchSpec, run_search
    from ..serve import Scheduler
    from ..server.core import load_models
    load_models()

    spec = SearchSpec.from_json(SEARCH_SPEC)
    sch = Scheduler(ledger_path=os.path.join(d, "ledger.jsonl"),
                    checkpoint_dir=os.path.join(d, "ck"),
                    journal_dir=os.path.join(d, "journal"),
                    device=device)
    run = run_search(spec, sch, max_wave=4, resume=resume,
                     memo={"table": os.path.join(d, "memo_table")})
    run.report.save(os.path.join(d, "report.json"))
    return 0 if run.report.clean else 1


# ----------------------------------------------------------------- parent


def _spawn(d: str, resume: bool, timeline=None,
           search: bool = False, device=None) -> subprocess.Popen:
    os.makedirs(d, exist_ok=True)
    args = [sys.executable, "-m", __spec__.name, "--child", "--dir", d]
    if device is not None:
        args += ["--device", str(device)]
    if search:
        args.append("--search")
    if resume:
        args.append("--resume")
    if timeline is not None:
        args += ["--timeline", str(timeline)]
    # the child holds its own copy of the log's descriptor
    with open(os.path.join(d, "child.log"), "a") as log:
        return subprocess.Popen(args, stdout=log, stderr=log,
                                cwd=str(REPO))


def _run_to_completion(d: str, resume: bool, timeline=None,
                       search: bool = False, device=None) -> dict:
    p = _spawn(d, resume, timeline, search=search, device=device)
    p.wait()
    report = os.path.join(d, "report.json")
    if p.returncode != 0 or not os.path.exists(report):
        raise RuntimeError(
            f"child run in {d} failed (rc={p.returncode}); see "
            f"{d}/child.log")
    with open(report) as f:
        return json.load(f)


def run_crash_test(out_dir, kills: int = 5, seed: int = 0,
                   min_delay: float = 1.0,
                   max_delay: float | None = None,
                   timeline=None, device=None) -> dict:
    """The whole harness (module docstring): reference run, N
    SIGKILLs at seeded-random offsets with resume after each, final
    resume to completion, normalized-report comparison.  Returns the
    result block (``ok`` is the bit-identity verdict); raises
    RuntimeError when a child fails outright.  `timeline` records one
    host span log per campaign ATTEMPT (killed attempts leave torn
    tails the reader tolerates) and renders the merged Perfetto file
    at the end."""
    out = pathlib.Path(out_dir)
    ref_dir, camp_dir = str(out / "ref"), str(out / "campaign")
    t0 = time.time()
    ref = _run_to_completion(ref_dir, resume=False, device=device)
    ref_wall = time.time() - t0
    # kill offsets span the child's working life: from early import (a
    # kill before anything durable exists — resume must cope with
    # empty state) into mid-campaign.  The ceiling sits at ~half the
    # reference wall: an attempt that outlives its kill offset runs to
    # COMPLETION, after which the remaining kills can only hit the
    # (sub-second) all-served resume path — early offsets keep real
    # work on the table for every kill
    hi = max_delay if max_delay is not None else max(2.0,
                                                     0.45 * ref_wall)
    rng = random.Random(seed)
    landed, early_done = 0, 0
    for i in range(kills):
        p = _spawn(camp_dir, resume=i > 0, timeline=timeline,
                   device=device)
        delay = rng.uniform(min_delay, hi)
        t_spawn = time.time()
        while time.time() - t_spawn < delay and p.poll() is None:
            time.sleep(0.05)
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
            landed += 1
            print(f"crash_test: kill {i + 1}/{kills} landed at "
                  f"+{delay:.2f}s", flush=True)
        else:
            # the attempt finished before its kill offset: resumed
            # children get faster (warm caches, ledger-served cells),
            # so ADAPT the ceiling to the observed wall — later kills
            # land inside the shrinking window (import, journal
            # replay, ledger join are all legitimate kill points too)
            early_done += 1
            wall = time.time() - t_spawn
            hi = max(min_delay + 0.5, 0.9 * wall)
            print(f"crash_test: kill {i + 1}/{kills} missed (child "
                  f"finished at +{wall:.2f}s < +{delay:.2f}s); "
                  f"ceiling -> {hi:.2f}s", flush=True)
        p.wait()
    final = _run_to_completion(camp_dir, resume=True,
                               timeline=timeline, device=device)
    ok = normalize_report(final) == normalize_report(ref)
    res = {"ok": ok, "kills_requested": kills, "kills_landed": landed,
           "kills_missed": early_done, "seed": seed,
           "ref_wall_s": round(ref_wall, 2),
           "cells": final.get("cells_total"),
           "resume": final.get("resume"),
           "grid_digest": final.get("grid_digest")}
    if timeline is not None:
        import glob

        from ..obs.export import spans_to_perfetto
        from ..obs.spans import read_spans
        rows, logs = [], sorted(glob.glob(
            os.path.join(str(timeline), "spans*.jsonl")))
        for f in logs:
            rows.extend(read_spans(f))
        tpath = os.path.join(str(timeline), "timeline.json")
        spans_to_perfetto(rows, path=tpath)
        res["timeline"] = {"path": tpath, "span_logs": len(logs),
                           "spans": len(rows)}
    return res


def run_search_crash_test(out_dir, kills: int = 3, seed: int = 0,
                          min_delay: float = 1.0,
                          max_delay: float | None = None,
                          device=None) -> dict:
    """The adaptive-search variant (--search): SIGKILL a `SEARCH_SPEC`
    campaign at seeded-random offsets — mid-prefix, mid-probe, between
    bisection rounds — resume after every kill, drive the final
    attempt to completion, and assert the resulting `SearchReport` is
    bit-identical to an uninterrupted run's outside
    `SEARCH_VOLATILE_KEYS`.  The probe SEQUENCE is the heart of the
    pin: it derives purely from (grid digest, search digest), so a
    resumed search must re-walk the identical coarse ladder +
    bisection path, serving settled probes from their ledger rows and
    re-entering mid-flight ones through checkpoints + the journal."""
    out = pathlib.Path(out_dir)
    ref_dir, camp_dir = str(out / "ref"), str(out / "campaign")
    t0 = time.time()
    ref = _run_to_completion(ref_dir, resume=False, search=True,
                             device=device)
    ref_wall = time.time() - t0
    # kill-offset ceiling: same adaptive logic as run_crash_test — an
    # attempt that outlives its offset completes, after which later
    # kills only exercise the all-served resume path
    hi = max_delay if max_delay is not None else max(2.0,
                                                     0.45 * ref_wall)
    rng = random.Random(seed)
    landed, early_done = 0, 0
    for i in range(kills):
        p = _spawn(camp_dir, resume=i > 0, search=True, device=device)
        delay = rng.uniform(min_delay, hi)
        t_spawn = time.time()
        while time.time() - t_spawn < delay and p.poll() is None:
            time.sleep(0.05)
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
            landed += 1
            print(f"crash_test: search kill {i + 1}/{kills} landed "
                  f"at +{delay:.2f}s", flush=True)
        else:
            early_done += 1
            wall = time.time() - t_spawn
            hi = max(min_delay + 0.5, 0.9 * wall)
            print(f"crash_test: search kill {i + 1}/{kills} missed "
                  f"(child finished at +{wall:.2f}s < +{delay:.2f}s); "
                  f"ceiling -> {hi:.2f}s", flush=True)
        p.wait()
    final = _run_to_completion(camp_dir, resume=True, search=True,
                               device=device)
    ok = normalize_search_report(final) == normalize_search_report(ref)
    return {"ok": ok, "kills_requested": kills, "kills_landed": landed,
            "kills_missed": early_done, "seed": seed,
            "ref_wall_s": round(ref_wall, 2),
            "cells_probed": final.get("cells_probed"),
            "boundaries_found": final.get("boundaries_found"),
            "search_digest": final.get("search_digest"),
            "grid_digest": final.get("grid_digest")}


def run_fleet_crash_test(out_dir, workers: int = 3, kills: int = 1,
                         seed: int = 0, min_delay: float = 1.0,
                         max_delay: float | None = None,
                         lease_ttl_s: float = 3.0,
                         timeline=None, device=None) -> dict:
    """The fleet variant (--workers N): run the SAME campaign as a
    lease-based worker fleet (matrix/driver.py run_grid(workers=N)),
    SIGKILL a seeded-random WORKER — not the whole campaign — at
    seeded offsets, and assert the surviving workers complete the grid
    with a `MatrixReport` bit-identical (normalized) to a 1-worker
    uninterrupted fleet run's.  At least one worker is never targeted,
    so survivors always exist to reclaim the dead workers' expired
    leases (short ttl keeps the reclaim window inside the test's
    wall); recovery is checkpoint adoption or journal replay — the
    same paths the single-process harness pins.

    `timeline` (a directory) turns every worker's host flight
    recorder ON: span JSONL per worker — a SIGKILLed worker's log
    survives as a torn tail the reader tolerates — plus one merged
    Perfetto ``timeline.json`` at the end, where the survivors'
    adoption spans reference the dead workers' request ids."""
    import threading

    from ..matrix import SweepGrid, run_grid
    from ..server.core import load_models
    load_models()

    out = pathlib.Path(out_dir)
    grid = SweepGrid.from_json(CRASH_GRID)
    t0 = time.time()
    ref = run_grid(grid, workers=1, fleet_dir=str(out / "ref-fleet"),
                   keep_states=(),
                   fleet_opts={"lease_ttl_s": lease_ttl_s,
                               "timeout_s": 600.0}, device=device)
    ref_wall = time.time() - t0
    ref.report.save(str(out / "ref-report.json"))
    # kill offsets span the fleet's working life (worker import included
    # — a kill mid-import must leave nothing adopted); the ceiling sits
    # inside the reference wall so real work stays on the table
    hi = max_delay if max_delay is not None else max(2.0,
                                                     0.6 * ref_wall)
    rng = random.Random(seed)
    kills = max(1, min(kills, workers - 1))
    victims = rng.sample(range(workers - 1), kills)
    delays = sorted(rng.uniform(min_delay, hi) for _ in victims)
    kill_log: list = []

    def on_spawned(procs):
        def killer():
            t_start = time.time()
            for v, d in zip(victims, delays):
                while time.time() - t_start < d:
                    time.sleep(0.05)
                p = procs[v]
                landed = p.poll() is None
                if landed:
                    os.kill(p.pid, signal.SIGKILL)
                kill_log.append({"worker": f"w{v}",
                                 "at_s": round(d, 2),
                                 "landed": landed})
                print(f"crash_test: SIGKILL w{v} at +{d:.2f}s "
                      f"({'landed' if landed else 'already exited'})",
                      flush=True)
        threading.Thread(target=killer, daemon=True,
                         name="fleet-killer").start()

    t1 = time.time()
    fleet_opts = {"lease_ttl_s": lease_ttl_s, "timeout_s": 600.0,
                  "on_spawned": on_spawned}
    if timeline is not None:
        os.makedirs(timeline, exist_ok=True)
        fleet_opts["timeline"] = str(timeline)
    final = run_grid(grid, workers=workers,
                     fleet_dir=str(out / "fleet"), keep_states=(),
                     fleet_opts=fleet_opts, device=device)
    wall = time.time() - t1
    final.report.save(str(out / "report.json"))
    timeline_block = None
    if timeline is not None:
        # render every worker's span log — the SIGKILLed workers'
        # torn tails included — onto one merged Perfetto timeline
        import glob

        from ..obs.export import spans_to_perfetto
        from ..obs.spans import read_spans
        rows = []
        logs = sorted(glob.glob(os.path.join(str(timeline), "**",
                                             "spans*.jsonl"),
                                recursive=True))
        for f in logs:
            rows.extend(read_spans(f))
        tpath = os.path.join(str(timeline), "timeline.json")
        spans_to_perfetto(rows, path=tpath)
        dead = {k["worker"] for k in kill_log if k["landed"]}
        adoptions = [r for r in rows
                     if r["name"].startswith("fleet.adopt")
                     and r.get("worker") not in dead]
        timeline_block = {"path": tpath, "span_logs": len(logs),
                          "spans": len(rows),
                          "survivor_adoptions": len(adoptions)}
    ok = normalize_report(final.report.to_json()) \
        == normalize_report(ref.report.to_json())
    fl = final.report.data.get("resume", {})
    res = {"ok": ok, "workers": workers, "kills": kill_log,
           "kills_landed": sum(1 for k in kill_log if k["landed"]),
           "seed": seed, "ref_wall_s": round(ref_wall, 2),
           "wall_s": round(wall, 2),
           "cells": final.report.data.get("cells_total"),
           "adopted_checkpoints": fl.get("adopted_checkpoints"),
           "entries_claimed": fl.get("journal_replayed"),
           "worker_deduped": fl.get("worker_deduped"),
           "grid_digest": final.report.data.get("grid_digest")}
    if timeline_block is not None:
        res["timeline"] = timeline_block
    return res


def _print_divergence(ref: dict, final: dict, norm=normalize_report):
    a, b = norm(ref), norm(final)
    for key in sorted(set(a) | set(b)):
        if a.get(key) != b.get(key):
            print(f"  DIVERGENCE in {key!r}:", file=sys.stderr)
            if key == "cells":
                for ra, rb in zip(a.get(key, ()), b.get(key, ())):
                    if ra != rb:
                        print(f"    cell {ra.get('cell')}: "
                              f"ref={json.dumps(ra, sort_keys=True)} "
                              f"resumed={json.dumps(rb, sort_keys=True)}",
                              file=sys.stderr)
            else:
                print(f"    ref={json.dumps(a.get(key), sort_keys=True)}"
                      f" resumed="
                      f"{json.dumps(b.get(key), sort_keys=True)}",
                      file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.crash_test",
        description="kill-anywhere recovery harness: SIGKILL a matrix "
                    "campaign N times, resume, assert report "
                    "bit-identity vs the uninterrupted run")
    ap.add_argument("--kills", type=int, default=5,
                    help="SIGKILLs before the final resume (default 5; "
                         "with --workers: workers killed, capped at "
                         "N-1 so survivors always exist)")
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="fleet variant: run the campaign as N lease-"
                         "based worker processes and SIGKILL seeded-"
                         "random WORKERS (not the campaign); the "
                         "survivors must finish with a report bit-"
                         "identical to a 1-worker uninterrupted "
                         "fleet run")
    ap.add_argument("--lease-ttl", type=float, default=3.0,
                    metavar="S", help="fleet lease ttl (--workers; "
                    "short keeps the dead workers' reclaim window "
                    "inside the test wall; default 3.0)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the kill-offset draws (default 0)")
    ap.add_argument("--dir", default=None, metavar="DIR",
                    help="working directory (default: a temp dir)")
    ap.add_argument("--min-delay", type=float, default=1.0,
                    help="earliest kill offset in seconds (default 1.0 "
                         "— lands mid-import)")
    ap.add_argument("--max-delay", type=float, default=None,
                    help="latest kill offset (default: 0.9 x the "
                         "reference run's wall)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON result line here")
    ap.add_argument("--timeline", default=None, metavar="DIR",
                    help="turn the host-plane flight recorder ON: "
                         "one span JSONL per campaign attempt (or per "
                         "fleet worker with --workers; SIGKILLed "
                         "processes leave torn tails the reader "
                         "tolerates) plus one merged Perfetto "
                         "timeline.json under DIR")
    ap.add_argument("--search", action="store_true",
                    help="adaptive-search variant: SIGKILL a "
                         "SEARCH_SPEC boundary-search campaign "
                         "mid-probe/mid-prefix/between bisection "
                         "rounds and assert the resumed SearchReport "
                         "is bit-identical (normalized) to an "
                         "uninterrupted run's")
    ap.add_argument("--device", default=None,
                    help="the device every child process or worker "
                         "runs on (default cuda)")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        if not args.dir:
            print("config error: --child needs --dir", file=sys.stderr)
            return 2
        os.makedirs(args.dir, exist_ok=True)
        if args.search:
            return search_child_main(args.dir, resume=args.resume,
                                     device=args.device)
        return child_main(args.dir, resume=args.resume,
                          timeline=args.timeline, device=args.device)

    if args.kills < 1:
        print("config error: --kills must be >= 1", file=sys.stderr)
        return 2
    import tempfile
    work = args.dir or tempfile.mkdtemp(prefix="wtpu-crash-")
    if args.search:
        if args.workers is not None:
            print("config error: --search is the single-process "
                  "kill+resume harness; fleet bit-identity is pinned "
                  "separately (run_search(workers=N) in "
                  "tests/test_torch_search.py)", file=sys.stderr)
            return 2
        try:
            res = run_search_crash_test(
                work, kills=args.kills, seed=args.seed,
                min_delay=args.min_delay, max_delay=args.max_delay,
                device=args.device)
        except RuntimeError as e:
            print(f"config error: {e}", file=sys.stderr)
            return 2
        line = json.dumps({"metric": "search_crash_bit_identical",
                           "value": int(res["ok"]), "unit": "bool",
                           **res})
        print(line)
        if args.out:
            pathlib.Path(args.out).write_text(line + "\n")
        if not res["ok"]:
            with open(os.path.join(work, "ref", "report.json")) as f:
                ref = json.load(f)
            with open(os.path.join(work, "campaign",
                                   "report.json")) as f:
                final = json.load(f)
            _print_divergence(ref, final, norm=normalize_search_report)
            return 1
        return 0
    if args.workers is not None:
        if args.workers < 2:
            print("config error: --workers needs N >= 2 (a 1-worker "
                  "fleet has no survivors to recover a kill)",
                  file=sys.stderr)
            return 2
        try:
            res = run_fleet_crash_test(
                work, workers=args.workers, kills=args.kills,
                seed=args.seed, min_delay=args.min_delay,
                max_delay=args.max_delay, lease_ttl_s=args.lease_ttl,
                timeline=args.timeline, device=args.device)
        except RuntimeError as e:
            print(f"config error: {e}", file=sys.stderr)
            return 2
        line = json.dumps({"metric": "fleet_crash_bit_identical",
                           "value": int(res["ok"]), "unit": "bool",
                           **res})
        print(line)
        if args.out:
            pathlib.Path(args.out).write_text(line + "\n")
        if not res["ok"]:
            with open(os.path.join(work, "ref-report.json")) as f:
                ref = json.load(f)
            with open(os.path.join(work, "report.json")) as f:
                final = json.load(f)
            _print_divergence(ref, final)
            return 1
        return 0
    try:
        res = run_crash_test(work, kills=args.kills, seed=args.seed,
                             min_delay=args.min_delay,
                             max_delay=args.max_delay,
                             timeline=args.timeline, device=args.device)
    except RuntimeError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    line = json.dumps({"metric": "crash_test_bit_identical",
                       "value": int(res["ok"]), "unit": "bool", **res})
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    if not res["ok"]:
        with open(os.path.join(work, "ref", "report.json")) as f:
            ref = json.load(f)
        with open(os.path.join(work, "campaign", "report.json")) as f:
            final = json.load(f)
        _print_divergence(ref, final)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
