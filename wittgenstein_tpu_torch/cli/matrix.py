"""One-command sweep-grid campaign: expand, plan, run, report, verify;
the port of `tools/matrix.py` (its arguments, exit codes and output,
with ``--device``, default ``cuda``; ``--workers`` processes take the
same device).

Loads a `SweepGrid` JSON (file, inline JSON, or '-' for stdin), plans
it (every cell validated, grouped by compile key), runs it through the
serve scheduler with live progress on stderr, prints the cross-cell
`MatrixReport` summary, and optionally spot-checks a deterministic
subset of cells bit-for-bit against sequential `Runner` runs (full
final pytree + metrics/audit blocks — the matrix acceptance pin).

Exit codes (the `cli/chaos.py` convention):
  0  every cell done, every audit verdict clean, spot checks
     bit-identical
  1  violations or divergence: errored cells, audit violations, or a
     spot-checked cell differing from its sequential reference (all
     printed)
  2  configuration error: malformed grid JSON, unknown axis path, a
     cell that fails `ScenarioSpec.validate` (the offending cell is
     named)

    # a 2 x 2 x 2 grid from a file, report to disk, 3 spot checks
    python -m wittgenstein_tpu_torch.cli.matrix --grid grid.json --out report.json \
        --spot-check 3

    # inline grid
    python -m wittgenstein_tpu_torch.cli.matrix --grid '{"base": {"protocol": "PingPong",
        "params": {"node_count": 32}, "sim_ms": 120, "chunk_ms": 120},
        "axes": [{"name": "seed", "field": "seeds",
                  "values": [[0], [1]]}]}'
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_grid_json(arg: str):
    if arg == "-":
        return json.load(sys.stdin)
    if arg.lstrip().startswith("{"):
        return json.loads(arg)
    with open(arg) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.matrix",
        description="declarative sweep-grid campaign: plan, run, "
                    "report, verify")
    ap.add_argument("--grid", required=True, metavar="JSON|PATH|-",
                    help="SweepGrid JSON: a file path, inline JSON, or "
                         "'-' for stdin (schema: matrix/grid.py)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the MatrixReport artifact here")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="per-cell RunManifest JSONL (default: the "
                         "shared reports/ledger)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write chunk-boundary group checkpoints; a "
                         "killed campaign restarts with --resume from "
                         "exactly where it died (bit-identical "
                         "continuation, spec digests verified)")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="durable submission journal (WAL): every "
                         "accepted cell submit is fsync'd before ack "
                         "and tombstoned on completion, so --resume "
                         "recovers even cells that were queued but "
                         "never launched when the process died")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed campaign: re-enqueue this "
                         "grid's per-group checkpoints (needs the "
                         "interrupted run's --checkpoint-dir), replay "
                         "the submission journal (--journal-dir, if "
                         "the interrupted run used one), serve "
                         "finished cells from their ledger rows "
                         "(--ledger; exact config-digest matches from "
                         "other grids dedup too), and re-run only the "
                         "unfinished cells.  Stale/mismatched "
                         "checkpoints refuse loudly (exit 2)")
    ap.add_argument("--memo", action="store_true",
                    help="memoized supersteps (wittgenstein_tpu_torch/"
                         "memo): "
                         "cells differing only in post-fork adversity "
                         "share ONE honest-prefix run and fork from "
                         "its checkpoint — bit-identical, and "
                         "spot-checks verify forked cells like any "
                         "other (their rows carry forked_from)")
    ap.add_argument("--memo-table", default=None, metavar="DIR",
                    help="cross-run memo table directory (implies "
                         "--memo): completed prefixes are reused "
                         "across campaign invocations")
    ap.add_argument("--max-wave", type=int, default=64,
                    help="max cells per coalesced launch wave "
                         "(default 64)")
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="fleet mode (serve/fleet.py): enqueue the "
                         "grid into a shared journal and run it with "
                         "N worker PROCESSES over --fleet-dir; cell "
                         "rows come back through the shared-ledger "
                         "join, bit-identical to a single-process run")
    ap.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="the shared fleet directory for --workers "
                         "(holds journal/, checkpoints/, ledger.jsonl, "
                         "workers/); re-running over the same dir "
                         "resumes an interrupted fleet campaign")
    ap.add_argument("--spot-check", type=int, default=0, metavar="N",
                    help="verify N cells (deterministic spread) "
                         "bit-for-bit against sequential Runner runs")
    ap.add_argument("--plan-only", action="store_true",
                    help="expand + plan + print the compile accounting, "
                         "run nothing")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-wave progress lines")
    ap.add_argument("--device", default=None,
                    help="the device the campaign runs on (default cuda)")
    args = ap.parse_args(argv)

    from ..core.state import resolve_device
    from ..matrix import (SweepGrid, pick_spot_cells, plan, run_grid,
                          verify_cell)
    from ..serve import Scheduler
    from ..server.core import load_models
    load_models()

    try:
        grid = SweepGrid.from_json(_load_grid_json(args.grid))
        mplan = plan(grid)
    except (ValueError, OSError, json.JSONDecodeError, TypeError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    summ = mplan.summary()
    print(f"grid {grid.name!r} [{summ['grid_digest']}]: "
          f"{summ['cells']} cells -> {summ['planned_compiles']} compile "
          f"keys ({summ['expected_builds']} program builds, largest "
          f"group {summ['largest_group']} cells)")
    if args.plan_only:
        return 0
    dev = resolve_device(args.device)

    spot = pick_spot_cells(mplan.cells, args.spot_check)

    def progress(p):
        if not args.quiet:
            print(f"  [{p['wall_s']:8.1f}s] {p['done']}/{p['total']} "
                  f"cells, {p['program_builds']} builds, "
                  f"{p['groups_done']}/{p['groups_total']} groups",
                  file=sys.stderr, flush=True)

    if args.resume and not args.checkpoint_dir:
        print("config error: --resume needs --checkpoint-dir (the "
              "interrupted run's checkpoint directory)", file=sys.stderr)
        return 2
    if args.workers is not None:
        if not args.fleet_dir:
            print("config error: --workers needs --fleet-dir (the one "
                  "shared directory the worker processes derive "
                  "journal/checkpoint/ledger paths from)",
                  file=sys.stderr)
            return 2
        if args.resume or args.memo or args.memo_table:
            print("config error: --workers is a separate-process "
                  "fleet; --resume/--memo are single-process drivers "
                  "(the fleet serves finished cells from the shared "
                  "ledger automatically)", file=sys.stderr)
            return 2

        def fleet_progress(p):
            if not args.quiet:
                print(f"  [{p['wall_s']:8.1f}s] {p['done']}/"
                      f"{p['total']} cells, journal lag "
                      f"{p['journal_lag']}", file=sys.stderr,
                      flush=True)

        run = run_grid(grid, plan_=mplan, keep_states=(),
                       progress=fleet_progress, workers=args.workers,
                       fleet_dir=args.fleet_dir, device=str(dev))
        report = run.report
        r = report.data["resume"]
        print(f"fleet: {r['fleet_workers']} workers, "
              f"{r['journal_replayed']} entries claimed, "
              f"{r['worker_deduped']} worker-deduped, "
              f"{r['adopted_checkpoints']} checkpoints adopted")
        print(report.format())
        if args.out:
            print(f"report -> {report.save(args.out)}")
        if spot:
            print("spot checks: SKIPPED (fleet cells' final states "
                  "live in the worker processes; re-run without "
                  "--workers to verify)")
        if report.clean:
            print("CLEAN: all cells done, audits clean")
        return 0 if report.clean else 1
    memo = None
    if args.memo or args.memo_table:
        memo = {"table": args.memo_table} if args.memo_table else True
    sch = Scheduler(ledger_path=args.ledger,
                    checkpoint_dir=args.checkpoint_dir,
                    journal_dir=args.journal_dir, device=dev)
    try:
        run = run_grid(grid, sch, plan_=mplan, max_wave=args.max_wave,
                       keep_states=tuple(spot), progress=progress,
                       resume=args.resume, memo=memo)
    except ValueError as e:
        # ONLY the resume staleness refusals are config errors; a
        # ValueError from a plain campaign is an internal failure and
        # must keep its traceback
        if not args.resume:
            raise
        print(f"config error: {e}", file=sys.stderr)
        return 2
    report = run.report
    if args.resume and "resume" in report.data:
        r = report.data["resume"]
        print(f"resume: {r['from_ledger']} cells from this grid's "
              f"ledger rows, {r['deduped']} deduped from exact config "
              f"matches, {r['resumed_requests']} requests resumed "
              f"from checkpoints ({r.get('journal_replayed', 0)} of "
              "them replayed from the submission journal)")
    print(report.format())
    if args.out:
        path = report.save(args.out)
        print(f"report -> {path}")

    rc = 0 if report.clean else 1
    for cid in spot:
        row = report.cell(cid)
        if row["status"] != "done":
            print(f"spot check {cid}: SKIPPED (cell "
                  f"{row['status']}: {row.get('error')})")
            rc = 1
            continue
        if cid not in run.states:
            # a resume run served this cell from its ledger row — no
            # fresh state to verify; it was spot-checkable when it ran
            print(f"spot check {cid}: SKIPPED (served from the "
                  "ledger; re-run without --resume to re-verify)")
            continue
        mism = verify_cell(mplan.resolved[cid], run.states[cid],
                           run.artifacts[cid])
        # a forked cell verifies like any other — its final state and
        # stitched blocks are compared against the same sequential
        # twin, with the fork provenance named instead of skipped
        fk = row.get("forked_from")
        how = (f" (forked from prefix {fk['prefix_digest']} @ "
               f"{fk['fork_ms']} ms)") if fk else ""
        if mism:
            print(f"spot check {cid}: DIVERGENCE vs the sequential "
                  f"Runner reference{how}:")
            for m in mism:
                print(f"  {m}")
            rc = 1
        else:
            print(f"spot check {cid}: bit-identical to the sequential "
                  f"Runner reference (full pytree + obs blocks){how}")
    if rc == 0:
        print("CLEAN: all cells done, audits clean"
              + (", spot checks bit-identical" if spot else ""))
    return rc


if __name__ == "__main__":
    sys.exit(main())
