"""One-command adaptive boundary search: compile, probe, report; the port
of `tools/search.py` (its arguments, exit codes and output, with
``--device``, default ``cuda``; ``--workers`` processes take the same
device).

Loads a `SearchSpec` JSON (file, inline JSON, or '-' for stdin) — a
`SweepGrid` plus a search axis and a predicate over per-cell report
fields — compiles it into the deterministic coarse-bracket + bisection
probe plan, runs the probes through the serve scheduler with memoized
supersteps (shared honest prefixes, cross-run memo table, ledger
dedup), prints the `SearchReport`, and optionally saves it.

Exit codes (the `cli/chaos.py` convention):
  0  every slice located its boundary
  1  predicate violation or divergence: a slice came back all_pass /
     all_fail (no boundary inside the axis range), non-monotone
     verdicts, or an errored probe cell (all printed)
  2  configuration error: malformed spec JSON, unknown axis or
     predicate field, --resume without --checkpoint-dir, --workers
     without --fleet-dir

    # where does done_frac >= 0.99 flip along the loss axis?
    python -m wittgenstein_tpu_torch.cli.search --spec search.json --out report.json

    # print the probe plan (slices, coarse ladder, worst-case probes)
    python -m wittgenstein_tpu_torch.cli.search --spec search.json --plan-only
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_spec_json(arg: str):
    if arg == "-":
        return json.load(sys.stdin)
    if arg.lstrip().startswith("{"):
        return json.loads(arg)
    with open(arg) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.search",
        description="adaptive boundary search over a sweep grid: "
                    "coarse bracket + bisection, memoized probes")
    ap.add_argument("--spec", required=True, metavar="JSON|PATH|-",
                    help="SearchSpec JSON: a file path, inline JSON, "
                         "or '-' for stdin (schema: matrix/search.py — "
                         "{'grid': ..., 'axis': ..., 'predicate': "
                         "{'field', 'op', 'value'}})")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the SearchReport artifact here "
                         "(atomic; what --resume compares against)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="per-probe RunManifest JSONL (default: the "
                         "shared reports/ledger); re-running a search "
                         "over the same ledger serves every probe "
                         "from its row — zero new simulated chunks")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write chunk-boundary checkpoints; a killed "
                         "search restarts with --resume from exactly "
                         "where it died (bit-identical report)")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="durable submission journal (WAL): probes "
                         "queued but never launched when the process "
                         "died are recovered by --resume")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed search: finished probes "
                         "serve from their ledger rows, mid-flight "
                         "ones re-enter through checkpoints + the "
                         "journal, and the probe sequence re-derives "
                         "identically from the spec digest")
    ap.add_argument("--no-memo", action="store_true",
                    help="disable memoized supersteps (probes run "
                         "cold end-to-end; bit-identical, just "
                         "slower — the bisection savings remain)")
    ap.add_argument("--memo-table", default=None, metavar="DIR",
                    help="cross-run memo table directory: completed "
                         "honest prefixes are reused across search "
                         "invocations (and handed to fleet workers)")
    ap.add_argument("--max-wave", type=int, default=64,
                    help="max probe cells per coalesced launch wave "
                         "(default 64)")
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="fleet mode (serve/fleet.py): probes become "
                         "durable journal entries completed by N "
                         "worker PROCESSES over --fleet-dir, each "
                         "opened on the shared memo table — "
                         "bit-identical to a single-process run")
    ap.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="the shared fleet directory for --workers "
                         "(holds journal/, checkpoints/, ledger.jsonl, "
                         "memo_table/, workers/)")
    ap.add_argument("--catalog", default=None, metavar="PATH",
                    help="program-catalog JSONL (obs/programs.py): "
                         "every probe program build appends a durable "
                         "row (first-launch wall, working set, kernel "
                         "launches) — render with "
                         "cli/programs.py (single-process mode "
                         "only; fleet workers take --catalog on the "
                         "worker CLI)")
    ap.add_argument("--plan-only", action="store_true",
                    help="compile + print the probe plan accounting, "
                         "run nothing")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-round progress lines")
    ap.add_argument("--device", default=None,
                    help="the device the probes run on (default cuda)")
    args = ap.parse_args(argv)

    from ..core.state import resolve_device
    from ..matrix import SearchSpec, compile_search, run_search
    from ..server.core import load_models
    load_models()

    try:
        spec = SearchSpec.from_json(_load_spec_json(args.spec))
        splan = compile_search(spec)
    except (ValueError, OSError, json.JSONDecodeError, TypeError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    s = splan.summary()
    print(f"search {spec.name!r} [{s['search_digest']}] over grid "
          f"[{s['grid_digest']}]: {s['slices']} slice(s) x "
          f"{len(s['axis_labels'])} {s['axis']!r} values, coarse "
          f"ladder {s['coarse_labels']}, worst case {s['max_probes']} "
          f"of {s['cells_exhaustive']} cells "
          f"({s['chunks_exhaustive']} chunks exhaustive)")
    if args.plan_only:
        return 0

    dev = resolve_device(args.device)
    if args.resume and not args.checkpoint_dir:
        print("config error: --resume needs --checkpoint-dir (the "
              "interrupted run's checkpoint directory)", file=sys.stderr)
        return 2
    if args.workers is not None:
        if not args.fleet_dir:
            print("config error: --workers needs --fleet-dir (the one "
                  "shared directory the worker processes derive "
                  "journal/checkpoint/ledger/memo-table paths from)",
                  file=sys.stderr)
            return 2
        if args.resume:
            print("config error: --workers is a separate-process "
                  "fleet; resume is implicit (re-running over the "
                  "same --fleet-dir serves finished probes from the "
                  "shared ledger automatically)", file=sys.stderr)
            return 2
        if args.catalog:
            print("config error: --catalog is single-process only "
                  "(fleet workers own their catalogs: pass --catalog "
                  "on the worker CLI, files land as "
                  "<fleet-dir>/programs-<worker>.jsonl)",
                  file=sys.stderr)
            return 2

    def progress(p):
        if not args.quiet:
            print(f"  [{p['wall_s']:8.1f}s] round {p['round']}: "
                  f"{p['probed']} cells probed, {p['slices_open']} "
                  f"slice(s) open, {p['chunks_simulated']} chunks "
                  f"simulated", file=sys.stderr, flush=True)

    memo = False if args.no_memo \
        else ({"table": args.memo_table} if args.memo_table else True)
    if args.workers is not None:
        run = run_search(spec, splan=splan, memo=memo,
                         progress=progress, workers=args.workers,
                         fleet_dir=args.fleet_dir, device=str(dev))
        rep = run.report
        r = rep.data["accounting"].get("resume") or {}
        print(f"fleet: {r.get('fleet_workers')} workers, "
              f"{r.get('journal_replayed')} entries claimed, "
              f"{r.get('memo_table_hits')} memo-table hits")
    else:
        from ..serve import Scheduler
        cat = None
        if args.catalog:
            from ..obs.programs import ProgramCatalog
            cat = ProgramCatalog(path=args.catalog)
        sch = Scheduler(ledger_path=args.ledger,
                        checkpoint_dir=args.checkpoint_dir,
                        journal_dir=args.journal_dir, catalog=cat,
                        device=dev)
        try:
            run = run_search(spec, sch, splan=splan,
                             max_wave=args.max_wave,
                             resume=args.resume, memo=memo,
                             progress=progress)
        except ValueError as e:
            # ONLY the resume staleness refusals are config errors; a
            # ValueError from a plain campaign is an internal failure
            # and must keep its traceback
            if not args.resume:
                raise
            print(f"config error: {e}", file=sys.stderr)
            return 2
        rep = run.report
    print(rep.format())
    if args.out:
        print(f"report -> {rep.save(args.out)}")
    if rep.clean:
        print("BOUNDARY: every slice bracketed and bisected to a "
              "single axis step")
        return 0
    for row in rep.data["slices"]:
        if row["status"] != "boundary":
            print(f"slice {row['slice']}: {row['status']}"
                  + (f" ({row['error']})" if row.get("error") else ""),
                  file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
