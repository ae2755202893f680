"""Gate a bench-history ledger: did the latest round regress?  The
port of `tools/regress.py`.

`cli/bench_suite.py` appends one row per stage per round to a history
ledger (``reports/bench_history.jsonl`` by default), and `bench_torch.py
--history` one row per bench line.  This CLI runs the median/MAD
detector (`wittgenstein_tpu_torch/obs/regress.py`) over that file:
the chosen round (default: the last one in the file) is compared
series-by-series against a same-(stage, config digest, backend, host)
baseline built from earlier rounds.

    # gate the most recent round
    python -m wittgenstein_tpu_torch.cli.regress \
        reports/bench_history.jsonl

    # gate a specific round, machine-readable
    python -m wittgenstein_tpu_torch.cli.regress \
        reports/bench_history.jsonl --round 1754550000000000000 --json

    # loosen the window for a noisy CI box
    python -m wittgenstein_tpu_torch.cli.regress \
        reports/bench_history.jsonl --nsigma 6 --rel-floor 0.25

Exit code 0 = clean (including "no baseline yet" — a fresh host has
nothing to gate against), 1 = regression (each finding names stage,
series, and ratio), 2 = configuration error (missing file, empty
history, unknown round).  ``bench_suite --check-regressions`` runs
the same gate in-process after a suite round.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs import regress


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="regression gate over a bench_suite history ledger")
    ap.add_argument("history", help="bench history JSONL "
                    "(bench_suite appends it per round)")
    ap.add_argument("--round", default=None,
                    help="round id to gate (default: last in file)")
    ap.add_argument("--k", type=int, default=regress.BASELINE_K,
                    help="baseline window: last K comparable rounds "
                    f"(default {regress.BASELINE_K})")
    ap.add_argument("--nsigma", type=float, default=regress.NSIGMA,
                    help="MAD-scaled threshold multiplier "
                    f"(default {regress.NSIGMA})")
    ap.add_argument("--rel-floor", type=float,
                    default=regress.REL_FLOOR,
                    help="relative threshold floor as a fraction of "
                    f"the baseline median (default {regress.REL_FLOOR})")
    ap.add_argument("--min-baseline", type=int,
                    default=regress.MIN_BASELINE,
                    help="skip series with fewer comparable rows "
                    f"(default {regress.MIN_BASELINE})")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as one JSON object")
    args = ap.parse_args(argv)

    code, findings, summary = regress.gate(
        args.history, round_id=args.round, k=args.k,
        nsigma=args.nsigma, rel_floor=args.rel_floor,
        min_baseline=args.min_baseline)

    if args.json:
        print(json.dumps({"exit": code, "summary": summary,
                          "findings": findings}, indent=2,
                         sort_keys=True))
        return code

    if code == 2:
        print(f"regress: {summary.get('error')}", file=sys.stderr)
        return code
    print(f"round {summary['round']}: {summary['stages']} stage(s), "
          f"{summary['series_checked']} series checked, "
          f"{summary['series_skipped_no_baseline']} skipped "
          "(no baseline)")
    if findings:
        print(regress.format_findings(findings))
    else:
        print("no regressions")
    return code


if __name__ == "__main__":
    sys.exit(main())
