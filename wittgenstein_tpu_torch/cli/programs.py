"""Render a program catalog: what did this host run cold, and what did
it cost?  The port of `tools/programs.py`.

The program observatory (`wittgenstein_tpu_torch/obs/programs.py`)
leaves one ``programs*.jsonl`` per catalog-attached process: one durable
row per (compile key, plane) carrying the backend, the first launch's
wall, the memory block (argument / output / alias bytes, and on the card
the first launch's working set ``temp_bytes``) and each kernel's
launches over that chunk.  This CLI reads a file or globs a run
directory (dead workers' torn tails and a JAX worker's rows included)
and prints the report the serve plane serves live at ``GET
/w/batch/programs``:

  * the top compile-wall consumers (the first launches' walls),
  * the bytes-per-program table (temp / argument / output / alias),
  * the working-set outliers (``temp_ratio = temp_bytes /
    argument_bytes``, the largest first).

    # a fleet run directory (programs-w0.jsonl, programs-w1.jsonl...)
    python -m wittgenstein_tpu_torch.cli.programs reports/fleet_run

    # one worker's catalog, machine-readable
    python -m wittgenstein_tpu_torch.cli.programs \
        reports/run/programs-w0.jsonl --json

Exit code 0 on success, 2 when no catalog rows are found (nothing to
render is a configuration error, not an empty observatory).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..obs.programs import read_catalog, summarize_programs


def collect_rows(target) -> tuple[list, list]:
    """Every catalog row under `target`: a JSONL file is read as-is, a
    directory is globbed recursively for ``programs*.jsonl`` (the fleet
    layout: one catalog per worker)."""
    if os.path.isdir(target):
        files = sorted(glob.glob(os.path.join(target, "**",
                                              "programs*.jsonl"),
                                 recursive=True))
    else:
        files = [target] if os.path.exists(target) else []
    rows = []
    for f in files:
        rows.extend(read_catalog(f))
    return rows, files


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:d}B"
        n /= 1024
    return str(n)


def _fmt_launches(row) -> str:
    launches = (row.get("cost") or {}).get("launches") or {}
    return ",".join(f"{k}={v}" for k, v in sorted(launches.items()) if v) \
        or "-"


def render(rep: dict, files: list) -> str:
    lines = [f"{rep['count']} program(s) from {len(files)} catalog "
             f"file(s); compile wall total "
             f"{rep['compile_wall_total_s']:.2f}s", ""]
    lines.append("top compile-wall consumers:")
    for t in rep["top_compile"]:
        lines.append(f"  {t['key']}  plane={t['plane']}  "
                     f"{t['compile_wall_s']:.3f}s")
    lines.append("")
    lines.append("bytes per program:")
    lines.append(f"  {'key':<18} {'plane':<9} {'backend':<8} "
                 f"{'compile_s':>9} {'temp':>10} {'args':>10} "
                 f"{'output':>10} {'alias':>10}  launches")
    for r in rep["programs"]:
        mem = r.get("memory") or {}
        lines.append(
            f"  {str(r.get('key')):<18} {str(r.get('plane')):<9} "
            f"{str(r.get('backend')):<8} "
            f"{(r.get('compile_wall_s') or 0):>9.3f} "
            f"{_fmt_bytes(mem.get('temp_bytes')):>10} "
            f"{_fmt_bytes(mem.get('argument_bytes')):>10} "
            f"{_fmt_bytes(mem.get('output_bytes')):>10} "
            f"{_fmt_bytes(mem.get('alias_bytes')):>10}  "
            f"{_fmt_launches(r)}")
    if rep["drift_outliers"]:
        lines.append("")
        lines.append("working-set outliers (first-launch temp / "
                     "argument bytes):")
        for d in rep["drift_outliers"]:
            extra = ""
            if d.get("chunk_wall_mean_s") is not None:
                extra = (f"  chunk_mean={d['chunk_wall_mean_s']:.4f}s"
                         f" over {d['chunks']} chunk(s)")
            lines.append(
                f"  {d['key']}  plane={d['plane']}  "
                f"ratio={d['temp_ratio']:g}  "
                f"({_fmt_bytes(d['temp_bytes'])} vs "
                f"{_fmt_bytes(d['argument_bytes'])})" + extra)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a program-catalog JSONL (or a run "
        "directory of them) into the /w/batch/programs report")
    ap.add_argument("target", help="a programs*.jsonl file or a run "
                    "directory to glob")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object")
    args = ap.parse_args(argv)

    rows, files = collect_rows(args.target)
    if not rows:
        print(f"programs: no catalog rows under {args.target}",
              file=sys.stderr)
        return 2
    rep = summarize_programs(rows)
    rep["files"] = files
    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    else:
        print(render(rep, files))
    return 0


if __name__ == "__main__":
    sys.exit(main())
