"""Render a run's host span logs into one Perfetto timeline; the port of
`tools/timeline.py` (it runs no engine: ``--device`` names device
Perfetto JSON files to merge, as in the root tool).

The host-plane flight recorder (`wittgenstein_tpu_torch/obs/spans.py`,
whose rows are the JAX package's) leaves
one ``spans-<worker>.jsonl`` per instrumented process — the serve
scheduler's request lifecycle (submit / queue-wait / compile / launch /
chunk / settle), the fleet workers' lease traffic (claim / renew /
adopt), and the crash-replay marks.  This CLI globs every span log
under a run directory (dead workers' torn tails included — the reader
is tail-tolerant), merges them into one Perfetto JSON via
`obs.export.spans_to_perfetto` (one process per worker, one track per
request), and prints a text critical-path summary: per-phase p50/p99
and the top wall-time consumers by phase and by request.

    # a serve_load or crash_test --timeline DIR run
    python -m wittgenstein_tpu_torch.cli.timeline reports/timeline_demo

    # merge the device lanes (engine metrics / trace-ring Perfetto
    # JSON produced by obs.export.to_perfetto / trace_to_perfetto)
    python -m wittgenstein_tpu_torch.cli.timeline DIR --device DIR/device.json

Exit code 0 on success, 2 when no span rows are found (nothing to
render is a configuration error, not an empty timeline).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys

from ..obs.export import spans_to_perfetto
from ..obs.spans import _quantile, read_spans


def collect_spans(root) -> tuple[list, list]:
    """Every span row under `root` (recursive ``spans*.jsonl`` glob),
    plus the list of files they came from.  A file may be a dead
    worker's torn tail — `read_spans` already tolerates that."""
    pattern = os.path.join(str(root), "**", "spans*.jsonl")
    files = sorted(glob.glob(pattern, recursive=True))
    rows = []
    for f in files:
        rows.extend(read_spans(f))
    return rows, files


def load_device(paths) -> list:
    """Load pre-rendered device Perfetto JSON files (.gz tolerated)
    for merging onto the host timeline."""
    traces = []
    for p in paths:
        opener = gzip.open if str(p).endswith(".gz") else open
        with opener(p, "rt") as f:
            traces.append(json.load(f))
    return traces


def summarize(rows) -> str:
    """The text critical-path summary: per-phase count/p50/p99/total
    wall, then the top wall consumers by phase and by request id."""
    by_name: dict = {}
    by_rid: dict = {}
    for r in rows:
        dur = float(r.get("dur", 0.0))
        by_name.setdefault(r["name"], []).append(dur)
        rid = r.get("rid")
        if rid is not None:
            by_rid[rid] = by_rid.get(rid, 0.0) + dur
    lines = ["phase                        count    p50_ms    p99_ms  total_s"]
    for name in sorted(by_name):
        durs = sorted(by_name[name])
        lines.append(
            f"{name:<28} {len(durs):>5} {1e3 * _quantile(durs, 0.5):>9.3f}"
            f" {1e3 * _quantile(durs, 0.99):>9.3f} {sum(durs):>8.3f}")
    top_names = sorted(by_name, key=lambda n: -sum(by_name[n]))[:5]
    lines.append("")
    lines.append("top wall consumers (by phase):")
    for name in top_names:
        lines.append(f"  {name:<28} {sum(by_name[name]):>8.3f} s")
    if by_rid:
        lines.append("top wall consumers (by request):")
        for rid in sorted(by_rid, key=lambda r: -by_rid[r])[:5]:
            lines.append(f"  {rid:<28} {by_rid[rid]:>8.3f} s")
    # compile spans carry their compile key (instrument.SPAN_COMPILE)
    # — name the top compile-wall keys so "where did the build minutes
    # go" is answerable from the summary alone (cli/programs.py has the
    # full per-program story)
    by_key: dict = {}
    for r in rows:
        if r.get("name") == "serve.compile" and r.get("key"):
            by_key[r["key"]] = by_key.get(r["key"], 0.0) \
                + float(r.get("dur", 0.0))
    if by_key:
        lines.append("top compile-wall compile keys:")
        for key in sorted(by_key, key=lambda k: -by_key[k])[:3]:
            lines.append(f"  {key:<28} {by_key[key]:>8.3f} s")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.timeline",
        description="merge host span logs into one Perfetto timeline")
    ap.add_argument("run_dir", help="run/journal directory holding "
                    "spans*.jsonl logs (searched recursively)")
    ap.add_argument("--out", default=None,
                    help="Perfetto JSON output path "
                    "(default: <run_dir>/timeline.json)")
    ap.add_argument("--device", action="append", default=[],
                    help="device Perfetto JSON (to_perfetto / "
                    "trace_to_perfetto output) to merge; repeatable")
    ap.add_argument("--name", default="wtpu host",
                    help="process-name prefix on the host tracks")
    args = ap.parse_args(argv)

    rows, files = collect_spans(args.run_dir)
    if not rows:
        print(f"timeline: no span rows under {args.run_dir} "
              "(expected spans*.jsonl)", file=sys.stderr)
        return 2
    out = args.out or os.path.join(args.run_dir, "timeline.json")
    trace = spans_to_perfetto(rows, device=load_device(args.device),
                              path=out, name=args.name)
    workers = sorted({r.get("worker") or "host" for r in rows})
    print(f"timeline: {len(rows)} spans from {len(files)} log(s), "
          f"{len(workers)} worker(s) -> {out} "
          f"({len(trace['traceEvents'])} events)")
    print()
    print(summarize(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
