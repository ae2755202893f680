"""One-command memo verification: fork a campaign, prove bit-identity;
the port of `tools/memo.py` (its arguments, exit codes and output, with
``--device``, default ``cuda``).

Runs a sweep grid TWICE through the serve scheduler — once plain, once
with the memo subsystem (snapshot-fork shared honest prefixes,
optionally a cross-run memo table) — and compares every cell
bit-for-bit: final state pytrees, metrics/trace/audit artifact blocks,
and the normalized `MatrixReport`s.  On a divergence it prints the
per-cell mismatches AND drives the `first_divergence` bisector
over the cell's engine configuration against the dense per-ms
reference, so "memo broke bit-identity" arrives with the first
divergent millisecond, leaf and node attached.

Exit codes (the `cli/chaos.py` convention):
  0  bit-identical: every forked cell's state and artifacts equal the
     unmemoized run's, prefix_chunks_saved matches the fork plan's
     prediction
  1  divergence: any state/artifact/report mismatch (printed, with the
     bisector's localization)
  2  configuration error: malformed grid JSON, a cell that fails
     validation, an unwritable table directory

    # the built-in smoke grid, with a cross-run table
    python -m wittgenstein_tpu_torch.cli.memo --table reports/memo

    # your own campaign
    python -m wittgenstein_tpu_torch.cli.memo --grid grid.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _default_grid():
    """The default grid — small, chaos-axis, 3-chunk shared prefix: the
    port's `cli/bench_suite.MEMO_SMOKE_GRID`."""
    from .bench_suite import MEMO_SMOKE_GRID
    return MEMO_SMOKE_GRID


def _load_grid_json(arg: str):
    if arg == "-":
        return json.load(sys.stdin)
    if arg.lstrip().startswith("{"):
        return json.loads(arg)
    with open(arg) as f:
        return json.load(f)


#: artifact keys that honestly differ between memoized and unmemoized
#: runs: run-local accounting (wall, scheduler/registry counters,
#: request ids), the fork provenance itself, and the fast-forward skip
#: stats (they record the work THIS run performed — a forked run
#: performs less; the trajectory artifacts are what bit-identity pins)
ARTIFACT_VOLATILE = ("wall_s", "resilience", "registry", "request",
                     "forked_from", "memo", "fast_forward")


def _strip(art: dict) -> dict:
    return {k: v for k, v in art.items() if k not in ARTIFACT_VOLATILE}


def _bisect(spec, mism: list, device):
    """Localize a reported divergence: run the cell's engine variant
    against the dense per-ms reference with the bisector and
    print the first divergent window (or state that the variant itself
    is internally clean, pointing the finger at the memo layer)."""
    from ..obs.diff import first_divergence

    for m in mism:
        print(f"  {m}")
    variant = {"superstep": spec.superstep,
               "batched": spec.engine == "batched",
               "fast_forward": spec.engine == "fast_forward"}
    proto = spec.build_protocol(device=device)
    div = first_divergence(proto, variant, {"superstep": 1},
                           spec.sim_ms, chunk_ms=spec.chunk_ms,
                           seeds=len(spec.seeds),
                           first_seed=int(spec.seeds[0]))
    if div is None:
        print("  bisector: the cell's engine variant is bit-identical "
              "to the dense per-ms reference over the whole span — "
              "the divergence is in the memo fork/stitch layer, not "
              "the engine")
    else:
        print("  bisector (engine variant vs dense per-ms reference):")
        print("  " + div.format().replace("\n", "\n  "))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.memo",
        description="memoized-supersteps bit-identity verifier "
                    "(snapshot-fork vs plain runs)")
    ap.add_argument("--grid", default=None, metavar="JSON|PATH|-",
                    help="SweepGrid JSON (file, inline, or '-'); "
                         "default: the built-in memo smoke grid")
    ap.add_argument("--table", default=None, metavar="DIR",
                    help="cross-run memo table directory (prefix "
                         "states + carries reused across invocations)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="RunManifest JSONL for the two runs (default: "
                         "a temp file — the verifier must not pollute "
                         "the shared ledger)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-cell OK lines")
    ap.add_argument("--device", default=None,
                    help="the device both runs take (default cuda)")
    args = ap.parse_args(argv)

    from ..core.state import resolve_device
    from ..matrix import SweepGrid, plan, run_grid
    from ..memo import MemoConfig, plan_prefixes
    from ..serve import Scheduler
    from ..server.core import load_models
    load_models()
    dev = resolve_device(args.device)

    try:
        raw = _load_grid_json(args.grid) if args.grid \
            else _default_grid()
        grid = SweepGrid.from_json(raw)
        mplan = plan(grid)
        fplan = plan_prefixes(mplan)
        memo_cfg = MemoConfig(table=args.table)
        if args.table:
            pathlib.Path(args.table).mkdir(parents=True, exist_ok=True)
    except (ValueError, OSError, json.JSONDecodeError, TypeError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    print(f"grid {grid.name!r} [{grid.grid_digest()}]: "
          f"{len(mplan.cells)} cells, {len(fplan.groups)} fork "
          f"group(s), predicted prefix_chunks_saved = "
          f"{fplan.predicted_chunks_saved}")
    for why in fplan.skipped.values():
        print(f"  (not forked: {why})")

    import tempfile

    import torch
    from torch.utils import _pytree as pytree

    with tempfile.TemporaryDirectory() as tmp:
        led = args.ledger
        ref = run_grid(grid, Scheduler(
            ledger_path=led or f"{tmp}/ref.jsonl", device=dev),
            plan_=mplan)
        mem = run_grid(grid, Scheduler(
            ledger_path=led or f"{tmp}/memo.jsonl", device=dev),
            plan_=mplan, memo=memo_cfg)
    blk = mem.report.data.get("memo") or {}
    print(f"memo: {blk.get('forked_cells', 0)} cells forked, "
          f"{blk.get('prefix_runs', 0)} prefix runs, "
          f"{blk.get('table_hits', 0)} table hits, "
          f"prefix_chunks_saved = {blk.get('prefix_chunks_saved', 0)}")

    rc = 0
    for cid in (c.id for c in mplan.cells):
        mism = []
        ra, ma = ref.artifacts.get(cid), mem.artifacts.get(cid)
        if ra is None or ma is None:
            mism.append("cell errored in one of the runs "
                        f"(ref={'ok' if ra else 'missing'}, "
                        f"memo={'ok' if ma else 'missing'})")
        else:
            for a, b in zip(pytree.tree_leaves(ref.states[cid]),
                            pytree.tree_leaves(mem.states[cid])):
                if not torch.equal(a, b):
                    mism.append("final-state pytree differs between "
                                "the memoized and plain runs")
                    break
            sa, sb = _strip(ra), _strip(ma)
            if sa != sb:
                mism += [f"artifact block {k!r} differs"
                         for k in sa if sa.get(k) != sb.get(k)]
        if mism:
            rc = 1
            print(f"DIVERGENCE {cid}:")
            _bisect(mplan.resolved[cid], mism, dev)
        elif not args.quiet:
            fk = (ma or {}).get("forked_from")
            print(f"  {cid}: bit-identical"
                  + (f" (forked from {fk['prefix_digest']} @ "
                     f"{fk['fork_ms']} ms)" if fk else " (not forked)"))
    if rc == 0:
        saved, want = (blk.get("prefix_chunks_saved", 0),
                       fplan.predicted_chunks_saved)
        vetoed = blk.get("fork_vetoed", 0)
        if vetoed:
            # a veto is the SOUNDNESS gate working (the cell ran
            # unforked and still verified bit-identical above) — the
            # accounting legitimately falls short of the prediction
            print(f"note: {vetoed} fork(s) vetoed by the chaos-no-op "
                  f"gate; prefix_chunks_saved {saved} < predicted "
                  f"{want} is expected for this grid")
        elif blk.get("table_hits", 0) == 0 and saved != want:
            print(f"DIVERGENCE: prefix_chunks_saved {saved} != the "
                  f"plan's prediction {want} with no vetoes and no "
                  "table hits — the driver lost planned forks")
            rc = 1
    print("CLEAN: memoized run bit-identical to the plain run"
          if rc == 0 else "memo bit-identity VIOLATED (see above)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
