"""One-command invariant audit of an engine-variant run; the port of
`tools/audit.py` (its arguments, exit codes and output, with
``--device``, default ``cuda``).

Runs one protocol configuration with the conservation-law monitors ON
(`wittgenstein_tpu_torch/obs/audit.py`) and prints the verdict:
clean runs state what was proved (which invariants, over which span),
violated runs print the per-invariant counts and the first-violation
``(ms, invariant, index, observed, expected)`` record — the same
localization `tools/divergence.py` produces for bit-identity breaks,
but continuous and single-run (no reference variant needed).

    # prove a clean 400 ms batched-K4 Handel window
    python -m wittgenstein_tpu_torch.cli.audit --proto handel --ms 400 \
        --variant superstep=4,batched --latency 'NetworkFixedLatency(16)'

    # plant a fault and watch the audit catch it (exit code 1)
    python -m wittgenstein_tpu_torch.cli.audit --proto pingpong --ms 128 \
        --inject 37:nodes.msg_sent:5:-1048576

Variant syntax matches `cli/divergence.py` (comma-separated
``key[=value]`` over superstep / batched / fast_forward).  Exit code 0
when the run audits clean, 1 when a violation is found (and printed),
2 on configuration errors — so CI can gate on it.  Every audited run
appends a `RunManifest` row to the ledger (``WTPU_LEDGER=0`` skips).
"""

from __future__ import annotations

import argparse
import os
import sys

from .divergence import make_protocol, parse_variant


def parse_inject(s: str):
    """``"37:nodes.msg_sent:5:-1048576"`` -> (ms, leaf, node, delta)."""
    parts = s.split(":")
    if len(parts) != 4:
        raise ValueError(
            f"--inject wants ms:leaf:node:delta, got {s!r}")
    return int(parts[0]), parts[1], int(parts[2]), int(parts[3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.audit",
        description="run the compiled invariant monitors over one "
                    "engine-variant configuration")
    ap.add_argument("--proto", default="handel",
                    help="handel | pingpong | p2pflood | dfinity")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--ms", type=int, default=400,
                    help="simulated span to audit")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--variant", default="superstep=1", metavar="VARIANT")
    ap.add_argument("--mode", default="first", choices=("count", "first"))
    ap.add_argument("--latency", default=None,
                    help="latency model by registry name, e.g. "
                         "'NetworkFixedLatency(16)'")
    ap.add_argument("--inject", default=None, metavar="MS:LEAF:NODE:DELTA",
                    help="plant a FaultInjector perturbation (the audit "
                         "self-test: the verdict must flag it)")
    ap.add_argument("--device", default=None,
                    help="the device the run takes (default cuda)")
    args = ap.parse_args(argv)

    try:
        variant = parse_variant(args.variant)
        proto = make_protocol(args.proto, args.nodes, args.latency,
                              args.device)
        inject = parse_inject(args.inject) if args.inject else None
    except (ValueError, KeyError) as e:
        print(f"audit: {e}", file=sys.stderr)
        return 2

    from ..obs import ledger
    from ..obs.audit import AuditSpec
    from ..obs.audit_report import audit_variant
    from ..obs.diff import FaultInjector

    if inject is not None:
        at_ms, leaf, node, delta = inject
        proto = FaultInjector(proto, at_ms=at_ms, leaf=leaf, node=node,
                              delta=delta)
    spec = AuditSpec(mode=args.mode)
    print(f"audit: {args.proto} n={proto.cfg.n} over {args.ms} ms, "
          f"variant={variant} mode={args.mode}"
          + (f" inject={args.inject}" if inject else ""),
          file=sys.stderr)
    try:
        report, _ = audit_variant(proto, args.ms, variant, spec,
                                  seeds=args.seeds,
                                  first_seed=args.seed0)
    except ValueError as e:
        print(f"audit: {e}", file=sys.stderr)
        return 2

    print(report.format())
    if os.environ.get("WTPU_LEDGER", "1") != "0":
        blk = report.stats()
        config = {"proto": args.proto, "nodes": proto.cfg.n,
                  "ms": args.ms, "variant": variant,
                  "mode": args.mode, "latency": args.latency,
                  "inject": args.inject, "seeds": args.seeds,
                  "seed0": args.seed0}
        mani = ledger.manifest_from_bench(
            {"audit": blk, "sim_ms": args.ms,
             "superstep": variant.get("superstep", 1)},
            config=dict(config, engine="audit_cli"), label="audit_cli")
        ledger.append(mani)
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
