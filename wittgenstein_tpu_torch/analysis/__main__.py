"""CLI: run the analysis rules against the checked-in budgets — the
port's copy of `python -m wittgenstein_tpu.analysis`, with the same
arguments, report and exit codes, and ``--device``.

    python -m wittgenstein_tpu_torch.analysis --device cpu   # all rules
    python -m wittgenstein_tpu_torch.analysis --protocol Handel \\
        --rule carry_copy --device cpu
    python -m wittgenstein_tpu_torch.analysis --source   # source rules
    python -m wittgenstein_tpu_torch.analysis --json report.json
    python -m wittgenstein_tpu_torch.analysis --update-budgets --device cpu

``--source`` runs only the global rules (determinism, the host-plane
family host_locks, host_durability, host_digest, host_except, and the
kernels' shared-memory models): no protocol chunk runs, no device is
needed, seconds — the mode of `cli/bench_suite.py analysis_smoke`.

The targets' chunks run on ``--device`` (``cuda`` by default, as every
entry point of the port: with no card the run refuses; pass ``--device
cpu`` to run the plain PyTorch versions).  Budgets are measured on the
CPU; on a card only each rule's device-independent metrics are gated
(framework.check_budget).

Exit code 0 iff no error findings.  The ``--json`` payload is the JAX
package's schema 2 (framework.REPORT_SCHEMA).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from . import framework, targets

    framework._install_rules()
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.analysis",
        description="op-stream/source lints over every protocol's "
                    "recorded chunk, plus host-plane source rules")
    ap.add_argument("--protocol", action="append", metavar="NAME",
                    help="restrict to protocol(s) (repeatable; default all)")
    ap.add_argument("--rule", action="append", metavar="NAME",
                    choices=sorted(framework.RULES),
                    help="restrict to rule(s) (repeatable; default all)")
    ap.add_argument("--source", action="store_true",
                    help="source rules only: skip every protocol target "
                         "(fast, no device)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report to PATH "
                         "('-' for stdout; schema: see module docstring)")
    ap.add_argument("--update-budgets", action="store_true",
                    help="ratchet analysis/budgets.json down to the "
                         "measured values (never up)")
    ap.add_argument("--list", action="store_true",
                    help="list each rule's scope and target count, "
                         "then exit")
    ap.add_argument("--device", default=None,
                    help="device the targets' chunks run on (default "
                         "cuda; 'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.list:
        names = targets.target_names()
        print(f"rules ({len(framework.RULES)}):")
        for name in sorted(framework.RULES):
            rule = framework.RULES[name]
            desc = rule.describe() if rule.scope == "global" \
                else f"{len(names)} recorded protocol targets"
            print(f"  {name:22s} {rule.scope:9s} {desc}")
        print(f"targets ({len(names)}): {' '.join(names)}")
        return 0

    if args.protocol and args.source:
        ap.error("--source runs no protocol targets; drop --protocol")

    device = "cpu"
    if not args.source:
        from ..core.state import resolve_device
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            ap.error(str(e))
        known = set(targets.target_names())
        for name in args.protocol or ():
            if name not in known:
                ap.error(f"unknown protocol {name!r}; known: "
                         f"{' '.join(sorted(known))}")
        if args.update_budgets and device.type != "cpu":
            ap.error("budgets are measured on the CPU: --update-budgets "
                     "needs --device cpu")
        if device.type == "cpu":
            # 64-node chunks: PyTorch's intra-op threads only fight over
            # the cores (about half the wall at one thread)
            import torch
            torch.set_num_threads(1)

    def progress(msg):
        print(f"[analysis] {msg}", file=sys.stderr, flush=True)

    report = framework.run_analysis(target_names=args.protocol,
                                    rule_names=args.rule,
                                    progress=progress,
                                    source_only=args.source,
                                    device=device)

    for f in report.findings:
        if f.severity != "info":
            where = f.span() or f.target
            print(f"{f.severity.upper():8s} {f.rule:16s} {where}: "
                  f"{f.message}")
    info = sum(1 for f in report.findings if f.severity == "info")
    warn = sum(1 for f in report.findings if f.severity == "warning")
    what = "source rules" if args.source else \
        f"{len(report.targets)} targets x {len(report.rules)} rules"
    print(f"[analysis] {what}: {len(report.errors)} errors, "
          f"{warn} warnings, {info} checks passed")

    if args.update_budgets:
        budgets = framework.load_budgets()
        framework.ratchet_budgets(report.findings, budgets, framework.RULES)
        framework.save_budgets(budgets)
        print(f"[analysis] budgets ratcheted -> {framework.BUDGETS_PATH}")

    if args.json:
        payload = json.dumps(report.to_json(), indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as fh:
                fh.write(payload + "\n")

    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
