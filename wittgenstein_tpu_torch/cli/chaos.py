"""One-command chaos-plane check: cross-engine identity, audit verdict
and impact report for a declarative `FaultSchedule`; the port of
`tools/chaos.py` (its arguments, exit codes and output, with
``--device``, default ``cuda``).

Two modes, both exit-code-gated for CI:

  * with faults given (--churn / --partition / --loss / --delay, or one
    --schedule JSON): runs the FAULTED configuration through the dense
    per-ms engine and the --b engine variant and bisects them with the
    `first_divergence` machinery — the chaos plane's contract is
    that one (schedule, seed) yields bit-identical trajectories in
    every engine — then runs the compiled invariant monitors over the
    faulted trajectory (audit verdicts must stay clean under
    churn/partition) and prints the impact vs the fault-free baseline
    (done/live/message deltas: what the adversity actually cost).
  * with NO faults: the zero-residue pin — the chaos-plane wrap with an
    EMPTY schedule must be bit-identical to the unwrapped protocol
    (`first_divergence` between the two returns none).

Exit 0 when clean (bit-identical + audit clean), 1 when a divergence
or audit violation is found (and printed), 2 on configuration errors.

    # churn + mid-run partition, dense vs superstep-2, with impact
    python -m wittgenstein_tpu_torch.cli.chaos --proto pingpong --ms 240 \
        --churn 3:20:60 --churn 5:40:100 --partition 30:90:1:0:32 \
        --b superstep=2

    # message loss + delay inflation against the fast-forward engine
    python -m wittgenstein_tpu_torch.cli.chaos --proto pingpong --ms 240 \
        --loss 0:240:250 --delay 10:50:3 --b fast_forward

    # the zero-residue pin
    python -m wittgenstein_tpu_torch.cli.chaos --proto pingpong --ms 240
"""

from __future__ import annotations

import argparse
import json
import sys

from .divergence import make_protocol, parse_variant


def _parse_window(kind: str, s: str, n: int):
    """``"a:b:c[:slo:shi:dlo:dhi]"`` -> a full event tuple; the link
    ranges default to all nodes."""
    parts = [int(x) for x in s.split(":")]
    if kind == "churn":
        if len(parts) != 3:
            raise ValueError(f"--churn wants node:down_ms:up_ms, got {s!r}")
        return tuple(parts)
    if kind == "partition":
        if len(parts) != 5:
            raise ValueError(
                f"--partition wants start:end:part_id:lo:hi, got {s!r}")
        return tuple(parts)
    # loss / delay: start:end:value with optional link ranges
    if len(parts) == 3:
        return tuple(parts) + (0, n, 0, n)
    if len(parts) == 7:
        return tuple(parts)
    raise ValueError(f"--{kind} wants start:end:value"
                     f"[:src_lo:src_hi:dst_lo:dst_hi], got {s!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.chaos",
        description="cross-engine identity + audit + impact for a "
                    "declarative fault schedule")
    ap.add_argument("--proto", default="pingpong",
                    help="handel | pingpong | p2pflood | dfinity")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--ms", type=int, default=240,
                    help="simulated span")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--b", default="superstep=2", metavar="VARIANT",
                    help="engine variant to check against the dense "
                         "per-ms engine (cli/divergence.py syntax)")
    ap.add_argument("--latency", default=None,
                    help="latency model by registry name")
    ap.add_argument("--schedule", default=None, metavar="JSON",
                    help="a full FaultSchedule as inline JSON "
                         "(overrides the per-class flags)")
    ap.add_argument("--churn", action="append", default=[],
                    metavar="NODE:DOWN:UP")
    ap.add_argument("--partition", action="append", default=[],
                    metavar="START:END:PID:LO:HI")
    ap.add_argument("--loss", action="append", default=[],
                    metavar="START:END:PERMILLE[:LINK]")
    ap.add_argument("--delay", action="append", default=[],
                    metavar="START:END:EXTRA[:LINK]")
    ap.add_argument("--device", default=None,
                    help="the device the runs take (default cuda)")
    args = ap.parse_args(argv)

    from ..chaos import ChaosProtocol, FaultSchedule, impact_summary
    from ..obs.audit import AuditSpec
    from ..obs.audit_report import audit_variant
    from ..obs.diff import first_divergence

    try:
        proto = make_protocol(args.proto, args.nodes, args.latency,
                              args.device)
        variant_b = parse_variant(args.b)
        if args.schedule is not None:
            sched = FaultSchedule.from_json(args.schedule)
        else:
            n = proto.cfg.n
            sched = FaultSchedule(
                churn=tuple(_parse_window("churn", s, n)
                            for s in args.churn),
                partitions=tuple(_parse_window("partition", s, n)
                                 for s in args.partition),
                loss=tuple(_parse_window("loss", s, n)
                           for s in args.loss),
                delay=tuple(_parse_window("delay", s, n)
                            for s in args.delay))
        sched.validate(n=proto.cfg.n, sim_ms=args.ms)
    except (ValueError, KeyError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    if sched.empty:
        # zero-residue pin: the wrap with an empty schedule IS the
        # unwrapped protocol, bit for bit
        print(f"no faults given — checking the empty-schedule "
              f"zero-residue pin over {args.ms} ms ...")
        div = first_divergence(
            proto, {"superstep": 1}, {"superstep": 1},
            args.ms, seeds=args.seeds, first_seed=args.seed0,
            protocol_b=ChaosProtocol(proto, sched))
        if div is None:
            print("CLEAN: chaos-plane wrap (empty schedule) is "
                  "bit-identical to the unwrapped engine")
            return 0
        print("DIVERGENCE vs the fault-free baseline:")
        print(div.format())
        return 1

    cp = ChaosProtocol(proto, sched)
    print(f"schedule: {json.dumps(sched.to_json())}")
    print(f"cross-engine check: dense per-ms vs {args.b} over "
          f"{args.ms} ms, {args.seeds} seed(s) ...")
    div = first_divergence(cp, {"superstep": 1}, variant_b, args.ms,
                           seeds=args.seeds, first_seed=args.seed0)
    if div is not None:
        print("DIVERGENCE between engine variants under this schedule:")
        print(div.format())
        return 1
    print("bit-identical across variants.")

    report, (nets, _) = audit_variant(cp, args.ms, {"superstep": 1},
                                      AuditSpec(), seeds=args.seeds,
                                      first_seed=args.seed0)
    _, (nets0, _) = audit_variant(proto, args.ms, {"superstep": 1},
                                  AuditSpec(), seeds=args.seeds,
                                  first_seed=args.seed0)
    faulted, base = impact_summary(nets), impact_summary(nets0)
    print("impact vs fault-free baseline:")
    for k in faulted:
        delta = faulted[k] - base[k]
        print(f"  {k:>14}: {faulted[k]:>8}  (baseline {base[k]}, "
              f"{delta:+d})")
    if not report.clean:
        print("AUDIT VIOLATIONS under the schedule:")
        print(report.format())
        return 1
    print(f"audit CLEAN over the faulted trajectory "
          f"({', '.join(report.monitored)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
