"""One-command first-divergence triage between two engine variants; the
port of `tools/divergence.py` (its arguments, exit codes and output, with
``--device``, default ``cuda``).

Runs two engine-variant configurations of one protocol side by side,
bisects the first simulated ms where their state pytrees diverge,
localizes the first differing (pytree leaf, element), and prints the
decoded flight-recorder window around it from BOTH runs — the
message-level context (sends, deliveries, drops, jumps) that turns a
day of print-and-rerun bisecting into one command.

    # is the batched K=4 window engine bit-identical to the dense scan?
    python -m wittgenstein_tpu_torch.cli.divergence --proto handel --ms 400 \
        --a superstep=1 --b superstep=4,batched \
        --latency 'NetworkFixedLatency(16)'

    # quiet-window engine vs dense, two seeds, wider trace window
    python -m wittgenstein_tpu_torch.cli.divergence --proto pingpong --nodes 256 --ms 600 \
        --a superstep=1 --b fast_forward --seeds 2 --pad 8

Variant syntax: comma-separated ``key[=value]`` over superstep /
batched / fast_forward (bare key = true).  Exit code 0 when the runs
are bit-identical, 1 when a divergence is found (and printed), 2 on
configuration errors — so CI can gate on it.
"""

from __future__ import annotations

import argparse
import sys


def parse_variant(s: str) -> dict:
    """``"superstep=4,batched"`` -> {"superstep": 4, "batched": True}."""
    from ..obs.diff import VARIANT_KEYS

    out = {}
    for part in filter(None, (p.strip() for p in s.split(","))):
        key, _, val = part.partition("=")
        if key not in VARIANT_KEYS:
            raise ValueError(f"unknown variant key {key!r}; known: "
                             f"{', '.join(VARIANT_KEYS)}")
        if not val:
            out[key] = True
        elif val.lower() in ("true", "false"):
            out[key] = val.lower() == "true"
        else:
            out[key] = int(val)
    return out


def make_protocol(name: str, nodes: int, latency: str | None,
                  device=None):
    """The bench protocol registry (mirrors bench.py's selection), on
    `device` (``cuda`` unless given)."""
    kw = {"device": device}
    if latency:
        kw["network_latency_name"] = latency
    if name == "handel":
        from ..models.handel import Handel
        down = nodes // 10
        return Handel(node_count=nodes,
                      threshold=int(0.99 * (nodes - down)),
                      nodes_down=down, pairing_time=4,
                      level_wait_time=50, dissemination_period_ms=20,
                      fast_path=10, **kw)
    if name == "pingpong":
        from ..models.pingpong import PingPong
        if latency:
            from ..core import latency as lat_mod
            kw = {"latency": lat_mod.get_by_name(latency),
                  "device": device}
        return PingPong(node_count=nodes, **kw)
    if name == "p2pflood":
        from ..models.p2pflood import P2PFlood
        return P2PFlood(node_count=nodes, dead_node_count=nodes // 10,
                        peers_count=8, delay_before_resent=1,
                        delay_between_sends=1, **kw)
    if name == "dfinity":
        from ..models.dfinity import Dfinity
        return Dfinity(**kw)
    raise ValueError(f"unknown protocol {name!r}; known: handel "
                     "pingpong p2pflood dfinity")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.cli.divergence",
        description="bisect the first bit-identity divergence between "
                    "two engine-variant configurations")
    ap.add_argument("--proto", default="handel",
                    help="handel | pingpong | p2pflood | dfinity")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--ms", type=int, default=400,
                    help="simulated span to compare")
    ap.add_argument("--chunk", type=int, default=None,
                    help="coarse-pass chunk (default: auto)")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--a", default="superstep=1", metavar="VARIANT")
    ap.add_argument("--b", default="superstep=2", metavar="VARIANT")
    ap.add_argument("--latency", default=None,
                    help="latency model by registry name, e.g. "
                         "'NetworkFixedLatency(16)'")
    ap.add_argument("--trace-cap", type=int, default=4096)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the traced replay (states only)")
    ap.add_argument("--pad", type=int, default=4,
                    help="trace window padding around the divergence, ms")
    ap.add_argument("--limit", type=int, default=40,
                    help="max printed trace events per side")
    ap.add_argument("--device", default=None,
                    help="the device both runs take (default cuda)")
    args = ap.parse_args(argv)

    try:
        variant_a = parse_variant(args.a)
        variant_b = parse_variant(args.b)
        proto = make_protocol(args.proto, args.nodes, args.latency,
                              args.device)
    except (ValueError, KeyError) as e:
        print(f"divergence: {e}", file=sys.stderr)
        return 2

    from ..obs.diff import first_divergence
    from ..obs.trace import TraceSpec

    print(f"divergence: {args.proto} n={proto.cfg.n} over {args.ms} ms, "
          f"A={variant_a} vs B={variant_b}", file=sys.stderr)
    div = first_divergence(
        proto, variant_a, variant_b, args.ms, chunk_ms=args.chunk,
        seeds=args.seeds, first_seed=args.seed0,
        trace_spec=False if args.no_trace
        else TraceSpec(capacity=args.trace_cap),
        trace_pad_ms=args.pad)
    if div is None:
        print(f"bit-identical over {args.ms} ms — no divergence")
        return 0
    print(div.format(trace_limit=args.limit))
    return 1


if __name__ == "__main__":
    sys.exit(main())
