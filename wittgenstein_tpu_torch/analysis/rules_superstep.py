"""Rule ``superstep_amortization`` — sort/scatter fixed cost per
simulated millisecond in the recorded chunk (the port's counterpart of
`wittgenstein_tpu/analysis/rules_superstep.py`).

The engine's per-ms fixed cost — sorts and scatters — is what the K-ms
superstep (core/network.step_kms) amortizes: one binning pass and one
routing pass serve K simulated milliseconds.  This rule counts the sort
ops (``sort``, ``argsort``) and scatter ops (``scatter*``,
``index_put_``, ``index_add_``) the chunk dispatches and divides by the
simulated ms it advances, so an engine change that sneaks a sort into
the window, or a protocol change that un-fuses the binning, fails the
gate with the measured count.  The kernels are single ops in the
recording (`analysis/trace.py`): K1's binning is one ``wtpu::route``,
as it is one launch on the card.

Metrics (budgeted per target, ratchet-down):
  sort_ops_per_ms     — sort ops per simulated ms;
  scatter_ops_per_ms  — scatter ops per simulated ms.
"""

from __future__ import annotations

from .framework import Finding, Rule, register_rule

SORT_OPS = ("aten::sort", "aten::argsort", "aten::msort")
SCATTER_PREFIXES = ("aten::scatter", "aten::index_put", "aten::_index_put",
                    "aten::index_add", "aten::index_copy", "aten::put_",
                    "aten::masked_scatter")


def count_ops(target) -> dict:
    counts = {"sort": 0, "scatter": 0}
    for op in target.recorder.ops:
        if op.base in SORT_OPS:
            counts["sort"] += 1
        elif op.base.startswith(SCATTER_PREFIXES):
            counts["scatter"] += 1
    return counts


def measure(target) -> dict:
    counts = count_ops(target)
    ms = target.ms or 1
    return {"sort_ops_per_ms": round(counts["sort"] / ms, 4),
            "scatter_ops_per_ms": round(counts["scatter"] / ms, 4)}


@register_rule
class SuperstepAmortizationRule(Rule):
    name = "superstep_amortization"
    scope = "protocol"
    budgeted_metrics = ("sort_ops_per_ms", "scatter_ops_per_ms")

    def run(self, target, budget):
        k = getattr(target, "ms_per_iter", None) or \
            (2 if str(target.engine).startswith("batched") else 1)
        return [Finding(rule=self.name, target=target.name,
                        severity="info", metric=m, value=v,
                        message=f"{m}={v} ({target.ms} ms chunk, "
                                f"windows of {k} ms)")
                for m, v in measure(target).items()]
