"""Rule ``trace_zero_cost`` — the flight recorder may never silently tax
an untraced chunk, and may never silently die (the port's counterpart
of `wittgenstein_tpu/analysis/rules_trace.py`).

Sibling of `metrics_zero_cost` (rules_metrics.py), for the EVENT plane
(obs/trace.py): the engine's `tap` hook defaults to None, so every
other target's budgeted output width and op count prove trace-OFF zero
residue, and a ``+trace`` target whose output does NOT carry the
`TraceCarry` leaves (buf, cursor, dropped, down) has a silently-dead
recorder — an error, not a budget.
"""

from __future__ import annotations

from .framework import Rule, register_rule
from .rules_metrics import zero_cost_findings

#: TraceCarry contributes this many pytree leaves (buf, cursor,
#: dropped, down).
_TRACE_CARRY_LEAVES = 4

#: analysis target-name suffix of the flight-recorder chunks
TRACE_SUFFIX = "+trace"


@register_rule
class TraceZeroCostRule(Rule):
    name = "trace_zero_cost"
    scope = "protocol"
    budgeted_metrics = ("carry_extra_leaves", "aten_ops")
    device_metrics = ("carry_extra_leaves",)

    def run(self, target, budget):
        return zero_cost_findings(
            self.name, target, TRACE_SUFFIX, _TRACE_CARRY_LEAVES,
            lambda extra: (
                f"traced target carries only {extra} extra leaves "
                f"(< {_TRACE_CARRY_LEAVES}: the TraceCarry leaves) — the "
                "flight recorder is silently dead in this chunk"))
