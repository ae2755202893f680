"""Rule ``audit_zero_cost`` — the invariant audit plane may never
silently tax an unaudited chunk, and may never silently die (the port's
counterpart of `wittgenstein_tpu/analysis/rules_audit.py`).

Sibling of `trace_zero_cost` and `metrics_zero_cost`, for the AUDIT
plane (obs/audit.py): every other target's budgeted output width and
op count prove audit-OFF zero residue, and an ``+audit`` target whose
output does NOT carry the `AuditCarry` leaves (counts, first,
prev_done, prev_counters, totals) has silently-dead monitors — an
error, not a budget.
"""

from __future__ import annotations

from .framework import Rule, register_rule
from .rules_metrics import zero_cost_findings

#: AuditCarry contributes this many pytree leaves.
_AUDIT_CARRY_LEAVES = 5

#: analysis target-name suffix of the audited chunks
AUDIT_SUFFIX = "+audit"


@register_rule
class AuditZeroCostRule(Rule):
    name = "audit_zero_cost"
    scope = "protocol"
    budgeted_metrics = ("carry_extra_leaves", "aten_ops")
    device_metrics = ("carry_extra_leaves",)

    def run(self, target, budget):
        return zero_cost_findings(
            self.name, target, AUDIT_SUFFIX, _AUDIT_CARRY_LEAVES,
            lambda extra: (
                f"audited target carries only {extra} extra leaves "
                f"(< {_AUDIT_CARRY_LEAVES}: the AuditCarry leaves) — the "
                "invariant monitors are silently dead in this chunk"))
