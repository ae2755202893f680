"""Rule ``metrics_zero_cost`` — the metrics plane may never silently tax
the hot path, and may never silently die (the port's counterpart of
`wittgenstein_tpu/analysis/rules_metrics.py`).

The obs package's contract is two-sided:

  * metrics-OFF chunks carry ZERO instrumentation residue: what the
    chunk returns beyond its state's leaves (``carry_extra_leaves``;
    the fast-forward engine's two skip counts on the ``+ff`` targets,
    the plane's leaves on the instrumented ones) is budgeted, and so is
    the number of ops the chunk dispatches (``aten_ops``, the port's
    twin of ``jaxpr_eqns``), so a dead reduction left in the engine
    fails the gate;
  * metrics-ON chunks actually instrument: a ``+metrics``/``+ffmetrics``
    target whose output does NOT carry the `MetricsCarry` leaves has a
    silently-dead plane — an error, not a budget.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree

from .framework import Finding, Rule, register_rule

#: MetricsCarry contributes this many pytree leaves (t0 + series).
_METRICS_CARRY_LEAVES = 2

#: analysis target-name suffixes of the instrumented chunks
INSTRUMENTED_SUFFIXES = ("+metrics", "+ffmetrics")


def zero_cost_findings(rule_name, target, suffixes, plane_leaves,
                       dead_message) -> list:
    """The shared body of the three plane zero-cost rules (metrics /
    trace / audit): the chunk's output leaves over its input state's,
    and its dispatched op count; an error when a target carrying one of
    `suffixes` does not widen by its plane's `plane_leaves`."""
    n_state = len(pytree.tree_leaves(target.args))
    n_out = len(pytree.tree_leaves(target.out))
    extra = n_out - n_state
    n_ops = len(target.recorder.ops)
    findings = [
        Finding(rule=rule_name, target=target.name, severity="info",
                metric="carry_extra_leaves", value=extra,
                message=f"the chunk returns {n_out} leaves for {n_state} "
                        f"state leaves (carry_extra_leaves={extra})"),
        Finding(rule=rule_name, target=target.name, severity="info",
                metric="aten_ops", value=n_ops,
                message="ops the chunk dispatches"),
    ]
    if target.name.endswith(suffixes) and extra < plane_leaves:
        findings.append(Finding(
            rule=rule_name, target=target.name, severity="error",
            message=dead_message(extra)))
    return findings


@register_rule
class MetricsZeroCostRule(Rule):
    name = "metrics_zero_cost"
    scope = "protocol"
    budgeted_metrics = ("carry_extra_leaves", "aten_ops")
    device_metrics = ("carry_extra_leaves",)

    def run(self, target, budget):
        return zero_cost_findings(
            self.name, target, INSTRUMENTED_SUFFIXES,
            _METRICS_CARRY_LEAVES,
            lambda extra: (
                f"instrumented target carries only {extra} extra "
                f"leaves (< {_METRICS_CARRY_LEAVES}: the MetricsCarry "
                "leaves) — the metrics plane is silently dead in this "
                "chunk"))
