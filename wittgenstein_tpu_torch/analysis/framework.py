"""Rule framework: findings, budgets, the ratchet, and the runner — the
port's copy of `wittgenstein_tpu/analysis/framework.py`.

A rule is a named check with one entry point:

    run(target, budget) -> list[Finding]

Program rules (``scope == "protocol"``) get an `AnalysisTarget` per
protocol, whose recorded chunk (`analysis/trace.py`) they walk; global
rules (``scope == "global"``) run once with ``target=None`` (source
lints, the kernels' shared-memory models).  A `Finding` with severity
"error" fails the run; "info" findings carry the measured metrics that
budgets are ratcheted from.

Budgets (``analysis/budgets.json`` of this package; the JAX package's
file is never read) ratchet DOWN, never up: ``--update-budgets`` writes
a metric only when the measured value is strictly below the checked-in
one (or when no budget exists yet).  A regression above budget is an
error finding; tightening requires nothing; loosening requires a human
editing the JSON in a reviewed diff.

Budgets are measured on the CPU.  On a card a rule's metrics are held
against them only where the rule names them in `device_metrics`: the
quantities that do not depend on where the chunk runs (host reads,
carries, dtypes); the others (op counts, copy bytes) differ between the
plain CPU versions and the card and are reported without a gate.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

BUDGETS_PATH = pathlib.Path(__file__).resolve().parent / "budgets.json"

SEVERITIES = ("error", "warning", "info")

#: machine-readable report schema (`Report.to_json()["schema"]`), the
#: JAX package's: 2 = ok / targets / rules / n_errors / findings, each
#: finding with rule / target / severity / message / metric / value and
#: repo-relative `path` / 1-based `line` source spans.  Fields are only
#: ever added within a version; removals or renames bump it.
REPORT_SCHEMA = 2


@dataclasses.dataclass
class Finding:
    rule: str
    target: str             # protocol/target name, or file for lints
    severity: str           # "error" | "warning" | "info"
    message: str
    metric: str | None = None   # budgetable metric name
    value: object = None        # measured value for `metric`
    path: str | None = None     # repo-relative source file, for lints
    line: int | None = None     # 1-based line within `path`

    def to_json(self):
        return dataclasses.asdict(self)

    def span(self) -> str:
        """``path:line`` when the finding carries a source span."""
        if self.path is None:
            return ""
        return f"{self.path}:{self.line}" if self.line else self.path


class Rule:
    """Base class; subclasses set `name`, `scope` and implement run()."""

    name: str = ""
    scope: str = "protocol"     # "protocol" | "global"
    #: metrics (by name) the budget ratchet tracks for this rule
    budgeted_metrics: tuple = ()
    #: the budgeted metrics that are held against the budgets when the
    #: targets run on a card (the rest are CPU measurements)
    device_metrics: tuple = ()

    def run(self, target, budget: dict) -> list[Finding]:
        raise NotImplementedError

    def describe(self) -> str:
        """One-line target summary for ``--list`` (global rules
        override this to say what they scan)."""
        return ""


RULES: dict[str, Rule] = {}


def register_rule(cls):
    inst = cls()
    assert inst.name and inst.name not in RULES, inst.name
    RULES[inst.name] = inst
    return cls


def _install_rules():
    """Import the rule modules for their registration side effect."""
    from . import (rules_audit, rules_carry, rules_determinism,  # noqa: F401
                   rules_dtype, rules_host_digest, rules_host_durability,
                   rules_host_except, rules_host_locks, rules_hostsync,
                   rules_metrics, rules_smem, rules_superstep, rules_trace)


def parse_allow(budget: dict) -> frozenset:
    """The rule's suppression list from its budget block: a frozenset
    of ``"relpath::qualname::pattern"`` strings (``budgets.json`` key
    ``<rule>.allow``), shared by every rule that exempts a site, so an
    exemption is always a reviewed budget-file diff, never a code-side
    skip."""
    return frozenset(budget.get("allow", ()))


def load_budgets(path=BUDGETS_PATH) -> dict:
    if pathlib.Path(path).exists():
        with open(path) as f:
            return json.load(f)
    return {}


def save_budgets(budgets: dict, path=BUDGETS_PATH):
    with open(path, "w") as f:
        json.dump(budgets, f, indent=2, sort_keys=True)
        f.write("\n")


def check_budget(findings, budgets, rule, target_name,
                 device="cpu") -> list[Finding]:
    """Turn measured info-findings into errors where they exceed the
    checked-in budget.  Metrics with no budget entry yet pass (run
    --update-budgets to pin them).  On another device than the CPU only
    the rule's `device_metrics` are gated."""
    out = list(findings)
    rb = budgets.get(rule.name, {}).get(target_name, {})
    gated = rule.budgeted_metrics if device == "cpu" else \
        rule.device_metrics
    for f in findings:
        if f.metric is None or f.metric not in gated:
            continue
        limit = rb.get(f.metric)
        if limit is not None and f.value is not None and f.value > limit:
            out.append(Finding(
                rule=rule.name, target=target_name, severity="error",
                metric=f.metric, value=f.value,
                message=(f"{f.metric}={f.value} exceeds the checked-in "
                         f"budget {limit} (analysis/budgets.json ratchets "
                         "down only — fix the regression, do not raise "
                         "the budget)")))
    return out


def ratchet_budgets(findings, budgets, rules) -> dict:
    """Fold measured metrics into `budgets`, downward only."""
    for f in findings:
        rule = rules.get(f.rule)
        if (rule is None or f.metric is None
                or f.metric not in rule.budgeted_metrics
                or not isinstance(f.value, (int, float))):
            continue
        rb = budgets.setdefault(f.rule, {}).setdefault(f.target, {})
        old = rb.get(f.metric)
        if old is None or f.value < old:
            rb[f.metric] = f.value
    return budgets


@dataclasses.dataclass
class Report:
    findings: list
    targets: list
    rules: list
    errors: list = dataclasses.field(init=False)

    def __post_init__(self):
        self.errors = [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self):
        return not self.errors

    def to_json(self):
        return {"schema": REPORT_SCHEMA, "ok": self.ok,
                "targets": self.targets, "rules": self.rules,
                "n_errors": len(self.errors),
                "findings": [f.to_json() for f in self.findings]}


def run_analysis(target_names=None, rule_names=None, budgets=None,
                 progress=None, source_only=False, device="cpu") -> Report:
    """Run `rule_names` (default: all) over `target_names` (default: the
    full pinned registry) against `budgets` (default: the checked-in
    file), the targets' chunks on `device`.  A target that fails to
    build or run becomes an error finding, not a crash — a protocol
    whose chunk stops running at its pinned config is itself a
    regression the report must surface.  ``source_only`` restricts the
    run to global rules and skips the target registry entirely — no
    protocol import, no chunk run, seconds (the ``--source`` CLI
    mode)."""
    _install_rules()
    budgets = load_budgets() if budgets is None else budgets
    rules = [RULES[r] for r in (rule_names or sorted(RULES))]
    if source_only:
        rules = [r for r in rules if r.scope == "global"]
        names = []
    else:
        from . import targets as targets_mod
        names = list(target_names) if target_names is not None \
            else list(targets_mod.target_names())
    dev = str(device).split(":")[0]

    findings: list[Finding] = []
    for rule in rules:
        if rule.scope != "global":
            continue
        if progress:
            progress(f"rule {rule.name} (global)")
        fs = rule.run(None, budgets.get(rule.name, {}))
        findings += check_budget(fs, budgets, rule, "global")

    proto_rules = [r for r in rules if r.scope == "protocol"]
    for name in names if proto_rules else []:
        target = targets_mod.get_target(name, device=device)
        for rule in proto_rules:
            if progress:
                progress(f"rule {rule.name} on {name}")
            try:
                fs = rule.run(target, budgets.get(rule.name, {}).get(name, {}))
            except Exception as e:          # noqa: BLE001
                findings.append(Finding(
                    rule=rule.name, target=name, severity="error",
                    message=f"rule crashed: {type(e).__name__}: {e}"))
                continue
            findings += check_budget(fs, budgets, rule, name, device=dev)
        target.release()
    return Report(findings=findings, targets=names,
                  rules=[r.name for r in rules])
