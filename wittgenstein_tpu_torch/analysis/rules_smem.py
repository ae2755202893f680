"""Rule ``smem_budget`` — every CUDA kernel's shared-memory model must fit
a block's opt-in limit at its real launch shapes (the port's twin of
`wittgenstein_tpu/analysis/rules_vmem.py`).

Each launcher in ``csrc/`` sizes its dynamic shared memory inline, and
several take a branch on it (route's rank tables in shared memory or in
device scratch, gsf_score's staged or unstaged kernel).  Each has a
Python model in its ``ops/`` module (`smem_bytes`) that says the bytes
and the branch; each extension exports the launcher's own figure
(``wtpu_<kernel>_smem``, the function the launcher itself calls), and
on the card `card_check` holds the model equal to that figure.  This
rule, off the card:

  * evaluates every model at the shapes of the rows of the kernel table
    in PERF.md (the headline, T2's piece, T3, G32, B, GSF 4096) and at
    the extremes of its parameter domain, against the sm_90 opt-in
    limit (227 KB a block, `ops/_build.SMEM_OPTIN`);
  * requires that a shape which cannot fit raises in the launcher
    (`_build.check_smem`) before the launch: gsf_merge's W-word row is
    the one model without a bound.
"""

from __future__ import annotations

from .framework import Finding, Rule, register_rule


def kernel_models():
    """(kernel, model, [(kwargs, label), ...]): each model's shapes,
    from the rows of PERF.md's kernel table and the extremes."""
    from ..ops import gsf_merge, merge, route, score

    return [
        ("K1 route", route.smem_bytes, [
            (dict(m=1, h=256, n=2048), "headline (H 256, N 2048)"),
            (dict(m=1, h=256, n=16384), "T2 sub-plane (H 256, N 16,384)"),
            (dict(m=1, h=256, n=65536), "T3 (H 256, N 65,536)"),
            (dict(m=1, h=512, n=32768), "G32 (H 512, N 32,768)"),
            (dict(m=1, h=512, n=4096), "B and GSF 4096 (H 512, N 4,096)"),
            (dict(m=1, h=1 << 15, n=1 << 16), "extreme (2^31 cells)"),
        ]),
        ("K2 merge", merge.smem_bytes, [
            (dict(q=16, s=12), "headline, T2, B (Q 16, S 12)"),
            (dict(q=255, s=0), "extreme (Q + S = 255)"),
            (dict(q=0, s=255), "extreme (S 255)"),
        ]),
        ("K3 score", score.smem_bytes, [
            (dict(q=16, w=64), "headline (W 64)"),
            (dict(q=16, w=1024), "T2 piece (W 1,024)"),
            (dict(q=16, w=128), "B (W 128)"),
        ]),
        ("K4 gsf_score", score.gsf_smem_bytes, [
            (dict(q=16, w=128), "GSF 4096 and its batch (W 128)"),
            (dict(q=16, w=1024), "G32 (W 1,024)"),
            (dict(q=255, w=4), "extreme (most stages)"),
        ]),
        ("K5 gsf_merge", gsf_merge.smem_bytes, [
            (dict(w=128), "GSF 4096 and its batch (W 128)"),
            (dict(w=1024), "G32 (W 1,024)"),
        ]),
    ]


#: (kernel, model kwargs) of a shape past the limit, and the launcher
#: guard that must refuse it before the launch
def refusals():
    from ..ops import _build, gsf_merge
    w = _build.SMEM_OPTIN // 4 + 1
    return [("K5 gsf_merge", dict(w=w),
             lambda: _build.check_smem(
                 "gsf_merge", gsf_merge.smem_bytes(w)["gsf_merge_kernel"]))]


def check_model(kernel, model, shapes, limit=None,
                rule_name="smem_budget") -> list[Finding]:
    """Evaluate one model at `shapes` against the opt-in limit; an error
    for each shape over it.  Exposed so tests can feed a deliberately
    over-limit fake model."""
    from ..ops._build import SMEM_OPTIN
    limit = SMEM_OPTIN if limit is None else limit
    findings = []
    for kw, label in shapes:
        got = model(**kw)
        parts = {k: v for k, v in got.items() if k != "branch"}
        worst = max(parts.values())
        sev = "error" if worst > limit else "info"
        findings.append(Finding(
            rule=rule_name, target=kernel, severity=sev,
            metric=None, value=worst,
            message=f"{label}: {parts} bytes ({got['branch']}) of the "
                    f"{limit}-byte opt-in limit"
                    + (" — the launch would fail on the card"
                       if sev == "error" else "")))
    return findings


def check_refusals(rule_name="smem_budget") -> list[Finding]:
    findings = []
    for kernel, kw, guard in refusals():
        try:
            guard()
        except ValueError as e:
            findings.append(Finding(
                rule=rule_name, target=kernel, severity="info",
                message=f"{kw}: refused before the launch ({e})"))
        else:
            findings.append(Finding(
                rule=rule_name, target=kernel, severity="error",
                message=f"{kw} does not fit a block, and the launcher "
                        "does not refuse it"))
    return findings


#: model -> (kernel-library entry, argument order, part names)
_CARD = {
    "K1 route": ("wtpu_route_smem", ("m", "h", "n"),
                 ("route_bucket_kernel", "route_rank_kernel", "branch")),
    "K2 merge": ("wtpu_merge_smem", ("q", "s"), ("merge_kernel",)),
    "K3 score": ("wtpu_score_smem", ("q", "w"), ("score_kernel",)),
    "K4 gsf_score": ("wtpu_gsf_score_smem", ("q", "w"),
                     ("gsf_score_kernel",)),
    "K5 gsf_merge": ("wtpu_gsf_merge_smem", ("w",), ("gsf_merge_kernel",)),
}


def card_check() -> list:
    """On the card: each model's bytes (and route's branch) against the
    figure the launcher's own function returns, at every shape of
    `kernel_models`; returns ``(kernel, label, part, model, launcher)``
    rows, the mismatches first."""
    from ..ops import _build
    lib = _build.lib()
    rows = []
    for kernel, model, shapes in kernel_models():
        entry, order, parts = _CARD[kernel]
        fn = getattr(lib, entry)
        for kw, label in shapes:
            got = model(**kw)
            args = [kw[k] for k in order]
            for i, part in enumerate(parts):
                if kernel == "K1 route":
                    want = int(got[part] == "tables_in_smem") \
                        if part == "branch" else got[part]
                    have = fn(*args, i)
                else:
                    want, have = got[part], fn(*args)
                rows.append((kernel, label, part, want, int(have)))
    return sorted(rows, key=lambda r: r[3] == r[4])


@register_rule
class SmemBudgetRule(Rule):
    name = "smem_budget"
    scope = "global"

    def run(self, target, budget):
        findings = []
        for kernel, model, shapes in kernel_models():
            findings += check_model(kernel, model, shapes,
                                    rule_name=self.name)
        return findings + check_refusals(self.name)

    def describe(self):
        return f"{len(kernel_models())} CUDA kernel shared-memory models"
