"""Host side of the invariant audit plane: decode + LOUD reporting; the
port of `wittgenstein_tpu/obs/audit_report.py`.

An `AuditReport` wraps the fetched `AuditCarry` pytree(s) of one run —
per-seed / per-shard carries (leading batch axes) merge onto one
verdict: violation counts sum, the first-violation record is the
earliest across buffers, totals sum (counts/bytes become batch
aggregates, exactly like `MetricsFrame.from_carry`).  Every consumer —
`Runner.audit_stats`, the bench ``audit`` JSON block —
surfaces violations LOUDLY; a clean verdict states what it proved
(which invariants, over how many windows' worth of state).

`cross_check_metrics` closes the loop between the two planes: the
audit carry samples its final counter totals (obs/audit.py TOTALS) so
a run captured with BOTH planes (one pass each — they are separate
carries) can assert the planes agree counter for counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .audit import (FIRST_FIELDS, INVARIANTS, TOTALS, AuditSpec,
                    monitored_invariants)
from .export import to_host


@dataclasses.dataclass
class AuditReport:
    """Host-side verdict of one audited run."""

    spec: AuditSpec
    counts: np.ndarray          # int64 [len(INVARIANTS)] — batch-summed
    first: dict | None          # decoded earliest violation, or None
    totals: np.ndarray          # int64 [len(TOTALS)] — batch-summed
    #: the invariants the audited build actually compiled
    #: (`audit.monitored_invariants`); None = unknown engine config,
    #: fall back to the spec's enabled set
    monitored: tuple | None = None

    @classmethod
    def from_carry(cls, spec: AuditSpec, ac,
                   monitored: tuple | None = None) -> "AuditReport":
        """Fetch a device `AuditCarry` (any leading batch axes).
        `monitored` (from `audit.monitored_invariants`) makes the
        verdict claim only the invariants the build compiled."""
        counts = to_host(ac.counts).reshape(
            -1, len(INVARIANTS)).sum(axis=0)
        firsts = to_host(ac.first).reshape(
            -1, len(FIRST_FIELDS))
        cand = firsts[firsts[:, 0] >= 0]
        first = None
        if cand.shape[0]:
            row = cand[np.argmin(cand[:, 0])]
            first = {"ms": int(row[0]),
                     "invariant": INVARIANTS[int(row[1])],
                     "index": int(row[2]), "observed": int(row[3]),
                     "expected": int(row[4])}
        totals = to_host(ac.totals).reshape(
            -1, len(TOTALS)).sum(axis=0)
        return cls(spec=spec, counts=counts, first=first, totals=totals,
                   monitored=monitored)

    @classmethod
    def from_carries(cls, spec: AuditSpec, carries,
                     monitored: tuple | None = None) -> "AuditReport":
        """Stitch consecutive chunks' carries into one verdict (counts
        sum, earliest first wins; totals are cumulative so the LAST
        chunk's batch-sum is the run's)."""
        frames = [cls.from_carry(spec, ac) for ac in carries]
        counts = np.sum([f.counts for f in frames], axis=0)
        firsts = [f.first for f in frames if f.first is not None]
        first = min(firsts, key=lambda r: r["ms"]) if firsts else None
        return cls(spec=spec, counts=counts, first=first,
                   totals=frames[-1].totals, monitored=monitored)

    # ------------------------------------------------------------ views

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    @property
    def clean(self) -> bool:
        return self.total == 0

    @property
    def claimed(self) -> tuple:
        """The invariants this verdict may honestly claim: the
        compiled subset when known, else the spec's enabled set."""
        return self.monitored if self.monitored is not None \
            else self.spec.invariants

    def violations(self) -> dict:
        """Violation count per claimed invariant name."""
        claimed = set(self.claimed)
        return {name: int(self.counts[i])
                for i, name in enumerate(INVARIANTS) if name in claimed}

    def totals_dict(self) -> dict:
        return {name: int(v) for name, v in zip(TOTALS, self.totals)}

    def stats(self) -> dict:
        """The dict `Runner.audit_stats` / the bench ``audit`` block
        consume."""
        out = {"clean": self.clean, "total": self.total,
               "mode": self.spec.mode,
               "invariants": list(self.claimed),
               "violations": self.violations(),
               "totals": self.totals_dict()}
        if self.first is not None:
            out["first"] = dict(self.first)
        return out

    def format(self) -> str:
        """Human-readable verdict — loud on violations."""
        if self.clean:
            return (f"audit: CLEAN — 0 violations over "
                    f"{len(self.claimed)} invariants "
                    f"({', '.join(self.claimed)})")
        lines = [f"!! AUDIT: {self.total} violation(s)"]
        for name, n in self.violations().items():
            if n:
                lines.append(f"  {name}: {n}")
        if self.first is not None:
            f = self.first
            lines.append(
                f"  first violation: ms {f['ms']} "
                f"invariant={f['invariant']} index={f['index']} "
                f"observed={f['observed']} expected={f['expected']}")
        elif self.spec.mode == "count":
            lines.append("  (mode='count': no first-violation record — "
                         "rerun with AuditSpec(mode='first') to "
                         "localize)")
        return "\n".join(lines)


def audit_block(report: AuditReport, extra: dict | None = None) -> dict:
    """The ``audit`` block of a bench JSON line (the JAX package's schema,
    BENCH_NOTES.md r10): the verdict, per-invariant counts and the
    first-violation record — never silent about a violation (one JSON line
    stays one line)."""
    out = report.stats()
    if extra:
        out.update(extra)
    return out


def cross_check_metrics(report: AuditReport, frame) -> list:
    """Assert the audit plane's final counter totals agree with a
    `MetricsFrame` captured from the SAME run (same protocol, seeds,
    span; both planes are bit-identical on the trajectory, so the two
    passes describe one trajectory).  Returns a list of human-readable
    mismatch strings — empty means the planes agree on every counter
    both enabled."""
    mismatches = []
    audit_totals = report.totals_dict()
    metric_totals = frame.totals()
    for name in TOTALS:
        if name not in metric_totals:
            continue        # counter not enabled in the metrics spec
        a, m = audit_totals[name], metric_totals[name]
        if a != m:
            mismatches.append(f"{name}: audit={a} metrics={m}")
    return mismatches


def audit_variant(protocol, ms: int, variant: dict,
                  spec: AuditSpec | None = None, seeds: int = 1,
                  first_seed: int = 0):
    """One-command audited run of an engine-variant configuration (the
    `obs.diff.build_variant` dispatch, audited;
    wittgenstein_tpu/obs/audit_report.py:165-211): returns
    ``(AuditReport, (nets, pstates))`` for a batch of `seeds` runs from
    `first_seed`.  `variant` is a dict over `obs.diff.VARIANT_KEYS`
    (superstep / batched / fast_forward)."""
    import torch

    from ..core.state import init_batched
    from .audit import (fast_forward_chunk_audit, scan_chunk_audit,
                        scan_chunk_batched_audit)
    from .diff import VARIANT_KEYS

    unknown = set(variant) - set(VARIANT_KEYS)
    if unknown:
        raise ValueError(f"unknown variant keys {sorted(unknown)}; "
                         f"known: {VARIANT_KEYS}")
    spec = spec or AuditSpec()
    k = int(variant.get("superstep", 1) or 1)
    if variant.get("batched") and k < 2:
        # refuse rather than silently bump: a K=1 label on a K=2 run
        # would mislabel the verdict
        raise ValueError("the batched engine is hard-wired to fused "
                         "K-ms windows: pass superstep >= 2 with "
                         "batched (e.g. superstep=2)")
    nets, ps = init_batched(protocol, torch.arange(first_seed,
                                                   first_seed + seeds))
    if variant.get("batched"):
        nets, ps, ac = scan_chunk_batched_audit(protocol, ms, spec,
                                                superstep=k)(nets, ps)
    elif variant.get("fast_forward"):
        nets, ps, _, ac = fast_forward_chunk_audit(
            protocol, ms, spec, seed_axis=True, superstep=k)(nets, ps)
    else:
        nets, ps, ac = scan_chunk_audit(protocol, ms, spec,
                                        superstep=k)(nets, ps)
    mon = monitored_invariants(spec, protocol.cfg)
    return AuditReport.from_carry(spec, ac, monitored=mon), (nets, ps)
