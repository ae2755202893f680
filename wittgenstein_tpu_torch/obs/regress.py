"""Bench-history regression gate — the port of
`wittgenstein_tpu/obs/regress.py`, which has no JAX in it: the port
keeps its own copy, function for function, so that a history written
by either package gates the same way in the other (the rows are one
schema).

Every bench round appends its stage measures to a history ledger
(`BenchHistory`; the producers are `cli/bench_suite.py` and
`bench_torch.py --history`), and the detector compares each new round
against a robust same-host baseline.

History rows are keyed on (stage, config digest, backend, host
fingerprint); all four must match before two rows are comparable:

  * the config digest is the stage's `ScenarioSpec` digest, so a K=4
    round never baselines a K=1 round;
  * backend + host fingerprint keep machines apart: a laptop's CPU
    walls never gate a card host's, and vice versa.

The detector is median/MAD, not mean/stddev: a baseline window that
itself holds one outlier round must not widen the gate.  For each
gated series the baseline is the median of the last K comparable
rows; the threshold is ``max(nsigma * 1.4826 * MAD, rel_floor *
|median|)``.  Direction comes from the series name: ``*per_sec*``
regresses DOWN (throughput), ``wall*`` / ``*_s`` regress UP (latency);
series that are neither (event counts, violation counts) are not gated.

Exit semantics (`cli/regress.py`, `cli/bench_suite.py
--check-regressions`): 0 = clean (including "no baseline yet"), 1 =
regression (the finding names stage + series + ratio), 2 =
configuration error (no history, unknown round).

Appends go through `utils/jsonl.append_line` with fsync; torn tails
are tolerated on read.
"""

from __future__ import annotations

import sys
import threading

from ..utils import jsonl

#: history-row schema (bump on field changes)
SCHEMA = 1

#: detector defaults: baseline window, MAD multiplier, relative floor,
#: minimum comparable rows before a series is gated at all
BASELINE_K = 5
NSIGMA = 4.0
REL_FLOOR = 0.10
MIN_BASELINE = 3

#: MAD -> sigma for a normal distribution
_MAD_SCALE = 1.4826


def host_fingerprint() -> str:
    """The machine identity rows are keyed on — hostname + ISA is
    enough to keep two lab machines apart without leaking anything a
    shared history file should not carry."""
    import platform
    return f"{platform.node()}/{platform.machine()}"


def stage_measures(res: dict) -> dict:
    """The gateable numeric series of one bench_suite result line:
    the stage metric's value and the wall-clock series the shared
    measurement protocol emits.  Error lines yield {} — a failed
    stage is the stage's own loud red, not a perf trend."""
    if res.get("error"):
        return {}
    out = {}
    for k in ("value", "wall_s", "wall_median_s"):
        v = res.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = float(v)
    return out


def series_direction(series: str, metric: str | None = None):
    """``"up"`` when higher is better (a drop regresses), ``"down"``
    when lower is better (a rise regresses), None = not gated.  The
    ``value`` series takes its meaning from the stage's metric
    name."""
    name = metric if series == "value" and metric else series
    name = (name or "").lower()
    if "per_sec" in name:
        return "up"
    if "wall" in name or name.endswith("_s") or "seconds" in name:
        return "down"
    return None


class BenchHistory:
    """Append-side handle for one history ledger (read side:
    `read_history` — files outlive the process that wrote them)."""

    #: lock inventory: `_mu` guards the degraded-write counter (appends
    #: may land from concurrent stage drivers).
    _LOCK_OWNS = {"_mu": ("_write_errors",)}

    def __init__(self, path, *, fsync: bool = True):
        self.path = str(path)
        #: fsync per row, like the program catalog: a history exists
        #: to survive the round that wrote it
        self.fsync = bool(fsync)
        self._write_errors = 0
        self._mu = threading.Lock()

    def append(self, *, stage: str, measures: dict, round_id: str,
               config_digest=None, backend=None, host=None,
               metric=None, extra: dict | None = None) -> dict:
        """Append one stage's round row.  Never raises on a failed
        write — the suite's emit loop must not die on a read-only
        reports/ directory (degrades loudly, the spans convention)."""
        row = {"schema": SCHEMA, "stage": str(stage),
               "round": str(round_id),
               "host": host if host is not None else host_fingerprint(),
               "measures": {k: float(v) for k, v in measures.items()}}
        if config_digest is not None:
            row["config_digest"] = config_digest
        if backend is not None:
            row["backend"] = backend
        if metric is not None:
            row["metric"] = metric
        if extra:
            row.update(extra)
        try:
            jsonl.append_line(self.path, row, fsync=self.fsync)
        except OSError as e:
            with self._mu:
                self._write_errors += 1
            print(f"regress: append to {self.path} failed ({e}); "
                  "round row lost", file=sys.stderr)
        return row

    def rows(self) -> list:
        return read_history(self.path)

    def stats(self) -> dict:
        with self._mu:
            return {"path": self.path,
                    "write_errors": self._write_errors}


def read_history(path) -> list:
    """Parse one history JSONL (torn tail tolerated).  Rows that are
    not history-shaped are skipped with a stderr note."""
    out = []
    for i, row in jsonl.iter_lines(path, label="regress"):
        if not isinstance(row, dict) or "stage" not in row \
                or not isinstance(row.get("measures"), dict):
            print(f"regress: row {i} of {path} is not a history row "
                  "(no stage/measures); skipped", file=sys.stderr)
            continue
        out.append(row)
    return out


def _median(vals):
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _row_key(row) -> tuple:
    return (row.get("stage"), row.get("config_digest"),
            row.get("backend"), row.get("host"))


def detect_regressions(history, new_rows, *, k: int = BASELINE_K,
                       nsigma: float = NSIGMA,
                       rel_floor: float = REL_FLOOR,
                       min_baseline: int = MIN_BASELINE) -> tuple:
    """Compare `new_rows` against `history` (module docstring).
    Returns ``(findings, checked)``: findings are regression dicts
    (stage, series, metric, value, baseline, threshold, ratio,
    direction); `checked` counts (row, series) pairs that HAD a
    baseline — callers report skipped-for-no-baseline honestly
    instead of calling it clean coverage."""
    by_key: dict = {}
    for row in history:
        by_key.setdefault(_row_key(row), []).append(row)
    findings, checked = [], 0
    for row in new_rows:
        base_rows = by_key.get(_row_key(row), [])
        for series, value in (row.get("measures") or {}).items():
            dirn = series_direction(series, row.get("metric"))
            if dirn is None:
                continue
            prior = [r["measures"][series] for r in base_rows
                     if series in (r.get("measures") or {})][-k:]
            if len(prior) < min_baseline:
                continue
            checked += 1
            med = _median(prior)
            mad = _median([abs(v - med) for v in prior])
            thr = max(nsigma * _MAD_SCALE * mad,
                      rel_floor * abs(med))
            delta = value - med
            regressed = (delta < -thr) if dirn == "up" \
                else (delta > thr)
            if regressed:
                findings.append({
                    "stage": row.get("stage"),
                    "series": series,
                    "metric": row.get("metric"),
                    "value": value,
                    "baseline": round(med, 6),
                    "threshold": round(thr, 6),
                    "ratio": round(value / med, 4) if med else None,
                    "direction": dirn,
                    "baseline_n": len(prior),
                    "host": row.get("host"),
                    "backend": row.get("backend")})
    return findings, checked


def gate(path, round_id=None, **kw) -> tuple:
    """The whole gate over one history file: pick the round (default:
    the last round in the file), baseline it against every EARLIER
    row, detect.  Returns ``(exit_code, findings, summary)`` with the
    module's 0/1/2 exit semantics."""
    rows = read_history(path)
    if not rows:
        return 2, [], {"error": f"no history rows in {path}"}
    if round_id is None:
        round_id = rows[-1].get("round")
    new = [r for r in rows if r.get("round") == round_id]
    if not new:
        return 2, [], {"error": f"round {round_id!r} not in {path}"}
    first = min(i for i, r in enumerate(rows)
                if r.get("round") == round_id)
    history = rows[:first]
    findings, checked = detect_regressions(history, new, **kw)
    summary = {"round": round_id, "stages": len(new),
               "series_checked": checked,
               "series_skipped_no_baseline":
                   sum(1 for r in new for s in (r.get("measures") or {})
                       if series_direction(s, r.get("metric"))
                       is not None) - checked,
               "regressions": len(findings)}
    return (1 if findings else 0), findings, summary


def format_findings(findings) -> str:
    """Human-readable finding lines (the CLI and the suite flag share
    one formatter so the loud red reads the same everywhere)."""
    lines = []
    for f in findings:
        arrow = "fell" if f["direction"] == "up" else "rose"
        lines.append(
            f"REGRESSION {f['stage']}.{f['series']}"
            + (f" ({f['metric']})" if f.get("metric") else "")
            + f": {f['value']:g} {arrow} past baseline "
            f"{f['baseline']:g} +/- {f['threshold']:g}"
            + (f" ({f['ratio']:g}x)" if f.get("ratio") else "")
            + f" [n={f['baseline_n']}, {f.get('backend')}]")
    return "\n".join(lines)
