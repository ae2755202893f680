"""Cumulative host-metrics registry with Prometheus text exposition.

The device plane's metrics are on-chip counters fetched per chunk
(obs/spec.py); this module is the HOST plane's scrapeable mirror:
counters (monotone non-decreasing), gauges, and histograms with
explicit buckets, exposed as deterministic Prometheus 0.0.4 text at
``GET /w/batch/metrics`` (server/http.py) and snapshotted into ledger
rows at settle time (serve/instrument.py).

Two write disciplines coexist deliberately:

  * event-time accumulation — `inc` / `observe` at the
    instrumentation site (span ends feed the phase histograms), so
    histogram series are CUMULATIVE across the process lifetime, not
    a window over a bounded ring;
  * scrape-time projection — `set_counter` / `set_gauge` from an
    already-monotone source (the scheduler's resilience counters, the
    journal's lag).  `set_counter` keeps ``max(old, new)`` so a
    projected counter can never read backwards even if its source is
    briefly re-created.

Exposition is deterministic: metrics sort by name, histogram buckets
by bound, and values format identically run to run — the monotone-
across-scrapes test diffs parsed expositions, not prose.

The port's own copy of `wittgenstein_tpu/obs/metrics.py`, which has no JAX in it: the port imports nothing of the JAX package, so it keeps this module line for line (the spans, exposition text, journal rows and ledger rows are byte for byte the JAX package's).
"""

from __future__ import annotations

import math
import threading

#: default histogram bucket bounds (seconds) — spans from sub-ms host
#: bookkeeping through multi-minute cold compiles
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)


def _fmt(v) -> str:
    """One deterministic number format for exposition lines."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """See module docstring.  Thread-safe; one instance per serve
    process (shared by the scheduler, the fleet worker loop and the
    HTTP scrape handler)."""

    #: lock inventory (analysis rule ``host_locks``): one lock guards
    #: every value table — increments land from drain/watchdog/renewal
    #: threads while the HTTP thread formats an exposition.
    _LOCK_OWNS = {"_mu": ("_counters", "_gauges", "_hists", "_help")}

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self._help: dict = {}

    # ------------------------------------------------------------ write

    def inc(self, name: str, amount=1, help: str = ""):
        """Add to a counter (created at 0).  Negative amounts are
        refused — a Prometheus counter is monotone by contract."""
        if amount < 0:
            raise ValueError(f"counter {name}: negative increment "
                             f"{amount} (use a gauge for values that "
                             "go down)")
        with self._mu:
            self._counters[name] = self._counters.get(name, 0) + amount
            if help:
                self._help.setdefault(name, help)

    def set_counter(self, name: str, value, help: str = ""):
        """Project an externally-accumulated monotone value (e.g. a
        scheduler resilience counter) into a counter; keeps
        ``max(old, new)`` so the exposed series never decreases."""
        with self._mu:
            self._counters[name] = max(self._counters.get(name, 0),
                                       value)
            if help:
                self._help.setdefault(name, help)

    def set_gauge(self, name: str, value, help: str = ""):
        with self._mu:
            self._gauges[name] = value
            if help:
                self._help.setdefault(name, help)

    def observe(self, name: str, value, buckets=None, help: str = ""):
        """One histogram observation.  `buckets` (explicit upper
        bounds, +Inf implied) applies on first creation; later calls
        reuse the recorded bounds."""
        v = float(value)
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                bounds = tuple(sorted(float(b) for b in
                                      (buckets or DEFAULT_BUCKETS)))
                h = {"bounds": bounds,
                     "counts": [0] * (len(bounds) + 1),
                     "sum": 0.0, "count": 0}
                self._hists[name] = h
            i = len(h["bounds"])
            for j, b in enumerate(h["bounds"]):
                if v <= b:
                    i = j
                    break
            h["counts"][i] += 1
            h["sum"] += v
            h["count"] += 1
            if help:
                self._help.setdefault(name, help)

    # ------------------------------------------------------------- read

    def snapshot(self) -> dict:
        """Structured snapshot (the ledger-row block): counters and
        gauges verbatim, histograms as count/sum only (bucket vectors
        stay in the exposition — one ledger row must stay one row)."""
        with self._mu:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    n: {"count": h["count"],
                        "sum": round(h["sum"], 6)}
                    for n, h in self._hists.items()},
            }

    def exposition(self) -> str:
        """Prometheus 0.0.4 text: deterministic ordering (metric name,
        then bucket bound), trailing newline, parseable by any scrape
        client."""
        with self._mu:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
            helps = dict(self._help)
        lines = []
        for name, val in counters:
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_fmt(val)}")
        for name, val in gauges:
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(val)}")
        for name, h in hists:
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for b, c in zip(h["bounds"], h["counts"]):
                cum += c
                lines.append(
                    f'{name}_bucket{{le="{_fmt(b)}"}} {cum}')
            cum += h["counts"][-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {_fmt(round(h['sum'], 9))}")
            lines.append(f"{name}_count {h['count']}")
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text back to ``{metric_or_series: value}`` —
    the test-side half of the round trip (bucket series keep their
    ``{le=...}`` suffix as part of the key).  Unparseable sample
    lines raise: a scrape endpoint emitting garbage should fail the
    test, not hide in a skip."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        if not name:
            raise ValueError(f"unparseable exposition line: {line!r}")
        out[name] = float(val)
    return out
