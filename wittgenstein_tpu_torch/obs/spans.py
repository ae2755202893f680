"""Host-plane span recorder — the request-lifecycle flight recorder.

The device plane has a flight recorder (obs/trace.py) on SIMULATED
time; this module is its host twin on WALL time.  A span is one named
interval of host work — submit, queue wait, compile, launch, chunk,
preempt, resume, settle, lease claim, adoption — carrying the request
id / compile key / tenant / worker attributes that let a Perfetto
merge (obs/export.spans_to_perfetto) put every request's host
lifecycle on one track next to its device timeline.

Design constraints, in order:

  * OFF costs nothing: the serve plane holds ``instrument=None`` by
    default and guards every site with a plain is-None test — this
    module is never imported, let alone allocated, on the
    uninstrumented hot path (tests/test_obs_spans.py pins it).
  * Crash postmortems keep the timeline: with ``path=`` set, every
    span is ALSO appended to a JSONL log through the sanctioned
    `utils/jsonl.append_line` write path, so a SIGKILLed worker's
    spans survive it (torn final line tolerated by `read_spans`, the
    `iter_lines` contract).  The rule ``host_durability`` covers this
    file as part of its strict zone.
  * Deterministic under an injected clock: all timestamps come from
    the ``clock`` callable (default `time.monotonic`) and nothing
    else, so a fake clock yields byte-identical JSONL across runs —
    the span log is testable the way the engines are.

The in-memory side is a bounded ring (`capacity` most-recent spans):
a long-lived service must not grow a span list without bound, and the
ring is what `phase_quantiles` (the `/w/batch/health` p50/p99 block)
and ad-hoc snapshots read.  The durable JSONL, when enabled, is the
complete record.

The port's own copy of `wittgenstein_tpu/obs/spans.py`, which has no JAX in it: the port imports nothing of the JAX package, so it keeps this module line for line (the spans, exposition text, journal rows and ledger rows are byte for byte the JAX package's).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

from ..utils import jsonl

#: span-row schema (bump on field changes)
SCHEMA = 1


def _quantile(sorted_vals, q: float) -> float:
    """Upper nearest-rank quantile over a sorted list (the serve_load
    convention: ceil, so a p99 over ~100 samples reads the true tail
    outlier, not ~p98)."""
    import math
    i = min(len(sorted_vals) - 1,
            math.ceil(q * (len(sorted_vals) - 1)))
    return sorted_vals[i]


class SpanRecorder:
    """Bounded-ring span recorder with optional durable JSONL.

    ``emit(name, t0)`` records one COMPLETED span (start/stop on the
    injected monotonic clock); ``span(name)`` is the context-manager
    sugar for coarse phases.  Thread-safe: serve drain, watchdog,
    renewal and HTTP threads all emit into one recorder."""

    #: lock inventory (analysis rule ``host_locks``): `_mu` guards the
    #: ring and the emit/drop counters — written from every emitting
    #: thread, read by snapshot/quantile callers (health endpoint).
    _LOCK_OWNS = {"_mu": ("_ring", "_emitted", "_write_errors")}

    def __init__(self, *, capacity: int = 4096, path=None,
                 fsync: bool = False, clock=None,
                 worker: str | None = None):
        self.capacity = max(1, int(capacity))
        #: durable JSONL log (None = ring only).  Appends go through
        #: utils/jsonl.append_line — the one sanctioned append path —
        #: so a crash leaves at worst one torn final line.
        self.path = str(path) if path else None
        #: fsync each span row (off by default: the span log is
        #: postmortem evidence, not an ack barrier — flush-per-line
        #: already bounds loss to the in-flight row)
        self.fsync = bool(fsync)
        #: the ONLY time source (injectable for byte-identical tests)
        self.clock = clock if clock is not None else time.monotonic
        #: default worker attribute stamped on every span
        self.worker = str(worker) if worker is not None else None
        import collections
        self._ring = collections.deque(maxlen=self.capacity)
        self._emitted = 0
        self._write_errors = 0
        self._mu = threading.Lock()

    # ------------------------------------------------------------- emit

    def now(self) -> float:
        """The recorder's clock — span starts MUST come from here, so
        an injected clock governs every timestamp."""
        return self.clock()

    def emit(self, name: str, t0: float, t1=None, *, rid=None,
             key=None, tenant=None, worker=None, **extra) -> dict:
        """Record one completed span ``[t0, t1]`` (t1 defaults to
        now).  Attribute fields are omitted when None so the JSONL
        stays compact and byte-stable.  Returns the row."""
        if t1 is None:
            t1 = self.clock()
        row = {"schema": SCHEMA, "name": str(name),
               "t0": float(t0),
               "dur": max(0.0, float(t1) - float(t0))}
        w = worker if worker is not None else self.worker
        if w is not None:
            row["worker"] = w
        if rid is not None:
            row["rid"] = rid
        if key is not None:
            row["key"] = key
        if tenant is not None:
            row["tenant"] = tenant
        if extra:
            row.update(extra)
        with self._mu:
            self._ring.append(row)
            self._emitted += 1
        if self.path is not None:
            try:
                jsonl.append_line(self.path, row, fsync=self.fsync)
            except OSError as e:
                # the ring keeps the span; the durable log degrades
                # loudly instead of failing the instrumented operation
                with self._mu:
                    self._write_errors += 1
                print(f"spans: append to {self.path} failed ({e}); "
                      "span kept in ring only", file=sys.stderr)
        return row

    def mark(self, name: str, **attrs) -> dict:
        """A zero-duration event marker (retry, degradation, watchdog
        trip, quarantine verdict) — a span whose t0 == t1."""
        t = self.clock()
        return self.emit(name, t, t, **attrs)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context-manager sugar: the enclosed block is the span."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.emit(name, t0, **attrs)

    # ------------------------------------------------------------- read

    def snapshot(self) -> list:
        """The ring's spans, oldest first (copies of the row dicts are
        NOT taken — rows are append-only by convention)."""
        with self._mu:
            return list(self._ring)

    def stats(self) -> dict:
        with self._mu:
            return {"emitted": self._emitted,
                    "in_ring": len(self._ring),
                    "capacity": self.capacity,
                    "write_errors": self._write_errors,
                    "durable": self.path is not None}

    def phase_quantiles(self, names=None) -> dict:
        """Per-span-name duration quantiles over the ring — the
        `/w/batch/health` ``phases`` block: ``{name: {count, p50_ms,
        p99_ms}}``.  `names` (optional) restricts to those span
        names."""
        by: dict = {}
        for row in self.snapshot():
            n = row["name"]
            if names is not None and n not in names:
                continue
            by.setdefault(n, []).append(row["dur"])
        out = {}
        for n in sorted(by):
            ds = sorted(by[n])
            out[n] = {"count": len(ds),
                      "p50_ms": round(1e3 * _quantile(ds, 0.50), 3),
                      "p99_ms": round(1e3 * _quantile(ds, 0.99), 3)}
        return out


def read_spans(path) -> list:
    """Parse one span JSONL log (torn tail tolerated — the
    `utils/jsonl.iter_lines` contract: a SIGKILL mid-append loses at
    most the in-flight row, loudly).  Rows that are not span-shaped
    (no name/t0) are skipped with a stderr note rather than failing
    the postmortem."""
    out = []
    for i, row in jsonl.iter_lines(path, label="spans"):
        if not isinstance(row, dict) or "name" not in row \
                or "t0" not in row:
            print(f"spans: row {i} of {path} is not a span "
                  "(no name/t0); skipped", file=sys.stderr)
            continue
        out.append(row)
    return out
