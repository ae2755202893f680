"""Host side of the metrics plane: MetricsFrame + the exporter matrix;
the port of `wittgenstein_tpu/obs/export.py` (numpy on the host, as
there: a carry is fetched once, after its chunk).

A `MetricsFrame` wraps the fetched ``[T, K]`` (or per-seed
``[R, T, K]``) series plus its spec, and derives the host-facing views:
forward-filled cumulative series (fast-forwarded quiet intervals carry
``samples == 0`` and flat-line exactly — a skipped ms is a no-op step),
per-interval deltas for the cumulative counters, and run totals.

Exporters:
  * `to_progress_csv` — the ProgressPerTime-style table
    (ProgressPerTime.java:53-149) via `tools/csvf.CSVFormatter`;
  * `to_perfetto` — Chrome-trace/Perfetto JSON (`process_name`
    metadata, "X" slices, "C" counter tracks), the conventions
    `torch.profiler`'s Chrome traces use too, so engine intervals and
    the card's op traces load on one Perfetto timeline (the engine
    lane's clock is SIMULATED ms, scaled 1 sim-ms -> 1 trace-ms);
  * `engine_metrics_block` — the structured dict `bench_torch.py`
    embeds as ``engine_metrics`` in its JSON line (the schema of the
    JAX package's `bench.py` block).
"""

from __future__ import annotations

import dataclasses
import gzip
import json

import numpy as np

from .spec import CUMULATIVE, GAUGES, MetricsSpec


def to_host(x, dtype=np.int64) -> np.ndarray:
    """A carry leaf (a tensor on any device) as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


@dataclasses.dataclass
class MetricsFrame:
    """Host-side view of one chunk's metrics series."""

    spec: MetricsSpec
    t0: int
    series: np.ndarray          # int64 [T, K] — run axis already reduced

    @classmethod
    def from_carry(cls, spec: MetricsSpec, mc) -> "MetricsFrame":
        """Fetch a device `MetricsCarry`.  A per-seed carry (series
        ``[R, T, K]``, lockstep rows) is aggregated by SUMMING over the
        run axis — counts/bytes become batch aggregates, gauges become
        batch totals (e.g. done_count across all runs); per-run frames
        are one `mc.series[i]` slice away for callers that want them."""
        series = to_host(mc.series)
        t0 = to_host(mc.t0).reshape(-1)[0]
        if series.ndim == 3:
            series = series.sum(axis=0)
        return cls(spec=spec, t0=int(t0), series=series)

    @classmethod
    def from_carries(cls, spec: MetricsSpec, carries) -> "MetricsFrame":
        """Stitch consecutive chunks' carries into one frame.  Requires
        interval-aligned chunks (every chunk length a multiple of
        `stat_each_ms`) so rows concatenate without straddling."""
        frames = [cls.from_carry(spec, mc) for mc in carries]
        for a, b in zip(frames, frames[1:]):
            if b.t0 != a.t0 + a.n_intervals * spec.stat_each_ms:
                raise ValueError(
                    f"chunk carries are not interval-aligned (t0 {b.t0} "
                    f"follows {a.t0} + {a.n_intervals} x "
                    f"{spec.stat_each_ms}): run chunks whose length is a "
                    "multiple of stat_each_ms, or export each chunk's "
                    "frame separately")
        return cls(spec=spec, t0=frames[0].t0,
                   series=np.concatenate([f.series for f in frames]))

    @property
    def n_intervals(self) -> int:
        return self.series.shape[0]

    def times(self) -> np.ndarray:
        """Interval END times in absolute simulated ms."""
        e = self.spec.stat_each_ms
        return self.t0 + e * (1 + np.arange(self.n_intervals))

    def column(self, name: str) -> np.ndarray:
        i = self.spec.col(name)
        if i is None:
            raise KeyError(f"counter {name!r} not enabled in {self.spec}")
        return self.series[:, i]

    def filled(self, name: str) -> np.ndarray:
        """Sampled series with quiet (samples == 0) intervals
        forward-filled from the last sampled row; leading quiet rows
        stay 0 (counters start at zero)."""
        vals = self.column(name).copy()
        samples = self.column("samples") if self.spec.col("samples") \
            is not None else np.ones_like(vals)
        last = 0
        for i in range(vals.shape[0]):
            if samples[i] > 0:
                last = vals[i]
            else:
                vals[i] = last
        return vals

    def deltas(self, name: str) -> np.ndarray:
        """Per-interval deltas of a cumulative counter (forward-filled
        first, so quiet intervals contribute exactly 0)."""
        c = self.filled(name)
        return np.diff(np.concatenate([[0], c]))

    def totals(self) -> dict:
        """Whole-chunk totals: final cumulative values, additive sums,
        high-water maxima, final gauges."""
        out = {}
        for name in self.spec.columns:
            if name in CUMULATIVE:
                out[name] = int(self.filled(name)[-1])
            elif name in ("samples", "ff_skipped_ms", "ff_jumps"):
                out[name] = int(self.column(name).sum())
            elif name == "spill_hwm":
                out[name] = int(self.column(name).max(initial=0))
            else:                       # gauges: value at chunk end
                out[name] = int(self.filled(name)[-1])
        return out


def to_progress_csv(frame: MetricsFrame):
    """ProgressPerTime-style table: one row per interval — cumulative
    counters as per-interval deltas (`<name>` column) plus their
    running totals (`<name>_cum`), gauges forward-filled, additive
    columns as recorded.  Returns a `tools/csvf.CSVFormatter` (str() or
    .save(path) it)."""
    from ..tools.csvf import CSVFormatter

    spec = frame.spec
    cols = ["time"]
    for name in spec.columns:
        if name in CUMULATIVE:
            cols += [name, f"{name}_cum"]
        else:
            cols.append(name)
    csv = CSVFormatter(cols)
    times = frame.times()
    cum = {n: frame.filled(n) for n in spec.columns if n in CUMULATIVE}
    dlt = {n: frame.deltas(n) for n in cum}
    gauge = {n: frame.filled(n) for n in spec.columns if n in GAUGES}
    raw = {n: frame.column(n) for n in spec.columns
           if n not in CUMULATIVE and n not in GAUGES}
    for i in range(frame.n_intervals):
        row = {"time": int(times[i])}
        for n in cum:
            row[n] = int(dlt[n][i])
            row[f"{n}_cum"] = int(cum[n][i])
        for n in gauge:
            row[n] = int(gauge[n][i])
        for n in raw:
            row[n] = int(raw[n][i])
        csv.add(**row)
    return csv


#: pid of the engine lane in the emitted trace — distinct from any
#: device pid so a merged Perfetto session shows it as its own process.
ENGINE_PID = 90210


def to_perfetto(frame: MetricsFrame, path: str | None = None,
                name: str = "wtpu engine") -> dict:
    """Chrome-trace JSON for the engine's interval series.

    Event conventions: `process_name`/`thread_name` "M" metadata, "X" duration
    slices (one per executed interval, args = that row's counters) and
    "C" counter events per enabled series.  Timestamps are
    ``1 sim-ms -> 1000 trace-us`` so the sim clock reads in ms in the
    UI.  `path` (optional) writes the JSON; a ``.gz`` suffix gzips it.
    """
    spec = frame.spec
    e_ms = spec.stat_each_ms
    events = [
        {"ph": "M", "pid": ENGINE_PID, "name": "process_name",
         "args": {"name": f"{name} (simulated time)"}},
        {"ph": "M", "pid": ENGINE_PID, "tid": 0, "name": "thread_name",
         "args": {"name": "engine intervals"}},
    ]
    times = frame.times()
    samples = (frame.column("samples")
               if spec.col("samples") is not None
               else np.ones(frame.n_intervals, np.int64))
    dlt = {n: frame.deltas(n) for n in spec.columns if n in CUMULATIVE}
    for i in range(frame.n_intervals):
        ts_us = int(times[i] - e_ms) * 1000
        args = {n: int(frame.series[i, k])
                for k, n in enumerate(spec.columns)}
        args.update({f"{n}_delta": int(d[i]) for n, d in dlt.items()})
        if samples[i] > 0:
            events.append({
                "ph": "X", "pid": ENGINE_PID, "tid": 0, "ts": ts_us,
                "dur": e_ms * 1000, "name": "engine interval",
                "args": args})
        for k, n in enumerate(spec.columns):
            val = int(dlt[n][i]) if n in CUMULATIVE \
                else int(frame.series[i, k])
            events.append({"ph": "C", "pid": ENGINE_PID, "ts": ts_us,
                           "name": n, "args": {"value": val}})
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        if str(path).endswith(".gz"):
            with gzip.open(path, "wt") as f:
                json.dump(trace, f)
        else:
            with open(path, "w") as f:
                json.dump(trace, f)
    return trace


#: pid of the flight-recorder lane — its own process next to the
#: metrics lane (ENGINE_PID) and any device pids on a merged Perfetto
#: session.
TRACE_PID = 90211

#: per-node thread_name metadata is emitted for at most this many
#: distinct nodes (unnamed tids still render; the cap only bounds the
#: metadata volume for wide captures).
_MAX_NAMED_NODE_TRACKS = 512


def trace_to_perfetto(frame, path: str | None = None,
                      name: str = "wtpu flight recorder") -> dict:
    """Chrome-trace JSON for a decoded event stream (`TraceFrame`,
    obs/decode.py): per-NODE track events on the simulated-time axis.

    Same conventions and clock as `to_perfetto` (1 sim-ms -> 1000
    trace-us, `process_name`/`thread_name` "M" metadata, "X" slices),
    so a flight-recorder capture, the metrics interval lane and the
    card's op traces all load on ONE Perfetto timeline.  Track
    assignment: sends/drops/spill parks on the SOURCE node's track,
    deliveries/unparks on the DESTINATION's,
    node_down/node_up on the node's own; engine-global events
    (bc_retire, ff_jump) on tid 0.
    `path` (optional) writes the JSON; a ``.gz`` suffix gzips it.
    """
    from .trace import EVENTS, KIND

    src_side = {KIND["send"], KIND["drop"], KIND["spill_park"],
                KIND["node_down"], KIND["node_up"]}
    events = [
        {"ph": "M", "pid": TRACE_PID, "name": "process_name",
         "args": {"name": f"{name} (simulated time)"}},
        {"ph": "M", "pid": TRACE_PID, "tid": 0, "name": "thread_name",
         "args": {"name": "engine (global events)"}},
    ]
    named = set()
    for ev, buf in zip(frame.events, frame.buffer):
        t, kind, src, dst, nbytes, aux = (int(x) for x in ev)
        node = src if kind in src_side else dst
        tid = node + 1 if node >= 0 else 0
        if tid and tid not in named and len(named) < _MAX_NAMED_NODE_TRACKS:
            named.add(tid)
            events.append({"ph": "M", "pid": TRACE_PID, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"node {node}"}})
        events.append({
            "ph": "X", "pid": TRACE_PID, "tid": tid, "ts": t * 1000,
            "dur": 250, "name": EVENTS[kind],
            "args": {"src": src, "dst": dst, "payload_bytes": nbytes,
                     "aux": aux, "buffer": int(buf)}})
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        if str(path).endswith(".gz"):
            with gzip.open(path, "wt") as f:
                json.dump(trace, f)
        else:
            with open(path, "w") as f:
                json.dump(trace, f)
    return trace


#: base pid of the HOST span lanes — one pid per worker, numbered up
#: from here, next to the device lanes (ENGINE_PID / TRACE_PID) on a
#: merged Perfetto session.
SPAN_PID_BASE = 90300


def spans_to_perfetto(rows, device=None, path: str | None = None,
                      name: str = "wtpu host") -> dict:
    """Chrome-trace JSON merging HOST lifecycle spans (obs/spans.py
    rows) with an optional DEVICE trace (the dict returned by
    `to_perfetto` / `trace_to_perfetto`, or a list of such dicts).

    Track model: one Perfetto process per worker (pid counts up from
    SPAN_PID_BASE, workers sorted; spans without a worker attr group
    under ``host``), one thread per request id inside it (tid counts
    up from 1, rids sorted; spans with no rid — compile, grid phases,
    lease renewals — land on tid 0, the worker's scheduler track).

    Clock: host spans are wall SECONDS on a monotonic clock; they are
    re-zeroed at the earliest span start and scaled to trace-us, so
    the host timeline starts at 0 exactly like the device lanes'
    sim-ms clock (1 sim-ms -> 1000 trace-us, preserved untouched in
    the merged events).  Zero-duration marks become instant events.
    `path` (optional) writes the JSON; a ``.gz`` suffix gzips it.
    """
    rows = list(rows)
    t_min = min((float(r["t0"]) for r in rows), default=0.0)
    by_worker: dict = {}
    for r in rows:
        by_worker.setdefault(r.get("worker") or "host", []).append(r)
    events = []
    for i, w in enumerate(sorted(by_worker)):
        pid = SPAN_PID_BASE + i
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"{name} worker {w} "
                                        "(wall time)"}})
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "thread_name",
                       "args": {"name": "scheduler"}})
        rids = sorted({str(r["rid"]) for r in by_worker[w]
                       if r.get("rid") is not None})
        tid_of = {rid: j + 1 for j, rid in enumerate(rids)}
        for rid, tid in tid_of.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"request {rid}"}})
        for r in by_worker[w]:
            rid = r.get("rid")
            tid = tid_of[str(rid)] if rid is not None else 0
            ts = int(round((float(r["t0"]) - t_min) * 1e6))
            dur = int(round(float(r.get("dur", 0.0)) * 1e6))
            args = {k: v for k, v in r.items()
                    if k not in ("schema", "name", "t0", "dur",
                                 "worker")}
            ev = {"pid": pid, "tid": tid, "ts": ts, "name": r["name"],
                  "args": args}
            if dur > 0:
                ev.update(ph="X", dur=dur)
            else:
                ev.update(ph="i", s="t")
            events.append(ev)
    if device is not None:
        for dev in (device if isinstance(device, (list, tuple))
                    else (device,)):
            events.extend(dev.get("traceEvents", []))
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        if str(path).endswith(".gz"):
            with gzip.open(path, "wt") as f:
                json.dump(trace, f)
        else:
            with open(path, "w") as f:
                json.dump(trace, f)
    return trace


#: series longer than this are summarized (totals only) in the bench
#: JSON line — one JSON line must stay one line.
_MAX_SERIES_ROWS = 64


def engine_metrics_block(frame: MetricsFrame, extra: dict | None = None) \
        -> dict:
    """The ``engine_metrics`` block of a bench JSON line (the JAX
    package's schema, BENCH_NOTES.md).  Totals always; full
    per-interval series only up to _MAX_SERIES_ROWS rows
    (`"series_truncated": true` past that — no silent cap)."""
    out = {
        "stat_each_ms": frame.spec.stat_each_ms,
        "t0": frame.t0,
        "intervals": frame.n_intervals,
        "counters": list(frame.spec.columns),
        "totals": frame.totals(),
    }
    if frame.n_intervals <= _MAX_SERIES_ROWS:
        out["series"] = {
            "time": [int(x) for x in frame.times()],
            **{n: [int(x) for x in frame.column(n)]
               for n in frame.spec.columns},
        }
    else:
        out["series_truncated"] = True
    if extra:
        out.update(extra)
    return out


def time_to_done_ms(engine_metrics: dict | None):
    """Earliest interval end (absolute sim ms) at which the run's
    final `done_count` was already reached, from an `engine_metrics`
    block's series; None when metrics are off, the series was
    truncated, or nothing ever finished (the JAX package's matrix
    report and serve ledger read it from the same block)."""
    if not engine_metrics or "series" not in engine_metrics:
        return None
    series = engine_metrics["series"]
    if "done_count" not in series:
        return None
    final = engine_metrics.get("totals", {}).get("done_count", 0)
    if final <= 0:
        return None
    vals = series["done_count"]
    samples = series.get("samples")
    times = series["time"]
    last = 0
    for i, t in enumerate(times):
        # forward-fill quiet (samples == 0) intervals, the
        # MetricsFrame.filled contract — a fast-forwarded row holds 0s
        if samples is None or samples[i] > 0:
            last = vals[i]
        if last >= final:
            return int(t)
    return None
