"""Serve-plane instrumentation bundle: spans + metrics, one handle.

The scheduler, fleet worker and matrix driver each accept
``instrument=`` (default None).  When None — the production default —
every site reduces to one attribute load and an is-None branch: zero
allocations, zero locks, nothing imported beyond this module
(tests/test_obs_spans.py pins it).  When set, the handle carries

  * a `SpanRecorder` (obs/spans.py): the request-lifecycle flight
    recorder, optionally durable as JSONL for crash postmortems;
  * a `MetricsRegistry` (obs/metrics.py): the scrapeable counters /
    gauges / histograms behind ``GET /w/batch/metrics``.

`end()` is the one write path phases go through: it closes the span
AND feeds the matching phase histogram, so the Perfetto timeline and
the Prometheus exposition can never disagree about what was measured.

Counters are NOT incremented at event sites.  The scheduler already
keeps monotone resilience counters under its lock; duplicating them
here would invite drift.  Instead `refresh_scheduler_metrics`
projects them (and the fleet's lease counters, via
`refresh_fleet_counters`) into the registry at scrape/settle time
through `set_counter`, which keeps max() — so the exposed series are
monotone across scrapes by construction.

The port's own copy of `wittgenstein_tpu/serve/instrument.py`, which has no JAX in it: the port imports nothing of the JAX package, so it keeps this module line for line (the spans, exposition text, journal rows and ledger rows are byte for byte the JAX package's).
"""

from __future__ import annotations

from ..obs.metrics import MetricsRegistry
from ..obs.spans import SpanRecorder

# ----------------------------------------------------------- span names

SPAN_SUBMIT = "serve.submit"          # validate + admit + journal ack
SPAN_QUEUE_WAIT = "serve.queue_wait"  # journal ack -> marked running
SPAN_COMPILE = "serve.compile"        # registry chunk_fn build/lookup
SPAN_LAUNCH = "serve.launch"          # one bounded launch attempt
SPAN_CHUNK = "serve.chunk"            # one chunk boundary to the next
SPAN_SETTLE = "serve.settle"          # artifact build + ledger append
SPAN_RESUME = "serve.resume"          # checkpoint restore, per request
SPAN_REPLAY = "serve.replay"          # journal replay adoption
MARK_PREEMPT = "serve.preempt"        # checkpoint-preempted at boundary
MARK_RETRY = "serve.retry"            # launch attempt failed, retrying
MARK_DEGRADE = "serve.degrade"        # width-degradation bisection step
MARK_QUARANTINE = "serve.quarantine"  # poison-lane verdict
MARK_WATCHDOG = "serve.watchdog_trip"
FLEET_CLAIM = "fleet.claim"
FLEET_RENEW = "fleet.renew"
FLEET_ADOPT_CKPT = "fleet.adopt_checkpoint"
FLEET_ADOPT_JOURNAL = "fleet.adopt_journal"
GRID_SUBMIT = "grid.submit"           # one submission wave
GRID_DRAIN = "grid.drain"             # drain-to-settled wait
GRID_HARVEST = "grid.harvest"         # cell artifact harvest

#: the per-request lifecycle in first-occurrence start order
#: (bench_suite `spans_smoke` asserts a served request produced all of
#: these, in this order).  The launch attempt nests INSIDE its chunk
#: span — the chunk opens at the boundary, then launches the device
#: call — so chunk precedes launch by t0 while enclosing it by span.
LIFECYCLE = (SPAN_SUBMIT, SPAN_QUEUE_WAIT, SPAN_COMPILE, SPAN_CHUNK,
             SPAN_LAUNCH, SPAN_SETTLE)

#: the phase block surfaced in `/w/batch/health` (satellite: span-
#: derived p50/p99 next to the chunk-wall EMA)
HEALTH_PHASES = (SPAN_QUEUE_WAIT, SPAN_COMPILE, SPAN_LAUNCH)

#: span name -> histogram fed by `Instrumentation.end`
PHASE_HISTOGRAMS = {
    SPAN_QUEUE_WAIT: "wtpu_serve_queue_wait_seconds",
    SPAN_COMPILE: "wtpu_serve_compile_seconds",
    SPAN_LAUNCH: "wtpu_serve_launch_seconds",
    SPAN_CHUNK: "wtpu_serve_chunk_seconds",
}

#: scheduler resilience counter -> exposed counter name
RESILIENCE_COUNTERS = {
    "rejected": "wtpu_serve_rejected_429_total",
    "retries": "wtpu_serve_retries_total",
    "demotions": "wtpu_serve_degradations_total",
    "preemptions": "wtpu_serve_preemptions_total",
    "resumed": "wtpu_serve_resumed_total",
    "quarantined": "wtpu_serve_quarantined_total",
    "watchdog_trips": "wtpu_serve_watchdog_trips_total",
    "replayed": "wtpu_serve_replayed_total",
    "repacked": "wtpu_serve_repacked_total",
}

#: fleet worker counter -> exposed counter name (reclaims = foreign
#: checkpoints adopted from another worker's lease)
FLEET_COUNTERS = {
    "claimed": "wtpu_fleet_lease_claims_total",
    "renewed": "wtpu_fleet_lease_renews_total",
    "adopted_checkpoints": "wtpu_fleet_lease_reclaims_total",
}

#: memo/search counter -> exposed counter name.  The sources are the
#: fleet worker's counters dict and the search driver's memo-stats
#: block (matrix/search.py) — both monotone over a process lifetime,
#: so max-keeping `set_counter` projection preserves monotonicity
#: across scrapes (the convention of the module docstring).
SEARCH_COUNTERS = {
    "memo_table_hits": "wtpu_memo_table_hits_total",
    "memo_table_misses": "wtpu_memo_table_misses_total",
    "prefix_chunks_saved": "wtpu_memo_prefix_chunks_saved_total",
    "search_probes_total": "wtpu_search_probes_total",
}


class Instrumentation:
    """One handle bundling the span recorder and the metrics registry.

    Constructed by the operator-facing entry points (serve_load
    ``--timeline``, fleet ``--timeline``, tests) and handed to
    `Scheduler(instrument=...)` / `FleetWorker(instrument=...)`; the
    serve plane itself never constructs one."""

    def __init__(self, *, span_path=None, fsync: bool = False,
                 clock=None, worker=None, capacity: int = 4096,
                 metrics=None):
        self.spans = SpanRecorder(capacity=capacity, path=span_path,
                                  fsync=fsync, clock=clock,
                                  worker=worker)
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()

    # thin delegations so instrumented sites touch one object --------

    def now(self) -> float:
        return self.spans.now()

    def end(self, name, t0, t1=None, **attrs) -> dict:
        """Close a phase span and feed its histogram (if any)."""
        row = self.spans.emit(name, t0, t1, **attrs)
        hist = PHASE_HISTOGRAMS.get(name)
        if hist is not None:
            self.metrics.observe(hist, row["dur"])
        return row

    def mark(self, name, **attrs) -> dict:
        return self.spans.mark(name, **attrs)

    def health_phases(self) -> dict:
        """Span-derived phase quantiles for `/w/batch/health`."""
        return self.spans.phase_quantiles(names=HEALTH_PHASES)


# ------------------------------------------------------- projections

def refresh_scheduler_metrics(metrics, sch) -> None:
    """Project a scheduler's monotone state into `metrics` (see
    module docstring for why scrape-time projection, not event-time
    increments)."""
    hs = sch.health_stats()
    res = hs.get("resilience") or {}
    for key, name in RESILIENCE_COUNTERS.items():
        metrics.set_counter(name, res.get(key, 0))
    # total submission attempts = rids minted + admission rejections
    metrics.set_counter("wtpu_serve_submits_total",
                        hs.get("submitted", 0) + res.get("rejected", 0))
    metrics.set_gauge("wtpu_serve_queue_depth", hs.get("queued", 0))
    metrics.set_gauge("wtpu_serve_running", hs.get("running", 0))
    lag = hs.get("journal_lag")
    if lag is not None:
        metrics.set_gauge("wtpu_serve_journal_lag", lag)
    ema = hs.get("chunk_wall_ema_s")
    if ema:
        metrics.set_gauge("wtpu_serve_chunk_wall_ema_seconds", ema)
    # compile-registry warm/cold story (satellite of the program
    # observatory: the per-artifact registry_block()s stay, but a
    # scrape should not need an artifact to see the hit ratio)
    reg = getattr(sch, "registry", None)
    if reg is not None:
        metrics.set_gauge("wtpu_registry_hits", reg.hits)
        metrics.set_gauge("wtpu_registry_misses", reg.misses)


def refresh_fleet_counters(metrics, counters) -> None:
    """Project a `FleetWorker.counters` dict into `metrics`."""
    for key, name in FLEET_COUNTERS.items():
        if key in counters:
            metrics.set_counter(name, counters[key])


def refresh_search_counters(metrics, counters) -> None:
    """Project memo/search counters (fleet worker counters dict or a
    search driver's accounting block) into `metrics`."""
    for key, name in SEARCH_COUNTERS.items():
        if key in counters:
            metrics.set_counter(name, counters[key])


def scheduler_exposition(sch) -> str:
    """The `GET /w/batch/metrics` body for an in-process scheduler:
    refresh projections, then render.  Works uninstrumented too — a
    transient registry still yields monotone series because every
    projected source is itself monotone."""
    ins = getattr(sch, "_ins", None)
    metrics = ins.metrics if ins is not None else MetricsRegistry()
    refresh_scheduler_metrics(metrics, sch)
    cat = getattr(sch, "catalog", None)
    if cat is not None:
        from ..obs.programs import refresh_catalog_metrics
        refresh_catalog_metrics(metrics, cat)
    return metrics.exposition()


def ledger_metrics_block(sch) -> dict:
    """The per-settle metrics snapshot embedded in ledger rows (only
    called when the scheduler is instrumented)."""
    ins = sch._ins
    refresh_scheduler_metrics(ins.metrics, sch)
    return ins.metrics.snapshot()
