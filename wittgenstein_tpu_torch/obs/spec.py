"""MetricsSpec — the static shape/enable contract of the metrics plane;
the port of `wittgenstein_tpu/obs/spec.py`, unchanged.

A spec is hashable (like `EngineConfig`): the interval length and the
enabled-counter subset select which reductions the instrumented step
runs, and fix the ``[T, K]`` series layout (T intervals x K enabled
counters, canonical column order).
"""

from __future__ import annotations

import dataclasses

#: Canonical counter order (= series column order when all are enabled).
#: Three kinds, by how an executed ms updates its interval row:
#:   sampled   — cumulative engine counters / state gauges written with
#:               last-write-wins (the row holds the value AS OF the last
#:               executed ms of the interval; host-side diffing turns the
#:               cumulative ones into per-interval deltas);
#:   high-water — max over the interval's executed ms;
#:   additive  — accumulated into the interval (samples per executed ms,
#:               ff_* by `record_jump` at a jump's origin interval).
COUNTERS = (
    "samples",          # additive: engine steps executed in this interval
    "msg_sent",         # sampled cum: sum over nodes of NodeState.msg_sent
    "msg_received",     # sampled cum
    "bytes_sent",       # sampled cum
    "bytes_received",   # sampled cum
    "done_count",       # sampled gauge: live nodes with done_at > 0
    "live_count",       # sampled gauge: nodes not down
    "ring_rows",        # sampled gauge: mailbox ring rows holding any delivery
    "ring_occupancy",   # sampled gauge: total pending unicast deliveries
    "bc_live",          # sampled gauge: active broadcast-table records
    "spill_hwm",        # high-water: parked spill entries (spill_cap > 0)
    "drop_count",       # sampled cum: dropped + bc_dropped + clamped + sp_dropped
    "ff_skipped_ms",    # additive: fast-forwarded ms originating here
    "ff_jumps",         # additive: fast-forward jumps originating here
)

_ADDITIVE = ("samples", "ff_skipped_ms", "ff_jumps")
_HIGH_WATER = ("spill_hwm",)
#: cumulative counters a host-side diff turns into per-interval deltas
CUMULATIVE = ("msg_sent", "msg_received", "bytes_sent", "bytes_received",
              "drop_count")
GAUGES = ("done_count", "live_count", "ring_rows", "ring_occupancy",
          "bc_live")


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Static instrumentation parameters (hashable).

    stat_each_ms — interval length in simulated ms (the reference's
    `ProgressPerTime` sampling period, ProgressPerTime.java:53-149).
    counters — enabled counter subset; stored in canonical COUNTERS
    order regardless of the order passed.
    """

    stat_each_ms: int = 10
    counters: tuple = COUNTERS

    def __post_init__(self):
        if self.stat_each_ms < 1:
            raise ValueError(f"stat_each_ms must be >= 1, got "
                             f"{self.stat_each_ms}")
        unknown = [c for c in self.counters if c not in COUNTERS]
        if unknown:
            raise ValueError(f"unknown counters {unknown}; known: "
                             f"{COUNTERS}")
        # canonical order + dedup, so the column layout is a pure
        # function of the enabled SET
        object.__setattr__(
            self, "counters",
            tuple(c for c in COUNTERS if c in set(self.counters)))

    @property
    def columns(self) -> tuple:
        """Series column names, in order."""
        return self.counters

    def col(self, name: str) -> int | None:
        """Column index of `name`, or None when not enabled."""
        try:
            return self.columns.index(name)
        except ValueError:
            return None

    def n_intervals(self, ms: int) -> int:
        """Rows needed to cover a chunk of `ms` simulated milliseconds."""
        return -(-int(ms) // self.stat_each_ms)
