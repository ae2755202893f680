"""Host side of the event flight recorder: TraceFrame + formatting; the
port of `wittgenstein_tpu/obs/decode.py`.

A `TraceFrame` wraps the fetched event ring(s) of one or more
`TraceCarry` pytrees (obs/trace.py) as a structured ``[E, 6]`` int64
array in recorded order, plus the truncation accounting (`dropped`,
`high_water`) that makes a silently-clipped trace impossible: every
consumer — `Runner.trace_stats`, the bench ``trace`` JSON block, the
divergence bisector — surfaces the counter.

Per-seed / per-shard carries (leading batch axes on the buffer) decode
into one frame with a parallel ``buffer`` column; multi-buffer frames
are stable-sorted by event time so lockstep streams interleave on one
timeline while each buffer's within-ms order is preserved.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .export import to_host
from .trace import EVENTS, FIELDS, KIND, TraceSpec

_COL = {name: i for i, name in enumerate(FIELDS)}


@dataclasses.dataclass
class TraceFrame:
    """Host-side view of one capture's event stream."""

    spec: TraceSpec
    events: np.ndarray          # int64 [E, 6] — FIELDS order
    buffer: np.ndarray          # int64 [E] — originating seed/shard ring
    dropped: int                # events lost to full rings (sum)
    high_water: int             # max rows any single ring filled

    @classmethod
    def from_carry(cls, spec: TraceSpec, tc) -> "TraceFrame":
        """Fetch a device `TraceCarry`.  A batched carry (leading axes
        on every leaf — per-seed or per-shard rings) is merged onto one
        timeline: events keep their per-buffer order and are stable-
        sorted by time across buffers."""
        buf = to_host(tc.buf)
        cursor = to_host(tc.cursor).reshape(-1)
        dropped = int(to_host(tc.dropped).sum())
        bufs = buf.reshape((-1,) + buf.shape[-2:])
        evs, ids = [], []
        for i, (b, c) in enumerate(zip(bufs, cursor)):
            evs.append(b[:c])
            ids.append(np.full(int(c), i, np.int64))
        events = (np.concatenate(evs) if evs
                  else np.zeros((0, len(FIELDS)), np.int64))
        buffer = (np.concatenate(ids) if ids else np.zeros((0,), np.int64))
        if len(bufs) > 1 and events.shape[0]:
            order = np.argsort(events[:, _COL["time_ms"]], kind="stable")
            events, buffer = events[order], buffer[order]
        return cls(spec=spec, events=events, buffer=buffer,
                   dropped=dropped,
                   high_water=int(cursor.max(initial=0)))

    @classmethod
    def from_carries(cls, spec: TraceSpec, carries) -> "TraceFrame":
        """Stitch consecutive chunks' carries into one frame (chunk
        order = time order for a single run; truncation accounting is
        summed/maxed across chunks)."""
        frames = [cls.from_carry(spec, tc) for tc in carries]
        return cls(
            spec=spec,
            events=np.concatenate([f.events for f in frames])
            if frames else np.zeros((0, len(FIELDS)), np.int64),
            buffer=np.concatenate([f.buffer for f in frames])
            if frames else np.zeros((0,), np.int64),
            dropped=sum(f.dropped for f in frames),
            high_water=max((f.high_water for f in frames), default=0))

    # ------------------------------------------------------------ views

    @property
    def n_events(self) -> int:
        return self.events.shape[0]

    def column(self, name: str) -> np.ndarray:
        return self.events[:, _COL[name]]

    def counts(self) -> dict:
        """Events per kind name (only kinds that occur)."""
        kinds, n = np.unique(self.column("kind"), return_counts=True)
        return {EVENTS[int(k)]: int(c) for k, c in zip(kinds, n)}

    def _select(self, mask) -> "TraceFrame":
        return dataclasses.replace(self, events=self.events[mask],
                                   buffer=self.buffer[mask])

    def window(self, t_lo: int, t_hi: int) -> "TraceFrame":
        """Events with ``t_lo <= time_ms < t_hi``."""
        t = self.column("time_ms")
        return self._select((t >= t_lo) & (t < t_hi))

    def filter(self, kinds=None, node=None) -> "TraceFrame":
        """Restrict to kind names and/or events touching `node` (src or
        dst)."""
        mask = np.ones(self.n_events, bool)
        if kinds is not None:
            codes = {KIND[k] for k in kinds}
            mask &= np.isin(self.column("kind"), sorted(codes))
        if node is not None:
            mask &= ((self.column("src") == node) |
                     (self.column("dst") == node))
        return self._select(mask)

    def rows(self) -> list:
        """Structured dicts, one per event (kind decoded to its name)."""
        out = []
        for ev in self.events:
            d = {name: int(ev[i]) for i, name in enumerate(FIELDS)}
            d["kind"] = EVENTS[d["kind"]]
            out.append(d)
        return out

    def format(self, limit: int | None = 50) -> str:
        """Human-readable event listing (``limit=None`` for all)."""
        lines = []
        evs = self.events if limit is None else self.events[:limit]
        for ev in evs:
            t, kind, src, dst, nbytes, aux = (int(x) for x in ev)
            dst_s = "all" if dst == -1 else f"{dst}"
            lines.append(f"[{t:>7} ms] {EVENTS[kind]:<12} "
                         f"src={src:>5} dst={dst_s:>5} "
                         f"{nbytes:>6} B aux={aux}")
        extra = self.n_events - len(evs)
        if extra > 0:
            lines.append(f"... {extra} more events")
        if self.dropped:
            lines.append(f"!! ring truncated: {self.dropped} events "
                         f"dropped (capacity {self.spec.capacity}) — "
                         "raise TraceSpec.capacity")
        return "\n".join(lines)


def trace_block(frame: TraceFrame, extra: dict | None = None) -> dict:
    """The ``trace`` block of a bench JSON line (the JAX package's
    schema, BENCH_NOTES.md r9): truncation accounting always — a
    clipped trace announces itself — plus per-kind counts; never the
    raw event rows (one JSON line must stay one line)."""
    out = {
        "capacity": frame.spec.capacity,
        "events": frame.n_events,
        "high_water": frame.high_water,
        "dropped": frame.dropped,
        "truncated": frame.dropped > 0,
        "counts": frame.counts(),
    }
    if frame.spec.node_filter is not None:
        out["node_filter"] = list(frame.spec.node_filter)
    if extra:
        out.update(extra)
    return out
