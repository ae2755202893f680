"""Device side of the metrics plane: the interval recorder — the port of
`wittgenstein_tpu/obs/plane.py`.

`MetricsCarry` rides the engine chunk beside the simulation state: a
fixed-shape ``[T, K]`` int32 series (``[R, T, K]`` for a seed batch),
one row per `stat_each_ms` interval, updated once per executed window
from pure reductions of the state the engine already keeps.  Nothing
here writes the simulation state, draws a random number or reads the
device from the host: the interval row of an executed ms is computed
from the chunk's time, which the engine carries as a Python int, so a
recording is a few reductions and one row write on the device.  That is
what makes metrics-ON bit-identical to metrics-OFF on the
`NetState`/`pstate` trajectory (tests/test_torch_obs.py).

Sampling semantics (obs/spec.py COUNTERS):
  * cumulative counters and gauges are written last-write-wins, so an
    interval row holds their value AS OF its last executed ms;
  * under fast-forwarding, intervals wholly inside a quiet window keep
    ``samples == 0`` and are forward-filled on the host
    (`export.MetricsFrame`): a skipped ms is a no-op step;
  * a fast-forward jump is attributed once, to the interval containing
    its origin ms (`record_jump`), even when it spans several rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import _Struct, register_struct
from .spec import _ADDITIVE, _HIGH_WATER, MetricsSpec

I32 = torch.int32


@register_struct
@dataclasses.dataclass(frozen=True)
class MetricsCarry(_Struct):
    """The on-device series: ``series[..., i, k]`` = counter k over
    interval ``[t0 + i*stat_each_ms, t0 + (i+1)*stat_each_ms)``; a seed
    batch has a leading R axis on both leaves."""

    t0: torch.Tensor        # int32 scalar (or [R]): chunk entry time
    series: torch.Tensor    # int32 [T, K] (or [R, T, K])


def init_metrics(spec: MetricsSpec, ms: int, t0) -> MetricsCarry:
    """Fresh zeroed carry covering a chunk of `ms` simulated ms; `t0` is
    the entry time tensor (``net.time``: a scalar, or [R] for a
    batch)."""
    t0 = t0.to(I32).clone()
    return MetricsCarry(t0=t0, series=torch.zeros(
        tuple(t0.shape) + (spec.n_intervals(ms), len(spec.columns)),
        dtype=I32, device=t0.device))


def _rings(net, name):
    """A ring leaf as a list of its node-range sub-planes."""
    leaf = getattr(net, name)
    return list(leaf) if isinstance(leaf, tuple) else [leaf]


def counter_values(spec: MetricsSpec, net) -> dict:
    """Current values of the enabled sampled and high-water counters, as
    int32 tensors (scalars, or [R] for a batch), from one NetState or a
    seed batch of them (wittgenstein_tpu/obs/plane.py:50-90): pure
    reductions over state the engine already maintains, so observing
    the state IS observing the engine's choke points."""
    lead = net.time.dim()
    nodes = net.nodes
    cols = set(spec.columns)
    out = {}

    def total(x):
        """Sum over every axis after the seed axis, in int32."""
        return x.sum(tuple(range(lead, x.dim())), dtype=I32)

    if "msg_sent" in cols:
        out["msg_sent"] = total(nodes.msg_sent)
    if "msg_received" in cols:
        out["msg_received"] = total(nodes.msg_received)
    if "bytes_sent" in cols:
        out["bytes_sent"] = total(nodes.bytes_sent)
    if "bytes_received" in cols:
        out["bytes_received"] = total(nodes.bytes_received)
    if "done_count" in cols:
        out["done_count"] = total((~nodes.down) & (nodes.done_at > 0))
    if "live_count" in cols:
        out["live_count"] = total(~nodes.down)
    if "ring_rows" in cols:
        # a row holds a delivery when any node of any sub-plane has one
        rows = None
        for count in _rings(net, "box_count"):
            hit = (count > 0).any(-1)
            rows = hit if rows is None else rows | hit
        out["ring_rows"] = total(rows)
    if "ring_occupancy" in cols:
        occ = [total(count) for count in _rings(net, "box_count")]
        out["ring_occupancy"] = occ[0] if len(occ) == 1 else \
            torch.stack(occ).sum(0, dtype=I32)
    if "bc_live" in cols:
        out["bc_live"] = total(net.bc_active)
    if "spill_hwm" in cols:
        out["spill_hwm"] = total(net.sp_arrival >= 0)
    if "drop_count" in cols:
        out["drop_count"] = (net.dropped + net.bc_dropped + net.clamped +
                             net.sp_dropped)
    return out


def interval_row(spec: MetricsSpec, mc: MetricsCarry, t0: int,
                 t: int) -> int:
    """The series row of absolute ms `t` in a chunk entered at `t0`,
    clipped to the carry as the JAX recorder clips it."""
    return min(max((t - t0) // spec.stat_each_ms, 0),
               mc.series.shape[-2] - 1)


def record(spec: MetricsSpec, mc: MetricsCarry, row: int, values: dict,
           n_steps: int = 1) -> MetricsCarry:
    """Fold one executed ms (or a K-ms window: ``n_steps=K``) into its
    interval row (wittgenstein_tpu/obs/plane.py:93-115).  The carry
    belongs to its chunk builder, so the row is written in place."""
    old = mc.series[..., row, :]
    new = []
    for i, name in enumerate(spec.columns):
        if name == "samples":
            new.append(old[..., i] + n_steps)
        elif name in _HIGH_WATER:
            new.append(torch.maximum(old[..., i], values[name]))
        elif name in _ADDITIVE:
            new.append(old[..., i])     # ff_*: written by record_jump only
        else:
            new.append(values[name].expand(old.shape[:-1]))
    mc.series[..., row, :] = torch.stack(new, -1)
    return mc


def record_step(spec: MetricsSpec, mc: MetricsCarry, net, t0: int, t: int,
                n_steps: int = 1) -> MetricsCarry:
    """Record the step(s) that just ran, the chunk having been entered
    at `t0`: `t` is the time after them (``net.time``), so the last
    executed ms is ``t - 1`` (wittgenstein_tpu/obs/plane.py:118-123)."""
    return record(spec, mc, interval_row(spec, mc, t0, t - 1),
                  counter_values(spec, net), n_steps=n_steps)


def record_jump(spec: MetricsSpec, mc: MetricsCarry, t0: int, t_from: int,
                dt: int) -> MetricsCarry:
    """Attribute a fast-forward jump of `dt` quiet ms to the interval
    containing its origin `t_from` (wittgenstein_tpu/obs/plane.py:
    126-142); ``dt == 0`` adds nothing."""
    i_skip = spec.col("ff_skipped_ms")
    i_jump = spec.col("ff_jumps")
    if dt == 0 or (i_skip is None and i_jump is None):
        return mc
    row = interval_row(spec, mc, t0, t_from)
    if i_skip is not None:
        mc.series[..., row, i_skip] += dt
    if i_jump is not None:
        mc.series[..., row, i_jump] += 1
    return mc
