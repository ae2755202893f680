"""Device side of the event flight recorder: message-level tracing — the
port of `wittgenstein_tpu/obs/trace.py`.

The metrics plane (obs/plane.py) answers "how much" per interval; this
module answers "which message, when, to whom".  A fixed-shape ring
(`TraceCarry`: a ``[capacity, 6]`` int32 event buffer, a write cursor
and a saturating ``dropped`` counter) rides the engine chunk beside the
state, and the host decoder (obs/decode.py) turns it into structured
events after the chunk returns.  Every append is a masked cumsum and
one row scatter on the device: no host read.

Event record layout (``FIELDS``): ``(time_ms, kind, src, dst,
payload_bytes, aux)``; the kinds (``EVENTS``) and their aux fields are
the JAX package's (wittgenstein_tpu/obs/trace.py:16-47), and so is the
order events are appended in.

Observation happens through the engine's `tap` hook
(`core/network.step_kms`): ``tap(t, net, None)`` at ms entry reads the
ms's ring row, pre-retire broadcast table and spill drain set; ``tap(t,
net, out)`` right after the protocol step reads the outbox.  Everything
recorded is a pure function of ``(t, state, outbox)``, so trace-ON is
bit-identical on the ``(NetState, pstate)`` trajectory, and ``tap=None``
runs no extra operation.  Inside a K-ms window the taps fire per
simulated ms, so every event carries its exact origin ms.  On a seed
batch the taps get the batch, and the per-run recorder runs under
`torch.func.vmap` with per-seed rings.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.latency import full_latency
from ..core.network import (broadcast_arrivals, check_chunk_config,
                            fast_forward_chunk, step_kms, step_ms)
from ..core.state import _Struct, register_struct
from ..ops import prng

I32 = torch.int32

#: Canonical event kinds; the kind CODE is the index here and is stable
#: regardless of which subset a spec enables (decode uses this table).
EVENTS = ("send", "deliver", "drop", "spill_park", "spill_unpark",
          "bc_retire", "ff_jump", "node_down", "node_up")
KIND = {name: i for i, name in enumerate(EVENTS)}

#: Event record columns, in buffer order.
FIELDS = ("time_ms", "kind", "src", "dst", "payload_bytes", "aux")

_I32_MAX = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Static flight-recorder parameters (hashable;
    wittgenstein_tpu/obs/trace.py:82-124).

    capacity — event ring rows; once full, further events are counted
    in the saturating ``dropped`` counter instead of overwriting.
    events — enabled kind subset (canonical EVENTS order); disabled
    kinds are never computed.
    node_filter — optional ``(lo, hi)`` global-node-id half-open range:
    only events touching a node in range (src or dst) are recorded
    (`ff_jump` is global and always kept).
    """

    capacity: int = 4096
    events: tuple = EVENTS
    node_filter: tuple | None = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        unknown = [e for e in self.events if e not in EVENTS]
        if unknown:
            raise ValueError(f"unknown events {unknown}; known: {EVENTS}")
        object.__setattr__(
            self, "events",
            tuple(e for e in EVENTS if e in set(self.events)))
        if self.node_filter is not None:
            lo, hi = self.node_filter
            if not (isinstance(lo, int) and isinstance(hi, int) and lo < hi):
                raise ValueError(
                    f"node_filter must be an int (lo, hi) half-open range "
                    f"with lo < hi, got {self.node_filter!r}")
            object.__setattr__(self, "node_filter", (int(lo), int(hi)))

    def enabled(self, name: str) -> bool:
        return name in self.events


@register_struct
@dataclasses.dataclass(frozen=True)
class TraceCarry(_Struct):
    """The on-device event ring (wittgenstein_tpu/obs/trace.py:127-145):
    ``buf[i]`` is the i-th recorded event for ``i < cursor``; `dropped`
    counts events that found the ring full (saturating); `down` is the
    last OBSERVED per-node down state the node_down/node_up detection
    differences against ([0]-shaped: detection off).  A seed batch has a
    leading R axis on every leaf."""

    buf: torch.Tensor       # int32 [capacity, 6]
    cursor: torch.Tensor    # int32 scalar — rows written (<= capacity)
    dropped: torch.Tensor   # int32 scalar
    down: torch.Tensor      # bool [N] (or [0])


def init_trace(spec: TraceSpec, down) -> TraceCarry:
    """Fresh empty ring (wittgenstein_tpu/obs/trace.py:148-161), seeded
    with the chunk ENTRY down state ``net.nodes.down`` ([N], or [R, N]
    for a batch: one ring a seed), so a node already down at entry is
    not recorded."""
    lead = tuple(down.shape[:-1])
    dev = down.device
    return TraceCarry(
        buf=torch.zeros(lead + (spec.capacity, len(FIELDS)), dtype=I32,
                        device=dev),
        cursor=torch.zeros(lead, dtype=I32, device=dev),
        dropped=torch.zeros(lead, dtype=I32, device=dev),
        down=down.clone())


def _append(spec: TraceSpec, tc: TraceCarry, t: int, kind: int, src, dst,
            nbytes, aux, valid) -> TraceCarry:
    """Compact-append the masked candidate batch
    (wittgenstein_tpu/obs/trace.py:164-194): the i-th valid entry (in
    index order) lands at ``cursor + i``; entries past capacity are
    dropped and counted.  One masked cumsum and one row scatter into
    the ring padded by a dump row, out of place (it runs under
    `torch.func.vmap` on a batch)."""
    cap = spec.capacity
    m = valid.shape[0]
    if spec.node_filter is not None and kind != KIND["ff_jump"]:
        lo, hi = spec.node_filter
        keep = ((src >= lo) & (src < hi)) | ((dst >= lo) & (dst < hi))
        valid = valid & keep
    valid_i = valid.to(I32)
    pos = tc.cursor + valid_i.cumsum(0, dtype=I32) - 1
    ok = valid & (pos < cap)
    idx = torch.where(ok, pos, cap).long()

    def col(x):
        if isinstance(x, torch.Tensor):
            return x.to(I32).expand(m)
        return torch.full((m,), x, dtype=I32, device=valid.device)

    ev = torch.stack([col(t), col(kind), col(src), col(dst), col(nbytes),
                      col(aux)], 1)
    pad = torch.cat([tc.buf, tc.buf.new_zeros(1, len(FIELDS))])
    buf = pad.scatter(0, idx[:, None].expand(m, len(FIELDS)), ev)[:cap]
    nv = valid_i.sum(dtype=I32)
    written = torch.minimum(nv, (cap - tc.cursor).clamp_min(0))
    dropped = tc.dropped + (nv - written)
    # saturate instead of wrapping negative on pathological volumes
    dropped = torch.where(dropped < tc.dropped, _I32_MAX, dropped)
    return tc.replace(buf=buf, cursor=tc.cursor + written, dropped=dropped)


def _ring_row(net, name, h):
    """Ring row `h` of leaf `name` ([N, ...] cells), the sub-planes of a
    split ring joined on the node axis."""
    leaf = getattr(net, name)
    if isinstance(leaf, tuple):
        return torch.cat([x[h] for x in leaf])
    return leaf[h]


def _unicast_row(cfg, net, t: int):
    """The time-t unicast ring row, shaped for observation: the slice
    the engine reads, minus the counter bumps
    (wittgenstein_tpu/obs/trace.py:197-225).  ``(src [N, C], size [N,
    C], valid [N, C])`` with the delivery-time down/partition checks
    applied."""
    nodes = net.nodes
    h = t % cfg.horizon
    src = _ring_row(net, "box_src", h)
    size = _ring_row(net, "box_size", h)
    count = _ring_row(net, "box_count", h)
    slots = torch.arange(cfg.inbox_cap, dtype=I32, device=src.device)
    valid = slots[None, :] < count[:, None]
    deliver_ok = (~nodes.down[:, None]) & (
        nodes.partition[src] == nodes.partition[:, None])
    return src, size, valid & deliver_ok


def _entry_events(spec: TraceSpec, cfg, model, tc: TraceCarry, t: int,
                  net) -> TraceCarry:
    """Events observable at ms entry (wittgenstein_tpu/obs/trace.py:
    228-290): churn transitions, this ms's deliveries (unicast ring row,
    then the broadcast recompute), broadcast retirements, spill
    re-injections, in that order."""
    nodes = net.nodes
    n = cfg.n
    dev = nodes.down.device
    node_idx = torch.arange(n, dtype=I32, device=dev)
    if tc.down.shape[0] > 0 and (spec.enabled("node_down")
                                 or spec.enabled("node_up")):
        cur = nodes.down
        zero = torch.zeros(n, dtype=I32, device=dev)
        if spec.enabled("node_down"):
            tc = _append(spec, tc, t, KIND["node_down"], node_idx,
                         node_idx, zero, zero, cur & ~tc.down)
        if spec.enabled("node_up"):
            tc = _append(spec, tc, t, KIND["node_up"], node_idx,
                         node_idx, zero, zero, (~cur) & tc.down)
        tc = tc.replace(down=cur)
    if spec.enabled("deliver"):
        c = cfg.inbox_cap
        src, size, valid = _unicast_row(cfg, net, t)
        dst = node_idx[:, None].expand(n, c)
        slot = torch.arange(c, dtype=I32, device=dev)[None, :].expand(n, c)
        tc = _append(spec, tc, t, KIND["deliver"], src.reshape(-1),
                     dst.reshape(-1), size.reshape(-1), slot.reshape(-1),
                     valid.reshape(-1))
        if cfg.bcast_slots > 0:
            b = cfg.bcast_slots
            arrival, ok, _ = broadcast_arrivals(cfg, model, net, nodes)
            hit = (ok & (arrival == t) & (~nodes.down[None, :])).T  # [N, B]
            bsrc = net.bc_src[None, :].expand(n, b)
            bsize = net.bc_size[None, :].expand(n, b)
            bdst = node_idx[:, None].expand(n, b)
            baux = (c + torch.arange(b, dtype=I32, device=dev))[None, :] \
                .expand(n, b)
            tc = _append(spec, tc, t, KIND["deliver"], bsrc.reshape(-1),
                         bdst.reshape(-1), bsize.reshape(-1),
                         baux.reshape(-1), hit.reshape(-1))
    if cfg.bcast_slots > 0 and spec.enabled("bc_retire"):
        retire = net.bc_active & ((t - net.bc_time) >= cfg.horizon)
        slot = torch.arange(cfg.bcast_slots, dtype=I32, device=dev)
        tc = _append(spec, tc, t, KIND["bc_retire"], net.bc_src,
                     torch.full_like(net.bc_src, -1), net.bc_size, slot,
                     retire)
    if cfg.spill_cap > 0 and spec.enabled("spill_unpark"):
        sel = (net.sp_arrival >= 0) & (net.sp_arrival - t <=
                                       cfg.horizon - 2)
        tc = _append(spec, tc, t, KIND["spill_unpark"], net.sp_src,
                     net.sp_dest, net.sp_size, net.sp_arrival, sel)
    return tc


def _post_events(spec: TraceSpec, cfg, model, tc: TraceCarry, t: int, net,
                 out, down0) -> TraceCarry:
    """Events observable right after the protocol step
    (wittgenstein_tpu/obs/trace.py:293-368): send-unicast (node-major,
    outbox-slot-minor), send-broadcast, spill_park, drop, node_down /
    node_up.  The drop/park decision replays the engine's routing
    validity with the same latency draw keyed on (seed, t, full-width
    slot id), so a traced drop is the drop the engine counts."""
    nodes = net.nodes
    n = cfg.n
    dev = nodes.down.device
    kk = out.dest.shape[1]
    m = n * kk
    src = torch.arange(n, dtype=I32, device=dev).repeat_interleave(kk)
    dest = out.dest.reshape(m)
    size = out.size.reshape(m)
    delay = out.delay.reshape(m)
    want = (dest >= 0) & (~nodes.down[src])
    dest_c = dest.clamp(0, n - 1)
    midx = src * cfg.out_deg + out.slot0 + \
        torch.arange(kk, dtype=I32, device=dev).repeat(n)
    if spec.enabled("send"):
        tc = _append(spec, tc, t, KIND["send"], src, dest_c, size, midx,
                     want)
        if cfg.bcast_slots > 0:
            node_idx = torch.arange(n, dtype=I32, device=dev)
            req = out.bcast & (~nodes.down)
            minus = torch.full((n,), -1, dtype=I32, device=dev)
            tc = _append(spec, tc, t, KIND["send"], node_idx, minus,
                         out.bcast_size, minus, req)
    want_park = cfg.spill_cap > 0 and spec.enabled("spill_park")
    if spec.enabled("drop") or want_park:
        seed_t = prng.hash3(net.seed, prng.TAG_LATENCY, t)
        delta = prng.uniform_delta(seed_t, midx)
        lat = full_latency(model, nodes, src, dest_c, delta)
        not_disc = lat < cfg.msg_discard_time
        raw_total = delay.clamp_min(0) + lat.clamp_min(1)
        reachable = (~nodes.down[dest_c]) & (
            nodes.partition[src] == nodes.partition[dest_c])
        valid = want & not_disc & reachable
        if want_park:
            far = valid & (raw_total > cfg.horizon - 2)
            tc = _append(spec, tc, t, KIND["spill_park"], src, dest_c,
                         size, t + 1 + raw_total, far)
        if spec.enabled("drop"):
            reason = torch.where(~not_disc, 1,
                                 torch.where(nodes.down[dest_c], 2, 3))
            tc = _append(spec, tc, t, KIND["drop"], src, dest_c, size,
                         reason, want & ~valid)
    liveness = spec.enabled("node_down") or spec.enabled("node_up")
    if liveness and down0 is not None:
        node_idx = torch.arange(n, dtype=I32, device=dev)
        zero = torch.zeros(n, dtype=I32, device=dev)
        if spec.enabled("node_down"):
            tc = _append(spec, tc, t, KIND["node_down"], node_idx,
                         node_idx, zero, zero, nodes.down & ~down0)
        if spec.enabled("node_up"):
            tc = _append(spec, tc, t, KIND["node_up"], node_idx,
                         node_idx, zero, zero, (~nodes.down) & down0)
    if liveness and tc.down.shape[0] > 0:
        tc = tc.replace(down=nodes.down)
    return tc


def trace_jump(spec: TraceSpec, tc: TraceCarry, t_from: int,
               dt: int) -> TraceCarry:
    """Record one quiet-window fast-forward jump
    (wittgenstein_tpu/obs/trace.py:371-380); ``dt == 0`` appends
    nothing.  Runs on one ring or a batch of them (the jump is the
    batch's)."""
    if not spec.enabled("ff_jump") or dt == 0:
        return tc

    def per_run(tc_):
        minus = torch.full((1,), -1, dtype=I32, device=tc_.buf.device)
        return _append(spec, tc_, t_from, KIND["ff_jump"], minus, minus,
                       0, dt, minus < 0)

    return torch.func.vmap(per_run)(tc) if tc.cursor.dim() else per_run(tc)


def trace_tap(protocol, spec: TraceSpec, cell):
    """The `step_kms` observation hook bound to a mutable 2-cell
    ``[TraceCarry, saved_down]`` (wittgenstein_tpu/obs/trace.py:
    383-398).  The engine calls it twice a simulated ms; the builder
    reads the carry back out of the cell after the step.  On a seed
    batch the per-run recorder runs under `torch.func.vmap`."""
    cfg, model = protocol.cfg, protocol.latency

    def entry(tc, net, t):
        return _entry_events(spec, cfg, model, tc, t, net)

    def post(tc, net, out, down0, t):
        return _post_events(spec, cfg, model, tc, t, net, out, down0)

    def tap(t, net, out):
        batch = net.time.dim() > 0
        if out is None:
            cell[1] = net.nodes.down
            fn = torch.func.vmap(entry, in_dims=(0, 0, None)) if batch \
                else entry
            cell[0] = fn(cell[0], net, t)
        else:
            fn = torch.func.vmap(post, in_dims=(0, 0, 0, 0, None)) \
                if batch else post
            cell[0] = fn(cell[0], net, out, cell[1], t)

    return tap


def _step_window_trace(protocol, spec: TraceSpec, k: int):
    """One traced K-ms window (k == 1 is a plain traced ms), for one run
    or a seed batch."""

    def one(net, pstate, tc, t):
        cell = [tc, None]
        net, pstate = step_kms(protocol, net, pstate, k, t=t,
                               tap=trace_tap(protocol, spec, cell))
        return net, pstate, cell[0]

    return one


def step_ms_trace(protocol, spec: TraceSpec, net, pstate, tc,
                  t: int | None = None):
    """One traced millisecond: `step_ms` with the recorder tapped in
    (wittgenstein_tpu/obs/trace.py:401-408)."""
    cell = [tc, None]
    net, pstate = step_ms(protocol, net, pstate, t=t,
                          tap=trace_tap(protocol, spec, cell))
    return net, pstate, cell[0]


def scan_chunk_trace(protocol, ms: int, spec: TraceSpec,
                     superstep: int = 1):
    """Returns ``run(net, pstate, t=None) -> (net, pstate, TraceCarry)``
    advancing `ms` milliseconds with the flight recorder beside the
    state — the traced twin of ``scan_chunk(protocol, ms, superstep=K)``
    (wittgenstein_tpu/obs/trace.py:424-445), for one run or a seed
    batch (per-seed rings).  Inside a K window the taps fire per
    simulated ms, so the stream equals the K=1 trace."""
    check_chunk_config(protocol, ms, superstep=superstep)
    step = _step_window_trace(protocol, spec, superstep)

    def run(net, pstate, t=None):
        t = int(net.time.reshape(-1)[0]) if t is None else t
        tc = init_trace(spec, net.nodes.down)
        for _ in range(ms // superstep):
            net, pstate, tc = step(net, pstate, tc, t)
            t += superstep
        return net, pstate, tc

    return run


def scan_chunk_batched_trace(protocol, ms: int, spec: TraceSpec,
                             superstep: int = 2):
    """Traced twin of `core/batched.scan_chunk_batched`
    (wittgenstein_tpu/obs/trace.py:448-476): per-seed event rings over
    the K-ms window engine on the seed batch, per-ms taps."""
    from ..core.batched import _check_batched_scope

    check_chunk_config(protocol, ms, superstep=superstep)
    _check_batched_scope(protocol, ms, superstep)
    return scan_chunk_trace(protocol, ms, spec, superstep=superstep)


class _Tracer:
    """The flight recorder as `network.fast_forward_chunk`'s observer."""

    def __init__(self, protocol, spec: TraceSpec, tc, k: int):
        self.spec, self.tc = spec, tc
        self.step = _step_window_trace(protocol, spec, k)

    def window(self, net, pstate, k: int, t: int):
        net, pstate, self.tc = self.step(net, pstate, self.tc, t)
        return net, pstate

    def jump(self, t: int, dt: int):
        self.tc = trace_jump(self.spec, self.tc, t, dt)


def fast_forward_chunk_trace(protocol, ms: int, spec: TraceSpec,
                             seed_axis: bool = False, superstep: int = 1):
    """Traced twin of `core/network.fast_forward_chunk`
    (wittgenstein_tpu/obs/trace.py:479-532): returns ``run(net, pstate,
    t=None) -> (net, pstate, stats, TraceCarry)``.  Executed ms record
    their events as the dense path does; each jump appends one
    `ff_jump` event at its origin ms.  ``seed_axis=True`` takes a seed
    batch with per-seed rings and lockstep jumps."""
    check_chunk_config(protocol, ms, superstep=superstep,
                       fast_forward=True)

    def run(net, pstate, t=None):
        tr = _Tracer(protocol, spec, init_trace(spec, net.nodes.down),
                     superstep)
        net, pstate, stats = fast_forward_chunk(
            protocol, ms, seed_axis=seed_axis, superstep=superstep,
            observer=tr)(net, pstate, t)
        return net, pstate, stats, tr.tc

    return run
