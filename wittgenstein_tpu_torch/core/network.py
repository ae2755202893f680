"""The per-ms and superstep engines — the port of
`wittgenstein_tpu/core/network.py`'s dense path, for one run or for a
batch of runs with a leading seed axis.

Per simulated ms t: retire the broadcast records past the ring, drain
the spill buffer's entries that came within reach of the ring, read the
ring row ``t % H`` as the unicast inbox, add the broadcast records that
arrive at t (their latency recomputed per (record, dest), never
stored), let the protocol step every node at once, clear the consumed
row, then route the step's unicast sends into the ring with the binning
kernel (`ops/route.py`), parking those past the ring in the spill
buffer, and allocate broadcast records for its sendAlls.  Determinism
comes from the counter-based hashes and the stable in-cell order of the
binning, as in the JAX package.  The superstep engine (`step_kms`) does
the same for a window of K ms: it reads the K rows at once, steps K
times (each ms retiring, delivering and enqueuing its own broadcasts),
clears the K rows, and bins all K outboxes with one launch.  The
fast-forward engine (`fast_forward_chunk`) steps only the ms that can
hold work and jumps the clock across the quiet ones, which the
`next_work` oracle proves to be no-op steps.

One engine serves both layouts.  A state whose ``time`` is a scalar is
one run; a state whose every leaf has a leading seed axis R (as
`core/state.init_batched` builds it) is a batch of runs in lockstep,
the port of the JAX harness's ``jax.vmap(scan_chunk(...))`` and of the
seed-folded engine of `core/batched.py`.  For a batch the ring keeps its
explicit seed axis (one bin launch serves every seed, the seed axis as
the kernel's grid.y), and every per-run function (the protocol step,
delivery checks, broadcast recompute and allocation, latency draws,
spill parking) runs under `torch.func.vmap`, out of place.

The JAX engine is pure; this one updates the mailbox ring (the
`box_*` tensors, 126 MB at 2048 nodes) IN PLACE, because copying it
every ms would cost more than the step, and `torch.func.vmap` cannot
batch an in-place write: every ring read and write happens outside the
vmapped functions, which see the state with its ring leaves set aside
(`_split_ring`).  Every other leaf is replaced.  The simulated time is
carried as a Python int inside a chunk (read from the device at most
once per call), so the step loop never waits for the card; the
fast-forward loop reads its oracle once a window, and that read waits.

Ported: `_retire_broadcasts`, `broadcast_arrivals`, `_bcast_inbox` with
the broadcast half of `build_inbox` (as `_with_broadcasts`),
`_unicast_inbox_window`, `_route_unicast` with `enqueue_unicast`'s spill
branch, `enqueue_broadcast`, `_alloc_free_slots`, `_park_in_spill`,
`_drain_spill`, `_bin_into_ring`, `step_ms`, `step_kms`, `step_2ms`, the
superstep gate (`unicast_floor_ms`, `superstep_ok`,
`check_chunk_config`, `pick_superstep`), `scan_chunk` with phase hints,
the fast-forward engine (`fast_forward_ok`, `next_work`, `_jump`,
`fast_forward_chunk`) and `Runner` with `ff_stats`, over one ring or
its ``box_split`` node-range sub-planes (the binning kernel runs once per
sub-plane, `_bin_into_ring`), and the chaos plane's hooks: a protocol's
`apply_faults(net, t)` at every window entry, the per-step PRNG key for
a protocol that asks for it (``wants_step_key``), and the fault
schedule's gates (`superstep_ok`, `check_chunk_config`).
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops import prng
from ..ops.route import bin_into_ring
from .latency import full_latency, latency_floor_ms
from .protocol import FAR_FUTURE
from .state import EngineConfig, Inbox, NetState, Outbox

I32 = torch.int32

#: Default upper bound for auto-picked superstep windows
#: (wittgenstein_tpu/core/network.py:894-897).
AUTO_SUPERSTEP_MAX = 32

#: the mailbox ring's leaves, updated in place
RING = ("box_data", "box_src", "box_size", "box_count")


def _split_ring(net: NetState):
    """``(net with empty ring leaves, {ring leaf: tensor})``: the state
    the per-run functions see (under `torch.func.vmap` for a batch,
    each placeholder a [0] tensor a run), and the ring they must not
    write."""
    empty = net.time.new_empty(net.time.shape + (0,))
    ring = {k: getattr(net, k) for k in RING}
    return net.replace(**dict.fromkeys(RING, empty)), ring


def _sub_planes(ring: dict) -> list:
    """The ring's node-range sub-planes in order, each a dict of the four
    ring leaves over its own N/P nodes: ``[ring]`` itself when the ring
    is not split (``box_split == 1``)."""
    if not isinstance(ring["box_count"], tuple):
        return [ring]
    return [dict(zip(RING, leaves))
            for leaves in zip(*(ring[k] for k in RING))]


def _bin_into_ring(ring: dict, arrival, dest, src, size, payload, valid):
    """Bin a batch of messages into the ring, in place
    (wittgenstein_tpu/core/network.py:198-285), for one run (message
    vectors [M]) or a batch (a leading R axis on the ring and the
    messages).  `dest` is clipped to [0, n) for valid messages, and
    their ``arrival - t`` spans at most H - 1 consecutive values (the
    kernel groups by ring row): [1, H-1] per ms, [K, H+K-2] for a K-ms
    window.  A split ring takes one launch per sub-plane j, with the
    messages to its nodes valid and their dests shifted by ``-j*N/P``
    (wittgenstein_tpu/ops/pallas_route.py:398-413): a message's rank
    among the same cell's messages is the same in either form, so the
    split is bit-identical.  Returns the dropped count (a scalar, or
    [R]), summed over the sub-planes."""
    subs = _sub_planes(ring)
    ns = subs[0]["box_count"].shape[-1]
    batch = subs[0]["box_count"].dim() == 3
    dropped = None
    for j, sub in enumerate(subs):
        d, ok = dest, valid
        if len(subs) > 1:
            d = dest - j * ns
            ok = valid & (d >= 0) & (d < ns)
        msgs = (arrival, d, src, size, payload, ok)
        if batch:
            n_drop = bin_into_ring(*sub.values(), *msgs)
        else:
            n_drop = bin_into_ring(*(x[None] for x in sub.values()),
                                   *(x[None] for x in msgs))[0]
        dropped = n_drop if dropped is None else dropped + n_drop
    return dropped


def _set_drop(table, slot_w, vals):
    """``table.at[slot_w].set(vals, mode="drop")`` for slot_w in [0,
    cap], cap meaning dropped: a scatter into the table padded by one
    dump row, which is then sliced off.  Out of place, so it runs under
    `torch.func.vmap`."""
    pad = torch.cat([table, torch.zeros_like(table[:1])])
    idx = slot_w.long().reshape(slot_w.shape + (1,) * (table.dim() - 1))
    idx = idx.expand(slot_w.shape + table.shape[1:])
    return pad.scatter(0, idx, vals.expand(idx.shape))[:table.shape[0]]


def _alloc_free_slots(free, want):
    """Deterministic free-slot allocation for a fixed table
    (wittgenstein_tpu/core/network.py:288-299): the i-th requester (in
    index order) takes the i-th free slot.  Returns ``(slot_w, ok)``,
    slot_w == len(free) for requesters that found the table full."""
    cap = free.shape[0]
    rank = want.to(I32).cumsum(0, dtype=I32) - 1
    n_free = free.sum(dtype=I32)
    slot_order = torch.argsort((~free).to(I32), stable=True).to(I32)
    ok = want & (rank < n_free)
    slot = slot_order[rank.clamp(0, cap - 1).long()]
    return torch.where(ok, slot, cap), ok


def _retire_broadcasts(cfg: EngineConfig, net: NetState, t: int):
    """A broadcast's last possible arrival is bc_time + horizon - 1
    (wittgenstein_tpu/core/network.py:44-47); elementwise, so it runs on
    a batch as it is."""
    live = net.bc_active & ((t - net.bc_time) < cfg.horizon)
    return net.replace(bc_active=live)


def broadcast_arrivals(cfg: EngineConfig, model, net: NetState, nodes):
    """Per-(record, dest) broadcast arrival recompute — the one shared
    definition of the reference's stateless multicast latency
    (wittgenstein_tpu/core/network.py:50-73).  Returns ``(arrival [B,
    N], ok [B, N], clamped [B, N])``: `ok` covers record-active,
    discard and partition checks (not the destination's down flag),
    `clamped` marks arrivals whose true latency outran the ring."""
    node_idx = torch.arange(cfg.n, dtype=I32, device=nodes.down.device)
    delta = prng.uniform_delta(net.bc_seed[:, None], node_idx[None, :])
    lat = full_latency(model, nodes, net.bc_src[:, None], node_idx[None, :],
                       delta)
    # Discard is checked against the true latency, then the survivor is
    # clamped into the ring.
    not_discarded = lat < cfg.msg_discard_time
    raw_lat = lat.clamp_min(1)
    lat = lat.clamp(1, cfg.horizon - 2)
    arrival = net.bc_time[:, None] + 1 + lat
    ok = (net.bc_active[:, None] & not_discarded
          & (nodes.partition[net.bc_src][:, None] ==
             nodes.partition[None, :]))
    return arrival, ok, raw_lat != lat


def _with_broadcasts(cfg: EngineConfig, model, net: NetState, uc: Inbox,
                     t: int):
    """One run's time-t inbox: the unicast slice `uc` and the broadcast
    records arriving at t, concatenated to [N, C + B]; the broadcast
    receive counters and clamps are counted here (`_bcast_inbox` and the
    broadcast half of `build_inbox`, wittgenstein_tpu/core/network.py:
    76-93 and 178-195).  Partition membership is checked at delivery
    time, as in the JAX package."""
    nodes = net.nodes
    n, b, f = cfg.n, cfg.bcast_slots, cfg.payload_words
    arrival, bc_ok, clamped = broadcast_arrivals(cfg, model, net, nodes)
    bc_hit = bc_ok & (arrival == t) & (~nodes.down[None, :])     # [B, N]
    bc_size = net.bc_size[None].expand(n, b)
    inbox = Inbox(
        data=torch.cat([uc.data, net.bc_payload[None].expand(n, b, f)], 1),
        src=torch.cat([uc.src, net.bc_src[None].expand(n, b)], 1),
        valid=torch.cat([uc.valid, bc_hit.T], 1))
    # Deliveries whose true latency outran the ring are counted once, at
    # their clamped delivery ms.
    return net.replace(
        nodes=_count_received(nodes, bc_hit.T, bc_size, 1),
        clamped=net.clamped + (bc_hit & clamped).sum(dtype=I32)), inbox


def _unicast_inbox_window(cfg: EngineConfig, ring: dict, t: int, k: int):
    """K consecutive unicast inbox slices as one window
    (wittgenstein_tpu/core/network.py:96-130): ``(data [.., K, N, C,
    F], src [.., K, N, C], size [.., K, N, C], filled [.., K, N, C])``,
    views of the ring rows ``t % H .. t % H + K - 1`` (`step_kms`
    requires ``t % K == 0`` and ``K | H``, so they never wrap), with the
    seed axis in front for a batch.  `filled` marks the occupied slots;
    `_receive_window` adds the delivery-time checks.  A split ring's
    sub-plane windows are concatenated on the node axis (a copy)."""
    h = t % cfg.horizon
    parts = []
    for sub in _sub_planes(ring):
        src = sub["box_src"][..., h:h + k, :, :]
        slots = torch.arange(cfg.inbox_cap, dtype=I32, device=src.device)
        parts.append((sub["box_data"][..., h:h + k, :, :].movedim(-4, -1),
                      src, sub["box_size"][..., h:h + k, :, :],
                      slots < sub["box_count"][..., h:h + k, :, None]))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(xs, -3 if i == 0 else -2)
                 for i, xs in enumerate(zip(*parts)))


def _receive_window(nodes, src, size, filled):
    """One run's delivery-time down/partition checks over its K-row
    window, and its receive counters bumped by the delivered unicasts
    (the checks are evaluated once for the window: a K > 1 window
    requires a protocol that does not change liveness)."""
    valid = filled & (~nodes.down[None, :, None]) & (
        nodes.partition[src] == nodes.partition[None, :, None])
    return _count_received(nodes, valid, size, (0, 2)), valid


def _count_received(nodes, valid, size, dims):
    """Bump the receive counters by the delivered messages."""
    recv = valid.sum(dims, dtype=I32)
    rbytes = torch.where(valid, size, 0).sum(dims, dtype=I32)
    return nodes.replace(msg_received=nodes.msg_received + recv,
                         bytes_received=nodes.bytes_received + rbytes)


def _park_in_spill(cfg: EngineConfig, net: NetState, src, dest, arrival,
                   payload, size, far):
    """Park far-future sends in the spill buffer (free slot: arrival <
    0); overflow is counted in `sp_dropped`
    (wittgenstein_tpu/core/network.py:302-313)."""
    slot_w, ok = _alloc_free_slots(net.sp_arrival < 0, far)
    return net.replace(
        sp_arrival=_set_drop(net.sp_arrival, slot_w, arrival),
        sp_src=_set_drop(net.sp_src, slot_w, src),
        sp_dest=_set_drop(net.sp_dest, slot_w, dest),
        sp_size=_set_drop(net.sp_size, slot_w, size),
        sp_payload=_set_drop(net.sp_payload, slot_w, payload),
        sp_dropped=net.sp_dropped + (far & ~ok).sum(dtype=I32))


def _drain_spill(cfg: EngineConfig, net: NetState, ring: dict, t: int,
                 frozen=None):
    """Re-inject parked messages whose arrival is within reach of the
    ring (wittgenstein_tpu/core/network.py:316-331), binned into the
    ring by the same kernel as the sends.  Selected entries have
    ``arrival - t <= H - 2`` and are clamped to ``arrival >= t + 1``,
    so their rel values lie in [1, H - 2]: at most H - 2 consecutive
    values, within the kernel's precondition (it groups by ring row,
    and rel -> rel % H is injective on them).  A `frozen` run's entries
    stay out of the bin (the ring is written in place)."""
    sel = (net.sp_arrival >= 0) & (net.sp_arrival - t <= cfg.horizon - 2)
    binned = sel if frozen is None else sel & ~frozen[:, None]
    # A batch's spill leaves come out of `torch.func.vmap` as strided
    # views; the kernel reads contiguous rows.
    n_drop = _bin_into_ring(ring, net.sp_arrival.clamp_min(t + 1),
                            net.sp_dest.contiguous(), net.sp_src.contiguous(),
                            net.sp_size.contiguous(),
                            net.sp_payload.contiguous(), binned)
    return net.replace(sp_arrival=torch.where(sel, -1, net.sp_arrival),
                       dropped=net.dropped + n_drop)


def _window_sends(cfg: EngineConfig, outs, t: int):
    """The window's K outboxes (ms t, t+1, ...) as one message list, in
    the order the ring bins them (by ms, then sender, then column):
    ``(src, dest, payload, size, delay, slot id, send ms, per-outbox
    message counts)``.  The slot id is the column's in the full-width
    outbox (`Outbox.slot0`), which keys its latency draw."""
    n, f = cfg.n, cfg.payload_words
    dev = outs[0].dest.device
    cols = []
    for i, out in enumerate(outs):
        k = out.dest.shape[1]
        src = torch.arange(n, dtype=I32, device=dev).repeat_interleave(k)
        col = torch.arange(k, dtype=I32, device=dev).repeat(n)
        cols.append((src, out.dest.reshape(n * k),
                     out.payload.reshape(n * k, f), out.size.reshape(n * k),
                     out.delay.reshape(n * k),
                     src * cfg.out_deg + out.slot0 + col,
                     torch.full((n * k,), t + i, dtype=I32, device=dev)))
    parts = [c[0] if len(outs) == 1 else torch.cat(c) for c in zip(*cols)]
    return (*parts, [c[0].shape[0] for c in cols])


def _route_unicast(cfg: EngineConfig, model, net: NetState, outs, t: int):
    """One run's unicast sends of a window's ms t, t+1, ... (`outs`, one
    outbox each; wittgenstein_tpu/core/network.py:334-414): sender
    counters, latency draws and validity, for the whole window at once
    (each message keyed by its own send ms, as the per-ms routing keys
    it); with ``spill_cap > 0`` (K = 1) the sends past the ring park in
    the spill buffer (delivered exactly on time when the ring reaches
    them), else they are clamped to the ring's edge and counted in
    `clamped`.  Returns ``(net', (arrival, dest, src, size, payload,
    valid))``, the batch the ring bins."""
    nodes = net.nodes
    n = cfg.n
    src, dest, payload, size, delay, midx, tm, counts = _window_sends(
        cfg, outs, t)
    want = (dest >= 0) & (~nodes.down[src])
    dest_c = dest.clamp(0, n - 1)
    # Attempted sends count whether or not the destination is reachable.
    sent = torch.stack([w.reshape(n, -1).sum(1, dtype=I32)
                        for w in want.split(counts)]).sum(0, dtype=I32)
    sbytes = torch.stack([w.reshape(n, -1).sum(1, dtype=I32) for w in
                          torch.where(want, size, 0).split(counts)]).sum(
        0, dtype=I32)
    net = net.replace(nodes=nodes.replace(msg_sent=nodes.msg_sent + sent,
                                          bytes_sent=nodes.bytes_sent + sbytes))

    seed_t = prng.hash3(net.seed, prng.TAG_LATENCY, tm)
    delta = prng.uniform_delta(seed_t, midx)
    lat = full_latency(model, nodes, src, dest_c, delta)
    not_discarded = lat < cfg.msg_discard_time
    raw_total = delay.clamp_min(0) + lat.clamp_min(1)
    total = raw_total.clamp(1, cfg.horizon - 2)
    valid = want & not_discarded & (~nodes.down[dest_c]) & (
        nodes.partition[src] == nodes.partition[dest_c])
    far = valid & (raw_total > cfg.horizon - 2)
    if cfg.spill_cap > 0:
        net = _park_in_spill(cfg, net, src, dest_c, tm + 1 + raw_total,
                             payload, size, far)
        valid = valid & ~far
    else:
        net = net.replace(clamped=net.clamped + far.sum(dtype=I32))
    return net, (tm + 1 + total, dest_c, src, size, payload, valid)


def _no_unicast(cfg: EngineConfig, model, net: NetState, outs, t: int):
    """`_route_unicast` for a protocol that never addresses a unicast
    (``sends_unicast = False``: its outbox dest is always -1, as Casper's
    and ETHPoW's are): no sender counter moves and no latency is drawn,
    and the batch the ring bins has the same shapes with no message
    valid, so the binning launches as it does for any protocol."""
    n = cfg.n
    src, dest, payload, size, _, _, tm, _ = _window_sends(cfg, outs, t)
    return net, (dest.clamp_min(0) + tm + 1, dest.clamp(0, n - 1), src,
                 size, payload, dest >= 0)


def enqueue_broadcast(cfg: EngineConfig, net: NetState, out: Outbox,
                      t: int):
    """Allocate broadcast-table records for this step's sendAll requests
    (wittgenstein_tpu/core/network.py:417-445).  A sendAll counts one
    attempted send and `bcast_size` bytes per destination, all N nodes,
    its own included; requests that find the table full are counted in
    `bc_dropped`."""
    nodes = net.nodes
    n = cfg.n
    req = out.bcast & (~nodes.down)
    sent = nodes.msg_sent + torch.where(req, n, 0).to(I32)
    sbytes = nodes.bytes_sent + torch.where(req, out.bcast_size * n, 0)
    slot_w, ok = _alloc_free_slots(~net.bc_active, req)
    node_idx = torch.arange(n, dtype=I32, device=req.device)
    bseed = prng.hash3(prng.hash2(net.seed, prng.TAG_BCAST), t,
                       node_idx).to(I32)
    return net.replace(
        nodes=nodes.replace(msg_sent=sent, bytes_sent=sbytes),
        bc_active=_set_drop(net.bc_active, slot_w, torch.ones_like(req)),
        bc_src=_set_drop(net.bc_src, slot_w, node_idx),
        bc_time=_set_drop(net.bc_time, slot_w, torch.full_like(node_idx, t)),
        bc_payload=_set_drop(net.bc_payload, slot_w, out.bcast_payload),
        bc_size=_set_drop(net.bc_size, slot_w, out.bcast_size),
        bc_seed=_set_drop(net.bc_seed, slot_w, bseed),
        bc_dropped=net.bc_dropped + (req & ~ok).sum(dtype=I32))


def protocol_step(protocol, pstate, nodes, inbox, key=None, *, t: int,
                  hints=None, step_hint=None):
    """``protocol.step``, with the phase hints only when there are any
    (protocols without a static schedule take none), the step hint only
    for a protocol that has one (`step_hint`) and the per-step PRNG key
    only for a protocol that asks for it (`step_key`)."""
    kw = {} if key is None else {"key": key}
    if hints is not None:
        kw["hints"] = hints
    if step_hint is not None:
        kw["step_hint"] = step_hint
    return protocol.step(pstate, nodes, inbox, t, **kw)


def step_hint(protocol, pstate, inbox: Inbox, t: int):
    """The protocol's `step_hint(pstate, inbox, t)`, where it has one:
    host-side facts about this ms, for one run or every run of a batch
    (seed axis in front), that let its step leave out work which is the
    identity on every node (ETHPoW walks only as many inbox slots as a
    node holds messages and starts no mining where no miner can need
    to; Casper runs the WF producer's build only where it can be due).
    It runs outside the vmapped step and reads the device once: the
    host waits for the card here, once a ms.  None for other
    protocols."""
    fn = getattr(protocol, "step_hint", None)
    return None if fn is None else fn(pstate, inbox, t)


def step_key(protocol, net: NetState, t: int):
    """The JAX engines' per-step key ``fold_in(PRNGKey(seed), t)``
    (wittgenstein_tpu/core/network.py:488), as two uint32 words in int64
    ([2], or [R, 2] for a batch), for a protocol that declares
    ``wants_step_key`` (the chaos plane's loss draw); None for every
    other protocol, whose step takes no key and costs no operation for
    it."""
    if not getattr(protocol, "wants_step_key", False):
        return None
    return prng.fold_in_key(net.seed, t)


def _broadcasts(protocol) -> bool:
    """Whether the engine runs its broadcast half for `protocol`: it has
    a broadcast table and may broadcast.  A protocol whose outbox never
    sets `Outbox.bcast` declares ``sends_broadcast = False``: its table
    stays empty, so retiring records, the arrivals (no record is active)
    and enqueueing (no request) are the identity on every leaf and are
    left out, and its inbox has no broadcast columns (they would hold no
    valid message)."""
    return bool(protocol.cfg.bcast_slots) and \
        getattr(protocol, "sends_broadcast", True)


def step_ms(protocol, net: NetState, pstate, t: int | None = None,
            hints=None, frozen=None, tap=None):
    """Advance one millisecond (wittgenstein_tpu/core/network.py:
    448-504): `step_kms` with K = 1.  `t` is the
    current time as a Python int, read from the device when omitted;
    `hints` are the protocol's phase hints for this ms; `tap` is the
    observation hook of the obs planes (see `step_kms`)."""
    return step_kms(protocol, net, pstate, 1, hints_k=[hints], t=t,
                    frozen=frozen, tap=tap)


def step_kms(protocol, net: NetState, pstate, k: int, hints_k=None,
             t: int | None = None, frozen=None, tap=None):
    """Advance K milliseconds in one engine pass, the superstep
    (wittgenstein_tpu/core/network.py:448-663), for one run or a seed
    batch (see the module docstring).

    Bit-identical to K `step_ms` calls whenever no unicast sent inside
    the window can arrive inside it: K <= ``unicast_floor_ms() + 1``
    (`check_chunk_config` proves it).  The K inbox rows are read as one
    window and their receive counters bumped up front; each ms of the
    window then retires its broadcasts, adds those arriving at it to
    the inbox, steps the protocol and enqueues its own broadcasts (a
    sendAll reaches its sender in 1 ms, so broadcasts are not
    window-fused); the K consumed rows are cleared, and all K outboxes
    are routed and binned by ONE launch (arrivals relative to t span
    [K, horizon + K - 2]; those past the horizon land in the rows just
    cleared, so the clear must come before the bin).  K > 1 requires
    ``t % K == 0``, ``K | horizon`` and ``spill_cap == 0``; with K = 1
    the spill buffer is drained before the inbox is read.

    `t` is the (batch's) time as a Python int, read from the device when
    omitted.  `frozen` ([R] bool, a batch only) marks runs whose ring
    must not change: their rows are neither cleared nor binned into, by
    the sends or the spill drain (the ring is updated in place, so a
    caller that keeps a stopped run's other leaves cannot restore its
    ring afterwards; `core/harness.py` uses it).  Their other leaves
    advance, and the caller selects them back.

    `tap` is the observation hook of the trace and audit planes
    (`obs/trace.py`, `obs/audit.py`; wittgenstein_tpu/core/network.py:
    448-620): ``tap(t_i, net, None)`` at each simulated ms's entry,
    before its broadcast retire and spill drain, and ``tap(t_i, net,
    out)`` right after its protocol step, before its broadcasts are
    enqueued, so every observation inside a K window carries its own
    ms.  `net` is the whole state, the ring included (for a batch with
    the seed axis in front, as is `out`); the hook reads it and must
    not write it.  ``tap=None`` adds no operation.

    A protocol with `apply_faults` (the chaos plane, `chaos/wrap.py`)
    has it applied once at the window's entry, before the tap and
    everything else (wittgenstein_tpu/core/network.py:476-478 and
    568-570): the gates require every churn/partition transition to be
    K-aligned, so the fault state is constant across the window.  A
    protocol without it runs no operation for it."""
    if hints_k is not None and len(hints_k) != k:
        raise ValueError(f"hints_k must have {k} entries, got "
                         f"{len(hints_k)}")
    cfg, model = protocol.cfg, protocol.latency
    if k > 1 and cfg.spill_cap > 0:
        raise ValueError("step_kms requires spill_cap == 0 (spill drain "
                         "is inherently per-ms)")
    lead = net.time.dim()
    per_run = torch.func.vmap if lead else (lambda fn: fn)
    if t is None:
        t = int(net.time.reshape(-1)[0])
    apply_faults = getattr(protocol, "apply_faults", None)
    if apply_faults is not None:
        net = apply_faults(net, t)
    net, ring = _split_ring(net)
    if tap is not None:
        tap(t, net.replace(**ring), None)
    bcast = _broadcasts(protocol)
    if bcast:
        net = _retire_broadcasts(cfg, net, t)
    if cfg.spill_cap:
        net = _drain_spill(cfg, net, ring, t, frozen)

    # All K slices and their receive counters up front (the counters are
    # write-only to the protocol step, so the early bump is invisible).
    data, src, size, filled = _unicast_inbox_window(cfg, ring, t, k)
    nodes, valid = per_run(_receive_window)(net.nodes, src, size, filled)
    net = net.replace(nodes=nodes)
    outs = []
    for i in range(k):
        if i and tap is not None:
            tap(t + i, net.replace(**ring), None)
        inbox = Inbox(data=data.select(lead, i), src=src.select(lead, i),
                      valid=valid.select(lead, i))
        if bcast:
            if i:
                net = _retire_broadcasts(cfg, net, t + i)
            net, inbox = per_run(functools.partial(
                _with_broadcasts, cfg, model, t=t + i))(net, inbox)
        key = step_key(protocol, net, t + i)
        pstate, nodes, out = per_run(functools.partial(
            protocol_step, protocol, t=t + i,
            hints=None if hints_k is None else hints_k[i],
            step_hint=step_hint(protocol, pstate, inbox, t + i)))(
                pstate, net.nodes, inbox,
                *(() if key is None else (key,)))
        net = net.replace(nodes=nodes)
        outs.append(out)
        if tap is not None:
            tap(t + i, net.replace(**ring), out)
        if bcast:
            net = per_run(functools.partial(enqueue_broadcast, cfg,
                                            t=t + i))(net, out)

    h = t % cfg.horizon
    for sub in _sub_planes(ring):
        rows = sub["box_count"][..., h:h + k, :]
        if frozen is None:
            rows.zero_()
        else:
            rows.copy_(torch.where(frozen[:, None, None], rows, 0))
    route = (_route_unicast if getattr(protocol, "sends_unicast", True)
             else _no_unicast)
    net, msgs = per_run(functools.partial(route, cfg, model, t=t))(net, outs)
    msgs = [x.contiguous() for x in msgs]
    if frozen is not None:
        msgs[5] = msgs[5] & ~frozen[:, None]
    n_dropped = _bin_into_ring(ring, *msgs)
    return net.replace(**ring, dropped=net.dropped + n_dropped,
                       time=net.time + k), pstate


def step_2ms(protocol, net: NetState, pstate, hints2=(None, None),
             t: int | None = None):
    """The K == 2 superstep (wittgenstein_tpu/core/network.py:666-674):
    the engine's 1-ms minimum latency is itself the floor, so it needs
    no latency-model floor and no self-send declaration."""
    return step_kms(protocol, net, pstate, 2, hints_k=list(hints2), t=t)


def unicast_floor_ms(protocol) -> int:
    """The provable lower bound on any of this protocol's unicast
    delivery latencies (wittgenstein_tpu/core/network.py:717-730): the
    model's `latency_floor_ms` when the protocol declares
    ``may_self_send = False``, else 1 (a self-addressed unicast always
    takes exactly 1 ms)."""
    if getattr(protocol, "may_self_send", True):
        return 1
    return latency_floor_ms(protocol.latency)


def superstep_ok(protocol, superstep: int = 2) -> bool:
    """True iff `step_kms` with this K is valid for this protocol
    (wittgenstein_tpu/core/network.py:733-748; the chunk length and entry
    time must also be K-aligned, which the caller checks).  A chaos
    schedule (`chaos_schedule`) must have every churn/partition
    transition on a K-ms window boundary."""
    cfg = protocol.cfg
    sched = getattr(protocol, "chaos_schedule", None)
    return (cfg.spill_cap == 0
            and superstep >= 1
            and cfg.horizon % superstep == 0
            and superstep < cfg.horizon
            and superstep <= unicast_floor_ms(protocol) + 1
            and not getattr(protocol, "mutates_liveness", False)
            and (sched is None or sched.superstep_aligned(superstep)))


def fast_forward_ok(protocol) -> bool:
    """True iff the fast-forward path is worth taking for this protocol
    (wittgenstein_tpu/core/network.py:750-758): spill-free and with the
    protocol's `next_action_time` half of the oracle.  Without it
    `fast_forward_chunk` is still sound but never jumps."""
    return (protocol.cfg.spill_cap == 0 and
            getattr(protocol, "next_action_time", None) is not None)


def check_chunk_config(protocol, ms, t0_mod=None, superstep=1,
                       fast_forward=False):
    """The shared eligibility gate of the chunk variants
    (wittgenstein_tpu/core/network.py:761-891, with its remedy texts):
    plain, superstep-K, phase-specialized and fast-forward.  It RAISES,
    never changes results; `pick_superstep` is the demoting half.  From
    `t0_mod` (a residue mod the schedule lcm) the K-alignment of the
    absolute entry time is provable only mod gcd(K, lcm); callers that
    know the entry time route through `pick_superstep(t0=...)`."""
    cfg = protocol.cfg
    if not isinstance(superstep, int) or superstep < 1:
        raise ValueError(f"superstep must be a positive int, got "
                         f"{superstep!r}")
    if fast_forward:
        if t0_mod is not None:
            raise ValueError(
                "fast_forward is incompatible with phase-specialized "
                "scans (t0_mod): phase hints statically specialize each "
                "ms of an unrolled schedule period, while fast-forward "
                "jumps the clock dynamically — the hint<->time pairing "
                "cannot survive a data-dependent jump. Drop t0_mod (the "
                "oracle already skips the hint-masked quiet ms, "
                "including data-dependent ones hints cannot see)")
        if cfg.spill_cap > 0:
            raise ValueError(
                f"fast_forward requires spill_cap == 0 (got "
                f"{cfg.spill_cap}): the spill drain re-examines the "
                "buffer every ms, so a skipped window could miss a "
                "re-injection. Use a horizon that covers the latency "
                "tail instead of spill, or run without fast_forward")
    if superstep < 2:
        return
    k = superstep
    even = "an even" if k == 2 else f"a multiple-of-{k}"
    if cfg.spill_cap > 0:
        raise ValueError(
            f"superstep={k} needs spill_cap == 0 (got "
            f"{cfg.spill_cap}): the spill drain is inherently "
            "per-ms. Fix: size the horizon for the latency tail "
            "instead of spill, or fall back to superstep=1")
    if getattr(protocol, "mutates_liveness", False):
        raise ValueError(
            f"superstep={k} needs a protocol whose step() does not "
            "mutate node liveness (every inbox validity check in the "
            "window is evaluated against window-entry down/partition "
            "state). Fix: superstep=1 for this protocol")
    if cfg.horizon % k or k >= cfg.horizon:
        raise ValueError(
            f"superstep={k} needs K to divide the horizon with room "
            f"to spare (horizon {cfg.horizon}): the K consumed ring "
            "rows are read and cleared as one contiguous window. "
            f"Fix: pad the horizon to a multiple of {k} (at least "
            f"{2 * k}), or lower K")
    sched = getattr(protocol, "chaos_schedule", None)
    if sched is not None and not sched.superstep_aligned(k):
        bad = [t for t in sched.transition_times() if t % k]
        raise ValueError(
            f"superstep={k} needs every chaos churn/partition "
            f"transition on a K-ms window boundary (misaligned: "
            f"{bad[:8]}): liveness/partition state is applied at "
            "window entry, so a mid-window transition would be "
            "visible to the per-ms engine but not the fused window. "
            f"Fix: align the FaultSchedule times to multiples of "
            f"{k}, pick a superstep dividing "
            f"gcd={sched.align_gcd() or 1} of the transition times, "
            "or fall back to superstep=1")
    floor = unicast_floor_ms(protocol)
    if k > floor + 1:
        self_send = getattr(protocol, "may_self_send", True)
        why = (
            "the protocol has not declared may_self_send = False, "
            "and a self-addressed unicast always arrives in exactly "
            "1 ms (full_latency pins src == dst), so only the "
            "universal K = 2 window is provable"
            if self_send else
            f"{protocol.latency!r} proves latency_floor_ms() = "
            f"{floor}, and a unicast sent at the window's first ms "
            f"can arrive {floor + 1} ms later — inside any window "
            f"longer than {floor + 1}")
        raise ValueError(
            f"superstep={k} exceeds the provable quiet window: {why}."
            f" Fix: use superstep <= {floor + 1}, switch to a latency"
            " model with a floor >= K-1 ms (e.g. NetworkFixedLatency,"
            " EthScanNetworkLatency), or — if step() provably never "
            "emits a unicast with dest == src — declare "
            "may_self_send = False on the protocol")
    if ms % k:
        raise ValueError(
            f"superstep={k} needs {even} chunk (got {ms}): the scan "
            f"advances in fused {k}-ms windows. Fix: make the chunk "
            f"length a multiple of {k}, or fall back to a smaller "
            "superstep for this chunk")
    if t0_mod is not None:
        sched = getattr(protocol, "schedule_lcm", None)
        g = math.gcd(k, sched) if sched else k
        if t0_mod % g:
            raise ValueError(
                f"superstep={k} needs {even} entry time "
                f"(t0_mod={t0_mod} is not 0 mod "
                f"gcd(K, schedule_lcm)={g}, so NO absolute entry "
                f"time can satisfy both time % lcm == {t0_mod} and "
                f"the K-aligned window contract): the window's ring "
                "rows are read as one K-aligned block. Fix: enter "
                "on a K-aligned chunk boundary (in-tree drivers "
                f"start at time 0 and use multiple-of-{k} chunks; "
                "burn one unaligned superstep=1 chunk first to "
                "realign), or keep superstep=1 for this chunk. "
                "(allow_unaligned only relaxes the schedule-lcm "
                "length check, not entry alignment — it cannot fix "
                "this one.)")


def pick_superstep(protocol, ms, t0=None, max_k: int = AUTO_SUPERSTEP_MAX,
                   also_divides=None, lcm=None) -> int:
    """The largest K for which `step_kms` is provably exact for chunks
    of `ms` entered at absolute time `t0` and every later boundary
    (wittgenstein_tpu/core/network.py:900-933); ``t0=None`` returns 1.
    `also_divides` adds a divisibility constraint, `lcm` the
    phase-specialized scan's (chunk a multiple of the K-adjusted
    schedule lcm).  Never raises: this is the demoting half of the
    gate."""
    ms = int(ms)
    best = 1
    for k in range(2, min(int(max_k), ms) + 1):
        if ms % k or (t0 is None or int(t0) % k):
            continue
        if also_divides is not None and also_divides % k:
            continue
        if lcm and ms % (lcm * k // math.gcd(lcm, k)):
            continue
        if superstep_ok(protocol, k):
            best = k
    return best


def chunk_hints(protocol, ms, t0_mod, superstep):
    """The phase hints of one schedule period for a phase-specialized
    chunk entered at ``time % schedule_lcm == t0_mod``, or None when the
    chunk is not specialized (wittgenstein_tpu/core/network.py:1117-
    1137).  With K not dividing the lcm, the period is the K-adjusted
    lcm; the chunk must be a multiple of it (the JAX package's
    `allow_unaligned` one-shot tail is not ported)."""
    sched = getattr(protocol, "schedule_lcm", None) \
        if t0_mod is not None else None
    if not sched:
        return None
    lcm = sched
    if superstep > 1 and lcm % superstep:
        lcm = lcm * superstep // math.gcd(lcm, superstep)
    if ms % lcm:
        raise ValueError(
            f"phase-specialized chunk length {ms} is not a multiple of "
            f"the protocol schedule lcm {lcm}: reusing this chunk "
            "function would misalign the phase schedule after the "
            "first call. Use an lcm-multiple chunk.")
    return [protocol.phase_hints((t0_mod + dt) % sched)
            for dt in range(lcm)]


def next_work(protocol, net: NetState, pstate, t: int):
    """The next-event oracle (wittgenstein_tpu/core/network.py:936-973):
    the earliest ms >= t that can hold work, as an int32 tensor on the
    device, for one run or the minimum over a seed batch.  The minimum
    of (a) the next nonempty ring row (with ``spill_cap == 0`` every
    unicast in flight is in the ring: a nonzero count in row ``(t + d)
    % H`` is a delivery at t + d), (b) the earliest live broadcast
    arrival >= t, recomputed on the post-step table, and (c) the
    protocol's `next_action_time` (every ms active without one).  Every
    ms in ``[t, next_work)`` is a no-op step.  Term (a) reads the ring
    outside vmap, with the seed axis explicit; (b) and (c) run per run,
    under `torch.func.vmap` on a batch."""
    cfg, model = protocol.cfg, protocol.latency
    lead = net.time.dim()
    rows = torch.arange(cfg.horizon, dtype=I32, device=net.time.device)
    row_any = functools.reduce(torch.logical_or, (
        (sub["box_count"] > 0).any(-1)                  # [H] or [R, H]
        for sub in _sub_planes({k: getattr(net, k) for k in RING})))
    nxt = torch.where(row_any, t + (rows - t) % cfg.horizon,
                      FAR_FUTURE).min()
    nat = getattr(protocol, "next_action_time", None)
    if nat is None:
        return torch.full_like(net.time.reshape(-1)[0], t)
    net, _ = _split_ring(net)

    bcast = _broadcasts(protocol)

    def per_run(net, pstate):
        out = nat(pstate, net.nodes, t)
        if bcast:
            arrival, ok, _ = broadcast_arrivals(cfg, model, net, net.nodes)
            out = torch.minimum(out, torch.where(
                ok & (arrival >= t), arrival, FAR_FUTURE).min())
        return out

    terms = (torch.func.vmap(per_run) if lead else per_run)(net, pstate)
    return torch.minimum(nxt, terms.min()).clamp_min(t).to(I32)


def _jump(cfg: EngineConfig, net: NetState, dt: int, t2: int):
    """Skip `dt` quiet ms to time `t2` (wittgenstein_tpu/core/network.py:
    976-988): only the clock (the ring's head: the skipped rows are
    empty) and broadcast retirement move.  Retirement is monotone in t,
    so one retire at t2 - 1 equals the per-ms ones."""
    if cfg.bcast_slots:
        net = _retire_broadcasts(cfg, net, t2 - 1)
    return net.replace(time=net.time + dt)


def fast_forward_chunk(protocol, ms: int, seed_axis: bool = False,
                       superstep: int = 1, observer=None):
    """The fast-forward chunk (wittgenstein_tpu/core/network.py:
    991-1059): advance exactly `ms` ms, stepping a window of K ms
    (`step_kms`) only where work can be, and jumping the clock by
    ``next_work - t`` across provably quiet ms.  Bit-identical to the
    dense `scan_chunk`, since a skipped ms is a no-op step.  Jumps are
    clipped at the chunk's end and floored to multiples of K, so every
    window starts K-aligned.  With ``seed_axis`` the state is a seed
    batch in lockstep and the batch jumps by the minimum of its runs'
    oracles.

    Returns ``run(net, pstate, t=None) -> (net, pstate, stats)`` with
    ``stats = {"skipped_ms": int, "jump_count": int}``; `t` is the entry
    time, read from the device when omitted.  Each window ends with one
    read of the oracle: the host waits there for the card.  There is no
    `frozen` argument (the JAX chunk has none; the harness runs dense
    chunks).

    `observer` is the hook of the obs planes' fast-forward twins
    (`obs/engine.py`, `obs/trace.py`, `obs/audit.py`): when given, each
    window runs ``observer.window(net, pstate, k, t)`` (`step_kms` with
    the plane's tap and its fold) in place of `step_kms`, and every
    oracle read is followed by ``observer.jump(t, dt)``, the jump of
    ``dt >= 0`` quiet ms from `t` (`_jump` as the JAX planes'
    `record_jump`, `trace_jump` and `audit_jump` see it, dt 0
    included)."""
    check_chunk_config(protocol, ms, superstep=superstep,
                       fast_forward=True)
    cfg, k = protocol.cfg, superstep

    def run(net, pstate, t=None, frozen=None):
        if frozen is not None:
            raise ValueError("fast-forward chunks take no frozen runs: a "
                             "batch jumps in lockstep; run stopped runs "
                             "through scan_chunk")
        if (net.time.dim() > 0) != bool(seed_axis):
            raise ValueError(
                f"fast_forward_chunk(seed_axis={seed_axis}) got a state "
                f"whose time has shape {tuple(net.time.shape)}")
        t = int(net.time.reshape(-1)[0]) if t is None else t
        t_end = t + ms
        skipped = jumps = 0
        while t < t_end:
            if observer is None:
                net, pstate = step_kms(protocol, net, pstate, k, t=t)
            else:
                net, pstate = observer.window(net, pstate, k, t)
            t += k
            nw = int(next_work(protocol, net, pstate, t))
            dt = min(nw, t_end) - t
            dt -= dt % k
            if observer is not None:
                observer.jump(t, dt)
            if dt > 0:
                net = _jump(cfg, net, dt, t + dt)
                t += dt
                skipped += dt
                jumps += 1
        return net, pstate, {"skipped_ms": skipped, "jump_count": jumps}

    return run


def scan_chunk(protocol, ms: int, t0_mod=None, superstep: int = 1,
               fast_forward: bool = False, timed_hints: bool = False):
    """Returns ``run(net, pstate, t=None, frozen=None) -> (net,
    pstate)`` advancing `ms` milliseconds
    (wittgenstein_tpu/core/network.py:1062-1174), a Python loop over the
    chunk's ms, for one run or a seed batch (every run at the same
    time); `t` is the entry time, read from the device when omitted,
    and `frozen` as in `step_kms`.

    ``t0_mod`` (= entry ``time % schedule_lcm``) specializes the chunk:
    each ms gets the protocol's `phase_hints`, so e.g. Handel's
    verification scoring runs only on the ms where a node can verify
    (bit-identical).  ``superstep=K`` advances in fused K-ms windows
    (`step_kms`) when `check_chunk_config` proves them.
    ``fast_forward=True`` runs `fast_forward_chunk` instead, on the
    state's own layout, and drops its skip counts.  ``timed_hints=True``
    gives each ms the `phase_hints` of its own absolute time, for a
    protocol with a static schedule, whatever the chunk's length and
    entry phase (the JAX package unrolls one schedule period of hints
    into the compiled chunk, so it specializes only chunks that are
    multiples of the period; the hints are exact either way)."""
    check_chunk_config(protocol, ms, t0_mod=t0_mod, superstep=superstep,
                       fast_forward=fast_forward)
    k = superstep
    if fast_forward:
        def run_ff(net, pstate, t=None, frozen=None):
            ff = fast_forward_chunk(protocol, ms,
                                    seed_axis=net.time.dim() > 0,
                                    superstep=k)
            return ff(net, pstate, t, frozen)[:2]

        return run_ff
    sched = getattr(protocol, "schedule_lcm", None) if timed_hints else None
    if sched:
        def run_timed(net, pstate, t=None, frozen=None):
            t = int(net.time.reshape(-1)[0]) if t is None else t
            for _ in range(ms // k):
                hints_k = [protocol.phase_hints((t + i) % sched)
                           for i in range(k)]
                net, pstate = step_kms(protocol, net, pstate, k,
                                       hints_k=hints_k, t=t, frozen=frozen)
                t += k
            return net, pstate

        return run_timed
    hints = chunk_hints(protocol, ms, t0_mod, k) or [None] * k

    def run(net, pstate, t=None, frozen=None):
        t = int(net.time.reshape(-1)[0]) if t is None else t
        for _ in range(ms // len(hints)):
            for i in range(0, len(hints), k):
                net, pstate = step_kms(protocol, net, pstate, k,
                                       hints_k=hints[i:i + k], t=t,
                                       frozen=frozen)
                t += k
        return net, pstate

    return run


class Runner:
    """Drives a protocol chunk by chunk — the port of `Runner`
    (wittgenstein_tpu/core/network.py:1177-1443).  ``superstep=K`` is an
    upper bound: each call runs the largest K <= it that
    `pick_superstep` proves for its length and entry time (and, with
    the metrics plane, for `stat_each_ms`).  ``fast_forward=True`` runs
    each call through `fast_forward_chunk` and keeps its skip counts
    (`ff_stats`); for a protocol that is not `fast_forward_ok` it runs
    dense, as the JAX `Runner` does.  Its first call hands the nodes to
    the latency model's `validate` hook, where the model has one (a city
    model refuses nodes placed without a city).

    One observability plane a Runner, as in the JAX package:
    ``metrics=`` (an `obs.MetricsSpec`), ``trace=`` (an
    `obs.TraceSpec`) or ``audit=`` (an `obs.AuditSpec`) runs every call
    through the plane's chunk builder, bit-identical on the state, and
    keeps each call's carry on the device (`metrics_carries`,
    `trace_carries`, `audit_carries`; no host read);
    `metrics_frame`, `trace_frame`, `trace_stats`, `audit_report` and
    `audit_stats` fetch and stitch them.  The engine writes the ring
    (and a protocol's `IN_PLACE` leaves) in place: the state handed to
    `run_ms` is donated, as the JAX `Runner` donates it off the TPU."""

    def __init__(self, protocol, superstep=1, fast_forward=False,
                 metrics=None, trace=None, audit=None):
        if sum(p is not None for p in (metrics, trace, audit)) > 1:
            raise ValueError(
                "Runner supports ONE observability plane per pass "
                "(metrics=, trace=, audit=): the planes are separate "
                "carries and their builders do not compose yet. Fix: "
                "run the chunk twice (every plane is bit-identical on "
                "the trajectory), or pick the one you are debugging "
                "with")
        self.protocol = protocol
        self._superstep = int(superstep)
        self._fast_forward = bool(fast_forward) and fast_forward_ok(protocol)
        self._metrics, self._trace, self._audit = metrics, trace, audit
        self._ff = []
        self.metrics_carries = []
        self.trace_carries = []
        self.audit_carries = []
        self._validated = False

    def _chunk_fn(self, ms: int, k: int):
        """The chunk of this Runner's plane (or of none), as ``run(net,
        pstate, t) -> (net, pstate, skip counts or None, carry or
        None)``."""
        proto, ff = self.protocol, self._fast_forward
        specs = {"metrics": self._metrics, "trace": self._trace,
                 "audit": self._audit}
        name = next((n for n, spec in specs.items() if spec is not None),
                    None)
        if name is None:
            if ff:
                base = fast_forward_chunk(proto, ms, superstep=k)
                return lambda net, ps, t: (*base(net, ps, t), None)
            dense = scan_chunk(proto, ms, superstep=k)
            return lambda net, ps, t: (*dense(net, ps, t), None, None)
        from .. import obs
        build = {"metrics": (obs.fast_forward_chunk_metrics,
                             obs.scan_chunk_metrics),
                 "trace": (obs.fast_forward_chunk_trace,
                           obs.scan_chunk_trace),
                 "audit": (obs.fast_forward_chunk_audit,
                           obs.scan_chunk_audit)}[name][0 if ff else 1]
        base = build(proto, ms, specs[name], superstep=k)
        if ff:
            return base

        def dense_plane(net, ps, t):
            net, ps, carry = base(net, ps, t)
            return net, ps, None, carry

        return dense_plane

    def run_ms(self, net: NetState, pstate, ms: int):
        """Advance `ms` milliseconds (wittgenstein_tpu/core/network.py:
        1399-1443)."""
        if not self._validated:
            validate = getattr(self.protocol.latency, "validate", None)
            if validate is not None:
                validate(net.nodes)
            self._validated = True
        ms = int(ms)
        t = int(net.time)
        stat_ms = (self._metrics.stat_each_ms
                   if self._metrics is not None else None)
        k = (pick_superstep(self.protocol, ms, t0=t, max_k=self._superstep,
                            also_divides=stat_ms)
             if self._superstep >= 2 else 1)
        net, pstate, stats, carry = self._chunk_fn(ms, k)(net, pstate, t)
        if stats is not None:
            self._ff.append(stats)
        if carry is not None:
            for spec, carries in ((self._metrics, self.metrics_carries),
                                  (self._trace, self.trace_carries),
                                  (self._audit, self.audit_carries)):
                if spec is not None:
                    carries.append(carry)
        return net, pstate

    def ff_stats(self):
        """The skip counts summed over every call this Runner made, or
        None when fast-forward was off or never ran
        (wittgenstein_tpu/core/network.py:1317-1330)."""
        if not self._ff:
            return None
        return {k: sum(s[k] for s in self._ff)
                for k in ("skipped_ms", "jump_count")}

    def metrics_frame(self):
        """Host-side `obs.MetricsFrame` stitched from every call's carry,
        or None when metrics were off or never ran
        (wittgenstein_tpu/core/network.py:1332-1339)."""
        if self._metrics is None or not self.metrics_carries:
            return None
        from ..obs.export import MetricsFrame
        return MetricsFrame.from_carries(self._metrics,
                                         self.metrics_carries)

    def trace_frame(self):
        """Host-side `obs.TraceFrame` stitched from every call's event
        ring, or None when tracing was off or never ran
        (wittgenstein_tpu/core/network.py:1341-1347)."""
        if self._trace is None or not self.trace_carries:
            return None
        from ..obs.decode import TraceFrame
        return TraceFrame.from_carries(self._trace, self.trace_carries)

    def trace_stats(self):
        """Flight-recorder truncation accounting across every call: total
        recorded events, the per-call ring high-water mark, capacity and
        the dropped-event count, or None when tracing was off or never
        ran (wittgenstein_tpu/core/network.py:1349-1367).  Reads the
        device."""
        if self._trace is None or not self.trace_carries:
            return None
        from ..obs.export import to_host
        cursors = [to_host(tc.cursor).reshape(-1)
                   for tc in self.trace_carries]
        dropped = sum(int(to_host(tc.dropped).sum())
                      for tc in self.trace_carries)
        return {"events": int(sum(c.sum() for c in cursors)),
                "high_water": int(max(c.max() for c in cursors)),
                "capacity": self._trace.capacity,
                "dropped": dropped}

    def audit_report(self):
        """Host-side `obs.AuditReport` stitched from every call's carry,
        or None when the audit plane was off or never ran
        (wittgenstein_tpu/core/network.py:1369-1380).  Reads the
        device."""
        if self._audit is None or not self.audit_carries:
            return None
        from ..obs.audit import monitored_invariants
        from ..obs.audit_report import AuditReport
        return AuditReport.from_carries(
            self._audit, self.audit_carries,
            monitored=monitored_invariants(self._audit,
                                           self.protocol.cfg))

    def audit_stats(self):
        """The audit verdict dict across every call, or None when the
        plane was off or never ran
        (wittgenstein_tpu/core/network.py:1382-1387)."""
        rep = self.audit_report()
        return None if rep is None else rep.stats()

    def run_report(self, net: NetState, wall_s=None) -> str:
        """One-line run summary (`utils/profiling.run_report`) with this
        Runner's skip counts, flight-recorder truncation and audit
        verdict (wittgenstein_tpu/core/network.py:1388-1395).  Reads
        the device."""
        from ..utils.profiling import run_report
        return run_report(net, wall_s, ff=self.ff_stats(),
                          trace=self.trace_stats(),
                          audit=self.audit_stats())
