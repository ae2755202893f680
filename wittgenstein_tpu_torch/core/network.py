"""The per-ms engine — the port of `wittgenstein_tpu/core/network.py`'s
dense path.

Per simulated ms t: read the ring row ``t % H`` as the inbox, let the
protocol step every node at once, clear the consumed row, then route
the step's unicast sends into the ring with the binning kernel
(`ops/route.py`).  Determinism comes from the counter-based hashes and
the stable in-cell order of the binning, as in the JAX package.

The JAX engine is pure; this one updates the mailbox ring (the
`box_*` tensors, 126 MB at 2048 nodes) IN PLACE, because copying it
every ms would cost more than the step.  Every other leaf is replaced.
The simulated time is carried as a Python int inside `Runner.run_ms`
(read from the device once per call), so the step loop never waits for
the card.

Ported: the unicast-only path of `build_inbox` (``bcast_slots == 0``),
`_route_unicast`, `enqueue_unicast` (``spill_cap == 0``),
`_bin_into_ring`, `step_ms` and `Runner.run_ms`.  Broadcasts, the
spill buffer, the fused superstep engine and fast-forward raise
`NotImplementedError` and are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from ..ops import prng
from ..ops.route import bin_into_ring
from .latency import full_latency
from .state import EngineConfig, Inbox, NetState, Outbox

I32 = torch.int32


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, the engine items after "
        "the first slice)")


def check_config(cfg: EngineConfig) -> None:
    """Refuse engine configurations the port does not run yet."""
    if cfg.bcast_slots:
        raise _unported("broadcasts (bcast_slots > 0)")
    if cfg.spill_cap:
        raise _unported("the spill buffer (spill_cap > 0)")
    if cfg.box_split != 1:
        raise _unported("ring sub-planes (box_split > 1)")


def build_inbox(cfg: EngineConfig, model, net: NetState, t: int):
    """Assemble the time-t inbox and bump the receive counters
    (wittgenstein_tpu/core/network.py:133-195, the ``bcast_slots == 0``
    path).  Returns ``(inbox, nodes)``; the inbox tensors are views of
    the ring row."""
    check_config(cfg)
    nodes = net.nodes
    c = cfg.inbox_cap
    h = t % cfg.horizon
    uc_data = net.box_data[:, h].permute(1, 2, 0)          # [N, C, F]
    uc_src = net.box_src[h]
    uc_size = net.box_size[h]
    slots = torch.arange(c, dtype=I32, device=uc_src.device)
    uc_valid = slots[None, :] < net.box_count[h][:, None]
    deliver_ok = (~nodes.down[:, None]) & (
        nodes.partition[uc_src] == nodes.partition[:, None])
    uc_valid = uc_valid & deliver_ok
    recv = uc_valid.sum(1, dtype=I32)
    rbytes = torch.where(uc_valid, uc_size, 0).sum(1, dtype=I32)
    nodes = nodes.replace(msg_received=nodes.msg_received + recv,
                          bytes_received=nodes.bytes_received + rbytes)
    return Inbox(data=uc_data, src=uc_src, valid=uc_valid), nodes


def _bin_into_ring(cfg: EngineConfig, net: NetState, t: int, src, dest,
                   arrival, payload, size, valid):
    """Bin a batch of messages into the ring, in place
    (wittgenstein_tpu/core/network.py:198-285).  `dest` is clipped to
    [0, n) and ``arrival - t`` lies in [1, horizon-1].  Returns
    ``(net, n_dropped)``."""
    dropped = bin_into_ring(
        net.box_data[None], net.box_src[None], net.box_size[None],
        net.box_count[None], arrival[None], dest[None], src[None],
        size[None], payload[None], valid[None])
    return net, dropped[0]


def _route_unicast(cfg: EngineConfig, model, net: NetState, out: Outbox,
                   t: int):
    """Sender counters, latency draws and validity
    (wittgenstein_tpu/core/network.py:334-389).  Returns ``(net', batch,
    abs_arrival_raw)`` with batch ``(src, dest_c, arrival, payload,
    size, valid, far)``."""
    nodes = net.nodes
    n, k = cfg.n, out.dest.shape[1]
    m = n * k
    dev = out.dest.device
    src = torch.arange(n, dtype=I32, device=dev).repeat_interleave(k)
    dest = out.dest.reshape(m)
    payload = out.payload.reshape(m, cfg.payload_words)
    size = out.size.reshape(m)
    delay = out.delay.reshape(m)

    want = (dest >= 0) & (~nodes.down[src])
    dest_c = dest.clamp(0, n - 1)
    sent = nodes.msg_sent + want.reshape(n, k).sum(1, dtype=I32)
    sbytes = nodes.bytes_sent + torch.where(want, size, 0).reshape(
        n, k).sum(1, dtype=I32)
    nodes = nodes.replace(msg_sent=sent, bytes_sent=sbytes)
    net = net.replace(nodes=nodes)

    seed_t = prng.hash3(net.seed, prng.TAG_LATENCY, t)
    midx = src * cfg.out_deg + out.slot0 + \
        torch.arange(m, dtype=I32, device=dev) % k
    delta = prng.uniform_delta(seed_t, midx)
    lat = full_latency(model, nodes, src, dest_c, delta)
    not_discarded = lat < cfg.msg_discard_time
    raw_total = delay.clamp_min(0) + lat.clamp_min(1)
    total = raw_total.clamp(1, cfg.horizon - 2)
    valid = want & not_discarded & (~nodes.down[dest_c]) & (
        nodes.partition[src] == nodes.partition[dest_c])
    far = valid & (raw_total > cfg.horizon - 2)
    batch = (src, dest_c, t + 1 + total, payload, size, valid, far)
    return net, batch, t + 1 + raw_total


def enqueue_unicast(cfg: EngineConfig, model, net: NetState, out: Outbox,
                    t: int):
    """Route the step's unicast sends into the ring
    (wittgenstein_tpu/core/network.py:392-414, ``spill_cap == 0``:
    arrivals past the ring are clamped and counted)."""
    check_config(cfg)
    net, batch, _ = _route_unicast(cfg, model, net, out, t)
    src, dest_c, arrival, payload, size, valid, far = batch
    n_clamped = far.sum(dtype=I32)
    net, n_dropped = _bin_into_ring(cfg, net, t, src, dest_c, arrival,
                                    payload, size, valid)
    return net.replace(dropped=net.dropped + n_dropped,
                       clamped=net.clamped + n_clamped)


def step_ms(protocol, net: NetState, pstate, t: int | None = None):
    """Advance one millisecond (wittgenstein_tpu/core/network.py:
    448-504, without hints, taps or fault hooks).  `t` is the current
    ``net.time`` as a Python int; when omitted it is read from the
    device."""
    cfg, model = protocol.cfg, protocol.latency
    check_config(cfg)
    if getattr(protocol, "apply_faults", None) is not None:
        raise _unported("fault hooks (apply_faults)")
    if t is None:
        t = int(net.time)
    inbox, nodes = build_inbox(cfg, model, net, t)
    net = net.replace(nodes=nodes)
    pstate, nodes, out = protocol.step(pstate, net.nodes, inbox, t)
    net = net.replace(nodes=nodes)
    # Clear the consumed row, then route new sends (their arrivals are
    # >= t+2, so they never land in the row just cleared).
    net.box_count[t % cfg.horizon] = 0
    net = enqueue_unicast(cfg, model, net, out, t)
    return net.replace(time=torch.full_like(net.time, t + 1)), pstate


class Runner:
    """Drives a protocol ms by ms — the port of `Runner`
    (wittgenstein_tpu/core/network.py:1177-1443) on its default path
    (superstep 1, no fast-forward, no observability planes)."""

    def __init__(self, protocol, superstep=1, fast_forward=False):
        if superstep != 1:
            raise _unported("the superstep engine (superstep > 1)")
        if fast_forward:
            raise _unported("the fast-forward engine")
        check_config(protocol.cfg)
        self.protocol = protocol

    def run_ms(self, net: NetState, pstate, ms: int):
        """Advance `ms` milliseconds (wittgenstein_tpu/core/network.py:
        1399-1443)."""
        t = int(net.time)
        for _ in range(int(ms)):
            net, pstate = step_ms(self.protocol, net, pstate, t)
            t += 1
        return net, pstate
