"""The per-ms and superstep engines — the port of
`wittgenstein_tpu/core/network.py`'s dense path.

Per simulated ms t: read the ring row ``t % H`` as the inbox, let the
protocol step every node at once, clear the consumed row, then route
the step's unicast sends into the ring with the binning kernel
(`ops/route.py`).  Determinism comes from the counter-based hashes and
the stable in-cell order of the binning, as in the JAX package.  The
superstep engine (`step_kms`) does the same for a window of K ms: it
reads the K rows at once, steps K times, clears the K rows, and bins all
K outboxes with one launch.

The JAX engine is pure; this one updates the mailbox ring (the
`box_*` tensors, 126 MB at 2048 nodes) IN PLACE, because copying it
every ms would cost more than the step.  Every other leaf is replaced.
The simulated time is carried as a Python int inside a chunk (read from
the device at most once per call), so the step loop never waits for
the card.

Ported: the unicast-only path of `build_inbox` (``bcast_slots == 0``),
`_unicast_inbox_window`, `_route_unicast`, `enqueue_unicast`
(``spill_cap == 0``), `_bin_into_ring`, `step_ms`, `step_kms`,
`step_2ms`, the superstep gate (`unicast_floor_ms`, `superstep_ok`,
`check_chunk_config`, `pick_superstep`), `scan_chunk` with phase hints
and `Runner`.  Broadcasts, the spill buffer and fast-forward raise
`NotImplementedError` and are queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from ..ops import prng
from ..ops.route import bin_into_ring
from .latency import full_latency, latency_floor_ms
from .state import EngineConfig, Inbox, NetState, Outbox

I32 = torch.int32

#: Default upper bound for auto-picked superstep windows
#: (wittgenstein_tpu/core/network.py:894-897).
AUTO_SUPERSTEP_MAX = 32


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


def _unicast_inbox_window(cfg: EngineConfig, net: NetState, t: int, k: int):
    """K consecutive unicast inbox slices as one window
    (wittgenstein_tpu/core/network.py:96-130): ``(data [K, N, C, F],
    src [K, N, C], size [K, N, C], valid [K, N, C])``, views of the ring
    rows ``t % H .. t % H + K - 1`` (`step_kms` requires ``t % K == 0``
    and ``K | H``, so they never wrap).  Delivery-time down/partition
    checks are evaluated once for the window: `step_kms` requires a
    protocol that does not change liveness."""
    nodes = net.nodes
    h = t % cfg.horizon
    data = net.box_data[:, h:h + k].permute(1, 2, 3, 0)
    src = net.box_src[h:h + k]
    size = net.box_size[h:h + k]
    slots = torch.arange(cfg.inbox_cap, dtype=I32, device=src.device)
    valid = slots[None, None, :] < net.box_count[h:h + k][:, :, None]
    deliver_ok = (~nodes.down[None, :, None]) & (
        nodes.partition[src] == nodes.partition[None, :, None])
    return data, src, size, valid & deliver_ok


def _count_received(nodes, valid, size, dims):
    """Bump the receive counters by the delivered messages."""
    recv = valid.sum(dims, dtype=I32)
    rbytes = torch.where(valid, size, 0).sum(dims, dtype=I32)
    return nodes.replace(msg_received=nodes.msg_received + recv,
                         bytes_received=nodes.bytes_received + rbytes)


def build_inbox(cfg: EngineConfig, model, net: NetState, t: int):
    """Assemble the time-t inbox and bump the receive counters
    (wittgenstein_tpu/core/network.py:133-195, the ``bcast_slots == 0``
    path).  Returns ``(inbox, nodes)``; the inbox tensors are views of
    the ring row."""
    check_config(cfg)
    data, src, size, valid = _unicast_inbox_window(cfg, net, t, 1)
    nodes = _count_received(net.nodes, valid[0], size[0], 1)
    return Inbox(data=data[0], src=src[0], valid=valid[0]), nodes


def _bin_into_ring(cfg: EngineConfig, net: NetState, t: int, src, dest,
                   arrival, payload, size, valid):
    """Bin a batch of messages into the ring, in place
    (wittgenstein_tpu/core/network.py:198-285).  `dest` is clipped to
    [0, n) and ``arrival - t`` lies in [1, horizon-1] for the per-ms
    path, [K, horizon+K-2] for a K-ms window.  Returns ``(net,
    n_dropped)``."""
    dropped = bin_into_ring(
        net.box_data[None], net.box_src[None], net.box_size[None],
        net.box_count[None], arrival[None], dest[None], src[None],
        size[None], payload[None], valid[None])
    return net, dropped[0]


def _route(cfg: EngineConfig, model, nodes, seed, out: Outbox, t: int):
    """Sender counters, latency draws and validity of one seed's outbox
    (wittgenstein_tpu/core/network.py:334-389).  Returns ``(nodes',
    batch, abs_arrival_raw)`` with batch ``(src, dest_c, arrival,
    payload, size, valid, far)``; runs under `torch.func.vmap` in the
    seed-folded engine."""
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

    seed_t = prng.hash3(seed, prng.TAG_LATENCY, t)
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
    return nodes, batch, t + 1 + raw_total


def _route_unicast(cfg: EngineConfig, model, net: NetState, out: Outbox,
                   t: int):
    """`_route` on a NetState: returns ``(net', batch,
    abs_arrival_raw)``."""
    nodes, batch, raw = _route(cfg, model, net.nodes, net.seed, out, t)
    return net.replace(nodes=nodes), batch, raw


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


def protocol_step(protocol, pstate, nodes, inbox, t: int, hints=None):
    """``protocol.step``, with the phase hints only when there are any
    (protocols without a static schedule take none)."""
    if hints is None:
        return protocol.step(pstate, nodes, inbox, t)
    return protocol.step(pstate, nodes, inbox, t, hints=hints)


def _check_step(protocol):
    check_config(protocol.cfg)
    if getattr(protocol, "apply_faults", None) is not None:
        raise _unported("fault hooks (apply_faults)")


def step_ms(protocol, net: NetState, pstate, t: int | None = None,
            hints=None):
    """Advance one millisecond (wittgenstein_tpu/core/network.py:
    448-504, without taps or fault hooks).  `t` is the current
    ``net.time`` as a Python int; when omitted it is read from the
    device.  `hints` are the protocol's phase hints for this ms."""
    cfg, model = protocol.cfg, protocol.latency
    _check_step(protocol)
    if t is None:
        t = int(net.time)
    inbox, nodes = build_inbox(cfg, model, net, t)
    net = net.replace(nodes=nodes)
    pstate, nodes, out = protocol_step(protocol, pstate, net.nodes, inbox, t,
                                       hints)
    net = net.replace(nodes=nodes)
    # Clear the consumed row, then route new sends (their arrivals are
    # >= t+2, so they never land in the row just cleared).
    net.box_count[t % cfg.horizon] = 0
    net = enqueue_unicast(cfg, model, net, out, t)
    return net.replace(time=torch.full_like(net.time, t + 1)), pstate


def _concat_batches(batches, dim):
    """The routed batches of a window as one: (src, dest, arrival,
    payload, size, valid) concatenated along `dim`, and the clamp
    count."""
    n_clamped = batches[0][6].sum(dim, dtype=I32)
    for b in batches[1:]:
        n_clamped = n_clamped + b[6].sum(dim, dtype=I32)
    cols = [torch.cat([b[i] for b in batches], dim) for i in range(6)]
    return cols, n_clamped


def step_kms(protocol, net: NetState, pstate, k: int, hints_k=None,
             t: int | None = None):
    """Advance K milliseconds in one fused engine pass, the superstep
    (wittgenstein_tpu/core/network.py:507-663, unicast only).

    Bit-identical to K `step_ms` calls whenever no unicast sent inside
    the window can arrive inside it: K <= ``unicast_floor_ms() + 1``
    (`check_chunk_config` proves it).  The K inbox rows are read as one
    window, the K protocol steps run in order, the K consumed rows are
    cleared, and all K outboxes are routed and binned by ONE launch
    (arrivals relative to t span [K, horizon + K - 2]; those past the
    horizon land in the rows just cleared, so the clear must come
    before the bin).  Requires ``t % K == 0`` and ``K | horizon``."""
    if hints_k is not None and len(hints_k) != k:
        raise ValueError(f"hints_k must have {k} entries, got "
                         f"{len(hints_k)}")
    if k == 1:
        return step_ms(protocol, net, pstate, t,
                       hints=None if hints_k is None else hints_k[0])
    cfg, model = protocol.cfg, protocol.latency
    if cfg.spill_cap > 0:
        raise ValueError("step_kms requires spill_cap == 0 (spill drain "
                         "is inherently per-ms)")
    _check_step(protocol)
    if t is None:
        t = int(net.time)
    # All K slices and their receive counters up front (the counters are
    # write-only to the protocol step, so the early bump is invisible).
    data, src, size, valid = _unicast_inbox_window(cfg, net, t, k)
    net = net.replace(nodes=_count_received(net.nodes, valid, size, (0, 2)))
    outs = []
    for i in range(k):
        inbox = Inbox(data=data[i], src=src[i], valid=valid[i])
        pstate, nodes, out = protocol_step(
            protocol, pstate, net.nodes, inbox, t + i,
            None if hints_k is None else hints_k[i])
        net = net.replace(nodes=nodes)
        outs.append(out)
    h = t % cfg.horizon
    net.box_count[h:h + k] = 0
    batches = []
    for i, out in enumerate(outs):
        net, b, _ = _route_unicast(cfg, model, net, out, t + i)
        batches.append(b)
    (msrc, dest, arrival, payload, msize, ok), n_clamped = \
        _concat_batches(batches, 0)
    net, n_dropped = _bin_into_ring(cfg, net, t, msrc, dest, arrival,
                                    payload, msize, ok)
    return net.replace(dropped=net.dropped + n_dropped,
                       clamped=net.clamped + n_clamped,
                       time=torch.full_like(net.time, t + k)), pstate


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
    time must also be K-aligned, which the caller checks)."""
    cfg = protocol.cfg
    return (cfg.spill_cap == 0
            and superstep >= 1
            and cfg.horizon % superstep == 0
            and superstep < cfg.horizon
            and superstep <= unicast_floor_ms(protocol) + 1
            and not getattr(protocol, "mutates_liveness", False))


def check_chunk_config(protocol, ms, t0_mod=None, superstep=1,
                       fast_forward=False):
    """The shared eligibility gate of the chunk variants
    (wittgenstein_tpu/core/network.py:761-891, with its remedy texts):
    plain, superstep-K and phase-specialized.  It RAISES, never changes
    results; `pick_superstep` is the demoting half.  From `t0_mod` (a
    residue mod the schedule lcm) the K-alignment of the absolute entry
    time is provable only mod gcd(K, lcm); callers that know the entry
    time route through `pick_superstep(t0=...)`.  Fast-forward is not
    ported; the chaos plane's schedule checks have no protocol here."""
    cfg = protocol.cfg
    if not isinstance(superstep, int) or superstep < 1:
        raise ValueError(f"superstep must be a positive int, got "
                         f"{superstep!r}")
    if fast_forward:
        raise _unported("the fast-forward engine")
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


def scan_chunk(protocol, ms: int, t0_mod=None, superstep: int = 1,
               fast_forward: bool = False):
    """Returns ``run(net, pstate, t=None) -> (net, pstate)`` advancing
    `ms` milliseconds (wittgenstein_tpu/core/network.py:1062-1174), a
    Python loop over the chunk's ms; `t` is the entry time, read from
    the device when omitted.

    ``t0_mod`` (= entry ``time % schedule_lcm``) specializes the chunk:
    each ms gets the protocol's `phase_hints`, so e.g. Handel's
    verification scoring runs only on the ms where a node can verify
    (bit-identical).  ``superstep=K`` advances in fused K-ms windows
    (`step_kms`) when `check_chunk_config` proves them."""
    check_chunk_config(protocol, ms, t0_mod=t0_mod, superstep=superstep,
                       fast_forward=fast_forward)
    k = superstep
    hints = chunk_hints(protocol, ms, t0_mod, k) or [None] * k

    def run(net, pstate, t=None):
        t = int(net.time) if t is None else t
        for _ in range(ms // len(hints)):
            for i in range(0, len(hints), k):
                net, pstate = step_kms(protocol, net, pstate, k,
                                       hints_k=hints[i:i + k], t=t)
                t += k
        return net, pstate

    return run


class Runner:
    """Drives a protocol chunk by chunk — the port of `Runner`
    (wittgenstein_tpu/core/network.py:1177-1443) without observability
    planes.  ``superstep=K`` is an upper bound: each call runs the
    largest K <= it that `pick_superstep` proves for its length and
    entry time."""

    def __init__(self, protocol, superstep=1, fast_forward=False):
        if fast_forward:
            raise _unported("the fast-forward engine")
        check_config(protocol.cfg)
        self.protocol = protocol
        self._superstep = int(superstep)

    def run_ms(self, net: NetState, pstate, ms: int):
        """Advance `ms` milliseconds (wittgenstein_tpu/core/network.py:
        1399-1443)."""
        ms = int(ms)
        t = int(net.time)
        k = (pick_superstep(self.protocol, ms, t0=t, max_k=self._superstep)
             if self._superstep >= 2 else 1)
        return scan_chunk(self.protocol, ms, superstep=k)(net, pstate, t)
