"""The seed-folded engine — the port of `wittgenstein_tpu/core/batched.py`,
the benchmark headline's engine.

A batch of R runs (every state leaf with a leading seed axis, the layout
of `core/state.init_batched`) advances in lockstep, in superstep windows
of K ms.  The mailbox machinery works on the whole batch at once: one
K-row inbox window read with an explicit R axis, one clear, and ONE
launch of the binning kernel for all K ms of all R seeds (the seed axis
is the kernel's grid.y, `ops/route.py`).  Everything else is the same
code as the dense engine under `torch.func.vmap`: the protocol step and
the routing (latency draws), as at wittgenstein_tpu/core/batched.py:
236-262.  Inside the step the merge and score kernels are custom ops
whose vmap rules fold the seed axis into their row axis, so every kernel
launch and every PyTorch op of a window serves all R seeds; there is no
loop over seeds.

Scope, as in the JAX package: ``spill_cap == 0`` and ``bcast_slots ==
0`` (Handel), K >= 2, all runs at the same time.  Fast-forward is not
ported (ROADMAP.md).
"""

from __future__ import annotations

import functools

import torch

from ..ops.route import bin_into_ring
from .network import (_concat_batches, _count_received, _route, _unported,
                      check_chunk_config, check_config, chunk_hints,
                      protocol_step, superstep_ok)
from .state import EngineConfig, Inbox, NetState

I32 = torch.int32


def _batched_inbox(cfg: EngineConfig, net: NetState, t: int, k: int):
    """The K-row inbox window of every seed, as views of the ring with an
    explicit R axis (wittgenstein_tpu/core/batched.py:133-171, for K ms
    at once): ``(data [R, K, N, C, F], src [R, K, N, C], valid [R, K, N,
    C])`` and the nodes with the window's receive counters bumped."""
    nodes = net.nodes
    r = net.box_count.shape[0]
    h = t % cfg.horizon
    data = net.box_data[:, :, h:h + k].permute(0, 2, 3, 4, 1)
    src = net.box_src[:, h:h + k]
    size = net.box_size[:, h:h + k]
    slots = torch.arange(cfg.inbox_cap, dtype=I32, device=src.device)
    valid = slots < net.box_count[:, h:h + k, :, None]
    part_src = torch.gather(nodes.partition, 1,
                            src.reshape(r, -1).long()).reshape(src.shape)
    deliver_ok = (~nodes.down[:, None, :, None]) & (
        part_src == nodes.partition[:, None, :, None])
    valid = valid & deliver_ok
    return (data, src, valid), _count_received(nodes, valid, size, (1, 3))


def step_kms_batched(protocol, net: NetState, pstate, k: int, hints_k=None,
                     t: int | None = None, frozen=None):
    """Batched twin of `network.step_kms` (wittgenstein_tpu/core/
    batched.py:174-277): the K-ms window for every seed of the batch.
    Preconditions: spill_cap == 0, bcast_slots == 0, all runs at time
    `t` (read from seed 0 when omitted) with ``t % K == 0``, K valid per
    `network.superstep_ok`.

    `frozen` ([R] bool, optional) marks runs that must not change: their
    ring rows are neither cleared nor binned into (the ring is updated in
    place, so a caller that keeps a stopped run's other leaves cannot
    restore its ring afterwards; `core/harness.py` uses it).  The JAX
    engine's `plane_barrier` orders XLA's in-place plane updates; eager
    PyTorch runs in stream order and has no counterpart."""
    cfg, model = protocol.cfg, protocol.latency
    if cfg.spill_cap or cfg.bcast_slots:
        raise ValueError("step_kms_batched requires spill_cap == 0 and "
                         "bcast_slots == 0 (core/batched.py scope)")
    check_config(cfg)
    if getattr(protocol, "apply_faults", None) is not None:
        raise _unported("fault hooks (apply_faults)")
    if hints_k is not None and len(hints_k) != k:
        raise ValueError(f"hints_k must have {k} entries, got "
                         f"{len(hints_k)}")
    if t is None:
        t = int(net.time[0])
    (data, src, valid), nodes = _batched_inbox(cfg, net, t, k)
    net = net.replace(nodes=nodes)

    outs = []
    for i in range(k):
        step = functools.partial(
            protocol_step, protocol, t=t + i,
            hints=None if hints_k is None else hints_k[i])
        inbox = Inbox(data=data[:, i], src=src[:, i], valid=valid[:, i])
        pstate, nodes, out = torch.func.vmap(step)(pstate, net.nodes, inbox)
        net = net.replace(nodes=nodes)
        outs.append(out)

    h = t % cfg.horizon
    if frozen is None:
        net.box_count[:, h:h + k] = 0
    else:
        rows = net.box_count[:, h:h + k]
        rows.copy_(torch.where(frozen[:, None, None], rows, 0))

    # Routing per seed (vmapped: elementwise work and the latency
    # model), then ONE bin for all K ms across all seeds.
    batches = []
    for i, out in enumerate(outs):
        route = functools.partial(_route, cfg, model, t=t + i)
        nodes, b, _ = torch.func.vmap(route)(net.nodes, net.seed, out)
        net = net.replace(nodes=nodes)
        batches.append(b)
    (msrc, dest, arrival, payload, msize, ok), n_clamped = \
        _concat_batches(batches, 1)
    if frozen is not None:
        ok = ok & ~frozen[:, None]
    # The seed-folded scatter of wittgenstein_tpu/core/batched.py:44-131
    # (`_batched_bin`): the kernel takes the seed axis as its grid.y.
    n_dropped = bin_into_ring(net.box_data, net.box_src, net.box_size,
                              net.box_count, arrival, dest, msrc, msize,
                              payload, ok)
    return net.replace(dropped=net.dropped + n_dropped,
                       clamped=net.clamped + n_clamped,
                       time=net.time + k), pstate


def step_2ms_batched(protocol, net: NetState, pstate, hints2=(None, None),
                     t: int | None = None):
    """The K == 2 seed-folded superstep (wittgenstein_tpu/core/batched.py:
    280-288): K == 2 needs no latency floor and no self-send
    declaration."""
    return step_kms_batched(protocol, net, pstate, 2, hints_k=list(hints2),
                            t=t)


def _check_batched_scope(protocol, ms, superstep):
    """The batched engine's own preconditions on top of the shared gate
    (wittgenstein_tpu/core/batched.py:362-374)."""
    if (superstep < 2 or ms % superstep or protocol.cfg.spill_cap
            or protocol.cfg.bcast_slots
            or not superstep_ok(protocol, superstep)):
        raise ValueError(
            f"the batched engine needs a chunk that is a multiple of "
            f"superstep={superstep} (>= 2; got chunk {ms}) and a "
            "spill-free, broadcast-free, superstep-eligible protocol "
            "(core/batched.py scope; see network.check_chunk_config for "
            "the per-constraint remedies)")


def scan_chunk_batched(protocol, ms: int, t0_mod=None, fast_forward=False,
                       superstep: int = 2):
    """Batched twin of ``scan_chunk(superstep=K)`` for seed-batched state
    (wittgenstein_tpu/core/batched.py:377-436); K defaults to the
    universally valid 2.  Returns ``run(net, pstate, t=None,
    frozen=None) -> (net, pstate)``: `t` is the batch's entry time (read
    from seed 0 when omitted), `frozen` as in `step_kms_batched`.  With
    `t0_mod` the chunk is phase-specialized and must be a multiple of
    the (K-adjusted) schedule lcm."""
    k = superstep
    check_chunk_config(protocol, ms, t0_mod=t0_mod, superstep=k,
                       fast_forward=fast_forward)
    _check_batched_scope(protocol, ms, k)
    hints = chunk_hints(protocol, ms, t0_mod, k) or [None] * k

    def run(net, pstate, t=None, frozen=None):
        t = int(net.time[0]) if t is None else t
        for _ in range(ms // len(hints)):
            for i in range(0, len(hints), k):
                net, pstate = step_kms_batched(
                    protocol, net, pstate, k, hints_k=hints[i:i + k], t=t,
                    frozen=frozen)
                t += k
        return net, pstate

    return run
