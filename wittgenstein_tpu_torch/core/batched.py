"""The seed-folded engine — the port of `wittgenstein_tpu/core/batched.py`,
the benchmark headline's engine.

A batch of R runs (every state leaf with a leading seed axis, the layout
of `core/state.init_batched`) advances in lockstep, in superstep windows
of K ms.  The engine itself is `core/network.step_kms` on a batch: the
mailbox machinery works on the whole batch at once (one K-row inbox
window read with an explicit R axis, one clear, and ONE launch of the
binning kernel for all K ms of all R seeds, the seed axis being the
kernel's grid.y, `ops/route.py`), and everything else runs under
`torch.func.vmap`: the protocol step and the routing (latency draws), as
at wittgenstein_tpu/core/batched.py:236-262.  Inside the step the merge
and score kernels are custom ops whose vmap rules fold the seed axis
into their row axis, so every kernel launch and every PyTorch op of a
window serves all R seeds; there is no loop over seeds.

`scan_chunk_batched` keeps the JAX package's scope: ``spill_cap == 0``
and ``bcast_slots == 0`` (Handel, GSF), K >= 2, all runs at the same
time.  The same engine runs any protocol at any K the shared gate
licenses, broadcasts and the spill buffer included, through
`network.scan_chunk` on a batch, which is what the multi-run harness
(`core/harness.py`) calls.  `fast_forward_chunk_batched` is the
fast-forward engine (`network.fast_forward_chunk`) on a batch in the
same scope: the batch jumps by the minimum of its runs' oracles.
"""

from __future__ import annotations

from .network import (check_chunk_config, fast_forward_chunk,
                      fast_forward_ok, next_work, scan_chunk, step_kms,
                      superstep_ok)


#: Batched twin of `network.step_kms` (wittgenstein_tpu/core/batched.py:
#: 174-277): the engine itself takes the seed batch, with `frozen` runs
#: kept out of the ring's clear and bins.  The JAX engine's
#: `plane_barrier` orders XLA's in-place plane updates; eager PyTorch
#: runs in stream order and has no counterpart.
step_kms_batched = step_kms

#: Batched next-event oracle (wittgenstein_tpu/core/batched.py:290-308):
#: the minimum over the seed batch of each run's earliest work ms, from
#: the ring term and the protocol timers (no broadcasts in this scope);
#: `network.next_work` on a batch computes exactly that.
_next_work_batched = next_work


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


def fast_forward_chunk_batched(protocol, ms: int, superstep: int = 2):
    """Fast-forward for the seed-folded engine
    (wittgenstein_tpu/core/batched.py:311-359): one K-ms window of the
    batch, then a jump by the batch's minimum oracle, floored to a
    multiple of K.  Bit-identical to `scan_chunk_batched`.  Returns
    ``run(net, pstate, t=None) -> (net, pstate, stats)`` as
    `network.fast_forward_chunk` does."""
    check_chunk_config(protocol, ms, superstep=superstep,
                       fast_forward=True)
    _check_batched_scope(protocol, ms, superstep)
    if not fast_forward_ok(protocol):
        raise ValueError("fast_forward_chunk_batched needs a protocol "
                         "implementing next_action_time (without it no "
                         "window is provably quiet and the loop would "
                         "degenerate to a slower dense scan)")
    return fast_forward_chunk(protocol, ms, seed_axis=True,
                              superstep=superstep)


def scan_chunk_batched(protocol, ms: int, t0_mod=None, fast_forward=False,
                       superstep: int = 2):
    """Batched twin of ``scan_chunk(superstep=K)`` for seed-batched state
    (wittgenstein_tpu/core/batched.py:377-436); K defaults to the
    universally valid 2.  Returns ``run(net, pstate, t=None,
    frozen=None) -> (net, pstate)``: `t` is the batch's entry time (read
    from seed 0 when omitted), `frozen` as in `network.step_kms`.  With
    `t0_mod` the chunk is phase-specialized and must be a multiple of
    the (K-adjusted) schedule lcm.  ``fast_forward=True`` runs
    `fast_forward_chunk_batched` and drops its skip counts."""
    check_chunk_config(protocol, ms, t0_mod=t0_mod, superstep=superstep,
                       fast_forward=fast_forward)
    if fast_forward:
        base = fast_forward_chunk_batched(protocol, ms, superstep=superstep)

        def run_ff(net, pstate, t=None, frozen=None):
            return base(net, pstate, t, frozen)[:2]

        return run_ff
    _check_batched_scope(protocol, ms, superstep)
    return scan_chunk(protocol, ms, t0_mod=t0_mod, superstep=superstep)
