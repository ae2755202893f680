"""`ChaosProtocol` — compile a `FaultSchedule` into any protocol of the
port (the port of `wittgenstein_tpu/chaos/wrap.py`).

The wrapper reaches every engine variant through two seams, so no
engine grows a chaos-specific code path:

  * `apply_faults(net, t)` — the engine's window-entry hook
    (`core/network.step_kms` at every window entry, so every ms at
    K = 1; the seed-folded and fast-forward engines run the same
    function): churn down-state and partition membership are
    STATELESS functions of t, written at every window entry.  A seed
    batch's [R, N] node leaves broadcast against the [N] fault vectors.
  * `step` — the per-ms protocol step: the inner step's outbox is
    post-processed with the loss and delay adversaries.  A lost unicast
    has its dest cleared (the engine then never routes or counts it), a
    delayed one gets `extra_ms` added to its sender-chosen delay.

The engine's simulated time is a Python int, so which windows are open
at t is decided on the host: a closed loss or delay window issues no
operation (in the JAX program it multiplies by 1.0 or adds 0, exactly),
and the churn/partition vectors are built once per distinct fault state
and kept on the device.  Loss draws are counter-based (`ops/prng`) on
(run seed, emit ms, full-width outbox slot id), keyed on the engine's
per-step PRNG key: ``fold_in(PRNGKey(seed), t)``, which the engine
builds (`ops/prng.fold_in_key`) only for a protocol that sets
``wants_step_key`` — this wrapper does when its schedule has loss — and
folds to one stream seed as the JAX package does (`_key_seed`).  The
realization is bit-identical to the JAX package's and independent of
the batch layout.

Fast-forward: `next_action_time` clamps the inner oracle at the next
churn/partition transition, so a jump never crosses one; a protocol
without the oracle stays without one.  Taps see the post-application
state (the obs planes' `node_down`/`node_up` kinds, audit).  Not
ported yet: the sharded engine's half (`step_sharded`, `gids`), which
waits for the port's multi-device engine (ROADMAP.md A15).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import prng
from .schedule import FaultSchedule

#: domain-separation tag for the loss draws
#: (wittgenstein_tpu/chaos/wrap.py:67)
TAG_CHAOS = 0x43484153      # "CHAS"


def impact_summary(net) -> dict:
    """The 4-counter impact fingerprint of a (possibly seed-batched)
    final NetState (wittgenstein_tpu/chaos/wrap.py:70-84)."""
    nodes = net.nodes
    down = nodes.down.cpu().numpy()
    return {
        "done_count": int(((nodes.done_at.cpu().numpy() > 0)
                           & ~down).sum()),
        "live_count": int((~down).sum()),
        "msg_sent": int(nodes.msg_sent.sum()),
        "msg_received": int(nodes.msg_received.sum()),
    }


def _key_seed(key):
    """Fold the engine's per-step key (``fold_in(PRNGKey(seed), t)``, two
    uint32 words held in int64) to one uint32 stream seed
    (wittgenstein_tpu/chaos/wrap.py:87-93)."""
    return prng.hash2(key[..., 0] ^ key[..., -1], TAG_CHAOS)


class ChaosProtocol:
    """Protocol proxy carrying a `FaultSchedule` (module docstring).
    Everything not chaos-related delegates to the wrapped protocol."""

    def __init__(self, inner, schedule: FaultSchedule):
        if isinstance(schedule, dict):
            schedule = FaultSchedule.from_json(schedule)
        self._inner = inner
        #: the engine gates key on this attribute (`superstep_ok`,
        #: `check_chunk_config`)
        self.chaos_schedule = schedule.validate(n=inner.cfg.n)
        #: the engine hands `step` its per-step key only when asked
        self.wants_step_key = bool(self.chaos_schedule.loss)
        self._trans = self.chaos_schedule.transition_times()
        self._states = {}           # (device, fault state) -> tensors
        self._src_in = {}           # (device, lo, hi) -> [N, 1] bool
        if getattr(inner, "next_action_time", None) is None:
            self.next_action_time = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # --------------------------------------------- window-entry mutation

    def _fault_state(self, t: int, device):
        """The churn and partition vectors of time `t`, built once per
        distinct fault state: ``(owned, down_vec, pmask, pvec)``, each
        None when its class is empty.  ``down = where(owned, down_vec,
        down)``; ``partition = where(pmask, pvec, partition)`` holds
        both the open windows' ids and the heal to 0 of every node a
        window ever claimed (wittgenstein_tpu/chaos/wrap.py:149-206)."""
        sch = self.chaos_schedule
        active = (tuple(dm <= t < um for _, dm, um in sch.churn),
                  tuple(s <= t < e for s, e, *_ in sch.partitions))
        key = (str(device), active)
        if key not in self._states:
            n = self.cfg.n
            out = [None] * 4
            if sch.churn:
                owned = np.zeros(n, bool)
                down = np.zeros(n, bool)
                for (node, _, _), act in zip(sch.churn, active[0]):
                    owned[node] = True
                    down[node] |= act
                out[:2] = owned, down
            if sch.partitions:
                ever = np.zeros(n, bool)
                pvec = np.zeros(n, np.int32)
                for (_, _, pid, lo, hi), act in zip(sch.partitions,
                                                    active[1]):
                    ever[lo:hi] = True
                    if act:
                        pvec[lo:hi] = pid
                out[2:] = ever, pvec
            self._states[key] = tuple(
                None if a is None else torch.tensor(a, device=device)
                for a in out)
        return self._states[key]

    def apply_faults(self, net, t: int):
        """Write the schedule's churn/partition state for absolute time
        `t` into `net.nodes` — the engine's window-entry hook; a no-op
        (bitwise) at every non-transition ms.  A node NAMED in a churn
        event has its down flag owned by the schedule: outside its
        outage windows it is UP, entry included
        (wittgenstein_tpu/chaos/wrap.py:149-168)."""
        sch = self.chaos_schedule
        if not sch.mutates_state:
            return net
        nodes = net.nodes
        owned, down, pmask, pvec = self._fault_state(int(t),
                                                     nodes.down.device)
        if owned is not None:
            nodes = nodes.replace(down=torch.where(owned, down, nodes.down))
        if pmask is not None:
            nodes = nodes.replace(partition=torch.where(pmask, pvec,
                                                        nodes.partition))
        return net.replace(nodes=nodes)

    # ------------------------------------------------- per-ms adversary

    def _src_mask(self, lo: int, hi: int, device):
        key = (str(device), lo, hi)
        if key not in self._src_in:
            m = np.zeros((self.cfg.n, 1), bool)
            m[lo:hi] = True
            self._src_in[key] = torch.tensor(m, device=device)
        return self._src_in[key]

    def _mutate_outbox(self, out, t: int, key):
        """The loss and delay adversaries on one run's outbox at ms `t`
        (wittgenstein_tpu/chaos/wrap.py:210-251); only the windows open
        at t issue operations."""
        sch = self.chaos_schedule
        delay = [ev for ev in sch.delay if ev[0] <= t < ev[1]]
        loss = [ev for ev in sch.loss if ev[0] <= t < ev[1]]
        if not (delay or loss):
            return out
        n = self.cfg.n
        dest = out.dest
        dev = dest.device
        live = dest >= 0
        dst_c = dest.clamp(0, n - 1)

        def link_match(ev):
            _s, _e, _val, slo, shi, dlo, dhi = ev
            return (self._src_mask(slo, shi, dev) & (dst_c >= dlo)
                    & (dst_c < dhi) & live)

        if delay:
            extra = out.delay
            for ev in delay:
                extra = extra + torch.where(link_match(ev), ev[2], 0).to(
                    extra.dtype)
            out = out.replace(delay=extra)
        if loss:
            keep = torch.ones(dest.shape, dtype=torch.float32, device=dev)
            for ev in loss:
                # the factor as jnp.float32(1.0 - p / 1000.0) rounds it
                f = float(np.float32(1.0 - ev[2] / 1000.0))
                keep = torch.where(link_match(ev), keep * f, keep)
            ke = dest.shape[-1]
            gid = torch.arange(n, dtype=torch.int32, device=dev)
            midx = (gid[:, None] * self.cfg.out_deg + out.slot0
                    + torch.arange(ke, dtype=torch.int32, device=dev))
            u = prng.uniform_float(_key_seed(key), midx)
            lost = live & (u < (1.0 - keep))
            out = out.replace(dest=torch.where(lost, -1, dest))
        return out

    # ------------------------------------------------- protocol contract

    def step(self, pstate, nodes, inbox, t, key=None, **kw):
        pstate, nodes, out = self._inner.step(pstate, nodes, inbox, t,
                                              **kw)
        return pstate, nodes, self._mutate_outbox(out, t, key)

    def next_action_time(self, pstate, nodes, t):
        """The inner oracle clamped at the next churn/partition
        transition >= t (wittgenstein_tpu/chaos/wrap.py:258-272); only
        defined when the inner protocol has the oracle."""
        nxt = self._inner.next_action_time(pstate, nodes, t)
        later = [x for x in self._trans if x >= int(t)]
        return nxt if not later else nxt.clamp_max(later[0])
