"""GSFSignature — "Gossiping San Fermín" BLS aggregation; the port of
`wittgenstein_tpu/models/gsf.py`.

The design notes of the JAX module hold unchanged: the levels share
Handel's id-space geometry, the global verified set V is one [N, W]
bitset row per node, a message carries (level, finished prefix, round
slot) and the receiver rebuilds the sender's set from its snapshot pool,
and the verification queue is a bounded pool of Q entries per node that
takes queued entries, incoming aggregates and incoming individual
signatures in three tiers.

Bitset rows are int32 words holding the JAX package's uint32 bits (see
`ops/bitset.py`).  The two per-ms kernels of the model are
`ops/gsf_merge.gsf_merge` (the receive merge) and `ops/score.gsf_score`
(the verification scoring); on CUDA tensors they launch the hand-written
kernels, on CPU tensors their plain versions.  The step is written out
of place, so it runs under `torch.func.vmap` over a seed batch (the
state registered as a pytree, both kernels custom ops whose vmap rules
fold the seeds into their rows), with one exception: the snapshot pool
(``[N, rounds, W]``, 7.1 GB at 32,768 nodes) has its round slot written
IN PLACE, as the engine writes the ring, where the JAX package writes it
with ``.at[].set`` under donation.  A copy of the pool every ms would
double its memory and move 14 GB a simulated ms at that size.  So a
state handed to the step is donated: the caller keeps no earlier pool
(`GSFSignature.IN_PLACE` names the leaf; `core/harness.py` keeps the
stopped runs' rows).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import bitset, prng
from ..ops.flat import gather2d, gather_rows, set2d
from ..ops.gsf_merge import gsf_merge
from ..ops.score import gsf_score
from ._levels import LevelMixin, get_bit_rows, keyed_level_peer

TAG_BAD = 0x47424144      # bad-node choice
TAG_PERM = 0x47504552     # per-(node, level) peer-order permutation

I32 = torch.int32


@register_struct
@dataclasses.dataclass(frozen=True)
class GSFState(_Struct):
    """wittgenstein_tpu/models/gsf.py:64-84.  Bitset leaves are int32
    words."""

    seed: torch.Tensor
    pairing: torch.Tensor
    verified: torch.Tensor
    ver_indiv: torch.Tensor
    got_indiv: torch.Tensor
    remaining: torch.Tensor
    pos: torch.Tensor
    q_from: torch.Tensor
    q_lvl: torch.Tensor
    q_indiv: torch.Tensor
    q_sig: torch.Tensor
    pend_from: torch.Tensor
    pend_lvl: torch.Tensor
    pend_sig: torch.Tensor
    pend_at: torch.Tensor
    accel_pending: torch.Tensor
    pool: torch.Tensor
    sigs_checked: torch.Tensor
    evicted: torch.Tensor


@register
class GSFSignature(LevelMixin):
    """Parameters mirror wittgenstein_tpu/models/gsf.py:87-152 without
    the kernel switch `pallas_merge` (the port has one path: the kernels
    on CUDA tensors, their plain versions on CPU tensors); the port adds
    `device` (``cuda`` unless the caller asks for another)."""

    # Dests come from sibling-half level peer sets — never self.
    may_self_send = False
    #: protocol-state leaves the step writes in place (see the module
    #: docstring); a caller that keeps an earlier state keeps no copy
    #: of them
    IN_PLACE = ("pool",)

    def __init__(self, node_count=1024, threshold=None, pairing_time=3,
                 timeout_per_level_ms=50, period_duration_ms=10,
                 accelerated_calls_count=10, nodes_down=0,
                 node_builder_name=None, network_latency_name=None,
                 queue_cap=16, inbox_cap=16, horizon=512, device=None):
        if queue_cap + 2 * inbox_cap > 255:
            # The merge kernel's unique-key headroom (BIG0 + position).
            raise ValueError(
                f"GSFSignature supports queue_cap + 2*inbox_cap <= 255 "
                f"(got {queue_cap} + 2*{inbox_cap})")
        if node_count & (node_count - 1):
            raise ValueError("power-of-two node counts only (the reference "
                             "rounds to pow2, MoreMath.roundPow2)")
        threshold = (int(node_count * 0.99) if threshold is None
                     else threshold)
        if not (0 <= nodes_down < node_count and
                threshold + nodes_down <= node_count and
                threshold <= node_count):
            raise ValueError(f"nodeCount={node_count}, threshold={threshold},"
                             f" nodesDown={nodes_down} "
                             "(GSFSignature.java:70-75)")
        self.device = resolve_device(device)
        self.node_count = node_count
        self.threshold = threshold
        self.pairing_time = pairing_time
        self.timeout_per_level = timeout_per_level_ms
        self.period = period_duration_ms
        self.accel = accelerated_calls_count
        self.nodes_down = nodes_down
        self.queue_cap = queue_cap
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)

        self.bits = max(1, int(math.log2(node_count)))
        self.levels = self.bits + 1
        # The queue-merge key (tier*(L+1)+lvl)*C + pos must fit int32
        # (wittgenstein_tpu/models/gsf.py:137-143).
        _m = queue_cap + 2 * inbox_cap
        if (2 * (self.levels + 1) + self.levels) * _m + _m >= 2 ** 31:
            raise ValueError(
                "queue-merge sort key would overflow int32: reduce "
                f"queue_cap={queue_cap}/inbox_cap={inbox_cap}")
        self.w = bitset.n_words(node_count)
        self.rounds = horizon // max(1, period_duration_ms) + 2
        self.half = np.array([0] + [1 << (lv - 1)
                                    for lv in range(1, self.levels)],
                             np.int32)
        k = (self.levels - 1) + self.accel
        self.cfg = EngineConfig(n=node_count, horizon=horizon,
                                inbox_cap=inbox_cap, payload_words=3,
                                out_deg=k, bcast_slots=0)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)
        self._halfs = torch.tensor(self.half, device=self.device)
        self._lvl_idx = torch.arange(self.levels, dtype=I32,
                                     device=self.device)[None, :]

    # ------------------------------------------------------------ primitives

    def _peer_at(self, seed, ids, level, pos):
        """The `pos`-th peer of `ids` at `level` in its shuffled peer
        order (wittgenstein_tpu/models/gsf.py:156-160)."""
        return keyed_level_peer(seed, TAG_PERM, ids, level, pos)

    def _fin_level(self, pc):
        """Last finished level f: levels 1..f all complete
        (wittgenstein_tpu/models/gsf.py:162-168).  pc [N, L]."""
        halfs = self._halfs[None, :]
        comp = (pc >= halfs) | (halfs == 0)
        run = torch.cumprod(comp.to(I32), dim=1, dtype=I32)
        return run.sum(1, dtype=I32) - 1

    # ---------------------------------------------------------------- init

    def init(self, seed):
        """Build ``(NetState, GSFState)`` from a seed
        (wittgenstein_tpu/models/gsf.py:172-210)."""
        n, w, L, Q = self.node_count, self.w, self.levels, self.queue_cap
        dev = self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        ids = self._ids

        if self.nodes_down:
            pri = prng.uniform_u32(prng.hash2(seed, TAG_BAD), ids)
            down = torch.zeros(n, dtype=torch.bool, device=dev)
            down[torch.argsort(pri, stable=True)[:self.nodes_down]] = True
            nodes = nodes.replace(down=down)

        pairing = (self.pairing_time * nodes.speed_ratio).clamp_min(1).to(I32)

        def zi(fill=0):
            return torch.full((n,), fill, dtype=I32, device=dev)

        net = init_net(self.cfg, nodes, seed)
        pstate = GSFState(
            seed=seed.clone(), pairing=pairing,
            verified=bitset.one_bit(ids, w),
            ver_indiv=torch.zeros((n, w), dtype=I32, device=dev),
            got_indiv=torch.zeros((n, w), dtype=I32, device=dev),
            remaining=self._halfs[None, :].expand(n, L).clone(),
            pos=torch.zeros((n, L), dtype=I32, device=dev),
            q_from=torch.full((n, Q), -1, dtype=I32, device=dev),
            q_lvl=torch.zeros((n, Q), dtype=I32, device=dev),
            q_indiv=torch.zeros((n, Q), dtype=torch.bool, device=dev),
            q_sig=torch.zeros((n, Q, w), dtype=I32, device=dev),
            pend_from=zi(-1), pend_lvl=zi(),
            pend_sig=torch.zeros((n, w), dtype=I32, device=dev),
            pend_at=zi(), accel_pending=zi(),
            pool=torch.zeros((n, self.rounds, w), dtype=I32, device=dev),
            sigs_checked=zi(),
            evicted=torch.zeros((), dtype=I32, device=dev))
        return net, pstate

    # ---------------------------------------------------------------- step

    def step(self, p: GSFState, nodes, inbox, t: int):
        """One ms for every node (wittgenstein_tpu/models/gsf.py:214-225)."""
        subm = self._subword_masks()
        hi = self._ids >> 5
        p = self._receive(p, inbox)
        p, nodes = self._apply_pending(p, nodes, t, subm, hi)
        p = self._pick_verification(p, nodes, t)
        p, out = self._disseminate(p, nodes, t, subm, hi)
        return p, nodes, out

    # -- receive (onNewSig, :539-553)

    def _receive(self, p: GSFState, inbox):
        """wittgenstein_tpu/models/gsf.py:229-337: rebuild each message's
        set from the sender's snapshot pool, mark same-key duplicates and
        superseded queue entries, then merge (`gsf_merge`)."""
        n, L = self.node_count, self.levels
        s = inbox.src.shape[1]
        dev = inbox.src.device

        valid = inbox.valid
        src = inbox.src.clamp(0, n - 1)
        level = inbox.data[:, :, 0].clamp(0, L - 1)
        fin = inbox.data[:, :, 1].clamp(0, L - 1)
        rslot = inbox.data[:, :, 2].clamp(0, self.rounds - 1)

        sig_all = (gather_rows(p.pool, src, rslot) &
                   self._sender_block_mask(src, level)) | \
            self._block_mask_dyn(src, fin)

        same = src[:, :, None] == src[:, None, :]
        later = torch.triu(torch.ones(s, s, dtype=torch.bool, device=dev),
                           diagonal=1)[None]
        dup = (same & (level[:, :, None] == level[:, None, :]) &
               valid[:, None, :] & later).any(dim=2)
        agg_ok = valid & ~dup                # newest same-key message wins
        superseded = ((p.q_from[:, :, None] == src[:, None, :]) &
                      (p.q_lvl[:, :, None] == level[:, None, :]) &
                      (~p.q_indiv)[:, :, None] & agg_ok[:, None, :]).any(dim=2)
        ex_keep = (p.q_from >= 0) & ~superseded

        # Incoming individuals: once ever per sender; the first slot this
        # ms wins, and senders already in got_indiv are consumed.
        earlier = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev),
                             diagonal=-1)[None]
        dup_ind = (same & valid[:, None, :] & earlier).any(dim=2)
        ind_ok = valid & ~dup_ind & ~get_bit_rows(p.got_indiv, src)

        q_from, q_lvl, q_indiv, q_sig, got_add, kept_ex_agg = gsf_merge(
            p.q_from, p.q_lvl, p.q_indiv, ex_keep, p.q_sig, src, level,
            agg_ok, ind_ok, sig_all, L)
        evicted = p.evicted + ((ex_keep & ~p.q_indiv).sum(1, dtype=I32) -
                               kept_ex_agg).sum(dtype=I32)
        return p.replace(q_from=q_from, q_lvl=q_lvl, q_indiv=q_indiv,
                         q_sig=q_sig, got_indiv=p.got_indiv | got_add,
                         evicted=evicted)

    # -- apply a finished verification (updateVerifiedSignatures, :383-460)

    def _apply_pending(self, p: GSFState, nodes, t: int, subm, hi):
        """wittgenstein_tpu/models/gsf.py:341-423."""
        n, L = self.node_count, self.levels
        ids = self._ids
        halfs = self._halfs
        lvl_idx = self._lvl_idx
        due = (p.pend_from >= 0) & (p.pend_at <= t)

        lvl = p.pend_lvl
        sigs = p.pend_sig
        exp = halfs[lvl.long()]

        # Individual sig marking (:387-390).
        mark_ind = due & (bitset.popcount(sigs) == 1)
        ver_indiv = torch.where(mark_ind[:, None], p.ver_indiv | sigs,
                                p.ver_indiv)
        lmask = self._range_mask_dyn(ids, lvl)
        sigs = sigs | (ver_indiv & lmask)

        # Oversized set -> complete the consecutive levels it includes
        # (:395-417), then clamp to the level range.
        pc_v = self._level_pc(p.verified, subm, hi)
        oversized = due & (bitset.popcount(sigs) > exp)
        incl = [torch.ones(n, dtype=torch.bool, device=ids.device)]
        for lv in range(1, L):
            rm = self._range_mask_dyn(ids, torch.full_like(ids, lv))
            incl.append(bitset.includes(sigs & rm, rm))
        run = torch.cumprod(torch.stack(incl, dim=1).to(I32), dim=1,
                            dtype=I32)
        fin_in = run.sum(1, dtype=I32) - 1
        was_comp = pc_v >= halfs[None, :]
        newly = (run > 0) & ~was_comp & (lvl_idx >= 1) & oversized[:, None]
        reset_any = newly.any(1)
        comp_mask = self._block_mask_dyn(ids, torch.where(oversized, fin_in,
                                                          0))
        verified = torch.where(oversized[:, None], p.verified | comp_mask,
                               p.verified)
        sigs = torch.where(oversized[:, None], lmask, sigs)

        # Merge with the level's current set when disjoint (:419-425).
        ver_l = verified & lmask
        ver_l_card = bitset.popcount(ver_l)
        disjoint = ~bitset.intersects(sigs, ver_l) & (ver_l_card > 0)
        sigs = torch.where(disjoint[:, None], sigs | ver_l, sigs)

        # Improvement -> replace the level's set inside V (:427-436).
        improved = due & ((bitset.popcount(sigs & lmask) > ver_l_card) |
                          reset_any)
        verified = torch.where(improved[:, None], (verified & ~lmask) | sigs,
                               verified)

        # Reset remainingCalls for levels >= min(affected).  argmax of the
        # int32 cast takes the first True, as jnp.argmax does.
        first_new = newly.to(I32).argmax(1).to(I32)
        base_l = torch.where(reset_any, torch.minimum(lvl, first_new), lvl)
        reset_row = improved[:, None] & (lvl_idx >= base_l[:, None])
        remaining = torch.where(reset_row, halfs[None, :], p.remaining)

        # Accelerated calls (:438-451): queue levels (lvl+1 .. fin+1).
        accel_pending = p.accel_pending
        if self.accel > 0:
            fin_now = self._fin_level(self._level_pc(verified, subm, hi))
            cand = (improved[:, None] & (lvl_idx > lvl[:, None]) &
                    (lvl_idx <= (fin_now + 1).clamp_max(L - 1)[:, None]))
            bits_ = torch.where(cand, torch.ones_like(lvl_idx) << lvl_idx,
                                0).sum(1, dtype=I32)
            accel_pending = accel_pending | bits_

        # doneAt at threshold (:452-456).
        done_now = ((nodes.done_at == 0) & due &
                    (bitset.popcount(verified) >= self.threshold))
        nodes = nodes.replace(done_at=torch.where(
            done_now, max(t, 1), nodes.done_at).to(I32))

        p = p.replace(verified=verified, ver_indiv=ver_indiv,
                      remaining=remaining, accel_pending=accel_pending,
                      pend_from=torch.where(due, -1, p.pend_from))
        return p, nodes

    # -- checkSigs / evaluateSig (:482-580)

    def _pick_verification(self, p: GSFState, nodes, t: int):
        """wittgenstein_tpu/models/gsf.py:427-493; the per-entry scoring
        is `gsf_score`."""
        ids = self._ids
        due = (~nodes.down) & (p.pend_from < 0) & \
            ((t - 1) % p.pairing == 0) & (t >= 1)

        filled = p.q_from >= 0
        elvl = p.q_lvl
        exp = self._halfs[elvl.long()]
        ver_l_card, card_sig, inter, pc_wi, pc_wv, inter_ind = gsf_score(
            p.q_sig, elvl, ids, p.verified, p.ver_indiv)

        new_total = torch.where(ver_l_card == 0, card_sig,
                                torch.where(inter, pc_wi, pc_wv))
        added = torch.where(ver_l_card == 0, new_total,
                            new_total - ver_l_card)
        indiv_bonus = ((card_sig == 1) & ~inter_ind).to(I32)
        score = torch.where(
            added <= 0, indiv_bonus,
            torch.where(new_total == exp, 1_000_000 - elvl * 10,
                        100_000 - elvl * 100 + added))
        score = torch.where(ver_l_card >= exp, 0, score)
        score = torch.where(filled, score, -1)

        best = score.argmax(1).to(I32)                # first maximum
        best_score = gather2d(score, ids, best)
        do = due & (best_score > 0)

        vfrom = gather2d(p.q_from, ids, best)
        vlvl = gather2d(p.q_lvl, ids, best)
        vsig = gather_rows(p.q_sig, ids, best)

        # Curation: due nodes drop score-0 entries (:560-567) + the winner.
        q_from = torch.where(due[:, None] & (score == 0), -1, p.q_from)
        q_from = set2d(q_from, ids, best, -1, ok=do)

        return p.replace(
            q_from=q_from,
            pend_from=torch.where(do, vfrom, p.pend_from),
            pend_lvl=torch.where(do, vlvl, p.pend_lvl),
            pend_sig=torch.where(do[:, None], vsig, p.pend_sig),
            pend_at=torch.where(do, p.pairing + t, p.pend_at),
            sigs_checked=p.sigs_checked + do.to(I32))

    # -- doCycle + accelerated sends + outbox (:191-224, :438-451)

    def _disseminate(self, p: GSFState, nodes, t: int, subm, hi):
        """wittgenstein_tpu/models/gsf.py:497-583."""
        n, L = self.node_count, self.levels
        ids = self._ids
        dev = ids.device
        halfs = self._halfs[None, :]
        lvl_idx = self._lvl_idx
        active = ~nodes.down
        per_due = active if (t >= 1 and (t - 1) % self.period == 0) else \
            torch.zeros_like(active)

        pc = self._level_pc(p.verified, subm, hi)
        fin = self._fin_level(pc)
        # card(V & block_{l-1}) = 1 + sum_{l'<l} pc (own bit + lower ranges).
        cum_low = 1 + pc.cumsum(1, dtype=I32) - pc
        two_fin = (torch.ones_like(fin) << fin.clamp(0, 30))[:, None]
        to_send_card = torch.where(fin[:, None] <= lvl_idx - 1, cum_low,
                                   two_fin)

        # hasStarted (:283-303): timeout or a full set to send.
        started = ((lvl_idx * self.timeout_per_level <= t) |
                   (to_send_card >= halfs)) & (halfs > 0)
        send_l = per_due[:, None] & started & (p.remaining > 0)

        half_cols = halfs.clamp_min(1)
        peer = self._peer_at(p.seed, ids[:, None], lvl_idx.expand(n, L),
                             p.pos % half_cols)
        pos = torch.where(send_l, (p.pos + 1) % half_cols, p.pos)
        remaining = torch.where(send_l, p.remaining - 1, p.remaining)

        rslot = (t // self.period) % self.rounds
        dest, payload, sizes = [], [], []

        def column_block(d, lvl, sz):
            """One block of outbox columns: dests [N, k], payload (level,
            finished prefix, round slot) and sizes.  Built out of place:
            under vmap the blocks are batched and the outbox is made
            from them, never written into."""
            k = d.shape[1]
            dest.append(d)
            payload.append(torch.stack(
                [lvl.expand(n, k), fin[:, None].expand(n, k),
                 torch.full((n, k), rslot, dtype=I32, device=dev)], -1))
            sizes.append(sz.expand(n, k))

        # SendSigs size = 1 + expected/8 + 96 (:146-152).
        column_block(torch.where(send_l, peer, -1)[:, 1:], lvl_idx[:, 1:],
                     (1 + halfs // 8 + 96)[:, 1:])

        # Accelerated sends: drain the lowest queued level, `accel` peers
        # at once (getRemainingPeers(acceleratedCallsCount), :444-449).
        accel_pending = p.accel_pending
        if self.accel > 0:
            ac = self.accel
            # The lowest queued level, 31 - clz(lsb) in the JAX code: the
            # bits below a power of two, counted exactly.
            lsb = accel_pending & -accel_pending
            fl = torch.where(lsb > 0, bitset.popcount_words(lsb - 1), 0)
            fhalf = self._halfs[fl.long()].clamp_min(1)
            frem = gather2d(remaining, ids, fl)
            fpos = gather2d(pos, ids, fl)
            k_idx = torch.arange(ac, dtype=I32, device=dev)[None, :]
            fsend = (fl > 0) & active
            fok = fsend[:, None] & (k_idx < frem.clamp_max(ac)[:, None])
            fpeer = self._peer_at(p.seed, ids[:, None],
                                  fl[:, None].expand(n, ac),
                                  (fpos[:, None] + k_idx) % fhalf[:, None])
            column_block(torch.where(fok, fpeer, -1), fl[:, None],
                         (1 + fhalf // 8 + 96)[:, None])
            nsent = fok.sum(1, dtype=I32)
            pos = set2d(pos, ids, fl, (fpos + nsent) % fhalf, ok=fsend)
            remaining = set2d(remaining, ids, fl,
                              (frem - nsent).clamp_min(0), ok=fsend)
            accel_pending = torch.where(fsend, accel_pending & ~lsb,
                                        accel_pending)
        dest = torch.cat(dest, 1)

        # Snapshot pool: senders record their V row for this round slot,
        # after the sends (the JAX order), in place (`IN_PLACE`).
        wrote = (dest >= 0).any(1)
        slot = p.pool[:, rslot]
        slot.copy_(torch.where(wrote[:, None], p.verified, slot))

        out = empty_outbox(self.cfg, dev, slot0=0).replace(
            dest=dest, payload=torch.cat(payload, 1),
            size=torch.cat(sizes, 1))
        return p.replace(pos=pos, remaining=remaining,
                         accel_pending=accel_pending), out

    # ---------------------------------------------------------------- misc

    def done(self, pstate, nodes):
        """wittgenstein_tpu/models/gsf.py:587-588."""
        return (nodes.down | (nodes.done_at > 0)).all()


def cont_if_gsf(net, pstate):
    """newConfIf (GSFSignature.java:676-688): continue while any live
    node is below the threshold (wittgenstein_tpu/models/gsf.py:591-595)."""
    live = ~net.nodes.down
    return (live & (net.nodes.done_at == 0)).any()
