"""Handel cardinal mode, the O(N*L)-state variant (SCALE.md tier 3); the
port of `wittgenstein_tpu/models/handel_cardinal.py`.

Handel's own accounting is per level, and a level's peer ranges are
disjoint by construction, so each (node, level) keeps only the count of
its best verified aggregate, ``lvl_best [N, L]``.  A level-l message
carries its sender's outgoing count ``1 + sum_{l' < l} lvl_best[l']``,
computed at send time into the payload (no snapshot pool); the
verification queue keeps ``q_cnt [N, Q]`` instead of sig rows; verifying
an aggregate of count c at level l replaces the level best when c beats
it.  What this gives up against exact mode (partial-overlap unions,
rank demotion, finishedPeers emission filtering) is listed in the JAX
module's docstring.  The attack modes keep an [N, W] blacklist, so they
run at small N; honest runs hold no O(N^2) state.

There is no kernel here: the queue merge is the plain
`_levels.merge_bounded_queue`, and everything else is elementwise or an
[N, L] / [N, Q] reduction.  The step runs under `torch.func.vmap` on a
seed batch with no per-seed fallback.
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
from ..ops.flat import gather2d, set2d
from ._levels import (LevelMixin, StaticScheduleMixin, byz_candidates,
                      get_bit_rows, keyed_level_peer, merge_bounded_queue,
                      msb)
from .handel import TAG_BAD, TAG_EMIT, TAG_LEVEL, TAG_RANK, TAG_START

I32 = torch.int32
BIG = 1 << 30


@register_struct
@dataclasses.dataclass(frozen=True)
class HandelCardinalState(_Struct):
    """wittgenstein_tpu/models/handel_cardinal.py:76-102.  `blacklist`
    is [N, W] int32 words under an attack flag, else [1, 1]; `byz_seen`
    [N, L] under hidden_byzantine, else [1, 1]."""

    seed: torch.Tensor
    start_at: torch.Tensor
    pairing: torch.Tensor
    lvl_best: torch.Tensor
    blacklist: torch.Tensor
    byz_seen: torch.Tensor
    q_from: torch.Tensor
    q_lvl: torch.Tensor
    q_rank: torch.Tensor
    q_cnt: torch.Tensor
    pos: torch.Tensor
    curr_window: torch.Tensor
    added_cycle: torch.Tensor
    pend_from: torch.Tensor
    pend_level: torch.Tensor
    pend_bad: torch.Tensor
    pend_cnt: torch.Tensor
    pend_at: torch.Tensor
    fast_pending: torch.Tensor
    sigs_checked: torch.Tensor
    msg_filtered: torch.Tensor
    evicted: torch.Tensor


@register
class HandelCardinal(LevelMixin, StaticScheduleMixin):
    """O(N*L)-state Handel; construct directly or through
    ``Handel(mode="cardinal")``.  Parameters mirror
    wittgenstein_tpu/models/handel_cardinal.py:116-176 (emission is
    always hashed, there is no snapshot pool); the port adds `device`
    (``cuda`` unless the caller asks for another)."""

    # Dests come from sibling-half level peer sets, never self
    # (core/network.unicast_floor_ms).
    may_self_send = False

    def __init__(self, node_count=2048, threshold=None, pairing_time=3,
                 level_wait_time=50, extra_cycle=10,
                 dissemination_period_ms=10, fast_path=10, nodes_down=0,
                 node_builder_name=None, network_latency_name=None,
                 desynchronized_start=0, window_initial=16, window_min=1,
                 window_max=128, queue_cap=16, inbox_cap=16, horizon=512,
                 byzantine_suicide=False, hidden_byzantine=False,
                 device=None):
        if node_count & (node_count - 1):
            raise ValueError("we support only power-of-two node counts "
                             "(Handel.java:119-121)")
        threshold = (int(node_count * 0.99) if threshold is None
                     else threshold)
        if not (0 <= nodes_down < node_count and
                threshold + nodes_down <= node_count):
            raise ValueError(f"nodeCount={node_count}, threshold={threshold},"
                             f" nodesDown={nodes_down} (Handel.java:113-118)")
        self.device = resolve_device(device)
        self.node_count = node_count
        self.threshold = threshold
        self.pairing_time = pairing_time
        self.level_wait_time = level_wait_time
        self.extra_cycle = extra_cycle
        self.period = dissemination_period_ms
        self.fast_path = fast_path
        self.nodes_down = nodes_down
        self.desynchronized_start = desynchronized_start
        self.window_initial = window_initial
        self.window_min = window_min
        self.window_max = window_max
        self.queue_cap = queue_cap
        if (byzantine_suicide or hidden_byzantine) and not nodes_down:
            raise ValueError("byzantine attacks need nodes_down > 0 "
                             "(the attacker controls the down nodes)")
        self.byzantine_suicide = byzantine_suicide
        self.hidden_byzantine = hidden_byzantine
        self.attacks = byzantine_suicide or hidden_byzantine
        if self.attacks and node_count > 131072:
            raise ValueError(
                "byzantine attack runs keep an [N, W] blacklist bitset "
                "(O(N^2)); run attacks at tier-1/2 node counts")
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        # Queue-merge sort key rank * (Q + S + 1) + pos, ranks < N (no
        # demotion in cardinal mode).
        s = inbox_cap + 1
        if node_count * (queue_cap + s + 1) >= 2 ** 31:
            raise ValueError(
                "queue-merge sort key would overflow int32: "
                f"{node_count}*({queue_cap}+{s}+1) >= 2**31; reduce "
                "queue_cap/inbox_cap")
        self.bits = max(1, int(math.log2(node_count)))
        self.levels = self.bits + 1
        self.w = bitset.n_words(node_count) if self.attacks else 1
        self.half = np.array([0] + [1 << (lv - 1)
                                    for lv in range(1, self.levels)],
                             np.int32)
        k = (self.levels - 1) + fast_path
        self.cfg = EngineConfig(n=node_count, horizon=horizon,
                                inbox_cap=inbox_cap, payload_words=2,
                                out_deg=k, bcast_slots=0)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)
        self._halfs = torch.tensor(self.half, device=self.device)

    # ------------------------------------------------------------ primitives

    def _rank(self, seed, i_ids, s_ids):
        """Reception rank node i assigns to sender s, no demotion
        (wittgenstein_tpu/models/handel_cardinal.py:180-184)."""
        key = prng.hash3(seed, TAG_RANK, i_ids)
        return prng.bij_perm(key, s_ids, self.bits)

    def _emission_peer(self, seed, i_ids, level, pos):
        """Hashed emission order, the only one here
        (wittgenstein_tpu/models/handel_cardinal.py:186-191)."""
        return keyed_level_peer(seed, TAG_EMIT, i_ids, level,
                                pos).clamp_max(self.node_count - 1)

    # ---------------------------------------------------------------- init

    def init(self, seed):
        """Build ``(NetState, HandelCardinalState)`` from a seed
        (wittgenstein_tpu/models/handel_cardinal.py:224-268)."""
        n, L, Q = self.node_count, self.levels, self.queue_cap
        dev = self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        ids = self._ids

        if self.nodes_down:
            pri = prng.uniform_u32(prng.hash2(seed, TAG_BAD), ids)
            down = torch.zeros(n, dtype=torch.bool, device=dev)
            down[torch.argsort(pri, stable=True)[:self.nodes_down]] = True
            nodes = nodes.replace(down=down)

        start_at = (prng.uniform_int(prng.hash2(seed, TAG_START), ids,
                                     self.desynchronized_start)
                    if self.desynchronized_start else
                    torch.zeros(n, dtype=I32, device=dev))
        pairing = (self.pairing_time * nodes.speed_ratio).clamp_min(1).to(I32)

        def zi(fill=0, shape=(n,)):
            return torch.full(shape, fill, dtype=I32, device=dev)

        net = init_net(self.cfg, nodes, seed)
        pstate = HandelCardinalState(
            seed=seed.clone(), start_at=start_at, pairing=pairing,
            lvl_best=zi(shape=(n, L)),
            blacklist=zi(shape=(n, self.w) if self.attacks else (1, 1)),
            byz_seen=zi(-1, (n, L) if self.hidden_byzantine else (1, 1)),
            q_from=zi(-1, (n, Q)), q_lvl=zi(shape=(n, Q)),
            q_rank=zi(shape=(n, Q)), q_cnt=zi(shape=(n, Q)),
            pos=zi(shape=(n, L)),
            curr_window=zi(self.window_initial),
            added_cycle=zi(self.extra_cycle),
            pend_from=zi(-1), pend_level=zi(),
            pend_bad=torch.zeros(n, dtype=torch.bool, device=dev),
            pend_cnt=zi(), pend_at=zi(), fast_pending=zi(),
            sigs_checked=zi(), msg_filtered=zi(),
            evicted=torch.zeros((), dtype=I32, device=dev))
        return net, pstate

    # ---------------------------------------------------------------- step

    def step(self, p: HandelCardinalState, nodes, inbox, t: int,
             hints=None):
        """One ms for every node
        (wittgenstein_tpu/models/handel_cardinal.py:272-281), with the
        phase hints of `models/handel.Handel.step`."""
        h = hints or {}
        active = (~nodes.down) & (p.start_at + 1 <= t)
        p = self._receive(p, nodes, inbox, t)
        if h.get("verify", True):
            p, nodes = self._apply_pending(p, nodes, t)
            p = self._pick_verification(p, nodes, t, active)
        p, out = self._disseminate(p, nodes, t, active,
                                   periodic=h.get("periodic", True))
        return p, nodes, out

    # -- receive: queue incoming counts (onNewSig, Handel.java:753-786)

    def _receive(self, p: HandelCardinalState, nodes, inbox, t: int):
        """wittgenstein_tpu/models/handel_cardinal.py:285-318."""
        n, L = self.node_count, self.levels
        ids = self._ids
        done = nodes.done_at > 0

        valid = inbox.valid
        src = inbox.src.clamp(0, n - 1)
        level = inbox.data[:, :, 0].clamp(0, L - 1)
        # The reference throws on size-overflowing aggregates
        # (HLevel.java:188-190); bounded shapes clip instead.
        cnt = torch.minimum(inbox.data[:, :, 1].clamp_min(0),
                            self._halfs[level.long()])

        ok = valid & ~done[:, None] & (p.start_at <= t)[:, None]
        if self.attacks:
            ok = ok & ~get_bit_rows(p.blacklist, src)
        filtered = (valid & done[:, None]).sum(1, dtype=I32)
        rank_all = self._rank(p.seed, ids[:, None], src)
        sel2, _, ev = merge_bounded_queue(
            p.q_from, p.q_lvl, p.q_rank, src, level, rank_all, ok,
            self.queue_cap, {"cnt": (p.q_cnt, cnt)}, {})
        return p.replace(q_from=sel2["from"], q_lvl=sel2["lvl"],
                         q_rank=sel2["rank"], q_cnt=sel2["cnt"],
                         msg_filtered=p.msg_filtered + filtered,
                         evicted=p.evicted + ev.sum(dtype=I32))

    # -- apply a finished verification (updateVerifiedSignatures, :686-750)

    def _apply_pending(self, p: HandelCardinalState, nodes, t: int):
        """wittgenstein_tpu/models/handel_cardinal.py:322-374."""
        L = self.levels
        ids = self._ids
        due = (p.pend_from >= 0) & (p.pend_at <= t)

        blacklist = p.blacklist
        if self.attacks:
            # Bad sig -> blacklist the sender (suicide attack, :690-699).
            blacklist = torch.where(
                (due & p.pend_bad)[:, None],
                p.blacklist | bitset.one_bit(p.pend_from.clamp_min(0),
                                             self.w), p.blacklist)
        ok = due & ~p.pend_bad

        # Best-count-wins replacement of the level aggregate.
        cur = gather2d(p.lvl_best, ids, p.pend_level)
        improves = ok & (p.pend_cnt > cur)
        lvl_best = set2d(p.lvl_best, ids, p.pend_level, p.pend_cnt,
                         ok=improves)

        halfs = self._halfs[None, :]
        vs_half = torch.where(
            p.pend_level > 0,
            torch.ones_like(p.pend_level) << (p.pend_level - 1).clamp(0, 30),
            0)
        just_completed = improves & (p.pend_cnt >= vs_half) & (vs_half > 0)

        fast_pending = p.fast_pending
        if self.fast_path > 0:
            og_size = 1 + lvl_best.cumsum(1, dtype=I32) - lvl_best
            lv = torch.arange(L, dtype=I32, device=ids.device)[None, :]
            cand = ((og_size >= halfs) & (lv > p.pend_level[:, None]) &
                    (halfs > 0) & just_completed[:, None])
            bits = torch.where(cand, torch.ones_like(lv) << lv, 0).sum(
                1, dtype=I32)
            fast_pending = fast_pending | bits

        # doneAt at threshold (:747-749); own signature is the +1.
        total_card = 1 + lvl_best.sum(1, dtype=I32)
        done_now = (nodes.done_at == 0) & ok & (total_card >= self.threshold)
        nodes = nodes.replace(done_at=torch.where(
            done_now, max(t, 1), nodes.done_at).to(I32))
        p = p.replace(blacklist=blacklist, lvl_best=lvl_best,
                      fast_pending=fast_pending,
                      pend_from=torch.where(due, -1, p.pend_from))
        return p, nodes

    # -- pick next signature to verify (checkSigs/bestToVerify, :566-630)

    def _pick_verification(self, p: HandelCardinalState, nodes, t: int,
                           active):
        """wittgenstein_tpu/models/handel_cardinal.py:378-526."""
        L = self.levels
        ids = self._ids
        dev = ids.device
        due = (active & (p.pend_from < 0) &
               ((t - (p.start_at + 1)) % p.pairing == 0))

        rows = ids[:, None]
        filled = p.q_from >= 0
        elvl = p.q_lvl
        cur = gather2d(p.lvl_best, rows, elvl)
        half_e = self._halfs[elvl.long()]

        # sizeIfIncluded (:545-552) under replace semantics.
        improving = filled & (p.q_cnt > cur)
        if self.attacks:
            improving = improving & ~get_bit_rows(p.blacklist,
                                                  p.q_from.clamp_min(0))
        keep = improving | ~filled          # curation (:597-614)

        lv = torch.arange(L, dtype=I32, device=dev)
        lvl_eq = elvl[:, None, :] == lv[None, :, None]          # [N, L, Q]
        rank_b = torch.where(filled[:, None, :] & lvl_eq,
                             p.q_rank[:, None, :], BIG)
        win_lo = rank_b.amin(2)
        win_lo_e = gather2d(win_lo, rows, elvl)
        inside = improving & (p.q_rank <= win_lo_e + p.curr_window[:, None])

        # score (:651-664): the count delta (cardinal aggregates always
        # interfere: same level range, replace-not-union).
        score = torch.where(cur >= half_e, 0, p.q_cnt - cur)
        score_in = torch.where(inside, score, -1)

        score_b = torch.where(lvl_eq, score_in[:, None, :], -1)
        in_slot = score_b.argmax(2)
        in_ok = score_b.amax(2) > 0
        out_rank_b = torch.where(lvl_eq & (improving & ~inside)[:, None, :],
                                 p.q_rank[:, None, :], BIG)
        out_slot = out_rank_b.argmin(2)
        out_ok = out_rank_b.amin(2) < BIG
        best_slot = torch.where(in_ok, in_slot, out_slot)        # [N, L]
        has_best = (in_ok | out_ok) & due[:, None]

        if self.byzantine_suicide:                      # :538-559, :577-583
            sbr, sbi = byz_candidates(self, p, nodes, p.blacklist)
            s_ok = ((win_lo < BIG) &
                    (sbr < win_lo + p.curr_window[:, None]))    # [N, L]
            has_best = has_best | (s_ok & due[:, None])

        # chooseBestFromLevels (:788-790): uniform random non-empty level.
        cnt_lv = has_best.sum(1, dtype=I32)
        r = prng.uniform_int(prng.hash3(p.seed, TAG_LEVEL, t), ids,
                             cnt_lv.clamp_min(1))
        csum = has_best.to(I32).cumsum(1, dtype=I32)
        pick_level = ((csum == r[:, None] + 1) & has_best).to(I32).argmax(
            1).to(I32)
        do = due & (cnt_lv > 0)

        slot = gather2d(best_slot, ids, pick_level)
        vfrom = gather2d(p.q_from, ids, slot)
        # Queue entries are never bad; only plants are.
        vbad = torch.zeros_like(do)
        vcnt = gather2d(p.q_cnt, ids, slot)
        keep_entry = torch.zeros_like(do)

        if self.byzantine_suicide:
            use_s = do & gather2d(s_ok, ids, pick_level)
            vfrom = torch.where(use_s, gather2d(sbi, ids, pick_level), vfrom)
            vbad = vbad | use_s
            vcnt = torch.where(use_s, 0, vcnt)
            keep_entry = keep_entry | use_s

        # HiddenByzantine (:840-917): the plant is a count-1 aggregate
        # scoring cur + 1; the `byz_seen` rank floor lets each byzantine
        # peer attack a (node, level) at most once.
        byz_seen = p.byz_seen
        if self.hidden_byzantine:
            hbr, hbi = byz_candidates(self, p, nodes, p.blacklist,
                                      min_rank=p.byz_seen)
            h_rank = gather2d(hbr, ids, pick_level)
            h_id = gather2d(hbi, ids, pick_level)
            honest = do & ~keep_entry
            queued = ((p.q_from == h_id[:, None]) &
                      (p.q_lvl == pick_level[:, None])).any(1)
            can = (honest & (h_id >= 0) & ~queued &
                   (h_rank < gather2d(p.q_rank, ids, slot)))    # :898-901
            h_score = gather2d(p.lvl_best, ids, pick_level) + 1
            s_picked = gather2d(score, ids, slot)
            was_in = gather2d(in_ok, ids, pick_level)
            h_win = can & (~was_in | (h_score > s_picked))
            vfrom = torch.where(h_win, h_id, vfrom)
            vbad = vbad & ~h_win
            vcnt = torch.where(h_win, 1, vcnt)
            keep_entry = keep_entry | h_win
            h_fail = can & ~h_win                               # :905-913
            byz_seen = set2d(byz_seen, ids, pick_level, h_rank, ok=can)

        lsize = self._halfs[pick_level.long()].clamp_min(1)
        grown = torch.where(vbad, p.curr_window // 4, 2 * p.curr_window)
        new_win = grown.clamp(self.window_min, self.window_max)
        curr_window = torch.where(do, torch.minimum(new_win, lsize),
                                  p.curr_window)

        # Curation sweep for due nodes + removal of the picked entry (no
        # rank demotion in cardinal mode).
        q_from = torch.where(due[:, None] & ~keep, -1, p.q_from)
        q_from = set2d(q_from, ids, slot, -1, ok=do & ~keep_entry)
        q_lvl, q_rank, q_cnt = p.q_lvl, p.q_rank, p.q_cnt

        if self.hidden_byzantine:
            # A failed attack leaves the plant queued (:905-913).
            free = q_from < 0
            any_free = free.any(1)
            worst = torch.where(free, -1, q_rank).argmax(1)
            worst_rank = gather2d(q_rank, ids, worst)
            islot = torch.where(any_free, free.to(I32).argmax(1), worst)
            ins = h_fail & (any_free | (h_rank < worst_rank))
            q_from = set2d(q_from, ids, islot, h_id, ok=ins)
            q_lvl = set2d(q_lvl, ids, islot, pick_level, ok=ins)
            q_rank = set2d(q_rank, ids, islot, h_rank, ok=ins)
            q_cnt = set2d(q_cnt, ids, islot, 1, ok=ins)

        return p.replace(
            q_from=q_from, q_lvl=q_lvl, q_rank=q_rank, q_cnt=q_cnt,
            curr_window=curr_window, byz_seen=byz_seen,
            pend_from=torch.where(do, vfrom, p.pend_from),
            pend_level=torch.where(do, pick_level, p.pend_level),
            pend_bad=torch.where(do, vbad, p.pend_bad),
            pend_cnt=torch.where(do, vcnt, p.pend_cnt),
            pend_at=torch.where(do, p.pairing + t, p.pend_at),
            sigs_checked=p.sigs_checked + do.to(I32))

    # -- dissemination (doCycle, :331-343,:470-504) + outbox assembly

    def _disseminate(self, p: HandelCardinalState, nodes, t: int, active,
                     periodic=True):
        """wittgenstein_tpu/models/handel_cardinal.py:530-645.  The
        2-word wire format is (level, count); a non-periodic ms (phase
        hint) fills only the fast-path slots, in a narrow outbox whose
        slot ids `Outbox.slot0` keeps.  Built out of place (column
        blocks concatenated), so the step runs under `torch.func.vmap`."""
        n, L = self.node_count, self.levels
        ids = self._ids
        dev = ids.device
        done = nodes.done_at > 0
        halfs = self._halfs[None, :]
        og_size = 1 + p.lvl_best.cumsum(1, dtype=I32) - p.lvl_best  # [N, L]
        dest, payload, sizes = [], [], []

        def column_block(d, lvl, cnt, sz):
            k = d.shape[1]
            dest.append(d)
            payload.append(torch.stack([lvl.expand(n, k), cnt.expand(n, k)],
                                       -1))
            sizes.append(sz.expand(n, k))

        pos, added_cycle = p.pos, p.added_cycle
        if periodic:
            per_due = active & ((t - (p.start_at + 1)) % self.period == 0)
            send_ok = per_due & (~done | (p.added_cycle > 0))
            added_cycle = torch.where(per_due & done,
                                      (p.added_cycle - 1).clamp_min(0),
                                      p.added_cycle)
            lvl_idx = torch.arange(L, dtype=I32, device=dev)[None, :]
            is_open = (((lvl_idx - 1) * self.level_wait_time <= t) |
                       (og_size >= halfs)) & (halfs > 0)
            # Round-robin through the keyed emission permutation, with no
            # finishedPeers/blacklist skip (O(N^2) bits, :470-504).
            peer = self._emission_peer(p.seed, ids[:, None], lvl_idx, p.pos)
            send_l = send_ok[:, None] & is_open
            adv = per_due[:, None] & is_open
            pos = torch.where(adv, (p.pos + 1) % halfs.clamp_min(1), p.pos)
            column_block(torch.where(send_l, peer, -1)[:, 1:],
                         lvl_idx[:, 1:], og_size[:, 1:],
                         (1 + halfs // 8 + 192)[:, 1:])

        fast_pending = p.fast_pending
        if self.fast_path > 0:
            fp = self.fast_path
            lsb = fast_pending & -fast_pending
            fl = torch.where(lsb > 0, msb(lsb.clamp_min(1)), 0)
            fhalf = self._halfs[fl.long()].clamp_min(1)
            fpos = gather2d(pos, ids, fl)
            foffs = (fpos[:, None] + torch.arange(
                fp, dtype=I32, device=dev)[None, :]) % fhalf[:, None]
            fids = self._emission_peer(p.seed, ids[:, None], fl[:, None],
                                       foffs)
            fsend = (fl > 0) & active & ~done
            column_block(torch.where(fsend[:, None], fids, -1),
                         fl[:, None], gather2d(og_size, ids, fl)[:, None],
                         (1 + fhalf // 8 + 192)[:, None])
            fl1 = fl.clamp_min(1)
            pos = set2d(pos, ids, fl1, (gather2d(pos, ids, fl1) + fp) %
                        fhalf, ok=fsend)
            fast_pending = torch.where(fsend, fast_pending & ~lsb,
                                       fast_pending)
            fast_pending = torch.where(done, 0, fast_pending)

        # slot0 clamped into [0, out_deg): see models/handel.py.
        slot0 = 0 if periodic else min(L - 1, self.cfg.out_deg - 1)
        out = empty_outbox(self.cfg, dev, k=sum(d.shape[1] for d in dest)
                           or 1, slot0=slot0)
        if dest:
            out = out.replace(dest=torch.cat(dest, 1),
                              payload=torch.cat(payload, 1),
                              size=torch.cat(sizes, 1))
        return p.replace(pos=pos, added_cycle=added_cycle,
                         fast_pending=fast_pending), out

    # ---------------------------------------------------------------- misc

    def done(self, pstate, nodes):
        """wittgenstein_tpu/models/handel_cardinal.py:649-650."""
        return (nodes.down | (nodes.done_at > 0)).all()
