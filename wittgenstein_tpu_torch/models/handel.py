"""Handel — multi-signature aggregation for large Byzantine committees
(arXiv:1906.05132); the port of `wittgenstein_tpu/models/handel.py`.

The slice ports the exact mode the benchmark headline runs: stored
emission lists, the send-time snapshot pool, one q_sig piece
(``state_split == 1``) and no attack flags.  The design notes of the
JAX module hold unchanged: one [N, W] bitset row per node carries every
level, reception ranks are a keyed permutation, messages carry (level,
flags, round slot) and the receiver rebuilds the aggregate from the
sender's snapshot pool, and the per-level verification queues are one
bounded pool of Q entries per node.

Bitset rows are int32 words holding the JAX package's uint32 bits (see
`ops/bitset.py`).  The two per-ms kernels of the model are
`ops/merge.merge_queue` (the receive merge) and `ops/score.score_queue`
(the verification scoring); on CUDA tensors they launch the
hand-written kernels, on CPU tensors their plain versions.
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
from ..ops.flat import add2d, gather2d, gather_rows, set2d
from ..ops.merge import merge_queue
from ..ops.score import score_queue
from ._levels import (LevelMixin, StaticScheduleMixin, get_bit_rows, msb,
                      sibling_base)

TAG_RANK = 0x48524E4B     # reception-rank permutation keys
TAG_BAD = 0x48424144      # bad-node choice
TAG_START = 0x48535452    # desynchronized start draw
TAG_LEVEL = 0x484C564C    # random level pick in checkSigs

I32 = torch.int32
BIG = 1 << 30


@register_struct
@dataclasses.dataclass(frozen=True)
class HandelState(_Struct):
    """wittgenstein_tpu/models/handel.py:84-123.  Bitset leaves are int32
    words; q_sig is the single [N, Q, W] piece."""

    seed: torch.Tensor
    start_at: torch.Tensor
    pairing: torch.Tensor
    ver_ind: torch.Tensor
    last_agg: torch.Tensor
    finished_peers: torch.Tensor
    blacklist: torch.Tensor
    demoted: torch.Tensor
    q_from: torch.Tensor
    q_lvl: torch.Tensor
    q_rank: torch.Tensor
    q_bad: torch.Tensor
    q_sig: torch.Tensor
    pool: torch.Tensor
    emission: torch.Tensor
    pos: torch.Tensor
    curr_window: torch.Tensor
    added_cycle: torch.Tensor
    pend_from: torch.Tensor
    pend_level: torch.Tensor
    pend_bad: torch.Tensor
    pend_sig: torch.Tensor
    pend_at: torch.Tensor
    fast_pending: torch.Tensor
    sigs_checked: torch.Tensor
    msg_filtered: torch.Tensor
    evicted: torch.Tensor


def reference_default_params(node_count: int = 2048) -> dict:
    """The benchmark headline's Handel scenario (bench.py:369-440): 10%
    of nodes down, threshold 99% of the live ones, pairing 4 ms, level
    wait 50 ms, period 20 ms, fast path 10, horizon 256, inbox 12."""
    down = node_count // 10
    return dict(node_count=node_count,
                threshold=int(0.99 * (node_count - down)),
                nodes_down=down, pairing_time=4, level_wait_time=50,
                dissemination_period_ms=20, fast_path=10, horizon=256,
                inbox_cap=12)


def _later(what: str):
    return NotImplementedError(
        f"Handel {what} is not ported yet (ROADMAP.md, Handel items after "
        "the first slice)")


@register
class Handel(LevelMixin, StaticScheduleMixin):
    """Parameters mirror wittgenstein_tpu/models/handel.py:155-288; the
    port adds `device` (``cuda`` unless the caller asks for another)."""

    # Every unicast dest comes from a level peer set, the sibling half of
    # the node's 2^l-aligned block, which never holds the node itself, so
    # the latency model's floor licenses superstep windows beyond 2
    # (core/network.unicast_floor_ms; wittgenstein_tpu/models/handel.py:
    # 134-138).
    may_self_send = False

    def __init__(self, node_count=2048, threshold=None, pairing_time=3,
                 level_wait_time=50, extra_cycle=10,
                 dissemination_period_ms=10, fast_path=10, nodes_down=0,
                 node_builder_name=None, network_latency_name=None,
                 desynchronized_start=0, window_initial=16, window_min=1,
                 window_max=128, queue_cap=16, inbox_cap=16, horizon=512,
                 emission_lookahead=8, byzantine_suicide=False,
                 hidden_byzantine=False, emission_mode=None,
                 snapshot_pool=None, state_split=1, mode="exact",
                 device=None):
        if mode == "cardinal":
            raise _later("mode='cardinal'")
        if mode != "exact":
            raise ValueError(f"unknown Handel mode {mode!r}")
        if node_count & (node_count - 1):
            raise ValueError("we support only power-of-two node counts "
                             "(Handel.java:119-121)")
        if emission_mode is None:
            emission_mode = "stored" if node_count <= 32768 else "hashed"
        if emission_mode not in ("stored", "hashed"):
            raise ValueError(f"unknown emission_mode {emission_mode!r}")
        if emission_mode == "hashed":
            raise _later("emission_mode='hashed'")
        if snapshot_pool is None:
            snapshot_pool = node_count <= 32768
        if not snapshot_pool:
            raise _later("snapshot_pool=False")
        if state_split != 1:
            raise _later("state_split > 1")
        if byzantine_suicide or hidden_byzantine:
            raise _later("attack modes (byzantine_suicide, "
                         "hidden_byzantine)")
        if queue_cap + inbox_cap > 255:
            # The merge kernel's unique-key headroom (BIG0 + position).
            raise ValueError(f"Handel supports queue_cap + inbox_cap <= 255 "
                             f"(got {queue_cap} + {inbox_cap})")
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
        self.emission_lookahead = emission_lookahead
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        # int32 guards (wittgenstein_tpu/models/handel.py:257-275).
        if 2 * node_count * (queue_cap + inbox_cap + 1) >= 2 ** 31:
            raise ValueError(
                "queue-merge sort key would overflow int32: "
                f"2*{node_count}*({queue_cap}+{inbox_cap}+1) >= 2**31; "
                "reduce queue_cap/inbox_cap or node_count")
        _w = (node_count + 31) // 32
        if node_count * queue_cap * _w >= 2 ** 31:
            raise ValueError(
                f"verification-queue flat index would overflow int32: "
                f"{node_count}*{queue_cap}*{_w} >= 2**31 per q_sig piece; "
                "reduce queue_cap or raise state_split (SCALE.md tier 2)")
        self.bits = max(1, int(math.log2(node_count)))
        self.levels = self.bits + 1
        self.w = bitset.n_words(node_count)
        self.rounds = horizon // max(1, dissemination_period_ms) + 2
        self.half = np.array([0] + [1 << (lv - 1)
                                    for lv in range(1, self.levels)],
                             np.int32)
        k = (self.levels - 1) + fast_path
        self.cfg = EngineConfig(n=node_count, horizon=horizon,
                                inbox_cap=inbox_cap, payload_words=3,
                                out_deg=k, bcast_slots=0)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)
        self._halfs = torch.tensor(self.half, device=self.device)

    # ------------------------------------------------------------ primitives

    def _rank(self, seed, i_ids, s_ids):
        """Reception rank node i assigns to sender s
        (wittgenstein_tpu/models/handel.py:297-302)."""
        key = prng.hash3(seed, TAG_RANK, i_ids)
        return prng.bij_perm(key, s_ids, self.bits)

    # ---------------------------------------------------------------- init

    def init(self, seed):
        """Build ``(NetState, HandelState)`` from a seed
        (wittgenstein_tpu/models/handel.py:344-416)."""
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

        start_at = (prng.uniform_int(prng.hash2(seed, TAG_START), ids,
                                     self.desynchronized_start)
                    if self.desynchronized_start else
                    torch.zeros(n, dtype=I32, device=dev))
        pairing = (self.pairing_time * nodes.speed_ratio).clamp_min(1).to(I32)

        # Emission lists: per (node, level), the level's receivers sorted
        # by the rank THEY assign to us; level l at columns [2^(l-1), 2^l).
        emission = torch.zeros((n, n), dtype=I32, device=dev)
        for lv in range(1, L):
            half = 1 << (lv - 1)
            base = sibling_base(ids, half)
            recv = base[:, None] + torch.arange(half, dtype=I32,
                                                device=dev)[None, :]
            key = self._rank(seed, recv, ids[:, None].expand_as(recv))
            order = torch.argsort(key * n + (recv - base[:, None]), dim=1,
                                  stable=True)
            emission[:, half:2 * half] = torch.gather(recv, 1, order)

        def zero_bits():
            return torch.zeros((n, w), dtype=I32, device=dev)

        def zi(fill=0):
            return torch.full((n,), fill, dtype=I32, device=dev)

        net = init_net(self.cfg, nodes, seed)
        pstate = HandelState(
            seed=seed.clone(), start_at=start_at, pairing=pairing,
            ver_ind=bitset.one_bit(ids, w), last_agg=zero_bits(),
            finished_peers=zero_bits(), blacklist=zero_bits(),
            demoted=zero_bits(),
            q_from=torch.full((n, Q), -1, dtype=I32, device=dev),
            q_lvl=torch.zeros((n, Q), dtype=I32, device=dev),
            q_rank=torch.zeros((n, Q), dtype=I32, device=dev),
            q_bad=torch.zeros((n, Q), dtype=torch.bool, device=dev),
            q_sig=torch.zeros((n, Q, w), dtype=I32, device=dev),
            pool=torch.zeros((n, self.rounds, w), dtype=I32, device=dev),
            emission=emission,
            pos=torch.zeros((n, L), dtype=I32, device=dev),
            curr_window=zi(self.window_initial),
            added_cycle=zi(self.extra_cycle),
            pend_from=zi(-1), pend_level=zi(),
            pend_bad=torch.zeros(n, dtype=torch.bool, device=dev),
            pend_sig=zero_bits(), pend_at=zi(), fast_pending=zi(),
            sigs_checked=zi(), msg_filtered=zi(),
            evicted=torch.zeros((), dtype=I32, device=dev))
        return net, pstate

    # ---------------------------------------------------------------- step

    def step(self, p: HandelState, nodes, inbox, t: int, hints=None):
        """One ms for every node (wittgenstein_tpu/models/handel.py:
        420-435).  `hints` are `phase_hints` for this ms: a false
        ``verify`` skips applying and picking verifications, a false
        ``periodic`` the period's dissemination; on such a ms both are
        the identity they would have computed."""
        h = hints or {}
        ids = self._ids
        active = (~nodes.down) & (p.start_at + 1 <= t)
        subm = self._subword_masks()
        hi = ids >> 5
        p = self._receive(p, nodes, inbox, t)
        if h.get("verify", True):
            p, nodes = self._apply_pending(p, nodes, t, subm, hi)
            p = self._pick_verification(p, t, active, subm, hi)
        p, out = self._disseminate(p, nodes, t, active, subm, hi,
                                   periodic=h.get("periodic", True))
        return p, nodes, out

    # -- receive: queue incoming aggregates (onNewSig, Handel.java:753-786)

    def _receive(self, p: HandelState, nodes, inbox, t: int):
        """wittgenstein_tpu/models/handel.py:439-522 (one q_sig piece,
        snapshot pool)."""
        n, w, L = self.node_count, self.w, self.levels
        ids = self._ids
        done = nodes.done_at > 0

        valid = inbox.valid
        src = inbox.src.clamp(0, n - 1)
        level = inbox.data[:, :, 0].clamp(0, L - 1)
        flags = inbox.data[:, :, 1]
        rslot = inbox.data[:, :, 2].clamp(0, self.rounds - 1)

        blk = get_bit_rows(p.blacklist, src)
        ok = valid & ~done[:, None] & (p.start_at <= t)[:, None] & ~blk
        filtered = (valid & done[:, None]).sum(1, dtype=I32)
        fin = ok & ((flags & 1) != 0)
        rank_all = self._rank(p.seed, ids[:, None], src) + torch.where(
            get_bit_rows(p.demoted, src), n, 0).to(I32)

        # levelFinished -> finishedPeers; an OR over the inbox slots (a
        # sum would double duplicate senders' bits).
        fin_bits = torch.where(fin[..., None], bitset.one_bit(src, w), 0)
        fin_or = fin_bits[:, 0]
        for s in range(1, fin_bits.shape[1]):
            fin_or = fin_or | fin_bits[:, s]

        sig_all = gather_rows(p.pool, src, rslot) & \
            self._sender_block_mask(src, level)
        q_f, q_l, q_r, q_b, q_s, ev = merge_queue(
            p.q_from, p.q_lvl, p.q_rank, p.q_bad, p.q_sig, src, level,
            rank_all, ok, sig_all)
        return p.replace(q_from=q_f, q_lvl=q_l, q_rank=q_r, q_bad=q_b,
                         q_sig=q_s, finished_peers=p.finished_peers | fin_or,
                         msg_filtered=p.msg_filtered + filtered,
                         evicted=p.evicted + ev)

    # -- apply a finished verification (updateVerifiedSignatures, :686-750)

    def _apply_pending(self, p: HandelState, nodes, t: int, subm, hi):
        """wittgenstein_tpu/models/handel.py:526-591."""
        w, L = self.w, self.levels
        ids = self._ids
        due = (p.pend_from >= 0) & (p.pend_at <= t)

        vs_from, vs_level, vs_sig, vs_bad = (p.pend_from, p.pend_level,
                                             p.pend_sig, p.pend_bad)
        bad = due & vs_bad
        blacklist = torch.where(bad[:, None],
                                p.blacklist | bitset.one_bit(vs_from, w),
                                p.blacklist)
        ok = due & ~vs_bad

        lmask = self._range_mask_dyn(ids, vs_level)
        from_bit = bitset.one_bit(vs_from.clamp_min(0), w)
        ver_ind = torch.where(ok[:, None], p.ver_ind | from_bit, p.ver_ind)

        old_agg_l = p.last_agg & lmask
        ver_l = ver_ind & lmask
        improves = bitset.popcount(vs_sig | ver_l) > bitset.popcount(ver_l)
        inter = bitset.intersects(old_agg_l, vs_sig)
        new_agg_l = torch.where((improves & inter)[:, None], vs_sig,
                                torch.where(improves[:, None],
                                            old_agg_l | vs_sig, old_agg_l))
        last_agg = torch.where(ok[:, None],
                               (p.last_agg & ~lmask) | new_agg_l, p.last_agg)

        total_inc = last_agg | ver_ind
        inc_pc = self._level_pc(total_inc, subm, hi)
        halfs = self._halfs[None, :]
        vs_half = torch.where(
            vs_level > 0,
            torch.ones_like(vs_level) << (vs_level - 1).clamp(0, 30), 0)
        vs_inc = gather2d(inc_pc, ids, vs_level)
        just_completed = ok & (vs_inc >= vs_half) & (vs_half > 0)

        fast_pending = p.fast_pending
        if self.fast_path > 0:
            og_size = 1 + inc_pc.cumsum(1, dtype=I32) - inc_pc
            og_complete = og_size >= halfs
            lv = torch.arange(L, dtype=I32, device=ids.device)[None, :]
            cand = (og_complete & (lv > vs_level[:, None]) & (halfs > 0) &
                    just_completed[:, None])
            bits = torch.where(cand, torch.ones_like(lv) << lv, 0).sum(
                1, dtype=I32)
            fast_pending = fast_pending | bits

        total_card = bitset.popcount(total_inc)
        done_now = (nodes.done_at == 0) & ok & (total_card >= self.threshold)
        nodes = nodes.replace(done_at=torch.where(
            done_now, max(t, 1), nodes.done_at).to(I32))
        p = p.replace(blacklist=blacklist, ver_ind=ver_ind,
                      last_agg=last_agg, fast_pending=fast_pending,
                      pend_from=torch.where(due, -1, p.pend_from))
        return p, nodes

    # -- pick next signature to verify (checkSigs/bestToVerify, :566-630)

    def _pick_verification(self, p: HandelState, t: int, active, subm, hi):
        """wittgenstein_tpu/models/handel.py:595-806 (no attack modes)."""
        n, w, L = self.node_count, self.w, self.levels
        ids = self._ids
        dev = ids.device
        due = (active & (p.pend_from < 0) &
               ((t - (p.start_at + 1)) % p.pairing == 0))

        total_inc = p.last_agg | p.ver_ind
        inc_pc = self._level_pc(total_inc, subm, hi)
        agg_pc = self._level_pc(p.last_agg, subm, hi)

        rows = ids[:, None]
        filled = p.q_from >= 0
        elvl = p.q_lvl
        cur_size = gather2d(inc_pc, rows, elvl)
        blk = get_bit_rows(p.blacklist, p.q_from.clamp_min(0))

        s_inc, pc_sig, pc_sig_ver, inter_agg = score_queue(
            p.q_sig, elvl, ids, total_inc, p.ver_ind, p.last_agg)
        improving = filled & ~blk & (s_inc > cur_size)
        keep = improving | ~filled          # curation (:597-614)

        lv = torch.arange(L, dtype=I32, device=dev)
        lvl_eq = elvl[:, None, :] == lv[None, :, None]          # [N, L, Q]
        rank_b = torch.where(filled[:, None, :] & lvl_eq,
                             p.q_rank[:, None, :], BIG)
        win_lo = rank_b.amin(2)
        win_lo_e = gather2d(win_lo, rows, elvl)
        inside = improving & (p.q_rank <= win_lo_e + p.curr_window[:, None])

        agg_card_e = gather2d(agg_pc, rows, elvl)
        half_e = self._halfs[elvl.long()]
        sc_disj = agg_card_e + pc_sig
        sc_join = (pc_sig_ver - agg_card_e).clamp_min(0)
        score = torch.where(inter_agg, sc_join, sc_disj)
        score = torch.where(agg_card_e >= half_e, 0, score)
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

        # chooseBestFromLevels (:788-790): uniform random non-empty level.
        cnt = has_best.sum(1, dtype=I32)
        r = prng.uniform_int(prng.hash3(p.seed, TAG_LEVEL, t), ids,
                             cnt.clamp_min(1))
        csum = has_best.to(I32).cumsum(1, dtype=I32)
        pick_level = ((csum == r[:, None] + 1) & has_best).to(I32).argmax(
            1).to(I32)
        do = due & (cnt > 0)

        slot = gather2d(best_slot, ids, pick_level)
        vfrom = gather2d(p.q_from, ids, slot)
        vbad = gather2d(p.q_bad, ids, slot)
        vsig = gather_rows(p.q_sig, ids, slot)

        lsize = self._halfs[pick_level.long()].clamp_min(1)
        grown = torch.where(vbad, p.curr_window // 4, 2 * p.curr_window)
        new_win = grown.clamp(self.window_min, self.window_max)
        curr_window = torch.where(do, torch.minimum(new_win, lsize),
                                  p.curr_window)
        demoted = torch.where(
            do[:, None], p.demoted | bitset.one_bit(vfrom.clamp_min(0), w),
            p.demoted)
        q_from = torch.where(due[:, None] & ~keep, -1, p.q_from)
        q_from = set2d(q_from, ids, slot, -1, ok=do)
        return p.replace(
            q_from=q_from, curr_window=curr_window, demoted=demoted,
            pend_from=torch.where(do, vfrom, p.pend_from),
            pend_level=torch.where(do, pick_level, p.pend_level),
            pend_bad=torch.where(do, vbad, p.pend_bad),
            pend_sig=torch.where(do[:, None], vsig, p.pend_sig),
            pend_at=torch.where(do, p.pairing + t, p.pend_at),
            sigs_checked=p.sigs_checked + do.to(I32))

    # -- dissemination (doCycle, :331-343,:470-504) + outbox assembly

    def _disseminate(self, p: HandelState, nodes, t: int, active, subm, hi,
                     periodic=True):
        """wittgenstein_tpu/models/handel.py:810-952 (stored emission,
        snapshot pool).  A non-periodic ms (phase hint) can only fill the
        fast-path slots: its outbox is narrow, those columns alone, with
        their slot ids kept through `Outbox.slot0`.  The outbox is built
        out of place (column blocks concatenated), so the step runs under
        `torch.func.vmap`."""
        n, L = self.node_count, self.levels
        ids = self._ids
        dev = ids.device
        done = nodes.done_at > 0
        halfs = self._halfs[None, :]
        total_inc = p.last_agg | p.ver_ind
        bad_bits = p.finished_peers | p.blacklist
        rslot = (t // self.period) % self.rounds
        dest, payload, sizes = [], [], []

        def column_block(d, lvl, flag, sz):
            """One block of outbox columns: dests [N, k], payload (level,
            flag, round slot) and sizes."""
            k = d.shape[1]
            dest.append(d)
            payload.append(torch.stack(
                [lvl.expand(n, k), flag.expand(n, k),
                 torch.full((n, k), rslot, dtype=I32, device=dev)], -1))
            sizes.append(sz.expand(n, k))

        pos, added_cycle = p.pos, p.added_cycle
        if periodic:
            per_due = active & ((t - (p.start_at + 1)) % self.period == 0)
            send_ok = per_due & (~done | (p.added_cycle > 0))
            added_cycle = torch.where(per_due & done,
                                      (p.added_cycle - 1).clamp_min(0),
                                      p.added_cycle)

            inc_pc = self._level_pc(total_inc, subm, hi)
            og_size = 1 + inc_pc.cumsum(1, dtype=I32) - inc_pc
            og_complete = og_size >= halfs
            inc_complete = inc_pc >= halfs
            lvl_idx = torch.arange(L, dtype=I32, device=dev)[None, :]
            is_open = (((lvl_idx - 1) * self.level_wait_time <= t) |
                       og_complete) & (halfs > 0)

            fin_pc = self._level_pc(bad_bits, subm, hi)
            any_cand = (halfs - fin_pc) > 0

            # Round-robin pick: next non-finished peer in emission order,
            # looking ahead `look` entries from posInLevel.
            look = self.emission_lookahead
            ar_look = torch.arange(look, dtype=I32, device=dev)
            half_cols = halfs.clamp_min(1)
            offs = (p.pos[:, :, None] + ar_look[None, None, :]) % \
                half_cols[:, :, None]
            cols = (half_cols[:, :, None] + offs).clamp_max(n - 1)
            cand_ids = gather2d(p.emission, ids[:, None, None], cols)
            okc = ~get_bit_rows(bad_bits, cand_ids)              # [N, L, k]
            found = okc.any(2)
            first = okc.to(I32).argmax(2).to(I32)
            peer = torch.where(
                okc & (ar_look[None, None, :] == first[..., None]),
                cand_ids, -1).amax(2)

            send_l = send_ok[:, None] & is_open & any_cand & found
            adv = per_due[:, None] & is_open & any_cand
            pos = torch.where(
                adv, (p.pos + torch.where(found, first + 1, look))
                % half_cols, p.pos)
            column_block(torch.where(send_l, peer, -1)[:, 1:],
                         lvl_idx[:, 1:], inc_complete.to(I32)[:, 1:],
                         (1 + halfs // 8 + 192)[:, 1:])

        # Fast-path sends on level completion (:738-743), bypassing the
        # period gate: drain the lowest queued level's fast_path peers.
        fast_pending = p.fast_pending
        if self.fast_path > 0:
            fp = self.fast_path
            lsb = fast_pending & -fast_pending
            fl = torch.where(lsb > 0, msb(lsb.clamp_min(1)), 0)
            fhalf = self._halfs[fl.long()].clamp_min(1)
            fpos = gather2d(pos, ids, fl)
            foffs = (fpos[:, None] + torch.arange(
                fp, dtype=I32, device=dev)[None, :]) % fhalf[:, None]
            fcols = (fhalf[:, None] + foffs).clamp_max(n - 1)
            fids = gather2d(p.emission, ids[:, None], fcols)
            fok = ~get_bit_rows(bad_bits, fids)
            fsend = (fl > 0) & active & ~done
            column_block(torch.where(fsend[:, None] & fok, fids, -1),
                         fl[:, None], torch.zeros_like(fl)[:, None],
                         (1 + fhalf // 8 + 192)[:, None])
            pos = add2d(pos, ids, fl.clamp_min(1),
                        torch.where(fsend, fok.sum(1, dtype=I32), 0))
            fast_pending = torch.where(fsend, fast_pending & ~lsb,
                                       fast_pending)
            fast_pending = torch.where(done, 0, fast_pending)

        # slot0 clamped into [0, out_deg): with fast_path == 0 the narrow
        # non-periodic outbox is one always-empty column, whose slot id
        # must not collide with the next node's slot 0 (:944-948).
        slot0 = 0 if periodic else min(L - 1, self.cfg.out_deg - 1)
        out = empty_outbox(self.cfg, dev, k=sum(d.shape[1] for d in dest)
                           or 1, slot0=slot0)
        if dest:
            out = out.replace(dest=torch.cat(dest, 1),
                              payload=torch.cat(payload, 1),
                              size=torch.cat(sizes, 1))

        # Snapshot pool: every sender this ms records its total_inc.
        wrote = (out.dest >= 0).any(1)
        pool = p.pool.clone()
        pool[:, rslot] = torch.where(wrote[:, None], total_inc,
                                     p.pool[:, rslot])
        return p.replace(pos=pos, added_cycle=added_cycle, pool=pool,
                         fast_pending=fast_pending), out

    # ---------------------------------------------------------------- misc

    def done(self, pstate, nodes):
        """wittgenstein_tpu/models/handel.py:956-957."""
        return (nodes.down | (nodes.done_at > 0)).all()


def cont_if_handel(net, pstate):
    """Run while any live node is not done or still owes extra
    dissemination cycles (wittgenstein_tpu/models/handel.py:960-965)."""
    live = ~net.nodes.down
    return (live & ((net.nodes.done_at == 0) |
                    (pstate.added_cycle > 0))).any()
