"""Dfinity consensus — block producers, attester committees and the
random beacon — ported from `wittgenstein_tpu/models/dfinity.py`.

Three roles (protocols/Dfinity.java): block producers propose when the
random beacon selects their round, attester committees vote on
proposals and broadcast the block at majority, and a beacon committee
exchanges signatures per height and broadcasts the beacon at majority;
each block a beacon node receives starts the next height's exchange,
paced by the round time.  Fork choice: the higher block wins, ties keep
the current head.  Votes and beacon exchanges accumulate as voter
bitsets ([N, A, Cw] and [N, A, Rw], int32 words holding the JAX
package's uint32 bits); majority is checked once per tick after the
whole inbox lands.  Unicasts go to the target height's committee, one
batch a tick; blocks and beacon results are broadcasts (160 slots).
The engine counts in 10-ms ticks (`_TickScaled`).

Where the JAX step OR-reduces one-hot words over the inbox axis
(``lax.reduce(..., bitwise_or, (1,))``) the port scatters the indices
into a bool row and packs it (`ops/bitset.bits_of`); where it adds
one-hot words into vote and exchange sets (``.at[].add``) the port adds
too (`scatter_add`, out of place, a masked-off slot adding 0), so a
repeated (index, bit) pair carries as in JAX; the lowest set bit of a queue word
(``31 - lax.clz(...)``) is `ops/bitset.lowest_bit`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import blockchain as bc
from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import masked_min, register
from ..core.state import (MAX_X, EngineConfig, _Struct, empty_outbox,
                          init_net, register_struct, resolve_device)
from ..ops import bitset, prng
from ..ops.flat import gather_rows, set_rows
from ._levels import get_bit_rows
from .ethpow import _TickScaled

I32 = torch.int32
ROUND_TIME_MS = 3000

K_PROPOSAL, K_VOTE, K_RB_EXCH, K_RB_RESULT, K_BLOCK = 0, 1, 2, 3, 4


def tracked_10k_params():
    """`tools/bench_suite.py`'s Dfinity line (`bench_dfinity`): 10 block
    producers and 10,000 attesters in rotating 100-attester committees,
    10,111 nodes."""
    return dict(block_producers_count=10, attesters_count=10_000,
                attesters_per_round=100, block_capacity=512)


@register_struct
@dataclasses.dataclass(frozen=True)
class DfinityState(_Struct):
    """wittgenstein_tpu/models/dfinity.py:49-74; the uint32 bitsets are
    int32 words with the same bits."""

    seed: torch.Tensor
    arena: bc.Arena
    recv_blk: torch.Tensor      # [N, Aw] bitset
    head: torch.Tensor          # int32 [N]
    last_beacon: torch.Tensor   # int32 [N]
    # attesters
    votes: torch.Tensor         # [N, A, Cw] committee-position voter sets
    vote_for_h: torch.Tensor    # int32 [N] (-1 = none)
    buffered: torch.Tensor      # [N, Aw] future proposals
    maj_height: torch.Tensor    # [N, Hw] committeeMajorityHeight
    # beacon nodes
    rb_height: torch.Tensor     # int32 [N]
    rb_last_sent: torch.Tensor  # int32 [N]
    exchanged: torch.Tensor     # [N, H, Rw] per-height exchange sets
    # outgoing queues
    q_vote: torch.Tensor        # [N, Aw] blocks to vote on
    q_prop: torch.Tensor        # int32 [N] (-1) proposal to send
    q_prop_at: torch.Tensor     # int32 [N]
    q_exch_h: torch.Tensor      # int32 [N] (-1) beacon exchange height
    q_exch_at: torch.Tensor     # int32 [N]
    q_bcast_blk: torch.Tensor   # [N, Aw] SendBlock broadcasts
    q_rb_h: torch.Tensor        # int32 [N] (-1) beacon result broadcast
    wait_for_h: torch.Tensor    # int32 [N] (-1) producer waiting for parent


@register
class Dfinity:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    dfinity.py:82-138), plus `device` (``cuda`` unless the caller asks
    for another).  Node layout: 0 = observer, then attesters, block
    producers, beacon nodes."""

    def __init__(self, block_producers_count=10, attesters_count=10,
                 attesters_per_round=10, block_construction_time=1,
                 attestation_construction_time=1,
                 percentage_dead_attester=0, node_builder_name=None,
                 network_latency_name=None, tick_ms=10, block_capacity=512,
                 inbox_cap=None, bcast_slots=160, horizon=64, device=None):
        self.n_bp = block_producers_count
        self.bp_per_round = 5
        self.bp_rounds = max(1, block_producers_count // self.bp_per_round)
        self.n_att = attesters_count
        self.att_per_round = attesters_per_round
        self.att_rounds = max(1, attesters_count // attesters_per_round)
        self.n_rb = attesters_per_round
        self.majority = attesters_per_round // 2 + 1
        self.t_block = max(1, block_construction_time // tick_ms)
        self.t_att = max(1, attestation_construction_time // tick_ms)
        self.dead_att_pct = percentage_dead_attester
        self.tick_ms = tick_ms
        self.round_ticks = ROUND_TIME_MS // tick_ms
        self.node_count = 1 + self.n_att + self.n_bp + self.n_rb
        self.capacity = block_capacity
        self.aw = bc.n_words(block_capacity)
        self.hw = bc.n_words(block_capacity)      # heights bounded by blocks
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = _TickScaled(
            latency_mod.get_by_name(network_latency_name), tick_ms)
        self.device = resolve_device(device)
        # Committee width: the largest residue class of attesters (the
        # fan-out masks overshoot ids); voter sets are committee-position
        # bitsets of that width (dfinity.py:109-132).
        self.att_width = -(-self.n_att // self.att_rounds)
        self.cw = bitset.n_words(self.att_width)
        self.rw = bitset.n_words(self.n_rb)
        k = max(self.att_width, self.n_rb)        # one fan-out batch per tick
        self.cfg = EngineConfig(
            n=self.node_count, horizon=horizon,
            inbox_cap=inbox_cap or (self.att_width + self.bp_per_round + 8),
            payload_words=2, out_deg=k, bcast_slots=bcast_slots)
        ids = np.arange(self.node_count)
        att = (ids >= 1) & (ids <= self.n_att)
        bp = (ids > self.n_att) & (ids <= self.n_att + self.n_bp)
        att_round = np.where(att, (ids - 1) % self.att_rounds, -1)
        bp_round = np.where(bp, (ids - 1 - self.n_att) % self.bp_rounds, -1)

        def dev(a):
            return torch.tensor(a, device=self.device)
        self._att, self._bp = dev(att), dev(bp)
        self._rb = dev(ids > self.n_att + self.n_bp)
        self._att_round = dev(att_round.astype(np.int32))
        self._bp_round = dev(bp_round.astype(np.int32))
        self._ids = dev(ids.astype(np.int32))

    def __repr__(self):
        return (f"Dfinity(block_producers_count={self.n_bp}, "
                f"attesters_count={self.n_att}, "
                f"attesters_per_round={self.att_per_round})")

    def init(self, seed):
        """wittgenstein_tpu/models/dfinity.py:157-192."""
        n, a, dev = self.node_count, self.capacity, self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        if self.dead_att_pct:
            pri = prng.uniform_u32(prng.hash2(seed, 0x44454144), self._ids)
            k = (self.n_att * self.dead_att_pct) // 100
            att_pri = torch.where(self._att, pri, 0xFFFFFFFF)
            dead = torch.zeros(n, dtype=torch.bool, device=dev)
            dead[torch.argsort(att_pri, stable=True)[:k]] = True
            nodes = nodes.replace(down=dead)
        net = init_net(self.cfg, nodes, seed)

        def zeros(*shape):
            return torch.zeros(shape, dtype=I32, device=dev)

        def full(v):
            return torch.full((n,), v, dtype=I32, device=dev)
        return net, DfinityState(
            seed=seed, arena=bc.make_arena(a, device=dev),
            recv_blk=bitset.one_bit(zeros(n), self.aw),
            head=zeros(n), last_beacon=zeros(n),
            votes=zeros(n, a, self.cw), vote_for_h=full(-1),
            buffered=zeros(n, self.aw), maj_height=zeros(n, self.hw),
            rb_height=full(1), rb_last_sent=zeros(n),
            exchanged=zeros(n, a, self.rw),
            q_vote=zeros(n, self.aw), q_prop=full(-1), q_prop_at=zeros(n),
            q_exch_h=full(-1), q_exch_at=zeros(n),
            q_bcast_blk=zeros(n, self.aw), q_rb_h=full(-1),
            wait_for_h=full(-1))

    # ------------------------------------------------------------ helpers

    def _on_beacon(self, p, h, okmask, t):
        """onRandomBeacon's once-per-height dispatch
        (wittgenstein_tpu/models/dfinity.py:203-243)."""
        att, bp, rb = self._att, self._bp, self._rb
        once = okmask & (p.last_beacon < h)
        p = p.replace(last_beacon=torch.where(once, h, p.last_beacon))
        rd = h                                      # rd value = height

        # producer: selected and parent in hand -> propose
        head_h = p.arena.height[p.head.clamp_min(0).long()]
        sel_bp = once & bp & (rd % self.bp_rounds == self._bp_round)
        now = sel_bp & (head_h == h - 1)
        p = p.replace(
            q_prop=torch.where(now, -2, p.q_prop),
            q_prop_at=torch.where(now, t + self.t_block, p.q_prop_at),
            wait_for_h=torch.where(sel_bp & ~now, h - 1, p.wait_for_h))

        # attester: start voting, vote the buffered proposals of h
        hbit_has = bitset.get_bit(p.maj_height, h.clamp(0, self.capacity - 1))
        sel_att = once & att & (rd % self.att_rounds == self._att_round) & \
            ~hbit_has
        p = p.replace(vote_for_h=torch.where(sel_att, h, p.vote_for_h))
        bmask = bitset.pack(p.arena.height[None, :] == h[:, None])
        p = p.replace(
            q_vote=torch.where(sel_att[:, None],
                               p.q_vote | (p.buffered & bmask), p.q_vote),
            buffered=torch.where(sel_att[:, None], 0, p.buffered))

        # beacon node fast-forward
        ff = once & rb & (h > p.rb_height)
        return p.replace(rb_height=torch.where(ff, h, p.rb_height),
                         rb_last_sent=torch.where(ff, p.rb_height,
                                                  p.rb_last_sent))

    def _committee_ids(self, hh):
        """Height hh's attester committee: the residue class ``(id - 1) %
        att_rounds == hh % att_rounds``, att_width wide, ids past n_att
        masked to -1 (wittgenstein_tpu/models/dfinity.py:436-446)."""
        pos = torch.arange(self.att_width, dtype=I32, device=hh.device)
        ids_c = 1 + (hh[:, None] % self.att_rounds) + pos[None, :] * \
            self.att_rounds
        return torch.where(ids_c <= self.n_att, ids_c, -1)

    # ---------------------------------------------------------------- step

    def step(self, p: DfinityState, nodes, inbox, t):
        """wittgenstein_tpu/models/dfinity.py:247-517."""
        n, cap = self.node_count, self.capacity
        ids = self._ids
        dev = ids.device
        alive = ~nodes.down
        att, bp, rb = self._att, self._bp, self._rb

        # init kick: beacon nodes broadcast height 1 at t == 1
        kick = alive & rb & (t == 1) & (p.rb_last_sent == 0)
        p = p.replace(q_rb_h=torch.where(kick, 1, p.q_rb_h),
                      rb_last_sent=torch.where(kick, 1, p.rb_last_sent))

        # ---- receive, vectorized over the S inbox slots ----
        ok = inbox.valid & alive[:, None]                     # [N, S]
        kind = inbox.data[:, :, 0]
        val = inbox.data[:, :, 1].clamp(0, cap - 1)
        src = inbox.src.clamp(0, n - 1)

        # -- BLOCK (onBlock for every role) --
        is_blk = ok & (kind == K_BLOCK)
        new_b = is_blk & ~get_bit_rows(p.recv_blk, val)
        recv_blk = p.recv_blk | bitset.bits_of(val, new_b, cap)
        bh_all = p.arena.height[val.long()]                   # [N, S]
        any_new = new_b.any(1)
        # head: highest received block this tick vs current (ties keep cur)
        cand_key = torch.where(new_b, bh_all, -1)
        cand_h = cand_key.max(1).values
        cand_slot = cand_key.argmax(1)
        cand = torch.gather(val, 1, cand_slot[:, None])[:, 0]
        head_h0 = p.arena.height[p.head.clamp_min(0).long()]
        take = (cand_h > head_h0) & any_new
        head = torch.where(take, cand, p.head)
        head_h = torch.where(take, cand_h, head_h0)
        # attester bookkeeping
        hbits = bitset.bits_of(bh_all.clamp(0, cap - 1),
                               new_b & att[:, None], cap)
        vote_cancel = (new_b & (bh_all == p.vote_for_h[:, None])).any(1) & att
        # producer waiting for its parent
        fire = bp & any_new & (head_h == p.wait_for_h)
        # beacon: catch rb_height up to the new head
        start = rb & any_new & (head_h >= p.rb_height)
        rb_height = torch.where(start, head_h + 1, p.rb_height)
        rb_idx = ids - (1 + self.n_att + self.n_bp)
        ownbit = bitset.one_bit(rb_idx.clamp_min(0), self.rw)
        hclip = rb_height.clamp(0, cap - 1)
        olde = gather_rows(p.exchanged, ids, hclip)
        exchanged = set_rows(p.exchanged, ids, hclip, olde | ownbit, ok=start)
        par = p.arena.parent[head.clamp_min(0).long()]
        wt = p.arena.time[par.clamp_min(0).long()] + 2 * self.round_ticks
        wt = torch.where(wt <= t, t + self.t_att, wt)
        p = p.replace(
            recv_blk=recv_blk, head=head,
            maj_height=p.maj_height | hbits,
            vote_for_h=torch.where(vote_cancel, -1, p.vote_for_h),
            q_prop=torch.where(fire, -2, p.q_prop),
            q_prop_at=torch.where(fire, t + self.t_block, p.q_prop_at),
            wait_for_h=torch.where(fire, -1, p.wait_for_h),
            rb_height=rb_height, exchanged=exchanged,
            q_exch_h=torch.where(start, rb_height, p.q_exch_h),
            q_exch_at=torch.where(start, wt, p.q_exch_at))

        # -- PROPOSAL --
        is_prop = ok & att[:, None] & (kind == K_PROPOSAL)
        live_vote = is_prop & (p.vote_for_h[:, None] == bh_all)
        own_pos = ((ids - 1) // self.att_rounds).clamp(0, self.att_width - 1)
        ownvote = bitset.one_bit(own_pos, self.cw)            # [N, Cw]
        # Own-vote bits are added, as the JAX package adds them.  A
        # masked-off slot adds 0 at its own (in-range) cell rather than
        # going to one dump cell, whose atomics would serialize.
        words = torch.arange(self.cw, dtype=I32, device=dev)
        vidx = (((ids[:, None] * cap + val) * self.cw)[..., None] +
                words).reshape(-1).long()
        vote_add = torch.zeros(n * cap * self.cw, dtype=I32,
                               device=dev).scatter_add(
            0, vidx, torch.where(live_vote[..., None], ownvote[:, None, :],
                                 0).reshape(-1))
        q_vote = p.q_vote | bitset.bits_of(val, live_vote, cap)
        buffered = p.buffered | bitset.bits_of(
            val, is_prop & ~live_vote & (bh_all > head_h[:, None]), cap)
        p = p.replace(q_vote=q_vote, buffered=buffered)

        # -- VOTE: sender committee-position bits, added --
        is_vote = (ok & att[:, None] & (kind == K_VOTE) &
                   (src >= 1) & (src <= self.n_att) &
                   ((src - 1) % self.att_rounds ==
                    bh_all % self.att_rounds))
        src_pos = ((src - 1) // self.att_rounds).clamp(0, self.att_width - 1)
        sbit_v = bitset.one_bit(src_pos, self.cw)             # [N, S, Cw]
        vote_add = vote_add.scatter_add(
            0, vidx, torch.where(is_vote[..., None], sbit_v, 0).reshape(-1))

        # -- RB exchange --
        is_ex = ok & rb[:, None] & (kind == K_RB_EXCH)
        fresh = is_ex & (val >= p.rb_height[:, None]) & \
            (val > p.rb_last_sent[:, None])
        rb_src = (src - (1 + self.n_att + self.n_bp)).clamp(0, self.n_rb - 1)
        ebit = bitset.one_bit(rb_src, self.rw)                # [N, S, Rw]
        rwords = torch.arange(self.rw, dtype=I32, device=dev)
        eidx = (((ids[:, None] * cap + val) * self.rw)[..., None] +
                rwords).reshape(-1).long()
        exch_add = torch.zeros(n * cap * self.rw, dtype=I32,
                               device=dev).scatter_add(
            0, eidx, torch.where(fresh[..., None], ebit, 0).reshape(-1))
        p = p.replace(exchanged=p.exchanged |
                      exch_add.reshape(p.exchanged.shape))

        # -- beacon result: once-per-height dispatch (highest wins) --
        beacon_h = torch.where(ok & (kind == K_RB_RESULT), val, -1).max(
            1).values
        p = self._on_beacon(p, beacon_h, beacon_h >= 0, t)

        # merge the tick's votes, then majority checks
        votes = p.votes | vote_add.reshape(p.votes.shape)
        p = p.replace(votes=votes)
        vh = p.vote_for_h
        counts = bitset.popcount(votes)                       # [N, A]
        h_eq = p.arena.height[None, :] == vh[:, None]
        maj = (counts >= self.majority) & h_eq & \
            (vh >= 0)[:, None] & att[:, None] & alive[:, None]
        any_maj = maj.any(1)
        maj_blk = maj.to(I32).argmax(1).to(I32)
        # sendBlock: broadcast, mark heights, stop voting
        p = p.replace(
            q_bcast_blk=p.q_bcast_blk | torch.where(
                any_maj[:, None], bitset.one_bit(maj_blk, self.aw), 0),
            maj_height=p.maj_height | torch.where(
                any_maj[:, None],
                bitset.one_bit(p.arena.height[maj_blk.long()].clamp(
                    0, cap - 1), self.hw), 0),
            vote_for_h=torch.where(any_maj, -1, p.vote_for_h))

        # beacon majority
        hclip = p.rb_height.clamp(0, cap - 1)
        exch_cnt = bitset.popcount(gather_rows(p.exchanged, ids, hclip))
        rb_maj = alive & rb & (exch_cnt >= self.majority) & \
            (p.rb_height > p.rb_last_sent)
        p = p.replace(
            q_rb_h=torch.where(rb_maj, p.rb_height, p.q_rb_h),
            rb_last_sent=torch.where(rb_maj, p.rb_height, p.rb_last_sent))

        # ---- producer proposal build (createProposal) ----
        build = (p.q_prop == -2) & (t >= p.q_prop_at) & alive
        arena, blk = bc.alloc(p.arena, build, p.head, ids, t)
        p = p.replace(arena=arena,
                      q_prop=torch.where(build, blk.clamp_min(0), p.q_prop))
        recv, _ = bc.receive_block(p.recv_blk, ids, blk, build)
        p = p.replace(recv_blk=recv)

        # ---- outbox ----
        k, a_w = self.cfg.out_deg, self.att_width

        def put(dest, payload, cols, mask, d, kind_v, val_v):
            """Columns [:cols] of the rows in `mask` get dests `d`, kind
            `kind_v` and value `val_v`; other rows keep theirs."""
            m = mask[:, None]
            dest = torch.cat([torch.where(m, d, dest[:, :cols]),
                              dest[:, cols:]], 1)
            pl = torch.stack([
                torch.where(m, kind_v, payload[:, :cols, 0]),
                torch.where(m, val_v, payload[:, :cols, 1])], -1)
            return dest, torch.cat([pl, payload[:, cols:]], 1)

        # proposal batch to the proposal height's committee (the JAX
        # step writes the proposal id into every row's value column)
        send_prop = (p.q_prop >= 0) & alive
        prop_h = p.arena.height[p.q_prop.clamp_min(0).long()]
        sp = send_prop[:, None]
        dest = torch.cat([
            torch.where(sp, self._committee_ids(prop_h), -1),
            torch.full((n, k - a_w), -1, dtype=I32, device=dev)], 1)
        payload = torch.cat([
            torch.stack([torch.where(sp, K_PROPOSAL, 0).to(I32).expand(
                n, a_w), p.q_prop[:, None].expand(n, a_w)], -1),
            torch.zeros((n, k - a_w, 2), dtype=I32, device=dev)], 1)
        p = p.replace(q_prop=torch.where(send_prop, -1, p.q_prop))

        # else: one vote batch per tick to the voted block's committee
        nz = p.q_vote != 0
        has_v = nz.any(1) & ~send_prop & alive
        fw = nz.to(I32).argmax(1).to(I32)
        word = torch.gather(p.q_vote, 1, fw[:, None].long())[:, 0]
        vblk = (fw * 32 + bitset.lowest_bit(word)).clamp(0, cap - 1)
        vote_h = p.arena.height[vblk.long()]
        dest, payload = put(dest, payload, a_w, has_v,
                            self._committee_ids(vote_h), K_VOTE,
                            vblk[:, None])
        p = p.replace(q_vote=torch.where(
            has_v[:, None], p.q_vote & ~bitset.one_bit(vblk, self.aw),
            p.q_vote))

        # beacon exchange batch to all beacon nodes
        send_ex = (p.q_exch_h >= 0) & (t >= p.q_exch_at) & alive
        rb_ids = 1 + self.n_att + self.n_bp + torch.arange(
            self.n_rb, dtype=I32, device=dev)
        dest, payload = put(dest, payload, self.n_rb, send_ex,
                            rb_ids[None, :], K_RB_EXCH, p.q_exch_h[:, None])
        p = p.replace(q_exch_h=torch.where(send_ex, -1, p.q_exch_h))

        # broadcasts: beacon result first, else one queued block
        nz2 = p.q_bcast_blk != 0
        has_blk = nz2.any(1)
        fw2 = nz2.to(I32).argmax(1).to(I32)
        word2 = torch.gather(p.q_bcast_blk, 1, fw2[:, None].long())[:, 0]
        bblk = (fw2 * 32 + bitset.lowest_bit(word2)).clamp(0, cap - 1)
        do_rb = (p.q_rb_h >= 0) & alive
        do_blk = has_blk & ~do_rb & alive
        bpayload = torch.stack(
            [torch.where(do_rb, K_RB_RESULT, K_BLOCK),
             torch.where(do_rb, p.q_rb_h, bblk)], 1).to(I32)
        p = p.replace(
            q_rb_h=torch.where(do_rb, -1, p.q_rb_h),
            q_bcast_blk=torch.where(
                do_blk[:, None],
                p.q_bcast_blk & ~bitset.one_bit(bblk, self.aw),
                p.q_bcast_blk))

        out = empty_outbox(self.cfg, dev).replace(
            dest=dest, payload=payload, bcast=do_rb | do_blk,
            bcast_payload=bpayload,
            bcast_size=torch.ones(n, dtype=I32, device=dev))
        return p, nodes, out

    def next_action_time(self, p: DfinityState, nodes, t):
        """Quiet-window oracle half (wittgenstein_tpu/models/dfinity.py:
        519-543): the t == 1 beacon kick, proposal builds maturing at
        ``q_prop_at``, beacon exchanges maturing at ``q_exch_at``, and
        queued sends, which drain one batch a tick; deliveries are the
        engine's terms."""
        alive = ~nodes.down
        kick = masked_min(1, alive & self._rb & (p.rb_last_sent == 0) &
                          (t <= 1))
        build = masked_min(p.q_prop_at.clamp_min(t),
                           alive & (p.q_prop == -2))
        exch = masked_min(p.q_exch_at.clamp_min(t),
                          alive & (p.q_exch_h >= 0))
        imm = alive & ((p.q_prop >= 0) | (p.q_vote != 0).any(1) |
                       (p.q_rb_h >= 0) | (p.q_bcast_blk != 0).any(1))
        queued = masked_min(t, imm)
        return torch.minimum(torch.minimum(kick, build),
                             torch.minimum(exch, queued))


def partition_by_x(net, ratio: float):
    """Network.partition: nodes left of ratio*MAX_X form partition 1
    (wittgenstein_tpu/models/dfinity.py:556-562)."""
    cut = int(ratio * MAX_X)
    part = (net.nodes.x <= cut).to(I32)
    return net.replace(nodes=net.nodes.replace(partition=part))


def heal_partition(net, pstate):
    """BlockChainNetwork.endPartition: clear partitions and have every
    node re-broadcast its head (wittgenstein_tpu/models/dfinity.py:
    565-573)."""
    net = net.replace(nodes=net.nodes.replace(
        partition=torch.zeros_like(net.nodes.partition)))
    aw = pstate.q_bcast_blk.shape[-1]
    return net, pstate.replace(
        q_bcast_blk=pstate.q_bcast_blk | bitset.one_bit(pstate.head, aw))
