"""Casper IMD — beacon-chain stage 1 — ported from
`wittgenstein_tpu/models/casper.py`.

8-s slots; one block producer a slot, round robin; attesters vote 4 s
into their slot, on their head; an attestation endorses its head's
ancestors within `cycle_length` slots; fork choice walks back to the
common ancestor and counts, on each branch, the attestations its
blocks include and those the node received, a coin or the block id
breaking ties; producers include every received attestation their
chain has not included yet.  Byzantine producer variants: delayed, SF
(skip the father), NS (skip if the father skipped) and WF (wait for the
father), the default.

Blocks live in the shared arena (`core/blockchain.py`); attestations in
their own table with an ancestor bitset each, so "attestation a
endorses block h" is one bit probe.  Every chain walk of the JAX step
is a walk by set (`blockchain.walk_while`): a fixed number of [N, A]
mask operations whatever the capacity.  The branch walks OR the
`included` rows of the blocks they visit; that OR is a product of 0/1
float matrices, [N, A] x [A, T], compared with 0 (counts up to A are
exact in float32).

The JAX step runs its heavy half (head reevaluation, attestations,
block building) under ``lax.cond(any_event, ...)``.  The heavy half is
the identity on a node with no event: every write is masked by the
node's own due flag (`tests/test_torch_casper.py` checks it).  So the
port runs each part only on the ticks where `t`, a Python int here, can
give it an event: reevaluation and attestations on the schedule's ticks
(2 of every 400 at the defaults), block building there and, for the WF
producer, whose build tick depends on the state, on the ticks where
`step_hint` (one host read a tick, outside the vmapped step) finds a
build scheduled or a block reaching it.  Under vmap each seed's due
flags mask its own rows, as the JAX cond's select does.  The receive
half, the identity on a node without messages, is left out on the
ticks where the hint finds no node holding one.

The uint32 bitsets of the JAX state are int32 words with the same bits
(`ops/bitset.py`); OR reductions over the inbox are `bitset.bits_of`,
the lowest set bit `bitset.lowest_bit`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import blockchain as bc
from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import bitset, prng
from ._levels import get_bit_rows
from .ethpow import _TickScaled

I32 = torch.int32
TAG_TIE = 0x43415350

HONEST_BP, BYZ_DELAY, BYZ_SF, BYZ_NS, BYZ_WF = 0, 1, 2, 3, 4
BYZ_KINDS = {None: BYZ_WF, "": BYZ_WF,
             "ByzBlockProducer": BYZ_DELAY, "ByzBlockProducerSF": BYZ_SF,
             "ByzBlockProducerNS": BYZ_NS, "ByzBlockProducerWF": BYZ_WF}

KIND_BLOCK, KIND_ATT = 0, 1


@register_struct
@dataclasses.dataclass(frozen=True)
class CasperState(_Struct):
    """wittgenstein_tpu/models/casper.py:60-84; the uint32 bitsets are
    int32 words with the same bits."""

    seed: torch.Tensor
    arena: bc.Arena
    included: torch.Tensor      # [A, Tw] attestations inside each block
    att_n: torch.Tensor         # int32 scalar: attestations allocated
    att_attester: torch.Tensor  # int32 [T]
    att_height: torch.Tensor    # int32 [T]: slot of the attestation
    att_head: torch.Tensor      # int32 [T]: head at attest time
    att_anc: torch.Tensor       # [T, Aw] blocks this attestation attests
    att_dropped: torch.Tensor   # int32 scalar
    recv_blk: torch.Tensor      # [N, Aw]
    recv_att: torch.Tensor      # [N, Tw]
    head: torch.Tensor          # int32 [N]
    reeval: torch.Tensor        # [N, Aw] blocksToReevaluate
    emit_at: torch.Tensor       # int32 [N] (-1 = none): pending sendAll
    emit_kind: torch.Tensor     # int32 [N]
    emit_id: torch.Tensor       # int32 [N]
    to_send: torch.Tensor       # int32 [N]: byz producer's next height
    wf_at: torch.Tensor         # int32 [N] (-1): WF scheduled build tick
    wf_father: torch.Tensor     # int32 [N]
    on_direct_father: torch.Tensor   # int32 [N]
    on_older_ancestor: torch.Tensor  # int32 [N]


@register
class CasperIMD:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    casper.py:87-147), plus `device` (``cuda`` unless the caller asks
    for another).  Node 0 is the observer; node 1 the byzantine
    producer; nodes 2..block_producers_count the honest producers; then
    the attesters."""

    SLOT_MS = 8000
    #: every message is a sendAll: the outbox's unicast dest is always -1
    #: (`core/network._no_unicast`)
    sends_unicast = False

    def __init__(self, cycle_length=4, random_on_ties=True,
                 block_producers_count=2, attesters_per_round=20,
                 block_construction_time=1000,
                 attestation_construction_time=1, byz_kind=None, byz_delay=0,
                 node_builder_name=None, network_latency_name=None,
                 tick_ms=20, block_capacity=512, att_capacity=4096,
                 reeval_picks=6, inbox_cap=4, bcast_slots=96, horizon=128,
                 device=None):
        if byz_kind not in BYZ_KINDS:
            raise ValueError(f"unknown byz producer {byz_kind!r}")
        if self.SLOT_MS % tick_ms or 4000 % tick_ms:
            raise ValueError("tick_ms must divide SLOT_DURATION and 4000")
        self.cycle = cycle_length
        self.random_on_ties = random_on_ties
        self.n_bp = block_producers_count
        self.att_per_round = attesters_per_round
        self.n_att = attesters_per_round * cycle_length
        self.node_count = 1 + self.n_bp + self.n_att
        self.t_block = max(1, block_construction_time // tick_ms)
        self.t_att = max(1, attestation_construction_time // tick_ms)
        self.byz_kind = BYZ_KINDS[byz_kind]
        self.byz_delay = byz_delay
        self.tick_ms = tick_ms
        self.slot = self.SLOT_MS // tick_ms          # ticks per slot
        self.capacity = block_capacity
        self.att_cap = att_capacity
        self.aw = bc.n_words(block_capacity)
        self.tw = bitset.n_words(att_capacity)
        self.reeval_picks = reeval_picks
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = _TickScaled(
            latency_mod.get_by_name(network_latency_name), tick_ms)
        self.cfg = EngineConfig(
            n=self.node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=2, out_deg=1, bcast_slots=bcast_slots)
        self.device = resolve_device(device)
        dev = self.device
        self._ids = torch.arange(self.node_count, dtype=I32, device=dev)
        self._blocks = torch.arange(block_capacity, dtype=I32, device=dev)
        self._att_idx = torch.arange(att_capacity, dtype=I32, device=dev)
        self._flag_cache = {}

    def __repr__(self):
        return (f"CasperIMD(nodes={self.node_count}, byz_kind="
                f"{self.byz_kind}, tick_ms={self.tick_ms})")

    def init(self, seed):
        """wittgenstein_tpu/models/casper.py:149-180."""
        n, a, t_cap, dev = (self.node_count, self.capacity, self.att_cap,
                            self.device)
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        nodes = nodes.replace(byzantine=(self._ids == 1) &
                              (self.byz_kind > 0))
        net = init_net(self.cfg, nodes, seed)

        def zeros(*shape):
            return torch.zeros(shape, dtype=I32, device=dev)

        def full(shape, v):
            return torch.full(shape, v, dtype=I32, device=dev)
        return net, CasperState(
            seed=seed, arena=bc.make_arena(a, device=dev),
            included=zeros(a, self.tw), att_n=zeros(),
            att_attester=full((t_cap,), -1), att_height=zeros(t_cap),
            att_head=zeros(t_cap), att_anc=zeros(t_cap, self.aw),
            att_dropped=zeros(),
            recv_blk=bitset.one_bit(zeros(n), self.aw),
            recv_att=zeros(n, self.tw), head=zeros(n),
            reeval=zeros(n, self.aw), emit_at=full((n,), -1),
            emit_kind=zeros(n), emit_id=zeros(n), to_send=full((n,), 1),
            wf_at=full((n,), -1), wf_father=zeros(n),
            on_direct_father=zeros(n), on_older_ancestor=zeros(n))

    # ------------------------------------------------------------ schedule

    def _due(self, t: int):
        """Host-side (numpy) due flags at tick t of the honest producers,
        the byzantine producer and the attesters
        (wittgenstein_tpu/models/casper.py:184-213)."""
        ids = np.arange(self.node_count)
        period = self.slot * self.n_bp
        phase = ids * self.slot                       # (pi + 1) * slot
        hon = (ids >= 2) & (ids <= self.n_bp) & (t >= phase) & \
            ((t - phase) % period == 0)
        bphase = max(self.slot + self.byz_delay // self.tick_ms, 1)
        if self.byz_kind == BYZ_WF:
            byz = (ids == 1) & (t == bphase)
        else:
            byz = (ids == 1) & (t >= bphase) & ((t - bphase) % period == 0)
        ai = ids - (1 + self.n_bp)
        aphase = (1 + ai % self.cycle) * self.slot + 4000 // self.tick_ms
        att = (ai >= 0) & (t >= aphase) & \
            ((t - aphase) % (self.slot * self.cycle) == 0)
        return hon, byz, att

    def _flags(self, flags):
        """A host-side flag array as a device tensor, one copy per
        distinct array (the schedule repeats, and a copy from pageable
        host memory would wait for the card)."""
        key = flags.tobytes()
        if key not in self._flag_cache:
            self._flag_cache[key] = torch.as_tensor(flags,
                                                    device=self.device)
        return self._flag_cache[key]

    # ----------------------------------------------------------- fork rule

    def _attests(self, p, h):
        """[N, T]: does attestation a endorse node i's candidate block h?
        One bit probe of the ancestor set
        (wittgenstein_tpu/models/casper.py:217-224)."""
        word = p.att_anc[:, (h // 32).long()].T              # [N, T]
        return (((word >> (h % 32)[:, None]) & 1) != 0) & \
            (self._att_idx < p.att_n)

    def _branch_walk(self, p, start, h_stop, inc_f, recv):
        """The branch start -> h_stop (exclusive; genesis stops it too)
        (wittgenstein_tpu/models/casper.py:226-267), as two [N, T] bool
        sets: the attestations its blocks include (`inc_f` is
        `included` unpacked, [A, T] floats) and the received ones
        (`recv`, [N, T]) whose head lies on it."""
        stop = (self._blocks == h_stop[:, None]) | (self._blocks == 0)
        _, above = bc.walk_while(p.arena, start, stop)
        inc = (above.to(torch.float32) @ inc_f) > 0
        head_on = torch.gather(above, 1, p.att_head.long()[None, :].expand(
            above.shape[0], self.att_cap))
        own = head_on & (self._att_idx < p.att_n) & recv
        return inc, own

    def _best(self, p, o1, o2, t, inc_f, recv):
        """Fork choice (wittgenstein_tpu/models/casper.py:280-305),
        vectorized over nodes; `_count`'s probe is the same for both
        branches (one common ancestor)."""
        arena = p.arena
        same = o1 == o2
        direct = bc.has_direct_link(arena, o1, o2)
        h1 = arena.height[o1.clamp_min(0).long()]
        h2 = arena.height[o2.clamp_min(0).long()]
        taller = torch.where(h1 >= h2, o1, o2)
        h = bc.common_ancestor(arena, o1, o2).clamp_min(0)
        i1, w1 = self._branch_walk(p, o1, h, inc_f, recv)
        i2, w2 = self._branch_walk(p, o2, h, inc_f, recv)
        probe = self._attests(p, h)
        v1 = (probe & (i1 | w1)).sum(1, dtype=I32)
        v2 = (probe & (i2 | w2)).sum(1, dtype=I32)
        if self.random_on_ties:
            coin = prng.bernoulli(prng.hash3(p.seed, TAG_TIE, t), self._ids,
                                  0.5)
            tie = torch.where(coin, o1, o2)
        else:
            tie = torch.where(o1 >= o2, o1, o2)
        voted = torch.where(v1 > v2, o1, torch.where(v2 > v1, o2, tie))
        return torch.where(same, o1, torch.where(direct, taller, voted))

    def _reevaluate(self, p, active, t, inc_f):
        """Fold `_best` over up to reeval_picks candidate blocks
        (wittgenstein_tpu/models/casper.py:307-328)."""
        head, reeval = p.head, p.reeval
        recv = bc.unpack(p.recv_att, self.att_cap)
        for _ in range(self.reeval_picks):
            live = torch.where(active[:, None], reeval, 0)
            nz = live != 0
            has = nz.any(1)
            fw = nz.to(I32).argmax(1).to(I32)
            word = torch.gather(live, 1, fw[:, None].long())[:, 0]
            cand = (fw * 32 + bitset.lowest_bit(word)).clamp(
                0, self.capacity - 1)
            new_head = self._best(p, head, cand, t, inc_f, recv)
            head = torch.where(has, new_head, head)
            reeval = torch.where(has[:, None],
                                 reeval & ~bitset.one_bit(cand, self.aw),
                                 reeval)
        return p.replace(head=head, reeval=reeval)

    # ---------------------------------------------------------------- step

    def _build_block(self, p, due, height, base, t, inc_f):
        """buildBlock (wittgenstein_tpu/models/casper.py:332-365): include
        every received attestation on the base branch (height below the
        new block's, within cycleLength) that no ancestor block already
        included.  `height` [N] is the slot height."""
        stop = bc.walk_to_height(p.arena, base,
                                 (height - self.cycle).clamp_min(0))
        recv = bc.unpack(p.recv_att, self.att_cap)
        inc, own = self._branch_walk(p, base, stop, inc_f, recv)
        h_ok = (p.att_height[None, :] < height[:, None]) & \
            (self._att_idx < p.att_n)
        new_bits = bitset.pack(own & ~inc & h_ok)

        arena, blk = bc.alloc(p.arena, due, base, self._ids, t,
                              height=height)
        # `.at[where(due, blk, A)].set(mode="drop")`: a due node whose
        # allocation was dropped (blk -1) writes row A - 1, as JAX
        # wraps a negative index
        row = torch.where(due, blk, self.capacity)
        row = torch.where(row < 0, row + self.capacity, row)
        included = bc._set_drop(p.included, row, new_bits)
        p = p.replace(arena=arena, included=included)
        recv_blk, _ = bc.receive_block(p.recv_blk, self._ids, blk, due)
        head = torch.where(due, blk.clamp_min(0), p.head)
        return p.replace(recv_blk=recv_blk, head=head), blk

    def step_hint(self, p: CasperState, inbox, t: int):
        """``(messages, wf)`` at t for one run or a batch, read from the
        device at once (`core/network.step_hint`): whether any node
        holds a message (else the receive half is the identity), and
        whether the WF producer's build can be due (a build scheduled at
        or before t, or a block reaching node 1, the only node that
        schedules one)."""
        msgs = inbox.valid.any()
        if self.byz_kind != BYZ_WF:
            return bool(msgs), False
        due = (p.wf_at[..., 1] >= 0) & (p.wf_at[..., 1] <= t)
        father = inbox.valid[..., 1, :] & \
            (inbox.data[..., 1, :, 0] == KIND_BLOCK)
        msgs, wf = torch.stack([msgs, (due.any() | father.any())]).tolist()
        return msgs, wf

    def step(self, p: CasperState, nodes, inbox, t: int, step_hint=None):
        """wittgenstein_tpu/models/casper.py:367-434, with the heavy half
        run on the ticks that can hold an event (module docstring); where
        `step_hint` says no node holds a message, the receive half (the
        identity then) is left out, and where it says the WF build
        cannot be due, so is that build."""
        ids = self._ids
        msgs, wf_may = (True, True) if step_hint is None else step_hint
        if msgs:
            p = self._receive(p, nodes, inbox, t)
        hon_np, byz_np, att_np = self._due(t)
        obs_tick = t % self.slot == 0 and t > 0
        scheduled = bool(hon_np.any() or byz_np.any() or att_np.any() or
                         obs_tick)
        alive = ~nodes.down
        if scheduled or (self.byz_kind == BYZ_WF and wf_may):
            hon_due = self._flags(hon_np) & alive
            byz_due = self._flags(byz_np) & alive
            att_due = self._flags(att_np) & alive
            wf_due = (p.wf_at >= 0) & (t >= p.wf_at) & alive
            obs_due = alive & (p.reeval != 0).any(1) & obs_tick
            p = self._events(p, hon_due, byz_due, att_due, wf_due, obs_due,
                             t, reevaluate=scheduled,
                             attest=bool(att_np.any()))

        # ---- pending emission (sendAll at +constructionTime) ----
        fire = (p.emit_at >= 0) & (t >= p.emit_at)
        out = empty_outbox(self.cfg, ids.device).replace(
            bcast=fire,
            bcast_payload=torch.stack([p.emit_kind, p.emit_id], 1).to(I32),
            bcast_size=torch.ones(self.node_count, dtype=I32,
                                  device=ids.device))
        p = p.replace(emit_at=torch.where(fire, -1, p.emit_at))
        return p, nodes, out

    def _receive(self, p, nodes, inbox, t):
        """The receive half (every message an idempotent OR, so the whole
        inbox at once), with the WF producer's father check."""
        ids = self._ids
        alive = ~nodes.down
        cap, tcap = self.capacity, self.att_cap

        ok = inbox.valid & alive[:, None]                     # [N, S]
        kind = inbox.data[:, :, 0]
        val = inbox.data[:, :, 1]
        is_blk = ok & (kind == KIND_BLOCK)
        bid = val.clamp(0, cap - 1)
        new_b = is_blk & ~get_bit_rows(p.recv_blk, bid)
        blk_or = bitset.bits_of(bid, new_b, cap)
        # blocksToReevaluate: the new blocks + our head
        add = blk_or | torch.where(new_b.any(1)[:, None],
                                   bitset.one_bit(p.head, self.aw), 0)
        is_att = ok & (kind == KIND_ATT)
        aid = val.clamp(0, tcap - 1)
        att_or = bitset.bits_of(aid, is_att, tcap)
        # reevaluate an attestation's head if we hold that block
        ahead = p.att_head[aid.long()]
        have = get_bit_rows(p.recv_blk, ahead) & is_att
        add = add | bitset.bits_of(ahead, have, cap)

        # WF: on receiving its father (height toSend - 1), schedule a
        # build at SLOT * toSend + delay, or now if late
        if self.byz_kind == BYZ_WF:
            bh = p.arena.height[bid.long()]
            father_in = new_b & (bh == p.to_send[:, None] - 1)
            hit = (father_in & (ids == 1)[:, None]).any(1)
            father = torch.where(father_in, bid, -1).max(1).values
            perfect = self.slot * p.to_send + self.byz_delay // self.tick_ms
            p = p.replace(
                wf_at=torch.where(hit, perfect.clamp_min(t), p.wf_at),
                wf_father=torch.where(hit, father, p.wf_father))

        return p.replace(recv_blk=p.recv_blk | blk_or,
                         recv_att=p.recv_att | att_or,
                         reeval=p.reeval | add)

    def _events(self, p, hon_due, byz_due, att_due, wf_due, obs_due, t,
                reevaluate=True, attest=True):
        """The heavy half (wittgenstein_tpu/models/casper.py:436-533).
        `reevaluate` and `attest` are False where every node's flag of
        that part is known to be off at t; the part is then the
        identity and is not run."""
        ids = self._ids
        tcap = self.att_cap
        inc_f = bc.unpack(p.included, tcap).to(torch.float32)   # [A, T]

        # reevaluateHead for every node acting this tick
        if reevaluate:
            acting = hon_due | byz_due | att_due | obs_due
            p = self._reevaluate(p, acting, t, inc_f)

        # ---- attesters vote on their head ----
        if attest:
            rank = att_due.to(I32).cumsum(0, dtype=I32) - 1
            aslot = p.att_n + rank
            a_ok = att_due & (aslot < tcap)
            aslot_w = torch.where(a_ok, aslot, tcap)
            # ancestors of head.parent within cycleLength, genesis
            # included when in range
            hw = p.head.clamp_min(0).long()
            par = p.arena.parent[hw]
            stop_h = (p.arena.height[hw] - self.cycle).clamp_min(0)
            anc = bitset.pack(bc.chain_mask(p.arena, par) &
                              (p.arena.height >= stop_h[:, None]))
            last = aslot.clamp_max(tcap - 1)
            p = p.replace(
                att_attester=bc._set_drop(p.att_attester, aslot_w, ids),
                att_height=bc._set_drop(
                    p.att_height, aslot_w,
                    torch.full_like(ids, t // self.slot)),
                att_head=bc._set_drop(p.att_head, aslot_w, p.head),
                att_anc=bc._set_drop(p.att_anc, aslot_w, anc),
                att_n=p.att_n + a_ok.sum(dtype=I32),
                att_dropped=p.att_dropped + (att_due & ~a_ok).sum(dtype=I32),
                recv_att=p.recv_att | torch.where(
                    a_ok[:, None], bitset.one_bit(last, self.tw), 0),
                emit_at=torch.where(a_ok, t + self.t_att, p.emit_at),
                emit_kind=torch.where(a_ok, KIND_ATT, p.emit_kind),
                emit_id=torch.where(a_ok, last, p.emit_id))

        # ---- byzantine producers ----
        byz_any = byz_due | wf_due
        arena = p.arena
        # reevaluateH: head walks down while height >= toSend
        keep = byz_any[:, None] & (arena.height >= p.to_send[:, None]) & \
            (self._blocks > 0)
        bhead, _ = bc.walk_while(arena, p.head, ~keep)
        hh = arena.height[bhead.clamp_min(0).long()]
        direct = hh == p.to_send - 1
        p = p.replace(
            on_direct_father=p.on_direct_father + (byz_any & direct).to(I32),
            on_older_ancestor=p.on_older_ancestor +
            (byz_any & ~direct).to(I32))
        bpar = arena.parent[bhead.clamp_min(0).long()]
        if self.byz_kind == BYZ_SF:
            bhead = torch.where(byz_any & direct & (bhead != 0), bpar, bhead)
        if self.byz_kind == BYZ_NS:
            gp_h = arena.height[bpar.clamp_min(0).long()]
            skip = byz_any & direct & (bhead != 0) & (gp_h == p.to_send - 3)
            bhead = torch.where(skip, bpar, bhead)
        if self.byz_kind == BYZ_WF:
            bhead = torch.where(wf_due, p.wf_father, bhead)

        # ---- build: honest producers on head at slot height ----
        bp_due = hon_due | byz_any
        base = torch.where(byz_any, bhead, p.head)
        heights = torch.where(byz_any, p.to_send, t // self.slot)
        p, blk = self._build_block(p, bp_due, heights, base, t, inc_f)
        return p.replace(
            to_send=torch.where(byz_any, p.to_send + self.n_bp, p.to_send),
            wf_at=torch.where(wf_due, -1, p.wf_at),
            emit_at=torch.where(bp_due, t + self.t_block, p.emit_at),
            emit_kind=torch.where(bp_due, KIND_BLOCK, p.emit_kind),
            emit_id=torch.where(bp_due, blk.clamp_min(0), p.emit_id))
