"""Ethereum proof-of-work mining with honest and selfish miners — ported
from `wittgenstein_tpu/models/ethpow.py`.

Every miner runs a 10-ms mining tick: a Bernoulli draw with the
probability that its hash power solves the block's difficulty in 10 ms.
Blocks carry Constantinople difficulty and bomb, in 2^21-scaled int32
units, and up to two uncles picked from received sibling blocks; fork
choice is total difficulty, an exact int32 fixed-point pair.  Strategy
hooks implement the Eyal-Sirer selfish miner (SELFISH), its
total-difficulty variant (SELFISH2) and an agent-driven miner (AGENT,
`MinerAgentEnv`).  One engine tick is `tick_ms` simulated ms, latencies
ceil-scaled into ticks (`_TickScaled`).

The step leaves out, by `step_hint` (one host read a tick, outside the
vmapped step), what is the identity on every node: inbox slots past the
deepest node's messages, `_start_mining` where no miner needs a
candidate, `_mine` where no miner solves its block.

Every chain walk of the JAX step (`_depth`, `_release_chain`, the
selfish miners' walks toward the received height, `walk_to_height` in
the uncle test and the difficulty guard) is a walk by set
(`core/blockchain.walk_while`): a fixed number of [N, A] mask
operations, whatever the arena's capacity.

The mining threshold ``1 - exp(x)`` cancels, so it sits on a 2^-24 grid
and one ulp of the float32 ``exp`` moves it a whole step: PyTorch's
``exp`` differs from XLA's in a few percent of ETHPoW's inputs, and
``exp`` in float64 rounded to float32 in about 0.2%.  The port computes
XLA's own float32 ``exp`` (`exp_f32`: Cephes' polynomial with fused
multiply-adds, each emulated exactly in float64), on the CPU and on the
card alike, so ``thr`` is bit-identical too.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from ..core import blockchain as bc
from ..core import builders
from ..core import latency as latency_mod
from ..core.latency import latency_floor_ms
from ..core.protocol import FAR_FUTURE, register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import bitset, prng
from ..ops.fmath import exp_f32

I32 = torch.int32
TAG_MINE = 0x504F5731

HONEST, SELFISH, SELFISH2, AGENT = 0, 1, 2, 3
STRATEGIES = {"": HONEST, None: HONEST, "ETHMiner": HONEST,
              "ETHSelfishMiner": SELFISH, "ETHSelfishMiner2": SELFISH2,
              "ETHAgentMiner": AGENT, "ETHMinerAgent": AGENT}

GENESIS_HEIGHT = 7_951_081
GENESIS_DIFF_RAW = 1_949_482_043_446_410
DIFF_SHIFT = 21                             # raw difficulty / 2^21 -> int32
GENESIS_DIFF_S = int(round(GENESIS_DIFF_RAW / 2 ** DIFF_SHIFT))
TOTAL_HASH_POWER = 200 * 1024               # GH/s


def difficulty_s(fd_s, father_height, gap, father_has_uncles):
    """Constantinople difficulty and bomb in 2^DIFF_SHIFT-scaled int32
    units (wittgenstein_tpu/models/ethpow.py:69-95); the bomb period
    counts from the father's height."""
    y = torch.where(father_has_uncles, 2, 1)
    ugap = (y - gap).clamp_min(-99)
    diff = torch.div(fd_s, 2048, rounding_mode="floor") * ugap
    periods = torch.div(father_height - 4_999_999, 100_000,
                        rounding_mode="floor")
    shift = (periods - 2 - DIFF_SHIFT).clamp(0, 30)
    bomb = torch.where(periods > 1,
                       torch.where(periods - 2 >= DIFF_SHIFT,
                                   torch.ones_like(shift) << shift, 0),
                       diff)
    return (fd_s + diff + bomb).to(I32)


class _TickScaled:
    """Wraps a ms latency model: its output is ceil-divided into engine
    ticks (wittgenstein_tpu/models/ethpow.py:98-120)."""

    def __init__(self, inner, tick_ms):
        self.inner = inner
        self.tick_ms = tick_ms
        self.name = f"TickScaled({inner!r}, {tick_ms})"

    def validate(self, nodes):
        v = getattr(self.inner, "validate", None)
        if v is not None:
            v(nodes)

    def extended(self, nodes, src, dst, delta):
        ms = self.inner.extended(nodes, src, dst, delta)
        return -torch.div(-ms, self.tick_ms, rounding_mode="floor")

    def latency_floor_ms(self):
        # Ceil-scaling is monotone, so the wrapped floor ceil-divides
        # through (>= 1 either way).
        return max(1, -(-latency_floor_ms(self.inner) // self.tick_ms))

    def __repr__(self):
        return self.name


def _td_gt(p, a, b):
    """total_difficulty[a] > total_difficulty[b], exact
    (wittgenstein_tpu/models/ethpow.py:126-130)."""
    aw_, bw_ = a.clamp_min(0).long(), b.clamp_min(0).long()
    return ((p.td_hi[aw_] > p.td_hi[bw_]) |
            ((p.td_hi[aw_] == p.td_hi[bw_]) & (p.td_lo[aw_] > p.td_lo[bw_])))


def _td_eq(p, a, b):
    """wittgenstein_tpu/models/ethpow.py:133-135."""
    aw_, bw_ = a.clamp_min(0).long(), b.clamp_min(0).long()
    return (p.td_hi[aw_] == p.td_hi[bw_]) & (p.td_lo[aw_] == p.td_lo[bw_])


def solve_threshold(hash_power, diff_s):
    """solveIn10ms's probability in float32, ``1 - exp(x)``
    (wittgenstein_tpu/models/ethpow.py:363-365), with XLA's ``exp``
    (`exp_f32`)."""
    x = -(hash_power.to(torch.float32) * (1 << 9)) / \
        (100.0 * diff_s.to(torch.float32))
    return 1.0 - exp_f32(x)


@register_struct
@dataclasses.dataclass(frozen=True)
class PoWState(_Struct):
    """wittgenstein_tpu/models/ethpow.py:138-164; the uint32 bitsets are
    int32 words with the same bits."""

    seed: torch.Tensor
    arena: bc.Arena
    diff_s: torch.Tensor        # int32 [A] scaled block difficulty
    td_hi: torch.Tensor         # int32 [A] total difficulty above genesis:
    td_lo: torch.Tensor         # td_hi * 2^30 + td_lo, td_lo in [0, 2^30)
    u1: torch.Tensor            # int32 [A] uncle slots (-1 = none)
    u2: torch.Tensor
    received: torch.Tensor      # [N, Aw]
    head: torch.Tensor          # int32 [N]
    min_father: torch.Tensor    # int32 [N] (-1 = not mining)
    min_u1: torch.Tensor        # int32 [N]
    min_u2: torch.Tensor
    min_diff: torch.Tensor      # int32 [N] scaled difficulty of the candidate
    thr: torch.Tensor           # f32 [N] solveIn10ms probability
    mined_unsent: torch.Tensor  # [N, Aw] minedToSend
    release: torch.Tensor       # [N, Aw] queued sendAll broadcasts
    private_blk: torch.Tensor   # int32 [N] (-1 = none)
    mine_private: torch.Tensor  # bool [N]: mining base is the private chain
    others_head: torch.Tensor   # int32 [N]
    hash_power: torch.Tensor    # int32 [N] GH/s
    strategy: torch.Tensor      # int32 [N]


@register
class ETHPoW:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    ethpow.py:167-197), plus `device` (``cuda`` unless the caller asks
    for another).  Node 0 is the observer (no hash power); the
    byzantine miner is node 1."""

    #: every message is a sendAll: the outbox's unicast dest is always -1
    #: (`core/network._no_unicast`)
    sends_unicast = False

    def __init__(self, number_of_miners=10, byz_class_name=None,
                 byz_mining_ratio=0.0, node_builder_name=None,
                 network_latency_name=None, tick_ms=10, capacity=4096,
                 inbox_cap=2, bcast_slots=12, horizon=1024, device=None):
        if byz_class_name not in STRATEGIES:
            raise ValueError(f"unknown byzantine miner {byz_class_name!r}; "
                             f"known: {sorted(k for k in STRATEGIES if k)}")
        self.n_miners = number_of_miners
        self.node_count = number_of_miners
        self.byz_strategy = STRATEGIES[byz_class_name]
        self.has_byz = byz_class_name not in (None, "")
        self.byz_ratio = byz_mining_ratio if self.has_byz else 0.0
        self.tick_ms = tick_ms
        # whole bitset words (block masks pack [A] as [aw, 32])
        self.capacity = -(-capacity // 32) * 32
        self.aw = bc.n_words(self.capacity)
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = _TickScaled(
            latency_mod.get_by_name(network_latency_name), tick_ms)
        self.cfg = EngineConfig(
            n=self.node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=1, out_deg=1, bcast_slots=bcast_slots)
        self.device = resolve_device(device)
        self._ids = torch.arange(self.node_count, dtype=I32,
                                 device=self.device)
        self._blocks = torch.arange(self.capacity, dtype=I32,
                                    device=self.device)

    def __repr__(self):
        return (f"ETHPoW(number_of_miners={self.n_miners}, byz_strategy="
                f"{self.byz_strategy}, byz_mining_ratio={self.byz_ratio})")

    def init(self, seed):
        """wittgenstein_tpu/models/ethpow.py:199-238."""
        n, a, aw, dev = self.node_count, self.capacity, self.aw, self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        # hash power split; node 0 observes (0 GH/s)
        byz_hp = int(TOTAL_HASH_POWER * self.byz_ratio)
        honest_ct = max(1, (self.n_miners - 1) - (1 if byz_hp else 0))
        honest_hp = (TOTAL_HASH_POWER - byz_hp) // honest_ct
        hp = torch.full((n,), honest_hp, dtype=I32, device=dev)
        hp[0] = 0
        strategy = torch.zeros(n, dtype=I32, device=dev)
        if self.has_byz and n > 1:
            hp[1] = byz_hp
            strategy[1] = self.byz_strategy
        net = init_net(self.cfg, nodes, seed)

        def full(shape, v, dtype=I32):
            return torch.full(shape, v, dtype=dtype, device=dev)
        diff_s = full((a,), 0)
        diff_s[0] = GENESIS_DIFF_S
        return net, PoWState(
            seed=seed,
            arena=bc.make_arena(a, genesis_height=GENESIS_HEIGHT,
                                device=dev),
            diff_s=diff_s, td_hi=full((a,), 0), td_lo=full((a,), 0),
            u1=full((a,), -1), u2=full((a,), -1),
            received=bitset.one_bit(full((n,), 0), aw),
            head=full((n,), 0), min_father=full((n,), -1),
            min_u1=full((n,), -1), min_u2=full((n,), -1),
            min_diff=full((n,), 0), thr=full((n,), 0.0, torch.float32),
            mined_unsent=full((n, aw), 0), release=full((n, aw), 0),
            private_blk=full((n,), -1),
            mine_private=full((n,), False, torch.bool),
            others_head=full((n,), 0), hash_power=hp, strategy=strategy)

    # ------------------------------------------------------------ helpers

    def _best(self, p, cur, alt, me):
        """Fork choice by total difficulty
        (wittgenstein_tpu/models/ethpow.py:242-250): invalid loses;
        strict improvement wins; ties go to own blocks."""
        aw_ = alt.clamp_min(0).long()
        a_ok = (alt >= 0) & p.arena.valid[aw_]
        better = a_ok & (_td_gt(p, alt, cur) |
                         (_td_eq(p, alt, cur) &
                          (p.arena.producer[aw_] == me)))
        return torch.where(better, alt, cur)

    def _release_chain(self, p, top, me, unsent):
        """Queue `top` and its own unsent ancestors for broadcast
        (wittgenstein_tpu/models/ethpow.py:269-293); `unsent` is
        `mined_unsent` unpacked.  The walk steps while the block is the
        node's own and unsent, so the blocks it visits are the chain's
        above the first that is not."""
        own = (p.arena.producer == me[:, None]) & unsent
        _, seen = bc.walk_while(p.arena, top, ~own)
        bits = bitset.pack(seen)
        return p.mined_unsent & ~bits, p.release | bits

    def _possible_uncle_of(self, p, father, b):
        """isPossibleUncle against a block mined on `father`
        (wittgenstein_tpu/models/ethpow.py:295-304)."""
        h = p.arena.height
        hb = h[b.clamp_min(0).long()]
        hf = h[father.clamp_min(0).long()]
        in_range = (b >= 0) & (father >= 0) & (hb <= hf) & (hb >= hf - 6)
        anc = bc.walk_to_height(p.arena, father, hb)
        sib = p.arena.parent[anc.clamp_min(0).long()] == \
            p.arena.parent[b.clamp_min(0).long()]
        return in_range & sib & (anc != b)

    def _start_mining(self, p, need, t):
        """startNewMining (wittgenstein_tpu/models/ethpow.py:306-372):
        pick <= 2 uncles, compute difficulty and the 10-ms success
        probability."""
        a = self.capacity
        ids = self._ids
        arena = p.arena
        f = torch.where(p.mine_private & (p.private_blk >= 0), p.private_blk,
                        p.head)
        fw = f.clamp_min(0).long()
        hf = arena.height[fw]
        # ancestors anc[k] at height hf - k, k = 0..7, and their uncles
        anc = [f]
        for _ in range(7):
            anc.append(torch.where(anc[-1] >= 0,
                                   arena.parent[anc[-1].clamp_min(0).long()],
                                   -1))
        anc_arr = torch.stack(anc, 1)                         # [N, 8]
        aw_ = anc_arr.clamp_min(0).long()
        inc = torch.cat([anc_arr, p.u1[aw_], p.u2[aw_]], 1)   # [N, 24]
        # the blocks of `inc`, as an [N, A] mask (-1 goes to a dump column)
        in_inc = torch.zeros((self.node_count, a + 1), dtype=torch.bool,
                             device=ids.device).scatter(
            1, torch.where(inc >= 0, inc, a).long(), True)[:, :a]
        blocks = self._blocks[None, :]
        hb = arena.height[None, :]
        k = hf[:, None] - hb                                  # level index
        anc_at = torch.gather(anc_arr, 1, k.clamp(0, 7).long())
        sib = arena.parent[anc_at.clamp_min(0).long()] == arena.parent
        got = bc.unpack(p.received, a)
        cand = (got & arena.valid & (blocks < arena.n) & (blocks > 0) &
                (k >= 0) & (k <= 6) & sib & ~in_inc)
        # UncleCmp: own uncles first (higher first), then others lowest
        # height first
        mine = arena.producer[None, :] == ids[:, None]
        big = 1 << 24
        key = torch.where(mine, (1 << 20) - hb + hf[:, None],
                          (1 << 21) + hb - hf[:, None] + 7)
        key = torch.where(cand, key, big)
        u1 = key.argmin(1).to(I32)
        k1 = torch.gather(key, 1, u1[:, None].long())[:, 0]
        key2 = torch.where(blocks == u1[:, None], big, key)
        u2 = key2.argmin(1).to(I32)
        k2 = torch.gather(key2, 1, u2[:, None].long())[:, 0]
        u1 = torch.where(k1 < big, u1, -1)
        u2 = torch.where(k2 < big, u2, -1)

        fd = p.diff_s[fw]
        gap = torch.div((t - arena.time[fw]) * self.tick_ms, 9000,
                        rounding_mode="floor")
        all_d = difficulty_s(fd, hf, gap, p.u1[fw] >= 0)
        thr = solve_threshold(p.hash_power, all_d)
        return p.replace(
            min_father=torch.where(need, f, p.min_father),
            min_u1=torch.where(need, u1, p.min_u1),
            min_u2=torch.where(need, u2, p.min_u2),
            min_diff=torch.where(need, all_d, p.min_diff),
            thr=torch.where(need, thr, p.thr))

    # ---------------------------------------------------------------- step

    def _mine(self, p, miner, t):
        """The mining draw and, for the nodes that solve their block, its
        allocation, broadcast or keeping, and the selfish miner's publish
        (wittgenstein_tpu/models/ethpow.py:502-559)."""
        a, aw = self.capacity, self.aw
        ids = self._ids
        u = prng.uniform_float(prng.hash3(p.seed, TAG_MINE, t), ids)
        found = miner & (p.min_father >= 0) & (u < p.thr)

        arena, blk = bc.alloc(p.arena, found, p.min_father, ids, t)
        bw = blk.clamp_min(0)
        fw = p.min_father.clamp_min(0).long()
        # `.at[where(found, blk, A)].set(mode="drop")`, a negative index
        # wrapping as in JAX
        row = torch.where(found, blk, a)
        row = torch.where(row < 0, row + a, row)
        lo = p.td_lo[fw] + p.min_diff
        p = p.replace(
            arena=arena,
            diff_s=bc._set_drop(p.diff_s, row, p.min_diff),
            td_hi=bc._set_drop(p.td_hi, row, p.td_hi[fw] + (lo >> 30)),
            td_lo=bc._set_drop(p.td_lo, row, lo & ((1 << 30) - 1)),
            u1=bc._set_drop(p.u1, row, p.min_u1),
            u2=bc._set_drop(p.u2, row, p.min_u2))

        received, _ = bc.receive_block(p.received, ids, blk, found)
        head = self._best(p, p.head, torch.where(found, blk, -1), ids)
        p = p.replace(received=received, head=head,
                      min_father=torch.where(found, -1, p.min_father))

        # honest: send at +1 tick; selfish: keep
        hon_found = found & (p.strategy == HONEST)
        sel_found = found & (p.strategy > 0)
        bit = bitset.one_bit(bw, aw)
        p = p.replace(
            release=p.release | torch.where(hon_found[:, None], bit, 0),
            mined_unsent=p.mined_unsent | torch.where(sel_found[:, None],
                                                      bit, 0),
            private_blk=torch.where(sel_found, blk, p.private_blk),
            mine_private=p.mine_private | (sel_found &
                                           (p.strategy != AGENT)))

        # selfish onMinedBlock: at deltaP == 0 with two own blocks in a
        # row, publish the private chain
        h = p.arena.height
        priv_h = torch.where(p.private_blk >= 0,
                             h[p.private_blk.clamp_min(0).long()], 0)
        oth_h = h[p.others_head.clamp_min(0).long()]
        priv_chain = bc.chain_mask(p.arena, p.private_blk)
        mine = p.arena.producer == ids[:, None]
        _, run = bc.walk_while(p.arena, p.private_blk, ~mine, priv_chain)
        depth2 = run.sum(1, dtype=I32) == 2
        pub = sel_found & (p.strategy != AGENT) & \
            (priv_h - (oth_h - 1) == 0) & depth2
        mu, rel = self._release_chain(
            p, torch.where(pub, p.private_blk, -1), ids,
            bc.unpack(p.mined_unsent, a))
        oh = self._best(p, p.others_head,
                        torch.where(pub, p.private_blk, -1), ids)
        p = p.replace(mined_unsent=mu, release=rel, others_head=oh)

        return p

    def step_hint(self, p: PoWState, inbox, t: int):
        """``(depth, need, found)`` at t for one run or a batch, read from
        the device at once (`core/network.step_hint`): the most messages
        any node holds; whether any miner can need a new candidate (one
        has none, or a node receives a block, which can abort one); and
        whether any miner can solve its block (where nothing is received
        and no candidate restarts, the step's draw on this state)."""
        depth = inbox.valid.sum(-1).max()
        need = ((p.min_father < 0) & (p.hash_power > 0)).any()
        u = prng.uniform_float(prng.hash3(p.seed[..., None], TAG_MINE, t),
                               self._ids)
        found = ((p.hash_power > 0) & (p.min_father >= 0) &
                 (u < p.thr)).any()
        depth, need, found = torch.stack(
            [depth, need.to(depth.dtype), found.to(depth.dtype)]).tolist()
        need = bool(need or depth)
        return depth, need, bool(found) or need

    def step(self, p: PoWState, nodes, inbox, t: int, step_hint=None):
        """wittgenstein_tpu/models/ethpow.py:376-578.  The receive loop
        walks the inbox slot by slot, as JAX does; a node is unchanged
        by a slot that holds nothing for it, and one node's slot never
        touches another's state, so with `step_hint`'s depth (the most
        messages a node holds) it walks each node's messages, moved to
        the front in slot order, that many slots deep; where no miner
        can need a new candidate, `_start_mining` (the identity then) is
        left out, and where none can solve its block, `_mine`."""
        n, a, aw = self.node_count, self.capacity, self.aw
        ids = self._ids
        S = inbox.src.shape[1]
        alive = ~nodes.down
        h = p.arena.height
        par_w = p.arena.parent.clamp_min(0).long()
        valid, blocks = inbox.valid, inbox.data[:, :, 0]
        depth, need_any, found_any = ((S, True, True) if step_hint is None
                                      else step_hint)
        if depth < S:
            if depth:
                order = torch.argsort((~valid).to(I32), dim=1, stable=True)
                valid = torch.gather(valid, 1, order)
                blocks = torch.gather(blocks, 1, order)
            S = depth

        # ---- receive blocks (onBlock + strategy hooks) ----
        for s in range(S):
            ok = valid[:, s] & alive
            b = blocks[:, s].clamp(0, a - 1)
            received, new = bc.receive_block(p.received, ids, b, ok)
            p = p.replace(received=received)
            old_head = p.head
            head = self._best(p, p.head, torch.where(new, b, -1), ids)
            head_chg = new & (head != old_head)
            # switchMining: abort the candidate on a new head, or when
            # the block could improve our uncle set
            uncle_hit = new & (p.min_father >= 0) & \
                self._possible_uncle_of(p, p.min_father, b)
            p = p.replace(
                head=head,
                min_father=torch.where(head_chg | uncle_hit, -1,
                                       p.min_father))

            # onReceivedBlock, selfish strategies
            selfish = new & (p.strategy > 0)
            oh = self._best(p, p.others_head, torch.where(selfish, b, -1),
                            ids)
            oh_chg = selfish & (oh != p.others_head) & (oh == b)
            p = p.replace(others_head=oh)
            priv_h = torch.where(p.private_blk >= 0,
                                 h[p.private_blk.clamp_min(0).long()], 0)
            rcv_h = h[b.long()]
            delta_p = priv_h - (rcv_h - 1)
            they_won = oh_chg & (((p.strategy == SELFISH) & (delta_p <= 0)) |
                                 ((p.strategy == SELFISH2) & (p.head == b)))
            # release everything (sendAllMined) and mine on their head
            unsent = bc.unpack(p.mined_unsent, a)
            mu, rel = self._release_chain(
                p, torch.where(they_won, p.private_blk, -1), ids, unsent)
            p = p.replace(mined_unsent=mu, release=rel,
                          mine_private=p.mine_private & ~they_won,
                          min_father=torch.where(they_won, -1,
                                                 p.min_father))

            ahead = oh_chg & ~they_won
            unsent = bc.unpack(p.mined_unsent, a)
            priv_chain = bc.chain_mask(p.arena, p.private_blk)
            # SELFISH far ahead: walk down toward the received height
            # while the parent is still unsent
            top = p.private_blk
            walk_go = ahead & (p.strategy == SELFISH) & (delta_p > 2)
            par_unsent = unsent[:, par_w]                     # [N, A]
            step_ok = walk_go[:, None] & par_unsent & (h > rcv_h[:, None])
            top_w, _ = bc.walk_while(p.arena, top, ~step_ok, priv_chain)
            top = torch.where(walk_go, top_w, top)
            # difficulty guard when heights still differ
            at_rcv = bc.walk_to_height(p.arena, top, rcv_h)
            guard_fail = (p.strategy == SELFISH) & (delta_p > 2) & \
                (h[top.clamp_min(0).long()] != rcv_h) & _td_gt(p, b, at_rcv)
            # SELFISH2: walk while the parent strictly beats rcv
            w2_go = ahead & (p.strategy == SELFISH2)
            bw_ = b.long()
            par_gt = (p.td_hi[par_w][None, :] > p.td_hi[bw_][:, None]) | (
                (p.td_hi[par_w][None, :] == p.td_hi[bw_][:, None]) &
                (p.td_lo[par_w][None, :] > p.td_lo[bw_][:, None]))
            step2 = w2_go[:, None] & (p.arena.parent >= 0) & \
                (h >= rcv_h[:, None]) & par_gt
            top2, _ = bc.walk_while(p.arena, p.private_blk, ~step2,
                                    priv_chain)
            top = torch.where(w2_go, top2, top)

            do_rel = ahead & ~guard_fail & (p.strategy != AGENT)
            mu, rel = self._release_chain(
                p, torch.where(do_rel, top, -1), ids, unsent)
            oh2 = self._best(p, p.others_head,
                             torch.where(do_rel, top, -1), ids)
            p = p.replace(mined_unsent=mu, release=rel, others_head=oh2)

            # AGENT: private blocks at or below the others' head can no
            # longer win; publish them (node 1 only, built out of place)
            if self.byz_strategy == AGENT:
                agent_rcv1 = new[1] & (p.strategy[1] == AGENT)
                oth_h2 = h[p.others_head[1].clamp_min(0).long()]
                over = bitset.pack(h <= oth_h2)
                over_bits = torch.where(agent_rcv1, p.mined_unsent[1] & over,
                                        0)
                row1 = (ids == 1)[:, None]
                p = p.replace(
                    mined_unsent=torch.where(row1, p.mined_unsent &
                                             ~over_bits, p.mined_unsent),
                    release=torch.where(row1, p.release | over_bits,
                                        p.release))

        # ---- mining tick (mine10ms) ----
        miner = alive & (p.hash_power > 0)
        if need_any:
            p = self._start_mining(p, miner & (p.min_father < 0), t)
        if found_any:
            p = self._mine(p, miner, t)

        # ---- drain one queued broadcast per node per tick ----
        nz = p.release != 0
        rel_any = nz.any(1)
        first_word = nz.to(I32).argmax(1).to(I32)
        word = torch.gather(p.release, 1, first_word[:, None].long())[:, 0]
        send_blk = (first_word * 32 + bitset.lowest_bit(word)).clamp(0, a - 1)
        p = p.replace(release=torch.where(
            rel_any[:, None], p.release & ~bitset.one_bit(send_blk, aw),
            p.release))

        out = empty_outbox(self.cfg, ids.device).replace(
            bcast=rel_any, bcast_payload=send_blk[:, None].to(I32),
            bcast_size=torch.ones(n, dtype=I32, device=ids.device))
        return p, nodes, out

    def next_action_time(self, p: PoWState, nodes, t):
        """Quiet-window oracle half (wittgenstein_tpu/models/ethpow.py:
        580-593): a live miner draws every tick, so it pins every tick;
        queued broadcasts drain one a tick."""
        mining = ((~nodes.down) & (p.hash_power > 0)).any()
        queued = (p.release != 0).any()
        return torch.where(mining | queued, t, FAR_FUTURE).to(I32)


# ------------------------------------------------------------- host stats

def _host(pstate):
    """The arena columns and uncle slots of one run, as numpy."""
    return (bc.to_numpy(pstate.arena), pstate.u1.detach().cpu().numpy(),
            pstate.u2.detach().cpu().numpy())


def rewards_by_miner(pstate, head: int, until_height: int = 0) -> dict:
    """allRewardsById: 2.0 a block on the chain from `head` plus uncle
    rewards (wittgenstein_tpu/models/ethpow.py:598-619)."""
    arena, u1, u2 = _host(pstate)
    out: dict = {}
    cur = int(head)
    while cur > 0 and arena["height"][cur] > until_height:
        prod = int(arena["producer"][cur])
        p_extra = 0.0
        for u in (int(u1[cur]), int(u2[cur])):
            if u >= 0:
                u_r = 2.0 * (arena["height"][u] + 8 - arena["height"][cur]) \
                    / 8
                out[int(arena["producer"][u])] = \
                    out.get(int(arena["producer"][u]), 0.0) + u_r
                p_extra += 2.0 / 32
        out[prod] = out.get(prod, 0.0) + 2.0 + p_extra
        cur = int(arena["parent"][cur])
    return out


def avg_difficulty(pstate, head: int, until_height: int = 0) -> float:
    """avgDifficulty: mean raw difficulty over the chain from `head`
    down to (excluding) `until_height` (wittgenstein_tpu/models/
    ethpow.py:622-632)."""
    arena = bc.to_numpy(pstate.arena)
    diff = pstate.diff_s.detach().cpu().numpy().astype(np.float64) * \
        2.0 ** DIFF_SHIFT
    tot, cnt, cur = 0.0, 0, int(head)
    while cur > 0 and arena["height"][cur] > until_height:
        tot += diff[cur]
        cnt += 1
        cur = int(arena["parent"][cur])
    return tot / max(1, cnt)


def uncle_rate(pstate, head: int, until_height: int = 0) -> float:
    """uncleRate: uncles / (uncles + head.height - first.height), down to
    (excluding) until_height (wittgenstein_tpu/models/ethpow.py:930-944)."""
    arena, u1, u2 = _host(pstate)
    uncles, cur, first = 0, int(head), None
    head_h = int(arena["height"][int(head)])
    while cur > 0 and arena["height"][cur] > until_height:
        uncles += int(u1[cur] >= 0) + int(u2[cur] >= 0)
        first = cur
        cur = int(arena["parent"][cur])
    if first is None:
        return 0.0
    return uncles / max(1, uncles + head_h - int(arena["height"][first]))


CSV_HEADER = ("miner, hashrate ratio, revenue ratio, revenue, uncle rate, "
              "total revenue, avg difficulty")


def miner_row(pstates, runs, hours, miner, pw, nl_name):
    """`try_miner`'s row of one hash-power point from the final states
    of its `runs` seeds (a batch): the byzantine miner's revenue and
    share, uncle rate, total revenue and mean difficulty over the
    public chain (observer node 0's head), warm-up blocks skipped on
    runs over 30 hours (wittgenstein_tpu/models/ethpow.py:657-685).
    Returns ``(row dict, CSV line)``."""
    from torch.utils import _pytree as pytree
    rew1 = ur = diff = tot = 0.0
    for i in range(runs):
        ps = pytree.tree_map(lambda x, i=i: x[i], pstates)
        arena = bc.to_numpy(ps.arena)
        base = int(ps.head[0])
        skip = 5000 if hours > 30 else 0
        for _ in range(skip):
            par = int(arena["parent"][base])
            if par <= 0:
                break
            base = par
        limit = GENESIS_HEIGHT + skip
        r = rewards_by_miner(ps, base, until_height=limit)
        rew1 += r.get(1, 0.0)
        tot += sum(r.values())
        ur += uncle_rate(ps, base, until_height=limit)
        diff += avg_difficulty(ps, base, until_height=limit)
    row = dict(miner=miner or "ETHMiner", pow=pw,
               revenue_ratio=rew1 / max(tot, 1e-9),
               revenue=rew1 / runs, uncle_rate=ur / runs,
               total_revenue=tot / runs, avg_difficulty=diff / runs)
    line = (f"{row['miner']}/{nl_name}/{hours}/{runs}, {pw:.2f}, "
            f"{row['revenue_ratio']:.4f}, {row['revenue']:.0f}, "
            f"{row['uncle_rate']:.4f}, {row['total_revenue']:.0f}, "
            f"{row['avg_difficulty']:.0f}")
    return row, line


def try_miner(builder_name, nl_name, miner, pows, hours, runs,
              number_of_miners=10, tick_ms=10, chunk=2000, capacity=8192,
              device=None, out=print, **proto_kw):
    """The strategy-evaluation harness (wittgenstein_tpu/models/ethpow.py:
    635-686): for each hash-power ratio in `pows`, `runs` seeds (from 1)
    in ONE batch through `core/harness.run_multiple_times`, then the
    reference's CSV header and one row per ratio (`miner_row`, printed
    with `out`).  Returns the rows as dicts."""
    from ..core.harness import run_multiple_times
    out(CSV_HEADER)
    rows = []
    ticks = int(hours * 3600 * 1000) // tick_ms
    for pw in pows:
        proto = ETHPoW(number_of_miners=number_of_miners,
                       byz_class_name=miner, byz_mining_ratio=pw,
                       node_builder_name=builder_name,
                       network_latency_name=nl_name, tick_ms=tick_ms,
                       capacity=capacity, device=device, **proto_kw)
        res = run_multiple_times(
            proto, run_count=runs, max_time=ticks, chunk=chunk,
            first_seed=1, cont_if=lambda net, ps: net.time >= 0)
        row, line = miner_row(res.pstates, runs, hours, miner, pw, nl_name)
        rows.append(row)
        out(line)
    return rows


class Decision:
    """ETHPoW.Decision: a choice taken at `taken_at_height`, evaluated
    when the head reaches `reward_at_height`
    (wittgenstein_tpu/models/ethpow.py:689-712)."""

    def __init__(self, taken_at_height: int, reward_at_height: int,
                 fields=()):
        if reward_at_height <= taken_at_height:
            raise ValueError("reward height must be after the decision")
        self.taken_at_height = taken_at_height
        self.reward_at_height = reward_at_height
        self.fields = tuple(fields)

    def for_csv(self) -> str:
        return ",".join(str(f) for f in
                        (self.taken_at_height, self.reward_at_height)
                        + self.fields)

    def reward(self, pstate, head: int, miner_id: int = 1) -> float:
        """The miner's rewards on the head chain above the decision
        height."""
        return rewards_by_miner(pstate, head,
                                until_height=self.taken_at_height
                                ).get(miner_id, 0.0)


class DecisionLog:
    """The agent miner's decision bookkeeping
    (wittgenstein_tpu/models/ethpow.py:715-739): decisions sorted by
    evaluation height; when the head passes one, its reward is appended
    to `path`."""

    def __init__(self, path="decisions.csv", miner_id=1):
        self.path = path
        self.miner_id = miner_id
        self.pending: list = []

    def add(self, d: Decision):
        keys = [x.reward_at_height for x in self.pending]
        self.pending.insert(bisect.bisect_right(keys, d.reward_at_height), d)

    def on_new_head(self, pstate, head: int):
        arena_h = int(pstate.arena.height[int(head)])
        out = []
        while self.pending and self.pending[0].reward_at_height <= arena_h:
            d = self.pending.pop(0)
            out.append(f"{d.for_csv()},"
                       f"{d.reward(pstate, head, self.miner_id)}")
        if out:
            with open(self.path, "a") as f:
                f.write("\n".join(out) + "\n")
        return out


class MinerAgentEnv:
    """Step-wise control of the byzantine miner for agents
    (wittgenstein_tpu/models/ethpow.py:742-927).  Node 1 runs strategy
    AGENT: it publishes only blocks the public chain has overtaken, and
    otherwise when the agent calls `send_mined_blocks`.  The JAX env
    runs its polling loop as one on-device while loop; here it is a host
    loop that steps one tick and reads the decision code, which stops on
    the same tick with the same state."""

    ON_MINED_BLOCK = 1
    ON_OTHER_NEW_HEAD = 2
    ON_OTHER_PRIVATE_HEAD = 3

    def __init__(self, byz_mining_ratio, seed=0, decision_log=None,
                 device=None, **kw):
        kw.setdefault("network_latency_name", "NetworkFixedLatency(1000)")
        kw.setdefault("node_builder_name",
                      builders.registry_name("cities", True, 0.0))
        self.proto = ETHPoW(byz_class_name="ETHMinerAgent",
                            byz_mining_ratio=byz_mining_ratio,
                            device=device, **kw)
        self.net, self.p = self.proto.init(seed)
        self.log = decision_log

    @classmethod
    def create(cls, byz_mining_ratio, seed=0, device=None):
        """ETHMinerAgent.create."""
        return cls(byz_mining_ratio, seed, device=device)

    def go_next_step(self, max_ticks=1_000_000) -> int:
        """Advance until the agent has a decision to take
        (wittgenstein_tpu/models/ethpow.py:773-817); returns the
        decision code (0 = budget hit)."""
        from ..core.network import step_ms
        code, left = 0, max_ticks
        t = int(self.net.time)
        while code == 0 and left > 0:
            p = self.p
            h0, oh0 = p.head[1], p.others_head[1]
            mu0 = bitset.popcount(p.mined_unsent[1])
            self.net, p = step_ms(self.proto, self.net, p, t=t)
            t += 1
            self.p = p
            mu1 = bitset.popcount(p.mined_unsent[1])
            h1 = p.head[1]
            others = p.arena.producer[h1.clamp_min(0).long()] != 1
            code = int(torch.where(
                mu1 > mu0, self.ON_MINED_BLOCK,
                torch.where((mu1 > 0) & (h1 != h0) & others,
                            self.ON_OTHER_NEW_HEAD,
                            torch.where((mu1 > 0) & (p.others_head[1] != oh0),
                                        self.ON_OTHER_PRIVATE_HEAD, 0))))
            left -= 1
        if self.log is not None:
            self.log.on_new_head(self.p, int(self.p.head[1]))
        return code

    def _unsent_blocks(self):
        word = self.p.mined_unsent[1].cpu().numpy().view(np.uint32)
        t = self.p.arena.time.cpu().numpy()
        out = [b for b in range(self.proto.capacity)
               if word[b // 32] >> (b % 32) & 1]
        return sorted(out, key=lambda b: int(t[b]))      # oldest first

    def send_mined_blocks(self, how_many: int):
        """Publish the `how_many` oldest private blocks
        (wittgenstein_tpu/models/ethpow.py:826-867, with the reference's
        post-decrement and queue-empty rules)."""
        blocks = self._unsent_blocks()
        send = blocks[:how_many]
        aw = self.proto.aw
        p = self.p
        unsent = p.mined_unsent.clone()
        release = p.release.clone()
        heights = p.arena.height.cpu().numpy()
        oh0 = oh = int(p.others_head[1])
        oh_h = int(heights[max(oh, 0)])
        for b in send:
            bit = bitset.one_bit(torch.tensor(b, dtype=I32,
                                              device=unsent.device), aw)
            unsent[1] &= ~bit
            release[1] |= bit
            if int(heights[b]) > oh_h:
                oh, oh_h = b, int(heights[b])
        pb = int(p.private_blk[1])
        restart = len(send) == how_many - 1 and pb >= 0

        def set1(v, x):
            v = v.clone()
            v[1] = x
            return v
        self.p = p.replace(
            mined_unsent=unsent, release=release,
            others_head=set1(p.others_head, oh) if oh != oh0
            else p.others_head,
            private_blk=set1(p.private_blk, -1) if len(blocks) <= how_many
            else p.private_blk,
            min_father=set1(p.min_father, -1) if restart else p.min_father)

    # ---------------------------------------------------------- observables

    def _walk_run(self, want_mine: bool) -> int:
        arena = bc.to_numpy(self.p.arena)
        cur = int(self.p.head[1])
        score = 0
        while cur > 0 and (int(arena["producer"][cur]) == 1) == want_mine:
            cur = int(arena["parent"][cur])
            score += 1
        return score

    def get_advance(self) -> int:
        """Own blocks in a row from the head."""
        return self._walk_run(True)

    def get_lag(self) -> int:
        """Others' blocks in a row from the head."""
        return self._walk_run(False)

    def get_secret_advance(self) -> int:
        """Private-chain height advance over the public head."""
        pb = int(self.p.private_blk[1])
        heights = self.p.arena.height
        priv = 0 if pb < 0 else int(heights[pb])
        oth = int(heights[int(self.p.others_head[1])])
        return max(0, priv - oth)

    def get_reward(self, last_blocks_count=None) -> float:
        head = int(self.p.head[1])
        until = 0
        if last_blocks_count is not None:
            until = int(self.p.arena.height[head]) - last_blocks_count
        return rewards_by_miner(self.p, head,
                                until_height=until).get(1, 0.0)

    def get_reward_ratio(self) -> float:
        r = rewards_by_miner(self.p, int(self.p.head[1]))
        tot = sum(r.values())
        return r.get(1, 0.0) / tot if tot > 0 else 0.0

    def i_am_ahead(self) -> bool:
        return int(self.p.arena.producer[int(self.p.head[1])]) == 1

    def count_my_blocks(self) -> int:
        arena = bc.to_numpy(self.p.arena)
        cur = int(self.p.head[1])
        count = 0
        while cur > 0:
            count += int(arena["producer"][cur]) == 1
            cur = int(arena["parent"][cur])
        return count

    def get_time_in_seconds(self) -> int:
        """The simulated time in seconds."""
        return int(self.net.time) * self.proto.tick_ms // 1000
