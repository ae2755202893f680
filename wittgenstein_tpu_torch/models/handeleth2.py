"""HandelEth2 — Handel aggregation of Eth2 attestation committees — the
port of `wittgenstein_tpu/models/handeleth2.py`.

A new aggregation starts every PERIOD_TIME = 6 s and runs for three
periods, so R = 3 run at once, each in the process slot ``height % R``.
Every node attests a hash drawn geometrically (80% hash 0) and keeps its
aggregates per hash: a disjoint incoming aggregate is merged, an
overlapping one replaces ours only when it, with the individual
contributions we hold, is larger.  Dissemination backs off
exponentially per level, one shared verification core picks the best
queued aggregate every pairing time, and completing a level's incoming
set sends the upper complete levels on the fast path.  The design notes
of the JAX module hold unchanged: per-hash incoming and individual
bitsets are [N, R, H, W] rows with every level in its own bit range, and
a message carries (height, level, flags, hash), the receiver rebuilding
the sender's outgoing set from the sender's current rows.

The receive loop walks the inbox slot by slot, as JAX does (a slot's
queue insert sees the previous slot's).  With `step_hint` (the most
messages any node holds this ms, one host read outside the vmapped
step) it walks only that many slots: a slot that holds nothing for a
node leaves its state as it is.  Bitset rows are int32 words holding the
JAX package's uint32 bits (see `ops/bitset.py`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import masked_min, next_tick, register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import bitset, prng
from ..ops.flat import gather2d, gather_rows
from ._levels import LevelMixin, get_bit_rows, keyed_level_peer

I32 = torch.int32
PERIOD_TIME = 6000
PERIOD_AGG_TIME = PERIOD_TIME * 3
R = PERIOD_AGG_TIME // PERIOD_TIME          # concurrent aggregations

TAG_HASH = 0x48453248
TAG_BAD = 0x48453242
TAG_START = 0x48453253
TAG_EMIT = 0x48453245


@register_struct
@dataclasses.dataclass(frozen=True)
class HandelEth2State(_Struct):
    """wittgenstein_tpu/models/handeleth2.py:64-100.  Bitset leaves
    (inc, ind, finished, demoted, q_sig, pend_sig) are int32 words."""

    seed: torch.Tensor
    start_delta: torch.Tensor   # int32 [N] desynchronized start draw
    pairing: torch.Tensor       # int32 [N]
    height: torch.Tensor        # int32 [N] current height counter
    active: torch.Tensor        # bool [N, R]
    p_height: torch.Tensor      # int32 [N, R]
    p_start: torch.Tensor       # int32 [N, R]
    own_hash: torch.Tensor      # int32 [N, R]
    inc: torch.Tensor           # [N, R, H, W] incoming per hash
    ind: torch.Tensor           # [N, R, H, W] individual contributions
    finished: torch.Tensor      # [N, R, W] finished peers
    demoted: torch.Tensor       # [N, R, W] reception-rank demotions
    contacted: torch.Tensor     # int32 [N, R, L]
    cycle: torch.Tensor         # int32 [N, R, L]
    pos: torch.Tensor           # int32 [N, R, L]
    fast_pending: torch.Tensor  # int32 [N, R] level bitmask to fast-path
    q_from: torch.Tensor        # int32 [N, Q] (-1 empty)
    q_lvl: torch.Tensor
    q_slot: torch.Tensor
    q_height: torch.Tensor
    q_hash: torch.Tensor
    q_rank: torch.Tensor
    q_sig: torch.Tensor         # [N, Q, H, W]
    pend_on: torch.Tensor       # bool [N]
    pend_at: torch.Tensor
    pend_from: torch.Tensor
    pend_lvl: torch.Tensor
    pend_slot: torch.Tensor
    pend_hash: torch.Tensor
    pend_sig: torch.Tensor      # [N, H, W]
    agg_done: torch.Tensor      # int32 [N]
    contributions: torch.Tensor  # int32 [N]


def hash_thresholds(n_hash: int) -> list:
    """The geometric draw's thresholds 0.2, 0.2^2, ... as the JAX step
    computes them (wittgenstein_tpu/models/handeleth2.py:155-158): a
    float32 running product, each factor the float32 nearest 0.2."""
    pr, out = np.float32(1.0), []
    for _ in range(1, n_hash):
        pr = np.float32(pr * np.float32(0.2))
        out.append(float(pr))
    return out


def _or_fold(x, dim):
    """Bitwise OR over a short static axis (the JAX package's
    ``lax.reduce(..., bitwise_or, (dim,))``)."""
    return functools.reduce(torch.bitwise_or, x.unbind(dim))


def _set_slot(arr, onehot, value):
    """``arr[i, r] = value[i]`` where ``onehot[i, r]`` (the one slot of
    node i to write, or none): [N, R, ...] leaves, `value` a scalar or
    [N, ...]."""
    mask = onehot.reshape(onehot.shape + (1,) * (arr.dim() - 2))
    if isinstance(value, torch.Tensor):
        value = value.unsqueeze(1)
    return torch.where(mask, value, arr)


@register
class HandelEth2(LevelMixin):
    """Parameters mirror wittgenstein_tpu/models/handeleth2.py:111-140
    (HandelEth2Parameters), plus `device` (``cuda`` unless the caller
    asks for another)."""

    # Dests come from sibling-half level peer sets, never self
    # (core/network.unicast_floor_ms); no broadcast is ever sent
    # (core/network._broadcasts).
    may_self_send = False
    sends_broadcast = False

    def __init__(self, node_count=64, pairing_time=3, level_wait_time=100,
                 period_duration_ms=50, nodes_down=0,
                 node_builder_name=None, network_latency_name=None,
                 desynchronized_start=0, hash_values=4, queue_cap=16,
                 inbox_cap=16, horizon=1024, device=None):
        if node_count & (node_count - 1):
            raise ValueError("power-of-two node counts only "
                             "(HandelEth2Parameters :56-58)")
        if not (0 <= nodes_down < node_count):
            raise ValueError(f"nodeCount={node_count}")
        self.device = resolve_device(device)
        self.node_count = node_count
        self.pairing_time = pairing_time
        self.level_wait = level_wait_time
        self.period = period_duration_ms
        self.nodes_down = nodes_down
        self.desync = desynchronized_start
        self.n_hash = hash_values
        self.queue_cap = queue_cap
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.bits = max(1, int(math.log2(node_count)))
        self.levels = self.bits + 1
        self.w = bitset.n_words(node_count)
        self.half = np.array([0] + [1 << (lv - 1)
                                    for lv in range(1, self.levels)], np.int32)
        # per process one send per level + a fast-path batch
        k = R * (self.levels - 1) + self.bits
        self.cfg = EngineConfig(n=node_count, horizon=horizon,
                                inbox_cap=inbox_cap, payload_words=4,
                                out_deg=k, bcast_slots=1)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)
        self._halfs = torch.tensor(self.half, device=self.device)
        self._thresholds = hash_thresholds(hash_values)

    def __repr__(self):
        return (f"HandelEth2(node_count={self.node_count}, "
                f"nodes_down={self.nodes_down}, "
                f"hash_values={self.n_hash})")

    # ------------------------------------------------------------ helpers

    def _emission_peer(self, seed, ids, level, pos):
        """pos-th peer of the level in emission order
        (wittgenstein_tpu/models/handeleth2.py:144-147)."""
        return keyed_level_peer(seed, TAG_EMIT, ids, level, pos)

    def _own_hash_draw(self, seed, ids, height):
        """Geometric hash draw, P(h) = 0.8 * 0.2^h clipped to n_hash - 1
        (wittgenstein_tpu/models/handeleth2.py:149-159): the count of
        float32 thresholds above the float32 uniform."""
        u = prng.uniform_float(prng.hash3(seed, TAG_HASH, height), ids)
        h = torch.zeros_like(ids)
        for pr in self._thresholds:
            h = h + (u < pr).to(I32)
        return h

    def _size_if_merged(self, rows_inc, rows_ind, sig, lmask):
        """sizeIfMerged per hash, summed over the hash axis
        (wittgenstein_tpu/models/handeleth2.py:161-175)."""
        our = rows_inc & lmask
        their = sig & lmask
        pc_our = bitset.popcount(our)
        pc_their = bitset.popcount(their)
        disj = ~bitset.intersects(our, their)
        pc_alt = bitset.popcount(their | (rows_ind & lmask))
        per_hash = torch.where(
            pc_their == 0, pc_our,
            torch.where(disj, pc_our + pc_their,
                        torch.maximum(pc_alt, pc_our)))
        return per_hash.sum(-1, dtype=I32)

    def _hash_rows(self, hashes, bits):
        """[N, H, W]: `bits` [N, W] in the row of each node's hash."""
        oh = torch.arange(self.n_hash, device=hashes.device)[None, :] == \
            hashes[:, None]
        return torch.where(oh[..., None], bits[:, None, :], 0)

    # ---------------------------------------------------------------- init

    def init(self, seed):
        """wittgenstein_tpu/models/handeleth2.py:179-222."""
        n, w, L, Q, H = (self.node_count, self.w, self.levels,
                         self.queue_cap, self.n_hash)
        dev = self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        ids = self._ids
        if self.nodes_down:
            pri = prng.uniform_u32(prng.hash2(seed, TAG_BAD), ids)
            down = torch.zeros(n, dtype=torch.bool, device=dev)
            down[torch.argsort(pri, stable=True)[:self.nodes_down]] = True
            nodes = nodes.replace(down=down)
        start_delta = (prng.uniform_int(prng.hash2(seed, TAG_START), ids,
                                        self.desync)
                       if self.desync else
                       torch.zeros(n, dtype=I32, device=dev))
        pairing = (self.pairing_time * nodes.speed_ratio).clamp_min(1).to(I32)
        net = init_net(self.cfg, nodes, seed)

        def zi(*shape, fill=0):
            return torch.full(shape, fill, dtype=I32, device=dev)

        pstate = HandelEth2State(
            seed=seed, start_delta=start_delta, pairing=pairing,
            height=zi(n, fill=1000),
            active=torch.zeros((n, R), dtype=torch.bool, device=dev),
            p_height=zi(n, R), p_start=zi(n, R), own_hash=zi(n, R),
            inc=zi(n, R, H, w), ind=zi(n, R, H, w),
            finished=zi(n, R, w), demoted=zi(n, R, w),
            contacted=zi(n, R, L), cycle=zi(n, R, L), pos=zi(n, R, L),
            fast_pending=zi(n, R),
            q_from=zi(n, Q, fill=-1), q_lvl=zi(n, Q), q_slot=zi(n, Q),
            q_height=zi(n, Q), q_hash=zi(n, Q), q_rank=zi(n, Q),
            q_sig=zi(n, Q, H, w),
            pend_on=torch.zeros(n, dtype=torch.bool, device=dev),
            pend_at=zi(n), pend_from=zi(n, fill=-1), pend_lvl=zi(n),
            pend_slot=zi(n), pend_hash=zi(n), pend_sig=zi(n, H, w),
            agg_done=zi(n), contributions=zi(n))
        return net, pstate

    # ---------------------------------------------------------------- step

    def step_hint(self, p: HandelEth2State, inbox, t: int):
        """``(depth, born, due, pick, fast, ranks)`` at t for one run or a
        batch, read from the device at once (`core/network.step_hint`):
        the most messages any node holds, and whether any node can start
        an aggregation, apply a verification, pick one (a pairing tick,
        with an entry queued or arriving) or send on the fast path this
        ms.  Where a flag is false that phase is the identity on every
        node (the queue's dead entries are dropped only after a start).
        `ranks` is the batch's reception-rank table (`_rank_table`), or
        None past its size cap."""
        sd = p.start_delta + 1
        seeds = p.seed.reshape(-1).to(torch.int64)
        flags = torch.cat([torch.stack([
            inbox.valid.sum(-1).max(),
            ((t >= sd) & ((t - sd) % PERIOD_TIME == 0)).any(),
            (p.pend_on & (t >= p.pend_at)).any(),
            ((t - 1) % p.pairing == 0).any() & (
                (p.q_from >= 0).any() | inbox.valid.any()),
            (p.fast_pending > 0).any()]).to(torch.int64), seeds]).tolist()
        return ((int(flags[0]),) + tuple(bool(f) for f in flags[1:5]) +
                (self._rank_table(tuple(flags[5:])),))

    def _rank_table(self, seeds):
        """``(seeds [R], ranks [R, N, N])``: the reception rank
        ``bij_perm(hash3(seed, TAG_EMIT + 1, i), s)`` node i gives sender
        s (wittgenstein_tpu/models/handeleth2.py:303-304) for every seed
        of the batch, made once per set of seeds: a pure function of
        (seed, i, s), looked up in the step instead of hashed every ms.
        None past R * N * N = 2^26 entries (the step then hashes)."""
        n = self.node_count
        if len(seeds) * n * n > 1 << 26:
            return None
        cached = getattr(self, "_ranks", None)
        if cached is None or cached[0] != seeds:
            dev = self._ids.device
            st = torch.tensor(seeds, dtype=I32, device=dev)
            key = prng.hash3(st[:, None, None], TAG_EMIT + 1,
                             self._ids[None, :, None])
            self._ranks = cached = (seeds, st, prng.bij_perm(
                key, self._ids[None, None, :], self.bits))
        return cached[1:]

    def step(self, p: HandelEth2State, nodes, inbox, t: int,
             step_hint=None):
        """wittgenstein_tpu/models/handeleth2.py:226-357.  With
        `step_hint` the receive loop walks as many slots as the deepest
        node's inbox, and a phase no node can act in this ms is left
        out: the lifecycle where no aggregation starts, the merge where
        no verification lands, the pick off the pairing ticks, the
        periodic sends off the period's ticks and the fast path where
        none is queued (each the identity there)."""
        depth, born_any, due_any, pick_any, fast_any, ranks = (
            (None, True, True, True, True, None) if step_hint is None
            else step_hint)
        alive = ~nodes.down
        if born_any:
            p = self._lifecycle(p, t, alive)
        p = self._receive(p, inbox, alive, depth, ranks)

        # drop queue entries for dead aggregations: an entry is queued
        # live, and dies only when its slot starts a new aggregation
        if born_any:
            q_live = (p.q_from >= 0) & (gather2d(
                p.p_height, self._ids[:, None], p.q_slot) == p.q_height)
            p = p.replace(q_from=torch.where(q_live, p.q_from, -1))

        if due_any:
            p = self._apply_pending(p, t)
        if pick_any and t >= 1:
            p = self._pick_verification(p, t, alive)
        p, out = self._disseminate(
            p, t, alive, periodic=t >= 1 and (t - 1) % self.period == 0,
            fast=fast_any or due_any)
        return p, nodes, out

    def _lifecycle(self, p, t: int, alive):
        """A new aggregation every PERIOD_TIME from start_delta; the
        reused slot's previous one ends (wittgenstein_tpu/models/
        handeleth2.py:232-276)."""
        n, H = self.node_count, self.n_hash
        ids = self._ids
        r_idx = torch.arange(R, device=ids.device)
        born = alive & (t >= p.start_delta + 1) & \
            ((t - (p.start_delta + 1)) % PERIOD_TIME == 0)
        new_h = p.height + 1
        slot = new_h % R
        old_active = gather2d(p.active, ids, slot)
        old_inc = gather_rows(p.inc.reshape(n, R, -1), ids,
                              slot).reshape(n, H, -1)
        old_size = bitset.popcount(old_inc).sum(-1, dtype=I32)
        ended = born & old_active
        p = p.replace(
            agg_done=p.agg_done + ended.to(I32),
            contributions=p.contributions + torch.where(ended, old_size, 0))

        own_hash = self._own_hash_draw(p.seed, ids, new_h)
        own_rows = self._hash_rows(own_hash, bitset.one_bit(ids, self.w))
        born_at = born[:, None] & (r_idx[None, :] == slot[:, None])
        reset = functools.partial(_set_slot, onehot=born_at)
        return p.replace(
            height=torch.where(born, new_h, p.height),
            active=reset(p.active, value=True),
            p_height=reset(p.p_height, value=new_h),
            p_start=reset(p.p_start, value=t),
            own_hash=reset(p.own_hash, value=own_hash),
            inc=reset(p.inc, value=own_rows),
            ind=reset(p.ind, value=own_rows),
            finished=reset(p.finished, value=0),
            demoted=reset(p.demoted, value=0),
            contacted=reset(p.contacted, value=0),
            cycle=reset(p.cycle, value=0),
            pos=reset(p.pos, value=0),
            fast_pending=reset(p.fast_pending, value=0))

    # ------------------------------------------------------------ phases

    def _receive(self, p, inbox, alive, depth, ranks=None):
        """onNewAgg, slot by slot (wittgenstein_tpu/models/handeleth2.py:
        278-342).  What a slot's message is (its sender's rank, block
        mask and rebuilt aggregate, and whether its aggregation is live
        here) depends on no earlier slot, so it is computed for all
        slots at once; the finished, demoted and queue updates run slot
        by slot."""
        n, w, L, Q, H = (self.node_count, self.w, self.levels,
                         self.queue_cap, self.n_hash)
        ids = self._ids
        dev = ids.device
        valid, src_all, data = inbox.valid, inbox.src, inbox.data
        S = src_all.shape[1]
        if depth is not None and depth < S:
            if depth:
                order = torch.argsort((~valid).to(I32), dim=1, stable=True)
                order = order[:, :depth]
                valid = torch.gather(valid, 1, order)
                src_all = torch.gather(src_all, 1, order)
                data = torch.gather(data, 1, order[:, :, None].expand(
                    -1, -1, data.shape[2]))
            S = depth
        if not S:
            return p
        valid, src_all, data = valid[:, :S], src_all[:, :S], data[:, :S]
        rows = ids[:, None]
        src = src_all.clamp(0, n - 1)                              # [N, S]
        m_h = data[:, :, 0]
        m_lvl = data[:, :, 1].clamp(0, L - 1)
        m_fin = data[:, :, 2]
        m_hash = data[:, :, 3].clamp(0, H - 1)
        m_slot = (m_h % R).to(I32)
        have = valid & alive[:, None] & gather2d(p.active, rows, m_slot) & \
            (gather2d(p.p_height, rows, m_slot) == m_h)
        fin_bit = bitset.one_bit(src, w)                           # [N, S, W]
        if ranks is None:
            rank0 = prng.bij_perm(prng.hash3(p.seed, TAG_EMIT + 1, rows),
                                  src, self.bits)
        else:
            # this run's row of the batch's table (a batch may repeat a
            # seed: the rows are then equal)
            seeds, table = ranks
            row = (seeds == p.seed).to(I32).argmax().reshape(1)
            rank0 = torch.gather(torch.index_select(table, 0, row)[0], 1,
                                 src.long())
        # the sender's outgoing: its incoming rows masked to levels below
        # m_lvl, plus its own individual attestation
        sig = gather_rows(p.inc.reshape(n, R, -1), src, m_slot).reshape(
            n, S, H, w) & self._sender_block_mask(src, m_lvl)[:, :, None]
        hash_oh = torch.arange(H, device=dev) == m_hash[..., None]  # [N,S,H]
        sig = sig | torch.where(hash_oh[..., None], fin_bit[:, :, None], 0)
        r_idx = torch.arange(R, device=dev)
        q_idx = torch.arange(Q, device=dev)
        q_from, q_lvl, q_slot = p.q_from, p.q_lvl, p.q_slot
        q_height, q_hash, q_rank, q_sig = (p.q_height, p.q_hash, p.q_rank,
                                           p.q_sig)
        finished, demoted = p.finished, p.demoted
        for s in range(S):
            h_s, f_s, src_s = have[:, s], fin_bit[:, s], src[:, s]
            lvl_s, height_s, slot_s = m_lvl[:, s], m_h[:, s], m_slot[:, s]
            at_slot = r_idx[None, :] == slot_s[:, None]          # [N, R]
            finished = torch.where(
                ((h_s & (m_fin[:, s] != 0))[:, None] & at_slot)[..., None],
                finished | f_s[:, None, :], finished)
            # reception rank + demotion (:340-346)
            dem_rows = gather_rows(demoted, ids, slot_s)
            rank = rank0[:, s] + torch.where(
                bitset.intersects(dem_rows, f_s), n, 0).to(I32)
            demoted = torch.where((h_s[:, None] & at_slot)[..., None],
                                  demoted | f_s[:, None, :], demoted)
            # queue insert: replace same (from, level, height), else a
            # free entry, else evict the highest rank
            same = (q_from == src_s[:, None]) & (q_lvl == lvl_s[:, None]) & \
                (q_height == height_s[:, None])
            free = q_from < 0
            worst = torch.where(free, -1, q_rank).argmax(1)
            worst_rank = torch.gather(q_rank, 1, worst[:, None])[:, 0]
            any_same = same.any(1)
            any_free = free.any(1)
            slot_q = torch.where(
                any_same, same.to(I32).argmax(1),
                torch.where(any_free, free.to(I32).argmax(1), worst))
            ins = h_s & (any_same | any_free | (rank < worst_rank))
            put = ins[:, None] & (q_idx[None, :] == slot_q[:, None])
            q_from = torch.where(put, src_s[:, None], q_from)
            q_lvl = torch.where(put, lvl_s[:, None], q_lvl)
            q_slot = torch.where(put, slot_s[:, None], q_slot)
            q_height = torch.where(put, height_s[:, None], q_height)
            q_hash = torch.where(put, m_hash[:, s, None], q_hash)
            q_rank = torch.where(put, rank[:, None], q_rank)
            q_sig = torch.where(put[..., None, None], sig[:, s, None], q_sig)
        return p.replace(q_from=q_from, q_lvl=q_lvl, q_slot=q_slot,
                         q_height=q_height, q_hash=q_hash, q_rank=q_rank,
                         q_sig=q_sig, finished=finished, demoted=demoted)

    def _apply_pending(self, p, t: int):
        """updateVerifiedSignatures and mergeIncoming per hash
        (wittgenstein_tpu/models/handeleth2.py:361-413)."""
        n, L = self.node_count, self.levels
        ids = self._ids
        halfs = self._halfs
        due = p.pend_on & (t >= p.pend_at)
        sl = p.pend_slot.clamp(0, R - 1)
        lvl = p.pend_lvl
        lmask = self._range_mask_dyn(ids, lvl)[:, None, :]       # [N, 1, W]
        shape = p.inc.shape
        rows_inc = gather_rows(p.inc.reshape(n, R, -1), ids,
                               sl).reshape(shape[0], *shape[2:])
        rows_ind = gather_rows(p.ind.reshape(n, R, -1), ids,
                               sl).reshape(shape[0], *shape[2:])
        our = rows_inc & lmask
        their = p.pend_sig & lmask
        disj = ~bitset.intersects(our, their)
        alt = their | (rows_ind & lmask)
        better = bitset.popcount(alt) > bitset.popcount(our)
        new_level = torch.where(
            (bitset.popcount(their) == 0)[..., None], our,
            torch.where(disj[..., None], our | their,
                        torch.where(better[..., None], alt, our)))
        merged_rows = (rows_inc & ~lmask) | new_level
        ind_rows = rows_ind | self._hash_rows(
            p.pend_hash, bitset.one_bit(p.pend_from.clamp_min(0), self.w))
        at_slot = due[:, None] & (torch.arange(R, device=ids.device)[None, :]
                                  == sl[:, None])
        inc = _set_slot(p.inc, at_slot, merged_rows)
        ind = _set_slot(p.ind, at_slot, ind_rows)

        # fast path trigger: level incoming now complete -> queue the
        # upper complete levels
        lvl_card = bitset.popcount(new_level).sum(-1, dtype=I32)
        complete = due & (lvl_card >= halfs[lvl.clamp(0, L - 1).long()])
        pc = self._level_pc(_or_fold(merged_rows, 1), self._subword_masks(),
                            ids >> 5)                            # [N, L]
        og = 1 + pc.cumsum(1, dtype=I32) - pc
        lvl_idx = torch.arange(L, dtype=I32, device=ids.device)[None, :]
        cand = ((og >= halfs[None, :]) & (lvl_idx > lvl[:, None]) &
                (halfs[None, :] > 0) & complete[:, None])
        bits_ = torch.where(cand, torch.ones_like(lvl_idx) << lvl_idx,
                            0).sum(1, dtype=I32)
        # the JAX add of (bits & ~fast) is an OR: no carries
        fast = torch.where(at_slot, p.fast_pending | bits_[:, None],
                           p.fast_pending)
        return p.replace(inc=inc, ind=ind, fast_pending=fast,
                         pend_on=p.pend_on & ~due)

    def _pick_verification(self, p, t: int, alive):
        """verify (wittgenstein_tpu/models/handeleth2.py:415-455)."""
        n, Q, H, w = self.node_count, self.queue_cap, self.n_hash, self.w
        ids = self._ids
        due = alive & ~p.pend_on & (t >= 1) & ((t - 1) % p.pairing == 0)
        filled = p.q_from >= 0
        lmask = self._range_mask_dyn(ids[:, None], p.q_lvl)      # [N, Q, W]
        sl = p.q_slot.clamp(0, R - 1).long()[:, :, None, None].expand(
            n, Q, H, w)
        inc_e = torch.gather(p.inc, 1, sl)                        # [N, Q, H, W]
        ind_e = torch.gather(p.ind, 1, sl)
        s = self._size_if_merged(inc_e, ind_e, p.q_sig, lmask[:, :, None, :])
        cur = bitset.popcount(inc_e & lmask[:, :, None, :]).sum(-1,
                                                               dtype=I32)
        improving = filled & (s > cur)
        # curation: drop non-improving entries on due ticks (:306-312)
        q_from = torch.where(due[:, None] & filled & ~improving, -1,
                             p.q_from)
        # level-1 first (:147-151), else best size
        score = torch.where(improving, s, -1)
        score = torch.where(improving & (p.q_lvl == 1), score + (1 << 20),
                            score)
        best = score.argmax(1)
        best_ok = torch.gather(score, 1, best[:, None])[:, 0] > 0
        do = due & best_ok
        q_idx = torch.arange(Q, device=ids.device)

        def g(a):
            return torch.gather(a, 1, best[:, None])[:, 0]
        q_from = torch.where(do[:, None] & (q_idx[None, :] == best[:, None]),
                             -1, q_from)
        picked = torch.gather(p.q_sig, 1, best[:, None, None, None].expand(
            n, 1, H, w))[:, 0]
        return p.replace(
            q_from=q_from,
            pend_on=p.pend_on | do,
            # -1 so the merge lands before the next verify tick (:283-287)
            pend_at=torch.where(do, t + (p.pairing - 1).clamp_min(1),
                                p.pend_at),
            pend_from=torch.where(do, g(p.q_from), p.pend_from),
            pend_lvl=torch.where(do, g(p.q_lvl), p.pend_lvl),
            pend_slot=torch.where(do, g(p.q_slot), p.pend_slot),
            pend_hash=torch.where(do, g(p.q_hash), p.pend_hash),
            pend_sig=torch.where(do[:, None, None], picked, p.pend_sig))

    def _disseminate(self, p, t: int, alive, periodic=True, fast=True):
        """Periodic sends with exponential backoff, then the fast path
        (wittgenstein_tpu/models/handeleth2.py:457-549).  Without
        `periodic` (no node's period tick) the periodic half, and
        without `fast` (nothing queued) the fast path, is the identity
        and sends nothing."""
        n, L = self.node_count, self.levels
        ids = self._ids
        dev = ids.device
        cols, kfp = L - 1, self.bits
        pos, cycle, contacted = p.pos, p.cycle, p.contacted
        if periodic:
            dests, pls, pos, cycle, contacted = self._periodic(p, t, alive)
        else:
            dests = [torch.full((n, R * cols), -1, dtype=I32, device=dev)]
            pls = [torch.zeros((n, R * cols, 4), dtype=I32, device=dev)]
        fast_pending = p.fast_pending
        if fast:
            fdest, fpl, fast_pending = self._fast_path(p, pos, alive)
        else:
            fdest = torch.full((n, kfp), -1, dtype=I32, device=dev)
            fpl = torch.zeros((n, kfp, 4), dtype=I32, device=dev)
        out = empty_outbox(self.cfg, dev).replace(
            dest=torch.cat(dests + [fdest], 1),
            payload=torch.cat(pls + [fpl], 1))
        return p.replace(contacted=contacted, cycle=cycle, pos=pos,
                         fast_pending=fast_pending), out

    def _periodic(self, p, t: int, alive):
        """One send per level and process slot where its backoff fires
        (wittgenstein_tpu/models/handeleth2.py:474-516): the outbox
        columns of each slot, and the new pos, cycle and contacted."""
        n, L = self.node_count, self.levels
        ids = self._ids
        dev = ids.device
        halfs = self._halfs[None, :]
        hmax = halfs.clamp_min(1)
        per_due = alive & (t >= 1) & ((t - 1) % self.period == 0)
        subm = self._subword_masks()
        hi = ids >> 5
        lvl_idx = torch.arange(L, dtype=I32, device=dev)[None, :]
        levels = lvl_idx.expand(n, L)
        cols = L - 1
        dests, pls = [], []
        cycles, poss, contacted = [], [], []
        for r in range(R):
            act = p.active[:, r] & per_due
            pc = self._level_pc(_or_fold(p.inc[:, r], 1), subm, hi)
            og = 1 + pc.cumsum(1, dtype=I32) - pc
            inc_complete = pc >= halfs
            is_open = (((t - p.p_start[:, r][:, None]) >=
                        (lvl_idx - 1) * self.level_wait) |
                       (og >= halfs)) & (halfs > 0)
            # exponential backoff (activeCycle :84-87)
            m = p.contacted[:, r] // max(1, self.bits)
            period_pow = torch.pow(3, m.clamp(0, 12)).to(I32)
            cyc = p.cycle[:, r] + (act[:, None] & is_open).to(I32)
            fire = act[:, None] & is_open & \
                ((cyc % period_pow.clamp_min(1)) == 0)
            cycles.append(cyc)
            pos_r = p.pos[:, r]
            peer = self._emission_peer(p.seed, ids[:, None], levels,
                                       pos_r % hmax)
            fin_peer = get_bit_rows(p.finished[:, r], peer)
            send_l = fire & ~fin_peer & (halfs > 0)
            poss.append(torch.where(fire, (pos_r + 1) % hmax, pos_r))
            contacted.append(p.contacted[:, r] + send_l.to(I32))
            dests.append(torch.where(send_l, peer, -1)[:, 1:])
            pls.append(torch.stack([
                p.p_height[:, r][:, None].expand(n, cols),
                levels[:, 1:],
                inc_complete.to(I32)[:, 1:],
                p.own_hash[:, r][:, None].expand(n, cols)], -1))
        return (dests, pls, torch.stack(poss, 1), torch.stack(cycles, 1),
                torch.stack(contacted, 1))

    def _fast_path(self, p, pos, alive):
        """Drain one queued level of one process slot per tick
        (wittgenstein_tpu/models/handeleth2.py:518-544): the outbox
        columns and the new fast_pending."""
        n, L, kfp = self.node_count, self.levels, self.bits
        ids = self._ids
        dev = ids.device
        any_fp = p.fast_pending > 0                                # [N, R]
        r_pick = any_fp.to(I32).argmax(1).to(I32)
        has_fp = any_fp.any(1) & alive
        fp_bits = gather2d(p.fast_pending, ids, r_pick)
        fl = bitset.lowest_bit(fp_bits)
        lsb = torch.where(fp_bits != 0, bitset.word_bit(fl), 0)
        fhalf = self._halfs[fl.long()].clamp_min(1)
        fpos = gather2d(pos.reshape(n, -1), ids, r_pick * L + fl)
        karange = torch.arange(kfp, dtype=I32, device=dev)[None, :]
        foffs = (fpos[:, None] + karange) % fhalf[:, None]
        fpeer = self._emission_peer(p.seed, ids[:, None],
                                    fl[:, None].expand(n, kfp), foffs)
        fok = has_fp[:, None] & (karange < fhalf.clamp_max(kfp)[:, None])
        payload = torch.stack([
            gather2d(p.p_height, ids, r_pick)[:, None].expand(n, kfp),
            fl[:, None].expand(n, kfp),
            torch.ones((n, kfp), dtype=I32, device=dev),
            gather2d(p.own_hash, ids, r_pick)[:, None].expand(n, kfp)], -1)
        fast_pending = torch.where(
            (has_fp[:, None] & (torch.arange(R, device=dev)[None, :]
                                == r_pick[:, None])),
            (fp_bits & ~lsb)[:, None], p.fast_pending)
        return torch.where(fok, fpeer, -1), payload, fast_pending

    def next_action_time(self, p: HandelEth2State, nodes, t: int):
        """Quiet-window oracle half (wittgenstein_tpu/models/
        handeleth2.py:551-572): the lifecycle tick every PERIOD_TIME from
        each node's start, a pending verification applying at
        ``pend_at``, the next pairing tick of a node with a queued
        entry, the dissemination tick of nodes with a live aggregation,
        and queued fast-path sends."""
        live = ~nodes.down
        one = torch.ones_like(p.pairing)
        born = masked_min(next_tick(t, p.start_delta + 1, PERIOD_TIME),
                          live)
        pend = masked_min(p.pend_at.clamp_min(t), live & p.pend_on)
        pick = masked_min(next_tick(t, one, p.pairing),
                          live & ~p.pend_on & (p.q_from >= 0).any(1))
        per = masked_min(next_tick(t, one, self.period),
                         live & p.active.any(1))
        fast = masked_min(t, live & (p.fast_pending > 0).any(1))
        return torch.minimum(torch.minimum(born, pend),
                             torch.minimum(pick, torch.minimum(per, fast)))
