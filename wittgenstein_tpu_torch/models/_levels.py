"""Binary-tree level machinery shared by the Handel family — the port of
`wittgenstein_tpu/models/_levels.py`.

Node i's level-l peer set is the sibling half of its 2^l-aligned block:
contiguous and disjoint across levels, so one [N, W] bitset row per node
holds every level's state and a level's view is a computed range mask.
Per-level popcounts use the integer prefix-sum form
(`_level_pc_prefix` in the JAX package), which the JAX package holds
bit-equal to its f32 one-hot einsum; there is no float in it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.protocol import masked_min, next_tick
from ..ops import bitset, prng
from ..ops.flat import gather2d

I32 = torch.int32
BIG = 0x7FFFFFFF


class StaticScheduleMixin:
    """Static task schedule of Handel (wittgenstein_tpu/models/
    _levels.py:27-52): verification picks, and their ``pend_at = t +
    pairing`` completions, fire at t = 1 (mod pairing_time), periodic
    dissemination at t = 1 (mod period).  The schedule is static only
    when every node shares the start (no desynchronized start) and the
    pairing time (constant-speed builder); otherwise ``schedule_lcm`` is
    None and `core/network.scan_chunk` never specializes.
    `next_action_time` is the protocol's half of the fast-forward
    oracle.  Requires self.desynchronized_start, self.builder,
    self.pairing_time, self.period."""

    @property
    def schedule_lcm(self):
        """Period (ms) after which the task schedule repeats, or None
        when it is data-dependent."""
        if self.desynchronized_start or self.builder.speed != "constant":
            return None
        return math.lcm(max(1, self.pairing_time), max(1, self.period))

    def phase_hints(self, tmod):
        """Static phase hints for ``time % schedule_lcm == tmod``: which
        gated sub-computations can fire this ms."""
        return {"verify": (tmod - 1) % max(1, self.pairing_time) == 0,
                "periodic": (tmod - 1) % max(1, self.period) == 0}

    def next_action_time(self, pstate, nodes, t: int):
        """The earliest ms >= t at which any node's timers can act
        (wittgenstein_tpu/models/_levels.py:53-97): an in-flight
        verification applying at ``pend_at``, the next pairing tick of a
        node with a non-empty queue, the next dissemination tick of any
        live node, a queued fast-path send, or the queue compaction the
        ms after a pick leaves a hole (the merge re-sorts the queue
        every ms it runs).  Under an attack flag every ms is active:
        the plants scan window state on each pick tick, outside the
        delivery flow (fast-forward then never jumps)."""
        start = pstate.start_at + 1
        if getattr(self, "byzantine_suicide", False) or \
                getattr(self, "hidden_byzantine", False):
            return torch.full_like(start, t).amin()
        live = ~nodes.down
        pend = masked_min(pstate.pend_at.clamp_min(t),
                          live & (pstate.pend_from >= 0))
        filled = pstate.q_from >= 0
        pick = masked_min(next_tick(t, start, pstate.pairing),
                          live & (pstate.pend_from < 0) & filled.any(1))
        hole_before_valid = ((torch.cumsum((~filled).to(I32), 1) > 0)
                             & filled).any(1)
        compact = masked_min(torch.full_like(start, t), hole_before_valid)
        per = masked_min(next_tick(t, start, self.period), live)
        fast = masked_min(start.clamp_min(t),
                          live & (pstate.fast_pending != 0))
        return torch.minimum(torch.minimum(pend, pick),
                             torch.minimum(torch.minimum(per, fast), compact))


def sibling_base(ids, half):
    """Base of the level range with half-block size `half`
    (wittgenstein_tpu/models/_levels.py:125-129)."""
    mine = ids & ~(2 * half - 1)
    return mine + torch.where((ids & half) != 0, torch.zeros_like(ids),
                              half)


def _pow2(k):
    """``1 << k`` for an int32 tensor k in [0, 30]."""
    return torch.ones_like(k) << k


def keyed_level_peer(seed, tag, ids, level, pos):
    """The `pos`-th peer of `ids` at `level` under a keyed permutation
    of the level's sibling range
    (wittgenstein_tpu/models/_levels.py:100-110)."""
    half = torch.where(level > 0, _pow2((level - 1).clamp(0, 30)), 1)
    base = sibling_base(ids, half.clamp_min(1))
    key = prng.hash3(prng.hash2(seed, tag), ids, level)
    return base + prng.bij_perm_dyn(key, torch.where(pos < half, pos, 0),
                                    (level - 1).clamp_min(0))


def byz_candidates(proto, p, nodes, excl_bits, demoted=None,
                   min_rank=None):
    """Per (node, level) lowest-reception-rank byzantine (down) peer not
    in `excl_bits` [N, W]: the adversary's peer scan of the attack modes
    (createSuicideByzantineSig, Handel.java:538-559;
    HiddenByzantine.firstByzantine, :844-858), as in
    wittgenstein_tpu/models/handel.py:315-340 (ranks raised by N for the
    senders set in `demoted`) and handel_cardinal.py:193-220 (only ranks
    above the [N, L] floor `min_rank` qualify).  Returns ([N, L] rank,
    BIG for none; [N, L] id, -1 for none).  A loop over the levels, each
    an [N, half] block: O(N^2) work, run only under an attack flag."""
    n, levels, ids = proto.node_count, proto.levels, proto._ids
    far = 1 << 30
    br = [torch.full((n,), far, dtype=I32, device=ids.device)]
    bi = [torch.full((n,), -1, dtype=I32, device=ids.device)]
    for lv in range(1, levels):
        half = 1 << (lv - 1)
        cand = sibling_base(ids, half)[:, None] + torch.arange(
            half, dtype=I32, device=ids.device)[None, :]
        rank = proto._rank(p.seed, ids[:, None], cand)
        if demoted is not None:
            rank = rank + torch.where(get_bit_rows(demoted, cand), n,
                                      0).to(I32)
        ok = nodes.down[cand.long()] & ~get_bit_rows(excl_bits, cand)
        if min_rank is not None:
            ok = ok & (rank > min_rank[:, lv][:, None])
        rank = torch.where(ok, rank, far)
        pos = rank.argmin(1, keepdim=True)
        best = torch.gather(rank, 1, pos)[:, 0]
        br.append(best)
        bi.append(torch.where(best < far, torch.gather(cand, 1, pos)[:, 0],
                              -1))
    return torch.stack(br, 1), torch.stack(bi, 1)


def get_bit_rows(bits, idx):
    """get_bit for [N, W] bitsets row-indexed by [N, ...] ids
    (wittgenstein_tpu/models/_levels.py:113-122)."""
    n = bits.shape[0]
    rows = torch.arange(n, dtype=I32, device=bits.device).reshape(
        (n,) + (1,) * (idx.dim() - 1))
    word = gather2d(bits, rows, idx // 32)
    return ((word >> (idx % 32)) & 1) != 0


def range_mask_dyn(ids, level, w: int):
    """[., W] level range mask of `ids` at per-element `level`
    (wittgenstein_tpu/models/_levels.py:305-310)."""
    half = torch.where(level > 0, _pow2((level - 1).clamp(0, 30)), 0)
    base = sibling_base(ids, half.clamp_min(1))
    return bitset.range_mask(torch.where(half > 0, base, 0), half, w)


def msb(x):
    """Index of the highest set bit of positive int32 values (the
    ``31 - lax.clz(x)`` of the JAX package, from comparisons: PyTorch
    has no count-leading-zeros)."""
    out = torch.zeros_like(x)
    for k in range(1, 31):
        out = out + ((x >> k) > 0).to(x.dtype)
    return out


def merge_bounded_queue(q_from, q_lvl, q_rank, src, level, rank_all, ok,
                        q_cap, cols2d, cols3d):
    """The bounded-queue merge of the Handel receive path
    (wittgenstein_tpu/models/_levels.py:132-182): one entry per (sender,
    level), the newest inbox message winning; keep the `q_cap` lowest
    keys ``rank * (Q+S+1) + position``.  Returns (sel2, sel3,
    evicted), `evicted` [M] int32: per row, the queued entries that
    survived superseding but were pushed out."""
    q = q_cap
    s = src.shape[1]
    dev = src.device
    later = torch.triu(torch.ones(s, s, dtype=torch.bool, device=dev),
                       diagonal=1)[None]
    dup = ((src[:, :, None] == src[:, None, :]) &
           (level[:, :, None] == level[:, None, :]) &
           ok[:, None, :] & later).any(dim=2)
    inc_ok = ok & ~dup
    superseded = ((q_from[:, :, None] == src[:, None, :]) &
                  (q_lvl[:, :, None] == level[:, None, :]) &
                  inc_ok[:, None, :]).any(dim=2)
    ex_keep = (q_from >= 0) & ~superseded

    u_from = torch.cat([torch.where(ex_keep, q_from, -1),
                        torch.where(inc_ok, src, -1)], dim=1)
    u2 = {"from": u_from,
          "lvl": torch.cat([q_lvl, level], dim=1),
          "rank": torch.cat([q_rank, rank_all], dim=1)}
    for k, (ex, inc) in cols2d.items():
        u2[k] = torch.cat([ex, inc], dim=1)
    u3 = {k: torch.cat([ex, inc], dim=1) for k, (ex, inc) in cols3d.items()}

    valid_u = u_from >= 0
    keyv = u2["rank"] * (q + s + 1) + \
        torch.arange(q + s, dtype=I32, device=dev)[None, :]
    sel2, sel3, order = select_queue(keyv, valid_u, q, u2, u3)
    kept_existing = ((order < q) &
                     torch.gather(valid_u, 1, order)).sum(1, dtype=I32)
    return sel2, sel3, ex_keep.sum(1, dtype=I32) - kept_existing


def select_queue(keyv, valid, q_cap, cols2d, cols3d):
    """Keep the `q_cap` lowest keys, invalid entries last in position
    order, and gather every column through that order
    (wittgenstein_tpu/models/_levels.py:185-207).  The JAX package's
    `lax.top_k` breaks ties by lower index; `torch.topk` promises no tie
    order, so this is a stable sort instead (valid keys are unique, and
    the invalid ones tie at BIG)."""
    order = torch.sort(torch.where(valid, keyv, BIG), dim=1,
                       stable=True).indices[:, :q_cap]
    sel2 = {k: torch.gather(v, 1, order) for k, v in cols2d.items()}
    sel3 = {k: torch.gather(v, 1, order[:, :, None].expand(
        -1, -1, v.shape[2])) for k, v in cols3d.items()}
    return sel2, sel3, order


class LevelMixin:
    """Requires self.node_count, self.levels, self.w, self.device
    (wittgenstein_tpu/models/_levels.py:210-324)."""

    def _subword_masks(self):
        """[N, L] in-word masks of the sub-word levels 1..5, as int32
        words (wittgenstein_tpu/models/_levels.py:227-252)."""
        subm = getattr(self, "_subm", None)
        if subm is None:
            n, L = self.node_count, self.levels
            masks = np.zeros((n, L), np.uint32)
            iarr = np.arange(n)
            for lv in range(1, min(6, L)):
                half = 1 << (lv - 1)
                mine = iarr & ~(2 * half - 1)
                base = (mine + np.where((iarr & half) != 0, 0, half)) & 31
                masks[:, lv] = np.uint32((1 << half) - 1) << base
            subm = torch.tensor(masks.view(np.int32), device=self.device)
            self._subm = subm
        return subm

    def _level_pc(self, rows, sub_masks, hi):
        """Per-level popcounts of [N, W] rows -> [N, L] int32: the
        prefix-sum form (wittgenstein_tpu/models/_levels.py:276-303).
        Levels >= 6 cover whole words [sibling_base/32, +half/32), a
        difference of two cumulative-sum gathers; levels 1..5 use the
        in-word masks on the node's own word."""
        n, L = rows.shape[0], self.levels
        ids = torch.arange(n, dtype=I32, device=rows.device)
        pc = bitset.popcount_words(rows)
        pref = pc.cumsum(dim=-1, dtype=I32)
        own_word = torch.gather(rows, 1, hi.long()[:, None])[:, 0]
        out = bitset.popcount_words(own_word[:, None] & sub_masks)
        cols = [out[:, :min(6, L)]]
        for lv in range(6, L):
            start = sibling_base(ids, 1 << (lv - 1)) >> 5
            end_i = start + (1 << (lv - 6)) - 1
            hi_s = torch.gather(pref, 1, end_i.long()[:, None])[:, 0]
            lo_s = torch.where(
                start > 0, torch.gather(
                    pref, 1, (start - 1).clamp_min(0).long()[:, None])[:, 0],
                0)
            cols.append((hi_s - lo_s)[:, None])
        return torch.cat(cols, dim=1)

    def _range_mask_dyn(self, ids, level):
        """wittgenstein_tpu/models/_levels.py:305-310."""
        return range_mask_dyn(ids, level, self.w)

    def _block_mask_dyn(self, ids, k):
        """[., W] mask of the 2^k block holding each id
        (wittgenstein_tpu/models/_levels.py:312-317)."""
        size = _pow2(k.clamp(0, 30))
        base = ids & ~(size - 1).clamp_min(0)
        return bitset.range_mask(base, size, self.w)

    def _sender_block_mask(self, src, level):
        """[., W] mask of the sender's outgoing set at `level`
        (wittgenstein_tpu/models/_levels.py:319-324): the `half`-aligned
        block of `half` bits holding `src`, ``range_mask(base, half)``.
        Such a block is whole words when half >= 32 and part of one word
        otherwise, so the mask is one word value over a word range: its
        [., W] transients are a bool and the result, not the int64
        shifts of `range_mask` (at 32,768 nodes a q_sig piece's [16,384,
        12, 1,024] block masks took 6 GB a seed that way)."""
        half = torch.where(level > 0, _pow2((level - 1).clamp(0, 30)), 0)
        base = src & ~(half - 1).clamp_min(0)
        first = (base >> 5)[..., None]
        word = torch.arange(self.w, dtype=I32, device=src.device)
        inside = (word >= first) & (word < first + ((half + 31) >> 5)[
            ..., None])
        bits = bitset.to_i32(((torch.ones_like(half, dtype=torch.int64)
                               << half.clamp_max(32).to(torch.int64)) - 1)
                             << (base & 31).to(torch.int64))
        return torch.where(inside, bits[..., None], 0)
