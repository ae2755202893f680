"""San Fermín signature aggregation — pairwise binomial swaps — ported
from `wittgenstein_tpu/models/sanfermin.py`.

Two protocols share the geometry:

* `SanFermin` (protocols/SanFerminSignature.java): each node walks
  prefix levels from log2(N)-1 down to 0, at each level swapping its
  aggregate with a node of the sibling block (SwapRequest / SwapReply),
  retrying other candidates on timeout; optimistic replies come from a
  per-level signature cache; a verification (pairingTime) gates every
  aggregation; doneAt = time + 2*pairingTime once level 0 completes.
* `SanFerminCappos` (protocols/SanFerminCappos.java): one `Swap(level,
  value, wantReply)` message, a per-level cache of the best received
  values whose total drives a threshold, a candidateCount fan-out, and
  cached levels skipped on entry.

Geometry (power-of-two N): at prefix length cpl, half =
2^(log2(N)-cpl-1); the own set is the node's half-block, the candidate
set the sibling half-block; pick j is ``(partner_off + j) mod half``
there, the mirror node first.  All of it is index arithmetic.

The step walks the inbox one slot at a time, as the JAX step does
(`sanfermin.py:267-327`, Cappos at `:501`), each slot's replies written
into a per-node reply buffer: many small PyTorch ops a simulated ms.
The four reply columns of the JAX step (dest, kind, level, value) are
one [N, reply_cap, 4] buffer here, written with one row scatter where
the JAX step writes four columns with the same mask.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops.flat import gather2d, set2d

I32 = torch.int32

REQ, OK, NO = 0, 1, 2          # SanFermin message kinds
SWAP_ASK, SWAP_INFO = 0, 1     # Cappos: wantReply true / false


def _half(bits, cpl):
    """Block size at prefix length cpl: 2^(bits - cpl - 1)
    (wittgenstein_tpu/models/sanfermin.py:55-57)."""
    return torch.ones_like(cpl) << (bits - cpl - 1).clamp(0, 30)


def _own_base(ids, half):
    """wittgenstein_tpu/models/sanfermin.py:60-61."""
    return ids & ~(half - 1)


def _cand_base(ids, half):
    """Base of the sibling half-block, the candidate set
    (wittgenstein_tpu/models/sanfermin.py:64-66)."""
    return _own_base(ids, half) ^ half


def _pick_offset(j, partner_off, half):
    """The j-th pick of a level's candidate order: the mirror node first,
    then the other offsets in a per-node rotation ``(partner_off + j) mod
    half`` (wittgenstein_tpu/models/sanfermin.py:69-87)."""
    return (partner_off + j) % half.clamp_min(1)


def _expected(off, partner_off, used, half):
    """Was candidate offset `off` among our first `used` picks?
    (wittgenstein_tpu/models/sanfermin.py:90-93)."""
    return (off - partner_off) % half.clamp_min(1) < used


class _SanFerminBase:
    """Shared scaffolding: parameters, node building, level geometry
    (wittgenstein_tpu/models/sanfermin.py:96-150)."""

    def _setup(self, node_count, pairing_time, signature_size,
               candidate_count, reply_cap, inbox_cap, horizon,
               node_builder_name, network_latency_name, device):
        if node_count & (node_count - 1):
            raise ValueError("power-of-two node counts only")
        self.node_count = node_count
        self.pairing_time = pairing_time
        self.signature_size = signature_size
        self.candidate_count = candidate_count
        self.reply_cap = reply_cap
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.device = resolve_device(device)
        self.bits = int(math.log2(node_count))
        self.levels = self.bits + 1          # cpl values 0..bits
        self.cfg = EngineConfig(
            n=node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=3,
            # +1: the first pick batch is mirror + candidate_count
            out_deg=candidate_count + 1 + reply_cap,
            bcast_slots=1)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)

    def __repr__(self):
        return f"{type(self).__name__}(node_count={self.node_count})"

    def _partner_off(self, ids, cpl):
        return ids & (_half(self.bits, cpl) - 1)

    def _pick_batch(self, ids, cpl, used, count):
        """Candidate ids of the next request batch at level cpl, -1 where
        the candidate set is exhausted: the first batch is the mirror
        plus `count` more, later ones the next `count` unused
        (wittgenstein_tpu/models/sanfermin.py:125-150).  Returns (dest
        [N, count+1], n_taken)."""
        half = _half(self.bits, cpl)                        # [N]
        base = _cand_base(ids, half)
        partner = self._partner_off(ids, cpl)
        first = used == 0
        width = count + 1
        cols = torch.arange(width, dtype=I32, device=ids.device)
        j = used[:, None] + cols[None, :]
        off = _pick_offset(j, partner[:, None], half[:, None])
        ok = (j < half[:, None]) & (first[:, None] | (cols[None, :] < count))
        dest = torch.where(ok, base[:, None] + off, -1)
        return dest, ok.sum(1, dtype=I32)

    def _init_nodes(self, seed):
        seed = torch.as_tensor(seed, device=self.device).to(I32)
        nodes = self.builder.build(seed, self.node_count, self.device)
        return seed, init_net(self.cfg, nodes, seed)

    def _outbox(self, dest_req, req_kind, req_lvl, req_val, replies, r_cnt,
                reply_kind=None):
        """The step's outbox: the request batch in columns [:cc+1], the
        reply buffer's live rows after it
        (wittgenstein_tpu/models/sanfermin.py:357-374 and 570-587).
        `replies` is [N, rc, 4] (dest, kind, level, value); Cappos's
        replies all carry `reply_kind`."""
        n, rc = self.node_count, self.reply_cap
        w = self.candidate_count + 1
        dev = dest_req.device
        live = torch.arange(rc, device=dev)[None, :] < r_cnt[:, None]
        dest = torch.cat([dest_req, torch.where(live, replies[..., 0], -1)], 1)
        kind = replies[..., 1] if reply_kind is None else \
            torch.full((n, rc), reply_kind, dtype=I32, device=dev)
        payload = torch.cat([
            torch.stack([torch.full((n, w), req_kind, dtype=I32, device=dev),
                         req_lvl[:, None].expand(n, w),
                         req_val[:, None].expand(n, w)], -1),
            torch.stack([kind, replies[..., 2], replies[..., 3]], -1)], 1)
        sizes = torch.full(dest.shape, self.signature_size + 1, dtype=I32,
                           device=dev)
        return empty_outbox(self.cfg, dev).replace(dest=dest,
                                                   payload=payload,
                                                   size=sizes)

    def done(self, pstate, nodes):
        return (nodes.down | pstate.done).all()


def _push_reply(replies, cnt, ids, row, ok, rc):
    """Append `row` ([N, 4]: dest, kind, level, value) to each masked
    node's reply buffer while it has room
    (wittgenstein_tpu/models/sanfermin.py:252-260).  The buffer starts
    as a fresh tensor, which vmap does not batch, so the row scatter is
    out of place (`index_put`); masked-off rows go to a dump row."""
    ok = ok & (cnt < rc)
    n = replies.shape[0]
    flat = torch.where(ok, ids * rc + cnt.clamp_max(rc - 1), n * rc)
    out = torch.cat([replies.reshape(n * rc, 4), replies.new_zeros(1, 4)])
    out = out.index_put((flat.long(),), row)
    return out[:n * rc].reshape(n, rc, 4), cnt + ok.to(I32)


def _row(dest, *cols):
    """[N, 4] reply rows: `dest` [N] and three columns, each a tensor or
    a Python int."""
    return torch.stack([dest] + [c if isinstance(c, torch.Tensor) else
                                 torch.full_like(dest, c) for c in cols],
                       1).to(I32)


@register_struct
@dataclasses.dataclass(frozen=True)
class SanFerminState(_Struct):
    """wittgenstein_tpu/models/sanfermin.py:153-169."""

    seed: torch.Tensor
    cpl: torch.Tensor           # int32 [N] currentPrefixLength
    agg: torch.Tensor           # int32 [N] aggValue
    cache: torch.Tensor         # int32 [N, L] signatureCache (0 = none)
    used: torch.Tensor          # int32 [N] picks consumed at current level
    swapping: torch.Tensor      # bool [N]
    pend_val: torch.Tensor      # int32 [N] value being "verified"
    pend_at: torch.Tensor       # int32 [N]
    pend_on: torch.Tensor       # bool [N]
    timeout_at: torch.Tensor    # int32 [N] (0 = none)
    timeout_lvl: torch.Tensor   # int32 [N]
    threshold_at: torch.Tensor  # int32 [N]
    done: torch.Tensor          # bool [N]
    sent_requests: torch.Tensor      # int32 [N]
    received_requests: torch.Tensor  # int32 [N]


@register
class SanFermin(_SanFerminBase):
    """protocols/SanFerminSignature.java; parameters mirror the JAX
    package's (wittgenstein_tpu/models/sanfermin.py:177-185), plus
    `device` (``cuda`` unless the caller asks for another)."""

    def __init__(self, node_count=1024, threshold=None, pairing_time=2,
                 signature_size=48, reply_timeout=300, candidate_count=1,
                 node_builder_name=None, network_latency_name=None,
                 reply_cap=4, inbox_cap=16, horizon=512, device=None):
        self.threshold = node_count if threshold is None else threshold
        self.reply_timeout = reply_timeout
        self._setup(node_count, pairing_time, signature_size,
                    candidate_count, reply_cap, inbox_cap, horizon,
                    node_builder_name, network_latency_name, device)

    def init(self, seed):
        """wittgenstein_tpu/models/sanfermin.py:187-209."""
        n, L, dev = self.node_count, self.levels, self.device
        seed, net = self._init_nodes(seed)

        def zi():
            return torch.zeros(n, dtype=I32, device=dev)

        def zb():
            return torch.zeros(n, dtype=torch.bool, device=dev)
        return net, SanFerminState(
            seed=seed, cpl=torch.full((n,), self.bits, dtype=I32, device=dev),
            agg=torch.ones(n, dtype=I32, device=dev),
            cache=torch.zeros((n, L), dtype=I32, device=dev),
            used=zi(), swapping=zb(), pend_val=zi(), pend_at=zi(),
            pend_on=zb(), timeout_at=zi(), timeout_lvl=zi(),
            threshold_at=zi(), done=zb(), sent_requests=zi(),
            received_requests=zi())

    def _enter_level(self, p, nodes, go, t):
        """goNextLevel: threshold and done checks, cpl decrement, own agg
        cached, request-batch trigger
        (wittgenstein_tpu/models/sanfermin.py:213-235)."""
        hit = go & ~(p.threshold_at > 0) & (p.agg >= self.threshold)
        threshold_at = torch.where(hit, t + 2 * self.pairing_time,
                                   p.threshold_at)
        finish = go & (p.cpl == 0) & ~p.done
        done = p.done | finish
        done_at = torch.where(finish & (nodes.done_at == 0),
                              max(1, t + 2 * self.pairing_time),
                              nodes.done_at)
        nodes = nodes.replace(done_at=done_at.to(I32))
        desc = go & ~finish & ~p.done
        cpl = torch.where(desc, p.cpl - 1, p.cpl)
        cache = set2d(p.cache, self._ids, cpl.clamp_min(0), p.agg, ok=desc)
        p = p.replace(cpl=cpl, cache=cache, swapping=p.swapping & ~desc,
                      used=torch.where(desc, 0, p.used), done=done,
                      threshold_at=threshold_at)
        return p, nodes, desc        # desc nodes send a fresh batch

    def step(self, p: SanFerminState, nodes, inbox, t):
        """wittgenstein_tpu/models/sanfermin.py:237-375."""
        n, L, rc = self.node_count, self.levels, self.reply_cap
        ids = self._ids
        alive = ~nodes.down
        replies = torch.zeros((n, rc, 4), dtype=I32, device=ids.device)
        r_cnt = torch.zeros_like(ids)
        want_batch = torch.zeros_like(alive)

        swapping, cache = p.swapping, p.cache
        pend_val, pend_at, pend_on = p.pend_val, p.pend_at, p.pend_on
        recvd = p.received_requests
        my_half = _half(self.bits, p.cpl)
        my_partner = self._partner_off(ids, p.cpl)

        for s in range(inbox.src.shape[1]):
            ok_s = inbox.valid[:, s] & alive
            src = inbox.src[:, s].clamp(0, n - 1)
            kind = inbox.data[:, s, 0]
            lvl = inbox.data[:, s, 1].clamp(0, L - 1)
            val = inbox.data[:, s, 2]

            half = _half(self.bits, lvl)
            cand_base = _cand_base(ids, half)
            is_cand = ok_s & (cand_base == _own_base(src, half))

            # ---- SwapRequest (onSwapRequest) ----
            is_req = ok_s & (kind == REQ)
            recvd = recvd + is_req.to(I32)
            wrong = is_req & (p.done | (lvl != p.cpl))
            cached = gather2d(cache, ids, lvl)
            # cached value -> optimistic OK reply
            replies, r_cnt = _push_reply(replies, r_cnt, ids,
                                         _row(src, OK, lvl, cached),
                                         wrong & (cached > 0), rc)
            # no cache -> NO reply carrying the replier's own level, the
            # value remembered if it came from a candidate
            replies, r_cnt = _push_reply(replies, r_cnt, ids,
                                         _row(src, NO, p.cpl, 0),
                                         wrong & (cached == 0), rc)
            cache = set2d(cache, ids, lvl, val,
                          ok=wrong & (cached == 0) & is_cand)
            # current level, already swapping -> optimistic OK with our agg
            cur = is_req & ~wrong
            replies, r_cnt = _push_reply(replies, r_cnt, ids,
                                         _row(src, OK, lvl, p.agg),
                                         cur & swapping, rc)
            # valid swap -> latch the verification (no reply on accept)
            accept = cur & ~swapping & is_cand
            swapping = swapping | accept
            pend_val = torch.where(accept, val, pend_val)
            pend_at = torch.where(accept, t + self.pairing_time, pend_at)
            pend_on = pend_on | accept

            # ---- SwapReply (onSwapReply) ----
            is_rep = ok_s & ((kind == OK) | (kind == NO)) & ~p.done & \
                (lvl == p.cpl) & ~swapping
            expected = _expected(src - cand_base, my_partner, p.used, my_half)
            acc2 = is_rep & (kind == OK) & is_cand
            swapping = swapping | acc2
            pend_val = torch.where(acc2, val, pend_val)
            pend_at = torch.where(acc2, t + self.pairing_time, pend_at)
            pend_on = pend_on | acc2
            # NO from an expected candidate -> try the next ones
            want_batch = want_batch | (is_rep & (kind == NO) & expected)

        p = p.replace(swapping=swapping, cache=cache, pend_val=pend_val,
                      pend_at=pend_at, pend_on=pend_on,
                      received_requests=recvd)

        # ---- apply finished verification -> aggregate + goNextLevel ----
        due = pend_on & (t >= p.pend_at) & ~p.done
        p = p.replace(agg=torch.where(due, p.agg + p.pend_val, p.agg),
                      pend_on=pend_on & ~due)
        p, nodes, desc = self._enter_level(p, nodes, due, t)

        # ---- init kick (registerTask(goNextLevel, 1)) ----
        kick = alive & (t == 1) & (p.cpl == self.bits)
        p, nodes, desc0 = self._enter_level(p, nodes, kick, t)
        desc = desc | desc0

        # ---- timeout (sendToNodes' chained task) ----
        fired = alive & ~p.done & (p.timeout_at > 0) & \
            (t >= p.timeout_at) & (p.cpl == p.timeout_lvl)
        want_batch = (want_batch & ~p.done & alive) | desc | fired

        # ---- assemble outbox ----
        dest_req, taken = self._pick_batch(ids, p.cpl, p.used,
                                           self.candidate_count)
        dest_req = torch.where(want_batch[:, None], dest_req, -1)
        sent_some = want_batch & (taken > 0)
        p = p.replace(
            used=torch.where(want_batch, p.used + taken, p.used),
            sent_requests=p.sent_requests + torch.where(
                want_batch, (dest_req >= 0).sum(1, dtype=I32), 0),
            timeout_at=torch.where(sent_some, t + self.reply_timeout,
                                   p.timeout_at),
            timeout_lvl=torch.where(sent_some, p.cpl, p.timeout_lvl))
        out = self._outbox(dest_req, REQ, p.cpl, p.agg, replies, r_cnt)
        return p, nodes, out


@register_struct
@dataclasses.dataclass(frozen=True)
class CapposState(_Struct):
    """wittgenstein_tpu/models/sanfermin.py:381-395."""

    seed: torch.Tensor
    cpl: torch.Tensor           # int32 [N]
    cache_best: torch.Tensor    # int32 [N, L] max received value per level
    used: torch.Tensor          # int32 [N]
    swapping: torch.Tensor      # bool [N]
    pend_val: torch.Tensor      # int32 [N]
    pend_lvl: torch.Tensor      # int32 [N]
    pend_at: torch.Tensor       # int32 [N]
    pend_on: torch.Tensor       # bool [N]
    timeout_at: torch.Tensor    # int32 [N]
    timeout_lvl: torch.Tensor   # int32 [N]
    threshold_at: torch.Tensor  # int32 [N]
    done: torch.Tensor          # bool [N]


@register
class SanFerminCappos(_SanFerminBase):
    """protocols/SanFerminCappos.java; parameters mirror the JAX
    package's (wittgenstein_tpu/models/sanfermin.py:404-412), plus
    `device`.  The threshold counts 1 + the sum of the best cached values
    at or above the current level (totalNumberOfSigs)."""

    def __init__(self, node_count=2048, threshold=1024, pairing_time=2,
                 signature_size=48, timeout=150, candidate_count=50,
                 node_builder_name=None, network_latency_name=None,
                 reply_cap=8, inbox_cap=32, horizon=512, device=None):
        self.threshold = threshold
        self.timeout = timeout
        self._setup(node_count, pairing_time, signature_size,
                    candidate_count, reply_cap, inbox_cap, horizon,
                    node_builder_name, network_latency_name, device)
        self._lvl_idx = torch.arange(self.levels, dtype=I32,
                                     device=self.device)

    def init(self, seed):
        """wittgenstein_tpu/models/sanfermin.py:414-433."""
        n, L, dev = self.node_count, self.levels, self.device
        seed, net = self._init_nodes(seed)

        def zi():
            return torch.zeros(n, dtype=I32, device=dev)

        def zb():
            return torch.zeros(n, dtype=torch.bool, device=dev)
        return net, CapposState(
            seed=seed, cpl=torch.full((n,), self.bits, dtype=I32, device=dev),
            cache_best=torch.zeros((n, L), dtype=I32, device=dev),
            used=zi(), swapping=zb(), pend_val=zi(), pend_lvl=zi(),
            pend_at=zi(), pend_on=zb(), timeout_at=zi(), timeout_lvl=zi(),
            threshold_at=zi(), done=zb())

    def _total(self, cache_best, level):
        """totalNumberOfSigs(level) = 1 + the sum of the best cached
        values at levels >= level
        (wittgenstein_tpu/models/sanfermin.py:435-441)."""
        return 1 + torch.where(self._lvl_idx[None, :] >= level[:, None],
                               cache_best, 0).sum(1, dtype=I32)

    def _enter_level(self, p, nodes, go, t):
        """goNextLevel, cached levels skipped, at most L deep
        (wittgenstein_tpu/models/sanfermin.py:443-472)."""
        ids = self._ids
        send = torch.zeros_like(go)
        again = go
        for _ in range(self.levels):
            total_cur = self._total(p.cache_best, p.cpl)
            hit = again & ~(p.threshold_at > 0) & (total_cur >= self.threshold)
            threshold_at = torch.where(hit, t + 2 * self.pairing_time,
                                       p.threshold_at)
            finish = again & (p.cpl == 0) & ~p.done
            done = p.done | finish
            done_at = torch.where(finish & (nodes.done_at == 0),
                                  max(1, t + 2 * self.pairing_time),
                                  nodes.done_at)
            nodes = nodes.replace(done_at=done_at.to(I32))
            desc = again & ~finish & ~done
            p = p.replace(cpl=torch.where(desc, p.cpl - 1, p.cpl),
                          swapping=p.swapping & ~desc,
                          used=torch.where(desc, 0, p.used), done=done,
                          threshold_at=threshold_at)
            has_cache = gather2d(p.cache_best, ids, p.cpl) > 0
            send = send | (desc & ~has_cache)
            again = desc & has_cache
        return p, nodes, send

    def step(self, p: CapposState, nodes, inbox, t):
        """wittgenstein_tpu/models/sanfermin.py:474-588."""
        n, L, rc = self.node_count, self.levels, self.reply_cap
        ids = self._ids
        alive = ~nodes.down
        replies = torch.zeros((n, rc, 4), dtype=I32, device=ids.device)
        r_cnt = torch.zeros_like(ids)

        swapping, cache = p.swapping, p.cache_best
        pend_val, pend_lvl, pend_at, pend_on = (p.pend_val, p.pend_lvl,
                                                p.pend_at, p.pend_on)
        thr_at = p.threshold_at

        for s in range(inbox.src.shape[1]):
            ok_s = inbox.valid[:, s] & alive
            src = inbox.src[:, s].clamp(0, n - 1)
            kind = inbox.data[:, s, 0]
            lvl = inbox.data[:, s, 1].clamp(0, L - 1)
            val = inbox.data[:, s, 2]
            want_reply = kind == SWAP_ASK

            half = _half(self.bits, lvl)
            is_cand = ok_s & (_cand_base(ids, half) == _own_base(src, half))

            wrong = ok_s & (p.done | (lvl != p.cpl))
            cached = gather2d(cache, ids, lvl)
            replies, r_cnt = _push_reply(replies, r_cnt, ids,
                                         _row(src, 0, lvl, cached),
                                         wrong & want_reply & (cached > 0),
                                         rc)
            # keep for later (putCachedSig): max, not replace
            upd = wrong & ~(want_reply & (cached > 0)) & is_cand
            cache = set2d(cache, ids, lvl, torch.maximum(cached, val), ok=upd)
            hit = upd & ~(thr_at > 0) & \
                (self._total(cache, p.cpl) >= self.threshold)
            thr_at = torch.where(hit, t + 2 * self.pairing_time, thr_at)

            cur = ok_s & ~wrong
            replies, r_cnt = _push_reply(
                replies, r_cnt, ids, _row(src, 0, lvl,
                                          self._total(cache, lvl)),
                cur & want_reply, rc)
            accept = cur & is_cand & ~swapping
            swapping = swapping | accept
            pend_val = torch.where(accept, val, pend_val)
            pend_lvl = torch.where(accept, lvl, pend_lvl)
            pend_at = torch.where(accept, t + self.pairing_time, pend_at)
            pend_on = pend_on | accept

        p = p.replace(swapping=swapping, cache_best=cache,
                      pend_val=pend_val, pend_lvl=pend_lvl, pend_at=pend_at,
                      pend_on=pend_on, threshold_at=thr_at)

        # apply verification: putCachedSig(level, value) + goNextLevel
        due = p.pend_on & (t >= p.pend_at) & ~p.done
        old = gather2d(p.cache_best, ids, p.pend_lvl)
        cache = set2d(p.cache_best, ids, p.pend_lvl,
                      torch.maximum(old, p.pend_val), ok=due)
        p = p.replace(cache_best=cache, pend_on=p.pend_on & ~due)
        hit = due & ~(p.threshold_at > 0) & \
            (self._total(p.cache_best, p.cpl) >= self.threshold)
        p = p.replace(threshold_at=torch.where(
            hit, t + 2 * self.pairing_time, p.threshold_at))
        p, nodes, send = self._enter_level(p, nodes, due, t)

        kick = alive & (t == 1) & (p.cpl == self.bits)
        p, nodes, send0 = self._enter_level(p, nodes, kick, t)
        send = send | send0

        fired = alive & ~p.done & (p.timeout_at > 0) & \
            (t >= p.timeout_at) & (p.cpl == p.timeout_lvl)
        send = (send & alive & ~p.done) | fired

        dest_req, taken = self._pick_batch(ids, p.cpl, p.used,
                                           self.candidate_count)
        dest_req = torch.where(send[:, None], dest_req, -1)
        sent_some = send & (taken > 0)
        # the value sent with a request: totalNumberOfSigs(cpl + 1)
        req_val = self._total(p.cache_best, p.cpl + 1)
        p = p.replace(
            used=torch.where(send, p.used + taken, p.used),
            timeout_at=torch.where(sent_some, t + self.timeout, p.timeout_at),
            timeout_lvl=torch.where(sent_some, p.cpl, p.timeout_lvl))
        out = self._outbox(dest_req, SWAP_ASK, p.cpl, req_val, replies,
                           r_cnt, reply_kind=SWAP_INFO)
        return p, nodes, out


def cont_if_sanfermin(net, pstate):
    """True while a live node is not done
    (wittgenstein_tpu/models/sanfermin.py:594-596)."""
    return (~net.nodes.down & ~pstate.done).any()
