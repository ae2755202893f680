"""Slush and Snowflake, the Avalanche-family binary-consensus protocols —
the port of `wittgenstein_tpu/models/avalanche.py`.

A colored node queries K distinct random peers for their color; an
uncolored receiver adopts the query's color and starts querying too;
every receiver answers with its current color.  When a querier has K
answers and the other color got more than A*K of them, it flips.  Slush
decides after M rounds; Snowflake keeps a confidence counter (a flip
resets it, a supermajority of its own color increments it) and decides
once it exceeds B.  Each node has one outstanding query, so the answer
bookkeeping is two [N] counters; peers are drawn by counter hashes with
three collision-repair rounds.

The protocol never broadcasts (``sends_broadcast = False``): its inbox
has no broadcast column, and the answer columns of the outbox keep the
JAX width (one per inbox slot and broadcast slot), so every message
keeps its column and its latency draw.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import FAR_FUTURE, register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import prng

I32 = torch.int32
QUERY, ANSWER = 0, 1
TAG_SAMPLE = 0x534C5348


@register_struct
@dataclasses.dataclass(frozen=True)
class AvalancheState(_Struct):
    """wittgenstein_tpu/models/avalanche.py:35-44."""

    seed: torch.Tensor      # int32 scalar
    color: torch.Tensor     # int32 [N]: 0 = uncolored, 1 or 2
    nonce: torch.Tensor     # int32 [N]: current query id (0 = none yet)
    round: torch.Tensor     # int32 [N]: Slush round / Snowflake queries
    cnt: torch.Tensor       # int32 [N]: Snowflake confidence counter
    got1: torch.Tensor      # int32 [N]: answers for color 1, this query
    got2: torch.Tensor      # int32 [N]
    decided: torch.Tensor   # bool [N]


class _AvalancheBase:
    """Shared query/answer machinery; subclasses decide flips and the end
    (wittgenstein_tpu/models/avalanche.py:47-180).  Parameters mirror
    the JAX package's, plus `device` (``cuda`` unless the caller asks
    for another)."""

    # Peers are drawn != self, and answers go to queriers, who are others.
    may_self_send = False
    sends_broadcast = False

    def __init__(self, node_count=100, rounds=5, k=7, alpha=4.0 / 7.0,
                 beta=3, node_builder_name=None, network_latency_name=None,
                 inbox_cap=16, horizon=1024, device=None):
        self.node_count = node_count
        self.rounds = rounds
        self.k = k
        self.ak = alpha * k
        self.beta = beta
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.device = resolve_device(device)
        s = inbox_cap + 1
        self.cfg = EngineConfig(n=node_count, horizon=horizon,
                                inbox_cap=inbox_cap, payload_words=3,
                                out_deg=k + s, bcast_slots=1)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)

    def __repr__(self):
        return (f"{type(self).__name__}(node_count={self.node_count}, "
                f"k={self.k})")

    def init(self, seed):
        """wittgenstein_tpu/models/avalanche.py:65-82: node 0 starts
        with color 1, node 1 with color 2; both query at t == 0."""
        n, dev = self.node_count, self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        net = init_net(self.cfg, nodes, seed)
        ids = self._ids
        color = torch.where(ids == 0, 1, torch.where(ids == 1, 2, 0)).to(I32)
        zero = torch.zeros(n, dtype=I32, device=dev)
        return net, AvalancheState(
            seed=seed, color=color, nonce=zero, round=zero.clone(),
            cnt=zero.clone(), got1=zero.clone(), got2=zero.clone(),
            decided=torch.zeros(n, dtype=torch.bool, device=dev))

    def _sample_peers(self, seed, nonce, n, k):
        """K distinct uniform peers != self per node, a fresh draw per
        (node, nonce), with three collision-repair rounds
        (wittgenstein_tpu/models/avalanche.py:84-105).  Each draw of the
        first round and of the repairs depends only on its round, node
        and column, so all four rounds are drawn at once (one hash
        pipeline over [4, N, K]; the JAX package draws the first round
        column by column and each repair round apart); the repairs then
        apply in order."""
        ids = self._ids[:, None]
        rounds = torch.arange(4, dtype=I32, device=ids.device)
        keys = prng.hash2(seed, TAG_SAMPLE + rounds)[:, None, None]
        jk = torch.arange(k, dtype=I32, device=ids.device)[None, :]
        s = prng.hash3(keys, nonce[:, None] * k + jk, ids)
        rd = prng.uniform_int(s, ids, n - 1)
        rd = rd + (rd >= ids).to(I32)                         # [4, N, K]
        # a repeat of any earlier column of the row
        earlier = torch.ones((k, k), dtype=torch.bool,
                             device=ids.device).tril(-1)
        part = rd[0]
        for r in range(1, 4):
            dup = ((part[:, :, None] == part[:, None, :]) & earlier).any(2)
            part = torch.where(dup, rd[r], part)
        return part                                           # [N, K]

    def step(self, p: AvalancheState, nodes, inbox, t: int):
        """wittgenstein_tpu/models/avalanche.py:107-171."""
        n, k = self.node_count, self.k
        dev = self._ids.device
        s_out = self.cfg.out_deg - k      # answer columns, as in the JAX outbox

        typ = inbox.data[:, :, 0]
        qid = inbox.data[:, :, 1]
        qcolor = inbox.data[:, :, 2].clamp(0, 2)

        # queries: adopt if uncolored, answer each with the current color
        is_q = inbox.valid & (typ == QUERY)
        any_q = is_q.any(1)
        first_q = is_q.to(I32).argmax(1)
        first_color = torch.gather(qcolor, 1, first_q[:, None])[:, 0]
        adopt = any_q & (p.color == 0)
        color = torch.where(adopt, first_color, p.color)
        # answers carry the color after adopting, before any flip
        ans_color = color

        # answers for the current query
        is_a = (inbox.valid & (typ == ANSWER) & (qid == p.nonce[:, None])
                & (p.nonce > 0)[:, None])
        got1 = p.got1 + (is_a & (qcolor == 1)).sum(1, dtype=I32)
        got2 = p.got2 + (is_a & (qcolor == 2)).sum(1, dtype=I32)
        complete = (~p.decided) & (p.nonce > 0) & (got1 + got2 >= k)

        other = torch.where(color == 1, 2, 1).to(I32)
        got_other = torch.where(color == 1, got2, got1)
        got_mine = torch.where(color == 1, got1, got2)
        flip = complete & (got_other > self.ak)
        color = torch.where(flip, other, color)
        p2, requery, decided = self._on_complete(p, complete, flip,
                                                 got_mine, color)

        # answers, one outbox column per inbox slot (dest = querier)
        pad = s_out - inbox.src.shape[1]
        ans_dest = torch.where(is_q, inbox.src, -1)
        ans_dest = torch.cat([ans_dest, ans_dest.new_full((n, pad), -1)], 1)
        ans_payload = torch.stack(
            [torch.full((n, s_out), ANSWER, dtype=I32, device=dev),
             torch.cat([qid, qid.new_zeros((n, pad))], 1),
             ans_color[:, None].expand(n, s_out)], -1)

        # new queries: adopters start their first, the two seeded nodes
        # start at t == 0, completers re-query
        kick = (p.color > 0) if t == 0 else torch.zeros_like(adopt)
        start = (~p.decided) & (adopt | kick | requery) & ~decided
        nonce = torch.where(start, p2.nonce + 1, p2.nonce)
        peers = self._sample_peers(p.seed, nonce, n, k)
        q_dest = torch.where(start[:, None], peers, -1)
        q_payload = torch.stack(
            [torch.full((n, k), QUERY, dtype=I32, device=dev),
             nonce[:, None].expand(n, k), color[:, None].expand(n, k)], -1)

        out = empty_outbox(self.cfg, dev).replace(
            dest=torch.cat([q_dest, ans_dest], 1),
            payload=torch.cat([q_payload, ans_payload], 1))

        done_now = decided & (nodes.done_at == 0)
        nodes = nodes.replace(done_at=torch.where(
            done_now, max(t, 1), nodes.done_at).to(I32))
        reset = complete | start
        return (p2.replace(color=color, nonce=nonce,
                           got1=torch.where(reset, 0, got1),
                           got2=torch.where(reset, 0, got2),
                           decided=p2.decided | decided),
                nodes, out)

    def next_action_time(self, p, nodes, t):
        """Quiet-window oracle half (wittgenstein_tpu/models/avalanche.py:
        173-180): the two seeded nodes' first query at t == 0 is the only
        timer; re-queries fire on an answer's arrival, which the
        engine's ring term sees."""
        return torch.full((), 0 if t <= 0 else FAR_FUTURE, dtype=I32,
                          device=nodes.down.device)

    def colors(self, p):
        return p.color


@register
class Slush(_AvalancheBase):
    """M rounds of K-sample queries, then decide
    (wittgenstein_tpu/models/avalanche.py:183-196): a node completes
    M + 1 queries in all."""

    def _on_complete(self, p, complete, flip, got_mine, color):
        round2 = torch.where(complete, p.round + 1, p.round)
        requery = complete & (round2 <= self.rounds)
        decided = complete & (round2 > self.rounds)
        return p.replace(round=round2), requery, decided


@register
class Snowflake(_AvalancheBase):
    """Confidence counter beta before deciding
    (wittgenstein_tpu/models/avalanche.py:199-210)."""

    def _on_complete(self, p, complete, flip, got_mine, color):
        cnt = torch.where(complete & flip, 0,
                          torch.where(complete & (got_mine > self.ak),
                                      p.cnt + 1, p.cnt))
        decided = complete & (cnt > self.beta)
        requery = complete & ~decided
        return p.replace(cnt=cnt), requery, decided
