"""OptimisticP2PSignature — signature flooding with verify-at-the-end —
the port of `wittgenstein_tpu/models/optimistic.py`.

Every node floods its own signature; a node forwards each first-seen
signature to all its peers but the sender, +1 ms later and
`fanout_pacing_ms` apart; at `threshold` distinct signatures it stops
accepting new ones and sets doneAt = time + 2 * pairingTime.  State: the
received and pending signatures as [N, W] bitsets and the first sender
of every signature as an [N, N] matrix, which bounds the protocol to
4,096 nodes.  Each ms a node forwards up to `drain_rate` pending
signatures, the lowest ids first.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders, p2p
from ..core import latency as latency_mod
from ..core.protocol import register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import bitset

I32 = torch.int32


def main_params(**overrides):
    """`OptimisticP2PSignature.main`'s configuration (1,000 nodes,
    threshold n/2 + 1, 13 peers, pairing 3) with the distance latency,
    as the JAX package's tests scale it down
    (tests/test_p2psig.py:18-22)."""
    params = dict(node_count=1000, threshold=501, connection_count=13,
                  pairing_time=3,
                  network_latency_name="NetworkLatencyByDistanceWJitter")
    params.update(overrides)
    return params


@register_struct
@dataclasses.dataclass(frozen=True)
class OptSigState(_Struct):
    """wittgenstein_tpu/models/optimistic.py:36-44.  received and pending
    are int32 words."""

    seed: torch.Tensor
    peers: torch.Tensor        # int32 [N, D]
    degree: torch.Tensor       # int32 [N]
    received: torch.Tensor     # [N, W] verifiedSignatures
    pending: torch.Tensor      # [N, W] received, not yet forwarded
    pending_src: torch.Tensor  # int32 [N, N] first sender per sig
    done: torch.Tensor         # bool [N]


@register
class OptimisticP2PSignature:
    """Parameters mirror wittgenstein_tpu/models/optimistic.py:51-89
    (OptimisticP2PSignatureParameters), plus `device` (``cuda`` unless
    the caller asks for another)."""

    # No broadcast is ever sent (core/network._broadcasts).
    sends_broadcast = False

    def __init__(self, node_count=100, threshold=99, connection_count=20,
                 pairing_time=1, node_builder_name=None,
                 network_latency_name=None, max_degree=None, inbox_cap=192,
                 drain_rate=4, fanout_pacing_ms=1, horizon=512,
                 device=None):
        if node_count > 4096:
            raise ValueError("OptimisticP2PSignature keeps an [N, N] "
                             "first-sender matrix; use <= 4096 nodes")
        self.device = resolve_device(device)
        self.node_count = node_count
        self.threshold = threshold
        self.connection_count = connection_count
        self.pairing_time = pairing_time
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.max_degree = max_degree or max(2 * connection_count,
                                            connection_count + 8)
        self.drain_rate = drain_rate
        self.fanout_pacing_ms = fanout_pacing_ms
        self.w = bitset.n_words(node_count)
        # Latencies that would outrun the ring are discarded (the
        # reference's msgDiscardTime) when the ring is large enough that
        # the threshold clears every realistic latency, else clamped
        # (wittgenstein_tpu/models/optimistic.py:76-85).
        discard = horizon - 2 - self.max_degree * fanout_pacing_ms
        cfg_kw = {"msg_discard_time": discard} if discard >= 500 else {}
        self.cfg = EngineConfig(
            n=node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=1, out_deg=self.max_degree * drain_rate,
            bcast_slots=1, **cfg_kw)
        self._fan_cfg = EngineConfig(n=node_count, out_deg=self.max_degree,
                                     payload_words=1)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)

    def __repr__(self):
        return (f"OptimisticP2PSignature(node_count={self.node_count}, "
                f"threshold={self.threshold})")

    def init(self, seed):
        """wittgenstein_tpu/models/optimistic.py:91-108."""
        n, w = self.node_count, self.w
        dev = self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        # P2PNetwork(connectionCount, false): average-degree construction
        peers, degree, _ = p2p.build_peer_graph(
            seed, n, self.connection_count, minimum=False,
            max_degree=self.max_degree, device=dev)
        ids = self._ids
        net = init_net(self.cfg, nodes, seed)
        return net, OptSigState(
            seed=seed, peers=peers, degree=degree,
            received=bitset.one_bit(ids, w), pending=bitset.one_bit(ids, w),
            pending_src=ids[:, None].expand(n, n).clone(),
            done=torch.zeros(n, dtype=torch.bool, device=dev))

    def step(self, p: OptSigState, nodes, inbox, t: int):
        """wittgenstein_tpu/models/optimistic.py:110-190."""
        n, w = self.node_count, self.w
        ids = self._ids
        S = inbox.src.shape[1]

        # Receive every inbox slot at once.  First arrival wins: a slot
        # repeating an earlier slot's signature is a duplicate, which
        # makes the new (node, sig) pairs unique.
        ok = inbox.valid & (~p.done & ~nodes.down)[:, None]    # [N, S]
        sig = inbox.data[:, :, 0].clamp(0, n - 1)              # [N, S]
        src = inbox.src.clamp(0, n - 1)
        earlier = torch.ones((S, S), dtype=torch.bool,
                             device=sig.device).tril(-1)
        dup = ((sig[:, :, None] == sig[:, None, :]) & ok[:, None, :] &
               earlier).any(2)
        word = torch.gather(p.received, 1, (sig >> 5).long())
        had = ((word >> (sig & 31)) & 1) != 0
        new = ok & ~dup & ~had                                 # [N, S]
        # The OR of the new signatures' bits: distinct bits of each row.
        new_words = bitset.bits_of(sig, new, n)
        received = p.received | new_words
        pending = p.pending | new_words
        pending_src = torch.cat(
            [p.pending_src, p.pending_src.new_zeros(n, 1)], 1).scatter(
                1, torch.where(new, sig, n).long(), src)[:, :n]

        # done at threshold: stop accepting new sigs, doneAt = t +
        # 2 * pairing; already queued forwards keep draining.
        count = bitset.popcount(received)
        done_now = ~p.done & (count >= self.threshold)
        done = p.done | done_now
        nodes = nodes.replace(done_at=torch.where(
            done_now & (nodes.done_at == 0),
            max(1, t + 2 * self.pairing_time), nodes.done_at).to(I32))

        # Forward up to drain_rate pending sigs per node per ms (lowest id
        # first), each to all peers but its first sender.
        outs = []
        order = p2p.shuffled_order(p.seed, t, n, self.max_degree)
        for _ in range(self.drain_rate):
            word_has = pending != 0
            has = word_has.any(1)
            first_word = word_has.to(I32).argmax(1).to(I32)
            low = torch.gather(pending, 1, first_word.long()[:, None])[:, 0]
            pick = (first_word * 32 + bitset.lowest_bit(low)).clamp(0, n - 1)
            exclude = torch.gather(pending_src, 1, pick.long()[:, None])[:, 0]
            outs.append(p2p.flood_fanout(
                self._fan_cfg, p.peers, has, exclude, pick[:, None], p.seed,
                t, local_delay=1, delay_between=self.fanout_pacing_ms,
                size=4 + 48, order=order))
            pending = torch.where(has[:, None],
                                  pending & ~bitset.one_bit(pick, w), pending)
        dest, payload, size, delay = (torch.cat(col, 1) for col in zip(*outs))
        out = empty_outbox(self.cfg, ids.device).replace(
            dest=dest, payload=payload, size=size, delay=delay)
        return (p.replace(received=received, pending=pending,
                          pending_src=pending_src, done=done), nodes, out)

    def done_pred(self, pstate, nodes):
        """wittgenstein_tpu/models/optimistic.py:192-193."""
        return (nodes.down | pstate.done).all()


def cont_if_optimistic(net, pstate):
    """wittgenstein_tpu/models/optimistic.py:196-198."""
    live = ~net.nodes.down
    return (live & ~pstate.done).any()
