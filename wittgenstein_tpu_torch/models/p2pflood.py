"""P2PFlood — flood routing on a random peer graph — ported from
`wittgenstein_tpu/models/p2pflood.py`.

A node that receives a flood message it has not seen forwards it to all
its peers but the sender, after `delay_before_resent` ms and with
`delay_between_sends` ms between consecutive peers (protocols/
P2PFlood.java, core/messages/FloodMessage.java).  The first
`dead_node_count` nodes are down.  A node is done when it has received
`msg_to_receive` distinct floods.  State: [N, M] received and pending
matrices (M distinct floods); each node forwards one pending message id
a ms, so every live node with news fans out every ms, to up to
`max_degree` peers.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders, p2p
from ..core import latency as latency_mod
from ..core.protocol import FAR_FUTURE, register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import prng

I32 = torch.int32
TAG_SENDERS = 0x464C4453


def quiet_params(n=256):
    """`bench.py` `bench_quiet`'s P2PFlood line at `n` nodes: a tenth of
    them down, 8 peers, 1-ms resend and stagger delays."""
    return dict(node_count=n, dead_node_count=n // 10, peers_count=8,
                delay_before_resent=1, delay_between_sends=1)


@register_struct
@dataclasses.dataclass(frozen=True)
class P2PFloodState(_Struct):
    """wittgenstein_tpu/models/p2pflood.py:32-39."""

    seed: torch.Tensor         # int32 scalar: for the fan-out shuffle draws
    peers: torch.Tensor        # int32 [N, D]
    degree: torch.Tensor       # int32 [N]
    received: torch.Tensor     # bool [N, M]
    pending: torch.Tensor      # bool [N, M]: received, not yet forwarded
    pending_src: torch.Tensor  # int32 [N, M]: who sent it to us (-1: nobody)


@register
class P2PFlood:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    p2pflood.py:50-86), plus `device` (``cuda`` unless the caller asks
    for another)."""

    # Every dest comes from the peer graph, which skips self.
    may_self_send = False

    def __init__(self, node_count=100, dead_node_count=10,
                 delay_before_resent=50, msg_count=1, msg_to_receive=None,
                 peers_count=10, delay_between_sends=30,
                 node_builder_name=None, network_latency_name=None,
                 max_degree=None, inbox_cap=16, horizon=None, device=None):
        if msg_count > node_count - dead_node_count:
            raise ValueError(
                f"msg_count={msg_count} needs that many live senders; only "
                f"{node_count - dead_node_count} nodes are up")
        self.node_count = node_count
        self.dead_node_count = dead_node_count
        self.delay_before_resent = delay_before_resent
        self.msg_count = msg_count
        self.msg_to_receive = (msg_count if msg_to_receive is None
                               else min(msg_to_receive, msg_count))
        self.peers_count = peers_count
        self.delay_between_sends = delay_between_sends
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.device = resolve_device(device)
        self.max_degree = max_degree or max(4 * peers_count, peers_count + 16)
        if horizon is None:
            # The ring holds the whole stagger schedule plus a latency
            # allowance, or arrivals get clamped.
            need = (delay_before_resent
                    + delay_between_sends * self.max_degree + 1024)
            horizon = 1 << (need - 1).bit_length()
        self.cfg = EngineConfig(
            n=node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=1, out_deg=self.max_degree, bcast_slots=1)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)

    def __repr__(self):
        return (f"P2PFlood(node_count={self.node_count}, "
                f"dead_node_count={self.dead_node_count}, "
                f"peers_count={self.peers_count})")

    def init(self, seed):
        """wittgenstein_tpu/models/p2pflood.py:88-119."""
        n, m, dev = self.node_count, self.msg_count, self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        down = self._ids < self.dead_node_count
        nodes = nodes.replace(down=down)
        peers, degree, _ = p2p.build_peer_graph(
            seed, n, self.peers_count, minimum=True,
            max_degree=self.max_degree, device=dev)
        # msg_count distinct random live senders, by a per-seed hash
        pri = prng.uniform_u32(prng.hash2(seed, TAG_SENDERS), self._ids)
        pri = torch.where(down, 0xFFFFFFFF, pri)
        senders = torch.argsort(pri, stable=True)[:m]
        received = torch.zeros((n, m), dtype=torch.bool, device=dev)
        received[senders, torch.arange(m, device=dev)] = True
        if m == 1:
            done_at = nodes.done_at.clone()
            done_at[senders] = 1
            nodes = nodes.replace(done_at=done_at)
        net = init_net(self.cfg, nodes, seed)
        return net, P2PFloodState(
            seed=seed, peers=peers, degree=degree, received=received,
            pending=received.clone(),
            pending_src=torch.full((n, m), -1, dtype=I32, device=dev))

    def step(self, pstate, nodes, inbox, t):
        """wittgenstein_tpu/models/p2pflood.py:121-162."""
        m = self.msg_count
        s = inbox.src.shape[1]
        msgid = inbox.data[:, :, 0].clamp(0, m - 1).long()
        # First arrival wins per (node, msg): scatter-min of the slot
        # index (slots are in delivery order).
        slot = torch.arange(s, dtype=I32, device=msgid.device)
        slot_w = torch.where(inbox.valid, slot, s)
        first = torch.full((self.node_count, m), s, dtype=I32,
                           device=msgid.device).scatter_reduce(
            1, msgid, slot_w, "amin", include_self=True)
        arrived = first < s
        src = torch.gather(inbox.src, 1, first.clamp(0, s - 1).long())

        new = arrived & ~pstate.received
        received = pstate.received | arrived
        pending = pstate.pending | new
        pending_src = torch.where(new, src, pstate.pending_src)

        # Forward one pending msg id per node per ms, the lowest first.
        has = pending.any(1)
        pick = pending.to(I32).argmax(1)[:, None]
        exclude = torch.gather(pending_src, 1, pick)[:, 0]
        dest, pl, size, delay = p2p.flood_fanout(
            self.cfg, pstate.peers, has, exclude, pick.to(I32),
            pstate.seed, t, local_delay=self.delay_before_resent,
            delay_between=self.delay_between_sends)
        pending = pending.scatter(
            1, pick, torch.gather(pending, 1, pick) & ~has[:, None])
        out = empty_outbox(self.cfg, msgid.device).replace(
            dest=dest, payload=pl, size=size, delay=delay)

        # doneAt = the time the count reaches the target; never
        # overwrite an earlier doneAt.
        count = received.sum(1)
        done_now = (count >= self.msg_to_receive) & (nodes.done_at == 0)
        nodes = nodes.replace(done_at=torch.where(
            done_now, max(t, 1), nodes.done_at).to(I32))
        return (pstate.replace(received=received, pending=pending,
                               pending_src=pending_src), nodes, out)

    def next_action_time(self, pstate, nodes, t):
        """Quiet-window oracle half (wittgenstein_tpu/models/p2pflood.py:
        164-174): a node with a pending flood forwards this ms; with none
        anywhere the next event is an arrival; t == 0 is pinned."""
        act_now = pstate.pending.any() | (t <= 0)
        return torch.where(act_now, t, FAR_FUTURE).to(I32)
