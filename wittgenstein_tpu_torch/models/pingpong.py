"""PingPong — the reference's sample protocol, ported from
`wittgenstein_tpu/models/pingpong.py`.

A witness node broadcasts a Ping to every node at t = 0; each node
replies with a Pong to the ping's sender; the witness counts the Pongs.
It is the first ported protocol that broadcasts (``bcast_slots=2``);
its pongs are unicasts, binned by the route kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders
from ..core.latency import NetworkLatencyByDistanceWJitter, get_by_name
from ..core.protocol import FAR_FUTURE, register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)

I32 = torch.int32
PING, PONG = 0, 1


@register_struct
@dataclasses.dataclass(frozen=True)
class PingPongState(_Struct):
    """wittgenstein_tpu/models/pingpong.py:23-25."""

    pongs: torch.Tensor     # int32 scalar: pongs seen by the witness


@register
class PingPong:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    pingpong.py:28-55), plus `device` (``cuda`` unless the caller asks
    for another)."""

    def __init__(self, node_count=1000, witness=0, latency=None,
                 node_builder=None, inbox_cap=32,
                 network_latency_name=None, device=None):
        self.node_count = node_count
        self.witness = witness
        if latency is not None and network_latency_name is not None:
            raise ValueError(
                "PingPong: pass either latency (an instance) or "
                "network_latency_name (a registry name), not both")
        if network_latency_name is not None:
            latency = get_by_name(network_latency_name)
        self.latency = latency or NetworkLatencyByDistanceWJitter()
        self.builder = node_builder or builders.NodeBuilder()
        self.device = resolve_device(device)
        # The witness's inbox must hold the pongs of its busiest ms (a
        # dozen at 1000 nodes under the distance model; every pong when a
        # constant latency lands them all on one ms).
        self.cfg = EngineConfig(n=node_count, horizon=1024,
                                inbox_cap=inbox_cap, payload_words=1,
                                out_deg=1, bcast_slots=2)
        self._ids = torch.arange(node_count, dtype=I32, device=self.device)

    def __repr__(self):
        return f"PingPong(node_count={self.node_count})"

    def init(self, seed):
        seed = torch.as_tensor(seed, device=self.device).to(I32)
        nodes = self.builder.build(seed, self.node_count, self.device)
        net = init_net(self.cfg, nodes, seed)
        return net, PingPongState(
            pongs=torch.zeros((), dtype=I32, device=self.device))

    def step(self, pstate, nodes, inbox, t):
        """wittgenstein_tpu/models/pingpong.py:62-97."""
        n = self.cfg.n
        dev = inbox.src.device
        is_witness = self._ids == self.witness
        # t == 0: the witness sends a Ping to all.  On a Ping: reply a
        # Pong to the first ping's sender.
        is_ping = inbox.valid & (inbox.data[:, :, 0] == PING)
        any_ping = is_ping.any(1)
        first = is_ping.to(I32).argmax(1)
        ping_src = torch.gather(inbox.src, 1, first[:, None])[:, 0]
        out = empty_outbox(self.cfg, dev).replace(
            bcast=is_witness & (t == 0),
            bcast_payload=torch.full((n, 1), PING, dtype=I32, device=dev),
            dest=torch.where(any_ping, ping_src, -1)[:, None],
            payload=torch.full((n, 1, 1), PONG, dtype=I32, device=dev))

        # The witness counts Pongs.
        is_pong = inbox.valid & (inbox.data[:, :, 0] == PONG)
        got = (is_witness[:, None] & is_pong).sum(dtype=I32)
        pstate = pstate.replace(pongs=pstate.pongs + got)

        # doneAt: a replier is done once it has ponged, the witness once
        # it has seen every pong (so `cont_until_done` drives PingPong).
        finished = torch.where(is_witness, pstate.pongs >= self.node_count,
                               any_ping)
        done_at = torch.where(finished & (nodes.done_at == 0), t,
                              nodes.done_at)
        return pstate, nodes.replace(done_at=done_at), out

    def next_action_time(self, pstate, nodes, t):
        """The witness's sendAll at t == 0 is PingPong's only timer;
        everything later is delivery-driven, which the engine's ring and
        broadcast terms see (wittgenstein_tpu/models/pingpong.py:99-107)."""
        return torch.full((), 0 if t <= 0 else FAR_FUTURE, dtype=I32,
                          device=nodes.down.device)

    def done(self, pstate, nodes):
        return pstate.pongs >= self.node_count
