"""Paxos — classic two-phase consensus with competing proposers — the
port of `wittgenstein_tpu/models/paxos.py`.

Proposers send Propose(seq) to every acceptor; an acceptor agrees to the
highest seq it has seen and reports any value it accepted; on a majority
of agrees the proposer commits (the highest reported value, else its
own); an acceptor accepts a commit that matches its agreed seq; a
majority of accepts decides the proposer.  Majorities of rejects, or a
timeout, restart a proposal with a higher seq.  Acceptors are ids
[0, A), proposers [A, A+P); -1 stands for the reference's `null`.

Inbox slots are handled one after another, in delivery order, as the
JAX package's unrolled slot loop handles them; the reply to slot s goes
to outbox column s.  With `step_hint` (the deepest valid slot of any
node this ms, read from the device) the loop stops there: every slot
past it is invalid on every node, so its handling is the identity.  The protocol never broadcasts
(``sends_broadcast = False``): the outbox keeps the JAX width, so every
message keeps its column and its latency draw.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders
from ..core import latency as latency_mod
from ..core.protocol import register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import prng

I32 = torch.int32
PROPOSE, REJECT, AGREE, COMMIT, ACCEPT, REJECT2 = range(6)
MAX_VAL = 1000
TAG_VAL = 0x50415856


@register_struct
@dataclasses.dataclass(frozen=True)
class PaxosState(_Struct):
    """wittgenstein_tpu/models/paxos.py:43-67."""

    # acceptors (valid on ids < A)
    max_agreed: torch.Tensor      # int32 [N], init -1
    accepted_seq: torch.Tensor    # int32 [N], -1 = null
    accepted_val: torch.Tensor    # int32 [N], -1 = null
    # proposers (valid on ids >= A)
    value_proposed: torch.Tensor  # int32 [N]
    value_accepted: torch.Tensor  # int32 [N], -1 = null
    acc_seq_ip: torch.Tensor      # int32 [N], -1 = null
    acc_val_ip: torch.Tensor      # int32 [N], -1 = null
    seq_ip: torch.Tensor          # int32 [N]
    seq_accepted: torch.Tensor    # int32 [N]
    agree_ip: torch.Tensor        # int32 [N]
    rej1_ip: torch.Tensor
    accept_ip: torch.Tensor
    rej2_ip: torch.Tensor
    proposal_ip: torch.Tensor     # bool [N]
    timeout_at: torch.Tensor      # int32 [N], 0 = none
    # statistics (ProposerNode counters)
    agree_count: torch.Tensor
    rej1_count: torch.Tensor
    rej2_count: torch.Tensor
    timeout_count: torch.Tensor


def _stack4(a, b, c, d):
    """The four payload words, broadcast against each other, as [..., 4]
    int32; `a` may be a Python int."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return torch.stack(torch.broadcast_tensors(a, b, c, d), -1).to(I32)


@register
class Paxos:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    paxos.py:70-92, Paxos.PaxosParameters), plus `device` (``cuda``
    unless the caller asks for another)."""

    sends_broadcast = False

    def __init__(self, acceptor_count=3, proposer_count=3, timeout=1000,
                 node_builder_name=None, network_latency_name=None,
                 inbox_cap=16, horizon=2048, device=None):
        self.a = acceptor_count
        self.p = proposer_count
        self.n = acceptor_count + proposer_count
        self.majority = acceptor_count // 2 + 1
        self.timeout = timeout
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.device = resolve_device(device)
        s = inbox_cap + 1
        self.cfg = EngineConfig(n=self.n, horizon=horizon,
                                inbox_cap=inbox_cap, payload_words=4,
                                out_deg=s + acceptor_count, bcast_slots=1)
        self.node_count = self.n
        self._ids = torch.arange(self.n, dtype=I32, device=self.device)

    def __repr__(self):
        return f"Paxos(acceptor_count={self.a}, proposer_count={self.p})"

    def init(self, seed):
        """wittgenstein_tpu/models/paxos.py:97-117."""
        n, dev = self.n, self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        net = init_net(self.cfg, nodes, seed)
        neg = torch.full((n,), -1, dtype=I32, device=dev)
        zero = torch.zeros(n, dtype=I32, device=dev)
        vals = prng.uniform_int(prng.hash2(seed, TAG_VAL), self._ids, MAX_VAL)
        return net, PaxosState(
            max_agreed=neg, accepted_seq=neg.clone(),
            accepted_val=neg.clone(), value_proposed=vals,
            value_accepted=neg.clone(), acc_seq_ip=neg.clone(),
            acc_val_ip=neg.clone(), seq_ip=zero, seq_accepted=zero.clone(),
            agree_ip=zero.clone(), rej1_ip=zero.clone(),
            accept_ip=zero.clone(), rej2_ip=zero.clone(),
            proposal_ip=torch.zeros(n, dtype=torch.bool, device=dev),
            timeout_at=zero.clone(), agree_count=zero.clone(),
            rej1_count=zero.clone(), rej2_count=zero.clone(),
            timeout_count=zero.clone())

    def _next_seq(self, p: PaxosState, start):
        """startNextProposal's seq partitioning
        (wittgenstein_tpu/models/paxos.py:119-126)."""
        rank = self._ids - self.a
        gap = p.seq_accepted % self.p
        new_seq = p.seq_accepted + self.p - gap + rank
        seq = torch.where(new_seq > p.seq_ip, new_seq, p.seq_ip + self.p)
        return torch.where(start, seq, p.seq_ip)

    def step_hint(self, p, inbox, t: int):
        """The deepest valid inbox slot of any node (of any run of a
        batch) this ms, plus one: the slots the loop must walk."""
        s = inbox.valid.shape[-1]
        depth = torch.where(inbox.valid, torch.arange(
            1, s + 1, dtype=I32, device=inbox.valid.device), 0).max()
        return int(depth)

    def step(self, p: PaxosState, nodes, inbox, t: int, step_hint=None):
        """wittgenstein_tpu/models/paxos.py:128-241."""
        n, A = self.n, self.a
        dev = self._ids.device
        is_prop = self._ids >= A
        s_out = self.cfg.out_deg - A      # reply columns, as in the JAX outbox
        depth = inbox.src.shape[1] if step_hint is None else step_hint
        zeros = torch.zeros(n, dtype=I32, device=dev)

        replies = []                      # (dest [N], payload [N, 4]) a slot
        start = torch.zeros(n, dtype=torch.bool, device=dev)
        commit = torch.zeros_like(start)

        # onTimeout fires before this ms's messages
        fire = is_prop & p.proposal_ip & (p.timeout_at > 0) & \
            (t >= p.timeout_at)
        p = p.replace(proposal_ip=torch.where(fire, False, p.proposal_ip),
                      timeout_count=p.timeout_count + fire.to(I32))
        start = start | fire
        done_at = nodes.done_at

        for s in range(depth):
            valid = inbox.valid[:, s]
            src = inbox.src[:, s].clamp(0, n - 1)
            typ = inbox.data[:, s, 0]
            a1 = inbox.data[:, s, 1]
            a2 = inbox.data[:, s, 2]
            a3 = inbox.data[:, s, 3]

            # acceptor: onPropose
            m = valid & ~is_prop & (typ == PROPOSE)
            rej = m & (a1 < p.max_agreed)
            agr = m & (a1 > p.max_agreed)
            r_dest = torch.where(rej | agr, src, -1)
            r_pay = torch.where(
                rej[:, None], _stack4(REJECT, a1, p.max_agreed, zeros),
                torch.where(agr[:, None],
                            _stack4(AGREE, a1, p.accepted_seq,
                                    p.accepted_val),
                            torch.zeros((n, 4), dtype=I32, device=dev)))
            p = p.replace(max_agreed=torch.where(agr, a1, p.max_agreed))

            # acceptor: onCommit
            m = valid & ~is_prop & (typ == COMMIT)
            bad = m & ((a1 != p.max_agreed) |
                       ((p.accepted_val >= 0) & (p.accepted_val != a2)))
            good = m & ~bad
            r_dest = torch.where(bad | good, src, r_dest)
            r_pay = torch.where(
                bad[:, None], _stack4(REJECT2, a1, p.max_agreed, zeros),
                torch.where(good[:, None], _stack4(ACCEPT, a1, zeros, zeros),
                            r_pay))
            p = p.replace(
                accepted_val=torch.where(good, a2, p.accepted_val),
                accepted_seq=torch.where(
                    good, torch.maximum(p.accepted_seq, a1), p.accepted_seq))
            replies.append((r_dest, r_pay))

            # proposer: onReject, onRejectOnCommit
            for tcode, cnt_name, stat_name in (
                    (REJECT, "rej1_ip", "rej1_count"),
                    (REJECT2, "rej2_ip", "rej2_count")):
                m = valid & is_prop & (typ == tcode) & (a1 == p.seq_ip)
                cnt = getattr(p, cnt_name) + m.to(I32)
                hit = m & (cnt == self.majority)
                p = p.replace(**{
                    cnt_name: cnt,
                    stat_name: getattr(p, stat_name) + hit.to(I32)})
                p = p.replace(
                    proposal_ip=torch.where(hit, False, p.proposal_ip),
                    seq_accepted=torch.where(
                        hit, torch.maximum(p.seq_accepted, a2),
                        p.seq_accepted))
                start = start | hit

            # proposer: onAgree
            m = valid & is_prop & (typ == AGREE) & (a1 == p.seq_ip) & \
                (p.agree_ip < self.majority)
            take = m & (a2 >= 0) & ((p.acc_seq_ip < 0) |
                                    (p.acc_seq_ip < a2))
            agree_ip = p.agree_ip + m.to(I32)
            maj = m & (agree_ip >= self.majority)
            p = p.replace(
                agree_ip=agree_ip,
                acc_seq_ip=torch.where(take, a2, p.acc_seq_ip),
                acc_val_ip=torch.where(take, a3, p.acc_val_ip),
                agree_count=p.agree_count + maj.to(I32))
            p = p.replace(acc_val_ip=torch.where(
                maj & (p.acc_val_ip < 0), p.value_proposed, p.acc_val_ip))
            commit = commit | maj

            # proposer: onAccept
            m = valid & is_prop & (typ == ACCEPT) & (a1 == p.seq_ip) & \
                (p.accept_ip < self.majority)
            accept_ip = p.accept_ip + m.to(I32)
            dec = m & (accept_ip >= self.majority)
            p = p.replace(
                accept_ip=accept_ip,
                proposal_ip=torch.where(dec, False, p.proposal_ip),
                value_accepted=torch.where(dec, p.acc_val_ip,
                                           p.value_accepted))
            done_at = torch.where(dec & (done_at == 0), max(t, 1), done_at)
        nodes = nodes.replace(done_at=done_at.to(I32))

        # init: every proposer starts at t == 0
        if t == 0:
            start = start | is_prop
        start = start & (p.value_accepted < 0)

        # startNextProposal
        seq_ip = self._next_seq(p, start)
        p = p.replace(
            seq_ip=seq_ip,
            acc_seq_ip=torch.where(start, -1, p.acc_seq_ip),
            acc_val_ip=torch.where(start, -1, p.acc_val_ip),
            proposal_ip=p.proposal_ip | start,
            agree_ip=torch.where(start, 0, p.agree_ip),
            rej1_ip=torch.where(start, 0, p.rej1_ip),
            accept_ip=torch.where(start, 0, p.accept_ip),
            rej2_ip=torch.where(start, 0, p.rej2_ip),
            timeout_at=torch.where(start, t + 1 + self.timeout,
                                   p.timeout_at))

        # Propose on start, Commit on an agree majority, to every acceptor
        bcast = start | commit
        acc_ids = torch.arange(A, dtype=I32, device=dev)[None, :].expand(n, A)
        b_dest = torch.where(bcast[:, None], acc_ids, -1)
        b_typ = torch.where(start, PROPOSE, COMMIT)
        b_pay = _stack4(b_typ[:, None], p.seq_ip[:, None],
                        p.acc_val_ip[:, None],
                        torch.zeros((n, A), dtype=I32, device=dev))

        pad = s_out - len(replies)
        r_dest = torch.stack([d for d, _ in replies] +
                             [torch.full((n,), -1, dtype=I32, device=dev)]
                             * pad, 1)
        r_pay = torch.stack([q for _, q in replies] +
                            [torch.zeros((n, 4), dtype=I32, device=dev)]
                            * pad, 1)
        out = empty_outbox(self.cfg, dev).replace(
            dest=torch.cat([r_dest, b_dest], 1),
            payload=torch.cat([r_pay, b_pay], 1))
        return p, nodes, out

    def done(self, pstate, nodes):
        """wittgenstein_tpu/models/paxos.py:268-269."""
        return (pstate.value_accepted[self.a:] >= 0).all()

    def cont_if(self):
        """Continue while any proposer has no accepted value
        (wittgenstein_tpu/models/paxos.py:271-275)."""
        a = self.a
        return lambda net, pstate: (pstate.value_accepted[a:] < 0).any()
