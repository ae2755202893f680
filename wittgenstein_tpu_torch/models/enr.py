"""ENRGossiping — EIP-778 node-record gossip with peer rewiring and churn
— the port of `wittgenstein_tpu/models/enr.py`.

Nodes carry a set of capabilities and gossip versioned records every
`cap_gossip_time` ms; a newer record replaces an older one.  On a record
from a node it is not linked to, a node connects if that adds capability
value, evicting its least valuable peer when it is full.  A fraction of
the nodes re-roll their capabilities every `time_to_change`; a joiner
slot comes up every `time_to_leave / 8` and leaves again later.  A node
is done when each of its capabilities has at least 3 matching peers and
its capability subgraph reaches half of that capability's live holders;
its doneAt counts from its start.

The reachability test is a transitive closure of the capability-
restricted adjacency, by repeated squaring of float32 0/1 [N, N]
matrices (plain products, exact: every sum is an integer of at most N),
one batched product for all capabilities at once.  The JAX package's
``.at[].set(mode="drop")`` scatters become one-hot selects where each
row writes one cell (the record, link and removal updates of the
receive loop), a scatter into a dump column that is sliced off where a
row writes several distinct cells (the joiners' links and the rebuilt
peer lists: their targets are distinct, only dropped writes share the
dump column), and an idempotent scatter of ``True`` for the edge
matrix, where repeated indices write the same value.

Inbox slots are handled one after another, as in the JAX package.
`step_hint` reads three facts of the ms from the device, and the step
leaves out what they show to be the identity on every node: the receive
loop stops at the deepest valid slot of any node (every later slot is
invalid), the joiners' links are skipped when no joiner comes up, and
the capability draw when no change is due.  Churn changes
liveness inside the step (``mutates_liveness``: no superstep), and the
protocol never broadcasts (``sends_broadcast = False``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders, p2p
from ..core import latency as latency_mod
from ..core.protocol import register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import prng

I32 = torch.int32
TAG_CAPS = 0x454E4330
TAG_JOIN = 0x454E4331
TAG_EXIT = 0x454E4332
TAG_GOSS = 0x454E4333
TAG_CHG = 0x454E4334
TAG_CHG_START = 0x454E4336

PEERS_PER_CAP = 3


def _draw_caps(seed, n, n_caps, cap_per_node, device):
    """capPerNode distinct capabilities per node: the ranks of a per-
    (node, capability) hash below capPerNode
    (wittgenstein_tpu/models/enr.py:52-62)."""
    pri = prng.uniform_u32(seed, torch.arange(
        n * n_caps, dtype=I32, device=device)).reshape(n, n_caps)
    order = torch.argsort(pri, dim=1, stable=True)
    rank = torch.argsort(order, dim=1)          # the inverse permutation
    return rank < cap_per_node


def _onehot(idx, width):
    """[N, width] bool: row i true at column idx[i]."""
    return torch.arange(width, device=idx.device)[None, :] == idx[:, None]


def _set_rows(table, cols, vals, width):
    """``table[i, cols[i, j]] = vals[i, j]`` for cols in [0, width], width
    meaning dropped: a scatter into a dump column that is then sliced
    off.  The kept columns of a row must be distinct."""
    pad = torch.cat([table, table[:, :1]], 1)
    return pad.scatter(1, cols.long(), vals)[:, :width]


@register_struct
@dataclasses.dataclass(frozen=True)
class ENRState(_Struct):
    """wittgenstein_tpu/models/enr.py:65-79."""

    seed: torch.Tensor
    caps: torch.Tensor          # bool [N, C]
    peers: torch.Tensor         # int32 [N, D] (mutable adjacency)
    degree: torch.Tensor        # int32 [N]
    seq: torch.Tensor           # int32 [N]: own record sequence number
    seen_seq: torch.Tensor      # int32 [N, N]: newest seq seen per source
    pending: torch.Tensor       # bool [N, N]: records to forward
    pending_src: torch.Tensor   # int32 [N, N]: who delivered each record
    join_at: torch.Tensor       # int32 [N] (0 = initial member)
    exit_at: torch.Tensor       # int32 [N] (0 = never leaves)
    start_time: torch.Tensor    # int32 [N]
    gossip_start: torch.Tensor  # int32 [N]
    change_start: torch.Tensor  # int32 [N] (0 = never changes caps)


@register
class ENRGossiping:
    """Parameters mirror the JAX package's (wittgenstein_tpu/models/
    enr.py:82-134, ENRParameters), plus `device` (``cuda`` unless the
    caller asks for another)."""

    mutates_liveness = True
    sends_broadcast = False

    def __init__(self, time_to_change=60_000, cap_gossip_time=10_000,
                 discard_time=100, time_to_leave=60_000, total_peers=5,
                 nodes=50, changing_nodes=10.0, max_peers=50,
                 number_of_different_capabilities=5, cap_per_node=3,
                 node_builder_name=None, network_latency_name=None,
                 join_slots=None, inbox_cap=16, horizon=1024, device=None):
        if cap_per_node > number_of_different_capabilities:
            raise ValueError("capPerNode > numberOfDifferentCapabilities")
        self.n_initial = nodes
        self.time_to_change = max(1, time_to_change)
        self.cap_gossip_time = max(1, cap_gossip_time)
        self.discard_time = discard_time        # inert, as in the reference
        self.time_to_leave = max(8, time_to_leave)
        self.total_peers = total_peers
        self.changing_nodes = changing_nodes
        self.max_peers = max_peers
        self.n_caps = number_of_different_capabilities
        self.cap_per_node = cap_per_node
        self.join_slots = 8 if join_slots is None else join_slots
        self.node_count = nodes + self.join_slots
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.device = resolve_device(device)
        self.arena_deg = max(max_peers, 4 * total_peers, total_peers + 16)
        self.cfg = EngineConfig(
            n=self.node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=2, out_deg=self.arena_deg, bcast_slots=1)
        self._ids = torch.arange(self.node_count, dtype=I32,
                                 device=self.device)

    def __repr__(self):
        return (f"ENRGossiping(nodes={self.n_initial}, "
                f"join_slots={self.join_slots})")

    def init(self, seed):
        """wittgenstein_tpu/models/enr.py:136-199."""
        n, ni, C, D = (self.node_count, self.n_initial, self.n_caps,
                       self.arena_deg)
        dev = self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        ids = self._ids
        nodes = self.builder.build(seed, n, dev)
        is_joiner = ids >= ni
        nodes = nodes.replace(down=is_joiner)

        caps = _draw_caps(prng.hash2(seed, TAG_CAPS), n, C,
                          self.cap_per_node, dev)
        # the initial graph over the ni live nodes only
        peers_i, _, _ = p2p.build_peer_graph(
            seed, ni, self.total_peers, minimum=True, max_degree=D,
            device=dev)
        peers = torch.cat([peers_i, torch.full((n - ni, D), -1, dtype=I32,
                                               device=dev)])
        degree = (peers >= 0).sum(1, dtype=I32)

        k = (ids - ni).clamp_min(0)
        join_at = torch.where(is_joiner, (k + 1) * (self.time_to_leave // 8),
                              0).to(I32)
        exit_rand = prng.uniform_int(prng.hash2(seed, TAG_EXIT), ids,
                                     self.time_to_leave)
        exit_at = torch.where(is_joiner, join_at + exit_rand.clamp_min(1),
                              0).to(I32)
        goss = prng.uniform_int(prng.hash2(seed, TAG_GOSS), ids,
                                self.cap_gossip_time)
        gossip_start = (join_at + goss + 1).to(I32)

        # the changing set is drawn from the first totalPeers ids (the
        # reference's quirk)
        n_chg = min(int(self.total_peers * self.changing_nodes),
                    self.total_peers)
        chg = torch.zeros(n, dtype=torch.bool, device=dev)
        if n_chg > 0:
            pri = prng.uniform_u32(prng.hash2(seed, TAG_CHG), torch.arange(
                self.total_peers, dtype=I32, device=dev))
            chg[torch.argsort(pri, stable=True)[:n_chg]] = True
        chg_start = prng.uniform_int(prng.hash2(seed, TAG_CHG_START), ids,
                                     self.time_to_change) + 1
        change_start = torch.where(chg, chg_start, 0).to(I32)

        net = init_net(self.cfg, nodes, seed)
        return net, ENRState(
            seed=seed, caps=caps, peers=peers, degree=degree,
            seq=torch.zeros(n, dtype=I32, device=dev),
            seen_seq=torch.full((n, n), -1, dtype=I32, device=dev),
            pending=torch.zeros((n, n), dtype=torch.bool, device=dev),
            pending_src=torch.full((n, n), -1, dtype=I32, device=dev),
            join_at=join_at, exit_at=exit_at, start_time=join_at.clone(),
            gossip_start=gossip_start, change_start=change_start)

    # ------------------------------------------------------------------

    @staticmethod
    def _score_counts(peers, caps):
        """cnt[i, c]: how many of i's peers hold capability c."""
        peer_caps = (peers >= 0)[..., None] & caps[peers.clamp_min(0).long()]
        return peer_caps.sum(1, dtype=I32)                     # [N, C]

    @staticmethod
    def _score_of(caps, cnt):
        """score(peers) (wittgenstein_tpu/models/enr.py:209-215): a
        capability held by k matching peers counts k * min(k, 3)."""
        return torch.where(caps, cnt * cnt.clamp_max(PEERS_PER_CAP),
                           0).sum(-1, dtype=I32)

    def _fully_connected(self, caps, peers, down, adj):
        """isFullyConnected (wittgenstein_tpu/models/enr.py:217-249):
        score maxed and each own capability's subgraph reaching at least
        half its live holders; `adj` is the symmetric [N, N] edge
        matrix."""
        n = self.node_count
        alive = ~down
        score_ok = self._score_of(caps, self._score_counts(peers, caps)) \
            >= caps.sum(1, dtype=I32) * PEERS_PER_CAP
        m = (caps & alive[:, None]).T                          # [C, N]
        f32 = torch.float32
        # r[c, i, j]: j reachable from i through the cap-c subgraph,
        # starting from i's cap-c peers; squaring the adjacency too
        # covers a diameter of N in log2(N) steps
        r = (adj[None] & m[:, None, :]).to(f32)
        ac = (adj[None] & m[:, None, :] & m[:, :, None]).to(f32)
        for _ in range(max(1, (n - 1).bit_length())):
            r = (r + r @ ac).clamp_max(1.0)
            ac = (ac + ac @ ac).clamp_max(1.0)
        eye = torch.eye(n, dtype=torch.bool, device=adj.device)
        others = m[:, None, :] & (r > 0) & ~eye
        reached = others.sum(2, dtype=I32)                     # [C, N]
        cap_total = m.sum(1, dtype=I32)                        # [C]
        cap_ok = (~caps.T) | ((reached + 1) >= (cap_total // 2)[:, None])
        return score_ok & cap_ok.all(0)

    def step_hint(self, p, inbox, t: int):
        """``(depth, join, change)`` at t for one run or a batch, read
        from the device at once (`core/network.step_hint`): the deepest
        valid inbox slot of any node plus one (the slots the receive
        loop walks), whether any joiner comes up, and whether any node's
        capability change is due (live or not, a superset).  Without a
        joiner the joiners' links are the identity, without a change the
        capability draw is."""
        s = inbox.valid.shape[-1]
        depth = torch.where(inbox.valid, torch.arange(
            1, s + 1, dtype=I32, device=inbox.valid.device), 0).max()
        join = ((p.join_at > 0) & (p.join_at == t)).any()
        change = ((p.change_start > 0) & (p.change_start <= t) &
                  ((t - p.change_start) % self.time_to_change == 0)).any()
        depth, join, change = torch.stack(
            [depth, join.to(I32), change.to(I32)]).tolist()
        return depth, bool(join), bool(change)

    def step(self, p: ENRState, nodes, inbox, t: int, step_hint=None):
        """wittgenstein_tpu/models/enr.py:251-411."""
        n, C, D = self.node_count, self.n_caps, self.arena_deg
        ids = self._ids
        dev = ids.device
        depth, any_join, any_change = (
            (inbox.src.shape[1], True, True) if step_hint is None
            else step_hint)

        # ---- membership: joins and exits
        joining = (p.join_at > 0) & (p.join_at == t)
        leaving = (p.exit_at > 0) & (p.exit_at == t) & ~nodes.down
        nodes = nodes.replace(down=(nodes.down & ~joining) | leaving)
        alive = ~nodes.down
        peers, degree = p2p.disconnect(p.peers, p.degree, leaving)

        # joiner links: the first totalPeers live candidates of 2x as many
        # draws; the reciprocal links come from the symmetrization below
        if self.join_slots and any_join:
            tries = self.total_peers * 2
            cand = prng.uniform_int(
                prng.hash3(p.seed, TAG_JOIN, t),
                ids[:, None] * tries + torch.arange(
                    tries, dtype=I32, device=dev)[None, :], n)
            cand_ok = joining[:, None] & alive[cand.clamp_min(0).long()] & \
                (cand != ids[:, None])
            ok_i = cand_ok.to(I32)
            rank = ok_i.cumsum(1, dtype=I32) - ok_i
            take = cand_ok & (rank < self.total_peers)
            slot = torch.where(take, degree[:, None] + rank, D)
            peers = _set_rows(peers, torch.where(slot < D, slot, D), cand, D)
            degree = (peers >= 0).sum(1, dtype=I32)

        # ---- receive records, slot by slot
        seen_seq, pending, pending_src = p.seen_seq, p.pending, p.pending_src
        caps, seq = p.caps, p.seq
        removed = torch.zeros((n, n), dtype=torch.bool, device=dev)
        cnt = self._score_counts(peers, caps)
        base_score = self._score_of(caps, cnt)
        d_idx = torch.arange(D, device=dev)[None, :]
        for s in range(depth):
            ok = inbox.valid[:, s] & alive
            src = inbox.src[:, s].clamp(0, n - 1)
            origin = inbox.data[:, s, 0].clamp(0, n - 1)
            rseq = inbox.data[:, s, 1]
            at_origin = _onehot(origin, n)                     # [N, N]
            old = torch.gather(seen_seq, 1, origin.long()[:, None])[:, 0]
            newer = ok & (rseq > old) & (origin != ids)
            hit = at_origin & newer[:, None]
            seen_seq = torch.where(hit, rseq[:, None], seen_seq)
            pending = pending | hit
            pending_src = torch.where(hit, src[:, None], pending_src)

            # onFlood's connect logic
            o = origin.long()
            o_caps = caps[o]                                   # [N, C]
            connected = (peers == origin[:, None]).any(1)
            can = newer & alive[o] & (degree[o] < self.max_peers) & \
                ~connected
            gain = self._score_of(caps, cnt + o_caps.to(I32)) - base_score
            want = can & (gain > 0)
            has_room = degree < self.max_peers
            # full: try replacing the worst peer
            peer_caps = (peers >= 0)[..., None] & \
                caps[peers.clamp_min(0).long()]
            repl_cnt = (cnt[:, None, :] - peer_caps.to(I32) +
                        o_caps[:, None, :].to(I32))            # [N, D, C]
            repl_score = self._score_of(caps[:, None, :], repl_cnt)
            repl_score = torch.where(peers >= 0, repl_score, -1)
            best_repl = repl_score.argmax(1)
            best_gain = torch.gather(repl_score, 1, best_repl[:, None])[:, 0] \
                - base_score
            do_repl = want & ~has_room & (best_gain > 0)
            repl_peer = torch.gather(peers.clamp_min(0), 1,
                                     best_repl[:, None])[:, 0]
            # drop the replaced link, remembered so that the symmetric
            # rebuild removes both directions
            removed = removed | (_onehot(repl_peer, n) & do_repl[:, None])
            peers = torch.where(do_repl[:, None] &
                                (d_idx == best_repl[:, None]), -1, peers)
            free = peers < 0
            free_slot = free.to(I32).argmax(1)
            do_conn = ((want & has_room) | do_repl) & free.any(1)
            peers = torch.where(do_conn[:, None] &
                                (d_idx == free_slot[:, None]),
                                origin[:, None], peers)
            # a re-created link cancels an earlier removal this ms
            removed = removed & ~(at_origin & do_conn[:, None])
            degree = (peers >= 0).sum(1, dtype=I32)
            cnt = self._score_counts(peers, caps)
            base_score = self._score_of(caps, cnt)

        # ---- symmetrize: every link mutual, removals both ways
        has_edge = _set_rows(torch.zeros((n, n), dtype=torch.bool,
                                         device=dev),
                             torch.where(peers >= 0, peers, n),
                             torch.ones_like(peers, dtype=torch.bool), n)
        final_edge = (has_edge | has_edge.T) & ~(removed | removed.T)
        rank_e = final_edge.to(I32).cumsum(1, dtype=I32) - 1
        slot_ok = final_edge & (rank_e < D)
        peers = _set_rows(torch.full((n, D), -1, dtype=I32, device=dev),
                          torch.where(slot_ok, rank_e, D),
                          ids[None, :].expand(n, n), D)
        degree = (peers >= 0).sum(1, dtype=I32)

        # ---- capability changes
        chg_due = alive & (p.change_start > 0) & (p.change_start <= t) & \
            ((t - p.change_start) % self.time_to_change == 0)
        if any_change:
            new_caps = _draw_caps(prng.hash3(p.seed, TAG_CHG_START + 1, t),
                                  n, C, self.cap_per_node, dev)
            caps = torch.where(chg_due[:, None], new_caps, caps)

        # ---- gossip the own record
        goss_due = alive & (p.gossip_start <= t) & \
            ((t - p.gossip_start) % self.cap_gossip_time == 0)
        bump = goss_due | chg_due
        seq = seq + bump.to(I32)
        diag = torch.eye(n, dtype=torch.bool, device=dev) & bump[:, None]
        pending = pending | diag
        pending_src = torch.where(diag, ids[:, None], pending_src)

        # ---- forward one pending record per node per ms
        pend_live = pending & alive[:, None]
        has = pend_live.any(1)
        pick = pend_live.to(I32).argmax(1).to(I32)
        own = pick == ids
        exclude = torch.where(
            own, -1, torch.gather(pending_src, 1, pick.long()[:, None])[:, 0])
        payload = torch.stack(
            [torch.where(own, ids, pick),
             torch.where(own, seq,
                         torch.gather(seen_seq, 1, pick.long()[:, None])[:, 0])],
            1).to(I32)
        dest, pl, size, delay = p2p.flood_fanout(
            self.cfg, peers, has, exclude, payload, p.seed, t,
            local_delay=10, delay_between=10)
        pending = pending & ~(_onehot(pick, n) & has[:, None])

        # ---- done check (relative time)
        full = self._fully_connected(caps, peers, nodes.down, final_edge)
        done_now = alive & full & (nodes.done_at == 0)
        nodes = nodes.replace(done_at=torch.where(
            done_now, (t - p.start_time).clamp_min(1),
            nodes.done_at).to(I32))

        out = empty_outbox(self.cfg, dev).replace(dest=dest, payload=pl,
                                                  size=size, delay=delay)
        return (p.replace(caps=caps, peers=peers, degree=degree, seq=seq,
                          seen_seq=seen_seq, pending=pending,
                          pending_src=pending_src), nodes, out)


def cont_if_enr(net, pstate):
    """wittgenstein_tpu/models/enr.py:411-413."""
    live = ~net.nodes.down
    return (live & (net.nodes.done_at == 0)).any()
