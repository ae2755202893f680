"""P2PHandel — gossip BLS aggregation with peer-state tracking — the port
of `wittgenstein_tpu/models/p2phandel.py`.

Nodes keep a bitset view of every peer's verified set; every
`sigs_send_period` ms each live node sends the peer with the largest
diff (verified minus what the peer is known to hold) that diff.
Incoming sets queue for verification; every `pairing_time` ms the queue
is scanned for the best new set (checkSigs1) or or-aggregated and
verified in one go (checkSigs2, the default double aggregation); a
verification lands 2 * pairing_time later, in one of two pipeline
slots.  Reaching the threshold sets doneAt and pushes the final
aggregate to every peer still below it; optional State messages keep
the peers' views fresh, and `relaying_node_count` nodes relay without
signing.  The four send-size strategies {all, dif, cmp_all, cmp_diff}
cost a message by its signature count or by `compressed_size`.

The receive loop walks the inbox slot by slot, as JAX does (two slots
from one sender update the same peer view); with `step_hint` (the most
messages any node holds this ms) it walks only that many.  Bitset rows
are int32 words holding the JAX package's uint32 bits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import builders, p2p
from ..core import latency as latency_mod
from ..core.protocol import FAR_FUTURE, masked_min, next_tick, register
from ..core.state import (EngineConfig, _Struct, empty_outbox, init_net,
                          register_struct, resolve_device)
from ..ops import bitset, prng
from ..ops.flat import gather_rows

I32 = torch.int32
TAG_RELAY = 0x52454C59

ALL, DIF, CMP_ALL, CMP_DIFF = "all", "dif", "cmp_all", "cmp_diff"


def scenario_params(signers=100, relays=20, **overrides):
    """The configuration of `scenarios/p2phandel_scenarios.
    default_params(signers, relays)` (threshold 99% of the signers, 40
    connections, pairing 100 ms, a send every 1,000 ms, the cities
    builder), with `NetworkLatencyByDistanceWJitter` in place of its
    `NetworkLatencyByCityWJitter`: the distance-latency configuration
    that `chip_smoke.py` phase P and `bench_torch.py --proto p2phandel`
    run and hold against their goldens.  The reference's own
    configuration is `scenarios.p2phandel_scenarios.default_params`."""
    params = dict(signing_node_count=signers, relaying_node_count=relays,
                  threshold=int(signers * 0.99), connection_count=40,
                  pairing_time=100, sigs_send_period=1000,
                  node_builder_name=builders.registry_name(
                      "cities", True, 0.0),
                  network_latency_name="NetworkLatencyByDistanceWJitter")
    params.update(overrides)
    return params


def compressed_size(bits_rows, n_signing):
    """Signature count after merging aligned full ranges (compressedSize,
    range size 2; wittgenstein_tpu/models/p2phandel.py:47-92): full
    aligned dyadic blocks of pairs count once, bits in partial pairs
    one each, and a set of at least `n_signing` bits costs 1.  The pair
    masks are built in int64, where the shifts are logical."""
    pc = bitset.popcount(bits_rows)
    w = bits_rows.shape[-1]
    v = bits_rows.to(torch.int64) & 0xFFFFFFFF
    full_pair = ((v & 0x55555555) << 1) & (v & 0xAAAAAAAA)
    n_full_pairs = bitset.popcount(bitset.to_i32(full_pair))
    bits_in_partial = pc - 2 * n_full_pairs
    # pairs[..., k]: pair k full; a level-j block of 2^j pairs is a
    # segment iff full and its parent is not
    pair = torch.arange(w * 16, device=bits_rows.device)
    cur = ((full_pair[..., pair // 16] >> ((pair % 16) * 2 + 1)) & 1).to(I32)
    segments = torch.zeros_like(pc)
    while True:
        cnt = cur.sum(-1, dtype=I32)
        if cur.shape[-1] == 1:
            segments = segments + cnt
            break
        if cur.shape[-1] % 2:
            cur = torch.cat([cur, cur.new_zeros(cur.shape[:-1] + (1,))], -1)
        nxt = cur[..., 0::2] * cur[..., 1::2]
        segments = segments + (cnt - 2 * nxt.sum(-1, dtype=I32))
        cur = nxt
    total = bits_in_partial + segments
    return torch.where(pc >= n_signing, 1, total.clamp_min(1)).to(I32)


@register_struct
@dataclasses.dataclass(frozen=True)
class P2PHandelState(_Struct):
    """wittgenstein_tpu/models/p2phandel.py:95-113.  Bitset leaves
    (verified, peer_state, acc, q_sig, pend_sig) are int32 words."""

    seed: torch.Tensor
    peers: torch.Tensor        # int32 [N, D]
    degree: torch.Tensor       # int32 [N]
    just_relay: torch.Tensor   # bool [N]
    verified: torch.Tensor     # [N, W]
    peer_state: torch.Tensor   # [N, D, W] our view of each peer
    acc: torch.Tensor          # [N, W] checkSigs2 or-accumulator
    has_acc: torch.Tensor      # bool [N]
    q_sig: torch.Tensor        # [N, Q, W] checkSigs1 queue
    q_used: torch.Tensor       # bool [N, Q]
    pend_sig: torch.Tensor     # [N, 2, W] two in-flight verifications
    pend_at: torch.Tensor      # int32 [N, 2]
    pend_on: torch.Tensor      # bool [N, 2]


def _row_where(mask, rows, arr):
    """``arr[i, j] = rows[i]`` where ``mask[i, j]``: [N, J, W] leaves."""
    return torch.where(mask[..., None], rows[:, None, :], arr)


@register
class P2PHandel:
    """Parameters mirror wittgenstein_tpu/models/p2phandel.py:124-151
    (P2PHandelParameters), plus `device` (``cuda`` unless the caller
    asks for another)."""

    # Every dest comes from the p2p peer graph, which skips self
    # (core/network.unicast_floor_ms); no broadcast is ever sent
    # (core/network._broadcasts).
    may_self_send = False
    sends_broadcast = False

    def __init__(self, signing_node_count=100, relaying_node_count=20,
                 threshold=99, connection_count=40, pairing_time=100,
                 sigs_send_period=1000, double_aggregate_strategy=True,
                 send_sigs_strategy=DIF, send_state=False,
                 node_builder_name=None, network_latency_name=None,
                 max_degree=None, queue_cap=8, inbox_cap=32, horizon=2048,
                 device=None):
        if send_sigs_strategy not in (ALL, DIF, CMP_ALL, CMP_DIFF):
            raise ValueError(f"unknown send strategy {send_sigs_strategy!r}")
        self.device = resolve_device(device)
        self.n_sign = signing_node_count
        self.n_relay = relaying_node_count
        self.node_count = signing_node_count + relaying_node_count
        self.threshold = threshold
        self.connection_count = connection_count
        self.pairing_time = pairing_time
        self.period = sigs_send_period
        self.double_agg = double_aggregate_strategy
        self.strategy = send_sigs_strategy
        self.send_state = send_state
        self.queue_cap = queue_cap
        self.builder = builders.get_by_name(node_builder_name)
        self.latency = latency_mod.get_by_name(network_latency_name)
        self.max_degree = max_degree or max(4 * connection_count,
                                            connection_count + 16)
        # Signature bits live in the full node-id space (the signers
        # are the nodes not chosen as relays, whatever their ids).
        self.w = bitset.n_words(self.node_count)
        self.cfg = EngineConfig(
            n=self.node_count, horizon=horizon, inbox_cap=inbox_cap,
            payload_words=1, out_deg=self.max_degree + 1, bcast_slots=1)
        self._ids = torch.arange(self.node_count, dtype=I32,
                                 device=self.device)

    def __repr__(self):
        return (f"P2PHandel(signing_node_count={self.n_sign}, "
                f"relaying_node_count={self.n_relay}, "
                f"strategy={self.strategy!r})")

    def init(self, seed):
        """wittgenstein_tpu/models/p2phandel.py:153-175."""
        n, w, D, Q = self.node_count, self.w, self.max_degree, self.queue_cap
        dev = self.device
        seed = torch.as_tensor(seed, device=dev).to(I32)
        nodes = self.builder.build(seed, n, dev)
        peers, degree, _ = p2p.build_peer_graph(
            seed, n, self.connection_count, minimum=False, max_degree=D,
            device=dev)
        ids = self._ids
        # relayingNodeCount distinct random relays (P2PHandel.init:482-487)
        pri = prng.uniform_u32(prng.hash2(seed, TAG_RELAY), ids)
        just_relay = torch.zeros(n, dtype=torch.bool, device=dev)
        just_relay[torch.argsort(pri, stable=True)[:self.n_relay]] = True
        own = torch.where(~just_relay[:, None], bitset.one_bit(ids, w), 0)
        net = init_net(self.cfg, nodes, seed)

        def z(*shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return net, P2PHandelState(
            seed=seed, peers=peers, degree=degree, just_relay=just_relay,
            verified=own, peer_state=z(n, D, w), acc=z(n, w),
            has_acc=z(n, dtype=torch.bool), q_sig=z(n, Q, w),
            q_used=z(n, Q, dtype=torch.bool), pend_sig=z(n, 2, w),
            pend_at=z(n, 2), pend_on=z(n, 2, dtype=torch.bool))

    # ------------------------------------------------------------------

    def step_hint(self, p: P2PHandelState, inbox, t: int):
        """``(depth, apply)`` at t for one run or a batch, read from the
        device at once (`core/network.step_hint`): the most messages any
        node holds, and whether any verification lands this ms."""
        depth, app = torch.stack([
            inbox.valid.sum(-1).max(),
            (p.pend_on & (t >= p.pend_at)).any()]).tolist()
        return int(depth), bool(app)

    def _receive(self, p, inbox, alive, depth):
        """State (kind 1) or SendSigs (kind 0) carrying the sender's
        current verified set, slot by slot (wittgenstein_tpu/models/
        p2phandel.py:191-221)."""
        n, D, Q = self.node_count, self.max_degree, self.queue_cap
        ids = self._ids
        valid, src_all, kinds = inbox.valid, inbox.src, inbox.data[:, :, 0]
        S = src_all.shape[1]
        if depth is not None and depth < S:
            if depth:
                order = torch.argsort((~valid).to(I32), dim=1, stable=True)
                valid = torch.gather(valid, 1, order)
                src_all = torch.gather(src_all, 1, order)
                kinds = torch.gather(kinds, 1, order)
            S = depth
        d_idx = torch.arange(D, device=ids.device)[None, :]
        q_idx = torch.arange(Q, device=ids.device)[None, :]
        peer_state, acc, has_acc = p.peer_state, p.acc, p.has_acc
        q_sig, q_used = p.q_sig, p.q_used
        for s in range(S):
            ok = valid[:, s] & alive
            src = src_all[:, s].clamp(0, n - 1)
            sig = p.verified[src.long()]                 # the sender's set
            hit = p.peers == src[:, None]
            slot = torch.where(hit.any(1), hit.to(I32).argmax(1), D)
            # peersState[from] |= sigs (onPeerState / onNewSig)
            at = (ok & (slot < D))[:, None] & (d_idx == slot[:, None])
            peer_state = torch.where(at[..., None],
                                     peer_state | sig[:, None, :],
                                     peer_state)
            is_sigs = ok & (kinds[:, s] == 0)
            if self.double_agg:
                acc = torch.where(is_sigs[:, None], acc | sig, acc)
                has_acc = has_acc | is_sigs
            else:
                free = ~q_used
                any_free = free.any(1)
                qslot = torch.where(any_free, free.to(I32).argmax(1), 0)
                put = (is_sigs & any_free)[:, None] & (q_idx ==
                                                       qslot[:, None])
                q_sig = _row_where(put, sig, q_sig)
                q_used = q_used | put
        return p.replace(peer_state=peer_state, acc=acc, has_acc=has_acc,
                         q_sig=q_sig, q_used=q_used)

    def step(self, p: P2PHandelState, nodes, inbox, t: int, step_hint=None):
        """wittgenstein_tpu/models/p2phandel.py:185-338.  With
        `step_hint` the receive loop walks as many slots as the deepest
        node's inbox, and where no verification lands, no checkSigs or
        sendSigs tick falls and no state kick is due, the rest of the
        step is the identity and sends nothing: it is left out."""
        depth, app_any = (None, True) if step_hint is None else step_hint
        alive = ~nodes.down
        p = self._receive(p, inbox, alive, depth)
        tick = t >= 1 and ((t - 1) % self.pairing_time == 0 or
                           (t - 1) % self.period == 0)
        if not (app_any or tick or (self.send_state and t == 1)):
            return p, nodes, empty_outbox(self.cfg, self._ids.device)
        return self._act(p, nodes, t, alive)

    def _act(self, p: P2PHandelState, nodes, t: int, alive):
        """Verifications, checkSigs and the sends
        (wittgenstein_tpu/models/p2phandel.py:223-338)."""
        n, D = self.node_count, self.max_degree
        ids = self._ids
        dev = ids.device

        # ---- apply verifications first (updateVerifiedSignatures): the
        # freed pipeline slot is pickable this same tick ----
        app = p.pend_on & (t >= p.pend_at)                       # [N, 2]
        any_app = app.any(1)
        old_card = bitset.popcount(p.verified)
        pend = torch.where(app[..., None], p.pend_sig, 0)
        verified = torch.where(any_app[:, None],
                               p.verified | pend[:, 0] | pend[:, 1],
                               p.verified)
        new_card = bitset.popcount(verified)
        improved = any_app & (new_card > old_card)
        pend_on = p.pend_on & ~app
        reach = improved & (nodes.done_at == 0) & \
            (new_card >= self.threshold)
        nodes = nodes.replace(done_at=torch.where(
            reach, max(t, 1), nodes.done_at).to(I32))
        final_burst = reach
        state_burst = (improved & ~reach & (nodes.done_at == 0)
                       & self.send_state)

        # ---- conditional checkSigs every pairingTime, into a free
        # pipeline slot ----
        free_slot = pend_on.to(I32).argmin(1)
        has_free = ~pend_on.all(1)
        due = alive & (t >= 1) & ((t - 1) % self.pairing_time == 0) & \
            (nodes.done_at == 0) & has_free
        acc, has_acc, q_used = p.acc, p.has_acc, p.q_used
        if self.double_agg:
            go = due & has_acc & ((acc & ~verified) != 0).any(1)
            picked = acc
            acc = torch.where(due[:, None], 0, acc)
            has_acc = has_acc & ~due
        else:
            gain = bitset.popcount(torch.where(
                q_used[..., None], p.q_sig & ~verified[:, None, :], 0))
            best = gain.argmax(1)
            best_gain = torch.gather(gain, 1, best[:, None])[:, 0]
            go = due & (best_gain > 0)
            picked = gather_rows(p.q_sig, ids, best)
            # curation: drop zero-gain entries; the picked one removed
            q_used = torch.where(due[:, None] & (gain == 0), False, q_used)
            q_idx = torch.arange(self.queue_cap, device=dev)[None, :]
            q_used = q_used & ~(go[:, None] & (q_idx == best[:, None]))
        into = go[:, None] & (torch.arange(2, device=dev)[None, :] ==
                              free_slot[:, None])
        pend_sig = _row_where(into, picked, p.pend_sig)
        pend_at = torch.where(into, t + 2 * self.pairing_time, p.pend_at)
        pend_on = pend_on | into

        # ---- outbox: burst sends + periodic sendSigs ----
        peer_state = p.peer_state
        peer_ok = p.peers >= 0                                   # [N, D]
        psrc = p.peers.clamp(0, n - 1)
        # final sig to peers below threshold (:302-315), size 1
        lag = bitset.popcount(peer_state) < self.threshold
        fsend = final_burst[:, None] & peer_ok & lag
        peer_state = torch.where(fsend[..., None],
                                 peer_state | verified[:, None, :],
                                 peer_state)
        # state broadcast (sendStateToPeers + the init kick)
        skick = alive & (t == 1) & self.send_state
        ssend = (state_burst | skick) & ~final_burst
        sdest = torch.where(ssend[:, None] & peer_ok, psrc, -1)
        st_size = max(1, (self.n_sign + 7) // 8)

        # periodic sendSigs (:334-379): the best peer by diff cardinality
        per = alive & (t >= 1) & ((t - 1) % self.period == 0) & \
            (nodes.done_at == 0)
        diff = torch.where(peer_ok[..., None],
                           verified[:, None, :] & ~peer_state, 0)
        dcard = bitset.popcount(diff)                            # [N, D]
        bestp = dcard.argmax(1)
        bestc = torch.gather(dcard, 1, bestp[:, None])[:, 0]
        send1 = per & (bestc > 0)
        d1 = torch.where(send1, torch.gather(psrc, 1, bestp[:, None])[:, 0],
                         -1)
        if self.strategy == DIF:
            msize = bestc
        elif self.strategy == CMP_ALL:
            msize = compressed_size(verified, self.n_sign)
        elif self.strategy == CMP_DIFF:
            bdiff = gather_rows(diff, ids, bestp)
            msize = torch.minimum(compressed_size(verified, self.n_sign),
                                  compressed_size(bdiff, self.n_sign))
        else:                                                    # ALL
            msize = bitset.popcount(verified)
        # we assume the peer receives it (:352-355)
        to_best = send1[:, None] & (torch.arange(D, device=dev)[None, :] ==
                                    bestp[:, None])
        peer_state = torch.where(to_best[..., None],
                                 peer_state | verified[:, None, :],
                                 peer_state)

        out = empty_outbox(self.cfg, dev).replace(
            dest=torch.cat([torch.where(fsend, psrc, sdest), d1[:, None]],
                           1),
            payload=torch.cat([torch.where(fsend, 0, 1).to(I32),
                               torch.zeros_like(d1)[:, None]], 1)[..., None],
            size=torch.cat([torch.where(fsend, 1, st_size),
                            msize.clamp_min(1)[:, None]], 1).to(I32))
        return (p.replace(peer_state=peer_state, acc=acc, has_acc=has_acc,
                          q_used=q_used, verified=verified,
                          pend_sig=pend_sig, pend_at=pend_at,
                          pend_on=pend_on),
                nodes, out)

    def next_action_time(self, p: P2PHandelState, nodes, t: int):
        """Quiet-window oracle half (wittgenstein_tpu/models/
        p2phandel.py:340-362): verification completions at ``pend_at``,
        the next checkSigs tick of an undone node with material and a
        free pipeline slot, the periodic sendSigs tick of undone nodes,
        and the t == 1 state kick when sendState is on."""
        live = ~nodes.down
        undone = live & (nodes.done_at == 0)
        one = torch.ones_like(nodes.done_at)
        pend = masked_min(p.pend_at.clamp_min(t), p.pend_on)
        has_free = ~p.pend_on.all(1)
        material = p.has_acc | p.q_used.any(1)
        pick = masked_min(next_tick(t, one, self.pairing_time),
                          undone & has_free & material)
        per = masked_min(next_tick(t, one, self.period), undone)
        kick = (masked_min(one, live & (t <= 1)) if self.send_state
                else torch.full_like(pend, FAR_FUTURE))
        return torch.minimum(torch.minimum(pend, pick),
                             torch.minimum(per, kick)).to(I32)


def cont_if_p2phandel(net, pstate):
    """wittgenstein_tpu/models/p2phandel.py:365-367."""
    live = ~net.nodes.down
    return (live & (net.nodes.done_at == 0)).any()
