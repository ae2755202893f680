"""P2P peer graphs and flood forwarding — the port of
`wittgenstein_tpu/core/p2p.py`.

The adjacency is a fixed-shape [N, D] int32 matrix (-1 = empty slot)
built in one shot from counter-based draws: every node draws its quota
of partners at once and the links are symmetrized (the reference's
sequential top-up loop, P2PNetwork.java:45-55, is matched statistically,
as in the JAX package).  Sorts are stable, as JAX's are; the JAX
scatters that drop an out-of-range index scatter here into a dump cell
that is cut off after.
"""

from __future__ import annotations

import torch

from ..ops import prng

I32 = torch.int32
TAG_P2P = 0x50325030   # domain separation for peer-graph draws
TAG_SHUF = 0x50325346  # flood fan-out shuffle draws

_BIG = 0x7FFFFFFF


def _roll1(x):
    """``jnp.roll(x, 1)``."""
    return torch.cat([x[-1:], x[:-1]])


def _scatter_adjacency(src, dst, keep, n, max_degree):
    """A kept directed-edge list as an [N, D] adjacency and degree
    (wittgenstein_tpu/core/p2p.py:37-72): edges sorted by (src, dst),
    duplicates dropped, each ranked within its source and scattered into
    the source's next free slot; edges past `max_degree` dropped and
    counted."""
    m = src.shape[0]
    dev = src.device
    src_k = torch.where(keep, src, _BIG)
    dst_k = torch.where(keep, dst, _BIG)
    o1 = torch.argsort(dst_k, stable=True)
    order = o1[torch.argsort(src_k[o1], stable=True)]
    src_s, dst_s = src_k[order], dst_k[order]

    dup = (src_s == _roll1(src_s)) & (dst_s == _roll1(dst_s))
    dup[0] = False
    kept = (src_s != _BIG) & ~dup

    # Rank among the kept entries within each src group.
    ckept = kept.to(I32).cumsum(0, dtype=I32)
    new_grp = src_s != _roll1(src_s)
    new_grp[0] = True
    grp_base = torch.cummax(torch.where(new_grp, ckept - kept.to(I32), 0),
                            0).values
    rank = ckept - kept.to(I32) - grp_base

    ok = kept & (rank < max_degree)
    cells = n * max_degree
    flat = torch.where(ok, src_s.long() * max_degree + rank, cells)
    peers = torch.full((cells + 1,), -1, dtype=I32, device=dev)
    peers[flat] = dst_s
    degree = torch.zeros(n + 1, dtype=I32, device=dev).index_add(
        0, torch.where(ok, src_s, n).long(), ok.to(I32))
    overflow = (kept & ~ok).sum(dtype=I32)
    return (peers[:cells].reshape(n, max_degree), degree[:n], overflow)


def build_peer_graph(seed, n: int, connection_count: int, minimum: bool = True,
                     max_degree: int | None = None, device="cpu"):
    """Vectorized `P2PNetwork.setPeers` (wittgenstein_tpu/core/p2p.py:
    75-160).  ``minimum=True``: every node draws `connection_count`
    distinct partners, symmetrized; ``minimum=False``: n*c/2 uniform
    pairs, then nodes below min(3, c) draw up to 3 more.  Returns
    (peers [N, D] int32 padded with -1, degree [N], overflow: links
    dropped because a node's D slots were full)."""
    if connection_count >= n:
        raise ValueError(
            f"wrong configuration: nodes={n}, "
            f"connection target={connection_count}")
    seed = prng.hash2(torch.as_tensor(seed, device=device).to(I32), TAG_P2P)
    ids = torch.arange(n, dtype=I32, device=device)

    def draw_partners(sub, count):
        # `count` distinct uniform partners per node: draw in [0, n-1)
        # and skip self, then redraw within-row duplicates, four rounds.
        cols = []
        for j in range(count):
            p = prng.uniform_int(prng.hash2(seed, sub * 1000 + j), ids, n - 1)
            cols.append(p + (p >= ids).to(I32))
        part = torch.stack(cols, 1)                   # [N, count]
        slot_ids = ids[:, None] * count + torch.arange(
            count, dtype=I32, device=device)[None, :]
        for r in range(1, 5):
            dup = torch.zeros(part.shape, dtype=torch.bool, device=device)
            for j in range(1, count):
                dup[:, j] = (part[:, :j] == part[:, j:j + 1]).any(1)
            redraw = prng.uniform_int(prng.hash2(seed, sub * 1000 + 500 + r),
                                      slot_ids, n - 1)
            redraw = redraw + (redraw >= ids[:, None]).to(I32)
            part = torch.where(dup, redraw, part)
        return part

    c = connection_count
    if max_degree is None:
        max_degree = max(4 * c, c + 16)
    if minimum:
        part = draw_partners(1, c)                    # [N, c]
        a = ids.repeat_interleave(c)
        b = part.reshape(-1)
        src = torch.cat([a, b])
        dst = torch.cat([b, a])
        keep = torch.ones_like(src, dtype=torch.bool)
    else:
        npairs = max(1, (n * c) // 2)
        pid = torch.arange(npairs, dtype=I32, device=device)
        pa = prng.uniform_int(prng.hash2(seed, 7001), pid, n)
        pb = prng.uniform_int(prng.hash2(seed, 7002), pid, n)
        ones = torch.ones_like(pa)
        deg0 = torch.zeros(n, dtype=I32, device=device).index_add(
            0, pa.long(), ones).index_add(0, pb.long(), ones)
        lonely = deg0 < min(3, c)
        extra = draw_partners(2, min(3, max(1, c)))   # [N, e]
        e = extra.shape[1]
        xa = ids.repeat_interleave(e)
        xb = extra.reshape(-1)
        xkeep = lonely.repeat_interleave(e)
        src = torch.cat([pa, pb, xa, xb])
        dst = torch.cat([pb, pa, xb, xa])
        keep = torch.cat([pa != pb, pa != pb, xkeep, xkeep])

    return _scatter_adjacency(src, dst, keep, n, max_degree)


def avg_peers(degree):
    """`P2PNetwork.avgPeers` (wittgenstein_tpu/core/p2p.py:163-165)."""
    return degree.sum(dtype=I32) // max(1, degree.shape[0])


def disconnect(peers, degree, node_mask):
    """Drop every link touching a masked node, as source and as peer
    (wittgenstein_tpu/core/p2p.py:168-176); degree recomputed."""
    dead_peer = torch.where(peers >= 0, node_mask[peers.clamp_min(0).long()],
                            False)
    peers = torch.where(dead_peer | node_mask[:, None], -1, peers)
    return peers, (peers >= 0).sum(1, dtype=I32)


def shuffled_order(seed, t, n: int, d: int):
    """Per-node pseudo-random slot permutation at time t: order[i, k] is
    the peer slot node i visits k-th (wittgenstein_tpu/core/p2p.py:
    179-187); `seed` a tensor, its device the result's."""
    flat = torch.arange(n * d, dtype=I32, device=seed.device).reshape(n, d)
    pri = prng.uniform_u32(prng.hash3(seed, TAG_SHUF, t), flat)
    return torch.argsort(pri, dim=1, stable=True).to(I32)


def flood_fanout(cfg, peers, forward, exclude_src, payload, seed, t,
                 local_delay=0, delay_between=0, size=1, order=None):
    """Outbox fields for `FloodMessage.action`-style forwarding
    (wittgenstein_tpu/core/p2p.py:190-208): each node with `forward[i]`
    sends `payload[i]` to all its peers but `exclude_src[i]`, in a
    shuffled order, the k-th sent after ``local_delay + k *
    delay_between`` ms.  Requires ``cfg.out_deg == peers.shape[1]``.
    `order` is ``shuffled_order(seed, t, n, d)`` where the caller has it
    already (several fan-outs of one ms share it).  Returns (dest,
    payload, size, delay) shaped for `Outbox`."""
    n, d = peers.shape
    assert cfg.out_deg == d, (cfg.out_deg, d)
    ok = forward[:, None] & (peers >= 0) & (peers != exclude_src[:, None])
    dest = torch.where(ok, peers, -1)
    # Rank among the sent slots only, in the shuffled order.
    if order is None:
        order = shuffled_order(seed, t, n, d)
    order = order.long()
    sent_sorted = torch.gather(ok, 1, order)
    pos_sorted = sent_sorted.to(I32).cumsum(1, dtype=I32) - 1
    pos = torch.zeros((n, d), dtype=I32, device=peers.device).scatter(
        1, order, pos_sorted)
    delay = local_delay + pos.clamp_min(0) * delay_between
    out_payload = payload[:, None, :].expand(n, d, payload.shape[-1])
    out_size = torch.full((n, d), size, dtype=I32, device=peers.device)
    return dest, out_payload, out_size, delay.to(I32)
