"""Blockchain core layer: the block arena and per-node chain state — the
port of `wittgenstein_tpu/core/blockchain.py`.

Blocks live in one global arena of fixed capacity A, a struct of
tensors; the block id is the arena slot, slot 0 the genesis block.  A
node's chain knowledge is an [N, A/32] received bitset (int32 words
with the JAX package's uint32 bits, as in `ops/bitset.py`) plus a head
index.  The arena is global to a run: `n` and `dropped` are scalars,
and take the seed axis on a batch.

Walks by set, not by steps.  The JAX package walks parent pointers in
`lax.while_loop`s whose trip count depends on the data; under
`torch.func.vmap` a loop cannot stop on a condition without a host
read, and a fixed trip count of A steps costs A times the ops.  The
port keeps one more leaf, ``anc`` [A, Aw]: block b's strict ancestors
as a bitset, set once by `alloc` (``anc[new] = anc[parent] |
bit(parent)``).  Every allocation keeps ``height[b] > height[parent[b]]``
(a default height is the parent's plus one; Casper's slot heights lie
above the father's), so chain(b), b and its ancestors, is ordered by
height, and a walk "from b, step to the parent while pred(cur)" stops
at the highest block of chain(b) where pred fails and has visited the
blocks of chain(b) above it.  Each walk is therefore a fixed number of
[lanes, A] mask operations and one max over heights, whatever the
capacity: `chain_mask`, `highest`, `walk_while` and the JAX package's
`walk_to_height`, `is_ancestor`, `has_direct_link`, `common_ancestor`
(whose lockstep walk meets only blocks of equal depth, the count of a
chain).  ``anc`` is not a JAX leaf: `convert.py` rebuilds it from
``parent`` (`ancestors_of`) and leaves it out of the JAX-named state.

Chain statistics are host-side numpy walks over the frozen arena
(`to_numpy`, `chain_ids`, `print_stat`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bitset
from .state import _Struct, register_struct

I32 = torch.int32
I32_MIN = -(1 << 31)

#: the Arena's leaves that are the JAX package's (``anc`` is the port's)
JAX_LEAVES = ("height", "parent", "producer", "valid", "time", "n",
              "dropped")


@register_struct
@dataclasses.dataclass(frozen=True)
class Arena(_Struct):
    """Global block table (wittgenstein_tpu/core/blockchain.py:35-49)
    and each block's ancestor bitset.  Slot 0 is the genesis block."""

    height: torch.Tensor    # int32 [A]
    parent: torch.Tensor    # int32 [A] (-1 for genesis)
    producer: torch.Tensor  # int32 [A] (-1 for genesis)
    valid: torch.Tensor     # bool [A]
    time: torch.Tensor      # int32 [A]: proposal time (engine ticks)
    n: torch.Tensor         # int32 scalar: blocks allocated (incl. genesis)
    dropped: torch.Tensor   # int32 scalar: allocations lost to a full arena
    anc: torch.Tensor       # int32 [A, Aw]: strict ancestors, a bitset

    @property
    def capacity(self):
        return self.height.shape[-1]


def make_arena(capacity: int, genesis_height: int = 0,
               device="cpu") -> Arena:
    """wittgenstein_tpu/core/blockchain.py:52-61."""
    height = torch.zeros(capacity, dtype=I32, device=device)
    height[0] = genesis_height
    valid = torch.zeros(capacity, dtype=torch.bool, device=device)
    valid[0] = True
    return Arena(
        height=height,
        parent=torch.full((capacity,), -1, dtype=I32, device=device),
        producer=torch.full((capacity,), -1, dtype=I32, device=device),
        valid=valid,
        time=torch.zeros(capacity, dtype=I32, device=device),
        n=torch.ones((), dtype=I32, device=device),
        dropped=torch.zeros((), dtype=I32, device=device),
        anc=torch.zeros((capacity, n_words(capacity)), dtype=I32,
                        device=device))


def ancestors_of(parent) -> np.ndarray:
    """The ``anc`` leaf [..., A, Aw] (uint32 bits as int32) of arenas
    given by their ``parent`` columns [..., A] (numpy, any leading
    axes).  A parent always has a lower id than its child (it was
    allocated first), so one pass in id order suffices."""
    parent = np.asarray(parent)
    a = parent.shape[-1]
    flat = parent.reshape(-1, a)
    words = np.zeros((flat.shape[0], a, n_words(a)), np.uint32)
    runs = np.arange(flat.shape[0])
    for b in range(1, a):
        par = flat[:, b]
        has = par >= 0
        pw = np.maximum(par, 0)
        row = words[runs, pw].copy()
        row[runs, pw // 32] |= np.uint32(1) << (pw % 32).astype(np.uint32)
        words[:, b] = np.where(has[:, None], row, 0)
    return words.reshape(parent.shape + (-1,)).view(np.int32)


def _set_drop(column, slot_w, vals):
    """``column.at[slot_w].set(vals, mode="drop")`` for slot_w in [0,
    A], A meaning dropped: a scatter into the column padded by one dump
    cell (a dump row for a 2-D column), sliced off after.  Out of place,
    so it runs under vmap."""
    pad = torch.cat([column, column.new_zeros((1,) + column.shape[1:])])
    idx = slot_w.long()
    if column.dim() > 1:
        idx = idx[:, None].expand(-1, column.shape[1])
    return pad.scatter(0, idx, vals.to(column.dtype))[:-1]


def alloc(arena: Arena, want, parent, producer, t, valid=None, height=None):
    """Allocate one block per requesting node, `want` [N] bool
    (wittgenstein_tpu/core/blockchain.py:64-94).  Returns ``(arena, ids
    [N])`` with ids[i] = -1 where node i allocated nothing; slots follow
    node order within the tick.  `height` overrides the default
    parent.height + 1 and must lie above the parent's (the order the
    walks rely on).  A new block's ancestors are its parent's and the
    parent."""
    a = arena.capacity
    nreq = want.shape[0]
    rank = want.to(I32).cumsum(0, dtype=I32) - 1
    slot = arena.n + rank
    ok = want & (slot < a)
    slot_w = torch.where(ok, slot, a)
    pw = parent.clamp_min(0).long()
    if height is None:
        height = torch.where(parent >= 0, arena.height[pw] + 1, 1)
    if valid is None:
        valid = torch.ones(nreq, dtype=torch.bool, device=want.device)
    if not isinstance(t, torch.Tensor):
        t = torch.full((nreq,), t, dtype=I32, device=want.device)
    anc = torch.where((parent >= 0)[:, None],
                      arena.anc[pw] | bitset.one_bit(parent.clamp_min(0),
                                                     arena.anc.shape[-1]),
                      0)
    arena = arena.replace(
        height=_set_drop(arena.height, slot_w, height),
        parent=_set_drop(arena.parent, slot_w, parent),
        producer=_set_drop(arena.producer, slot_w, producer),
        valid=_set_drop(arena.valid, slot_w, valid),
        time=_set_drop(arena.time, slot_w, t.expand(nreq)),
        n=arena.n + ok.sum(dtype=I32),
        dropped=arena.dropped + (want & ~ok).sum(dtype=I32),
        anc=_set_drop(arena.anc, slot_w, anc))
    return arena, torch.where(ok, slot, -1)


def _at(column, b):
    return column[b.clamp_min(0).long()]


def _lanes(arena: Arena, b):
    return torch.as_tensor(b, dtype=I32, device=arena.height.device)


def unpack(words, n: int):
    """[..., W] int32 words -> [..., n] bools, bit i of the row at i."""
    shifts = torch.arange(32, dtype=I32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n] != 0


def chain_mask(arena: Arena, b):
    """[..., A] bools: chain(b), block b and its ancestors; empty for
    b = -1 (genesis has no ancestors, and no block has id -1)."""
    b = _lanes(arena, b)
    ids = torch.arange(arena.capacity, dtype=I32, device=b.device)
    return unpack(_at(arena.anc, b), arena.capacity) | (ids == b[..., None])


def highest(arena: Arena, mask):
    """The block of greatest height among `mask` [..., A] (a subset of
    one chain, whose heights are distinct), -1 where it is empty."""
    key = torch.where(mask, arena.height, I32_MIN)
    top, idx = key.max(-1)
    return torch.where(top != I32_MIN, idx.to(I32), -1)


def walk_while(arena: Arena, b, stop, chain=None):
    """The JAX package's ``while (cur >= 0 && pred(cur)) cur =
    cur.parent`` from b, with `stop` [..., A] the blocks where pred
    fails: returns ``(cur, visited)``, the highest block of chain(b) in
    `stop` (-1 when there is none) and the blocks of chain(b) above it,
    [..., A] bools.  `chain` is chain(b) when the caller has it."""
    c = chain_mask(arena, b) if chain is None else chain
    cur = highest(arena, c & stop)
    h = torch.where(cur >= 0, _at(arena.height, cur), I32_MIN)
    return cur, c & (arena.height > h[..., None])


def walk_to_height(arena: Arena, b, h):
    """Vectorized ``while (cur.height > h) cur = cur.parent``
    (wittgenstein_tpu/core/blockchain.py:97-110): the highest block of
    chain(b) at height <= h; b, h broadcastable int32 tensors, -1
    propagates."""
    b = _lanes(arena, b)
    h = torch.as_tensor(h, dtype=I32, device=b.device).expand(b.shape)
    return highest(arena, chain_mask(arena, b) &
                   (arena.height <= h[..., None]))


def is_ancestor(arena: Arena, a, b):
    """True where block a is a strict ancestor of block b
    (wittgenstein_tpu/core/blockchain.py:113-118)."""
    a, b = _lanes(arena, a), _lanes(arena, b)
    up = walk_to_height(arena, b, _at(arena.height, a))
    return (up == a) & (b != a)


def has_direct_link(arena: Arena, a, b):
    """True where one of a, b is an ancestor of (or equal to) the other
    (wittgenstein_tpu/core/blockchain.py:121-125)."""
    a, b = _lanes(arena, a), _lanes(arena, b)
    return (a == b) | is_ancestor(arena, a, b) | is_ancestor(arena, b, a)


def common_ancestor(arena: Arena, a, b):
    """Lowest common ancestor of two blocks, -1 where there is none
    (wittgenstein_tpu/core/blockchain.py:128-151).  JAX walks both to
    the lower height, then steps both in lockstep until they meet or
    one falls off genesis: they meet, at the deepest common block, only
    when the two blocks are at the same depth (the chains' lengths)."""
    a, b = _lanes(arena, a), _lanes(arena, b)
    h = torch.minimum(_at(arena.height, a), _at(arena.height, b))
    x = walk_to_height(arena, a, h)
    y = walk_to_height(arena, b, h)
    cx, cy = chain_mask(arena, x), chain_mask(arena, y)
    same = cx.sum(-1, dtype=I32) == cy.sum(-1, dtype=I32)
    return torch.where(same, highest(arena, cx & cy), -1)


# ---------------------------------------------------------------- per-node

def n_words(capacity: int) -> int:
    """wittgenstein_tpu/core/blockchain.py:156-157."""
    return bitset.n_words(capacity)


def receive_block(received, ids_row, block_id, ok):
    """Mark `block_id` received for the masked nodes; returns
    ``(received, was_new [N])``
    (wittgenstein_tpu/core/blockchain.py:160-167)."""
    w = received.shape[-1]
    bit = bitset.one_bit(block_id.clamp_min(0), w)
    known = bitset.intersects(received, bit)
    new = ok & (block_id >= 0) & ~known
    return torch.where(new[:, None], received | bit, received), new


# ---------------------------------------------------------------- host side

def to_numpy(arena: Arena) -> dict:
    """wittgenstein_tpu/core/blockchain.py:172-175 (the JAX leaves
    only)."""
    return {k: getattr(arena, k).detach().cpu().numpy()
            for k in ("height", "parent", "producer", "valid", "time")} | {
            "n": int(arena.n)}


def chain_ids(arena_np: dict, head: int) -> list:
    """Block ids on the chain from head down to (excluding) genesis
    (wittgenstein_tpu/core/blockchain.py:178-185)."""
    out, cur = [], int(head)
    while cur > 0:
        out.append(cur)
        cur = int(arena_np["parent"][cur])
    return out


def print_stat(arena_np: dict, head: int, node_info=None, small=True,
               out=print):
    """printStat: blocks in the observer's chain, per-producer counts
    (wittgenstein_tpu/core/blockchain.py:188-206)."""
    chain = chain_ids(arena_np, head)
    producers = {}
    for b in chain:
        if not small:
            out(f"block: h:{arena_np['height'][b]}, id={b}, "
                f"creationTime:{arena_np['time'][b]}, "
                f"producer={arena_np['producer'][b]}, "
                f"parent:{arena_np['parent'][b]}")
        producers.setdefault(int(arena_np["producer"][b]), []).append(b)
    if not small:
        out(f"block count:{len(chain)} on {arena_np['n']}")
    for pid in sorted(producers):
        line = f"producer {pid}; {len(producers[pid])} blocks"
        if node_info:
            line += f"; {node_info(pid)}"
        out(line)
    return {"blocks_in_chain": len(chain),
            "per_producer": {k: len(v) for k, v in producers.items()}}

