"""Blockchain core layer: the block arena and per-node chain state — the
port of `wittgenstein_tpu/core/blockchain.py`.

Blocks live in one global arena of fixed capacity A, a struct of
tensors; the block id is the arena slot, slot 0 the genesis block.  A
node's chain knowledge is an [N, A/32] received bitset (int32 words
with the JAX package's uint32 bits, as in `ops/bitset.py`) plus a head
index.  The arena is global to a run: `n` and `dropped` are scalars,
and take the seed axis on a batch.

The ancestor walks are the JAX package's `lax.while_loop`s with a
condition that depends on the data.  Under `torch.func.vmap` there is no
host read of a condition, and once the condition is false the body
changes nothing, so each walk runs a fixed trip count: the arena's
capacity, which bounds every chain's length.

Chain statistics are host-side numpy walks over the frozen arena
(`to_numpy`, `chain_ids`, `print_stat`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bitset
from .state import _Struct, register_struct

I32 = torch.int32


@register_struct
@dataclasses.dataclass(frozen=True)
class Arena(_Struct):
    """Global block table (wittgenstein_tpu/core/blockchain.py:35-49).
    Slot 0 is the genesis block."""

    height: torch.Tensor    # int32 [A]
    parent: torch.Tensor    # int32 [A] (-1 for genesis)
    producer: torch.Tensor  # int32 [A] (-1 for genesis)
    valid: torch.Tensor     # bool [A]
    time: torch.Tensor      # int32 [A]: proposal time (engine ticks)
    n: torch.Tensor         # int32 scalar: blocks allocated (incl. genesis)
    dropped: torch.Tensor   # int32 scalar: allocations lost to a full arena

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
        dropped=torch.zeros((), dtype=I32, device=device))


def _set_drop(column, slot_w, vals):
    """``column.at[slot_w].set(vals, mode="drop")`` for slot_w in [0,
    A], A meaning dropped: a scatter into the column padded by one dump
    cell, sliced off after.  Out of place, so it runs under vmap."""
    pad = torch.cat([column, column.new_zeros(1)])
    return pad.scatter(0, slot_w.long(), vals.to(column.dtype))[:-1]


def alloc(arena: Arena, want, parent, producer, t, valid=None, height=None):
    """Allocate one block per requesting node, `want` [N] bool
    (wittgenstein_tpu/core/blockchain.py:64-94).  Returns ``(arena, ids
    [N])`` with ids[i] = -1 where node i allocated nothing; slots follow
    node order within the tick.  `height` overrides the default
    parent.height + 1."""
    a = arena.capacity
    nreq = want.shape[0]
    rank = want.to(I32).cumsum(0, dtype=I32) - 1
    slot = arena.n + rank
    ok = want & (slot < a)
    slot_w = torch.where(ok, slot, a)
    if height is None:
        height = torch.where(parent >= 0,
                             arena.height[parent.clamp_min(0).long()] + 1, 1)
    if valid is None:
        valid = torch.ones(nreq, dtype=torch.bool, device=want.device)
    if not isinstance(t, torch.Tensor):
        t = torch.full((nreq,), t, dtype=I32, device=want.device)
    arena = arena.replace(
        height=_set_drop(arena.height, slot_w, height),
        parent=_set_drop(arena.parent, slot_w, parent),
        producer=_set_drop(arena.producer, slot_w, producer),
        valid=_set_drop(arena.valid, slot_w, valid),
        time=_set_drop(arena.time, slot_w, t.expand(nreq)),
        n=arena.n + ok.sum(dtype=I32),
        dropped=arena.dropped + (want & ~ok).sum(dtype=I32))
    return arena, torch.where(ok, slot, -1)


def _at(column, b):
    return column[b.clamp_min(0).long()]


def walk_to_height(arena: Arena, b, h):
    """Vectorized ``while (cur.height > h) cur = cur.parent``
    (wittgenstein_tpu/core/blockchain.py:97-110); b, h broadcastable
    int32 tensors, -1 propagates."""
    cur = torch.as_tensor(b, dtype=I32, device=arena.height.device)
    h = torch.as_tensor(h, dtype=I32, device=cur.device).expand(cur.shape)
    for _ in range(arena.capacity):
        step = (cur >= 0) & (_at(arena.height, cur) > h)
        cur = torch.where(step, _at(arena.parent, cur), cur)
    return cur


def is_ancestor(arena: Arena, a, b):
    """True where block a is a strict ancestor of block b
    (wittgenstein_tpu/core/blockchain.py:113-118)."""
    dev = arena.height.device
    a = torch.as_tensor(a, dtype=I32, device=dev)
    b = torch.as_tensor(b, dtype=I32, device=dev)
    up = walk_to_height(arena, b, _at(arena.height, a))
    return (up == a) & (b != a)


def has_direct_link(arena: Arena, a, b):
    """True where one of a, b is an ancestor of (or equal to) the other
    (wittgenstein_tpu/core/blockchain.py:121-125)."""
    dev = arena.height.device
    a = torch.as_tensor(a, dtype=I32, device=dev)
    b = torch.as_tensor(b, dtype=I32, device=dev)
    return (a == b) | is_ancestor(arena, a, b) | is_ancestor(arena, b, a)


def common_ancestor(arena: Arena, a, b):
    """Lowest common ancestor of two blocks, -1 where there is none
    (wittgenstein_tpu/core/blockchain.py:128-151)."""
    dev = arena.height.device
    a = torch.as_tensor(a, dtype=I32, device=dev)
    b = torch.as_tensor(b, dtype=I32, device=dev)
    h = torch.minimum(_at(arena.height, a), _at(arena.height, b))
    x = walk_to_height(arena, a, h)
    y = walk_to_height(arena, b, h)
    for _ in range(arena.capacity):
        step = (x != y) & (x >= 0) & (y >= 0)
        x, y = (torch.where(step, _at(arena.parent, x), x),
                torch.where(step, _at(arena.parent, y), y))
    return torch.where(x == y, x, -1)


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
    """wittgenstein_tpu/core/blockchain.py:172-175."""
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

