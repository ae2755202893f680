"""The block arena of the port (`wittgenstein_tpu_torch/core/
blockchain.py`) and the bit tricks Dfinity needs (`ops/bitset.py`)
against the JAX package's, bit for bit: `alloc` (node-order slots, a
full arena's drops, height overrides), the ancestor walks on a random
forest, `receive_block`, the host-side chain statistics; `alloc` under
`torch.func.vmap` with no per-seed fallback; the lowest-set-bit
emulation of ``31 - lax.clz(...)`` at all 32 positions and the zero
word; the OR reduction of one-hot words over an axis, repeated bits
included; and the packing of block masks."""

import numpy as np
import pytest
import torch

from wittgenstein_tpu_torch.core import blockchain as bc
from wittgenstein_tpu_torch.ops import bitset

CAP = 64


def _jax_forest(seed=0):
    """The JAX arena after five ticks of allocations, each from random
    parents among the blocks so far, up to a full arena; the port's
    arena after the same calls."""
    import jax.numpy as jnp
    from wittgenstein_tpu.core import blockchain as jbc
    rng = np.random.default_rng(seed)
    ja, ta = jbc.make_arena(CAP), bc.make_arena(CAP)
    for t in range(1, 6):
        want = rng.random(24) < 0.7
        parent = rng.integers(-1, int(ja.n), 24).astype(np.int32)
        producer = rng.integers(0, 24, 24).astype(np.int32)
        ja, jids = jbc.alloc(ja, jnp.asarray(want), jnp.asarray(parent),
                             jnp.asarray(producer), t)
        ta, tids = bc.alloc(ta, torch.tensor(want), torch.tensor(parent),
                            torch.tensor(producer), t)
        assert np.asarray(jids).tolist() == tids.tolist()
    return ja, ta


def _same(jarena, tarena):
    for k in ("height", "parent", "producer", "valid", "time", "n",
              "dropped"):
        assert np.array_equal(np.asarray(getattr(jarena, k)),
                              getattr(tarena, k).numpy()), k


def test_alloc_matches_jax():
    """Node-order slots, parent.height + 1, a full arena counting its
    drops, and an explicit height and validity."""
    import jax.numpy as jnp
    from wittgenstein_tpu.core import blockchain as jbc
    ja, ta = _jax_forest()
    _same(ja, ta)
    assert int(ta.n) == CAP and int(ta.dropped) > 0
    j2, jids = jbc.alloc(jbc.make_arena(8), jnp.ones(3, bool),
                         jnp.asarray([0, 0, -1]), jnp.arange(3), 4,
                         valid=jnp.asarray([True, False, True]),
                         height=jnp.asarray([5, 6, 7]))
    t2, tids = bc.alloc(bc.make_arena(8), torch.ones(3, dtype=torch.bool),
                        torch.tensor([0, 0, -1]), torch.arange(3), 4,
                        valid=torch.tensor([True, False, True]),
                        height=torch.tensor([5, 6, 7]))
    _same(j2, t2)
    assert np.asarray(jids).tolist() == tids.tolist() == [1, 2, 3]


def test_walks_match_jax():
    """walk_to_height, is_ancestor, has_direct_link and common_ancestor
    on every pair of blocks of a random forest (-1 included)."""
    import jax.numpy as jnp
    from wittgenstein_tpu.core import blockchain as jbc
    ja, ta = _jax_forest(1)
    ids = np.arange(-1, CAP, dtype=np.int32)
    a, b = (x.ravel() for x in np.meshgrid(ids, ids))
    h = np.random.default_rng(2).integers(0, 6, a.shape).astype(np.int32)
    cases = [("walk_to_height", (a, h)), ("is_ancestor", (a, b)),
             ("has_direct_link", (a, b)), ("common_ancestor", (a, b))]
    got = {}
    for name, args in cases:
        want = getattr(jbc, name)(ja, *map(jnp.asarray, args))
        got[name] = getattr(bc, name)(ta, *map(torch.tensor, args))
        assert np.asarray(want).tolist() == got[name].tolist(), name
    assert int(got["is_ancestor"].sum()) > CAP
    assert int((got["common_ancestor"] > 0).sum()) > CAP


def test_receive_block_and_host_stats_match_jax():
    import jax.numpy as jnp
    from wittgenstein_tpu.core import blockchain as jbc
    rng = np.random.default_rng(3)
    w = bc.n_words(CAP)
    recv = rng.integers(0, 1 << 32, (16, w), dtype=np.uint64).astype(
        np.uint32)
    blk = rng.integers(-1, CAP, 16).astype(np.int32)
    ok = rng.random(16) < 0.6
    want = jbc.receive_block(jnp.asarray(recv), None, jnp.asarray(blk),
                             jnp.asarray(ok))
    got = bc.receive_block(torch.tensor(recv.view(np.int32)), None,
                           torch.tensor(blk), torch.tensor(ok))
    assert np.array_equal(np.asarray(want[0]), got[0].numpy().view(np.uint32))
    assert np.asarray(want[1]).tolist() == got[1].tolist()
    ja, ta = _jax_forest(4)
    jnp_, tnp = jbc.to_numpy(ja), bc.to_numpy(ta)
    assert all(np.array_equal(jnp_[k], tnp[k]) for k in jnp_)
    head = int(np.argmax(tnp["height"]))
    assert bc.chain_ids(tnp, head) == jbc.chain_ids(jnp_, head)
    lines = [[], []]
    stats = [jbc.print_stat(jnp_, head, small=False, out=lines[0].append),
             bc.print_stat(tnp, head, small=False, out=lines[1].append)]
    assert stats[0] == stats[1] and lines[0] == lines[1]


def test_alloc_under_vmap():
    """Two seeds' arenas allocated under `torch.func.vmap`, each equal to
    its own unbatched allocation, with no per-seed fallback."""
    from test_torch_batched import no_vmap_fallback
    from torch.utils import _pytree as pytree
    rng = np.random.default_rng(5)
    want = torch.tensor(rng.random((2, 12)) < 0.6)
    parent = torch.tensor(rng.integers(-1, 3, (2, 12)), dtype=torch.int32)
    arenas = pytree.tree_map(lambda x: torch.stack([x, x]),
                             bc.make_arena(8))
    with no_vmap_fallback():
        got, ids = torch.func.vmap(
            lambda a, w, p: bc.alloc(a, w, p, p, 3))(arenas, want, parent)
    for r in range(2):
        one, one_ids = bc.alloc(bc.make_arena(8), want[r], parent[r],
                                parent[r], 3)
        assert ids[r].tolist() == one_ids.tolist()
        for k in ("height", "parent", "n", "dropped"):
            assert torch.equal(getattr(got, k)[r], getattr(one, k)), k


def test_lowest_bit_matches_clz():
    """`bitset.lowest_bit` against the JAX package's ``31 -
    lax.clz(max(low, 1).astype(int32))``, ``low = word & (~word + 1)``
    (wittgenstein_tpu/models/dfinity.py:462-463): every single-bit word,
    bit 31 (negative as int32) included, the zero word, and random words
    with several bits set."""
    import jax
    import jax.numpy as jnp
    U32 = jnp.uint32
    rng = np.random.default_rng(6)
    words = np.concatenate([
        (np.uint64(1) << np.arange(32, dtype=np.uint64)).astype(np.uint32),
        np.array([0, 0xFFFFFFFF, 0x80000001], np.uint32),
        rng.integers(0, 1 << 32, 200, dtype=np.uint64).astype(np.uint32)])
    w = jnp.asarray(words, U32)
    low = w & (~w + U32(1))
    want = 31 - jax.lax.clz(jnp.maximum(low, U32(1)).astype(jnp.int32))
    got = bitset.lowest_bit(torch.tensor(words.view(np.int32)))
    assert np.asarray(want).tolist() == got.tolist()
    assert got[:32].tolist() == list(range(32)) and int(got[32]) == 0


@pytest.mark.parametrize("n", [512, 100, 37])
def test_or_reduce_matches_jax(n):
    """`bitset.bits_of` against ``lax.reduce(where(mask[..., None],
    one_bit(idx, w), 0), 0, bitwise_or, (1,))`` on [N, S] indices with
    repeated bits in a row; `bitset.pack` against `_mask_blocks`'s
    add of one-hot words."""
    import jax
    import jax.numpy as jnp
    from wittgenstein_tpu.models.dfinity import _mask_blocks
    from wittgenstein_tpu.ops import bitset as jbitset
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, (24, 40)).astype(np.int32)
    idx[:, 20:] = idx[:, :20]                       # every bit twice
    idx[3] = 7                                      # one bit 40 times
    mask = rng.random((24, 40)) < 0.7
    w = bitset.n_words(n)
    want = jax.lax.reduce(
        jnp.where(jnp.asarray(mask)[..., None],
                  jbitset.one_bit(jnp.asarray(idx), w), jnp.uint32(0)),
        jnp.uint32(0), jax.lax.bitwise_or, (1,))
    got = bitset.bits_of(torch.tensor(idx), torch.tensor(mask), n)
    assert np.array_equal(np.asarray(want), got.numpy().view(np.uint32))
    flags = rng.random((24, n)) < 0.3
    want = _mask_blocks(jnp.asarray(flags), n)
    got = bitset.pack(torch.tensor(flags))
    assert np.array_equal(np.asarray(want), got.numpy().view(np.uint32))


def _jax_skipped_forest(seed=7, cap=CAP):
    """Arenas whose blocks sit 1-4 heights above their parents (Casper's
    slot heights), built alike in both packages, parents drawn among
    the blocks so far (genesis included, never -1)."""
    import jax.numpy as jnp
    from wittgenstein_tpu.core import blockchain as jbc
    rng = np.random.default_rng(seed)
    ja, ta = jbc.make_arena(cap), bc.make_arena(cap)
    for t in range(1, 8):
        n = int(ta.n)
        want = rng.random(12) < 0.8
        parent = rng.integers(0, n, 12).astype(np.int32)
        height = (ta.height.numpy()[parent] +
                  rng.integers(1, 5, 12)).astype(np.int32)
        ja, _ = jbc.alloc(ja, jnp.asarray(want), jnp.asarray(parent),
                          jnp.asarray(parent), t, height=jnp.asarray(height))
        ta, _ = bc.alloc(ta, torch.tensor(want), torch.tensor(parent),
                         torch.tensor(parent), t, height=torch.tensor(height))
    return ja, ta


def _pointer_walk(arena_np, b, stop):
    """The JAX package's walk, one lane at a time on the host: from b,
    step to the parent while the block is not in `stop`."""
    cur, seen = int(b), []
    while cur >= 0 and not stop[cur]:
        seen.append(cur)
        cur = int(arena_np["parent"][cur])
    return cur, seen


def test_walks_on_skipped_heights_match_jax():
    """The four walks on an arena with skipped heights, every pair of
    blocks and lanes at -1, and `walk_while` against a step-by-step walk
    on random stop sets; the height order holds and the ancestor
    bitsets are those `ancestors_of` rebuilds from the parents."""
    import jax.numpy as jnp
    from wittgenstein_tpu.core import blockchain as jbc
    import torch_parity as tp
    ja, ta = _jax_skipped_forest()
    arena_np = bc.to_numpy(ta)
    tp.assert_heights_ordered(arena_np)
    assert np.array_equal(bc.ancestors_of(arena_np["parent"]),
                          ta.anc.numpy())
    ids = np.arange(-1, int(ta.n), dtype=np.int32)
    a, b = (x.ravel() for x in np.meshgrid(ids, ids))
    h = np.random.default_rng(8).integers(-1, 20, a.shape).astype(np.int32)
    for name, args in [("walk_to_height", (a, h)), ("is_ancestor", (a, b)),
                       ("has_direct_link", (a, b)),
                       ("common_ancestor", (a, b))]:
        want = getattr(jbc, name)(ja, *map(jnp.asarray, args))
        got = getattr(bc, name)(ta, *map(torch.tensor, args))
        assert np.asarray(want).tolist() == got.tolist(), name
    rng = np.random.default_rng(9)
    stop = rng.random((len(ids), CAP)) < 0.3
    stop[:, 0] = rng.random(len(ids)) < 0.5
    cur, seen = bc.walk_while(ta, torch.tensor(ids), torch.tensor(stop))
    for i, lane in enumerate(ids):
        want_cur, want_seen = _pointer_walk(arena_np, lane, stop[i])
        assert int(cur[i]) == want_cur
        assert sorted(np.nonzero(seen[i].numpy())[0]) == sorted(want_seen)


def _walk_ops(cap):
    from torch.autograd import DeviceType
    arena = bc.make_arena(cap)
    lanes = torch.arange(-1, 15, dtype=torch.int32)
    stop = torch.zeros((16, cap), dtype=torch.bool)
    with torch.profiler.profile() as prof:
        bc.walk_to_height(arena, lanes, lanes)
        bc.has_direct_link(arena, lanes, lanes.flip(0))
        bc.common_ancestor(arena, lanes, lanes.flip(0))
        bc.walk_while(arena, lanes, stop)
        bc.alloc(arena, lanes >= 0, lanes, lanes, 3)
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.cpu_parent is None and e.name.startswith("aten::"))


def test_walk_ops_do_not_grow_with_capacity():
    """Every walk and `alloc` issue the same top-level aten ops at 256
    and 8,192 blocks."""
    ops = [_walk_ops(c) for c in (256, 8192)]
    assert ops[0] == ops[1] and ops[0] > 30, ops
