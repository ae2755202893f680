"""The seed-folded engine of the port (`core/batched.py`) against the JAX
package's: `scan_chunk_batched` with 3 seeds of the 64-node
reference-default Handel, superstep K=2 and phase hints (the benchmark
headline's engine), leaf for leaf with the R axis, and against the
port's dense engine seed by seed.  Every run here turns `torch.func.vmap`'s
fallback warning (an op without a batching rule, run as a loop over
seeds) into an error.  Also: the merge and score custom ops under vmap
against one call per seed, and one K=2 window's batch through the ring
binning against the JAX package's `_batched_bin`, with arrivals on the
rows the window just cleared (rel = H)."""

import contextlib
import warnings

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.utils import _pytree as pytree

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import batched
from wittgenstein_tpu_torch.core.network import Runner
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.handel import (Handel,
                                                  reference_default_params)
from wittgenstein_tpu_torch.ops import merge, route, score

SEEDS, MS = 3, 200


@contextlib.contextmanager
def no_vmap_fallback():
    """vmap's per-seed fallback raises instead of warning."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "error", message=".*There is a performance drop.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_run():
    proto = Handel(**reference_default_params(64), device="cpu")
    nets, ps = init_batched(proto, torch.arange(SEEDS))
    with no_vmap_fallback():
        nets, ps = batched.scan_chunk_batched(proto, MS, t0_mod=0)(nets, ps)
    return nets, ps


def test_batched_matches_jax(port_run):
    """Against the JAX package's seed-folded engine without phase hints:
    its hinted one is bit-equal to it (tests/test_batched.py) and takes
    minutes more to compile here; the hinted one is held at full size,
    16 seeds x 2048 nodes, by the golden digests on the card."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import scan_chunk_batched
    from wittgenstein_tpu.models.handel import Handel as JHandel
    jproto = JHandel(**reference_default_params(64))
    nets, ps = jax.vmap(jproto.init)(jnp.arange(SEEDS, dtype=jnp.int32))
    ref = tp.jax_state(*jax.jit(scan_chunk_batched(jproto, MS))(nets, ps))
    tp.assert_states_equal(ref, convert.to_numpy(*port_run), "batched")
    assert ref[0]["time"].tolist() == [MS] * SEEDS


def test_batched_matches_dense_per_seed(port_run):
    proto = Handel(**reference_default_params(64), device="cpu")
    runner = Runner(proto)
    digests = convert.seed_digests(*convert.to_numpy(*port_run))
    for r in range(SEEDS):
        net, ps = runner.run_ms(*proto.init(r), MS)
        one = pytree.tree_map(lambda x, r=r: x[r], port_run)
        tp.assert_states_equal(convert.to_numpy(net, ps),
                               convert.to_numpy(*one), f"seed {r}")
        assert digests[r] == convert.state_digest(*convert.to_numpy(net, ps))
        assert int(ps.sigs_checked.sum()) > 0


def test_step_2ms_batched_frozen_runs_stay():
    """A frozen run's leaves, ring included, come out of a window as they
    went in; the others advance as without freezing."""
    proto = Handel(**reference_default_params(64), device="cpu")
    nets, ps = init_batched(proto, torch.arange(2))
    nets, ps = batched.scan_chunk_batched(proto, 40)(nets, ps)
    before = convert.flatten(dict(zip(("net", "pstate"),
                                      convert.to_numpy(nets, ps))))
    twin = convert.from_reference(*pytree.tree_map(
        lambda x: x[1], convert.to_numpy(nets, ps)), "cpu")
    frozen = torch.tensor([True, False])
    with no_vmap_fallback():
        nets, ps = batched.step_kms_batched(proto, nets, ps, 2, t=40,
                                            frozen=frozen)
    after = convert.flatten(dict(zip(("net", "pstate"),
                                     convert.to_numpy(nets, ps))))
    ring = ("box_data", "box_src", "box_size", "box_count")
    for k in before:
        if any(r in k for r in ring):
            assert np.array_equal(before[k][0], after[k][0]), k
    twin = Runner(proto, superstep=2).run_ms(*twin, 2)
    one = pytree.tree_map(lambda x: x[1], (nets, ps))
    tp.assert_states_equal(convert.to_numpy(*twin), convert.to_numpy(*one),
                           "running seed beside a frozen one")


def _merge_args(rng, r, m, q, s, w):
    q_from = np.where(rng.random((r, m, q)) < 0.7,
                      rng.integers(0, 64, (r, m, q)), -1)
    q_lvl = rng.integers(0, 7, (r, m, q))
    src = rng.integers(0, 64, (r, m, s))
    level = rng.integers(0, 7, (r, m, s))
    slot = rng.integers(0, q, s)
    dup = rng.random((r, m, s)) < 0.3            # (sender, level) queued
    src[dup] = np.abs(q_from[..., slot])[dup]
    level[dup] = q_lvl[..., slot][dup]
    return [torch.tensor(a, dtype=torch.int32) for a in (
                q_from, q_lvl, rng.integers(0, 128, (r, m, q)))] + [
            torch.tensor(rng.random((r, m, q)) < 0.2),
            torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (r, m, q, w)),
                         dtype=torch.int32),
            torch.tensor(src, dtype=torch.int32),
            torch.tensor(level, dtype=torch.int32),
            torch.tensor(rng.integers(0, 128, (r, m, s)), dtype=torch.int32),
            torch.tensor(rng.random((r, m, s)) < 0.6),
            torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (r, m, s, w)),
                         dtype=torch.int32)]


def test_merge_and_score_ops_under_vmap():
    """The vmap rules fold the seed axis into the rows: equal to one call
    per seed, evictions counted per seed; on CPU tensors no kernel is
    launched."""
    rng = np.random.default_rng(5)
    r, m, q, s, w = 3, 32, 8, 12, 2
    args = _merge_args(rng, r, m, q, s, w)
    launches = merge.merge_queue.launches, score.score_queue.launches
    with no_vmap_fallback():
        got = torch.func.vmap(merge.merge_queue)(*args)
    want = [merge.merge_queue(*[a[i] for a in args]) for i in range(r)]
    for j, g in enumerate(got):
        assert torch.equal(g, torch.stack([w_[j] for w_ in want])), j
    assert int(got[5].sum()) > 0                  # evictions happened
    ids = torch.arange(m, dtype=torch.int32) + 17
    rows = [torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (r, m, w)),
                         dtype=torch.int32) for _ in range(3)]
    sargs = [args[4], args[1], ids] + rows
    with no_vmap_fallback():
        got = torch.func.vmap(score.score_queue,
                              in_dims=(0, 0, None, 0, 0, 0))(*sargs)
    want = [score.score_queue(args[4][i], args[1][i], ids,
                              *[x[i] for x in rows]) for i in range(r)]
    for j, g in enumerate(got):
        assert torch.equal(g, torch.stack([w_[j] for w_ in want])), j
    assert (merge.merge_queue.launches,
            score.score_queue.launches) == launches


class _Net:
    """The four ring leaves and `replace`, all `_batched_bin` reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def replace(self, **kw):
        return _Net(**{**self.__dict__, **kw})


def test_window_batch_bin_matches_jax():
    """One K=2 window entered at t=6 of two seeds: the consumed rows 6
    and 7 cleared, then a batch whose arrivals span rel = K .. H + K - 2,
    some at rel = H (row 6 again), some cells overflowing, binned by
    the port (`bin_into_ring`, the plain version on the CPU) and by the
    JAX package's `_batched_bin`: ring, counts and drops equal."""
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import _batched_bin
    from wittgenstein_tpu.core.state import EngineConfig
    rng = np.random.default_rng(11)
    r, f, hz, n, c, k, t, m = 2, 3, 16, 8, 4, 2, 6, 400
    data = rng.integers(0, 1 << 20, (r, f, hz, n, c)).astype(np.int32)
    src = rng.integers(0, n, (r, hz, n, c)).astype(np.int32)
    size = rng.integers(0, 99, (r, hz, n, c)).astype(np.int32)
    count = rng.integers(0, c + 1, (r, hz, n)).astype(np.int32)
    count[:, t % hz:t % hz + k] = 0
    rel = rng.integers(k, hz + k - 1, (r, m)).astype(np.int32)
    rel[:, ::7] = hz
    arrival = t + rel
    dest = rng.integers(0, n, (r, m)).astype(np.int32)
    msrc = rng.integers(0, n, (r, m)).astype(np.int32)
    msize = rng.integers(1, 99, (r, m)).astype(np.int32)
    payload = rng.integers(0, 1 << 20, (r, m, f)).astype(np.int32)
    valid = rng.random((r, m)) < 0.8

    cfg = EngineConfig(n=n, horizon=hz, inbox_cap=c, payload_words=f)
    net = _Net(box_data=tuple(jnp.asarray(data[:, i].reshape(r, -1))
                              for i in range(f)),
               box_src=(jnp.asarray(src.reshape(r, -1)),),
               box_size=(jnp.asarray(size.reshape(r, -1)),),
               box_count=jnp.asarray(count))
    jnet, jdrop = _batched_bin(
        cfg, net, t, *[jnp.asarray(a) for a in (msrc, dest, arrival,
                                                payload, msize, valid)])
    ring = [torch.tensor(a) for a in (data, src, size, count)]
    drop = route.bin_into_ring(*ring, *[torch.tensor(a) for a in (
        arrival, dest, msrc, msize, payload, valid)])
    for i in range(f):
        assert np.array_equal(np.asarray(jnet.box_data[i]),
                              ring[0][:, i].reshape(r, -1).numpy())
    assert np.array_equal(np.asarray(jnet.box_src[0]),
                          ring[1].reshape(r, -1).numpy())
    assert np.array_equal(np.asarray(jnet.box_size[0]),
                          ring[2].reshape(r, -1).numpy())
    assert np.array_equal(np.asarray(jnet.box_count), ring[3].numpy())
    assert np.array_equal(np.asarray(jdrop), drop.numpy())
    assert drop.sum() > 0 and (ring[3][:, t % hz] > 0).all()


def test_batched_scope_refusals():
    proto = Handel(**reference_default_params(64), device="cpu")
    with pytest.raises(ValueError, match="batched engine"):
        batched.scan_chunk_batched(proto, 40, superstep=1)
    with pytest.raises(ValueError, match="even chunk"):
        batched.scan_chunk_batched(proto, 41)
    run = batched.scan_chunk_batched(proto, 40, fast_forward=True)
    with no_vmap_fallback():
        nets, _ = run(*init_batched(proto, torch.arange(2)))
    assert nets.time.tolist() == [40, 40]        # fast-forward is ported


def test_batched_rejects_broadcast_protocols():
    """tests/test_batched.py:126: `scan_chunk_batched` keeps the JAX
    package's scope and refuses PingPong, in the JAX package's words
    (the harness runs it through the same engine)."""
    from wittgenstein_tpu.core.batched import scan_chunk_batched as jscb
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    texts = []
    for fn, proto in ((jscb, JPingPong(node_count=64)),
                      (batched.scan_chunk_batched,
                       PingPong(node_count=64, device="cpu"))):
        with pytest.raises(ValueError, match="broadcast-free") as e:
            fn(proto, 40)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
