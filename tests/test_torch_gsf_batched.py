"""GSF on a seed batch in the port: `GSFSignature.step` under
`torch.func.vmap` (the state a registered pytree, the merge and score
kernels custom ops whose vmap rules fold the seeds into their rows), on
the harness's engine at K=1 (`network.scan_chunk` on the batch, the
counterpart of ``jax.vmap(scan_chunk(...))``) and on the seed-folded
engine at K=2 (`core/batched.scan_chunk_batched`), each against the JAX
package and against the port's one-seed runs, full state, tolerance 0;
`run_multiple_times` on GSF against the JAX harness; K4 and K5 under
vmap against one call per seed and the JAX kernels in interpret mode;
and a batch's state through `convert` both ways.  Every run here turns
vmap's per-seed fallback warning into an error.  The `cuda` tests hold
the vmap rules and a 256-node seed batch on the card against the CPU."""

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.utils import _pytree as pytree

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import batched, harness, network
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.gsf import GSFSignature, cont_if_gsf
from wittgenstein_tpu_torch.ops import gsf_merge, score

# tests/test_gsf.py::test_gsf_pallas_merge_bit_equal's configuration: a
# small queue forces evictions.
EVICTIONS = dict(node_count=128, threshold=115, nodes_down=12, queue_cap=4,
                 inbox_cap=8,
                 network_latency_name="NetworkLatencyByDistanceWJitter")
SEEDS, MS = 3, 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    from test_torch_batched import no_vmap_fallback
    with no_vmap_fallback():
        yield


def _run(k):
    proto = GSFSignature(**EVICTIONS, device="cpu")
    nets, ps = init_batched(proto, torch.arange(SEEDS))
    chunk = (network.scan_chunk(proto, MS) if k == 1 else
             batched.scan_chunk_batched(proto, MS, superstep=k))
    return chunk(nets, ps)


@pytest.fixture(scope="module")
def runs():
    """The port's batch at K=1 and K=2, with the launch counts of the
    K=2 run (none: CPU tensors take the plain versions)."""
    launches = gsf_merge.gsf_merge.launches, score.gsf_score.launches
    out = {k: _run(k) for k in (1, 2)}
    assert (gsf_merge.gsf_merge.launches,
            score.gsf_score.launches) == launches
    return out


def _jax_batch(k):
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import scan_chunk_batched
    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.gsf import GSFSignature as JGSF
    jproto = JGSF(**EVICTIONS)
    nets, ps = jax.vmap(jproto.init)(jnp.arange(SEEDS, dtype=jnp.int32))
    run = (jax.vmap(scan_chunk(jproto, MS)) if k == 1 else
           scan_chunk_batched(jproto, MS, superstep=k))
    return tp.jax_state(*jax.jit(run)(nets, ps))


@pytest.mark.parametrize("k", [1, 2])
def test_seed_batch_matches_jax(runs, k):
    """K=1: ``jax.jit(jax.vmap(scan_chunk(proto, 300)))``, the JAX
    harness's chunk; K=2: the JAX seed-folded `scan_chunk_batched`."""
    got = convert.to_numpy(*runs[k])
    tp.assert_states_equal(_jax_batch(k), got, f"GSF batch at K={k}")
    assert got[0]["time"].tolist() == [MS] * SEEDS
    assert got[1]["evicted"].sum() > 0              # the queue overflowed
    assert (got[1]["sigs_checked"].sum(1) > 0).all()


def test_seed_batch_matches_one_seed_runs(runs):
    proto = GSFSignature(**EVICTIONS, device="cpu")
    runner = network.Runner(proto)
    digests = {k: convert.seed_digests(*convert.to_numpy(*v))
               for k, v in runs.items()}
    for r in range(SEEDS):
        one = convert.state_digest(*convert.to_numpy(
            *runner.run_ms(*proto.init(r), MS)))
        assert digests[1][r] == one, f"seed {r} at K=1"
        assert digests[2][r] == one, f"seed {r} at K=2"


def test_harness_multirun_matches_jax():
    """tests/test_gsf.py::test_harness_multirun's arguments: both stop
    every run at the same ms, with equal stats and final states."""
    from wittgenstein_tpu.models.gsf import GSFSignature as JGSF
    from wittgenstein_tpu.models.gsf import cont_if_gsf as jcont
    kw = dict(node_count=64, threshold=58, nodes_down=4,
              network_latency_name="NetworkNoLatency")
    from wittgenstein_tpu.core import harness as jharness
    from wittgenstein_tpu.utils import stats as jstats
    from wittgenstein_tpu_torch.utils import stats
    getters = ("done_count", "msg_sent_stats")
    jres = jharness.run_multiple_times(
        JGSF(**kw), run_count=2, max_time=3000, chunk=250, cont_if=jcont,
        stats_getters=[getattr(jstats, g) for g in getters])
    res = harness.run_multiple_times(
        GSFSignature(**kw, device="cpu"), run_count=2, max_time=3000,
        chunk=250, cont_if=cont_if_gsf,
        stats_getters=[getattr(stats, g) for g in getters])
    assert res.stopped_at.tolist() == np.asarray(jres.stopped_at).tolist()
    assert (res.stopped_at > 0).all()
    assert res.stats == jres.stats
    tp.assert_states_equal(tp.jax_state(jres.nets, jres.pstates),
                           convert.to_numpy(res.nets, res.pstates),
                           "GSF harness")


def _score_case(rng, r, n=256, q=8, levels=9):
    """tests/test_pallas_score.py::test_gsf_score_kernel_bit_equal's case
    (256 nodes, q 8, levels 0 to the top, random dense bitsets), R seeds
    of it."""
    w = n // 32
    u32 = dict(dtype=np.uint32)
    return [rng.integers(0, 2 ** 32, (r, n, q, w), **u32),
            rng.integers(0, levels, (r, n, q)).astype(np.int32),
            rng.integers(0, 2 ** 32, (r, n, w), **u32),
            rng.integers(0, 2 ** 32, (r, n, w), **u32)]


def _i32(a):
    a = np.asarray(a)
    return torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _jax_out(fn, args, **kw):
    import jax.numpy as jnp
    return [np.asarray(o) for o in fn(*[jnp.asarray(a) for a in args],
                                       **kw)]


def _same(ref, got, what):
    for j, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} output {j}")


def _score_zero_and_full():
    """`tests/test_torch_kernels.py::test_gsf_score_zero_and_full_rows`'s
    two cases as two seeds: all-zero and all-ones sigs against all-ones
    and all-zero rows, at level 0, 1, the top level and 3."""
    n, q, levels = 64, 4, 7
    w = n // 32
    fills = (0, 0xFFFFFFFF)
    return [np.stack([np.full((n, q, w), f, np.uint32) for f in fills]),
            np.tile(np.array([0, 1, levels - 1, 3], np.int32), (2, n, 1)),
            np.stack([np.full((n, w), 0xFFFFFFFF - f, np.uint32)
                      for f in fills]),
            np.full((2, n, w), 0xFFFFFFFF, np.uint32)]


@pytest.mark.parametrize("case", ["random", "zero_and_full"])
def test_gsf_score_under_vmap(case):
    """Through the vmap rule, node ids unbatched as in the step: equal to
    one call a seed and to the JAX kernel in interpret mode on each."""
    from wittgenstein_tpu.ops.pallas_score import gsf_score_pallas
    sig, elvl, ver, ind = (_score_case(np.random.default_rng(23), 3)
                           if case == "random" else _score_zero_and_full())
    r = sig.shape[0]
    ids = np.arange(sig.shape[1], dtype=np.int32)
    args = [_i32(sig), _i32(elvl), torch.tensor(ids), _i32(ver), _i32(ind)]
    got = torch.func.vmap(score.gsf_score, in_dims=(0, 0, None, 0, 0))(
        *args)
    for i in range(r):
        one = score.gsf_score(args[0][i], args[1][i], args[2], args[3][i],
                              args[4][i])
        _same([o.numpy() for o in one], [g[i] for g in got], f"seed {i}")
        _same(_jax_out(gsf_score_pallas, (sig[i], elvl[i], ids, ver[i],
                                          ind[i]), interpret=True),
              [g[i] for g in got], f"JAX seed {i}")


@pytest.mark.parametrize("q_cap,s_cap,w", [(16, 16, 8), (4, 8, 4),
                                           (8, 3, 2)])
def test_gsf_merge_under_vmap(q_cap, s_cap, w):
    """`tests/test_torch_kernels.py`'s GSF merge cases with a seed axis:
    equal to one call a seed and to `gsf_merge_pallas` in interpret mode
    on each; got_add [R, N, W] and kept_ex_agg [R, N] come back with the
    seed axis."""
    from test_torch_kernels import _gsf_merge_case
    from wittgenstein_tpu.ops.pallas_gsf_merge import gsf_merge_pallas
    rng = np.random.default_rng(q_cap * 100 + s_cap)
    cases = [_gsf_merge_case(rng, 64, q_cap, s_cap, w, n_ids=32 * w)
             for _ in range(2)]
    args = [_i32(np.stack(col)) for col in zip(*cases)]
    got = torch.func.vmap(gsf_merge.gsf_merge, in_dims=(0,) * 10 + (None,))(
        *args, 8)
    assert got[4].shape == (2, 64, w) and got[5].shape == (2, 64)
    for i, case in enumerate(cases):
        one = gsf_merge.gsf_merge(*[a[i] for a in args], 8)
        _same([o.numpy() for o in one], [g[i] for g in got], f"seed {i}")
        _same(_jax_out(gsf_merge_pallas, case, levels=8, interpret=True),
              [g[i] for g in got], f"JAX seed {i}")
    assert int(got[4].ne(0).sum()) > 0 and int(got[5].sum()) > 0


def test_batch_state_through_convert(runs):
    """A seed batch to numpy (the JAX package's `jax.vmap` layout) and
    back: every leaf equal, and each seed's slice equal to that seed's
    state converted alone."""
    once = convert.to_numpy(*runs[2])
    back = convert.from_reference(*once, "cpu")
    tp.assert_states_equal(once, convert.to_numpy(*back), "roundtrip")
    assert back[0].box_data.shape[:2] == (SEEDS, 3)
    one = pytree.tree_map(lambda x: x[1], runs[2])
    tp.assert_states_equal(pytree.tree_map(lambda x: x[1], once),
                           convert.to_numpy(*one), "seed 1")


def test_cont_if_gsf_under_vmap(runs):
    still = torch.func.vmap(cont_if_gsf)(*runs[1])
    assert still.shape == (SEEDS,)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gsf_kernels_vmap_rules():
    """K4 and K5 through their vmap rules on the card: one launch each
    for all seeds, equal to the plain versions on the CPU."""
    from test_torch_kernels import _gsf_merge_case
    dev = _cuda()
    rng = np.random.default_rng(3)
    sig, elvl, ver, ind = _score_case(rng, 4)
    ids = torch.arange(sig.shape[1], dtype=torch.int32)
    sargs = [_i32(sig), _i32(elvl), ids, _i32(ver), _i32(ind)]
    dims = (0, 0, None, 0, 0)
    before = score.gsf_score.launches
    got = torch.func.vmap(score.gsf_score, in_dims=dims)(
        *[a.to(dev) for a in sargs])
    assert score.gsf_score.launches == before + 1
    want = torch.func.vmap(score.gsf_score, in_dims=dims)(*sargs)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)
    cases = [_gsf_merge_case(rng, 256, 16, 16, 8, n_ids=256)
             for _ in range(4)]
    margs = [_i32(np.stack(col)) for col in zip(*cases)]
    before = gsf_merge.gsf_merge.launches
    got = torch.func.vmap(gsf_merge.gsf_merge, in_dims=(0,) * 10 + (None,))(
        *[a.to(dev) for a in margs], 8)
    assert gsf_merge.gsf_merge.launches == before + 1
    want = torch.func.vmap(gsf_merge.gsf_merge,
                           in_dims=(0,) * 10 + (None,))(*margs, 8)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)


@pytest.mark.cuda
def test_cuda_gsf_seed_batch_matches_cpu():
    """A 256-node GSF batch of 2 seeds for 100 ms at K=1 and K=2 on the
    card equals the same batch on the CPU."""
    dev = _cuda()
    for k in (1, 2):
        out = {}
        for d in ("cpu", dev):
            proto = GSFSignature(node_count=256, device=d)
            nets, ps = init_batched(proto, torch.arange(2))
            chunk = (network.scan_chunk(proto, 100) if k == 1 else
                     batched.scan_chunk_batched(proto, 100, superstep=k))
            out[str(d)] = convert.seed_digests(
                *convert.to_numpy(*chunk(nets, ps)))
        assert out["cpu"] == out[str(dev)], f"K={k}"
