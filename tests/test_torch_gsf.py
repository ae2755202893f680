"""The GSF slice as a whole: the port's GSFSignature on its per-ms engine
(wittgenstein_tpu_torch, CPU path) against the JAX package's
GSFSignature through `Runner.run_ms`, full state leaf for leaf, bit for
bit (tolerance 0), at 64, 128 and 256 nodes, the eviction configuration
of the JAX package's own tests included."""

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu.core.network import Runner as JRunner
from wittgenstein_tpu.models.gsf import GSFSignature as JGSF
from wittgenstein_tpu.models.gsf import cont_if_gsf as j_cont
from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core.network import Runner
from wittgenstein_tpu_torch.core.protocol import get_protocol
from wittgenstein_tpu_torch.models.gsf import GSFSignature, cont_if_gsf

# tests/test_gsf.py::test_run_to_done_and_determinism and
# ::test_gsf_pallas_merge_bit_equal (a small queue forces evictions).
RUN_TO_DONE = dict(node_count=128, threshold=115, pairing_time=3,
                   period_duration_ms=10, accelerated_calls_count=10,
                   nodes_down=12,
                   network_latency_name="NetworkLatencyByDistanceWJitter")
EVICTIONS = dict(node_count=128, threshold=115, nodes_down=12, queue_cap=4,
                 inbox_cap=8,
                 network_latency_name="NetworkLatencyByDistanceWJitter")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes PyTorch's CPU ops are too
    small to share, and the suite's workers share the machine's cores,
    where many threads per worker slow every worker down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [64, 256])
def test_init_equal(n):
    for seed, kw in ((0, {}), (5, dict(nodes_down=n // 10,
                                       threshold=n - n // 10))):
        ref = tp.jax_state(*JGSF(node_count=n, **kw).init(seed))
        got = convert.to_numpy(*GSFSignature(node_count=n, **kw,
                                             device="cpu").init(seed))
        tp.assert_states_equal(ref, got, f"init n={n} seed={seed}")


@pytest.mark.parametrize("case,seed,ms", [("run_to_done", 0, 500),
                                          ("evictions", 7, 600)])
def test_full_state_equal_after_run(case, seed, ms):
    """Both packages from their own init, every leaf equal every 100 ms
    and `cont_if_gsf` agreeing at each checkpoint; then the port again
    from the JAX state at about half time, carried across by
    `convert.from_reference`, equal at the end."""
    kw = RUN_TO_DONE if case == "run_to_done" else EVICTIONS
    jproto = JGSF(**kw)
    jnet, jps = jproto.init(seed)
    jrun = JRunner(jproto)
    proto = GSFSignature(**kw, device="cpu")
    runner = Runner(proto)
    net, ps = proto.init(seed)
    half = ms // 200 * 100
    for t in range(100, ms + 1, 100):
        jnet, jps = jrun.run_ms(jnet, jps, 100)
        net, ps = runner.run_ms(net, ps, 100)
        ref = tp.jax_state(jnet, jps)
        tp.assert_states_equal(ref, convert.to_numpy(net, ps),
                               f"{case} at {t} ms")
        assert bool(cont_if_gsf(net, ps)) == bool(j_cont(jnet, jps))
        if t == half:
            mid = ref
    assert int(net.time) == ms
    assert int(ps.sigs_checked.sum()) > 0         # the run did real work
    assert int(net.dropped) == 0 and int(net.clamped) == 0
    if case == "evictions":
        assert int(ps.evicted) > 0
    net, ps = runner.run_ms(*convert.from_reference(*mid, "cpu"), ms - half)
    tp.assert_states_equal(ref, convert.to_numpy(net, ps),
                           f"{case} from the converted {half}-ms state")


def test_default_params_until_done():
    """256 nodes with every parameter at its default, in 100-ms calls
    until `done`, compared after each call."""
    jproto = JGSF(node_count=256)
    proto = GSFSignature(node_count=256, device="cpu")
    jstate, state = jproto.init(0), proto.init(0)
    jrun, run = JRunner(jproto), Runner(proto)
    for t in range(100, 2001, 100):
        jstate = jrun.run_ms(*jstate, 100)
        state = run.run_ms(*state, 100)
        tp.assert_states_equal(tp.jax_state(*jstate),
                               convert.to_numpy(*state), f"at {t} ms")
        done = bool(proto.done(state[1], state[0].nodes))
        assert done == bool(jproto.done(jstate[1], jstate[0].nodes))
        if done:
            break
    assert done, "GSF at 256 nodes did not finish in 2000 ms"


def test_determinism_and_seed_sensitivity():
    proto = GSFSignature(node_count=64, device="cpu")
    runner = Runner(proto)

    def run(seed):
        return convert.to_numpy(*runner.run_ms(*proto.init(seed), 120))

    a, b, c = run(3), run(3), run(4)
    tp.assert_states_equal(a, b, "same seed")
    fa = convert.flatten({"net": a[0], "pstate": a[1]})
    fc = convert.flatten({"net": c[0], "pstate": c[1]})
    assert convert.first_difference(fa, fc) is not None


def test_cont_if_gsf_finished_run():
    """Every live node done stops the run; a down node never blocks it."""
    proto = GSFSignature(node_count=64, nodes_down=6, threshold=58,
                         device="cpu")
    net, ps = proto.init(0)
    assert bool(cont_if_gsf(net, ps))
    assert not bool(proto.done(ps, net.nodes))
    live = ~net.nodes.down
    nodes = net.nodes.replace(done_at=live.to(torch.int32) * 7)
    net = net.replace(nodes=nodes)
    assert not bool(cont_if_gsf(net, ps))
    assert bool(proto.done(ps, net.nodes))


def test_state_roundtrip_through_convert():
    proto = GSFSignature(**EVICTIONS, device="cpu")
    net, ps = Runner(proto).run_ms(*proto.init(2), 120)
    once = convert.to_numpy(net, ps)
    twice = convert.to_numpy(*convert.from_reference(*once, "cpu"))
    tp.assert_states_equal(once, twice, "roundtrip")
    assert once[1]["q_sig"].dtype == np.uint32       # one array, not pieces
    assert once[1]["q_indiv"].dtype == np.bool_
    assert convert.state_class(once[1]) is type(ps)


def test_argmax_ties_take_the_first_slot():
    """Planted ties in the verification scores (identical queue entries)
    pick the first slot, as `jnp.argmax` does."""
    import jax.numpy as jnp

    n, q = 64, 16
    jproto = JGSF(node_count=n, queue_cap=q)
    jnet, jps = jproto.init(0)
    rng = np.random.default_rng(3)
    ids = np.arange(n)
    lvl = rng.integers(1, jproto.levels, (n, 1)).repeat(q, 1)
    half = np.where(lvl > 0, 1 << np.maximum(lvl - 1, 0), 0)
    peer = (ids[:, None] ^ half) & ~(half - 1) | rng.integers(0, 2, (n, q))
    sig = rng.integers(0, 2 ** 32, (n, 1, jproto.w), dtype=np.uint32)
    filled = rng.random((n, q)) < 0.7
    jps = jps.replace(
        q_from=jnp.asarray(np.where(filled, peer, -1).astype(np.int32)),
        q_lvl=jnp.asarray(lvl.astype(np.int32)),
        q_sig=jnp.asarray(np.broadcast_to(sig, (n, q, jproto.w))))
    ref_in = tp.jax_state(jnet, jps)
    ids_j = jnp.arange(n, dtype=jnp.int32)
    t = 1
    ref = jproto._pick_verification(
        jps, jnet.nodes, t, jproto._word_onehot(ids_j),
        jproto._subword_masks(ids_j), ids_j >> 5)
    proto = GSFSignature(node_count=n, queue_cap=q, device="cpu")
    net, ps = convert.from_reference(*ref_in, "cpu")
    got = proto._pick_verification(ps, net.nodes, t)
    want = tp.jax_nested(ref)
    assert (np.asarray(want["pend_from"]) >= 0).sum() > n // 2
    tp.assert_states_equal((ref_in[0], want),
                           (ref_in[0], convert.to_numpy(net, got)[1]),
                           "pick with ties")


def test_level_pc_matches_einsum_at_4096():
    """The port's integer prefix `_level_pc` against the JAX GSF path's
    f32 one-hot einsum at 4096-node widths, on random rows."""
    import jax.numpy as jnp

    n = 4096
    jproto = JGSF(node_count=n)
    proto = GSFSignature(node_count=n, device="cpu")
    rows = np.random.default_rng(5).integers(0, 2 ** 32, (n, jproto.w),
                                             dtype=np.uint32)
    rows[::7] = 0xFFFFFFFF
    ids = jnp.arange(n, dtype=jnp.int32)
    ref = jproto._level_pc(jnp.asarray(rows), jproto._word_onehot(ids),
                           jproto._subword_masks(ids), ids >> 5)
    got = proto._level_pc(torch.tensor(rows.view(np.int32)),
                          proto._subword_masks(),
                          torch.arange(n, dtype=torch.int32) >> 5)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_constructor_refusals():
    with pytest.raises(ValueError, match="255"):
        GSFSignature(node_count=64, queue_cap=200, inbox_cap=28,
                     device="cpu")
    GSFSignature(node_count=64, queue_cap=199, inbox_cap=28, device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        GSFSignature(node_count=100, device="cpu")
    assert get_protocol("GSFSignature") is GSFSignature
