"""The fast-forward engine of the port (`core/network.fast_forward_chunk`,
`next_work`, `Runner(fast_forward=True)` and
`core/batched.fast_forward_chunk_batched`): the counterparts of
tests/test_fast_forward.py.  A skipped ms is a no-op step, so every run
equals the dense engine's state leaf for leaf (tolerance 0), and the
skip counts equal the JAX engine's for the same run: Handel and PingPong
at 64 nodes, 2 seeds, 320 ms with the seed axis; the seed-folded engine
with even skips; the stats-free `scan_chunk(fast_forward=True)` on one
run; the oracle against the JAX oracle and a brute-force truth on
randomized rings and broadcast tables; the gate's refusals in the JAX
package's words; `Runner.ff_stats`.  Every run here turns vmap's
per-seed fallback warning into an error.  The `cuda` test holds a
256-node fast-forwarded PingPong on the card against the CPU."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import batched, network
from wittgenstein_tpu_torch.core.protocol import FAR_FUTURE
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.gsf import GSFSignature
from wittgenstein_tpu_torch.models.handel import Handel
from wittgenstein_tpu_torch.models.pingpong import PingPong

#: tests/test_fast_forward.py's configurations
PARAMS = {
    "Handel": dict(node_count=64, threshold=56, nodes_down=6,
                   pairing_time=4, dissemination_period_ms=20,
                   level_wait_time=50, fast_path=10),
    "PingPong": dict(node_count=64)}
MS, SEEDS = 320, 2


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


def _port(name):
    return {"Handel": Handel, "PingPong": PingPong}[name](**PARAMS[name],
                                                          device="cpu")


def _jax(name):
    from wittgenstein_tpu.models.handel import Handel as JHandel
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    return {"Handel": JHandel, "PingPong": JPingPong}[name](**PARAMS[name])


def _jax_ff(jproto, run, seeds=SEEDS):
    """``run`` (a JAX fast-forward chunk) on ``jax.vmap(init)`` of the
    seeds: the state as numpy dicts and the skip counts as ints."""
    import jax
    import jax.numpy as jnp
    nets, ps, stats = jax.jit(run)(*jax.vmap(jproto.init)(
        jnp.arange(seeds, dtype=jnp.int32)))
    return tp.jax_state(nets, ps), {k: int(v) for k, v in stats.items()}


@pytest.mark.parametrize("name", ["Handel", "PingPong"])
def test_seed_axis_matches_dense_and_jax(name):
    """`fast_forward_chunk(seed_axis=True)` against the port's dense
    chunk on the same batch and against the JAX engine's fast-forward:
    equal states, equal skip counts, something skipped, the whole chunk
    advanced."""
    from wittgenstein_tpu.core.network import fast_forward_chunk as jff
    proto = _port(name)
    dense = network.scan_chunk(proto, MS)(*init_batched(
        proto, torch.arange(SEEDS)))
    nets, ps, stats = network.fast_forward_chunk(proto, MS, seed_axis=True)(
        *init_batched(proto, torch.arange(SEEDS)))
    got = convert.to_numpy(nets, ps)
    tp.assert_states_equal(convert.to_numpy(*dense), got, f"{name} dense")
    ref, jstats = _jax_ff(_jax(name), jff(_jax(name), MS, seed_axis=True))
    tp.assert_states_equal(ref, got, f"{name} JAX")
    assert stats == jstats
    assert 0 < stats["skipped_ms"] < MS and stats["jump_count"] > 0
    assert nets.time.tolist() == [MS] * SEEDS


def test_batched_engine_matches_scan_chunk_batched():
    """The seed-folded engine at K=2 with batch-minimum jumps: equal to
    `scan_chunk_batched`, skips even, the skip counts equal the JAX
    `fast_forward_chunk_batched`'s."""
    from wittgenstein_tpu.core.batched import \
        fast_forward_chunk_batched as jffb
    proto = _port("Handel")
    dense = batched.scan_chunk_batched(proto, MS)(*init_batched(
        proto, torch.arange(SEEDS)))
    nets, ps, stats = batched.fast_forward_chunk_batched(proto, MS)(
        *init_batched(proto, torch.arange(SEEDS)))
    got = convert.to_numpy(nets, ps)
    tp.assert_states_equal(convert.to_numpy(*dense), got, "batched")
    assert stats["skipped_ms"] > 0 and stats["skipped_ms"] % 2 == 0
    ref, jstats = _jax_ff(_jax("Handel"), jffb(_jax("Handel"), MS))
    tp.assert_states_equal(ref, got, "JAX batched")
    assert stats == jstats
    run = batched.scan_chunk_batched(proto, 40, fast_forward=True)
    assert run(*init_batched(proto, torch.arange(SEEDS)))[0].time.tolist() \
        == [40] * SEEDS


def test_scan_chunk_wrapper_single_run():
    """`scan_chunk(fast_forward=True)`, the stats-free interface, on one
    run against the dense chunk."""
    proto = _port("PingPong")
    ref = network.scan_chunk(proto, 300)(*proto.init(0))
    net, ps = network.scan_chunk(proto, 300, fast_forward=True)(
        *proto.init(0))
    tp.assert_states_equal(convert.to_numpy(*ref), convert.to_numpy(net, ps),
                           "single run")
    assert int(ps.pongs) > 0 and int(net.time) == 300


def test_oracle_never_over_jumps_on_randomized_mailbox():
    """tests/test_fast_forward.py:191's property on the same randomized
    rings and broadcast tables of PingPong(32): the port's `next_work`
    equals the JAX `next_work` and lies in [t, the brute-force next
    event]; on a batch of two such states it is their minimum."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import broadcast_arrivals
    from wittgenstein_tpu.core.network import next_work as jnext_work
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong

    jproto = JPingPong(node_count=32)
    proto = PingPong(node_count=32, device="cpu")
    cfg = jproto.cfg
    rng = np.random.default_rng(7)
    net0, ps = jproto.init(0)
    h, n, b = cfg.horizon, cfg.n, cfg.bcast_slots
    oracle = jax.jit(lambda net, ps: jnext_work(jproto, net, ps, net.time))
    states, answers = [], []
    for trial in range(8):
        t = int(rng.integers(0, 3 * h))
        box_count = np.zeros((h, n), np.int32)
        for _ in range(int(rng.integers(0, 4))):
            rel = int(rng.integers(0, h))
            box_count[(t + rel) % h, rng.integers(0, n)] = \
                int(rng.integers(1, cfg.inbox_cap))
        bc_active = rng.random(b) < 0.5
        bc_time = (t - rng.integers(0, h, size=b)).astype(np.int32)
        net = net0.replace(
            time=jnp.asarray(t, jnp.int32),
            box_count=jnp.asarray(box_count),
            bc_active=jnp.asarray(bc_active),
            bc_time=jnp.asarray(bc_time),
            bc_seed=jnp.asarray(rng.integers(0, 1 << 30, size=b),
                                jnp.int32))
        want = int(oracle(net, ps))
        arrival, ok, _ = broadcast_arrivals(cfg, jproto.latency, net,
                                            net.nodes)
        arrival, ok = np.asarray(arrival), np.asarray(ok)
        truth = FAR_FUTURE
        for u in range(t, t + h):
            if box_count[u % h].any() or (ok & (arrival == u)).any():
                truth = u
                break
        state = convert.from_reference(*tp.jax_state(net, ps), "cpu")
        got = int(network.next_work(proto, *state, t))
        assert got == want, (trial, t, got, want)
        assert t <= got <= truth, (trial, t, got, truth)
        states.append(state)
        answers.append((t, got))
    # A batch of two states at one time t: the minimum of the two.
    t, a = answers[0]
    second = states[1][0].replace(time=states[0][0].time)
    b_alone = int(network.next_work(proto, second, states[1][1], t))
    pair = [states[0], (second, states[1][1])]
    batch = torch.utils._pytree.tree_map(lambda *x: torch.stack(x), *pair)
    assert int(network.next_work(proto, *batch, t)) == min(a, b_alone)


def test_fast_forward_rejects_bad_configs():
    """tests/test_fast_forward.py:172's refusals, in the JAX package's
    words; and what the port refuses beside them: frozen runs, and a
    state whose layout is not the chunk's."""
    from wittgenstein_tpu.core.batched import \
        fast_forward_chunk_batched as jffb
    from wittgenstein_tpu.core.network import fast_forward_ok as jok
    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu.models.gsf import GSFSignature as JGSF

    def message(fn, *args, **kw):
        with pytest.raises(ValueError) as e:
            fn(*args, **kw)
        return str(e.value)

    jproto, proto = _jax("Handel"), _port("Handel")
    for kw in (dict(t0_mod=0), dict(superstep=8)):
        assert message(network.scan_chunk, proto, 40, fast_forward=True,
                       **kw) == message(jscan, jproto, 40,
                                        fast_forward=True, **kw)
    network.scan_chunk(proto, 40, superstep=2, fast_forward=True)
    jproto.cfg = dataclasses.replace(jproto.cfg, spill_cap=8)
    proto.cfg = dataclasses.replace(proto.cfg, spill_cap=8)
    assert "spill_cap" in message(network.scan_chunk, proto, 40,
                                  fast_forward=True)
    assert message(network.scan_chunk, proto, 40, fast_forward=True) == \
        message(jscan, jproto, 40, fast_forward=True)
    assert not network.fast_forward_ok(proto) and not jok(jproto)
    gsf = GSFSignature(node_count=64, device="cpu")
    assert not network.fast_forward_ok(gsf)
    assert message(batched.fast_forward_chunk_batched, gsf, 40) == \
        message(jffb, JGSF(node_count=64), 40)
    pp = _port("PingPong")
    run = network.fast_forward_chunk(pp, 40)
    with pytest.raises(ValueError, match="frozen"):
        run(*pp.init(0), frozen=torch.zeros(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="seed_axis"):
        run(*init_batched(pp, torch.arange(2)))


def test_runner_ff_stats_match_jax():
    """`Runner(fast_forward=True)` on PingPong(64) in 100-ms calls to
    300 ms: the JAX `Runner`'s state and `ff_stats`; a protocol without
    the oracle runs dense and reports no stats, as in JAX."""
    from wittgenstein_tpu.core.network import Runner as JRunner
    jproto, proto = _jax("PingPong"), _port("PingPong")
    jrun, run = JRunner(jproto, fast_forward=True), network.Runner(
        proto, fast_forward=True)
    jstate, state = jproto.init(0), proto.init(0)
    for _ in range(3):
        jstate, state = jrun.run_ms(*jstate, 100), run.run_ms(*state, 100)
    tp.assert_states_equal(tp.jax_state(*jstate), convert.to_numpy(*state),
                           "Runner")
    assert run.ff_stats() == jrun.ff_stats()
    assert run.ff_stats()["skipped_ms"] > 0
    gsf = GSFSignature(node_count=64, device="cpu")
    runner = network.Runner(gsf, fast_forward=True)
    net, ps = runner.run_ms(*gsf.init(0), 20)
    assert runner.ff_stats() is None and int(net.time) == 20


def test_handel_oracle_matches_jax_mid_run():
    """Handel's `next_action_time` equals the JAX mixin's at every t of a
    window, on a mid-run state of each seed and on variants of it that
    make each of its terms the earliest: queues with holes (the
    compaction term), no pending verification, no fast-path bits, empty
    queues (only the dissemination ticks left)."""
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import Runner as JRunner
    jproto, proto = _jax("Handel"), _port("Handel")
    for seed in range(SEEDS):
        jnet, jps = JRunner(jproto).run_ms(*jproto.init(seed), 63)
        base = tp.jax_nested(jps)
        q_from = base["q_from"]
        holes = q_from.copy()           # slot 0 empty, slot 1 taken
        holes[:, 0] = -1
        holes[:, 1] = np.where(q_from[:, 1] >= 0, q_from[:, 1],
                               np.arange(len(q_from)) ^ 1)
        variants = {
            "as run": {},
            "holes": {"q_from": holes, "pend_from": np.full_like(
                base["pend_from"], -1), "fast_pending": np.zeros_like(
                    base["fast_pending"])},
            "no pending": {"pend_from": np.full_like(base["pend_from"], -1)},
            "no fast path": {"fast_pending": np.zeros_like(
                base["fast_pending"])},
            "empty queues": {"q_from": np.full_like(q_from, -1),
                             "pend_from": np.full_like(base["pend_from"],
                                                       -1),
                             "fast_pending": np.zeros_like(
                                 base["fast_pending"])}}
        for name, change in variants.items():
            jv = jps.replace(**{k: jnp.asarray(v) for k, v in change.items()})
            net, ps = convert.from_reference(*tp.jax_state(jnet, jv), "cpu")
            for t in range(63, 90):
                assert int(proto.next_action_time(ps, net.nodes, t)) == int(
                    jproto.next_action_time(jv, jnet.nodes, t)), (
                        seed, name, t)
        assert (holes != q_from).any()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fast_forward_pingpong_matches_cpu():
    """A 256-node PingPong fast-forwarded on the card, one run in 100-ms
    calls and a 2-seed batch at K=2, equals the same runs on the CPU,
    skip counts included."""
    dev = _cuda()
    out = {}
    for d in ("cpu", dev):
        proto = PingPong(node_count=256, device=d)
        runner = network.Runner(proto, fast_forward=True)
        state = proto.init(0)
        for _ in range(4):
            state = runner.run_ms(*state, 100)
        nets, ps, stats = network.fast_forward_chunk(
            proto, 200, seed_axis=True, superstep=2)(
                *init_batched(proto, torch.arange(2)))
        out[str(d)] = (convert.state_digest(*convert.to_numpy(*state)),
                       runner.ff_stats(),
                       convert.seed_digests(*convert.to_numpy(nets, ps)),
                       stats)
    assert out["cpu"] == out[str(dev)]
    assert out["cpu"][1]["skipped_ms"] > 0
