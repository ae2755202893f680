"""The slice as a whole: the port's Handel on its per-ms engine
(wittgenstein_tpu_torch, CPU path) against the JAX package's Handel
through `Runner.run_ms`, full state leaf for leaf, bit for bit, at 64
and 256 nodes with 10% of them down (the benchmark's reference-default
parameters)."""

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu.core.network import Runner as JRunner
from wittgenstein_tpu.models.handel import Handel as JHandel
from wittgenstein_tpu.models.handel import cont_if_handel as j_cont
from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core.network import Runner
from wittgenstein_tpu_torch.models.handel import (Handel, cont_if_handel,
                                                  reference_default_params)

CHECKPOINTS = (20, 100, 200)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """At these sizes PyTorch's intra-op threads only fight over the
    cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [64, 256])
def test_init_equal(n):
    params = reference_default_params(n)
    for seed in (0, 5):
        ref = tp.jax_state(*JHandel(**params).init(seed))
        got = convert.to_numpy(*Handel(**params, device="cpu").init(seed))
        tp.assert_states_equal(ref, got, f"init n={n} seed={seed}")


@pytest.mark.parametrize("n", [64, 256])
def test_full_state_equal_after_run(n):
    """Both packages from their own init, and the port also from the JAX
    init carried across by `convert.from_reference`: every leaf equal at
    20, 100 and 200 ms; `cont_if_handel` agrees at each checkpoint."""
    params = reference_default_params(n)
    jproto = JHandel(**params)
    jnet, jps = jproto.init(1)
    start = tp.jax_state(jnet, jps)
    jrun = JRunner(jproto)
    ref = {}
    for t in range(20, CHECKPOINTS[-1] + 1, 20):
        jnet, jps = jrun.run_ms(jnet, jps, 20)
        if t in CHECKPOINTS:
            ref[t] = (tp.jax_state(jnet, jps), bool(j_cont(jnet, jps)))

    proto = Handel(**params, device="cpu")
    runner = Runner(proto)
    for label, state in (("own init", proto.init(1)),
                         ("converted init",
                          convert.from_reference(*start, "cpu"))):
        net, ps = state
        t = 0
        for cp in CHECKPOINTS:
            net, ps = runner.run_ms(net, ps, cp - t)
            t = cp
            tp.assert_states_equal(ref[cp][0], convert.to_numpy(net, ps),
                                   f"n={n} {label} at {cp} ms")
            assert bool(cont_if_handel(net, ps)) == ref[cp][1]
    assert int(net.time) == CHECKPOINTS[-1]
    assert int(ps.sigs_checked.sum()) > 0         # the run did real work


def test_determinism_and_seed_sensitivity():
    proto = Handel(**reference_default_params(64), device="cpu")
    runner = Runner(proto)

    def run(seed):
        return convert.to_numpy(*runner.run_ms(*proto.init(seed), 60))

    a, b, c = run(3), run(3), run(4)
    tp.assert_states_equal(a, b, "same seed")
    fa = convert.flatten({"net": a[0], "pstate": a[1]})
    fc = convert.flatten({"net": c[0], "pstate": c[1]})
    assert convert.first_difference(fa, fc) is not None


def test_cont_if_handel_finished_run():
    """All live nodes done with no extra cycles owed stops the run."""
    proto = Handel(**reference_default_params(64), device="cpu")
    net, ps = proto.init(0)
    assert bool(cont_if_handel(net, ps))
    nodes = net.nodes.replace(done_at=torch.ones_like(net.nodes.done_at))
    net = net.replace(nodes=nodes)
    assert bool(cont_if_handel(net, ps))          # extra cycles owed
    ps = ps.replace(added_cycle=torch.zeros_like(ps.added_cycle))
    assert not bool(cont_if_handel(net, ps))
    assert bool(proto.done(ps, net.nodes))


def test_state_roundtrip_through_convert():
    proto = Handel(**reference_default_params(64), device="cpu")
    net, ps = Runner(proto).run_ms(*proto.init(2), 30)
    once = convert.to_numpy(net, ps)
    twice = convert.to_numpy(*convert.from_reference(*once, "cpu"))
    tp.assert_states_equal(once, twice, "roundtrip")
    assert once[1]["q_sig"][0].dtype == np.uint32


@pytest.mark.parametrize("kw", [dict(mode="cardinal"),
                                dict(emission_mode="hashed"),
                                dict(snapshot_pool=False),
                                dict(state_split=2),
                                dict(byzantine_suicide=True),
                                dict(hidden_byzantine=True)],
                         ids=["cardinal", "hashed", "pool_free",
                              "state_split", "byzantine_suicide",
                              "hidden_byzantine"])
def test_scale_and_attack_modes_construct_and_step(kw):
    """Every mode the JAX constructor takes constructs in the port and
    steps 40 ms, every leaf equal to the JAX package's."""
    params = dict(reference_default_params(64), **kw)
    jproto = JHandel(**params)
    ref = tp.jax_state(*JRunner(jproto).run_ms(*jproto.init(1), 40))
    proto = Handel(**params, device="cpu")
    assert type(proto).__name__ == type(jproto).__name__
    net, ps = Runner(proto).run_ms(*proto.init(1), 40)
    tp.assert_states_equal(ref, convert.to_numpy(net, ps), str(kw))
    assert int(net.time) == 40


@pytest.mark.parametrize("field,value", [("box_split", 2)])
def test_engine_sub_planes_run(field, value):
    """Ring sub-planes on the per-ms engine, equal to the JAX package's
    after 40 ms; the fast-forward and superstep engines take them."""
    import dataclasses
    params = reference_default_params(64)
    jproto = JHandel(**params)
    proto = Handel(**params, device="cpu")
    for p in (jproto, proto):
        p.cfg = dataclasses.replace(p.cfg, **{field: value})
    ref = tp.jax_state(*JRunner(jproto).run_ms(*jproto.init(0), 40))
    tp.assert_states_equal(ref, convert.to_numpy(
        *Runner(proto).run_ms(*proto.init(0), 40)), f"{field}={value}")
    runner = Runner(proto, fast_forward=True)  # fast-forward is ported
    net, _ = runner.run_ms(*proto.init(0), 40)
    assert int(net.time) == 40 and runner.ff_stats() is not None
    assert len(net.box_src) == value
    Runner(proto, superstep=2)          # the superstep engine is ported


@pytest.mark.parametrize("field,value", [("bcast_slots", 2),
                                         ("spill_cap", 8)])
def test_engine_broadcast_and_spill_configs_run(field, value):
    """The Handel configurations the engine used to refuse: a broadcast
    table (recomputed and retired every ms, never filled: Handel sends
    no sendAll) and a spill buffer (drained every ms, its own route
    launch); every leaf equal to the JAX package's after 40 ms."""
    import dataclasses
    params = reference_default_params(64)
    jproto = JHandel(**params)
    proto = Handel(**params, device="cpu")
    for p in (jproto, proto):
        p.cfg = dataclasses.replace(p.cfg, **{field: value})
    ref = tp.jax_state(*JRunner(jproto).run_ms(*jproto.init(1), 40))
    net, ps = Runner(proto).run_ms(*proto.init(1), 40)
    tp.assert_states_equal(ref, convert.to_numpy(net, ps),
                           f"{field}={value}")
    assert getattr(net, {"bcast_slots": "bc_active",
                         "spill_cap": "sp_arrival"}[field]).shape == (value,)
    assert int(ps.sigs_checked.sum()) > 0
