"""Slush, Snowflake and Paxos in the port (`wittgenstein_tpu_torch/models/
avalanche.py`, `models/paxos.py`) against the JAX package's, leaf for
leaf (tolerance 0), on the cases of `tests/test_committee.py`: Slush at
100 nodes fast-forwarded to 3,000 ms (the JAX engine's skip counts) and
its 64-node determinism configuration dense, in a seed batch under
`torch.func.vmap` at K=2 and fast-forwarded; Snowflake at 64 nodes;
Paxos with 3 + 3 and 5 + 4 nodes to agreement, one run and a seed
batch.  The JAX tests' own assertions hold on the port's runs
(convergence, every node decided, Paxos safety, zero drops)."""

import numpy as np
import pytest
import torch
import torch_parity as tp
from test_torch_batched import no_vmap_fallback

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models import avalanche, paxos


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name, **kw):
    """(JAX protocol, port protocol on the CPU)."""
    import importlib
    mod = {"Slush": "avalanche", "Snowflake": "avalanche",
           "Paxos": "paxos"}[name]
    jmod = importlib.import_module(f"wittgenstein_tpu.models.{mod}")
    tmod = {"avalanche": avalanche, "paxos": paxos}[mod]
    return getattr(jmod, name)(**kw), getattr(tmod, name)(**kw, device="cpu")


def _converged(color, decided):
    """tests/test_committee.py:17-21."""
    assert decided.all(), "every node must decide"
    counts = np.bincount(color, minlength=3)
    assert counts[0] == 0, "no node may stay uncolored"
    return counts[1] == 0 or counts[2] == 0


def _jax_ff(jproto, ms, chunk):
    """The JAX `Runner(fast_forward=True)` from seed 0 in `chunk`-ms
    calls: its state after each call and its skip counts."""
    from wittgenstein_tpu.core.network import Runner
    runner = Runner(jproto, donate=False, fast_forward=True)
    state, out = jproto.init(0), {}
    for t in range(chunk, ms + 1, chunk):
        state = runner.run_ms(*state, chunk)
        out[t] = tp.jax_state(*state)
    return out, runner.ff_stats()


@pytest.mark.parametrize("name", ["Slush", "Snowflake"])
def test_avalanche_fast_forward_matches_jax(name):
    """Slush (100 nodes, M 5, K 7; tests/test_committee.py:24) to 3,000
    ms and Snowflake (64 nodes, K 7, beta 3) to 4,000 ms, each through
    `Runner(fast_forward=True)` in 1,000-ms calls: every call's state
    equal to the JAX run's, the skip counts the JAX engine's; converged
    with every node decided and done, zero drops."""
    kw = (dict(node_count=100, rounds=5, k=7) if name == "Slush" else
          dict(node_count=64, k=7, beta=3))
    ms = 3000 if name == "Slush" else 4000
    jproto, proto = _pair(name, **kw)
    want, jstats = _jax_ff(jproto, ms, 1000)
    runner = network.Runner(proto, fast_forward=True)
    state = proto.init(0)
    for t in range(1000, ms + 1, 1000):
        state = runner.run_ms(*state, 1000)
        tp.assert_states_equal(want[t], convert.to_numpy(*state),
                               f"{name} at {t}")
    assert runner.ff_stats() == jstats and jstats["skipped_ms"] > 0
    net, p = state
    assert _converged(p.color.numpy(), p.decided.numpy())
    assert int(net.dropped) == 0 and bool((net.nodes.done_at > 0).all())


def test_slush_batch_and_fast_forward_match_jax():
    """`test_avalanche_deterministic`'s Slush (64 nodes, M 4, K 5), seeds
    2 and 3 in one batch, to 600 ms: dense at K=2 (vmap with no
    per-seed fallback) and fast-forwarded at K=1 in the same layout,
    each seed equal to the JAX run of that seed alone, the skip counts
    the JAX engine's."""
    kw = dict(node_count=64, rounds=4, k=5)
    jproto, proto = _pair("Slush", **kw)
    want = tp.jax_chunk_states(jproto, (2, 3), 600, 600)
    assert network.pick_superstep(proto, 200, t0=0, max_k=2) == 2
    with no_vmap_fallback():
        dense, _ = tp.port_chunks(proto, init_batched(proto, [2, 3]), 600,
                                  200, 2)
        ff, stats = tp.port_chunks(proto, init_batched(proto, [2, 3]), 600,
                                   200, 1, fast_forward=True)
    for r, seed in enumerate((2, 3)):
        for got in (dense, ff):
            tp.assert_states_equal(want[seed, 600],
                                   [tp.seed_state(x, r) for x in got[600]],
                                   f"batch seed {seed}")
    _, jstats = tp.jax_ff_batch(jproto, [2, 3], 600, 200, 1)
    assert stats == jstats


def _paxos_run(proto, seed, chunk, limit):
    """The port's Paxos from `seed` in `chunk`-ms `Runner` calls until
    every proposer has a value: the state after each call as numpy (the
    engine writes the ring in place), and the last state."""
    runner = network.Runner(proto)
    state, out, t = proto.init(seed), {}, 0
    while t < limit:
        state = runner.run_ms(*state, chunk)
        t += chunk
        out[t] = convert.to_numpy(*state)
        if bool(proto.done(state[1], state[0].nodes)):
            break
    return out, state


@pytest.mark.parametrize("a,p,timeout,seed", [(3, 3, 1000, 0),
                                              (5, 4, 800, 1)])
def test_paxos_matches_jax(a, p, timeout, seed):
    """tests/test_committee.py:57 (3 + 3, seed 0) and :75 (5 + 4, timeout
    800, seed 1) in 500-ms calls until every proposer accepted: each
    call's state equal to the JAX run's; one agreed value, one of the
    proposed ones, zero drops; `cont_if` stops there."""
    from wittgenstein_tpu.core.network import Runner
    jproto, proto = _pair("Paxos", acceptor_count=a, proposer_count=p,
                          timeout=timeout)
    got, (net, ps) = _paxos_run(proto, seed, 500, 6000)
    jrun, jstate = Runner(jproto, donate=False), jproto.init(seed)
    for t, state in got.items():
        jstate = jrun.run_ms(*jstate, 500)
        tp.assert_states_equal(tp.jax_state(*jstate), state, f"Paxos at {t}")
    va = ps.value_accepted[a:].numpy()
    assert (va >= 0).all() and len(set(va.tolist())) == 1
    assert va[0] in ps.value_proposed[a:].numpy()
    assert int(net.dropped) == 0
    assert not bool(proto.cont_if()(net, ps))
    assert bool(jproto.cont_if()(*jstate)) == bool(proto.cont_if()(net, ps))


def test_paxos_batch_matches_single_runs():
    """Paxos 3 + 3, seeds 0-2 in one batch (vmap with no per-seed
    fallback) to 1,000 ms, each seed equal to the JAX run of that seed."""
    jproto, proto = _pair("Paxos")
    want = tp.jax_chunk_states(jproto, (0, 1, 2), 1000, 500)
    with no_vmap_fallback():
        got, _ = tp.port_chunks(proto, init_batched(proto, [0, 1, 2]), 1000,
                                500)
    for r in range(3):
        tp.assert_states_equal(want[r, 1000],
                               [tp.seed_state(x, r) for x in got[1000]],
                               f"seed {r}")


def test_convert_round_trip():
    """`convert.py` carries both states across and back; the protocols
    are in the registry under their JAX names."""
    from wittgenstein_tpu_torch.core.protocol import get_protocol
    assert get_protocol("Slush") is avalanche.Slush
    assert get_protocol("Snowflake") is avalanche.Snowflake
    assert get_protocol("Paxos") is paxos.Paxos
    for name, kw in (("Slush", dict(node_count=32)), ("Paxos", {})):
        jproto, _ = _pair(name, **kw)
        state = tp.jax_state(*jproto.init(4))
        tp.assert_states_equal(state, convert.to_numpy(
            *convert.from_reference(*state, "cpu")), name)


def test_paxos_step_hint_is_identity():
    """The slots past the deepest valid one are the identity: 600 ms of
    Paxos 5 + 4 with the hint equal the same with every slot walked."""
    _, proto = _pair("Paxos", acceptor_count=5, proposer_count=4,
                     timeout=800)

    class NoHint(paxos.Paxos):
        step_hint = None

    plain = NoHint(acceptor_count=5, proposer_count=4, timeout=800,
                   device="cpu")
    got = [convert.to_numpy(*network.Runner(p).run_ms(*p.init(1), 600))
           for p in (proto, plain)]
    tp.assert_states_equal(got[1], got[0], "hinted vs full step")
