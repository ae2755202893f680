"""ENRGossiping in the port (`wittgenstein_tpu_torch/models/enr.py`)
against the JAX package's, leaf for leaf (tolerance 0), on
`tests/test_enr.py`'s configuration (`make()`: 40 nodes and 8 joiner
slots, 2 of 5 capabilities a node, gossip every 500 ms): one run to
3,000 ms through `Runner` in 500-ms calls, and a seed batch under
`torch.func.vmap` (no per-seed fallback) with fast churn (joins every
500 ms) to 1,500 ms.  The JAX tests' own assertions hold on the port's
runs (init invariants, rewiring finishes, membership changes, zero
drops)."""

import numpy as np
import pytest
import torch
import torch_parity as tp
from test_torch_batched import no_vmap_fallback

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.enr import ENRGossiping, cont_if_enr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    """tests/test_enr.py:12-20."""
    args = dict(nodes=40, total_peers=5, max_peers=12,
                number_of_different_capabilities=5, cap_per_node=2,
                cap_gossip_time=500, time_to_change=5_000,
                time_to_leave=20_000, changing_nodes=0.4,
                network_latency_name="NetworkLatencyByDistanceWJitter")
    args.update(kw)
    return args


def _pair(**kw):
    from wittgenstein_tpu.models.enr import ENRGossiping as JENR
    return JENR(**_args(**kw)), ENRGossiping(**_args(**kw), device="cpu")


def test_init_matches_jax():
    """`init` equal to the JAX package's for three seeds, and
    tests/test_enr.py:23's invariants on the port's state; the protocol
    is in the registry under its JAX name."""
    from wittgenstein_tpu_torch.core.protocol import get_protocol
    assert get_protocol("ENRGossiping") is ENRGossiping
    jproto, proto = _pair()
    for seed in (0, 1, 5):
        net, ps = proto.init(seed)
        tp.assert_states_equal(tp.jax_state(*jproto.init(seed)),
                               convert.to_numpy(net, ps), f"seed {seed}")
    caps = ps.caps.numpy()
    assert np.all(caps.sum(1) == 2) and np.all(caps[:40].sum(0) >= 2)
    down = net.nodes.down.numpy()
    assert down[40:].all() and not down[:40].any()
    assert np.all(ps.join_at.numpy()[40:] > 0)
    peers = ps.peers.numpy()
    for i in range(40):
        for q in peers[i][peers[i] >= 0]:
            assert i in peers[q], (i, q)


def test_run_matches_jax():
    """tests/test_enr.py:44: seed 0 through `Runner` in 500-ms calls to
    3,000 ms, every call's state equal to the JAX run's; more than 80%
    of the live nodes done, zero drops, `cont_if_enr` as JAX's."""
    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.enr import cont_if_enr as jcont
    jproto, proto = _pair()
    jrun, run = Runner(jproto, donate=False), network.Runner(proto)
    jstate, state = jproto.init(0), proto.init(0)
    for t in range(500, 3001, 500):
        jstate = jrun.run_ms(*jstate, 500)
        state = run.run_ms(*state, 500)
        tp.assert_states_equal(tp.jax_state(*jstate),
                               convert.to_numpy(*state), f"ENR at {t}")
    net = state[0]
    live = ~net.nodes.down
    assert float((net.nodes.done_at[live] > 0).float().mean()) > 0.8
    assert int(net.dropped) == 0
    assert bool(cont_if_enr(*state)) == bool(jcont(*jstate))


def test_churn_batch_matches_jax():
    """tests/test_enr.py:61's churn (time_to_leave 4,000: a joiner every
    500 ms, quick exits), seeds 1 and 2 in one batch to 1,500 ms, each
    seed equal to the JAX run of that seed alone; membership changed."""
    jproto, proto = _pair(time_to_leave=4_000)
    want = tp.jax_chunk_states(jproto, (1, 2), 1500, 500)
    with no_vmap_fallback():
        got, _ = tp.port_chunks(proto, init_batched(proto, [1, 2]), 1500,
                                500)
    for r, seed in enumerate((1, 2)):
        alive = []
        for t in (500, 1000, 1500):
            state = [tp.seed_state(x, r) for x in got[t]]
            tp.assert_states_equal(want[seed, t], state, f"seed {seed}")
            alive.append(int((~state[0]["nodes"]["down"]).sum()))
        assert len(set(alive)) > 1, alive


def test_step_hints_leave_out_only_identities():
    """The step hint's three leave-outs (slots past the deepest valid
    one, the joiners' links without a joiner, the capability draw
    without a due change) are the identity: with a joiner at 500 ms and
    capability changes every 200 ms, 700 ms with the hint equal 700 ms
    with the hint off (every slot, every part)."""
    _, proto = _pair(time_to_leave=4_000, time_to_change=200)

    class NoHint(ENRGossiping):
        step_hint = None

    plain = NoHint(**_args(time_to_leave=4_000, time_to_change=200),
                   device="cpu")
    got = [convert.to_numpy(*network.Runner(p).run_ms(*p.init(3), 700))
           for p in (proto, plain)]
    tp.assert_states_equal(got[1], got[0], "hinted vs full step")
    assert got[0][1]["seq"].sum() > 0


def test_churn_golden_hint_matches_port_init():
    """The churn batch that `chip_smoke.py` runs on the card: the ms at
    which its golden wants the step hint to report a joiner or a
    capability change are those the port's own initial state of seeds
    22-25 schedules, a join and a change among them."""
    import json
    with open(tp.ENR_CHURN_FILE) as f:
        golden = json.load(f)
    assert golden["params"] == tp.ENR_CHURN_PARAMS == _args(
        time_to_leave=4_000)
    proto = ENRGossiping(**golden["params"], device="cpu")
    first = golden["first_seed"]
    assert first == tp.ENR_CHURN_FIRST_SEED
    _, ps = init_batched(proto, torch.arange(first,
                                             first + len(golden["seeds"])))
    assert tp.enr_hint_ms(ps.join_at.numpy(), ps.change_start.numpy(),
                          proto.time_to_change, golden["ms"]) == \
        golden["hint"]
    assert golden["hint"]["join_ms"] and golden["hint"]["change_ms"]
