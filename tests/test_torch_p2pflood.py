"""P2P peer graphs and P2PFlood in the port (`wittgenstein_tpu_torch/
core/p2p.py`, `models/p2pflood.py`) against the JAX package's, bit for
bit (tolerance 0): the peer-graph and fan-out cases of
`tests/test_p2p.py` (both graph variants equal to JAX's, and their
invariants), `disconnect` and `avg_peers`; `bench.py` `bench_quiet`'s
P2PFlood scaled to 64 nodes on one run at K=1 and at the proved K (2),
on a 2-seed batch at K=2 and fast-forwarded (the skip counts the JAX
engine's); `convert.py`'s round trip."""

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network, p2p
from wittgenstein_tpu_torch.core.state import EngineConfig, init_batched
from wittgenstein_tpu_torch.models.p2pflood import P2PFlood, quiet_params

N, MS, CHUNK = 64, 400, 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,n,c,minimum", [(0, 200, 5, True),
                                              (1, 400, 10, False)])
def test_peer_graph_matches_jax(seed, n, c, minimum):
    """tests/test_p2p.py:17 and :35: every slot equal to the JAX graph,
    no overflow, no duplicate peers or self loops, symmetric links, the
    degree bounds of each variant; `avg_peers` and `disconnect` as
    JAX's."""
    from wittgenstein_tpu.core import p2p as jp2p
    want = [np.asarray(x) for x in jp2p.build_peer_graph(seed, n, c,
                                                         minimum=minimum)]
    got = [x.numpy() for x in p2p.build_peer_graph(seed, n, c,
                                                   minimum=minimum)]
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    peers, degree, overflow = got
    assert int(overflow) == 0
    if minimum:
        assert degree.min() >= c and 8.0 < degree.mean() < 10.5
    else:
        assert degree.min() >= 1 and 8.0 < degree.mean() < 12.0
    for i in (0, 17, n - 1):
        row = peers[i][peers[i] >= 0]
        assert len(row) == degree[i] == len(set(row.tolist()))
        assert i not in row and all(i in peers[j] for j in row)
    assert int(p2p.avg_peers(torch.tensor(degree))) == \
        int(jp2p.avg_peers(degree))
    mask = np.arange(n) % 7 == 3
    jd = [np.asarray(x) for x in jp2p.disconnect(peers, degree, mask)]
    td = [x.numpy() for x in p2p.disconnect(torch.tensor(peers),
                                            torch.tensor(degree),
                                            torch.tensor(mask))]
    assert all(np.array_equal(a, b) for a, b in zip(jd, td))


def test_flood_fanout_matches_jax():
    """tests/test_p2p.py:46: the k-th peer in the shuffled order waits
    local + k*between ms, the excluded sender skipped; and a random
    128-node case, every field equal to JAX's."""
    import jax.numpy as jnp
    from wittgenstein_tpu.core import p2p as jp2p
    from wittgenstein_tpu.core.state import EngineConfig as JConfig
    peers = np.array([[1, 2, 3], [0, -1, -1], [0, -1, -1], [0, -1, -1]],
                     np.int32)
    forward = np.array([True, False, False, False])
    exclude = np.array([2, -1, -1, -1], np.int32)
    got = p2p.flood_fanout(EngineConfig(n=4, out_deg=3), torch.tensor(peers),
                           torch.tensor(forward), torch.tensor(exclude),
                           torch.zeros((4, 1), dtype=torch.int32),
                           torch.tensor(7, dtype=torch.int32), 0,
                           local_delay=10, delay_between=30)
    dest, delay = got[0].numpy(), got[3].numpy()
    sent = dest[0] >= 0
    assert set(dest[0][sent].tolist()) == {1, 3}
    assert sorted(delay[0][sent].tolist()) == [10, 40]
    assert (dest[1:] == -1).all()
    rng = np.random.default_rng(0)
    peers, _, _ = p2p.build_peer_graph(5, 128, 6)
    forward = rng.random(128) < 0.5
    exclude = rng.integers(-1, 128, 128).astype(np.int32)
    payload = rng.integers(0, 9, (128, 2)).astype(np.int32)
    d = peers.shape[1]
    want = jp2p.flood_fanout(JConfig(n=128, out_deg=d), jnp.asarray(peers),
                             forward, exclude, jnp.asarray(payload),
                             jnp.int32(11), 37, local_delay=3,
                             delay_between=2, size=5)
    got = p2p.flood_fanout(EngineConfig(n=128, out_deg=d), peers,
                           torch.tensor(forward), torch.tensor(exclude),
                           torch.tensor(payload),
                           torch.tensor(11, dtype=torch.int32), 37,
                           local_delay=3, delay_between=2, size=5)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def jax_states():
    """Seeds 0 and 1 of the JAX package's bench_quiet P2PFlood at 64
    nodes."""
    return tp.jax_chunk_states(tp.jax_protocol("p2pflood", N), (0, 1), MS,
                               CHUNK)


@pytest.mark.parametrize("k", [1, 2])
def test_single_run_matches_jax(jax_states, k):
    proto = P2PFlood(**quiet_params(N), device="cpu")
    assert network.pick_superstep(proto, CHUNK, t0=0, max_k=2) == 2
    got, _ = tp.port_chunks(proto, proto.init(0), MS, CHUNK, k)
    for t in (CHUNK, MS):
        tp.assert_states_equal(jax_states[0, t], got[t], f"K={k} at {t}")
    live = ~got[MS][0]["nodes"]["down"]
    assert (got[MS][0]["nodes"]["done_at"][live] > 0).all()


def test_seed_batch_and_fast_forward_match_jax(jax_states):
    """Two seeds in one batch at K=2, then fast-forwarded in the same
    layout (`fast_forward_chunk(seed_axis=True, superstep=2)`): each seed
    equal to its JAX run, the skip counts the JAX engine's."""
    from test_torch_batched import no_vmap_fallback
    proto = P2PFlood(**quiet_params(N), device="cpu")
    with no_vmap_fallback():
        dense, _ = tp.port_chunks(proto, init_batched(proto, [0, 1]), MS,
                                  CHUNK, 2)
        ff, stats = tp.port_chunks(proto, init_batched(proto, [0, 1]), MS,
                                   CHUNK, 2, fast_forward=True)
    for r in (0, 1):
        for got in (dense, ff):
            tp.assert_states_equal(jax_states[r, MS],
                                   [tp.seed_state(x, r) for x in got[MS]],
                                   f"seed {r}")
    _, jstats = tp.jax_ff_batch(tp.jax_protocol("p2pflood", N), [0, 1], MS,
                                CHUNK, 2)
    assert stats == jstats
    assert sum(s["skipped_ms"] for s in stats) > 0


def test_convert_round_trip(jax_states):
    state = jax_states[1, MS]
    tp.assert_states_equal(state, convert.to_numpy(
        *convert.from_reference(*state, "cpu")), "round trip")
