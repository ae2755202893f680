"""San Fermín in the port (`wittgenstein_tpu_torch/models/sanfermin.py`)
against the JAX package's, bit for bit (tolerance 0): the geometry and
pick order of `tests/test_sanfermin.py` on the full grid of their
arguments; `SanFermin` at 128 nodes with two ring sub-planes
(``box_split=2``, as `tools/bench_suite.py` runs the 32k line) on one
run at K=1 and at the K the gate proves (2), and on a 2-seed batch at
K=2; `SanFerminCappos` at 64 nodes the same way; `convert.py`'s round
trip of both states."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models import sanfermin

MS, CHUNK = 400, 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_geometry_matches_jax():
    """`_half`, `_own_base` and `_cand_base` at 16 nodes for every id and
    prefix length, against the JAX functions and the worked cases of
    tests/test_sanfermin.py:14."""
    import jax.numpy as jnp
    from wittgenstein_tpu.models import sanfermin as jsf
    bits = 4
    ids, cpl = np.meshgrid(np.arange(16), np.arange(bits + 1))
    ids, cpl = ids.ravel().astype(np.int32), cpl.ravel().astype(np.int32)
    half = sanfermin._half(bits, torch.tensor(cpl))
    jhalf = jsf._half(bits, jnp.asarray(cpl))
    assert half.tolist() == np.asarray(jhalf).tolist()
    for fn in ("_own_base", "_cand_base"):
        got = getattr(sanfermin, fn)(torch.tensor(ids), half)
        want = getattr(jsf, fn)(jnp.asarray(ids), jhalf)
        assert got.tolist() == np.asarray(want).tolist(), fn
    five = torch.tensor([5])
    h = [sanfermin._half(bits, torch.tensor([c])) for c in (3, 2, 0)]
    assert int(h[0]) == 1 and int(sanfermin._cand_base(five, h[0])) == 4
    assert int(h[1]) == 2 and int(sanfermin._own_base(five, h[1])) == 4
    assert int(sanfermin._cand_base(five, h[1])) == 6
    assert int(sanfermin._cand_base(five, h[2])) == 8


def test_pick_order_matches_jax():
    """`_pick_offset` and `_expected` for every (j, partner, used, half)
    up to half 8, against the JAX functions; the rotation of
    tests/test_sanfermin.py:32 and its bijection at every pick index."""
    import jax.numpy as jnp
    from wittgenstein_tpu.models import sanfermin as jsf
    grid = np.array(np.meshgrid(np.arange(9), np.arange(8), np.arange(9),
                                [1, 2, 4, 8], np.arange(-8, 16)),
                    dtype=np.int32).reshape(5, -1)
    j, po, used, half, off = grid
    got = sanfermin._pick_offset(*map(torch.tensor, (j, po, half)))
    want = jsf._pick_offset(*map(jnp.asarray, (j, po, half)))
    assert got.tolist() == np.asarray(want).tolist()
    got = sanfermin._expected(*map(torch.tensor, (off, po, used, half)))
    want = jsf._expected(*map(jnp.asarray, (off, po, used, half)))
    assert got.tolist() == np.asarray(want).tolist()
    four = torch.tensor([4])
    picks = [int(sanfermin._pick_offset(torch.tensor([j]), torch.tensor([2]),
                                        four)) for j in range(4)]
    assert picks == [2, 3, 0, 1]
    for j in range(4):
        offs = sanfermin._pick_offset(torch.tensor(j), torch.arange(4), four)
        assert sorted(offs.tolist()) == [0, 1, 2, 3]


def _split(proto):
    proto.cfg = dataclasses.replace(proto.cfg, box_split=2)
    return proto


@pytest.fixture(scope="module")
def sf_states():
    """Seeds 0 and 1 of the JAX package's SanFermin(128), box_split 2."""
    return tp.jax_chunk_states(_split(tp.jax_protocol("sanfermin", 128)),
                               (0, 1), MS, CHUNK)


@pytest.fixture(scope="module")
def cappos_states():
    """Seeds 0 and 1 of the JAX package's SanFerminCappos(64)."""
    return tp.jax_chunk_states(tp.jax_protocol("cappos", 64), (0, 1), MS,
                               CHUNK)


def _check(proto, states, k, batch):
    """The port from init (seed 0, or seeds 0 and 1 in one batch) in
    CHUNK-ms calls at K=k, every state equal to the JAX package's."""
    from test_torch_batched import no_vmap_fallback
    state = init_batched(proto, [0, 1]) if batch else proto.init(0)
    with no_vmap_fallback():
        got, _ = tp.port_chunks(proto, state, MS, CHUNK, k)
    for t in (CHUNK, MS):
        for r in ((0, 1) if batch else (0,)):
            one = [tp.seed_state(x, r) for x in got[t]] if batch else got[t]
            tp.assert_states_equal(states[r, t], one,
                                   f"K={k} seed {r} at {t} ms")
    return got


@pytest.mark.parametrize("k,batch", [(1, False), (2, False), (2, True)])
def test_sanfermin_matches_jax(sf_states, k, batch):
    proto = _split(sanfermin.SanFermin(node_count=128, device="cpu"))
    assert network.pick_superstep(proto, CHUNK, t0=0) == 2
    got = _check(proto, sf_states, k, batch)
    if not batch:
        ps = got[MS][1]
        assert ps["agg"].max() > 1 and ps["sent_requests"].sum() > 0
        from types import SimpleNamespace as NS
        from wittgenstein_tpu.models.sanfermin import cont_if_sanfermin
        net, pst = convert.from_reference(*got[MS], "cpu")
        want = cont_if_sanfermin(
            NS(nodes=NS(down=got[MS][0]["nodes"]["down"])),
            NS(done=ps["done"]))
        assert bool(sanfermin.cont_if_sanfermin(net, pst)) == bool(want)


@pytest.mark.parametrize("k,batch", [(1, False), (2, True)])
def test_cappos_matches_jax(cappos_states, k, batch):
    proto = sanfermin.SanFerminCappos(node_count=64, device="cpu")
    got = _check(proto, cappos_states, k, batch)
    if not batch:
        assert got[MS][1]["cache_best"].sum() > 0


def test_convert_round_trip(sf_states, cappos_states):
    for states in (sf_states, cappos_states):
        state = states[1, MS]
        tp.assert_states_equal(state, convert.to_numpy(
            *convert.from_reference(*state, "cpu")), "round trip")


@pytest.mark.slow
def test_sanfermin_example_outcome_vs_published():
    """tests/test_golden_parity.py:128 on the port: at the default 1,024
    nodes seconds-scale completion with at most 2% stranded, tens of
    messages a node with no hubs, near-full aggregates."""
    proto = sanfermin.SanFermin(node_count=1024, device="cpu")
    runner = network.Runner(proto, superstep=2)
    net, ps = proto.init(0)
    for _ in range(16):                                   # up to 8 s sim
        net, ps = runner.run_ms(net, ps, 500)
        if bool((net.nodes.done_at[~net.nodes.down] > 0).all()):
            break
    live = ~net.nodes.down
    done = net.nodes.done_at[live].numpy()
    finished = done[done > 0]
    assert 1.0 - finished.size / done.size <= 0.02
    assert finished.size and 500 <= finished.mean() <= 6000
    assert finished.max() <= 8000
    msgs = net.nodes.msg_received[live].numpy()
    assert 10 <= msgs.mean() <= 400 and msgs.max() <= 4 * msgs.mean()
    assert ps.agg[live].float().mean() >= 0.85 * proto.node_count
