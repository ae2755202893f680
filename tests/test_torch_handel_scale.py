"""Exact-mode Handel's scale switches in the port against the JAX
package, full state leaf for leaf, bit for bit: hashed emission with no
snapshot pool, `state_split` q_sig pieces (P 2 and 4), ring sub-planes
(`box_split` 2 and 4) on the per-ms, superstep, seed-folded and
fast-forward engines, both attack modes, the tier-2 line's parameters
(`tier2_params`) cut to 64 nodes, and the constructor's guards.  The
cases of tests/test_handel.py (:101, :142, :171, :197, :274),
tests/test_engine.py::test_box_split_bit_equal, tests/test_batched.py::
test_batched_box_split and tests/test_pallas_route.py's box-split and
Handel fast-forward cases, at 64 nodes with one intra-op thread."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp
from test_torch_batched import no_vmap_fallback

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
from wittgenstein_tpu_torch.core.network import (Runner, fast_forward_chunk,
                                                 scan_chunk)
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.handel import (TIER2_BOX_SPLIT, Handel,
                                                  reference_default_params,
                                                  tier2_params)
from wittgenstein_tpu_torch.ops import bitset

ATTACK = dict(node_count=64, threshold=56, nodes_down=8, pairing_time=3,
              level_wait_time=20, dissemination_period_ms=10,
              network_latency_name="NetworkFixedLatency(20)")
# tests/test_pallas_route.py's `_floor_handel`: a latency floor of 16 ms.
FLOOR = dict(node_count=64, threshold=56, nodes_down=6, pairing_time=4,
             dissemination_period_ms=20, level_wait_time=50, fast_path=10,
             horizon=64, network_latency_name="NetworkFixedLatency(16)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _protos(params, box_split=1):
    """(JAX Handel, the port's on the CPU), with ring sub-planes."""
    from wittgenstein_tpu.models.handel import Handel as JHandel
    jproto, proto = JHandel(**params), Handel(**params, device="cpu")
    for p in (jproto, proto):
        p.cfg = dataclasses.replace(p.cfg, box_split=box_split)
    return jproto, proto


def _equal_per_ms(params, ms, box_split=1, seed=0):
    """Both packages' per-ms Runner from their own init, every leaf
    equal after `ms` ms; returns the port's state."""
    from wittgenstein_tpu.core.network import Runner as JRunner
    jproto, proto = _protos(params, box_split)
    ref = tp.jax_state(*JRunner(jproto, donate=False).run_ms(
        *jproto.init(seed), ms))
    state = Runner(proto).run_ms(*proto.init(seed), ms)
    tp.assert_states_equal(ref, convert.to_numpy(*state),
                           f"{params} box_split {box_split} at {ms} ms")
    return state


def test_hashed_emission_poolfree_equal_to_jax():
    """tests/test_handel.py::test_scale_mode_hashed_emission_poolfree at
    64 nodes: every leaf equal at 700 ms, every live node done, no
    O(N^2) leaf; deterministic, and seed-sensitive."""
    params = dict(reference_default_params(64), emission_mode="hashed",
                  snapshot_pool=False, prefix_pc=True)
    net, ps = _equal_per_ms(params, 700)
    assert (net.nodes.done_at[~net.nodes.down] > 0).all()
    assert int(net.dropped) == 0 and int(net.clamped) == 0
    assert ps.emission.shape == (1, 1) and ps.pool.shape == (1, 1, 1)
    proto = Handel(**params, device="cpu")
    runs = [Runner(proto).run_ms(*proto.init(s), 60)[0].nodes.msg_received
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])


@pytest.mark.parametrize("attack", ["byzantine_suicide", "hidden_byzantine",
                                    "hidden_small_queue"])
def test_exact_attacks_equal_to_jax(attack):
    """tests/test_handel.py's attack cases (:142, :171, :197) at 200 ms,
    every leaf equal, with the attack seen in the state: suicide plants
    blacklist byzantine senders only; hidden plants put down nodes'
    bits into honest aggregates; under hidden plants a 2-entry queue
    evicts."""
    params = dict(ATTACK, **{attack: True})
    if attack == "hidden_small_queue":
        params = dict(ATTACK, hidden_byzantine=True, queue_cap=2,
                      inbox_cap=16, nodes_down=16, threshold=44)
    net, ps = _equal_per_ms(params, 200)
    live = ~net.nodes.down
    down_ids = torch.nonzero(net.nodes.down)[:, 0]
    if attack == "byzantine_suicide":
        bl = ps.blacklist
        assert int(bitset.popcount(bl).sum()) > 0
        hit = bitset.get_bit(bl[live][:, None, :].expand(-1, 64, -1),
                             torch.arange(64)[None, :].expand(
                                 int(live.sum()), -1))
        assert net.nodes.down[torch.nonzero(hit)[:, 1]].all()
    elif attack == "hidden_byzantine":
        inc = (ps.last_agg | ps.ver_ind)[live]
        hit = bitset.get_bit(inc[:, None, :].expand(-1, len(down_ids), -1),
                             down_ids[None, :].expand(len(inc), -1))
        assert int(hit.sum()) > 0
    else:
        assert int(ps.evicted) > 0


@pytest.mark.parametrize("split", [2, 4])
def test_splits_equal_to_jax(split):
    """tests/test_handel.py::test_state_split_bit_equal and
    tests/test_engine.py::test_box_split_bit_equal in one run: q_sig in
    P node-range pieces and the ring in P sub-planes, every leaf equal
    to the JAX package's at the same P; and against the port's unsplit
    run, the pieces and the logical ring (sub-planes concatenated on the
    node axis) equal, every other leaf too."""
    params = reference_default_params(64)
    net, ps = _equal_per_ms(dict(params, state_split=split), 120,
                            box_split=split)
    assert len(ps.q_sig) == split and len(net.box_src) == split
    proto = Handel(**params, device="cpu")
    net1, ps1 = Runner(proto).run_ms(*proto.init(0), 120)
    assert torch.equal(torch.cat(ps.q_sig), ps1.q_sig[0])
    ring = {k: torch.cat(getattr(net, k), axis)
            for k, axis in (("box_data", 2), ("box_src", 1), ("box_size", 1),
                            ("box_count", 1))}
    tp.assert_states_equal(convert.to_numpy(net1, ps1.replace(q_sig=())),
                           convert.to_numpy(net.replace(**ring),
                                            ps.replace(q_sig=())),
                           f"split {split} against 1")
    assert int(ps.sigs_checked.sum()) > 0


def test_batched_tier2_equal_to_jax():
    """The seed-folded engine, K=2 with phase hints, on 2 seeds of the
    tier-2 line at 64 nodes (hashed, pool-free, two q_sig pieces, two
    ring sub-planes), against the JAX package's without hints
    (tests/test_batched.py::test_batched_box_split on the tier-2 line;
    the hinted one is bit-equal to it)."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import scan_chunk_batched as jscb
    jproto, proto = _protos(tier2_params(64), TIER2_BOX_SPLIT)
    nets, ps = jax.vmap(jproto.init)(jnp.arange(2, dtype=jnp.int32))
    ref = tp.jax_state(*jax.jit(jscb(jproto, 60, superstep=2))(nets, ps))
    with no_vmap_fallback():
        got = scan_chunk_batched(proto, 60, t0_mod=0)(
            *init_batched(proto, torch.arange(2)))
    tp.assert_states_equal(ref, convert.to_numpy(*got), "tier 2")
    assert len(got[1].q_sig) == 2 and len(got[0].box_src) == 2
    assert int(got[1].sigs_checked.sum()) > 0


@pytest.mark.parametrize("engine", ["superstep", "fast_forward"])
def test_floor_latency_engines_equal_to_jax(engine):
    """tests/test_pallas_route.py's box-split and Handel fast-forward
    cases, on the 16-ms latency floor: a split ring through 2-ms
    supersteps, one run; and the fast-forward chunk, K=2, over 2
    seeds."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import fast_forward_chunk as jff
    from wittgenstein_tpu.core.network import scan_chunk as jscan
    if engine == "superstep":
        jproto, proto = _protos(FLOOR, box_split=2)
        ref = tp.jax_state(*jax.jit(jscan(jproto, 16, superstep=2))(
            *jproto.init(1)))
        got = scan_chunk(proto, 16, superstep=2)(*proto.init(1))
    else:
        jproto, proto = _protos(FLOOR)
        nets, ps = jax.vmap(jproto.init)(jnp.arange(2, dtype=jnp.int32))
        ref = tp.jax_state(*jax.jit(jff(jproto, 16, seed_axis=True,
                                        superstep=2))(nets, ps)[:2])
        with no_vmap_fallback():
            got = fast_forward_chunk(proto, 16, seed_axis=True,
                                     superstep=2)(
                *init_batched(proto, torch.arange(2)))[:2]
    tp.assert_states_equal(ref, convert.to_numpy(*got), engine)


GUARDS = {
    "stored_past_32k": dict(node_count=65536, emission_mode="stored"),
    "split_divides": dict(node_count=64, state_split=3),
    "split_with_attack": dict(node_count=64, nodes_down=6, state_split=2,
                              byzantine_suicide=True),
    "attack_needs_down": dict(node_count=64, hidden_byzantine=True),
    "sort_key_int32": dict(node_count=1 << 25, queue_cap=16, inbox_cap=16,
                           emission_mode="hashed"),
    "flat_index_int32": dict(node_count=65536, queue_cap=32, inbox_cap=8),
    "emission_mode": dict(node_count=64, emission_mode="sorted"),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_constructor_guards_match_jax(case):
    """The JAX constructor's ValueErrors (wittgenstein_tpu/models/
    handel.py:186-275), with the same messages, before anything is
    allocated."""
    from wittgenstein_tpu.models.handel import Handel as JHandel
    kw = GUARDS[case]
    with pytest.raises(ValueError) as ref:
        JHandel(**kw)
    with pytest.raises(ValueError) as got:
        Handel(**kw, device="cpu")
    assert str(got.value) == str(ref.value)


def test_scale_state_roundtrip_through_convert():
    """A split ring and q_sig pieces go to the JAX layout (F*P and P
    flat planes, P pieces) and back unchanged."""
    _, proto = _protos(tier2_params(64), TIER2_BOX_SPLIT)
    state = Runner(proto).run_ms(*proto.init(2), 40)
    once = convert.to_numpy(*state)
    assert len(once[0]["box_data"]) == 3 * TIER2_BOX_SPLIT
    assert len(once[1]["q_sig"]) == 2
    assert once[0]["box_count"].shape == (256, 64)
    twice = convert.to_numpy(*convert.from_reference(*once, "cpu"))
    tp.assert_states_equal(once, twice, "roundtrip")
    assert np.asarray(once[1]["q_sig"][1]).dtype == np.uint32
