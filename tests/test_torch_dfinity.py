"""Dfinity in the port (`wittgenstein_tpu_torch/models/dfinity.py`)
against the JAX package's, bit for bit (tolerance 0): the reference
default (31 nodes) over 400 ticks on one run at K=1 and at the K the
gate proves (2), on a 2-seed batch at K=2 and fast-forwarded (the skip
counts the JAX engine's); rotating committees (40 attesters, 10 a
round); dead attesters at init; the partition demo's two helpers; and
`convert.py`'s round trip of a Dfinity state with its nested arena."""

import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.dfinity import (Dfinity, heal_partition,
                                                   partition_by_x)

TICKS, CHUNK = 400, 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_states():
    """Seeds 0 and 1 of the JAX package's reference-default Dfinity at
    200 and 400 ticks."""
    from wittgenstein_tpu.models.dfinity import Dfinity as JDfinity
    return tp.jax_chunk_states(JDfinity(), (0, 1), TICKS, CHUNK)


def test_proved_superstep_is_two():
    """Dfinity sends to itself (committee addressing), so the gate
    proves K = 2 and no more, as in the JAX package."""
    from wittgenstein_tpu.core import network as jnetwork
    from wittgenstein_tpu.models.dfinity import Dfinity as JDfinity
    proto = Dfinity(device="cpu")
    assert network.pick_superstep(proto, CHUNK, t0=0) == 2 == \
        jnetwork.pick_superstep(JDfinity(), CHUNK, t0=0)
    assert proto.latency.latency_floor_ms() == 1


@pytest.mark.parametrize("k", [1, 2])
def test_single_run_matches_jax(jax_states, k):
    proto = Dfinity(device="cpu")
    got, _ = tp.port_chunks(proto, proto.init(0), TICKS, CHUNK, k)
    for t in (CHUNK, TICKS):
        tp.assert_states_equal(jax_states[0, t], got[t], f"K={k} at {t}")
    assert int(got[TICKS][1]["arena"]["n"]) > 1      # blocks were made


def test_seed_batch_and_fast_forward_match_jax(jax_states):
    """Two seeds in one batch at K=2 (`network.scan_chunk` on
    `init_batched`), then fast-forwarded in the same layout: each seed
    equal to its JAX run, and the skip counts those of the JAX
    engine's ``fast_forward_chunk(seed_axis=True, superstep=2)``."""
    from test_torch_batched import no_vmap_fallback
    from wittgenstein_tpu.models.dfinity import Dfinity as JDfinity
    proto = Dfinity(device="cpu")
    with no_vmap_fallback():
        dense, _ = tp.port_chunks(proto, init_batched(proto, [0, 1]),
                                  TICKS, CHUNK, 2)
        ff, stats = tp.port_chunks(proto, init_batched(proto, [0, 1]),
                                   TICKS, CHUNK, 2, fast_forward=True)
    for r in (0, 1):
        for t in (CHUNK, TICKS):
            tp.assert_states_equal(jax_states[r, t],
                                   [tp.seed_state(x, r) for x in dense[t]],
                                   f"seed {r} at {t}")
        tp.assert_states_equal(jax_states[r, TICKS],
                               [tp.seed_state(x, r) for x in ff[TICKS]],
                               f"fast-forwarded seed {r}")
    _, jstats = tp.jax_ff_batch(JDfinity(), [0, 1], TICKS, CHUNK, 2)
    assert stats == jstats
    assert sum(s["skipped_ms"] for s in stats) > 0


def test_rotating_committees_match_jax():
    """att_rounds 4 (the 10k-validator shape scaled down): the port at
    K=2 against the JAX package's per-ms run to 1,000 ticks."""
    from wittgenstein_tpu.models.dfinity import Dfinity as JDfinity
    kw = dict(attesters_count=40, attesters_per_round=10)
    ref = tp.jax_chunk_states(JDfinity(**kw), (0,), 1000, 500)
    proto = Dfinity(**kw, device="cpu")
    assert proto.att_rounds == 4 and proto.att_width == 10
    got, _ = tp.port_chunks(proto, proto.init(0), 1000, 500, 2)
    for t in (500, 1000):
        tp.assert_states_equal(ref[0, t], got[t], f"at {t}")
    heights = got[1000][1]["arena"]["height"][got[1000][1]["head"]]
    assert heights.max() >= 3 and heights.max() - heights.min() <= 1


def test_dead_attesters_and_partition_match_jax():
    """`percentage_dead_attester` picks the same attesters (a stable
    sort of hashed priorities); `partition_by_x` and `heal_partition`
    give the JAX package's states."""
    from wittgenstein_tpu.models import dfinity as jdfinity
    kw = dict(attesters_count=40, attesters_per_round=10,
              percentage_dead_attester=25)
    jproto = jdfinity.Dfinity(**kw)
    proto = Dfinity(**kw, device="cpu")
    jnet, jps = jproto.init(3)
    net, ps = proto.init(3)
    tp.assert_states_equal(tp.jax_state(jnet, jps),
                           convert.to_numpy(net, ps), "init")
    assert int(net.nodes.down.sum()) == 10
    jnet, jps = jdfinity.heal_partition(
        jdfinity.partition_by_x(jnet, 0.4), jps)
    part = partition_by_x(net, 0.4)
    assert int(part.nodes.partition.sum()) > 0
    net, ps = heal_partition(part, ps)
    tp.assert_states_equal(tp.jax_state(jnet, jps),
                           convert.to_numpy(net, ps), "healed")
    assert bool((ps.q_bcast_blk != 0).any())


def test_convert_round_trip(jax_states):
    """`to_numpy(*from_reference(state))` equals the JAX state leaf for
    leaf, the uint32 bitsets and the nested arena included."""
    state = jax_states[1, TICKS]
    tp.assert_states_equal(state, convert.to_numpy(
        *convert.from_reference(*state, "cpu")), "round trip")
    assert state[1]["votes"].dtype.name == "uint32"
    assert isinstance(state[1]["arena"], dict)


@pytest.mark.slow
def test_block_rate_perfect_network_vs_published():
    """tests/test_golden_parity.py:95 on the port: on a perfect network
    one block a 3-s round (Dfinity.java:467-481), 300 simulated s
    fast-forwarded, the arena sized for the run."""
    proto = Dfinity(network_latency_name="NetworkNoLatency",
                    block_capacity=1000, device="cpu")
    runner = network.Runner(proto, superstep=2, fast_forward=True)
    net, ps = runner.run_ms(*proto.init(0), 30_000)
    assert int(ps.arena.dropped) == 0
    blocks = int(ps.arena.height[ps.head.long()].max())
    assert 97 <= blocks <= 101, blocks
