"""Casper IMD in the port (`wittgenstein_tpu_torch/models/casper.py`)
against the JAX package's, leaf for leaf (tolerance 0):
`test_casper.py`'s `make()` (43 nodes, 40-ms ticks) over 2,000 ticks for
each producer kind (the delayed producer on time and 1 s late, SF, NS
and WF), every arena keeping its heights above its parents'; two WF
seeds in one batch at the K the gate proves (1,000 ticks); the heavy
half of the step is the identity where no node has an event; the ops of
an event tick do not grow with the arena; `convert.py`'s round trip of a
Casper state; and the schema of the reference configuration's golden
(`chip_smoke.py` phase K)."""

import json

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.autograd import DeviceType

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.core.state import Inbox, init_batched
from wittgenstein_tpu_torch.models.casper import CasperIMD

TICKS, CHUNK = 2000, 1000

#: producer kind -> byz_delay (ms): the delayed producer on time and 1 s
#: late (test_casper.py's delay), the skipping ones and WF
KINDS = {"ByzBlockProducer": 0, "ByzBlockProducer-late": 1000,
         "ByzBlockProducerSF": 0, "ByzBlockProducerNS": 0,
         "ByzBlockProducerWF": 0}


def make_kw(kind="ByzBlockProducerWF", **kw):
    """test_casper.py's `make()`: cycle 4, 2 producers, 10 attesters a
    round (43 nodes), 40-ms ticks, the distance latency."""
    args = dict(cycle_length=4, block_producers_count=2,
                attesters_per_round=10, byz_kind=kind.split("-")[0],
                byz_delay=KINDS.get(kind, 0), tick_ms=40,
                network_latency_name="NetworkLatencyByDistanceWJitter")
    args.update(kw)
    return args


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_states(kind, seeds):
    from wittgenstein_tpu.models.casper import CasperIMD as JCasper
    return tp.jax_chunk_states(JCasper(**make_kw(kind)), seeds, TICKS, CHUNK)


@pytest.fixture(scope="module")
def wf_states():
    """Seeds 0 and 1 of the JAX package's default (WF) `make()` at 1,000
    and 2,000 ticks."""
    return _jax_states("ByzBlockProducerWF", (0, 1))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_single_run_matches_jax(kind, wf_states):
    ref = wf_states if kind == "ByzBlockProducerWF" else \
        _jax_states(kind, (0,))
    proto = CasperIMD(**make_kw(kind), device="cpu")
    got, _ = tp.port_chunks(proto, proto.init(0), TICKS, CHUNK, 1)
    for t in (CHUNK, TICKS):
        tp.assert_states_equal(ref[0, t], got[t], f"{kind} at {t}")
        tp.assert_heights_ordered(got[t][1]["arena"])
    ps = got[TICKS][1]
    assert ps["arena"]["n"] > 5 and ps["att_n"] > 50
    assert (ps["arena"]["producer"][1:ps["arena"]["n"]] == 1).any()


def test_seed_batch_matches_jax(wf_states):
    """Seeds 0 and 1 in one batch (`network.scan_chunk` on `init_batched`)
    at the K the gate proves (2, as the JAX gate) to 1,000 ticks, each
    seed equal to its JAX run, with no per-seed fallback of vmap."""
    from test_torch_batched import no_vmap_fallback
    from wittgenstein_tpu.core import network as jnetwork
    from wittgenstein_tpu.models.casper import CasperIMD as JCasper
    proto = CasperIMD(**make_kw(), device="cpu")
    k = network.pick_superstep(proto, CHUNK, t0=0)
    assert k == 2 == jnetwork.pick_superstep(JCasper(**make_kw()), CHUNK,
                                             t0=0)
    with no_vmap_fallback():
        got, _ = tp.port_chunks(proto, init_batched(proto, [0, 1]), CHUNK,
                                CHUNK, k)
    for r in (0, 1):
        for t in (CHUNK,):
            tp.assert_states_equal(wf_states[r, t],
                                   [tp.seed_state(x, r) for x in got[t]],
                                   f"seed {r} at {t}")


def test_heavy_half_is_identity_without_events():
    """`_events` with every due flag off leaves the state as it was (the
    ground for running each part only where t can give it an event), on
    a state with blocks, attestations and a queued reevaluation."""
    proto = CasperIMD(**make_kw("ByzBlockProducerSF"), device="cpu")
    net, ps = network.scan_chunk(proto, 600)(*proto.init(0), t=0)
    assert int(ps.arena.n) > 1 and int(ps.att_n) > 0
    off = torch.zeros(proto.node_count, dtype=torch.bool)
    out = proto._events(ps, off, off, off, off, off, 613)
    a = convert.flatten(convert.to_numpy(net, ps)[1])
    b = convert.flatten(convert.to_numpy(net, out)[1])
    assert convert.first_difference(a, b) is None


def _event_tick_ops(capacity):
    proto = CasperIMD(**make_kw(), block_capacity=capacity, device="cpu")
    net, ps = proto.init(0)
    empty = Inbox(
        data=torch.zeros(proto.node_count, 4, 2, dtype=torch.int32),
        src=torch.zeros(proto.node_count, 4, dtype=torch.int32),
        valid=torch.zeros(proto.node_count, 4, dtype=torch.bool))
    t = 2 * proto.slot                  # a producer and the observer
    with torch.profiler.profile() as prof:
        proto.step(ps, net.nodes, empty, t)
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.cpu_parent is None and e.name.startswith("aten::"))


def test_event_tick_ops_do_not_grow_with_the_arena():
    """The top-level aten ops of one event tick (reevaluation, a build)
    are the same at 256 and 1,024 blocks: every walk is by set."""
    ops = [_event_tick_ops(c) for c in (256, 1024)]
    assert ops[0] == ops[1] and ops[0] > 100, ops


def test_convert_round_trip():
    """to_numpy(from_reference(JAX state)) is the JAX state, leaf for
    leaf (the arena's ancestor bitsets rebuilt from its parents)."""
    import jax
    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.casper import CasperIMD as JCasper
    jproto = JCasper(**make_kw())
    ref = tp.jax_state(*jax.jit(scan_chunk(jproto, 500))(*jproto.init(2)))
    net, ps = convert.from_reference(*ref, "cpu")
    tp.assert_states_equal(ref, convert.to_numpy(net, ps), "round trip")
    proto = CasperIMD(**make_kw(), device="cpu")
    want = proto.init(2)[1].arena.anc
    assert ps.arena.anc.shape == want.shape
    assert int(ps.arena.n) > 1 and bool((ps.arena.anc != 0).any())


def test_reference_golden_schema():
    """`chip_smoke.py` phase K's golden: `CasperIMD()`'s 8 seeds at each
    CASPER_CHUNK ticks to CASPER_TICKS (600 and 1,200), leaf names those
    of the port's state, zero drops,
    heads within 2 (test_casper.py's consensus check), and at the end a
    block a slot past the first (8-s slots, 400 ticks of 20 ms)."""
    with open(tp.CASPER_GOLDEN_FILE) as f:
        golden = json.load(f)
    assert golden["call"].startswith("jax.jit(jax.vmap(")
    assert f"scan_chunk(proto, {tp.CASPER_CHUNK})" in golden["call"]
    assert {"wall_s", "peak_rss_gb"} <= set(golden["generator"])
    proto = CasperIMD(device="cpu")
    assert proto.node_count == 83
    names = sorted(convert.state_digest(*convert.to_numpy(*proto.init(0))))
    assert sorted(map(int, golden["ticks"])) == list(range(
        tp.CASPER_CHUNK, tp.CASPER_TICKS + 1, tp.CASPER_CHUNK))
    for at in golden["ticks"].values():
        assert len(at["seeds"]) == len(at["counts"]) == tp.CASPER_SEEDS
        for leaves, counts in zip(at["seeds"], at["counts"]):
            assert sorted(leaves) == names
            assert counts["dropped"] == counts["bc_dropped"] == 0
            assert counts["height_max"] - counts["height_min"] <= 2
    last = golden["ticks"][str(tp.CASPER_TICKS)]
    assert len({json.dumps(s, sort_keys=True) for s in last["seeds"]}) == 8
    assert np.all([c["height_max"] >= tp.CASPER_TICKS // 400 - 1
                   for c in last["counts"]])
