"""The multi-run harness of the port (`core/harness.py`, the engine on a
seed batch) against the JAX package's `core/harness.py`: on the 64-node
reference-default Handel with 3 seeds, `run_multiple_times` (each run's
stop time, per-run and averaged stats, and the final state of every run,
frozen at its stop time, ring included) and `progress_per_time` (sample
times, per-run samples, merged series); the frozen runs against the
dense engine run to their stop times; the `max_time=0` wall-clock guard;
Handel with a broadcast table or a spill buffer.  Then the port twins
of `tests/test_harness.py`'s PingPong tests (:21, :38, :50, :62, each
also against the JAX harness's result), of its odd-entry demotion
(:149), and two-seed spill runs at K = 1 (one with a run frozen while
its message is parked), each equal to the JAX harness."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.utils import _pytree as pytree

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import harness, network
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.network import Runner
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.handel import (Handel,
                                                  reference_default_params)
from wittgenstein_tpu_torch.models.pingpong import PingPong
from wittgenstein_tpu_torch.utils import stats

SEEDS = 3
GETTERS = ("done_at_stats", "msg_received_stats", "msg_sent_stats",
           "done_count")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    """Every op of the engine on a batch, the protocol steps and the
    broadcast and spill functions included, has a vmap batching rule:
    a per-seed fallback is an error."""
    from test_torch_batched import no_vmap_fallback
    with no_vmap_fallback():
        yield


def _protos():
    from wittgenstein_tpu.models.handel import Handel as JHandel
    params = reference_default_params(64)
    return JHandel(**params), Handel(**params, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """(JAX result, port result) of run_multiple_times until every run's
    live nodes are done, chunks of 10 ms."""
    from wittgenstein_tpu.core import harness as jharness
    from wittgenstein_tpu.utils import stats as jstats
    jproto, proto = _protos()
    jres = jharness.run_multiple_times(
        jproto, SEEDS, stats_getters=[getattr(jstats, g) for g in GETTERS])
    res = harness.run_multiple_times(
        proto, SEEDS, stats_getters=[getattr(stats, g) for g in GETTERS])
    return jres, res


def test_run_multiple_times_matches_jax(runs):
    jres, res = runs
    stopped = [int(x) for x in np.asarray(jres.stopped_at)]
    assert res.stopped_at.tolist() == stopped
    assert len(set(stopped)) > 1 and min(stopped) > 0
    assert res.stats == jres.stats
    for name, per in jres.per_run.items():
        for comp, v in per.items():
            assert np.array_equal(np.asarray(v),
                                  res.per_run[name][comp].numpy()), (name,
                                                                     comp)
    assert res.stats["doneCount"]["count"] == jres.stats["doneCount"]["count"]
    tp.assert_states_equal(tp.jax_state(jres.nets, jres.pstates),
                           convert.to_numpy(res.nets, res.pstates),
                           "run_multiple_times final states")


def test_frozen_runs_keep_their_stop_state(runs):
    """The run that stopped first equals the dense engine run from its
    seed to its stop time: nothing, the ring included, moved after it
    stopped while the other runs went on."""
    _, res = runs
    r = int(res.stopped_at.argmin())
    stop = int(res.stopped_at[r])
    assert stop < int(res.stopped_at.max())
    proto = Handel(**reference_default_params(64), device="cpu")
    net, ps = Runner(proto, superstep=2).run_ms(*proto.init(r), stop)
    one = pytree.tree_map(lambda x: x[r], (res.nets, res.pstates))
    tp.assert_states_equal(convert.to_numpy(net, ps),
                           convert.to_numpy(*one), f"run {r}")
    assert int(one[0].time) == stop


def test_progress_per_time_matches_jax():
    from wittgenstein_tpu.core import harness as jharness
    from wittgenstein_tpu.utils import stats as jstats
    jproto, proto = _protos()
    jts, _, _ = jharness.progress_per_time(
        jproto, run_count=SEEDS, max_time=300, stat_each_ms=10,
        stats_getters=(jstats.done_count, jstats.msg_sent_stats))
    ts, nets, _ = harness.progress_per_time(
        proto, run_count=SEEDS, max_time=300, stat_each_ms=10,
        stats_getters=(stats.done_count, stats.msg_sent_stats))
    assert ts.times == jts.times == list(range(10, 301, 10))
    assert ts.merged == jts.merged
    counts = ts.merged["doneCount.count"]["avg"]
    assert all(a <= b for a, b in zip(counts, counts[1:]))
    for name, samples in jts.per_run.items():
        for js, s in zip(samples, ts.per_run[name]):
            for comp in js:
                assert np.array_equal(np.asarray(js[comp]), s[comp].numpy())
    assert nets.time.tolist() == [300] * SEEDS


def test_max_time_zero_wall_clock_guard():
    """max_time=0 with a never-true stop predicate hits the wall-clock
    bound instead of looping forever."""
    proto = Handel(**reference_default_params(64), device="cpu")
    with pytest.raises(RuntimeError, match="wall-clock bound"):
        harness.run_multiple_times(
            proto, 1, max_time=0, max_wall_s=0.0,
            cont_if=lambda net, p: torch.tensor(True))


def _both(jproto, proto, fn="run_multiple_times", getters=(), **kw):
    """`fn` of both harnesses on the twin protocols: stop times, stats,
    per-run values and the final state of every run equal.  Returns the
    port's result."""
    from wittgenstein_tpu.core import harness as jharness
    from wittgenstein_tpu.utils import stats as jstats
    jres = getattr(jharness, fn)(
        jproto, stats_getters=[getattr(jstats, g) for g in getters], **kw)
    res = getattr(harness, fn)(
        proto, stats_getters=[getattr(stats, g) for g in getters], **kw)
    if fn == "progress_per_time":
        (jts, jnets, jps), (ts, nets, ps) = jres, res
        assert ts.times == jts.times and ts.merged == jts.merged
        for name, samples in jts.per_run.items():
            for js, s_ in zip(samples, ts.per_run[name]):
                for comp in js:
                    assert np.array_equal(np.asarray(js[comp]),
                                          s_[comp].numpy())
        tp.assert_states_equal(tp.jax_state(jnets, jps),
                               convert.to_numpy(nets, ps), fn)
        return res
    assert res.stopped_at.tolist() == np.asarray(jres.stopped_at).tolist()
    assert res.stats == jres.stats
    for name, per in jres.per_run.items():
        for comp, v in per.items():
            assert np.array_equal(np.asarray(v),
                                  res.per_run[name][comp].numpy())
    tp.assert_states_equal(tp.jax_state(jres.nets, jres.pstates),
                           convert.to_numpy(res.nets, res.pstates), fn)
    return res


@pytest.mark.parametrize("field", ["bcast_slots", "spill_cap"])
def test_protocols_outside_the_batched_scope_run(field):
    """The Handel configurations the harness used to refuse now run on
    the engine (K = 2 with a broadcast table, K = 1 with a spill buffer)
    and equal the JAX harness."""
    from wittgenstein_tpu.models.handel import Handel as JHandel
    params = reference_default_params(64)
    jproto, proto = JHandel(**params), Handel(**params, device="cpu")
    for p in (jproto, proto):
        p.cfg = dataclasses.replace(p.cfg, **{field: 4})
    res = _both(jproto, proto, getters=("msg_sent_stats",), run_count=2,
                max_time=20)
    assert res.nets.time.tolist() == [20, 20]


def _small_pingpongs():
    """tests/test_harness.py's `small_pingpong` in both packages: a
    constant 20-ms latency lands every pong on one ms at the witness,
    so its inbox holds all 64."""
    from wittgenstein_tpu.core.latency import NetworkFixedLatency as JFixed
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    return (JPingPong(node_count=64, latency=JFixed(20), inbox_cap=64),
            PingPong(node_count=64, latency=tlat.NetworkFixedLatency(20),
                     inbox_cap=64, device="cpu"))


def test_pingpong_run_multiple_times_completes_and_averages():
    """tests/test_harness.py:21: pings arrive at 21, pongs at 42, so every
    run stops at the first 10-ms boundary after 42."""
    jproto, proto = _small_pingpongs()
    res = _both(jproto, proto, getters=(
        "done_at_stats", "msg_received_stats", "done_count"), run_count=3,
        max_time=500, chunk=10,
        final_check=lambda net, p: p.pongs >= proto.node_count)
    assert res.stopped_at.tolist() == [50, 50, 50]
    assert res.stats["doneCount"]["count"] == 64.0
    assert res.stats["msgReceived"]["min"] == 1.0
    assert res.stats["msgReceived"]["max"] == 65.0
    assert res.stats["doneAt"]["max"] == 42.0


def test_pingpong_run_multiple_times_is_deterministic():
    """tests/test_harness.py:38, under the distance model."""
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    proto = PingPong(node_count=64, device="cpu")
    r1 = _both(JPingPong(node_count=64), proto, getters=("done_at_stats",),
               run_count=2, max_time=800)
    r2 = harness.run_multiple_times(proto, 2, max_time=800,
                                    stats_getters=(stats.done_at_stats,))
    assert r1.stats == r2.stats
    per = r1.per_run["doneAt"]["avg"]
    assert float(per[0]) != float(per[1])


def test_pingpong_frozen_runs_keep_their_stop_state():
    """tests/test_harness.py:50: the witness sent 64 (its sendAll) + 1
    pong to itself, each replier 1; a stopped run stops counting."""
    jproto, proto = _small_pingpongs()
    res = _both(jproto, proto, getters=("msg_sent_stats",), run_count=2,
                max_time=500)
    assert res.stats["msgSent"]["max"] == 65.0
    assert res.stats["msgSent"]["min"] == 1.0
    assert int(res.nets.time[0]) == int(res.stopped_at[0])


def test_pingpong_progress_per_time_series():
    """tests/test_harness.py:62."""
    jproto, proto = _small_pingpongs()
    ts, _, _ = _both(jproto, proto, "progress_per_time",
                     getters=("done_count",), run_count=2, max_time=300,
                     stat_each_ms=10)
    counts = ts.merged["doneCount.count"]["avg"]
    assert counts[-1] == 64.0
    assert all(a <= b for a, b in zip(counts, counts[1:]))
    assert ts.times[0] == 10 and ts.times[-1] <= 300


def test_spill_protocol_runs_at_k1():
    """Two seeds of tests/test_engine.py's spill probe (delay 500 past
    horizon 64, 8 spill slots): the spill buffer forces K = 1, every run
    delivers at exactly 511, and the harness equals the JAX one."""
    from test_torch_engine_bcast_spill import SPILL8, OneShot, _jax_probe
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), cfg=SPILL8,
                    delay=500)
    jproto = _jax_probe("OneShot", proto.latency, cfg=SPILL8, n=4,
                        delay=500)
    assert network.pick_superstep(proto, 10, t0=0) == 1
    res = _both(jproto, proto, run_count=2, max_time=520)
    assert res.pstates["when"][:, 1].tolist() == [511, 511]
    assert res.pstates["got"].sum(1).tolist() == [1, 1]
    assert res.nets.sp_dropped.tolist() == [0, 0]
    assert int((res.nets.sp_arrival >= 0).sum()) == 0


def test_spill_frozen_run_keeps_its_parked_message():
    """Seed 0 stops after its first 10-ms chunk with its far send still
    parked: the spill drain must keep it out of the in-place ring, so
    seed 0 ends exactly as it stopped (message parked, nothing
    delivered) while seed 1 delivers at 511; both equal the JAX
    harness."""
    from test_torch_engine_bcast_spill import SPILL8, OneShot, _jax_probe
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), cfg=SPILL8,
                    delay=500)
    jproto = _jax_probe("OneShot", proto.latency, cfg=SPILL8, n=4,
                        delay=500)
    res = _both(jproto, proto, run_count=2, max_time=520,
                cont_if=lambda net, p: net.seed != 0)
    assert res.stopped_at.tolist() == [10, 0]
    assert res.nets.time.tolist() == [10, 520]
    assert res.pstates["when"][:, 1].tolist() == [-1, 511]
    assert (res.nets.sp_arrival >= 0).sum(1).tolist() == [1, 0]
    assert int(res.nets.box_count[0].sum()) == 0


class OddStart:
    """tests/test_harness.py:149's probe in either package: the
    64-node Handel whose init starts the clock at t = 1."""

    def __init__(self, handel_cls, **kw):
        self._p = handel_cls(
            node_count=64, threshold=56, nodes_down=6, pairing_time=4,
            dissemination_period_ms=20, level_wait_time=50, fast_path=10,
            horizon=64, network_latency_name="NetworkFixedLatency(16)",
            **kw)
        self.cfg, self.latency = self._p.cfg, self._p.latency
        self.may_self_send = self._p.may_self_send

    def init(self, seed):
        net, ps = self._p.init(seed)
        return net.replace(time=net.time * 0 + 1), ps

    def step(self, *a, **kw):
        return self._p.step(*a, **kw)


def test_odd_entry_time_demotes_superstep():
    """tests/test_harness.py:149: an odd entry time demotes the
    harness's chunk to K = 1, and its result equals the JAX package's
    per-ms `jax.vmap(scan_chunk(...))` from that entry."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk as jscan_chunk
    from wittgenstein_tpu.models.handel import Handel as JHandel
    proto, jproto = OddStart(Handel, device="cpu"), OddStart(JHandel)
    assert network.pick_superstep(proto, 20, t0=1) == 1
    assert network.pick_superstep(proto, 20, t0=0) == 4
    chunk_all = harness._freeze_chunk(proto, 20, harness.cont_until_done,
                                      t0=1)
    nets, ps = init_batched(proto, torch.arange(2))
    nets, ps, *_ = chunk_all(nets, ps, torch.zeros(2, dtype=torch.bool),
                             torch.zeros(2, dtype=torch.int32), 1)
    seeds = jnp.arange(2, dtype=jnp.int32)
    ref = jax.jit(jax.vmap(jscan_chunk(jproto._p, 20)))(
        *jax.vmap(jproto.init)(seeds))
    tp.assert_states_equal(tp.jax_state(*ref), convert.to_numpy(nets, ps),
                           "odd entry")
    assert nets.time.tolist() == [21, 21]
