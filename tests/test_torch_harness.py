"""The multi-run harness of the port (`core/harness.py`, on the
seed-folded engine) against the JAX package's `core/harness.py`, on the
64-node reference-default Handel with 3 seeds: `run_multiple_times` (each
run's stop time, per-run and averaged stats, and the final state of every
run, frozen at its stop time, ring included) and `progress_per_time`
(sample times, per-run samples, merged series); the frozen runs against
the dense engine run to their stop times; the `max_time=0` wall-clock
guard; protocols outside the engine's scope refused."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.utils import _pytree as pytree

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import harness
from wittgenstein_tpu_torch.core.network import Runner
from wittgenstein_tpu_torch.models.handel import (Handel,
                                                  reference_default_params)
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


@pytest.mark.parametrize("field", ["bcast_slots", "spill_cap"])
def test_protocols_outside_the_batched_scope_raise(field):
    proto = Handel(**reference_default_params(64), device="cpu")
    proto.cfg = dataclasses.replace(proto.cfg, **{field: 4})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        harness.run_multiple_times(proto, 2, max_time=20)
