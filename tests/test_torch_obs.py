"""The port's on-device metrics plane (`wittgenstein_tpu_torch/obs`
spec, plane, engine and export): the counterparts of tests/test_obs.py.

Every run holds the port against the JAX package at tolerance 0: the
instrumented state equals the uninstrumented one leaf for leaf (ON is
bit-identical) and equals the JAX run's, and the `MetricsCarry` equals
the JAX plane's carry word for word, for the dense engine (PingPong,
Handel exact and cardinal, Dfinity; 2 seeds), the seed-folded engine,
the fast-forward engine, `Runner(metrics=)` and
`progress_per_time_on_device`; the exporters' CSV, Perfetto trace and
bench block equal the JAX exporters' output on the same carry.  The
zero-residue pin: the engine without a plane issues exactly the PyTorch
ops a simulated ms it issued before the planes were ported (counted on
the CPU by `chip_smoke.ops_per_ms`).  The sharded twin waits for the
port's multi-device engine (ROADMAP.md A15).
"""

import json

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import obs
from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
from wittgenstein_tpu_torch.core.network import (Runner, fast_forward_chunk,
                                                 scan_chunk)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_obs():
    from wittgenstein_tpu import obs as jobs
    return jobs


def _check_frame_accounting(frame, net, executed_ms):
    """The recorded series is exact: cumulative-counter deltas sum to
    the final state, samples count every executed ms."""
    t = frame.totals()
    nodes = net.nodes
    assert t["samples"] == executed_ms
    assert t["msg_sent"] == int(nodes.msg_sent.sum())
    assert t["msg_received"] == int(nodes.msg_received.sum())
    assert t["bytes_sent"] == int(nodes.bytes_sent.sum())
    assert t["bytes_received"] == int(nodes.bytes_received.sum())
    assert t["drop_count"] == int(net.dropped.sum() + net.bc_dropped.sum()
                                  + net.clamped.sum() + net.sp_dropped.sum())
    for name in ("msg_sent", "bytes_received", "drop_count"):
        assert int(frame.deltas(name).sum()) == t[name], name


@pytest.mark.parametrize("name", ["PingPong", "Handel", "HandelCardinal",
                                  "Dfinity"])
def test_metrics_on_bit_identical_and_exact(name):
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols(name)
    ms, seeds = 160, 2
    spec = obs.MetricsSpec(stat_each_ms=20)

    ref = scan_chunk(pp, ms)(*tp.port_batch(pp, seeds))
    net2, ps2, mc = obs.scan_chunk_metrics(pp, ms, spec)(
        *tp.port_batch(pp, seeds))
    tp.assert_states_equal(tp.convert.to_numpy(*ref),
                           tp.convert.to_numpy(net2, ps2), "ON vs OFF")
    jn, jps, jmc = jax.jit(jax.vmap(jobs.scan_chunk_metrics(
        jp, ms, jobs.MetricsSpec(stat_each_ms=20))))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2), name)
    tp.assert_carries_equal(jmc, mc, name)
    frame = obs.MetricsFrame.from_carry(spec, mc)
    assert frame.n_intervals == spec.n_intervals(ms)
    _check_frame_accounting(frame, net2, seeds * ms)


def test_metrics_on_bit_identical_batched_engine():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("Handel")
    ms, seeds = 80, 2
    spec = obs.MetricsSpec(stat_each_ms=20)
    ref = scan_chunk_batched(pp, ms)(*tp.port_batch(pp, seeds))
    net2, ps2, mc = obs.scan_chunk_batched_metrics(pp, ms, spec)(
        *tp.port_batch(pp, seeds))
    tp.assert_states_equal(tp.convert.to_numpy(*ref),
                           tp.convert.to_numpy(net2, ps2), "ON vs OFF")
    jn, jps, jmc = jax.jit(jobs.scan_chunk_batched_metrics(
        jp, ms, jobs.MetricsSpec(stat_each_ms=20)))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2))
    tp.assert_carries_equal(jmc, mc)
    _check_frame_accounting(obs.MetricsFrame.from_carry(spec, mc), net2,
                            seeds * ms)
    with pytest.raises(ValueError, match="batched metrics builders"):
        obs.scan_chunk_batched_metrics(pp, 80, spec, superstep=1)


def test_metrics_fast_forward_bit_identical_and_covers_chunk():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    ms, seeds = 320, 2
    spec = obs.MetricsSpec(stat_each_ms=20)
    ref = fast_forward_chunk(pp, ms, seed_axis=True)(
        *tp.port_batch(pp, seeds))
    net2, ps2, stats, mc = obs.fast_forward_chunk_metrics(
        pp, ms, spec, seed_axis=True)(*tp.port_batch(pp, seeds))
    tp.assert_states_equal(tp.convert.to_numpy(*ref[:2]),
                           tp.convert.to_numpy(net2, ps2), "ON vs OFF")
    assert stats == ref[2] and stats["skipped_ms"] > 0
    jn, jps, jstats, jmc = jax.jit(jobs.fast_forward_chunk_metrics(
        jp, ms, jobs.MetricsSpec(stat_each_ms=20), seed_axis=True))(
        *tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2))
    assert {k: int(v) for k, v in jstats.items()} == stats
    tp.assert_carries_equal(jmc, mc)

    frame = obs.MetricsFrame.from_carry(spec, mc)
    t = frame.totals()
    skipped = stats["skipped_ms"]
    assert t["ff_skipped_ms"] == seeds * skipped
    assert t["samples"] + t["ff_skipped_ms"] == seeds * ms
    assert t["ff_jumps"] == seeds * stats["jump_count"]
    _check_frame_accounting(frame, net2, seeds * (ms - skipped))
    samples = frame.column("samples")
    filled = frame.filled("msg_sent")
    raw = frame.column("msg_sent")
    assert (samples == 0).any()
    for i in range(1, frame.n_intervals):
        assert filled[i] == (filled[i - 1] if samples[i] == 0 else raw[i])


def test_counter_values_reads_engine_state_exactly():
    _, pp = tp.obs_protocols("PingPong")
    net, _ = pp.init(0)
    count = net.box_count.clone()
    count[3, 5], count[7, 1] = 2, 1
    active = net.bc_active.clone()
    active[0] = True
    net = net.replace(box_count=count, bc_active=active,
                      dropped=torch.tensor(4, dtype=torch.int32),
                      clamped=torch.tensor(1, dtype=torch.int32))
    vals = {k: int(v) for k, v in obs.counter_values(obs.MetricsSpec(),
                                                     net).items()}
    assert vals["ring_rows"] == 2
    assert vals["ring_occupancy"] == 3
    assert vals["bc_live"] == 1
    assert vals["drop_count"] == 5
    assert vals["live_count"] == pp.cfg.n
    assert vals["done_count"] == 0
    assert vals["spill_hwm"] == 0
    assert all(v.dtype == torch.int32 for v in
               obs.counter_values(obs.MetricsSpec(), net).values())


def test_metrics_spec_validation_and_layout():
    from wittgenstein_tpu_torch.obs.engine import _check_superstep_interval
    with pytest.raises(ValueError, match="stat_each_ms"):
        obs.MetricsSpec(stat_each_ms=0)
    with pytest.raises(ValueError, match="unknown counters"):
        obs.MetricsSpec(counters=("msg_sent", "nope"))
    spec = obs.MetricsSpec(counters=("drop_count", "samples", "msg_sent"))
    assert spec.columns == ("samples", "msg_sent", "drop_count")
    assert spec.col("drop_count") == 2 and spec.col("ff_jumps") is None
    assert spec.n_intervals(95) == 10
    with pytest.raises(ValueError, match="multiple of it"):
        _check_superstep_interval(obs.MetricsSpec(stat_each_ms=5), 2)
    _, pp = tp.obs_protocols("PingPong")
    out = obs.scan_chunk_metrics(pp, 40, spec)(*pp.init(0))
    assert tuple(out[2].series.shape) == (4, 3)
    assert out[2].series.dtype == torch.int32


def test_exporters_equal_the_jax_exporters():
    """The CSV, the Perfetto trace and the bench block of the port's
    frame equal the JAX exporters' output on the JAX carry."""
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    spec, jspec = (obs.MetricsSpec(stat_each_ms=20),
                   jobs.MetricsSpec(stat_each_ms=20))
    ms = 200
    net2, ps2, mc = obs.scan_chunk_metrics(pp, ms, spec)(*pp.init(0))
    _, _, jmc = jax.jit(jobs.scan_chunk_metrics(jp, ms, jspec))(
        *jp.init(0))
    tp.assert_carries_equal(jmc, mc)
    frame = obs.MetricsFrame.from_carry(spec, mc)
    jframe = jobs.MetricsFrame.from_carry(jspec, jmc)

    csv = str(obs.to_progress_csv(frame))
    assert csv == str(jobs.to_progress_csv(jframe))
    lines = csv.strip().splitlines()
    assert lines[0].startswith("time,samples,msg_sent,msg_sent_cum")
    assert len(lines) == 1 + frame.n_intervals
    last = dict(zip(lines[0].split(","), lines[-1].split(",")))
    assert int(last["msg_sent_cum"]) == int(net2.nodes.msg_sent.sum())

    trace = obs.to_perfetto(frame)
    assert trace == jobs.to_perfetto(jframe)
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == frame.n_intervals
    assert xs[0]["dur"] == spec.stat_each_ms * 1000

    blk = obs.engine_metrics_block(frame)
    assert blk == jobs.engine_metrics_block(jframe)
    assert blk["series"]["time"][-1] == ms
    json.dumps(blk)
    assert obs.export.time_to_done_ms(blk) == \
        jobs.export.time_to_done_ms(jobs.engine_metrics_block(jframe))
    big = obs.MetricsFrame(spec=spec, t0=0,
                           series=np.zeros((100, len(spec.columns)),
                                           np.int64))
    assert obs.engine_metrics_block(big).get("series_truncated") is True


def test_runner_fast_forward_and_metrics():
    from wittgenstein_tpu.core.network import Runner as JRunner
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    spec = obs.MetricsSpec(stat_each_ms=20)
    ref = Runner(pp).run_ms(*pp.init(0), 200)

    r1 = Runner(pp, fast_forward=True, metrics=spec)
    out = r1.run_ms(*pp.init(0), 100)
    out = r1.run_ms(*out, 100)                  # chunked: carries stitch
    tp.assert_states_equal(tp.convert.to_numpy(*ref),
                           tp.convert.to_numpy(*out), "ON vs OFF")
    st = r1.ff_stats()
    assert st["skipped_ms"] > 0
    frame = r1.metrics_frame()
    assert frame.n_intervals == 10
    assert frame.totals()["ff_skipped_ms"] == st["skipped_ms"]
    assert frame.totals()["samples"] + st["skipped_ms"] == 200

    j1 = JRunner(jp, fast_forward=True,
                 metrics=jobs.MetricsSpec(stat_each_ms=20))
    jout = j1.run_ms(*jp.init(0), 100)
    jout = j1.run_ms(*jout, 100)
    tp.assert_port_jax_states(jout, out)
    assert j1.ff_stats() == st
    for jmc, mc in zip(j1.metrics_carries, r1.metrics_carries):
        tp.assert_carries_equal(jmc, mc)
    with pytest.raises(ValueError, match="run the chunk twice"):
        Runner(pp, metrics=spec, trace=obs.TraceSpec())
    assert Runner(pp).metrics_frame() is None


def test_harness_on_device_progress_series():
    from wittgenstein_tpu.core.harness import \
        progress_per_time_on_device as jax_ppt
    from wittgenstein_tpu_torch.core.harness import \
        progress_per_time_on_device
    jp, pp = tp.obs_protocols("PingPong")
    frame, nets, ps = progress_per_time_on_device(
        pp, run_count=2, max_time=320, stat_each_ms=20, fast_forward=True)
    t = frame.totals()
    assert t["samples"] + t["ff_skipped_ms"] == 2 * 320
    assert t["msg_sent"] == int(nets.nodes.msg_sent.sum())
    assert frame.n_intervals == 16
    jframe, jnets, jps = jax_ppt(jp, run_count=2, max_time=320,
                                 stat_each_ms=20, fast_forward=True)
    np.testing.assert_array_equal(frame.series, jframe.series)
    assert frame.t0 == jframe.t0
    tp.assert_port_jax_states((jnets, jps), (nets, ps))
    frame2, _, _ = progress_per_time_on_device(pp, run_count=1,
                                               max_time=60, stat_each_ms=20,
                                               counters=("msg_sent",))
    assert frame2.spec.columns == ("msg_sent",)
    assert frame2.n_intervals == 3


#: PyTorch ops a simulated ms of the engine without a plane (CPU,
#: `chip_smoke.ops_per_ms` over 2 ms from t=20, after a 20-ms chunk
#: from seed 0), counted on the tree before the planes were ported:
#: the planes' hooks must add none
OPS_PIN = {("PingPong", 1): 740.0, ("PingPong", 2): 579.5,
           ("Handel", 1): 1889.0, ("Handel", 2): 1721.5}


@pytest.mark.parametrize("name", ["PingPong", "Handel"])
def test_planes_off_add_no_op(name, monkeypatch):
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _, pp = tp.obs_protocols(name)
    for k in (1, 2):
        net, ps = scan_chunk(pp, 20)(*pp.init(0), t=0)
        window = scan_chunk(pp, 2, superstep=k)
        assert chip_smoke.ops_per_ms(lambda: window(net, ps, t=20), 2) == \
            OPS_PIN[name, k], (name, k)


def test_obs_golden_matches_jax():
    """The committed carries of `chip_smoke.py` phase O (PingPong 64
    under each plane) are the JAX planes' (`torch_parity.py obs-golden`),
    and the port's planes on the CPU equal them."""
    import dataclasses
    with open(tp.OBS_GOLDEN_FILE) as f:
        golden = json.load(f)
    _, pp = tp.obs_protocols("PingPong")
    runner = Runner(pp, audit=obs.AuditSpec())
    runner.run_ms(*pp.init(0), tp.OBS_MS)
    port = {"metrics": obs.scan_chunk_metrics(
        pp, tp.OBS_METRICS_MS, obs.MetricsSpec(stat_each_ms=tp.OBS_STAT_MS))(
        *pp.init(0))[2],
        "trace": obs.scan_chunk_trace(pp, tp.OBS_MS, obs.TraceSpec())(
            *pp.init(0))[2],
        "audit": runner.audit_carries[-1]}
    for plane, (carry, state) in tp.jax_obs_carries().items():
        want = golden[plane]
        assert tp.obs_carry_record(plane, carry) == want["carry"], plane
        assert tp.convert.state_digest(*state) == want["leaves"], plane
        got = {f.name: getattr(port[plane], f.name).numpy()
               for f in dataclasses.fields(port[plane])}
        assert tp.obs_carry_record(plane, got) == want["carry"], plane
