"""The port's event flight recorder (`wittgenstein_tpu_torch/obs` trace,
decode, export and `core/harness.capture_trace`): the counterparts of
tests/test_trace.py.

Every traced run equals the untraced run leaf for leaf (trace-ON is
bit-identical) and the JAX run, and its `TraceCarry` (the event ring,
its cursor, the dropped count and the observed down row) equals the JAX
recorder's word for word: the dense engine (PingPong, Handel exact and
cardinal, Dfinity; 2 seeds), the seed-folded engine, the fast-forward
engine with its jump events, the K-window ladder (events at their exact
origin ms, equal to the K=1 ring), `Runner(trace=)` and `capture_trace`
with the Perfetto exporter.  The planes add no host read: a traced
chunk reads the device from the host (the analysis plane's op recorder,
`wittgenstein_tpu_torch/analysis/trace.py`: items, `nonzero`,
`tolist`, ...) no more often than the untraced one.  The sharded twin waits
for the port's multi-device engine (ROADMAP.md A15).
"""

import json

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import obs
from wittgenstein_tpu_torch.analysis.trace import host_reads
from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
from wittgenstein_tpu_torch.core.network import (Runner, fast_forward_chunk,
                                                 scan_chunk)
from wittgenstein_tpu_torch.obs.trace import KIND


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_obs():
    from wittgenstein_tpu import obs as jobs
    return jobs


def _same(a, b, what=""):
    tp.assert_states_equal(tp.convert.to_numpy(*a), tp.convert.to_numpy(*b),
                           what)




@pytest.mark.parametrize("name", ["PingPong", "Handel", "HandelCardinal",
                                  "Dfinity"])
def test_trace_on_bit_identical_dense(name):
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols(name)
    ms, seeds = 120, 2
    spec = obs.TraceSpec(capacity=1 << 15)
    ref = scan_chunk(pp, ms)(*tp.port_batch(pp, seeds))
    net2, ps2, tc = obs.scan_chunk_trace(pp, ms, spec)(
        *tp.port_batch(pp, seeds))
    _same(ref, (net2, ps2), "ON vs OFF")
    jn, jps, jtc = jax.jit(jax.vmap(jobs.scan_chunk_trace(
        jp, ms, jobs.TraceSpec(capacity=1 << 15))))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2), name)
    tp.assert_carries_equal(jtc, tc, name)
    frame = obs.TraceFrame.from_carry(spec, tc)
    assert frame.dropped == 0
    assert frame.counts().get("deliver", 0) > 0


def test_trace_on_bit_identical_batched_engine():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("Handel")
    ms, seeds = 80, 2
    spec = obs.TraceSpec(capacity=1 << 15)
    ref = scan_chunk_batched(pp, ms)(*tp.port_batch(pp, seeds))
    net2, ps2, tc = obs.scan_chunk_batched_trace(pp, ms, spec)(
        *tp.port_batch(pp, seeds))
    _same(ref, (net2, ps2), "ON vs OFF")
    jn, jps, jtc = jax.jit(jobs.scan_chunk_batched_trace(
        jp, ms, jobs.TraceSpec(capacity=1 << 15)))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2))
    tp.assert_carries_equal(jtc, tc)
    assert obs.TraceFrame.from_carry(spec, tc).n_events > 0


def test_trace_fast_forward_bit_identical_and_jump_events():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    ms, seeds = 320, 2
    spec = obs.TraceSpec(capacity=4096)
    ref = fast_forward_chunk(pp, ms, seed_axis=True)(
        *tp.port_batch(pp, seeds))
    net2, ps2, stats, tc = obs.fast_forward_chunk_trace(
        pp, ms, spec, seed_axis=True)(*tp.port_batch(pp, seeds))
    _same(ref[:2], (net2, ps2), "ON vs OFF")
    assert stats == ref[2] and stats["skipped_ms"] > 0
    jn, jps, _, jtc = jax.jit(jobs.fast_forward_chunk_trace(
        jp, ms, jobs.TraceSpec(capacity=4096), seed_axis=True))(
        *tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2))
    tp.assert_carries_equal(jtc, tc)
    frame = obs.TraceFrame.from_carry(spec, tc)
    ffj = frame.events[frame.column("kind") == KIND["ff_jump"]]
    assert ffj.shape[0] == seeds * stats["jump_count"]
    assert ffj[:, 5].sum() == seeds * stats["skipped_ms"]


def test_trace_superstep_origin_ms_handel():
    """The K-window ring equals the K=1 ring bit for bit, with events at
    ms off the K grid (the taps fire per simulated ms), and the K=1 ring
    equals the JAX recorder's."""
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("FloorHandel")
    spec = obs.TraceSpec(capacity=1 << 14)
    ref = obs.scan_chunk_trace(pp, 40, spec)(*pp.init(0))
    jref = jax.jit(jobs.scan_chunk_trace(
        jp, 40, jobs.TraceSpec(capacity=1 << 14)))(*jp.init(0))
    tp.assert_carries_equal(jref[2], ref[2])
    times = ref[2].buf[:int(ref[2].cursor), 0].numpy()
    assert times.size > 0
    for k in (2, 4):
        assert (times % k != 0).any(), f"no event off the K={k} grid"
        got = obs.scan_chunk_trace(pp, 40, spec, superstep=k)(*pp.init(0))
        _same(ref[:2], got[:2], f"K={k}")
        for a, b in zip(tp.pytree_leaves(ref[2]), tp.pytree_leaves(got[2])):
            assert torch.equal(a, b), k


def test_trace_event_semantics_pingpong():
    jp, pp = tp.obs_protocols("PingPong")
    spec = obs.TraceSpec(capacity=4096)
    _, _, tc = obs.scan_chunk_trace(pp, 200, spec)(*pp.init(0))
    frame = obs.TraceFrame.from_carry(spec, tc)
    rows = frame.rows()
    assert rows[0] == {"time_ms": 0, "kind": "send", "src": 0,
                       "dst": -1, "payload_bytes": 1, "aux": -1}
    sends, got_bc = set(), 0
    for r in rows:
        if r["kind"] == "send":
            sends.add((r["src"], r["dst"]))
        elif r["kind"] == "deliver":
            if r["aux"] >= pp.cfg.inbox_cap:
                got_bc += 1
                assert r["src"] == 0
            else:
                assert (r["src"], r["dst"]) in sends or \
                    (r["src"], -1) in sends, r
    assert got_bc > 0
    assert "drop" not in frame.counts()
    w = frame.window(0, 1)
    assert w.n_events >= 1 and (w.column("time_ms") == 0).all()
    node7 = frame.filter(node=7)
    assert all(r["src"] == 7 or r["dst"] == 7 for r in node7.rows())
    assert "send" in frame.format(limit=5)


def test_trace_node_filter_and_event_subset():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    kw = dict(capacity=1024, events=("deliver",), node_filter=(0, 8))
    spec = obs.TraceSpec(**kw)
    _, _, tc = obs.scan_chunk_trace(pp, 200, spec)(*pp.init(0))
    _, _, jtc = jax.jit(jobs.scan_chunk_trace(jp, 200, jobs.TraceSpec(
        **kw)))(*jp.init(0))
    tp.assert_carries_equal(jtc, tc)
    frame = obs.TraceFrame.from_carry(spec, tc)
    assert frame.n_events > 0
    assert set(frame.counts()) == {"deliver"}
    src, dst = frame.column("src"), frame.column("dst")
    assert (((src >= 0) & (src < 8)) | ((dst >= 0) & (dst < 8))).all()
    assert obs.trace_block(frame)["node_filter"] == [0, 8]


def test_trace_spec_validation():
    with pytest.raises(ValueError, match="capacity"):
        obs.TraceSpec(capacity=0)
    with pytest.raises(ValueError, match="unknown events"):
        obs.TraceSpec(events=("deliver", "nope"))
    with pytest.raises(ValueError, match="node_filter"):
        obs.TraceSpec(node_filter=(5, 5))
    spec = obs.TraceSpec(events=("drop", "send", "deliver"))
    assert spec.events == ("send", "deliver", "drop")
    assert spec.enabled("send") and not spec.enabled("ff_jump")


def test_trace_capacity_truncation_is_loud():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    spec = obs.TraceSpec(capacity=16)
    net2, ps2, tc = obs.scan_chunk_trace(pp, 200, spec)(*pp.init(0))
    _same(scan_chunk(pp, 200)(*pp.init(0)), (net2, ps2), "ON vs OFF")
    _, _, jtc = jax.jit(jobs.scan_chunk_trace(
        jp, 200, jobs.TraceSpec(capacity=16)))(*jp.init(0))
    tp.assert_carries_equal(jtc, tc)
    assert int(tc.cursor) == 16
    frame = obs.TraceFrame.from_carry(spec, tc)
    assert frame.dropped > 0
    blk = obs.trace_block(frame)
    assert blk["truncated"] is True and blk["dropped"] == frame.dropped
    assert blk == jobs.trace_block(jobs.TraceFrame.from_carry(
        jobs.TraceSpec(capacity=16), jtc))
    assert "truncated" in frame.format()


def test_runner_trace_and_stats():
    from wittgenstein_tpu.core.network import Runner as JRunner
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    spec = obs.TraceSpec(capacity=2048)
    ref = Runner(pp).run_ms(*pp.init(0), 200)
    r1 = Runner(pp, fast_forward=True, trace=spec)
    out = r1.run_ms(*pp.init(0), 100)
    out = r1.run_ms(*out, 100)                  # chunked: rings stitch
    _same(ref, out, "ON vs OFF")
    frame = r1.trace_frame()
    st = r1.trace_stats()
    assert st["events"] == frame.n_events > 0
    assert st["dropped"] == 0
    j1 = JRunner(jp, fast_forward=True, trace=jobs.TraceSpec(capacity=2048))
    jout = j1.run_ms(*jp.init(0), 100)
    j1.run_ms(*jout, 100)
    assert j1.trace_stats() == st
    for jtc, tc in zip(j1.trace_carries, r1.trace_carries):
        tp.assert_carries_equal(jtc, tc)
    r2 = Runner(pp, trace=obs.TraceSpec(capacity=8))
    out2 = r2.run_ms(*pp.init(0), 200)
    _same(ref, out2)
    assert r2.trace_stats()["dropped"] > 0


def test_capture_trace_helper_and_perfetto():
    from wittgenstein_tpu.core.harness import capture_trace as jcapture
    from wittgenstein_tpu_torch.core.harness import capture_trace
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    frame, net, ps = capture_trace(pp, 120, obs.TraceSpec(capacity=1024))
    assert frame.n_events > 0 and frame.dropped == 0
    assert int(net.time) == 120
    jframe, jnet, jps = jcapture(jp, 120, jobs.TraceSpec(capacity=1024))
    np.testing.assert_array_equal(frame.events, jframe.events)
    tp.assert_port_jax_states((jnet, jps), (net, ps))
    trace = obs.trace_to_perfetto(frame)
    assert trace == jobs.trace_to_perfetto(jframe)
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == frame.n_events
    assert {e["name"] for e in xs} <= set(obs.EVENTS)
    assert xs[0]["ts"] == int(frame.events[0, 0]) * 1000
    json.dumps(trace)
    ff, fnet, _ = capture_trace(pp, 120, obs.TraceSpec(capacity=1024),
                                fast_forward=True)
    assert int(fnet.time) == 120 and ff.counts().get("ff_jump", 0) > 0
    spans = obs.spans_to_perfetto(
        [{"name": "chunk", "t0": 1.0, "dur": 0.5, "rid": "r1"}],
        device=trace)
    assert spans == jobs.spans_to_perfetto(
        [{"name": "chunk", "t0": 1.0, "dur": 0.5, "rid": "r1"}],
        device=trace)


@pytest.mark.parametrize("plane", ["metrics", "trace", "audit"])
def test_planes_add_no_host_read(plane):
    """A plane's chunk reads the device from the host no more often than
    the engine's alone (the CPU twin of the card's sync count)."""
    _, pp = tp.obs_protocols("PingPong")
    build = {"metrics": lambda: obs.scan_chunk_metrics(
        pp, 20, obs.MetricsSpec(stat_each_ms=10)),
        "trace": lambda: obs.scan_chunk_trace(pp, 20, obs.TraceSpec()),
        "audit": lambda: obs.scan_chunk_audit(pp, 20, obs.AuditSpec())}
    plain, run = scan_chunk(pp, 20), build[plane]()
    state = scan_chunk(pp, 20)(*pp.init(0), t=0)
    base = host_reads(lambda: plain(*tp.clone(state), t=20))
    assert host_reads(lambda: run(*tp.clone(state), t=20)) <= base
