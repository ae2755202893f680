"""The port's obs planes under the chaos plane: the counterparts of
tests/test_chaos.py:208-292, held to the JAX package.

Taps see the post-application state, so the flight recorder records
each churn transition as a `node_down`/`node_up` event at its exact ms
(the same stream at K=1 and K=2), the audit stays clean under churn and
partition while a planted `FaultInjector` counter fault is still caught
at its ms, and the metrics plane sees the outage; every carry equals the
JAX plane's word for word and every instrumented state the plain
faulted run's.
"""

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import obs
from wittgenstein_tpu_torch.chaos import ChaosProtocol, FaultSchedule
from wittgenstein_tpu_torch.core.network import scan_chunk
from wittgenstein_tpu_torch.models.pingpong import PingPong

SCHED = dict(churn=((3, 20, 60), (5, 40, 100)),
             partitions=((30, 90, 1, 0, 32),),
             loss=((0, 120, 250, 0, 64, 0, 64),),
             delay=((10, 50, 3, 0, 64, 0, 64),))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair():
    """(JAX, port) PingPong(64) under SCHED."""
    from wittgenstein_tpu import chaos
    from wittgenstein_tpu.models.pingpong import PingPong as JP
    return (chaos.ChaosProtocol(JP(node_count=64),
                                chaos.FaultSchedule(**SCHED)),
            ChaosProtocol(PingPong(node_count=64, device="cpu"),
                          FaultSchedule(**SCHED)))


def test_trace_node_down_up_kinds():
    import jax

    from wittgenstein_tpu.obs.trace import TraceSpec as JSpec
    from wittgenstein_tpu.obs.trace import scan_chunk_trace as jtrace
    jc, cp = _pair()
    spec = obs.TraceSpec(capacity=4096)
    net, ps, tc = obs.scan_chunk_trace(cp, 120, spec)(*cp.init(0))
    fr = obs.TraceFrame.from_carry(spec, tc)
    dn, up = (fr.filter(kinds=(k,)) for k in ("node_down", "node_up"))
    assert list(zip(dn.column("time_ms").tolist(),
                    dn.column("src").tolist())) == [(20, 3), (40, 5)]
    assert list(zip(up.column("time_ms").tolist(),
                    up.column("src").tolist())) == [(60, 3), (100, 5)]
    tp.assert_states_equal(
        tp.convert.to_numpy(*scan_chunk(cp, 120)(*cp.init(0))),
        tp.convert.to_numpy(net, ps), "trace ON vs OFF")
    jn, jps, jtc = jax.jit(jtrace(jc, 120, JSpec(capacity=4096)))(
        *jc.init(0))
    tp.assert_port_jax_states((jn, jps), (net, ps))
    tp.assert_carries_equal(jtc, tc, "trace")
    p = obs.trace_to_perfetto(fr)
    assert sum(1 for e in p["traceEvents"]
               if e.get("ph") == "X") == fr.n_events
    _, _, tc2 = obs.scan_chunk_trace(cp, 120, spec, superstep=2)(
        *cp.init(0))
    assert torch.equal(tc.buf, tc2.buf) and int(tc.cursor) == \
        int(tc2.cursor)


def test_audit_clean_under_chaos_and_fault_still_caught():
    from wittgenstein_tpu.obs.audit import AuditSpec as JSpec
    from wittgenstein_tpu.obs.audit_report import audit_variant as jaudit
    from wittgenstein_tpu_torch.obs.diff import FaultInjector
    jc, cp = _pair()
    report, states = obs.audit_variant(cp, 120, {"superstep": 1},
                                       obs.AuditSpec())
    assert report.clean, report.format()
    tp.assert_states_equal(
        tp.convert.to_numpy(*scan_chunk(cp, 120)(*tp.port_batch(cp, 1))),
        tp.convert.to_numpy(*states), "audited vs plain")
    jreport, jstates = jaudit(jc, 120, {"superstep": 1}, JSpec())
    tp.assert_port_jax_states(jstates, states)
    assert report.stats() == jreport.stats()
    inner = PingPong(node_count=64, device="cpu")
    planted = ChaosProtocol(FaultInjector(inner, at_ms=37,
                                          leaf="nodes.msg_sent", node=5,
                                          delta=-(1 << 20)),
                            FaultSchedule(**SCHED))
    rep2, _ = obs.audit_variant(planted, 120, {"superstep": 1},
                                obs.AuditSpec())
    assert not rep2.clean
    assert rep2.first["invariant"] == "counter_monotone"
    assert rep2.first["ms"] == 37


def test_metrics_plane_sees_the_outage():
    import jax

    from wittgenstein_tpu.obs.engine import scan_chunk_metrics as jmetrics
    from wittgenstein_tpu.obs.spec import MetricsSpec as JSpec
    jc, cp = _pair()
    mspec = obs.MetricsSpec(stat_each_ms=10)
    net, ps, mc = obs.scan_chunk_metrics(cp, 120, mspec)(*cp.init(0))
    frame = obs.MetricsFrame.from_carry(mspec, mc)
    live = frame.series[:, list(mspec.columns).index("live_count")]
    assert int(live.min()) == 62 and int(live[-1]) == 64
    tp.assert_states_equal(
        tp.convert.to_numpy(*scan_chunk(cp, 120)(*cp.init(0))),
        tp.convert.to_numpy(net, ps), "metrics ON vs OFF")
    jn, jps, jmc = jax.jit(jmetrics(jc, 120, JSpec(stat_each_ms=10)))(
        *jc.init(0))
    tp.assert_port_jax_states((jn, jps), (net, ps))
    tp.assert_carries_equal(jmc, mc, "metrics")
    np.testing.assert_array_equal(np.asarray(jmc.series),
                                  mc.series.numpy())
