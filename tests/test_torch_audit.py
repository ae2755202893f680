"""The port's invariant audit plane (`wittgenstein_tpu_torch/obs` audit
and audit_report): the counterparts of tests/test_audit.py.

Every audited run equals the unaudited run leaf for leaf (audit-ON is
bit-identical) and the JAX run, its verdict is clean, and its
`AuditCarry` equals the JAX plane's word for word: the dense engine
(PingPong, Dfinity; 2 seeds), the K-window ladder (K = 1, 2, 4 on a
floor-rich Handel), the seed-folded engine, the fast-forward engine and
`Runner(audit=)`.  An injected one-(ms, node, leaf) fault trips
counter_monotone in its own window, and the verdict agrees with the
port's bisector (`obs.diff.first_divergence`) and with the JAX
package's verdict on the same fault; mode "count" keeps no first
record; the audit's totals cross-check against the metrics plane.  The
sharded audit and the JAX package's ledger and CLI are not ported
(ROADMAP.md A14, A15).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import obs
from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
from wittgenstein_tpu_torch.core.network import (Runner, fast_forward_chunk,
                                                 scan_chunk)
from wittgenstein_tpu_torch.obs.audit import monitored_invariants
from wittgenstein_tpu_torch.obs.diff import FaultInjector, first_divergence


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


@pytest.mark.parametrize("name", ["PingPong", "Dfinity"])
def test_audit_on_bit_identical_dense_and_clean(name):
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols(name)
    ms, seeds = 120, 2
    spec = obs.AuditSpec()
    ref = scan_chunk(pp, ms)(*tp.port_batch(pp, seeds))
    net2, ps2, ac = obs.scan_chunk_audit(pp, ms, spec)(
        *tp.port_batch(pp, seeds))
    _same(ref, (net2, ps2), "ON vs OFF")
    jn, jps, jac = jax.jit(jax.vmap(jobs.scan_chunk_audit(
        jp, ms, jobs.AuditSpec())))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2), name)
    tp.assert_carries_equal(jac, ac, name)
    report = obs.AuditReport.from_carry(spec, ac)
    assert report.clean, report.format()
    assert report.totals_dict()["msg_sent"] > 0
    assert "shard_conservation" not in monitored_invariants(spec, pp.cfg)


def test_audit_superstep_windows_bit_identical_and_clean():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("FloorHandel")
    spec = obs.AuditSpec()
    ref = obs.scan_chunk_audit(pp, 40, spec)(*pp.init(0))
    assert obs.AuditReport.from_carry(spec, ref[2]).clean
    for k in (1, 2, 4):
        got = obs.scan_chunk_audit(pp, 40, spec, superstep=k)(*pp.init(0))
        _same(ref[:2], got[:2], f"K={k}")
        report = obs.AuditReport.from_carry(spec, got[2])
        assert report.clean, (k, report.format())
        jgot = jax.jit(jobs.scan_chunk_audit(jp, 40, jobs.AuditSpec(),
                                             superstep=k))(*jp.init(0))
        tp.assert_port_jax_states(jgot[:2], got[:2], f"K={k}")
        tp.assert_carries_equal(jgot[2], got[2], f"K={k}")


def test_audit_batched_engine_bit_identical_and_clean():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("Handel")
    ms, seeds = 80, 2
    spec = obs.AuditSpec()
    ref = scan_chunk_batched(pp, ms)(*tp.port_batch(pp, seeds))
    net2, ps2, ac = obs.scan_chunk_batched_audit(pp, ms, spec)(
        *tp.port_batch(pp, seeds))
    _same(ref, (net2, ps2), "ON vs OFF")
    assert obs.AuditReport.from_carry(spec, ac).clean
    jn, jps, jac = jax.jit(jobs.scan_chunk_batched_audit(
        jp, ms, jobs.AuditSpec()))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2))
    tp.assert_carries_equal(jac, ac)


def test_audit_fast_forward_bit_identical_and_clean():
    import jax
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    ms, seeds = 240, 2
    spec = obs.AuditSpec()
    ref = fast_forward_chunk(pp, ms, seed_axis=True)(
        *tp.port_batch(pp, seeds))
    net2, ps2, stats, ac = obs.fast_forward_chunk_audit(
        pp, ms, spec, seed_axis=True)(*tp.port_batch(pp, seeds))
    _same(ref[:2], (net2, ps2), "ON vs OFF")
    assert stats == ref[2] and stats["skipped_ms"] > 0
    report = obs.AuditReport.from_carry(spec, ac)
    assert report.clean, report.format()
    jn, jps, _, jac = jax.jit(jobs.fast_forward_chunk_audit(
        jp, ms, jobs.AuditSpec(), seed_axis=True))(*tp.jax_batch(jp, seeds))
    tp.assert_port_jax_states((jn, jps), (net2, ps2))
    tp.assert_carries_equal(jac, ac)


def _bad(proto, at_ms, mod=None):
    cls = FaultInjector if mod is None else mod.FaultInjector
    return cls(proto, at_ms=at_ms, leaf="nodes.msg_sent", node=5,
               delta=-(1 << 20))


def _assert_injection_flagged(name, at_ms, total_ms, chunk_ms):
    """A one-(ms, node, leaf) perturbation trips counter_monotone in its
    own window; the verdict agrees with the bisector's localization and
    with the JAX plane's verdict on the same fault."""
    from wittgenstein_tpu.obs import audit_variant as jaudit_variant
    from wittgenstein_tpu.obs import diff as jdiff
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols(name)
    report, _ = obs.audit_variant(_bad(pp, at_ms), total_ms,
                                  {"superstep": 1},
                                  obs.AuditSpec(mode="first"))
    assert not report.clean
    assert report.first["invariant"] == "counter_monotone"
    assert report.first["ms"] == at_ms
    div = first_divergence(pp, {"superstep": 1}, {"superstep": 1},
                           total_ms, chunk_ms=chunk_ms,
                           protocol_b=_bad(pp, at_ms), trace_spec=False)
    assert div is not None and div.ms == report.first["ms"]
    assert "msg_sent" in div.leaf
    assert "AUDIT" in report.format()
    assert "counter_monotone" in report.format()
    jreport, _ = jaudit_variant(_bad(jp, at_ms, jdiff), total_ms,
                                {"superstep": 1},
                                jobs.AuditSpec(mode="first"))
    assert jreport.stats() == report.stats()


def test_audit_flags_injected_fault_pingpong_and_agrees_with_bisector():
    _assert_injection_flagged("PingPong", at_ms=37, total_ms=64,
                              chunk_ms=32)


def test_audit_flags_injected_fault_handel_and_agrees_with_bisector():
    _assert_injection_flagged("Handel", at_ms=21, total_ms=40, chunk_ms=20)


def test_audit_mode_count_has_no_first_record():
    _, pp = tp.obs_protocols("PingPong")
    report, _ = obs.audit_variant(_bad(pp, 37), 64, {"superstep": 1},
                                  obs.AuditSpec(mode="count"))
    assert not report.clean and report.first is None
    assert report.violations()["counter_monotone"] >= 1
    assert "mode='count'" in report.format()
    with pytest.raises(ValueError, match="superstep >= 2"):
        obs.audit_variant(pp, 64, {"batched": True})
    with pytest.raises(ValueError, match="unknown variant keys"):
        obs.audit_variant(pp, 64, {"warp": 9})


def test_runner_audit_and_report():
    from wittgenstein_tpu.core.network import Runner as JRunner
    jobs = _jax_obs()
    jp, pp = tp.obs_protocols("PingPong")
    spec = obs.AuditSpec()
    ref = Runner(pp).run_ms(*pp.init(0), 200)
    r1 = Runner(pp, audit=spec)
    out = r1.run_ms(*pp.init(0), 100)
    out = r1.run_ms(*out, 100)                  # chunked: carries stitch
    _same(ref, out, "ON vs OFF")
    report = r1.audit_report()
    assert report.clean, report.format()
    assert r1.audit_stats() == report.stats()
    j1 = JRunner(jp, audit=jobs.AuditSpec())
    jout = j1.run_ms(*jp.init(0), 100)
    j1.run_ms(*jout, 100)
    assert j1.audit_stats() == r1.audit_stats()
    for jac, ac in zip(j1.audit_carries, r1.audit_carries):
        tp.assert_carries_equal(jac, ac)
    with pytest.raises(ValueError, match="run the chunk twice"):
        Runner(pp, metrics=obs.MetricsSpec(), audit=spec)
    r2 = Runner(_bad(pp, 37), audit=spec)
    r2.run_ms(*pp.init(0), 100)
    assert "AUDIT" in r2.audit_report().format()


def test_audit_metrics_cross_check():
    _, pp = tp.obs_protocols("PingPong")
    ms, seeds = 120, 2
    mspec = obs.MetricsSpec(stat_each_ms=10)
    _, _, mc = obs.scan_chunk_metrics(pp, ms, mspec)(
        *tp.port_batch(pp, seeds))
    frame = obs.MetricsFrame.from_carry(mspec, mc)
    report, _ = obs.audit_variant(pp, ms, {"superstep": 1}, obs.AuditSpec(),
                                  seeds=seeds)
    assert obs.cross_check_metrics(report, frame) == []
    broken = dataclasses.replace(report, totals=report.totals + 1)
    assert len(obs.cross_check_metrics(broken, frame)) == 4


def test_audit_spec_validation_and_block():
    jobs = _jax_obs()
    with pytest.raises(ValueError, match="mode"):
        obs.AuditSpec(mode="loud")
    with pytest.raises(ValueError, match="unknown invariants"):
        obs.AuditSpec(invariants=("ring_conservation", "nope"))
    with pytest.raises(ValueError, match="spill_budget"):
        obs.AuditSpec(spill_budget=-1)
    spec = obs.AuditSpec(invariants=("counter_monotone",
                                     "ring_conservation"))
    assert spec.invariants == ("ring_conservation", "counter_monotone")
    assert spec.enabled("ring_conservation")
    assert not spec.enabled("bc_consistency")
    report = obs.AuditReport(spec=spec, counts=np.zeros(8, np.int64),
                             first=None, totals=np.arange(4))
    jreport = jobs.AuditReport(spec=jobs.AuditSpec(
        invariants=spec.invariants), counts=np.zeros(8, np.int64),
        first=None, totals=np.arange(4))
    assert obs.audit_block(report, {"ms": 5}) == \
        jobs.audit_block(jreport, {"ms": 5})
    assert report.format() == jreport.format()
    assert obs.audit.INVARIANTS == jobs.INVARIANTS


def test_audit_jump_is_a_clock_check():
    from wittgenstein_tpu_torch.obs.audit import audit_jump, init_audit
    _, pp = tp.obs_protocols("PingPong")
    spec = obs.AuditSpec()
    ac = init_audit(spec, pp.init(0)[0])
    assert audit_jump(spec, ac, 10, 3) is ac
    bad = audit_jump(spec, ac, 10, -3)
    assert int(bad.counts[obs.audit.INV["clock_monotone"]]) == 1
    assert bad.first.tolist() == [10, obs.audit.INV["clock_monotone"], -1,
                                  -3, 0]
