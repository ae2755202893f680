"""Resilience of the port's request plane: the twins of
tests/test_serve_resilience.py (retry with backoff, width degradation,
checkpoint/resume, poison-lane quarantine, the watchdog, stream
termination, chaos specs through the service), each driven by the same
fault-injected launcher (the `Scheduler(launcher=)` seam) in the JAX
package and the port and compared with tolerance 0; and the tests of
the port's own launch design:

  * a launcher that runs the chunk to its end and then raises (the
    ring already advanced): the retry, the width halving and the
    poison-lane bisection still give states bit-identical to an
    uninterrupted run, because every retryable launch runs on its own
    copy of the in-place leaves;
  * a watchdog-abandoned launch stops at its next window's entry and
    writes nothing after it is abandoned, and the group's state after
    the retry equals an uninterrupted run's.
"""

import dataclasses
import os
import threading
import time

import pytest
import serve_parity as sp
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(**kw):
    base = dict(protocol="PingPong", params={"node_count": 64},
                seeds=(0, 1), sim_ms=120, chunk_ms=40, obs=("metrics",))
    base.update(kw)
    return base


def _np(state):
    return convert.to_numpy(*state)


@pytest.fixture(scope="module")
def reference():
    """One uninterrupted run of the canonical spec in the port (held to
    the JAX package's run of it): the bit-identity reference."""
    jsch, psch = sp.pair()
    a = jsch.submit(sp.specs(_spec())[0])
    b = psch.submit(sp.specs(_spec())[1])
    jsch.run_pending()
    psch.run_pending()
    sp.assert_requests_equal(jsch.request(a), psch.request(b), "reference")
    return psch.request(b).final_state


def _both(launcher_factory, spec_dicts, **kw):
    """The same submits and launcher in both packages, drained."""
    jsch, psch = sp.pair(jax_kw={"launcher": launcher_factory()},
                         port_kw={"launcher": launcher_factory()}, **kw)
    jr, pr = [], []
    for d in spec_dicts:
        js, ps = sp.specs(d)
        jr.append(jsch.submit(js))
        pr.append(psch.submit(ps))
    jsch.run_pending()
    psch.run_pending()
    sp.assert_schedulers_equal(jsch, psch, jr, pr)
    return jsch, psch, jr, pr


def test_retry_with_backoff(reference):
    def factory():
        calls = {"n": 0}

        def flaky(fn, *args):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("injected launch failure")
            return fn(*args)
        return flaky

    _, psch, _, pr = _both(factory, [_spec()], retry_backoff_s=0.0)
    req = psch.request(pr[0])
    assert req.status == "done", req.error
    assert psch.resilience["retries"] == 2
    tp.assert_states_equal(_np(reference), _np(req.final_state), "retry")


def test_retries_exhausted_fails_group():
    def factory():
        def dead(fn, *args):
            raise RuntimeError("device gone")
        return dead

    _, psch, _, pr = _both(factory, [_spec()], retry_backoff_s=0.0,
                           max_retries=1)
    req = psch.request(pr[0])
    assert req.status == "error" and "device gone" in req.error


def test_width_degradation(reference):
    """A launcher that faults at full width: the lane batch is halved
    and the halves run one after the other; per-lane results equal the
    full-width run's."""
    def factory():
        def narrow(fn, *args):
            if int(args[0].time.shape[0]) > 1:
                raise RuntimeError("injected OOM at full width")
            return fn(*args)
        return narrow

    _, psch, _, pr = _both(factory, [_spec(seeds=(0,)), _spec(seeds=(1,))],
                           retry_backoff_s=0.0, max_retries=0)
    assert psch.resilience["demotions"] > 0
    ref = _np(reference)
    for r, rid in enumerate(pr):
        got = _np(psch.request(rid).final_state)
        tp.assert_states_equal(
            tuple(tp.seed_state(x, slice(r, r + 1)) for x in ref), got,
            f"lane {r}")


def test_checkpoint_resume_bit_identical(reference, tmp_path):
    """Killed after one chunk, resumed from the checkpoint in a FRESH
    scheduler: equal to the uninterrupted run, with the resume point in
    the artifacts and the ledger row, in both packages."""
    out = []
    for k in (0, 1):
        mod = (sp.jax_serve(), sp.port_serve())[k]
        dev = {} if k == 0 else {"device": "cpu"}
        ck = str(tmp_path / f"ck{k}")
        state = {"n": 0}

        def killer(fn, *args, state=state):
            if state["n"] >= 1:
                raise RuntimeError("KILLED")
            state["n"] += 1
            return fn(*args)

        crashed = mod.Scheduler(launcher=killer, retry_backoff_s=0.0,
                                max_retries=0, checkpoint_dir=ck, **dev)
        rid = crashed.submit(sp.specs(_spec())[k])
        crashed.run_pending()
        assert crashed.request(rid).status == "error"
        key = crashed.request(rid).compile_key
        assert os.path.exists(os.path.join(ck, f"group-{key[:16]}.npz"))
        fresh = mod.Scheduler(checkpoint_dir=ck, ledger_path=str(
            tmp_path / f"led{k}.jsonl"), **dev)
        rids = fresh.resume_checkpoints()
        fresh.run_pending()
        req = fresh.request(rids[0])
        assert req.status == "done", req.error
        assert req.resumed_from_ms == req.artifacts["resumed_from_ms"] == 40
        assert not os.listdir(ck)
        out.append((fresh, rids))
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "resumed")
    tp.assert_states_equal(_np(reference),
                           _np(psch.request(pr[0]).final_state), "resumed")
    assert sp.manifest_rows(tmp_path / "led0.jsonl") == \
        sp.manifest_rows(tmp_path / "led1.jsonl")


def test_submit_never_overwrites_restored_ids():
    from wittgenstein_tpu_torch.serve.scheduler import Request
    sched = sp.port_serve().Scheduler(device="cpu")
    restored = sp.specs(_spec())[1].validate()
    with sched._mu:
        sched._requests["r0001"] = Request(
            id="r0001", spec=restored, compile_key=restored.compile_key())
    assert sched.submit(sp.specs(_spec(seeds=(5, 6)))[1]) == "r0002"
    assert sched.request("r0001").spec is restored


def test_resume_empty_dir_is_noop(tmp_path):
    ps = sp.port_serve()
    assert ps.Scheduler(checkpoint_dir=str(tmp_path / "none"),
                        device="cpu").resume_checkpoints() == []
    assert ps.Scheduler(device="cpu").resume_checkpoints() == []


# --------------------------------------------------- crash-only launches


def _poison_launcher(after=False):
    """Fails every launch whose batch holds the lane with node 5 down
    (partition=(5,) is data: same compile key as its neighbors); with
    `after`, the launch first runs to its end (the ring advanced)."""
    def poison(fn, *args):
        bad = bool(args[0].nodes.down[..., 5].any())
        if bad and after:
            fn(*args)
        if bad:
            raise RuntimeError("poison lane fault")
        return fn(*args)
    return poison


def _jax_poison():
    import jax
    import numpy as np

    def poison(fn, *args):
        if np.asarray(jax.device_get(args[0].nodes.down))[..., 5].any():
            raise RuntimeError("poison lane fault")
        return fn(*args)
    return poison


def test_poison_lane_quarantine_isolates_one_request(tmp_path):
    """A 4-lane coalesced group with one planted poison lane fails ONLY
    that request (quarantined artifact, ledger row, tenant stat); the
    3 neighbors equal their solo runs — and everything equals the JAX
    package's."""
    spec = _spec(obs=("metrics", "audit"))
    ds = [dict(spec, seeds=(0,)), dict(spec, seeds=(1,)),
          dict(spec, seeds=(2,), partition=(5,)), dict(spec, seeds=(3,))]
    jsch, psch = sp.pair(jax_kw={"launcher": _jax_poison(),
                                 "ledger_path": str(tmp_path / "j.jsonl")},
                         port_kw={"launcher": _poison_launcher(),
                                  "ledger_path": str(tmp_path / "p.jsonl")},
                         retry_backoff_s=0.0, max_retries=0)
    jr = [jsch.submit(sp.specs(d)[0]) for d in ds]
    pr = [psch.submit(sp.specs(d)[1]) for d in ds]
    jsch.run_pending()
    psch.run_pending()
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "quarantine")
    assert sp.manifest_rows(tmp_path / "j.jsonl") == \
        sp.manifest_rows(tmp_path / "p.jsonl")
    bad = psch.request(pr[2])
    assert bad.status == "error" and bad.artifacts["quarantined"] is True
    assert psch.tenancy_stats()["tenants"]["default"]["quarantined"] == 1
    for i in (0, 1, 3):
        solo = sp.port_serve().Scheduler(registry=psch.registry,
                                         device="cpu")
        rid = solo.submit(sp.specs(ds[i])[1])
        solo.run_pending()
        tp.assert_states_equal(_np(solo.request(rid).final_state),
                               _np(psch.request(pr[i]).final_state),
                               f"neighbor {i}")


def test_failure_after_a_full_chunk_retries_from_the_boundary(reference):
    """THE port's launch design: a launcher that runs the chunk to its
    end (the ring advanced in place) and THEN raises.  A retry, a width
    halving and a poison-lane bisection each start again from the true
    chunk-boundary state, so every lane equals the uninterrupted run."""
    ps = sp.port_serve()
    ref = _np(reference)
    # retry: the first launch of every chunk runs and then fails
    seen = set()

    def late_fail(fn, *args):
        out = fn(*args)
        key = args[2]
        if key not in seen:
            seen.add(key)
            raise RuntimeError("failed after the chunk ran")
        return out

    sch = ps.Scheduler(launcher=late_fail, retry_backoff_s=0.0,
                       device="cpu")
    rid = sch.submit(sp.specs(_spec())[1])
    sch.run_pending()
    assert sch.resilience["retries"] == 3
    tp.assert_states_equal(ref, _np(sch.request(rid).final_state), "retry")

    # halving: at full width the chunk runs, then the launch fails
    def late_narrow(fn, *args):
        out = fn(*args)
        if int(args[0].time.shape[0]) > 1:
            raise RuntimeError("failed at full width after running")
        return out

    sch = ps.Scheduler(launcher=late_narrow, retry_backoff_s=0.0,
                       max_retries=0, device="cpu")
    rids = [sch.submit(sp.specs(_spec(seeds=(s,)))[1]) for s in (0, 1)]
    sch.run_pending()
    assert sch.resilience["demotions"] == 3
    for r, rid in enumerate(rids):
        tp.assert_states_equal(
            tuple(tp.seed_state(x, slice(r, r + 1)) for x in ref),
            _np(sch.request(rid).final_state), f"halved lane {r}")

    # bisection: the poison lane's launches run, then fail
    sch = ps.Scheduler(launcher=_poison_launcher(after=True),
                       retry_backoff_s=0.0, max_retries=1, device="cpu")
    rids = [sch.submit(sp.specs(_spec(seeds=(s,)))[1]) for s in (0, 1)]
    bad = sch.submit(sp.specs(_spec(seeds=(2,), partition=(5,)))[1])
    sch.run_pending()
    assert sch.request(bad).artifacts["quarantined"] is True
    for r, rid in enumerate(rids):
        tp.assert_states_equal(
            tuple(tp.seed_state(x, slice(r, r + 1)) for x in ref),
            _np(sch.request(rid).final_state), f"bisected lane {r}")


def test_watchdog_abandons_hung_launch(reference):
    """A launch that hangs past its deadline is abandoned (the JAX twin's
    counts); the abandoned launch, released later, stops at its first
    window's entry (`LaunchAbandoned`) and leaves the state it was
    handed as it was; the retry completes the group bit-identically and
    the drain never waited on the hang."""
    from wittgenstein_tpu_torch.serve.registry import LaunchAbandoned
    ps = sp.port_serve()
    reg = ps.CompileRegistry(device="cpu")
    warm = ps.Scheduler(registry=reg, device="cpu")
    warm.submit(sp.specs(_spec())[1])
    warm.run_pending()
    release = threading.Event()
    seen = {}

    def hung(fn, *args):
        if "first" not in seen:
            seen["first"] = True
            before = [t.clone() for t in tp.pytree_leaves(args[:2])]
            release.wait(30)
            try:
                fn(*args)
            except LaunchAbandoned:
                seen["abandoned"] = True
            after = tp.pytree_leaves(args[:2])
            seen["unchanged"] = all(torch.equal(a, b)
                                    for a, b in zip(before, after))
            seen["done"] = True
            raise RuntimeError("abandoned launch returned")
        return fn(*args)

    sch = ps.Scheduler(registry=reg, launcher=hung, retry_backoff_s=0.0,
                       max_retries=1, watchdog_factor=8.0,
                       watchdog_floor_s=2.0, device="cpu")
    rid = sch.submit(sp.specs(_spec())[1])
    t0 = time.perf_counter()
    sch.run_pending()
    elapsed = time.perf_counter() - t0
    req = sch.request(rid)
    assert req.status == "done", req.error
    assert sch.resilience["watchdog_trips"] == 1
    assert sch.resilience["retries"] == 1
    assert elapsed < 25, elapsed
    release.set()
    for _ in range(300):
        if seen.get("done"):
            break
        time.sleep(0.1)
    assert seen.get("abandoned") and seen.get("unchanged"), seen
    tp.assert_states_equal(_np(reference), _np(req.final_state), "watchdog")
    health = sch.health_stats()
    assert health["watchdog_trips"] == 1
    assert health["watchdog_deadline_s"] is not None
    # the JAX twin: its first launch sleeps past the same deadline on a
    # warm registry; the retried group's artifacts equal the port's
    js = sp.jax_serve()
    jreg = js.CompileRegistry()
    warm = js.Scheduler(registry=jreg)
    warm.submit(sp.specs(_spec())[0])
    warm.run_pending()
    jcalls = {"n": 0}

    def sleepy(fn, *args):
        jcalls["n"] += 1
        if jcalls["n"] == 1:
            time.sleep(5)
        return fn(*args)

    jsch = js.Scheduler(registry=jreg, launcher=sleepy, retry_backoff_s=0.0,
                        max_retries=1, watchdog_factor=8.0,
                        watchdog_floor_s=2.0)
    jrid = jsch.submit(sp.specs(_spec())[0])
    jsch.run_pending()
    sp.assert_requests_equal(jsch.request(jrid), req, "watchdog")
    assert jsch.resilience == sch.resilience


def test_stream_terminates_on_error_and_quarantine():
    """A long-poll on a request that fails (or is quarantined) returns a
    final error record promptly, as in the JAX package."""
    ps = sp.port_serve()

    def dead(fn, *args):
        raise RuntimeError("device gone")

    sched = ps.Scheduler(launcher=dead, retry_backoff_s=0.0, max_retries=0,
                         device="cpu")
    rid = sched.submit(sp.specs(_spec())[1])
    out: dict = {}
    th = threading.Thread(target=lambda: out.update(
        sched.stream_chunks(rid, timeout_s=30.0)))
    th.start()
    time.sleep(0.1)
    sched.run_pending()
    th.join(timeout=10)
    assert not th.is_alive()
    assert out["status"] == "error" and out["eof"]
    assert "device gone" in out["error"]

    sched2 = ps.Scheduler(launcher=_poison_launcher(), retry_backoff_s=0.0,
                          max_retries=0, device="cpu")
    ok_rid = sched2.submit(sp.specs(_spec(seeds=(0,)))[1])
    poison_rid = sched2.submit(sp.specs(_spec(seeds=(2,),
                                              partition=(5,)))[1])
    out2: dict = {}
    th2 = threading.Thread(target=lambda: out2.update(
        sched2.stream_chunks(poison_rid, timeout_s=30.0)))
    th2.start()
    time.sleep(0.1)
    sched2.run_pending()
    th2.join(timeout=10)
    assert not th2.is_alive()
    assert out2["eof"] and out2.get("quarantined") is True
    assert sched2.request(ok_rid).status == "done"


def test_chaos_spec_through_service(tmp_path):
    """A fault_schedule spec rides the request plane (coalesced by its
    compile key, audited clean under churn and partition), and a planted
    counter attack is still flagged: payloads equal the JAX service's."""
    fs = {"churn": [[3, 20, 60]], "partitions": [[30, 90, 1, 0, 32]]}
    spec = _spec(obs=("metrics", "audit"), fault_schedule=fs)
    atk = {"at_ms": 37, "leaf": "nodes.msg_sent", "node": 5,
           "delta": -(1 << 20)}
    bodies = [spec, dict(spec, seeds=(2, 3)), _spec(obs=("metrics",
                                                         "audit")),
              dict(spec, seeds=(9,), attack=atk)]
    results = []
    for k in (0, 1):
        mod = (sp.jax_serve(), sp.port_serve())[k]
        dev = {} if k == 0 else {"device": "cpu"}
        svc = mod.Service(scheduler=mod.Scheduler(
            ledger_path=str(tmp_path / f"l{k}.jsonl"), **dev), auto=False)
        subs = [svc.submit(sp.specs(b)[k].to_json()) for b in bodies]
        svc.run_pending()
        results.append([sp.clean_artifacts(svc.result(s["id"]))
                        for s in subs])
        if k:
            assert subs[0]["compile_key"] == subs[1]["compile_key"] != \
                subs[2]["compile_key"]
            with pytest.raises(ValueError, match="ONE partition at a time"):
                svc.submit(sp.specs(_spec(fault_schedule={
                    "partitions": [[10, 50, 1, 0, 32],
                                   [20, 60, 2, 16, 48]]}))[1].to_json())
    assert results[0] == results[1]
    ra, rc = results[1][0], results[1][3]
    assert ra["audit"]["clean"] and ra["spec"]["fault_schedule"] == fs
    assert not rc["audit"]["clean"]
    assert rc["audit"]["first"]["invariant"] == "counter_monotone"
    assert rc["audit"]["first"]["ms"] == 37


def test_dataclass_replace_keeps_spec_digest():
    """`dataclasses.replace` on a port spec gives the JAX spec's digest
    (the tests above build specs either way)."""
    js, ps = sp.specs(_spec())
    assert dataclasses.replace(js, seeds=(4,)).digest() == \
        dataclasses.replace(ps, seeds=(4,)).digest()
