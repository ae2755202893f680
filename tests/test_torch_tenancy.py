"""Tenancy of the port's request plane: the twins of
tests/test_tenancy.py — admission control with 429/retry-after,
deficit-round-robin fairness, deadlines, chunk-boundary checkpoint
preemption with bit-identical resumption (state AND the stitched obs
artifacts; chaos ON in one case) and the stale-checkpoint refusal —
each sending the same submits through the JAX `Scheduler` and the
port's and comparing with tolerance 0 outside the named wall fields
(`serve_parity`)."""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import serve_parity as sp
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert

CHAOS = {"churn": [[3, 20, 60]], "partitions": [[30, 90, 1, 0, 32]]}


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


def _artifact_blocks(art):
    return {k: art[k] for k in ("engine_metrics", "trace", "audit",
                                "summary") if k in art}


def _drive(k, first, on_boundary=None, **kw):
    """Package k's (0: JAX, 1: the port) scheduler with `first` submitted
    and `on_boundary(sch, submitted)` wired, drained; returns (scheduler,
    rids in submission order)."""
    mod = (sp.jax_serve(), sp.port_serve())[k]
    sch = mod.Scheduler(**kw, **({} if k == 0 else {"device": "cpu"}))
    rids = [sch.submit(sp.specs(d)[k]) for d in first]
    if on_boundary is not None:
        sch.on_boundary = lambda: on_boundary(sch, rids, k)
    sch.run_pending()
    return sch, rids


def _both(first, on_boundary=None, **kw):
    jsch, jr = _drive(0, first, on_boundary, **kw)
    psch, pr = _drive(1, first, on_boundary, **kw)
    sp.assert_schedulers_equal(jsch, psch, jr, pr)
    return psch, pr


def test_tenancy_fields_digest_only():
    """tenant/priority/deadline_ms move the digest, never the compile
    key, in both packages alike."""
    for k in (0, 1):
        a = sp.specs(_spec())[k]
        b = sp.specs(_spec(tenant="interactive", priority=3,
                           deadline_ms=5000))[k]
        assert a.digest() != b.digest()
        assert a.validate().compile_key() == b.validate().compile_key()
    assert sp.specs(_spec(tenant="x", priority=3))[0].digest() == \
        sp.specs(_spec(tenant="x", priority=3))[1].digest()


def test_tenancy_field_refusals():
    ps = sp.port_serve()
    for bad, match in ((dict(tenant=""), "tenant"),
                       (dict(priority="high"), "priority"),
                       (dict(deadline_ms=0), "deadline_ms"),
                       (dict(deadline_ms=2.5), "deadline_ms")):
        with pytest.raises(ValueError, match=match):
            ps.ScenarioSpec(**_spec(**bad))
    with pytest.raises(ValueError, match="weight"):
        ps.TenantPolicy(weight=0)


def test_admission_429_and_recovery():
    """An over-budget tenant is refused with a retry-after remedy (the
    JAX text), other tenants are not, and a post-drain retry lands."""
    tenants = {"camp": {"max_queued": 2, "retry_after_s": 0.5}}
    errs, scheds = [], []
    for k in (0, 1):
        mod = (sp.jax_serve(), sp.port_serve())[k]
        sch = mod.Scheduler(tenants=tenants,
                            **({} if k == 0 else {"device": "cpu"}))
        mk = (lambda **kw: sp.specs(_spec(**kw))[k])
        rids = [sch.submit(mk(tenant="camp", seeds=(0,))),
                sch.submit(mk(tenant="camp", seeds=(1,)))]
        with pytest.raises(mod.AdmissionError, match="retry after") as ei:
            sch.submit(mk(tenant="camp", seeds=(2,)))
        assert ei.value.retry_after_s >= 0.5
        assert ei.value.http_status == 429
        errs.append(str(ei.value))
        rids.append(sch.submit(mk(tenant="other", seeds=(3,))))
        sch.run_pending()
        rids.append(sch.submit(mk(tenant="camp", seeds=(2,))))
        sch.run_pending()
        scheds.append((sch, rids))
    assert errs[0] == errs[1]
    (jsch, jr), (psch, pr) = scheds
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "admission")
    ten = psch.tenancy_stats()
    assert ten["rejected"] == 1 and ten["tenants"]["camp"]["done"] == 3


def test_http_429_round_trip():
    """Over HTTP on the port's server: 429 with Retry-After (header and
    body), a malformed spec still 400, and the queue drains back to
    admitting."""
    from wittgenstein_tpu_torch.server.http import make_server
    ps = sp.port_serve()
    httpd = make_server(port=0, batch_auto=False, scheduler=ps.Scheduler(
        tenants={"default": {"max_queued": 1, "retry_after_s": 0.25}},
        device="cpu"), device="cpu")
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"

    def post(path, body=None):
        req = urllib.request.Request(
            f"{base}{path}", method="POST",
            data=json.dumps(body or {}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    try:
        spec = sp.specs(_spec(seeds=(0,)))[1]
        st, sub = post("/w/batch/submit", spec.to_json())
        assert st == 200 and sub["id"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/w/batch/submit",
                 dataclasses.replace(spec, seeds=(1,)).to_json())
        e = ei.value
        assert e.code == 429
        body = json.loads(e.read())
        assert body["retry_after_s"] >= 0.25
        assert "retry after" in body["error"]
        assert int(e.headers["Retry-After"]) >= 1
        with pytest.raises(urllib.error.HTTPError) as ei400:
            post("/w/batch/submit", {"protocol": "PingPong",
                                     "obs": ["typo_plane"]})
        assert ei400.value.code == 400
        assert post("/w/batch/run")[0] == 200
        st, sub2 = post("/w/batch/submit",
                        dataclasses.replace(spec, seeds=(1,)).to_json())
        assert st == 200, sub2
        post("/w/batch/run")
        with urllib.request.urlopen(f"{base}/w/batch/tenancy",
                                    timeout=10) as resp:
            ten = json.loads(resp.read())
        assert ten["rejected"] == 1
        assert ten["tenants"]["default"]["done"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_drr_fairness_no_starvation():
    """A weight-4 interactive tenant's request finishes before a weight-1
    campaign backlog does, with the JAX package's preemptions and
    artifacts."""
    first = [_spec(tenant="campaign", seeds=(s,)) for s in range(3)] + \
        [_spec(tenant="interactive", seeds=(9,), params={"node_count": 32})]
    psch, pr = _both(first, tenants={"campaign": {"weight": 1},
                                     "interactive": {"weight": 4}},
                     quantum_chunks=1)
    reqs = [psch.request(r) for r in pr]
    assert all(q.status == "done" for q in reqs)
    assert reqs[3].finished < max(q.finished for q in reqs[:3])
    assert psch.resilience["preemptions"] >= 1


def _preemptor(**kw):
    """An on_boundary hook submitting one higher-priority request at the
    first boundary."""
    def hook(sch, rids, k):
        if len(rids) == 1:
            rids.append(sch.submit(sp.specs(_spec(
                params={"node_count": 32}, seeds=(7,), **kw))[k]))
    return hook


def test_priority_preempt_then_resume_bit_identical():
    """A higher-priority submission preempts the running group at the
    next boundary; the preempted request completes equal to an
    uninterrupted run, state and stitched artifacts, and to the JAX
    package's preempted run."""
    ref, rr = _drive(1, [_spec()])
    psch, pr = _both([_spec()], _preemptor(priority=5,
                                           tenant="interactive"))
    rlo, rhi = psch.request(pr[0]), psch.request(pr[1])
    assert rlo.preempted >= 1 and rhi.finished < rlo.finished
    tp.assert_states_equal(convert.to_numpy(*ref.request(rr[0]).final_state),
                           convert.to_numpy(*rlo.final_state), "preempted")
    assert _artifact_blocks(rlo.artifacts) == \
        _artifact_blocks(ref.request(rr[0]).artifacts)


def test_preempt_under_chaos_bit_identical():
    """The same with a fault schedule (churn + mid-run partition) and
    the audit plane: state and audit artifacts identical and clean."""
    spec = _spec(obs=("metrics", "audit"), fault_schedule=CHAOS)
    ref, rr = _drive(1, [spec])
    assert ref.request(rr[0]).artifacts["audit"]["clean"]
    psch, pr = _both([spec], _preemptor(priority=5))
    req = psch.request(pr[0])
    assert req.preempted >= 1
    assert _artifact_blocks(req.artifacts) == \
        _artifact_blocks(ref.request(rr[0]).artifacts)


def test_deadline_demotes_never_kills():
    """A request past its deadline yields to waiting work at a boundary
    but still completes, equal to the JAX package's run."""
    def hook(sch, rids, k):
        if len(rids) == 1:
            time.sleep(0.01)
            rids.append(sch.submit(sp.specs(_spec(
                params={"node_count": 32}, seeds=(7,),
                tenant="other"))[k]))

    psch, pr = _both([_spec(deadline_ms=1)], hook)
    rd, ro = psch.request(pr[0]), psch.request(pr[1])
    assert rd.preempted >= 1 and rd.artifacts["deadline_missed"] is True
    assert ro.finished < rd.finished


def test_preempted_request_coalesces_on_return():
    """A preempted vmapped request re-enters the SAME program: two
    registry entries in all, as in the JAX package."""
    psch, pr = _both([_spec()], _preemptor(priority=9))
    assert psch.request(pr[0]).preempted >= 1
    assert psch.registry.stats()["entries"] == 2


def test_stale_checkpoint_spec_digest_refused(tmp_path):
    """A group checkpoint whose stored spec was edited after it was
    written is refused with remedy text, an older schema too, and a
    garbage file is skipped — on a checkpoint the port wrote."""
    from wittgenstein_tpu_torch.utils import checkpoint as ckpt
    ps = sp.port_serve()
    ck = str(tmp_path / "ck")
    calls = {"n": 0}

    def killer(fn, *a):
        calls["n"] += 1
        if calls["n"] > 1:          # chunk 1 lands (one pass), 2 dies
            raise RuntimeError("KILLED")
        return fn(*a)

    crashed = ps.Scheduler(launcher=killer, retry_backoff_s=0.0,
                           max_retries=0, checkpoint_dir=ck, device="cpu")
    crashed.submit(sp.specs(_spec(obs=("metrics", "audit")))[1])
    crashed.run_pending()
    files = os.listdir(ck)
    assert len(files) == 1
    path = os.path.join(ck, files[0])
    meta = ckpt.peek_meta(path)
    assert meta["schema"] == 2 and meta["requests"][0]["spec_digest"]
    assert ckpt.stale_meta_problems(meta) == []
    meta["requests"][0]["spec"]["sim_ms"] = 240
    assert ckpt.stale_meta_problems(meta)
    z = dict(np.load(path))
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **z)
    with pytest.raises(ps.StaleCheckpointError, match="edited"):
        ps.Scheduler(checkpoint_dir=ck, device="cpu").resume_checkpoints()
    meta["schema"] = 1
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **z)
    with pytest.raises(ps.StaleCheckpointError, match="schema"):
        ps.Scheduler(checkpoint_dir=ck, device="cpu").resume_checkpoints()
    with open(path, "wb") as f:
        f.write(b"not an npz at all")
    assert ps.Scheduler(checkpoint_dir=ck,
                        device="cpu").resume_checkpoints() == []
