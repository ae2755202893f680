"""The port's request plane (`wittgenstein_tpu_torch/serve`), held to the
JAX package's: the twins of tests/test_serve.py, each sending the same
specs through the JAX `Scheduler`/`Service` and the port's (on the CPU)
and comparing with tolerance 0 — final states leaf for leaf, the
artifacts, ledger rows, registry blocks and exposition text outside the
wall and platform fields `serve_parity` names.

The port's own design for the obs planes (every plane of a request in
one engine pass, where the JAX scheduler runs shadow passes) is held
here too: the raw per-chunk metrics, trace and audit carries equal the
JAX primary and shadow passes' carries.  The JAX tests' slow marks carry
over; the `cuda`-marked twin of the chip smoke's served headline runs
the coalescing check on the card at 64 nodes.

JAX is imported inside the tests that compare with it, so the `cuda`
test also runs where JAX is not installed."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

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
                seeds=(0,), sim_ms=240, chunk_ms=120,
                obs=("metrics", "audit"))
    base.update(kw)
    return base


def _run_both(tmp_path, spec_dicts, **kw):
    """Submit `spec_dicts` in order to a JAX and a port scheduler, drain
    both; returns (jax scheduler, port scheduler, jax rids, port rids)."""
    jsch, psch = sp.pair(jax_kw={"ledger_path": str(tmp_path / "j.jsonl")},
                         port_kw={"ledger_path": str(tmp_path / "p.jsonl")},
                         **kw)
    jr, pr = [], []
    for d in spec_dicts:
        js, ps = sp.specs(d)
        jr.append(jsch.submit(js))
        pr.append(psch.submit(ps))
    assert jr == pr
    jsch.run_pending()
    psch.run_pending()
    return jsch, psch, jr, pr


# ------------------------------------------------------------- registry


def test_registry_repeat_spec_is_warm_hit():
    """A repeated spec maps to the SAME program object (a hit), a
    data-only difference too, a program difference to another one; the
    counts equal the JAX registry's for the same lookups."""
    from wittgenstein_tpu_torch.serve import CompileRegistry
    jreg = sp.jax_serve().CompileRegistry(persistent=False)
    reg = CompileRegistry(persistent=False, device="cpu")
    for r, specs in ((jreg, 0), (reg, 1)):
        mk = (lambda **k: sp.specs(_spec(**k))[specs].validate())
        f1 = r.chunk_fn(mk(), "metrics")
        assert r.chunk_fn(mk(), "metrics") is f1
        assert r.chunk_fn(mk(seeds=(5, 6)), "metrics") is f1
        assert r.chunk_fn(mk(chunk_ms=60), "metrics") is not f1
    assert sp.clean_registry(jreg.stats()) == sp.clean_registry(
        reg.stats()) == {"entries": 2, "hits": 2, "misses": 2}


def test_registry_refuses_unresolved_spec():
    from wittgenstein_tpu_torch.serve import CompileRegistry
    with pytest.raises(ValueError, match="resolved"):
        CompileRegistry().chunk_fn(sp.specs(_spec(superstep="auto"))[1])


# --------------------------------------------- coalescing bit-identity


def test_coalesced_requests_equal_jax_and_sequential(tmp_path):
    """THE acceptance pin, twice: 3 coalesced requests (one compile key,
    seeds 0-2, metrics and audit ON) equal the JAX scheduler's — final
    states, artifacts, ledger rows, registry, resilience and exposition
    — and each equals a sequential single-seed `Runner` run of the
    port, chunked as the scheduler chunks."""
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.obs import AuditSpec, MetricsSpec
    jsch, psch, jr, pr = _run_both(
        tmp_path, [_spec(seeds=(s,)) for s in (0, 1, 2)])
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "coalesced")
    assert sp.manifest_rows(tmp_path / "j.jsonl") == \
        sp.manifest_rows(tmp_path / "p.jsonl")
    for rid, seed in zip(pr, (0, 1, 2)):
        req = psch.request(rid)
        assert req.status == "done", req.error
        spec = req.spec
        proto = spec.build_protocol(device="cpu")
        runner = Runner(proto, metrics=MetricsSpec(
            stat_each_ms=spec.stat_each_ms))
        auditor = Runner(proto, audit=AuditSpec())
        state = proto.init(seed)
        astate = tp.clone(state)
        for _ in range(spec.sim_ms // spec.chunk_ms):
            state = runner.run_ms(*state, spec.chunk_ms)
            astate = auditor.run_ms(*astate, spec.chunk_ms)
        lane = convert.to_numpy(*tp.clone(req.final_state))
        tp.assert_states_equal(
            tuple(tp.seed_state(x, 0) for x in lane),
            convert.to_numpy(*state), f"seed {seed}")
        blk = req.artifacts["engine_metrics"]
        assert blk["totals"] == runner.metrics_frame().totals()
        assert req.artifacts["audit"]["totals"] == \
            auditor.audit_report().totals_dict()


def test_planes_in_one_pass_equal_jax_shadow_passes(tmp_path):
    """The port's one-pass design: a request with the metrics, trace and
    audit planes keeps per-chunk carries equal to the JAX scheduler's
    primary (metrics) and shadow (trace, audit) passes, chunk by chunk,
    on the dense and the fast-forward engine."""
    for engine in ("vmapped", "fast_forward"):
        d = _spec(seeds=(0, 1), sim_ms=80, chunk_ms=40, engine=engine,
                  obs=("metrics", "trace", "audit"), trace_capacity=2048)
        jsch, psch = sp.pair()
        js, ps = sp.specs(d)
        a = jsch.submit(js, keep_carries=True)
        b = psch.submit(ps, keep_carries=True)
        jsch.run_pending()
        psch.run_pending()
        sp.assert_requests_equal(jsch.request(a), psch.request(b), engine)
        sp.assert_carries_equal(jsch.request(a), psch.request(b), engine)


def test_continuous_batching_late_join(tmp_path):
    """A compatible request submitted while the group is in flight joins
    at the next chunk boundary (a batch of runs at two clocks), in both
    packages, with equal results; and the joiner equals a solo run."""
    out = []
    for pkg in ("jax", "port"):
        sch = sp.pair()[0 if pkg == "jax" else 1]
        mk = sp.specs
        a = sch.submit(mk(_spec(seeds=(0,), sim_ms=360))[
            0 if pkg == "jax" else 1])
        late = {}

        def join_once(sch=sch, late=late, pkg=pkg):
            if not late:
                late["id"] = sch.submit(mk(_spec(seeds=(9,)))[
                    0 if pkg == "jax" else 1])

        sch.on_boundary = join_once
        assert sch.run_pending()["processed"] == 2
        ra, rb = sch.request(a), sch.request(late["id"])
        assert ra.status == rb.status == "done"
        assert rb.started <= ra.finished
        out.append((sch, [a, late["id"]]))
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "late join")
    solo = sp.port_serve().Scheduler(registry=psch.registry, device="cpu")
    rid = solo.submit(sp.specs(_spec(seeds=(9,)))[1])
    solo.run_pending()
    tp.assert_states_equal(convert.to_numpy(*psch.request(pr[1])
                                            .final_state),
                           convert.to_numpy(*solo.request(rid)
                                            .final_state), "joiner")
    assert psch.request(pr[1]).artifacts["audit"] == \
        solo.request(rid).artifacts["audit"]


def test_partition_and_attack_requests(tmp_path):
    """Partition is data (same compile key), an attack is program (the
    audit plane flags the planted perturbation) — equal to the JAX
    package's in both."""
    atk = {"at_ms": 37, "leaf": "nodes.msg_sent", "node": 5,
           "delta": -(1 << 20)}
    jsch, psch, jr, pr = _run_both(
        tmp_path, [_spec(), _spec(partition=(3, 5)), _spec(attack=atk)])
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "partition/attack")
    rp, ra = psch.request(pr[1]), psch.request(pr[2])
    assert rp.compile_key == psch.request(pr[0]).compile_key
    assert ra.compile_key != rp.compile_key
    assert rp.final_state[0].nodes.down[:, [3, 5]].all()
    assert rp.artifacts["summary"]["live_count"] == 62
    assert ra.artifacts["audit"]["first"]["invariant"] == \
        "counter_monotone"


def test_done_request_eviction(tmp_path):
    """Beyond `keep_done` the oldest finished records are evicted; the
    ledger rows stay."""
    from wittgenstein_tpu_torch.obs import ledger
    jsch, psch, jr, pr = _run_both(
        tmp_path, [_spec(seeds=(0,), obs=("metrics",)),
                   _spec(seeds=(1,), obs=("metrics",))], keep_done=1)
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "eviction")
    with pytest.raises(KeyError):
        psch.request(pr[0])
    assert len(ledger.read_all(str(tmp_path / "p.jsonl"))) == 2


def test_freeze_lanes_equal_jax(tmp_path):
    """Fixed-point lane freezing (`Scheduler(freeze=True)`): lanes the
    oracle proves quiet are sliced out at a boundary and their tails
    synthesized — states, artifacts (the ``memo`` block), streamed
    boundaries and memo stats equal the JAX scheduler's, and the frozen
    lanes equal their unfrozen runs."""
    d = dict(protocol="PingPong", params={"node_count": 64},
             latency_model="NetworkFixedLatency(10)", sim_ms=240,
             chunk_ms=40, obs=("metrics", "audit", "trace"),
             trace_capacity=1024)
    ds = [dict(d, seeds=(0, 1)), dict(d, seeds=(2,))]
    jsch, psch, jr, pr = _run_both(tmp_path, ds, freeze=True)
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "freeze")
    assert psch.memo_stats()["frozen_lanes"] >= 1
    for a, b in zip(jr, pr):
        assert jsch.request(a).chunk_totals == psch.request(b).chunk_totals
    plain = sp.port_serve().Scheduler(device="cpu", freeze=False)
    rids = [plain.submit(sp.specs(x)[1]) for x in ds]
    plain.run_pending()
    for rid, b in zip(rids, pr):
        tp.assert_states_equal(
            convert.to_numpy(*plain.request(rid).final_state),
            convert.to_numpy(*psch.request(b).final_state), "frozen")


# -------------------------------------------------------------- service


def test_service_in_process_manual_drain(tmp_path):
    """Service payloads (submit, status, result, registry) equal the JAX
    service's; a warm resubmit adds no registry entry."""
    js, ps = sp.jax_serve(), sp.port_serve()
    jsvc = js.Service(scheduler=js.Scheduler(
        ledger_path=str(tmp_path / "j.jsonl")), auto=False)
    psvc = ps.Service(scheduler=ps.Scheduler(
        ledger_path=str(tmp_path / "p.jsonl"), device="cpu"), auto=False)
    body = sp.specs(_spec(seeds=(0, 1)))[0].to_json()
    subs = [svc.submit(body) for svc in (jsvc, psvc)]
    assert subs[0] == subs[1]
    assert jsvc.status(subs[0]["id"]) == psvc.status(subs[1]["id"])
    assert psvc.result(subs[1]["id"])["status"] == "queued"
    for svc in (jsvc, psvc):
        svc.run_pending()
    res = [sp.clean_artifacts(svc.result(s["id"]))
           for svc, s in zip((jsvc, psvc), subs)]
    assert res[0] == res[1]
    assert res[1]["engine_metrics"]["intervals"] == 24
    entries = psvc.registry_stats()["entries"]
    sub2 = psvc.submit(sp.specs(_spec(seeds=(7,)))[1].to_json())
    psvc.run_pending()
    assert sub2["compile_key"] == subs[1]["compile_key"]
    assert psvc.registry_stats()["entries"] == entries
    assert psvc.programs() == jsvc.programs()
    assert psvc.memo_stats() == jsvc.memo_stats()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_batch_round_trip():
    """/w/batch/* over HTTP on the port's server: submit -> run ->
    status -> result -> stream, the result equal to the JAX service's
    in-process result for the same spec; a bad spec 400s with remedy
    text, malformed JSON 400s, an unknown init kwarg 400s with the
    template, and a malformed grid on /w/matrix/submit 400s with the
    JAX service's message.  Every request is bounded (60 s)."""
    from wittgenstein_tpu_torch.server.http import make_server
    httpd = make_server(0, batch_auto=False, device="cpu")
    httpd.batch_service.scheduler.ledger_path = "/dev/null"
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        spec = sp.specs(_spec(params={"node_count": 32}, sim_ms=120,
                              chunk_ms=60, obs=("metrics",)))[1]
        sub = _post(port, "/w/batch/submit", spec.to_json())
        assert sub["status"] == "queued"
        _post(port, "/w/batch/run")
        st = _get(port, f"/w/batch/status/{sub['id']}")
        assert st["status"] == "done" and st["progress"]["done_count"] > 0
        res = _get(port, f"/w/batch/result/{sub['id']}")
        stream = _get(port, f"/w/batch/stream/{sub['id']}?after=-1")
        assert [c["t_ms"] for c in stream["chunks"]] == [60, 120]
        js = sp.jax_serve()
        jsvc = js.Service(scheduler=js.Scheduler(ledger_path="/dev/null"),
                          auto=False)
        jsub = jsvc.submit(spec.to_json())
        jsvc.run_pending()
        jres = jsvc.result(jsub["id"])
        assert sp.clean_artifacts(res) == sp.clean_artifacts(jres)
        assert _get(port, f"/w/batch/stream/{sub['id']}?after=-1") == \
            jsvc.stream(jsub["id"], after_ms=-1)
        assert sp.clean_registry(_get(port, "/w/batch/registry")) == \
            sp.clean_registry(jsvc.registry_stats())
        bad = dict(spec.to_json(), sim_ms=250)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/w/batch/submit", bad)
        assert ei.value.code == 400
        assert "multiple of chunk_ms" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/w/batch/status/nope")
        assert ei.value.code == 400
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/w/batch/submit",
            data=b'{"protocol":"PingPong",',
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400
        assert "malformed JSON" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/w/network/init/PingPong",
                  {"node_count": 32, "bogus": 1})
        assert ei.value.code == 400
        err = json.loads(ei.value.read())["error"]
        assert "bogus" in err and "node_count" in err
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/w/matrix/submit", {})
        assert ei.value.code == 400
        with pytest.raises(ValueError) as jerr:
            jsvc.matrix_submit({})
        assert json.loads(ei.value.read())["error"] == str(jerr.value)
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/w/batch/metrics",
            timeout=60).read().decode()
        assert sp.exposition_lines(metrics) == \
            sp.exposition_lines(jsvc.metrics())
        health = _get(port, "/w/batch/health")
        assert health["resilience"] == jsvc.health()["resilience"]
    finally:
        httpd.batch_service.close()
        httpd.shutdown()
        httpd.server_close()


def test_service_auto_worker_drains():
    """The background worker drains a submit without an explicit run."""
    svc = sp.port_serve().Service(auto=True, device="cpu")
    svc.scheduler.ledger_path = "/dev/null"
    try:
        sub = svc.submit(sp.specs(_spec(params={"node_count": 32},
                                        sim_ms=120, chunk_ms=120,
                                        obs=("metrics",)))[1].to_json())
        deadline = time.time() + 120
        while time.time() < deadline:
            if svc.status(sub["id"])["status"] in ("done", "error"):
                break
            time.sleep(0.2)
        assert svc.status(sub["id"])["status"] == "done"
    finally:
        svc.close()


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """`Scheduler`, `Service`, `Server` and `make_server` default to
    ``cuda`` and raise without one — never a CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from wittgenstein_tpu_torch.server.core import Server
    from wittgenstein_tpu_torch.server.http import make_server
    ps = sp.port_serve()
    for build in (ps.Scheduler, ps.Service, Server,
                  lambda: make_server(0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


# ------------------------------------------------ engine variants (slow)


@pytest.mark.slow
def test_serve_fast_forward_and_batched_variants(tmp_path):
    """engine='fast_forward' and engine='batched' (seed-folded Handel)
    through the request plane equal the JAX package's, and each equals
    the dense vmapped engine of the port."""
    handel = dict(node_count=64, threshold=56, nodes_down=6,
                  pairing_time=4, dissemination_period_ms=20,
                  level_wait_time=50, fast_path=10)
    ds = [_spec(seeds=(0, 1)),
          _spec(seeds=(0, 1), engine="fast_forward"),
          dict(protocol="Handel", params=handel, seeds=(0, 1), sim_ms=80,
               chunk_ms=80, engine="vmapped", superstep=2,
               obs=("metrics", "audit"), stat_each_ms=20),
          dict(protocol="Handel", params=handel, seeds=(0, 1), sim_ms=80,
               chunk_ms=80, engine="batched", superstep=2,
               obs=("metrics", "audit"), stat_each_ms=20)]
    jsch, psch, jr, pr = _run_both(tmp_path, ds)
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "variants")
    for a, b in ((pr[0], pr[1]), (pr[2], pr[3])):
        tp.assert_states_equal(
            convert.to_numpy(*psch.request(a).final_state),
            convert.to_numpy(*psch.request(b).final_state), "variant")
    assert psch.request(pr[1]).artifacts["fast_forward"]["skipped_ms"] > 0


_HANDEL = dict(node_count=64, threshold=56, nodes_down=6, pairing_time=4,
               dissemination_period_ms=20, level_wait_time=50,
               fast_path=10)


def _handel_batched(sim_ms, seeds):
    return dict(protocol="Handel", params=_HANDEL, seeds=seeds,
                sim_ms=sim_ms, chunk_ms=40, engine="batched", superstep=4,
                obs=("metrics", "audit"), stat_each_ms=20,
                latency_model="NetworkFixedLatency(10)")


@pytest.mark.slow
def test_repack_fork_join_into_batched_group(tmp_path):
    """A fork-restored request joins a RUNNING batched-K4 group at its
    80-ms boundary (lockstep lane repacking): both requests equal their
    solo runs and the JAX package's repacked run, state and
    artifacts."""
    out = []
    for k in (0, 1):
        mod = (sp.jax_serve(), sp.port_serve())[k]
        dev = {} if k == 0 else {"device": "cpu"}
        mk = (lambda s, seeds: sp.specs(_handel_batched(s, seeds))[k])
        pre = mod.Scheduler(**dev)
        rp = pre.submit(mk(80, (2, 3)), keep_carries=True)
        pre.run_pending()
        p = pre.request(rp)
        fork = mod.ForkState(state=p.final_state, carries=p.final_carries,
                             at_ms=80, prefix_digest=p.spec.digest())
        sch = mod.Scheduler(registry=pre.registry, **dev)
        rids, seen = {}, []

        def joiner(sch=sch, rids=rids, seen=seen, fork=fork, mk=mk):
            seen.append(len(seen))
            if len(seen) == 2:
                rids["b"] = sch.submit(mk(160, (2, 3)), fork=fork,
                                       keep_carries=True)

        sch.on_boundary = joiner
        rids["a"] = sch.submit(mk(160, (0, 1)), keep_carries=True)
        sch.run_pending()
        assert sch.resilience["repacked"] == 1 and len(seen) == 4
        out.append((sch, [rids["a"], rids["b"]]))
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "repack")
    for a, b in zip(jr, pr):
        sp.assert_carries_equal(jsch.request(a), psch.request(b), "repack")


@pytest.mark.slow
def test_repack_group_split_across_two_checkpoints(tmp_path):
    """The fleet-recovery shape: one compile key's work in TWO dead
    workers' checkpoints at different boundaries (A@40 from w1, B@80
    from w2); a survivor adopts both, runs A to 80 and repacks B in —
    equal to the JAX package's survivor, state and artifacts."""
    def die_after(n):
        calls = {"n": 0}

        def launcher(fn, *args):
            calls["n"] += 1
            if calls["n"] > n:
                raise RuntimeError("KILLED")
            return fn(*args)
        return launcher

    out = []
    for k in (0, 1):
        mod = (sp.jax_serve(), sp.port_serve())[k]
        dev = {} if k == 0 else {"device": "cpu"}
        # one chunk is two launches in the JAX package (metrics, then the
        # audit shadow) and one pass in the port
        per_chunk = 2 if k == 0 else 1
        ck = str(tmp_path / f"ck{k}")
        for wid, chunks, seeds in (("w1", 1, (0, 1)), ("w2", 2, (2, 3))):
            dying = mod.Scheduler(checkpoint_dir=ck, worker_id=wid,
                                  launcher=die_after(per_chunk * chunks),
                                  max_retries=0, retry_backoff_s=0.0, **dev)
            dying.submit(sp.specs(_handel_batched(160, seeds))[k])
            dying.run_pending()
        survivor = mod.Scheduler(checkpoint_dir=ck, **dev)
        got = survivor.resume_checkpoints()
        assert {survivor.request(r).resumed_from_ms for r in got} == \
            {40, 80}
        survivor.run_pending()
        assert survivor.resilience["repacked"] == 1
        assert not os.listdir(ck)
        out.append((survivor, got))
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "two checkpoints")


@pytest.mark.slow
def test_repack_fast_forward_group_cross_check_clean():
    """A fork-restored request repacked into a running fast-forward
    group: equal to the JAX package's, and the audit-vs-metrics cross
    check over the stitched carries stays empty."""
    from wittgenstein_tpu_torch.obs.audit import (AuditSpec,
                                                  monitored_invariants)
    from wittgenstein_tpu_torch.obs.audit_report import (AuditReport,
                                                         cross_check_metrics)
    from wittgenstein_tpu_torch.obs.export import MetricsFrame
    from wittgenstein_tpu_torch.obs.spec import MetricsSpec

    def mk(k, sim_ms, seeds):
        return sp.specs(_spec(seeds=seeds, sim_ms=sim_ms, chunk_ms=40,
                              engine="fast_forward"))[k]

    out = []
    for k in (0, 1):
        mod = (sp.jax_serve(), sp.port_serve())[k]
        dev = {} if k == 0 else {"device": "cpu"}
        pre = mod.Scheduler(**dev)
        rp = pre.submit(mk(k, 80, (1,)), keep_carries=True)
        pre.run_pending()
        p = pre.request(rp)
        fork = mod.ForkState(state=p.final_state, carries=p.final_carries,
                             at_ms=80, prefix_digest=p.spec.digest())
        sch = mod.Scheduler(registry=pre.registry, **dev)
        rids, seen = {}, []

        def joiner(sch=sch, rids=rids, seen=seen, fork=fork, k=k):
            seen.append(len(seen))
            if len(seen) == 2:
                rids["b"] = sch.submit(mk(k, 160, (1,)), fork=fork,
                                       keep_carries=True)

        sch.on_boundary = joiner
        rids["a"] = sch.submit(mk(k, 160, (0,)), keep_carries=True)
        sch.run_pending()
        assert sch.resilience["repacked"] == 1
        out.append((sch, [rids["a"], rids["b"]]))
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "ff repack")
    aspec = AuditSpec()
    for rid in pr:
        req = psch.request(rid)
        frame = MetricsFrame.from_carries(
            MetricsSpec(stat_each_ms=req.spec.stat_each_ms),
            req.final_carries["metrics"])
        report = AuditReport.from_carries(
            aspec, req.final_carries["audit"],
            monitored=monitored_invariants(aspec, req.cfg))
        assert report.clean and cross_check_metrics(report, frame) == []


# ------------------------------------------------------------ the card


@pytest.mark.cuda
def test_cuda_served_coalescing_matches_cpu():
    """The chip smoke's V1 at 64 nodes: four one-seed Handel requests
    (batched, K=2, metrics) coalesce into one group of width 4 on the
    card (one registry miss), and each lane's state and artifacts equal
    the same requests served on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    from wittgenstein_tpu_torch.models.handel import reference_default_params
    ps = sp.port_serve()
    d = dict(protocol="Handel", params=reference_default_params(64),
             engine="batched", superstep=2, sim_ms=200, chunk_ms=100,
             obs=("metrics",))
    runs = []
    for dev in ("cpu", "cuda"):
        sch = ps.Scheduler(device=dev, ledger_path="/dev/null")
        rids = [sch.submit(ps.ScenarioSpec(**d, seeds=(s,)))
                for s in range(4)]
        assert len({sch.request(r).compile_key for r in rids}) == 1
        sch.run_pending()
        assert sch.registry.stats()["misses"] == 1
        runs.append([sch.request(r) for r in rids])
    for a, b in zip(*runs):
        assert b.status == "done", b.error
        tp.assert_states_equal(convert.to_numpy(*a.final_state),
                               convert.to_numpy(*b.final_state), "card")
        assert sp.clean_artifacts(a.artifacts) == \
            sp.clean_artifacts(b.artifacts)
