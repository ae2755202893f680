"""The port's fleet (`serve/fleet.py`, `FleetService`, `server/http.py
--fleet-dir`): the twin of tests/test_crash.py:281 (two in-process
workers over one fleet directory: the claim split, the settled map, the
cross-worker dedup and the ledger rows equal the JAX workers'), the
directory contract shared by both packages (a JAX worker's ledger rows
serve the port's workers and the other way round, `fleet_paths` and
`aggregate_worker_stats` read the same files), the front tier against
the JAX `FleetService`, the HTTP server's ``--fleet-dir``, one
`spawn_worker` subprocess on the CPU, and the claim that re-reads the
tombstones.

The JAX side runs once (a module fixture): its two workers drain the
journal of tests/test_crash.py:281, whose specs every later case reuses.
Every wait here is bounded (at most 60 s) and fails the test when it
runs out.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import serve_parity as sp
import torch

from wittgenstein_tpu_torch.serve import FleetService, FleetWorker
from wittgenstein_tpu_torch.serve.fleet import (aggregate_worker_stats,
                                                fleet_paths, spawn_worker)
from wittgenstein_tpu_torch.serve.journal import SubmissionJournal

#: every bounded wait of this file
WAIT_S = 60.0


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


#: tests/test_crash.py:281's journal: chunk_ms differs, so two compile
#: keys, and the cold-key claim budget splits them across two workers
ENTRIES = (("fw0001", _spec()), ("fw0002", _spec(seeds=(7,), chunk_ms=60)))


def _fill(mod, jd):
    j = mod.SubmissionJournal(jd)
    for rid, spec in ENTRIES:
        j.record_submit(rid, mod.ScenarioSpec(**spec))
    return j


def _partition_and_dedup(mod, fd, **kw):
    """tests/test_crash.py:281's sequence on `mod`'s workers: two cold
    workers split the two entries, then a duplicate of a settled spec
    is deduped from the ledger.  Returns what it observed."""
    from importlib import import_module
    fleet = import_module(mod.__name__ + ".fleet")
    jd = fleet.fleet_paths(fd)["journal_dir"]
    j = _fill(mod, jd)
    wa = fleet.FleetWorker(fd, "wa", lease_ttl_s=30.0, **kw)
    wb = fleet.FleetWorker(fd, "wb", lease_ttl_s=30.0, **kw)
    for _ in range(6):
        wa.step()
        wb.step()
        if j.lag() == 0:
            break
    split = (j.lag(), j.settled(), dict(wa.counters), dict(wb.counters))
    j.record_submit("fw0003", mod.ScenarioSpec(**_spec()))
    wa.step()
    dedup = (j.lag(), j.settled()["fw0003"], wa.counters["deduped"],
             wa.sched.peek("fw0003"))
    for w in (wa, wb):
        w.write_stats()
    states = {rid: wa.sched.peek(rid) or wb.sched.peek(rid)
              for rid, _ in ENTRIES}
    return split, dedup, states


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """The JAX workers' run of the journal, its fleet directory kept."""
    js = sp.jax_serve()
    fd = str(tmp_path_factory.mktemp("jfleet") / "fleet")
    split, dedup, reqs = _partition_and_dedup(js, fd)
    import torch_parity as tp
    states = {rid: tp.jax_state(*r.final_state) for rid, r in reqs.items()}
    arts = {rid: sp.clean_artifacts(r.artifacts) for rid, r in reqs.items()}
    return fd, split, dedup, states, arts


def test_workers_partition_and_dedup_equal_jax(jax_fleet, tmp_path):
    """tests/test_crash.py:281 in the port: every entry is claimed by
    exactly one worker (one cold compile key each), both settle, and a
    duplicate resubmit is served from the shared ledger without a run
    — counters, settled map, final states, artifacts and ledger rows
    equal to the JAX workers'."""
    jfd, jsplit, jdedup, jstates, jarts = jax_fleet
    fd = str(tmp_path / "fleet")
    split, dedup, reqs = _partition_and_dedup(sp.port_serve(), fd,
                                              device="cpu")
    lag, settled, ca, cb = split
    assert lag == 0
    assert settled == {"fw0001": "done", "fw0002": "done"}
    assert ca["claimed"] == 1 and cb["claimed"] == 1
    assert split == jsplit
    assert dedup[:3] == (0, "done", 1) and dedup[3] is None
    assert dedup == jdedup
    import torch_parity as tp

    from wittgenstein_tpu_torch import convert
    for rid, req in reqs.items():
        tp.assert_states_equal(jstates[rid],
                               convert.to_numpy(*req.final_state), rid)
        assert sp.clean_artifacts(req.artifacts) == jarts[rid], rid
    assert sp.manifest_rows(fleet_paths(fd)["ledger_path"]) == \
        sp.manifest_rows(os.path.join(jfd, "ledger.jsonl"))


def test_fleet_paths_and_worker_stats_read_alike(jax_fleet):
    """`fleet_paths` derives the JAX layout, and `aggregate_worker_stats`
    reads the JAX workers' snapshots as the JAX function does (the
    counters summed, the registry and resilience blocks too)."""
    from wittgenstein_tpu.serve import fleet as jfleet
    fd = jax_fleet[0]
    assert fleet_paths(fd) == jfleet.fleet_paths(fd)
    agg, jagg = aggregate_worker_stats(fd), jfleet.aggregate_worker_stats(fd)
    assert agg == jagg
    assert agg["counters"]["claimed"] == 3
    assert agg["counters"]["deduped"] == 1
    assert set(agg["workers"]) == {"wa", "wb"}


def test_port_workers_dedup_from_jax_ledger(jax_fleet, tmp_path):
    """A fleet directory shared across the packages: entries the JAX
    workers already ran, journaled again, are settled by a port worker
    from the JAX rows of the shared ledger, with no launch."""
    import shutil
    fd = str(tmp_path / "shared")
    shutil.copytree(jax_fleet[0], fd)
    j = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    for i, (_, spec) in enumerate(ENTRIES):
        j.record_submit(f"fx{i:04d}", ScenarioSpec(**spec))
    w = FleetWorker(fd, "wp", lease_ttl_s=30.0, device="cpu")
    w.step()
    assert j.lag() == 0
    assert j.settled()["fx0000"] == j.settled()["fx0001"] == "done"
    assert w.counters["deduped"] == 2 and w.counters["processed"] == 0
    assert w.sched.registry.stats()["misses"] == 0


def _drain_fleet(worker, journal):
    deadline = time.time() + WAIT_S
    while journal.lag():
        assert time.time() < deadline, "fleet drain timed out"
        worker.step()


def test_front_tier_equals_jax_front_tier(tmp_path):
    """`FleetService` submit, status and result against the JAX
    `FleetService`, each over its own directory and drained by its own
    package's worker: the same rid, status sequence and result (the
    ledger row's completion facts), and the same 400 on a bad spec."""
    from wittgenstein_tpu.serve import fleet as jfleet
    from wittgenstein_tpu.serve import service as jservice
    out = []
    for k, (svc_cls, wk_cls, kw) in enumerate((
            (jservice.FleetService, jfleet.FleetWorker, {}),
            (FleetService, FleetWorker, {"device": "cpu"}))):
        fd = str(tmp_path / f"fleet{k}")
        svc = svc_cls(fd, front_id="front")
        sub = svc.submit(_spec(seeds=[3]))
        queued = svc.status(sub["id"])
        early = svc.result(sub["id"])
        with pytest.raises(ValueError, match="sim_ms"):
            svc.submit(_spec(sim_ms=130))
        with pytest.raises(KeyError):
            svc.status("nope")
        w = wk_cls(fd, "wa", lease_ttl_s=30.0, **kw)
        _drain_fleet(w, svc.journal)
        w.write_stats()
        res = svc.result(sub["id"])
        health = svc.health()
        out.append((sub, queued, early, svc.status(sub["id"]), res,
                    health["fleet"], health["journal_lag"],
                    svc.run_pending(), svc.programs()))
    assert out[1] == out[0]
    sub, queued, early, done, res = out[1][:5]
    assert sub["id"] == "front-r0001" and queued["status"] == "queued"
    assert done["status"] == "done"
    assert res["artifacts"]["from_ledger"] is True
    assert res["artifacts"]["summary"]["done_count"] > 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_http_server_fleet_dir_health(tmp_path):
    """`python -m wittgenstein_tpu_torch.server.http PORT --fleet-dir D`
    serves the batch routes through `FleetService`: health says
    ``"fleet": true`` and a submit lands in the shared journal."""
    fd = str(tmp_path / "fleet")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "wittgenstein_tpu_torch.server.http",
         str(port), "--device", "cpu", "--fleet-dir", fd],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + WAIT_S
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline, "the server never answered"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/w/batch/health",
                        timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.2)
        assert health["fleet"] is True and health["journal_lag"] == 0
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/w/batch/submit",
            data=json.dumps(_spec()).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            sub = json.loads(r.read())
        assert sub["status"] == "queued"
        live = SubmissionJournal(fleet_paths(fd)["journal_dir"]).replay()
        assert [e["rid"] for e in live] == [sub["id"]]
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT_S)


def test_spawn_worker_subprocess_on_cpu(jax_fleet, tmp_path):
    """One `spawn_worker` subprocess with ``--device cpu`` and a 2-s idle
    exit drains a journal entry and exits by itself; its ledger row
    equals the JAX worker's row of the same spec, its recorded state
    digests (``--state-digests``) the JAX final state's, and its log
    carries its start-up line and its final counters."""
    fd = str(tmp_path / "fleet")
    j = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    j.record_submit("fw0002", ScenarioSpec(**ENTRIES[1][1]))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = spawn_worker(fd, "ws", idle_exit_s=2.0, poll_s=0.1,
                        device="cpu", env=env, state_digests=fd)
    try:
        proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(proc.log_path) as f:
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    assert proc.returncode == 0, lines
    assert lines[0]["device"] == "cpu" and lines[0]["startup_s"] >= 0
    assert lines[-1]["worker"] == "ws" and lines[-1]["claimed"] == 1
    assert j.settled() == {"fw0002": "done"}
    rows = sp.manifest_rows(fleet_paths(fd)["ledger_path"])
    jrows = [r for r in sp.manifest_rows(
        os.path.join(jax_fleet[0], "ledger.jsonl"))
        if r["run"] == "serve:fw0002"]
    assert rows == jrows
    from wittgenstein_tpu_torch import convert
    with open(os.path.join(fd, "digests-ws.jsonl")) as f:
        (rec,) = [json.loads(ln) for ln in f]
    assert rec["rid"] == "fw0002" and rec["seeds"] == [7]
    assert rec["digests"] == convert.seed_digests(*jax_fleet[3]["fw0002"])


def test_catalog_flag_refuses(tmp_path):
    """``--catalog`` no longer refuses: it records the worker's programs
    to ``<dir>/programs-<worker>.jsonl`` (one row for the one cold
    program of the entry it drains), which the front tier summarizes.
    (The name is the one the test had while the flag refused.)"""
    from wittgenstein_tpu_torch.obs.programs import read_catalog
    from wittgenstein_tpu_torch.serve.fleet import main
    fd = str(tmp_path / "fleet")
    front = FleetService(fd, front_id="front")
    sub = front.submit(_spec(seeds=[3]))
    assert main(["--dir", fd, "--worker-id", "wc", "--catalog",
                 "--device", "cpu", "--idle-exit", "0.5", "--poll",
                 "0.05", "--max-wall", str(WAIT_S)]) == 0
    assert front.status(sub["id"])["status"] == "done"
    (row,) = read_catalog(os.path.join(fd, "programs-wc.jsonl"))
    assert (row["protocol"], row["plane"], row["backend"], row["batch"]) \
        == ("PingPong", "metrics", "cpu", 1)
    rep = front.programs()
    assert rep["count"] == 1 and rep["programs"] == [row]
    assert rep["catalog"] == {"fleet": True, "files": 1, "durable": True}


def test_entry_settled_after_the_snapshot_is_not_run_again(tmp_path):
    """A worker whose journal snapshot still lists an entry that another
    worker settled and released since (the race between a poll cycle's
    read and its claim) claims it, sees the tombstone, and releases it
    without running it: every entry runs once.  (The JAX worker runs it
    a second time.)"""
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    fd = str(tmp_path / "fleet")
    j = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    j.record_submit("fw0001", ScenarioSpec(**_spec()))
    stale = j.replay()
    wb = FleetWorker(fd, "wb", lease_ttl_s=30.0, device="cpu")
    wb.step()
    assert j.settled() == {"fw0001": "done"}
    wa = FleetWorker(fd, "wa", lease_ttl_s=30.0, device="cpu", dedup=False)
    wa.journal.replay = lambda: [dict(e) for e in stale]
    out = wa.step()
    assert out == {"adopted": 0, "processed": 0}
    assert wa.sched.peek("fw0001") is None
    assert wa.counters["claimed"] == wa.counters["released"] == 1
    assert wa.leases.holder("fw0001") is None
    assert len(sp.manifest_rows(fleet_paths(fd)["ledger_path"])) == 1


def test_claim_reads_only_the_journal_rows_appended_since(tmp_path):
    """The claim's tombstone check polls the journal incrementally: it
    never parses the whole journal (`settled()`), it sees a tombstone
    appended after its last poll, and it stops at the end of the file
    each time."""
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    fd = str(tmp_path / "fleet")
    j = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    for rid in ("fa", "fb"):
        j.record_submit(rid, ScenarioSpec(**_spec()))
    w = FleetWorker(fd, "wa", lease_ttl_s=30.0, device="cpu")

    def whole_parse():
        raise AssertionError("the claim parsed the whole journal")
    w.journal.settled = whole_parse
    assert w._claim_unsettled("fa")
    assert w._journal_tail._offset == os.path.getsize(j.path)
    w._release("fa")
    j.record_settled("fb", "done")
    assert not w._claim_unsettled("fb")
    assert w.leases.holder("fb") is None
    j.record_settled("fa", "done")
    assert not w._claim_unsettled("fa")
    assert w._journal_tail._offset == os.path.getsize(j.path)
    assert w.counters["claimed"] == w.counters["released"] == 3


def test_jax_worker_dedups_from_port_ledger(tmp_path):
    """The other way round: a JAX worker over a fleet directory whose
    ledger rows the port's worker wrote settles a duplicate of the same
    spec from them, with no launch."""
    from wittgenstein_tpu.serve import ScenarioSpec as JSpec
    from wittgenstein_tpu.serve.fleet import FleetWorker as JWorker
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    fd = str(tmp_path / "fleet")
    j = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    j.record_submit("fw0002", ScenarioSpec(**ENTRIES[1][1]))
    FleetWorker(fd, "wp", lease_ttl_s=30.0, device="cpu").step()
    assert j.settled() == {"fw0002": "done"}
    j.record_submit("fx0002", JSpec(**ENTRIES[1][1]))
    jw = JWorker(fd, "wj", lease_ttl_s=30.0)
    jw.step()
    assert j.settled()["fx0002"] == "done"
    assert jw.counters["deduped"] == 1 and jw.counters["processed"] == 0
    assert jw.sched.registry.stats()["misses"] == 0
