"""The port's adaptive boundary search (`matrix/search.py`): the twins of
tests/test_search.py — spec digests and refusals, the bisection
automaton, the search against the exhaustive grid's ground truth and
its ledger join, the report's round trip, the metrics projection, the
checked-in question's digest pin — and the fleet's memo-table seam,
which the port makes deterministic: a worker puts a finished prefix in
the shared table before the prefix's journal tombstone, so a search's
probes always fork from it (tests/test_search.py:279 in the JAX package
is intermittent for want of that order).

The JAX package answers the 6-step loss ladder once (a module fixture:
the exhaustive `run_grid`, then `run_search` over the same ledger); the
port's answers are compared with its reports, walls left out.  Every
wait here is bounded (at most 60 s) and fails the test when it runs
out.
"""

import copy
import json
import os
import pathlib
import threading
import time

import pytest
import torch

from wittgenstein_tpu_torch.matrix import (SearchReport, SearchSpec,
                                           compile_search, run_grid,
                                           run_search)
from wittgenstein_tpu_torch.matrix.search import (_SliceState,
                                                  exhaustive_boundaries)
from wittgenstein_tpu_torch.serve import Scheduler

SPEC_PATH = pathlib.Path(__file__).parent.parent / "tools" / "specs" \
    / "search_loss_boundary.json"

#: every bounded wait of this file
WAIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loss_axis(n, step=20):
    return {"name": "loss", "field": "fault_schedule",
            "values": [{"loss": [[40, 160, p, 0, 32, 0, 32]]}
                       for p in range(0, n * step, step)],
            "labels": ["p%03d" % p for p in range(0, n * step, step)]}


def _spec_json(**kw):
    base = dict(
        name="t-search",
        grid={"name": "t-grid",
              "base": {"protocol": "PingPong",
                       "params": {"node_count": 32}, "seeds": [0],
                       "sim_ms": 160, "chunk_ms": 40,
                       "obs": ["metrics", "audit"],
                       "latency_model": "NetworkFixedLatency(50)"},
              "axes": [_loss_axis(6)]},
        axis="loss",
        predicate={"field": "summary.done_frac", "op": ">=",
                   "value": 0.99},
        coarse=2)
    base.update(kw)
    return base


def _spec(**kw):
    return SearchSpec.from_json(_spec_json(**kw))


def _norm(rep, keys=("wall_s",)):
    d = copy.deepcopy(rep.to_json() if hasattr(rep, "to_json") else rep)
    for k in keys:
        d.pop(k, None)
    return d


# ----------------------------------------------------------------- spec


def test_spec_roundtrip_and_digest_stability():
    """tests/test_search.py:68 in the port, and the digest is the JAX
    package's."""
    from wittgenstein_tpu.matrix import SearchSpec as JSpec
    s = _spec()
    again = SearchSpec.from_json(json.loads(s.canonical_json()))
    assert again == s
    assert again.digest() == s.digest()
    shuffled = SearchSpec.from_json(
        json.loads(json.dumps(s.to_json(), sort_keys=True)))
    assert shuffled.digest() == s.digest()
    assert s.digest() == JSpec.from_json(_spec_json()).digest()
    assert s.canonical_json() == JSpec.from_json(
        _spec_json()).canonical_json()


def test_spec_digest_sensitivity():
    """tests/test_search.py:79 in the port: every part of the question
    moves the digest."""
    s = _spec()
    two_axes = _spec(grid={
        "name": "t-grid", "base": s.grid.base,
        "axes": [_loss_axis(6),
                 {"name": "seed", "field": "seeds",
                  "values": [[0], [1]]}]})
    digests = {
        s.digest(),
        _spec(name="other").digest(),
        _spec(coarse=3).digest(),
        _spec(predicate={"field": "summary.done_frac", "op": ">=",
                         "value": 0.5}).digest(),
        _spec(predicate={"field": "summary.done_frac", "op": "<",
                         "value": 0.99}).digest(),
        _spec(predicate={"field": "time_to_done_ms", "op": "<=",
                         "value": 120}).digest(),
        _spec(grid={"name": "t-grid", "base": s.grid.base,
                    "axes": [_loss_axis(8)]}).digest(),
        two_axes.digest(),
        SearchSpec.from_json(dict(two_axes.to_json(),
                                  axis="seed")).digest(),
    }
    assert len(digests) == 9, \
        "a question change failed to move the search digest"


def test_spec_validation_refuses_with_remedy():
    """tests/test_search.py:108 in the port."""
    with pytest.raises(ValueError, match="unknown key"):
        SearchSpec.from_json({"grid": {}, "axis": "a",
                              "predicate": {}, "bogus": 1})
    with pytest.raises(ValueError, match="missing required"):
        SearchSpec.from_json({"axis": "loss"})
    s = _spec()
    with pytest.raises(ValueError, match="not one of the grid's axes"):
        SearchSpec.from_json(dict(s.to_json(), axis="nope"))
    with pytest.raises(ValueError, match="exactly"):
        SearchSpec.from_json(dict(s.to_json(),
                                  predicate={"field": "x"}))
    with pytest.raises(ValueError, match="op"):
        SearchSpec.from_json(dict(
            s.to_json(), predicate={"field": "summary.done_frac",
                                    "op": "==", "value": 1}))
    with pytest.raises(ValueError, match="must be a number"):
        SearchSpec.from_json(dict(
            s.to_json(), predicate={"field": "summary.done_frac",
                                    "op": ">=", "value": True}))
    with pytest.raises(ValueError, match="field"):
        SearchSpec.from_json(dict(
            s.to_json(), predicate={"field": "wall_s", "op": ">=",
                                    "value": 1}))
    with pytest.raises(ValueError, match="coarse"):
        SearchSpec.from_json(dict(s.to_json(), coarse=1))
    with pytest.raises(ValueError, match="exhaustive sweep"):
        SearchSpec.from_json(dict(s.to_json(), coarse=7))
    with pytest.raises(ValueError, match="at least 2"):
        SearchSpec.from_json(dict(s.to_json(),
                                  grid={"name": "g",
                                        "base": s.grid.base,
                                        "axes": [_loss_axis(1)]}))
    with pytest.raises(ValueError, match="exclusion"):
        two = {"name": "g", "base": s.grid.base,
               "axes": [_loss_axis(2),
                        {"name": "seed", "field": "seeds",
                         "values": [[0], [1]]}],
               "exclude": [{"loss": "p000", "seed": "0"}]}
        SearchSpec.from_json(dict(s.to_json(), grid=two))
    with pytest.raises(ValueError, match="schema"):
        SearchSpec.from_json(dict(s.to_json(), schema=2))


# ------------------------------------------------------------ automaton


def _drive(n, coarse_idx, oracle):
    sl = type("S", (), {"id": "*", "labels": {},
                        "cell_ids": tuple(f"c{i}" for i in range(n))})
    st = _SliceState(sl, coarse_idx)
    seq = []
    while True:
        nxt = st.next_probes()
        if not nxt:
            return seq, st
        for i in nxt:
            seq.append(i)
            st.observe(i, oracle(i), float(oracle(i)), None)


def test_bisection_probe_sequence_and_boundary():
    """tests/test_search.py:171 in the port."""
    seq, st = _drive(16, (0, 5, 10, 15), lambda i: i < 7)
    assert seq == [0, 5, 10, 15, 7, 6]
    assert st.status == "boundary" and st.boundary_idx == 7
    seq2, _ = _drive(16, (0, 5, 10, 15), lambda i: i < 7)
    assert seq2 == seq
    for flip in range(1, 16):
        _, st = _drive(16, (0, 5, 10, 15), lambda i, f=flip: i < f)
        truth = next(i for i in range(16) if not (i < flip))
        assert st.boundary_idx == truth, f"flip at {flip}"


def test_bisection_edge_verdicts():
    """tests/test_search.py:187 in the port."""
    _, st = _drive(8, (0, 7), lambda i: True)
    assert st.status == "all_pass" and st.boundary_idx is None
    _, st = _drive(8, (0, 7), lambda i: False)
    assert st.status == "all_fail"
    _, st = _drive(16, (0, 5, 10, 15),
                   lambda i: i in (0, 1, 10, 11, 12))
    assert st.status == "divergent"
    assert st.boundary_idx is not None


# -------------------------------------------------- ground truth (sim)


@pytest.fixture(scope="module")
def jax_boundary(tmp_path_factory):
    """The JAX package's exhaustive grid and search of the ladder."""
    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.matrix import SearchSpec as JSpec
    from wittgenstein_tpu.matrix import run_grid as jrun_grid
    from wittgenstein_tpu.matrix import run_search as jrun_search
    from wittgenstein_tpu.serve import Scheduler as JScheduler
    d = tmp_path_factory.mktemp("jsearch")
    spec = JSpec.from_json(_spec_json())
    led = str(d / "ledger.jsonl")
    grid = jrun_grid(spec.grid, JScheduler(ledger_path=led),
                     keep_states=())
    search = jrun_search(spec, JScheduler(ledger_path=led))
    return grid.report.to_json(), search.report.to_json()


@pytest.fixture(scope="module")
def boundary_run(tmp_path_factory):
    """The port's answers: exhaustively via `run_grid`, then adaptively
    via `run_search` over the SAME ledger."""
    d = tmp_path_factory.mktemp("search")
    spec = _spec()
    led = str(d / "ledger.jsonl")
    grid_run = run_grid(spec.grid, Scheduler(ledger_path=led, device="cpu"),
                        keep_states=())
    assert grid_run.report.clean
    search_run = run_search(spec, Scheduler(ledger_path=led, device="cpu"))
    return spec, grid_run, search_run


def test_search_agrees_with_exhaustive_oracle(jax_boundary, boundary_run):
    """tests/test_search.py:218 in the port, its grid and search
    reports equal to the JAX package's."""
    spec, grid_run, search_run = boundary_run
    splan = search_run.plan
    rows = {r["cell"]: r for r in grid_run.report.data["cells"]}
    truth = exhaustive_boundaries(splan, rows)
    rep = search_run.report.data
    assert rep["boundaries_found"] == len(splan.slices) == 1
    for row in rep["slices"]:
        assert row["status"] == "boundary"
        assert row["boundary_cell"] == truth[row["slice"]]
    assert rep["cells_probed"] < rep["cells_exhaustive"] == 6
    jgrid, jsearch = jax_boundary
    assert grid_run.report.data["cells"] == jgrid["cells"]
    assert grid_run.report.data["by_axis"] == jgrid["by_axis"]
    assert _norm(search_run.report) == _norm(jsearch)


def test_search_serves_probes_from_ledger_join(boundary_run):
    """tests/test_search.py:232 in the port."""
    _, _, search_run = boundary_run
    rep = search_run.report.data
    assert rep["chunks_simulated"] == 0
    acct = rep["accounting"]
    assert acct["ledger_hits"] == rep["cells_probed"]
    assert acct["live_probes"] == 0


def test_report_roundtrip_and_schema_refusal(boundary_run):
    """tests/test_search.py:243 in the port."""
    _, _, search_run = boundary_run
    rep = search_run.report
    again = SearchReport.from_json(
        json.dumps(rep.to_json(), sort_keys=True))
    assert again.to_json() == rep.to_json()
    assert again.search_digest == rep.search_digest
    assert again.clean
    with pytest.raises(ValueError, match="schema"):
        SearchReport.from_json(dict(rep.to_json(), schema=99))
    with pytest.raises(ValueError, match="search_digest"):
        SearchReport.from_json({"cells": []})
    assert "boundary" in rep.format()


def test_probe_sequence_rederives_identically(boundary_run):
    """tests/test_search.py:258 in the port."""
    spec, _, search_run = boundary_run
    seq_a = [p["cell"] for p in search_run.report.data["probes"]]
    splan2 = compile_search(SearchSpec.from_json(
        json.loads(spec.canonical_json())))
    assert splan2.search_digest == search_run.plan.search_digest
    assert [s.cell_ids for s in splan2.slices] \
        == [s.cell_ids for s in search_run.plan.slices]
    assert splan2.coarse_idx == search_run.plan.coarse_idx
    assert seq_a[:len(splan2.coarse_idx)] == [
        splan2.slices[0].cell_ids[i] for i in splan2.coarse_idx]


def test_cold_search_equals_jax(jax_boundary, tmp_path):
    """A cold search (no ledger to join): every probe runs, each after
    the first fork of a slice forks from its memo prefix, and the
    report equals the JAX package's answer bit for bit but its
    accounting (the JAX answer joined the exhaustive ledger)."""
    run = run_search(_spec(), Scheduler(ledger_path=str(tmp_path / "l"),
                                        device="cpu"))
    rep = run.report.data
    memo = rep["accounting"]["memo"]
    assert rep["accounting"]["live_probes"] == rep["cells_probed"]
    assert memo["forked_cells"] == rep["cells_probed"]
    assert memo["fork_vetoed"] == memo["prefix_failed"] == 0
    keep = ("wall_s", "accounting", "chunks_simulated",
            "probe_savings_ratio", "cells")
    assert _norm(run.report, keep) == _norm(jax_boundary[1], keep)
    for a, b in zip(rep["cells"], jax_boundary[1]["cells"]):
        a = dict(a)
        assert a.pop("forked_from")["fork_ms"] == 40
        assert a == b


def test_search_counter_metrics_projection():
    """tests/test_search.py:343 in the port: the exposition lines equal
    the JAX projection's."""
    from wittgenstein_tpu.obs.metrics import MetricsRegistry as JReg
    from wittgenstein_tpu.serve.instrument import \
        refresh_search_counters as jrefresh

    from wittgenstein_tpu_torch.obs.metrics import MetricsRegistry
    from wittgenstein_tpu_torch.serve.instrument import (
        SEARCH_COUNTERS, refresh_search_counters)
    m, jm = MetricsRegistry(), JReg()
    counts = {"memo_table_hits": 3, "memo_table_misses": 1,
              "prefix_chunks_saved": 9, "search_probes_total": 4}
    refresh_search_counters(m, counts)
    jrefresh(jm, counts)
    text = m.exposition()
    for name in SEARCH_COUNTERS.values():
        assert name in text
    refresh_search_counters(m, {"memo_table_hits": 2})
    assert "wtpu_memo_table_hits_total 3" in m.exposition()
    jrefresh(jm, {"memo_table_hits": 2})
    assert m.exposition() == jm.exposition()


def test_checked_in_spec_digest_pin():
    """tests/test_search.py:386 in the port: the checked-in boundary
    question digests as the JAX package pins it."""
    spec = SearchSpec.from_json(json.loads(SPEC_PATH.read_text()))
    assert spec.digest() == "71897572ddfeb0fd"
    assert spec.grid.grid_digest() == "414eeea427bbbe87"
    splan = compile_search(spec)
    assert len(splan.slices) == 2
    assert splan.summary()["chunks_exhaustive"] == 256


# ----------------------------------------------------- fleet memo seam


def _fleet_search(tmp_path, step):
    """`_run_search_fleet` on a thread over a fresh fleet directory, its
    two in-process workers ("wa", "wb", one shared memo table) driven
    by `step(wa, wb, journal)` until the search returns (at most
    WAIT_S)."""
    from wittgenstein_tpu_torch.matrix.search import _run_search_fleet
    from wittgenstein_tpu_torch.serve.fleet import FleetWorker, fleet_paths
    from wittgenstein_tpu_torch.serve.journal import SubmissionJournal

    spec = _spec()
    splan = compile_search(spec)
    fd = str(tmp_path / "fleet")
    table_dir = os.path.join(fd, "memo_table")
    wa = FleetWorker(fd, "wa", lease_ttl_s=30.0, memo_table=table_dir,
                     device="cpu")
    wb = FleetWorker(fd, "wb", lease_ttl_s=30.0, memo_table=table_dir,
                     device="cpu")
    box = {}

    def search():
        box["run"] = _run_search_fleet(
            spec, splan, fleet_dir=fd, workers=2, spawn=False,
            poll_s=0.05, timeout_s=WAIT_S)

    t = threading.Thread(target=search, name="fleet-search")
    t.start()
    journal = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    deadline = time.time() + WAIT_S
    try:
        while t.is_alive() and time.time() < deadline:
            step(wa, wb, journal)
            wa.write_stats()
            wb.write_stats()
            t.join(timeout=0.02)
    finally:
        t.join(timeout=WAIT_S)
    assert not t.is_alive(), "the fleet search did not return in time"
    assert "run" in box, "the fleet search raised (see its stderr)"
    return box["run"], wa, wb


def test_fleet_workers_share_memo_table_in_process(jax_boundary, tmp_path):
    """tests/test_search.py:279 in the port, deterministic: worker "wa"
    alone is stepped while prefix entries are pending, so it runs the
    honest prefix; "wb" alone runs the probes, and every probe forks
    from wa's table entry (hits == probes, no miss) — because a port
    worker puts the prefix in the table before its tombstone.  The
    report equals the single-process JAX answer but its accounting and
    the probes' fork markers."""
    def step(wa, wb, journal):
        if any(e["rid"].startswith("sp") for e in journal.replay()):
            wa.step()
        else:
            wb.step()

    run, wa, wb = _fleet_search(tmp_path, step)
    rep = run.report
    assert rep.clean
    probed = rep.data["cells_probed"]
    assert probed < rep.data["cells_exhaustive"]
    assert wa.counters["memo_table_hits"] == 0
    assert wb.counters["memo_table_hits"] == probed
    assert wb.counters["memo_table_misses"] == 0
    assert wb.counters["prefix_chunks_saved"] == probed
    assert wb.counters["search_probes_total"] == probed
    acct = rep.data["accounting"]["resume"]
    assert acct["memo_table_hits"] == probed
    assert acct["memo_table_misses"] == 0
    assert rep.data["accounting"]["memo"]["prefix_failed"] == 0
    keep = ("wall_s", "accounting", "chunks_simulated",
            "probe_savings_ratio", "cells")
    assert _norm(rep, keep) == _norm(jax_boundary[1], keep)
    for a, b in zip(rep.data["cells"], jax_boundary[1]["cells"]):
        a = dict(a)
        assert a.pop("forked_from")["fork_ms"] == 40
        assert a == b


def test_prefix_is_in_the_table_before_it_settles(tmp_path):
    """The order the fleet search rests on: when a worker writes a memo
    prefix's journal tombstone, the prefix's table entry already
    exists.  Every tombstone this worker writes is checked as it is
    written."""
    from wittgenstein_tpu_torch.memo import MemoTable, plan_prefixes
    from wittgenstein_tpu_torch.serve.fleet import FleetWorker, fleet_paths
    from wittgenstein_tpu_torch.serve.journal import SubmissionJournal

    splan = compile_search(_spec())
    fplan = plan_prefixes(splan.mplan, min_cells=2, include_singles=True)
    assert fplan.groups
    fd = str(tmp_path / "fleet")
    table = MemoTable(os.path.join(fd, "memo_table"))
    journal = SubmissionJournal(fleet_paths(fd)["journal_dir"])
    specs = {}
    for i, fg in enumerate(fplan.groups):
        rid = f"sp-{i:04d}"
        specs[rid] = fg.prefix_spec
        journal.record_submit(
            rid, fg.prefix_spec, label="memo:prefix",
            ledger_extra={"grid_digest": splan.grid_digest,
                          "memo_prefix": fg.prefix_digest})
    w = FleetWorker(fd, "wa", lease_ttl_s=30.0, memo_table=table.root,
                    device="cpu")
    seen = {}
    settle = w.sched.journal.record_settled

    def checked(rid, status):
        seen[rid] = os.path.exists(table.path(specs[rid]))
        return settle(rid, status)

    w.sched.journal.record_settled = checked
    deadline = time.time() + WAIT_S
    while journal.lag():
        assert time.time() < deadline, "the prefixes never settled"
        w.step()
    assert seen == {rid: True for rid in specs}, seen
    for spec in specs.values():
        assert table.get(spec, device="cpu") is not None


@pytest.mark.slow
def test_search_crash_kill_resume_bit_identical(tmp_path):
    """tests/test_search.py:491 in the port, in process: a search whose
    launches start failing mid-flight leaves finished probes (ledger
    rows), a checkpoint and journal entries; a fresh scheduler and
    `run_search(resume=True)` finish it with the uninterrupted run's
    report (modulo walls, accounting and resume/fork markers)."""
    led, ck, jd = (str(tmp_path / n) for n in ("led.jsonl", "ck", "jd"))
    spec = _spec()
    ref = run_search(spec, Scheduler(ledger_path=str(tmp_path / "r"),
                                     device="cpu"))
    calls = {"n": 0}

    def killer(fn, *a):
        calls["n"] += 1
        if calls["n"] > 4:
            raise RuntimeError("KILLED")
        return fn(*a)

    run_search(spec, Scheduler(ledger_path=led, checkpoint_dir=ck,
                               journal_dir=jd, launcher=killer,
                               max_retries=0, retry_backoff_s=0.0,
                               device="cpu"))
    resumed = run_search(spec, Scheduler(ledger_path=led,
                                         checkpoint_dir=ck,
                                         journal_dir=jd, device="cpu"),
                         resume=True)
    keep = ("wall_s", "accounting", "chunks_simulated",
            "probe_savings_ratio")

    def strip(rep):
        d = _norm(rep, keep)
        for row in d["cells"]:
            row.pop("resumed_from_ms", None)
            row.pop("forked_from", None)
        return d

    assert resumed.report.clean
    assert resumed.report.data["boundaries_found"] == 1
    assert strip(resumed.report) == strip(ref.report)
