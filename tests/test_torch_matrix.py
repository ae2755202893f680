"""The port's sweep-grid campaigns (`matrix/driver.py`, `matrix/report.py`
and the `/w/matrix/*` routes): the twins of tests/test_matrix.py's run,
report, HTTP and campaign-resume cases, each held to the JAX package
with tolerance 0.

One small grid serves the whole file: PingPong(32), 120 ms in 40-ms
chunks under the metrics and audit planes, three seeds against a loss
window that opens at 40 ms — two compile keys, six cells, and a fork
group per seed for `run_grid(memo=True)`.  The JAX `run_grid` runs it
once (a module fixture); every port run is compared with that report,
its ledger rows and its final states.  What a comparison leaves out is
named in tests/serve_parity.py (walls, the registry's cache directory)
and below (`_norm`).
"""

import copy
import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import serve_parity as sp
import torch

from wittgenstein_tpu_torch.matrix import (MatrixReport, SweepGrid,
                                           pick_spot_cells, plan, run_grid,
                                           verify_cell)
from wittgenstein_tpu_torch.obs import ledger
from wittgenstein_tpu_torch.serve import Scheduler

#: loss on every link of the 32 nodes from 40 ms: the clean twin's
#: first chunk is every lossy cell's honest prefix
LOSS_SCHEDULE = {"loss": [[40, 120, 400, 0, 32, 0, 32]]}

GRID = dict(
    name="t-port",
    base={"protocol": "PingPong", "params": {"node_count": 32},
          "seeds": [0], "sim_ms": 120, "chunk_ms": 40,
          "obs": ["metrics", "audit"]},
    axes=({"name": "seed", "field": "seeds",
           "values": [[0], [1], [2]]},
          {"name": "chaos", "field": "fault_schedule",
           "values": [None, LOSS_SCHEDULE], "labels": ["clean", "loss"]}))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(**kw):
    return SweepGrid(**{**GRID, **kw})


def _norm(report: dict, run_local=True) -> dict:
    """A report without its wall and the registry's cache directory;
    with `run_local`, also without the run-local accounting a resumed
    or memoized run honestly changes (builds, registry, resilience,
    resume and memo blocks, resume and fork markers on cell rows)."""
    d = copy.deepcopy(report)
    d.pop("wall_s", None)
    if "registry" in d:
        d["registry"] = sp.clean_registry(d["registry"])
    if run_local:
        for k in ("program_builds", "registry", "resilience", "resume",
                  "memo"):
            d.pop(k, None)
        for row in d["cells"]:
            row.pop("resumed_from_ms", None)
            row.pop("forked_from", None)
    return d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's `run_grid` of the grid: its report, final
    states (numpy) and ledger rows."""
    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.matrix import SweepGrid as JGrid
    from wittgenstein_tpu.matrix import run_grid as jrun_grid
    from wittgenstein_tpu.serve import Scheduler as JScheduler
    import torch_parity as tp
    led = str(tmp_path_factory.mktemp("jax") / "ledger.jsonl")
    run = jrun_grid(JGrid(**GRID), JScheduler(ledger_path=led))
    states = {cid: tp.jax_state(*st) for cid, st in run.states.items()}
    return run.report.to_json(), states, sp.manifest_rows(led)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    led = str(tmp_path_factory.mktemp("port") / "ledger.jsonl")
    run = run_grid(_grid(), Scheduler(ledger_path=led, device="cpu"))
    return run, led


def _states_equal_jax(jstates, run):
    from wittgenstein_tpu_torch import convert
    import torch_parity as tp
    assert set(run.states) == set(jstates)
    for cid, st in run.states.items():
        tp.assert_states_equal(jstates[cid], convert.to_numpy(*st), cid)


def test_run_equals_jax_compile_minimal_and_ledger_rows(jax_run, port_run):
    """tests/test_matrix.py:257 in the port: builds == the plan's, one
    row per cell labelled by cell with the grid digest and axes — and
    the report, the final states and the ledger rows equal the JAX
    run's."""
    jrep, jstates, jrows = jax_run
    run, led = port_run
    rep = run.report.to_json()
    assert rep["cells_done"] == 6 and rep["cells_error"] == 0
    assert rep["audit_violations"] == 0 and run.report.clean
    assert rep["planned_compiles"] == rep["distinct_compile_keys"] == 2
    assert rep["program_builds"] == rep["expected_builds"] == 4
    rows = ledger.read_all(led)
    assert len(rows) == 6
    by_cell = {r.extra["cell"]: r for r in rows}
    g = _grid()
    for cell in g.expand():
        row = by_cell[cell.id]
        assert row.run == f"matrix:{cell.id}"
        assert row.extra["grid_digest"] == g.grid_digest()
        assert row.extra["axes"] == cell.labels
        assert row.config_digest == cell.spec.digest()
    assert _norm(rep, run_local=False) == _norm(jrep, run_local=False)
    assert sp.manifest_rows(led) == jrows
    _states_equal_jax(jstates, run)


def test_run_pinned_subset_bit_identical_to_runner(port_run):
    """tests/test_matrix.py:279 in the port: spot cells, a lossy one
    among them, equal sequential `Runner` runs (final state, metrics
    and audit blocks)."""
    run, _ = port_run
    p = plan(_grid())
    spots = pick_spot_cells(p.cells, 2)
    spots.append("seed=1/chaos=loss")
    for cid in dict.fromkeys(spots):
        mism = verify_cell(p.resolved[cid], run.states[cid],
                           run.artifacts[cid])
        assert mism == [], f"{cid}: {mism}"


def test_verify_cell_names_a_differing_state(port_run):
    """`verify_cell` is no rubber stamp: another cell's state fails it
    with the seed named."""
    run, _ = port_run
    p = plan(_grid())
    mism = verify_cell(p.resolved["seed=0/chaos=loss"],
                       run.states["seed=0/chaos=clean"],
                       run.artifacts["seed=0/chaos=loss"])
    assert any("seed 0: final-state" in m for m in mism), mism


def test_report_impact_and_axis_aggregates(jax_run, port_run):
    """tests/test_matrix.py:293 in the port: the loss cost deliveries
    against the fault-free twin, the per-axis tables, the JSON round
    trip — all equal to the JAX report's."""
    jrep = jax_run[0]
    rep = port_run[0].report
    row = rep.cell("seed=0/chaos=loss")
    assert row["impact_vs_twin"]["msg_received"] < 0
    assert row["impact_vs_twin"] == next(
        r for r in jrep["cells"]
        if r["cell"] == "seed=0/chaos=loss")["impact_vs_twin"]
    assert "impact_vs_twin" not in rep.cell("seed=0/chaos=clean")
    ax = rep.to_json()["by_axis"]["chaos"]
    assert ax["clean"]["done"] == 3 and ax["loss"]["done"] == 3
    assert ax["loss"]["done_delta_vs_twin_mean"] <= 0
    assert "time_to_done_ms_mean" in ax["clean"]
    assert rep.to_json()["by_axis"] == jrep["by_axis"]
    again = MatrixReport.from_json(json.loads(json.dumps(rep.to_json())))
    assert again.to_json() == rep.to_json()
    assert "2 compile keys" in again.format()


def test_memo_run_equals_unmemoized_bit_for_bit(jax_run, port_run, tmp_path):
    """`run_grid(memo=True)`: each seed's clean first chunk is run once
    and both of its cells fork from it; every final state equals the
    unforked run's, and every report row too (but its fork marker)."""
    run, _ = port_run
    memo = run_grid(_grid(), Scheduler(
        ledger_path=str(tmp_path / "l.jsonl"), device="cpu"), memo=True)
    m = memo.report.to_json()["memo"]
    assert m["fork_groups"] == 3 and m["prefix_runs"] == 3
    assert m["forked_cells"] == 6 and m["fork_vetoed"] == 0
    assert m["prefix_chunks_saved"] == m["predicted_chunks_saved"] == 3
    assert all("forked_from" in r for r in memo.report.data["cells"])
    assert _norm(memo.report.to_json()) == _norm(run.report.to_json())
    _states_equal_jax(jax_run[1], memo)


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def test_http_matrix_round_trip(jax_run, tmp_path):
    """tests/test_matrix.py:327 in the port: /w/matrix/* submit -> run
    -> status -> report over HTTP with a manual drain (the report equal
    to the JAX run's), a malformed grid's 400 naming the cell, an
    unknown id's 400."""
    from wittgenstein_tpu_torch.server.http import make_server
    httpd = make_server(0, batch_auto=False, device="cpu")
    httpd.batch_service.scheduler.ledger_path = str(tmp_path / "l.jsonl")
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        grid = _grid().to_json()
        sub = _post(port, "/w/matrix/submit", grid)
        assert sub["status"] == "planned" and sub["cells"] == 6
        assert sub["planned_compiles"] == 2
        assert sub["grid_digest"] == _grid().grid_digest()
        assert _get(port, f"/w/matrix/status/{sub['id']}")["status"] \
            == "planned"
        assert _get(port, f"/w/matrix/report/{sub['id']}")["status"] \
            == "planned"
        _post(port, f"/w/matrix/run/{sub['id']}")
        rep = _get(port, f"/w/matrix/report/{sub['id']}")
        assert rep.pop("status") == "done"
        assert rep["cells_done"] == 6 and rep["audit_violations"] == 0
        assert rep["program_builds"] == 4
        assert _norm(rep) == _norm(jax_run[0])
        st = _get(port, f"/w/matrix/status/{sub['id']}")
        assert st["status"] == "done" and st["progress"]["done"] == 6
        bad = dict(grid, axes=[{"name": "span", "field": "sim_ms",
                                "values": [120, 250]}])
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/w/matrix/submit", bad)
        assert ei.value.code == 400
        err = json.loads(ei.value.read())["error"]
        assert "span=250" in err and "chunk_ms" in err
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/w/matrix/status/nope")
        assert ei.value.code == 400
    finally:
        httpd.batch_service.close()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


def _killer(n):
    calls = {"n": 0}

    def killer(fn, *a):
        calls["n"] += 1
        if calls["n"] > n:
            raise RuntimeError("KILLED")
        return fn(*a)
    return killer


def test_kill_mid_campaign_resume_bit_identical(jax_run, port_run,
                                                tmp_path):
    """tests/test_matrix.py:419 in the port: a campaign hard-stopped
    with finished cells (ledger rows), a group caught mid-run under the
    loss schedule (its checkpoint) and cells never run; a fresh
    scheduler and `run_grid(resume=True)` finish it with a report and
    final states equal to the uninterrupted run's (and so the JAX
    run's).  Waves of at most 2 cells x 3 chunks, one launch a chunk
    (both planes in one pass): the clean group's two waves take 6
    launches, and the kill lands on the third chunk of the loss
    group's first wave, after its checkpoint at 80 ms."""
    p = plan(_grid())
    led, ck = str(tmp_path / "led.jsonl"), str(tmp_path / "ck")
    crashed = run_grid(_grid(), Scheduler(
        ledger_path=led, checkpoint_dir=ck, launcher=_killer(8),
        max_retries=0, retry_backoff_s=0.0, device="cpu"),
        plan_=p, max_wave=2)
    assert 0 < crashed.report.data["cells_done"] < len(p.cells)
    rows_after_crash = ledger.read_all(led)
    assert 0 < len(rows_after_crash) < len(p.cells)
    assert os.listdir(ck), "no mid-flight checkpoint was written"
    resumed = run_grid(_grid(), Scheduler(ledger_path=led,
                                          checkpoint_dir=ck, device="cpu"),
                       plan_=p, resume=True)
    rinfo = resumed.report.data["resume"]
    assert rinfo["from_ledger"] == len(rows_after_crash)
    assert rinfo["resumed_requests"] >= 1
    assert resumed.report.clean
    assert _norm(resumed.report.to_json()) == _norm(jax_run[0])
    assert resumed.states, "resume re-ran nothing: the kill was a no-op"
    import torch_parity as tp
    from wittgenstein_tpu_torch import convert
    for cid, st in resumed.states.items():
        tp.assert_states_equal(jax_run[1][cid], convert.to_numpy(*st), cid)
    assert not os.listdir(ck)


def test_resume_cross_grid_dedup_and_stale_refusal(port_run, tmp_path):
    """tests/test_matrix.py:488 in the port: a cell whose config digest
    has a clean row in the ledger is served from it (`deduped`), and a
    resume of another grid against a campaign's checkpoints refuses,
    naming the grid."""
    led = str(tmp_path / "led.jsonl")
    g1 = _grid(axes=(GRID["axes"][0],))
    r1 = run_grid(g1, Scheduler(ledger_path=led, device="cpu"))
    assert r1.report.clean
    g2 = _grid(axes=({"name": "seed", "field": "seeds",
                      "values": [[0], [1], [2], [3]]},))
    r2 = run_grid(g2, Scheduler(ledger_path=led, device="cpu",
                                checkpoint_dir=str(tmp_path / "ck2")),
                  resume=True)
    assert r2.report.clean
    assert r2.report.data["resume"]["deduped"] == 3
    assert r2.report.data["resume"]["from_ledger"] == 0
    for row in r2.report.data["cells"]:
        assert row["status"] == "done"
        assert row["summary"]["done_count"] > 0
    # the deduped rows equal the full campaign's rows of the same specs
    full = {r["spec_digest"]: r for r in port_run[0].report.data["cells"]}
    for row in r2.report.data["cells"][:3]:
        want = dict(full[row["spec_digest"]])
        for k in ("cell", "axes"):
            want.pop(k), row.pop(k)
        assert row == want
    ck = str(tmp_path / "ck3")
    run_grid(g1, Scheduler(ledger_path=str(tmp_path / "x.jsonl"),
                           checkpoint_dir=ck, launcher=_killer(2),
                           max_retries=0, retry_backoff_s=0.0,
                           device="cpu"),
             max_wave=2)
    g_edited = _grid(axes=(GRID["axes"][0],),
                     base={**GRID["base"], "sim_ms": 240})
    with pytest.raises(ValueError, match="grid"):
        run_grid(g_edited, Scheduler(ledger_path=led, checkpoint_dir=ck,
                                     device="cpu"), resume=True)


@pytest.mark.slow
def test_matrix_campaign_kill_resume_with_journal(tmp_path):
    """tests/test_crash.py:322 in the port: the crash tool's chaos-axis
    campaign, hard-stopped with finished cells, a mid-run group
    (checkpoint) AND queued-but-unlaunched cells (journal entries
    only); a fresh scheduler and `run_grid(resume=True)` recover all
    three, and the report and states equal the uninterrupted run's."""
    from tools.crash_test import CRASH_GRID, normalize_report

    from wittgenstein_tpu_torch.serve.journal import SubmissionJournal
    g = SweepGrid.from_json(CRASH_GRID)
    p = plan(g)
    led = str(tmp_path / "led.jsonl")
    ck, jd = str(tmp_path / "ck"), str(tmp_path / "journal")
    ref = run_grid(g, Scheduler(ledger_path=str(tmp_path / "ref.jsonl"),
                                device="cpu"), plan_=p)
    assert ref.report.clean
    crashed = run_grid(g, Scheduler(
        ledger_path=led, checkpoint_dir=ck, journal_dir=jd,
        launcher=_killer(4), max_retries=0, retry_backoff_s=0.0,
        device="cpu"), plan_=p, max_wave=2)
    assert 0 < crashed.report.data["cells_done"] < len(p.cells)
    assert os.listdir(ck)
    resumed = run_grid(g, Scheduler(ledger_path=led, checkpoint_dir=ck,
                                    journal_dir=jd, device="cpu"),
                       plan_=p, resume=True)
    rinfo = resumed.report.data["resume"]
    assert rinfo["journal_replayed"] >= 1
    assert rinfo["resumed_requests"] >= 1
    assert resumed.report.clean
    assert normalize_report(resumed.report.to_json()) == \
        normalize_report(ref.report.to_json())
    from torch.utils import _pytree as pytree
    for cid, st in resumed.states.items():
        for a, b in zip(pytree.tree_leaves(st),
                        pytree.tree_leaves(ref.states[cid])):
            assert torch.equal(a, b), cid
    assert not os.listdir(ck)
    assert SubmissionJournal(jd).lag() == 0
