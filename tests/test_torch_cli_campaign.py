"""The port's campaign command lines and suite (`cli/matrix.py`,
`memo.py`, `search.py`, `crash_test.py`, `bench_suite.py`,
`serve_load.py`), run through their ``main(argv)`` with ``--device
cpu``: the twins of the JAX tools' tests of tests/test_matrix.py,
test_memo.py, test_search.py and test_crash.py, two `bench_suite`
rounds gated by the port's `regress`, and `serve_load` at 12 requests.
"""

import io
import json
import pathlib
from contextlib import redirect_stdout

import pytest
import torch

from wittgenstein_tpu_torch.cli import (bench_suite, matrix, memo, search,
                                        serve_load)

REPO = pathlib.Path(__file__).resolve().parent.parent
SPEC_PATH = REPO / "tools" / "specs" / "search_loss_boundary.json"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _ledger_in_tmp(monkeypatch, tmp_path):
    """The tools and a scheduler without ``ledger_path`` append to the
    shared run ledger under the checkout; here it is a temporary file."""
    from wittgenstein_tpu_torch.obs import ledger
    monkeypatch.setattr(ledger, "LEDGER_PATH", tmp_path / "ledger.jsonl")


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


# ------------------------------------------- matrix, memo and search

def _grid(**kw):
    base = dict(
        name="t",
        base={"protocol": "PingPong", "params": {"node_count": 32},
              "seeds": [0], "sim_ms": 120, "chunk_ms": 120,
              "obs": ["metrics", "audit"]},
        axes=[{"name": "seed", "field": "seeds", "values": [[0], [1]]}])
    base.update(kw)
    return json.dumps(base)


@pytest.mark.parametrize("cli", [matrix, memo], ids=["matrix", "memo"])
def test_cli_config_error_exit_2(cli, capsys):
    """Twins of tests/test_matrix.py::test_cli_config_error_exit_2 and
    tests/test_memo.py::test_cli_memo_config_error_exit_2."""
    assert cli.main(["--grid", '{"bogus": 1}', "--device", "cpu"]) == 2
    assert "config error" in capsys.readouterr().err
    if cli is matrix:
        assert cli.main(["--grid", "not json at {all",
                         "--device", "cpu"]) == 2


def test_cli_plan_only(capsys):
    grid = _grid(axes=[
        {"name": "seed", "field": "seeds", "values": [[0], [1]]},
        {"name": "lat", "field": "latency_model",
         "values": [None, "NetworkFixedLatency(30)"]}])
    assert matrix.main(["--grid", grid, "--plan-only"]) == 0
    assert "4 cells -> 2 compile keys" in capsys.readouterr().out


def test_cli_resume_flags(capsys):
    assert matrix.main(["--grid", _grid(), "--resume",
                        "--device", "cpu"]) == 2
    assert "--checkpoint-dir" in capsys.readouterr().err


@pytest.mark.slow
def test_cli_memo_clean_exit_0(capsys):
    """Twin of tests/test_memo.py::test_cli_memo_clean_exit_0, slow as
    it is there (two full grid runs)."""
    grid = json.dumps({
        "name": "cli",
        "base": {"protocol": "PingPong", "params": {"node_count": 32},
                 "latency_model": "NetworkFixedLatency(10)",
                 "seeds": [0], "sim_ms": 80, "chunk_ms": 40,
                 "obs": ["metrics"]},
        "axes": [{"name": "chaos", "field": "fault_schedule",
                  "values": [None,
                             {"loss": [[40, 80, 500, 0, 32, 0, 32]]}],
                  "labels": ["clean", "loss"]}]})
    assert memo.main(["--grid", grid, "--quiet", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CLEAN" in out and "prefix_chunks_saved = 1" in out


def _search_spec():
    return json.dumps({
        "name": "t-search",
        "grid": {"name": "t-grid",
                 "base": {"protocol": "PingPong",
                          "params": {"node_count": 32}, "seeds": [0],
                          "sim_ms": 160, "chunk_ms": 40,
                          "obs": ["metrics", "audit"],
                          "latency_model": "NetworkFixedLatency(50)"},
                 "axes": [{"name": "loss", "field": "fault_schedule",
                           "values": [{"loss": [[40, 160, p, 0, 32, 0,
                                                 32]]}
                                      for p in range(0, 120, 20)],
                           "labels": ["p%03d" % p
                                      for p in range(0, 120, 20)]}]},
        "axis": "loss",
        "predicate": {"field": "summary.done_frac", "op": ">=",
                      "value": 0.99},
        "coarse": 2})


def test_search_cli_config_error_exit_2(capsys):
    """Twin of tests/test_search.py::test_cli_config_error_exit_2."""
    assert search.main(["--spec", '{"bogus": 1}', "--device", "cpu"]) == 2
    assert "config error" in capsys.readouterr().err
    assert search.main(["--spec", _search_spec(), "--resume",
                        "--device", "cpu"]) == 2
    assert "--checkpoint-dir" in capsys.readouterr().err
    assert search.main(["--spec", _search_spec(), "--workers", "2",
                        "--device", "cpu"]) == 2
    assert "--fleet-dir" in capsys.readouterr().err


def test_search_cli_plan_only(capsys):
    """Twin of tests/test_search.py::test_cli_plan_only (the checked-in
    boundary question)."""
    assert search.main(["--spec", str(SPEC_PATH), "--plan-only"]) == 0
    out = capsys.readouterr().out
    assert "2 slice(s) x 32 'loss' values" in out
    assert "coarse ladder" in out


@pytest.mark.slow
def test_crash_tool_kill_anywhere_bit_identical(tmp_path):
    """Twin of tests/test_crash.py's kill-anywhere pin, slow as it is
    there: `cli/crash_test.py` SIGKILLs a subprocess campaign at 5
    seeded-random wall offsets, resumes with journal and checkpoints
    every time, and the final MatrixReport is bit-identical to the
    uninterrupted run's."""
    from wittgenstein_tpu_torch.cli.crash_test import run_crash_test
    res = run_crash_test(str(tmp_path), kills=5, seed=0, device="cpu")
    assert res["ok"], res
    assert res["kills_requested"] == 5
    assert res["kills_landed"] + res["kills_missed"] == 5


# ------------------------------------------- the suite and the load

def test_bench_suite_history_and_gate(tmp_path, capsys):
    """Two `bench_suite` rounds of catalog_smoke and serve_smoke into one
    history, the second gated by ``--check-regressions``: every line
    without an error, the catalog row's CPU fields, the gate's exit 0
    (a thin history checks nothing yet), one history row a stage a
    round; an unknown stage is an error line, as in the JAX suite."""
    from wittgenstein_tpu_torch.obs.regress import read_history
    hist = str(tmp_path / "bench_history.jsonl")
    for rnd in range(2):
        argv = ["catalog_smoke", "serve_smoke", "--history", hist,
                "--device", "cpu"]
        assert bench_suite.main(argv + ["--check-regressions"] * rnd) == 0
        lines = _json_lines(capsys.readouterr().out)
        assert [ln["metric"] for ln in lines[:2]] == \
            ["catalog_smoke_programs", "serve_smoke_requests"]
        assert not any("error" in ln for ln in lines), lines
        assert lines[0]["temp_ratio"] is None and \
            lines[0]["launches"]["route"] == 0
    gate = lines[-1]
    assert gate["metric"] == "regression_gate" and gate["exit"] == 0
    rows = read_history(hist)
    assert [r["stage"] for r in rows] == ["catalog_smoke",
                                          "serve_smoke"] * 2
    assert rows[0]["config_digest"] == \
        bench_suite._stage_spec("catalog_smoke").digest()
    assert bench_suite.main(["pingpong_1000n", "--no-history",
                             "--device", "cpu"]) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["metric"] == "pingpong_1000n_agg_sim_ms_per_sec" and \
        "KeyError" in line["error"]


def test_serve_load_every_tenant_completes(tmp_path):
    """`serve_load --requests 12`: every tenant's requests complete, the
    line written to ``--out`` too."""
    out_path = tmp_path / "load.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = serve_load.main(["--requests", "12", "--out", str(out_path),
                              "--device", "cpu"])
    assert rc == 0
    (line,) = _json_lines(buf.getvalue())
    assert json.loads(out_path.read_text()) == line
    ten = line["tenancy"]
    assert ten["requests"] == ten["completed"] == 12
    assert all(t["completed"] == t["submitted"] == 4
               for t in ten["per_tenant"].values())
    assert line["platform"] == "cpu" and line["metric"] == \
        "serve_load_p99_ms"
