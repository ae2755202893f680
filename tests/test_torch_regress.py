"""The port's bench-history gate (`wittgenstein_tpu_torch/obs/regress.py`,
`cli/regress.py`): the twins of tests/test_regress.py's 15 tests, one
parity test (the same history through the JAX and the port's
`gate`/`detect_regressions`/`format_findings`: findings, exit code and
text equal, tolerance 0) and the two directions of a shared history (a
history written by either package's `BenchHistory` gates the same way
in the other).
"""

import json

import pytest
import torch

from wittgenstein_tpu.obs import regress as jregress
from wittgenstein_tpu_torch.cli import regress as cli
from wittgenstein_tpu_torch.obs import regress
from wittgenstein_tpu_torch.obs.regress import (BenchHistory,
                                                detect_regressions, gate,
                                                read_history,
                                                series_direction,
                                                stage_measures)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill(h, stage="route", rounds=5, wall=0.5, value=100.0,
          host=None, metric="route_msgs_per_sec", digest="abc",
          jitter=0.0):
    for r in range(rounds):
        h.append(stage=stage, round_id=f"base{r}",
                 measures={"value": value + jitter * r,
                           "wall_median_s": wall + 0.01 * jitter * r},
                 config_digest=digest, backend="cpu", host=host,
                 metric=metric)


def _rows(values, metric="x_per_sec", rnd="r"):
    return [{"stage": "s", "config_digest": "d", "backend": "cpu",
             "host": "h", "round": f"{rnd}{i}", "metric": metric,
             "measures": {"value": v}} for i, v in enumerate(values)]


# ------------------------------------------------------------- the gate

def test_wall_inflation_exits_1_naming_stage(tmp_path):
    p = tmp_path / "hist.jsonl"
    h = BenchHistory(p)
    _fill(h, jitter=1.0)
    h.append(stage="route", round_id="new",
             measures={"value": 101.0, "wall_median_s": 1.0},
             config_digest="abc", backend="cpu",
             metric="route_msgs_per_sec")
    code, findings, summary = gate(p)
    assert code == 1 and summary["regressions"] == 1
    [f] = findings
    assert f["stage"] == "route" and f["series"] == "wall_median_s"
    assert f["direction"] == "down" and f["ratio"] == pytest.approx(
        1.0 / 0.52, rel=0.05)
    assert "route.wall_median_s" in regress.format_findings(findings)


def test_clean_rerun_exits_0(tmp_path):
    p = tmp_path / "hist.jsonl"
    h = BenchHistory(p)
    _fill(h, jitter=1.0)
    h.append(stage="route", round_id="new",
             measures={"value": 103.0, "wall_median_s": 0.53},
             config_digest="abc", backend="cpu",
             metric="route_msgs_per_sec")
    code, findings, summary = gate(p)
    assert code == 0 and not findings
    assert summary["series_checked"] == 2


def test_throughput_drop_is_a_regression(tmp_path):
    p = tmp_path / "hist.jsonl"
    h = BenchHistory(p)
    _fill(h)
    h.append(stage="route", round_id="new", measures={"value": 50.0},
             config_digest="abc", backend="cpu",
             metric="route_msgs_per_sec")
    code, findings, _ = gate(p)
    assert code == 1
    assert findings[0]["series"] == "value"
    assert findings[0]["direction"] == "up"     # higher-is-better fell


@pytest.mark.parametrize("case", ["cross_host", "config_digest"])
def test_rows_of_another_key_never_compared(tmp_path, case):
    """Twins of test_cross_host_rows_never_compared and
    test_config_digest_partitions_baselines: a new round under another
    host fingerprint or config digest has NO baseline."""
    p = tmp_path / "hist.jsonl"
    h = BenchHistory(p)
    if case == "cross_host":
        _fill(h, host="laptop/arm64")
        h.append(stage="route", round_id="new",
                 measures={"value": 1.0, "wall_median_s": 99.0},
                 config_digest="abc", backend="cpu", host="card/x86_64",
                 metric="route_msgs_per_sec")
    else:
        _fill(h, digest="k1-config", wall=0.1)
        h.append(stage="route", round_id="new",
                 measures={"wall_median_s": 5.0},
                 config_digest="k4-config", backend="cpu",
                 metric="route_msgs_per_sec")
    code, findings, summary = gate(p)
    assert code == 0 and not findings
    assert summary["series_checked"] == 0
    if case == "cross_host":
        assert summary["series_skipped_no_baseline"] == 2


# ------------------------------------------------------------- detector

def test_directions():
    assert series_direction("value", "route_msgs_per_sec") == "up"
    assert series_direction("value", "analysis_smoke_wall_s") == "down"
    assert series_direction("wall_median_s", None) == "down"
    assert series_direction("wall_s", "x_events") == "down"
    # count-like series are not gated
    assert series_direction("value", "trace_smoke_events") is None
    assert series_direction("value", None) is None


def test_stage_measures_extraction():
    res = {"metric": "m", "value": 7, "wall_median_s": 0.25,
           "wall_s": 1.5, "reps": 2, "unit": "x",
           "crosscheck": "sync_override"}
    assert stage_measures(res) == {"value": 7.0, "wall_s": 1.5,
                                   "wall_median_s": 0.25}
    assert stage_measures({"metric": "m", "error": "boom"}) == {}
    assert stage_measures({"value": True}) == {}    # bools are not data


def test_mad_threshold_survives_baseline_outlier():
    hist = _rows([100.0, 101.0, 99.0, 100.0, 30.0])
    findings, checked = detect_regressions(hist, _rows([97.0], rnd="n"))
    assert checked == 1 and not findings    # median ~100, MAD robust


@pytest.mark.parametrize("value,flagged", [(95.0, False), (85.0, True)])
def test_rel_floor_gates_zero_mad_history(value, flagged):
    """Within the 10% floor: clean; past it: flagged."""
    findings, _ = detect_regressions(_rows([100.0] * 5),
                                     _rows([value], rnd="n"))
    assert bool(findings) == flagged


def test_min_baseline_skips_thin_history():
    findings, checked = detect_regressions(_rows([100.0] * 2),
                                           _rows([1.0], rnd="n"))
    assert checked == 0 and not findings


# ----------------------------------------------------------- durability

def test_torn_tail_tolerated(tmp_path):
    p = tmp_path / "hist.jsonl"
    h = BenchHistory(p)
    _fill(h, rounds=3)
    with open(p, "ab") as f:        # the SIGKILL mid-append shape
        f.write(b'{"schema": 1, "stage": "route", "measur')
    assert len(read_history(p)) == 3
    assert gate(p)[0] == 0


def test_non_history_rows_skipped(tmp_path, capsys):
    p = tmp_path / "hist.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps({"not": "a history row"}) + "\n")
        f.write(json.dumps({"stage": "s", "round": "r",
                            "measures": {"value": 1.0}}) + "\n")
    assert len(read_history(p)) == 1
    assert "not a history row" in capsys.readouterr().err


def test_append_error_degrades_loudly(tmp_path, capsys):
    h = BenchHistory(tmp_path)      # a DIRECTORY: open() fails
    h.append(stage="s", round_id="r", measures={"value": 1.0})
    assert h.stats()["write_errors"] == 1
    assert "regress" in capsys.readouterr().err


# ------------------------------------------------------------------ CLI

def test_exit_2_on_missing_or_unknown(tmp_path):
    assert gate(tmp_path / "missing.jsonl")[0] == 2
    p = tmp_path / "hist.jsonl"
    BenchHistory(p).append(stage="s", round_id="r",
                           measures={"value": 1.0})
    assert gate(p, round_id="nope")[0] == 2


def test_cli_regress(tmp_path, capsys):
    """Twin of test_tools_regress_cli, on `cli/regress.py`."""
    p = tmp_path / "hist.jsonl"
    h = BenchHistory(p)
    _fill(h, jitter=1.0)
    h.append(stage="route", round_id="bad",
             measures={"wall_median_s": 2.0}, config_digest="abc",
             backend="cpu", metric="route_msgs_per_sec")
    capsys.readouterr()
    assert cli.main([str(p)]) == 1
    out = capsys.readouterr().out
    assert "REGRESSION route.wall_median_s" in out
    assert cli.main([str(p), "--json"]) == 1
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["exit"] == 1
    assert verdict["findings"][0]["stage"] == "route"
    assert cli.main([str(tmp_path / "missing.jsonl")]) == 2


# ------------------------------------------------- against the JAX gate

def _mixed_history(h, jitter=1.0):
    """Several stages, hosts and digests, one regressed round and one
    unknown-host round: every branch of the detector."""
    _fill(h, jitter=jitter)
    _fill(h, stage="serve_smoke", metric="serve_smoke_requests",
          wall=2.0, value=2.0, jitter=0.5)
    _fill(h, stage="route", host="other/arm64", digest="abc", wall=9.0)
    _fill(h, stage="pingpong_1000n", metric="pingpong_agg_sim_ms_per_sec",
          value=800.0, wall=1.2, jitter=3.0, digest="pp")
    for stage, measures, metric, digest, host in (
            ("route", {"value": 70.0, "wall_median_s": 0.9},
             "route_msgs_per_sec", "abc", None),
            ("serve_smoke", {"value": 2.0, "wall_median_s": 2.02},
             "serve_smoke_requests", "abc", None),
            ("route", {"value": 1.0, "wall_median_s": 99.0},
             "route_msgs_per_sec", "abc", "new/x86_64"),
            ("pingpong_1000n", {"value": 801.0, "wall_median_s": 1.3},
             "pingpong_agg_sim_ms_per_sec", "pp", None)):
        h.append(stage=stage, round_id="new", measures=measures,
                 config_digest=digest, backend="cpu", host=host,
                 metric=metric)


def test_gate_equals_the_jax_gate(tmp_path):
    """The same history through both packages: findings, exit code,
    summary and text equal, tolerance 0; also with the detector's knobs
    moved, and for an unknown round."""
    p = tmp_path / "hist.jsonl"
    _mixed_history(BenchHistory(p))
    for kw in ({}, {"k": 3, "nsigma": 2.0, "rel_floor": 0.05,
                    "min_baseline": 2}):
        mine, theirs = gate(p, **kw), jregress.gate(p, **kw)
        assert mine == theirs
        assert mine[0] == 1 and len(mine[1]) >= 2
        assert regress.format_findings(mine[1]) == \
            jregress.format_findings(theirs[1])
    assert gate(p, round_id="base2") == jregress.gate(p, round_id="base2")
    assert gate(p, round_id="nope") == jregress.gate(p, round_id="nope")
    hist = read_history(p)
    assert hist == jregress.read_history(p)
    new = [r for r in hist if r["round"] == "new"]
    assert detect_regressions(hist[:-4], new) == \
        jregress.detect_regressions(hist[:-4], new)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_history_of_either_package_gates_in_the_other(tmp_path, writer):
    """A history written by one package's `BenchHistory` gates the same
    way in the other (one row schema, one host fingerprint)."""
    p = tmp_path / "hist.jsonl"
    ours = writer == "port"
    h = BenchHistory(p) if ours else jregress.BenchHistory(p)
    _mixed_history(h)
    assert regress.host_fingerprint() == jregress.host_fingerprint()
    reader = jregress if ours else regress
    code, findings, summary = reader.gate(p)
    assert (code, findings, summary) == \
        (regress if ours else jregress).gate(p)
    assert code == 1 and {f["stage"] for f in findings} == {"route"}
