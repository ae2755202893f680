"""The port's command lines (`wittgenstein_tpu_torch/cli/`), run through
their ``main(argv)`` with ``--device cpu``: the twins of the JAX tools'
tests of tests/test_audit.py, test_divergence.py and test_programs.py;
`chaos` and `timeline` against the JAX tools' own output on the same
arguments; `serve_bench`'s line against the JAX tool's keys.  The
campaign tools, `bench_suite` and `serve_load` are in
tests/test_torch_cli_campaign.py.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from wittgenstein_tpu_torch.cli import (audit, chaos, divergence, programs,
                                        serve_bench, timeline)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _ledger_in_tmp(monkeypatch, tmp_path):
    """The tools (the JAX ones too) and a scheduler without
    ``ledger_path`` append to the shared run ledger under the checkout;
    here it is a temporary file."""
    from wittgenstein_tpu.obs import ledger as jledger
    from wittgenstein_tpu_torch.obs import ledger
    monkeypatch.setattr(ledger, "LEDGER_PATH", tmp_path / "ledger.jsonl")
    monkeypatch.setattr(jledger, "LEDGER_PATH", tmp_path / "jledger.jsonl")


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


# ------------------------------------------------------------- audit

def test_ledger_round_trip(tmp_path):
    """Twin of tests/test_audit.py::test_ledger_round_trip on the port's
    ledger (the rows `cli/audit.py` appends)."""
    from wittgenstein_tpu_torch.obs import ledger
    path = tmp_path / "ledger.jsonl"
    line = {"metric": "m", "value": 12.5, "unit": "sim_ms/s",
            "sim_ms": 1000, "superstep": 2, "batch": 4,
            "audit": {"clean": True, "total": 0},
            "engine_metrics": {"totals": {"msg_sent": 7}}}
    mani = ledger.manifest_from_bench(line, config={"n": 64, "k": 2})
    assert mani.audit_clean is True
    assert mani.metrics_digest and mani.audit_digest
    assert mani.config_digest == ledger.digest({"n": 64, "k": 2})
    assert ledger.append(mani, path) == str(path)
    ledger.append(mani, path)                   # append-only: 2 rows
    rows = ledger.read_all(path)
    assert len(rows) == 2
    assert dataclasses.asdict(rows[0]) == dataclasses.asdict(mani)
    with open(path, "a") as f:                  # a torn tail is skipped
        f.write("{not json\n")
    assert len(ledger.read_all(path)) == 2


def test_audit_cli_clean_and_violated(capsys):
    rc = audit.main(["--proto", "pingpong", "--nodes", "32", "--ms",
                     "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "CLEAN" in out
    rc = audit.main(["--proto", "pingpong", "--nodes", "32", "--ms", "64",
                     "--inject", "37:nodes.msg_sent:5:-1048576",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "counter_monotone" in out and "ms 37" in out
    # config errors are exit code 2
    assert audit.main(["--proto", "nope", "--device", "cpu"]) == 2
    assert audit.main(["--proto", "pingpong", "--inject", "bad",
                       "--device", "cpu"]) == 2


# -------------------------------------------------------- divergence

def test_variant_helpers_and_cli_parsing():
    from wittgenstein_tpu_torch.obs.diff import (build_variant,
                                                 variant_granularity)
    parse_variant = divergence.parse_variant
    assert parse_variant("superstep=4,batched") == {"superstep": 4,
                                                    "batched": True}
    assert parse_variant("fast_forward") == {"fast_forward": True}
    assert parse_variant("") == {}
    with pytest.raises(ValueError, match="unknown variant key"):
        parse_variant("warp=9")
    assert variant_granularity({"superstep": 1}) == 1
    assert variant_granularity({"batched": True}) == 2
    assert variant_granularity({"superstep": 4, "batched": True}) == 4
    pp = divergence.make_protocol("pingpong", 32, None, "cpu")
    with pytest.raises(ValueError, match="unknown variant keys"):
        build_variant(pp, 32, {"warp": 9})
    with pytest.raises(ValueError, match="unknown protocol"):
        divergence.make_protocol("nope", 32, None, "cpu")


def test_make_protocol_equals_the_jax_tools():
    """`make_protocol` builds the JAX tool's configurations: the same
    config for every protocol it knows."""
    from tools import divergence as jdiv
    for name, lat in (("handel", None), ("pingpong", None),
                      ("pingpong", "NetworkFixedLatency(16)"),
                      ("p2pflood", None)):
        mine = divergence.make_protocol(name, 64, lat, "cpu")
        theirs = jdiv.make_protocol(name, 64, lat)
        for field in ("n", "horizon", "inbox_cap", "payload_words"):
            assert getattr(mine.cfg, field) == getattr(theirs.cfg, field), \
                (name, field)


def test_cli_end_to_end_no_divergence(capsys):
    rc = divergence.main(["--proto", "pingpong", "--nodes", "32", "--ms",
                          "96", "--chunk", "32", "--a", "superstep=1",
                          "--b", "superstep=2", "--no-trace",
                          "--device", "cpu"])
    assert rc == 0
    assert "bit-identical" in capsys.readouterr().out


# ------------------------------------------------------------- chaos

#: a churn and a loss window on PingPong(32): a real impact in 80 ms
CHAOS_ARGS = ["--proto", "pingpong", "--nodes", "32", "--ms", "80",
              "--churn", "3:20:60", "--loss", "0:80:250"]


def test_chaos_cli_equals_the_jax_tool(capsys):
    """The same schedule through the JAX tool and the port's: the same
    text (the schedule, K=1 against K=2 bit-identity, the impact
    against the fault-free run, the audit verdict), exit 0 both."""
    from tools import chaos as jchaos
    assert jchaos.main(CHAOS_ARGS) == 0
    theirs = capsys.readouterr().out
    assert chaos.main(CHAOS_ARGS + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert mine == theirs
    assert "bit-identical across variants" in mine and "-1)" in mine


def test_chaos_cli_zero_residue_and_config_errors(capsys):
    assert chaos.main(["--proto", "pingpong", "--nodes", "32", "--ms",
                       "40", "--device", "cpu"]) == 0
    assert "zero-residue" in capsys.readouterr().out
    assert chaos.main(["--churn", "bad", "--device", "cpu"]) == 2
    assert chaos.main(["--churn", "3:20", "--device", "cpu"]) == 2
    assert "config error" in capsys.readouterr().err


# ---------------------------------------------------------- timeline

def test_timeline_cli_equals_the_jax_tool(tmp_path, capsys):
    """Span logs of an instrumented port scheduler (one of them with a
    torn tail), rendered by the port's and the JAX tool: the same
    summary text and the same Perfetto file; no span rows is exit 2."""
    from tools import timeline as jtimeline
    from wittgenstein_tpu_torch.serve import ScenarioSpec, Scheduler
    from wittgenstein_tpu_torch.serve.instrument import Instrumentation
    run = tmp_path / "run"
    run.mkdir()
    ins = Instrumentation(span_path=run / "spans-w0.jsonl", worker="w0")
    sch = Scheduler(instrument=ins, device="cpu",
                    ledger_path=tmp_path / "l.jsonl")
    sch.submit(ScenarioSpec(protocol="PingPong", params={"node_count": 32},
                            seeds=(0,), sim_ms=80, chunk_ms=40,
                            obs=("metrics",)))
    sch.run_pending()
    with open(run / "spans-w0.jsonl", "ab") as f:   # a SIGKILL's tail
        f.write(b'{"name": "serve.chunk", "t0": 1.0, "du')
    capsys.readouterr()
    outs = []
    for cli in (timeline, jtimeline):
        out = tmp_path / f"{cli.__name__.split('.')[-1]}-{len(outs)}.json"
        assert cli.main([str(run), "--out", str(out)]) == 0
        text = capsys.readouterr().out
        outs.append((text.split("\n", 1)[1], out.read_text()))
    assert outs[0] == outs[1]
    assert "serve.chunk" in outs[0][0] and "top wall consumers" in \
        outs[0][0]
    assert json.loads(outs[0][1])["traceEvents"]
    assert timeline.main([str(tmp_path / "empty")]) == 2


# ------------------------------------------------------------ programs

def test_cli_programs(tmp_path, capsys):
    """Twin of tests/test_programs.py::test_tools_programs_cli."""
    from wittgenstein_tpu_torch.obs.programs import ProgramCatalog
    assert programs.main([str(tmp_path / "missing")]) == 2
    cat = ProgramCatalog(path=tmp_path / "programs-w0.jsonl")
    cat.record_program("kx", "metrics", lower_wall_s=0.0,
                       compile_wall_s=0.5,
                       memory={"temp_bytes": 1024,
                               "argument_bytes": 4096},
                       cost={"launches": {"route": 40}})
    capsys.readouterr()
    assert programs.main([str(tmp_path)]) == 0         # directory glob
    out = capsys.readouterr().out
    assert "kx" in out and "top compile-wall" in out
    assert "ratio=0.25" in out and "route=40" in out
    assert programs.main([str(tmp_path / "programs-w0.jsonl"),
                          "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["count"] == 1 and rep["drift"][0]["temp_ratio"] == 0.25


# --------------------------------------------------- the serve benches

def test_serve_bench_line_has_the_jax_tools_keys(monkeypatch):
    """`serve_bench` at PingPong(64), 240 ms: the warm leg a registry
    hit, and the line's keys the JAX tool's (same nodes and span)."""
    from tools import serve_bench as jbench
    out = io.StringIO()
    with redirect_stdout(out):
        assert serve_bench.main(["64", "240", "--device", "cpu"]) == 0
    (mine,) = _json_lines(out.getvalue())
    monkeypatch.setattr("sys.argv", ["serve_bench.py", "64", "240"])
    out = io.StringIO()
    with redirect_stdout(out):
        jbench.main()
    (theirs,) = _json_lines(out.getvalue())
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["registry"]) == sorted(theirs["registry"])
    assert (mine["metric"], mine["sim_ms"], mine["platform"],
            mine["compile_cache"]) == \
        ("serve_warm_submit_latency_ms_pingpong_64n", 240, "cpu", "off")
    assert mine["registry"]["hits"] == theirs["registry"]["hits"] >= 1
    assert mine["registry"]["misses"] == theirs["registry"]["misses"]
