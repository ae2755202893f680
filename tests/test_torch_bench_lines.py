"""`bench_torch.py`'s Dfinity, P2PFlood and SanFermin lines end to end
on the CPU at tiny sizes, each passing its check with its JSON line in
`bench.py`'s shape: `bench_quiet`'s Dfinity (31 nodes, 2 seeds,
fast-forwarded) and P2PFlood (32 nodes, 2 seeds), `tools/
bench_suite.py`'s Dfinity line with 40 attesters (one run, 2,000 ticks,
fast-forwarded) and its SanFermin line at 8 nodes (one run, 500 ms)."""

import json

import pytest
import torch

import bench_torch


def _line(capsys, argv):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert bench_torch.main(argv + ["--device", "cpu", "--reps", "1"]) \
            == 0
    finally:
        torch.set_num_threads(threads)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_quiet_dfinity_line(capsys):
    line = _line(capsys, ["--proto", "dfinity", "--seeds", "2", "--ms", "400",
                          "--fast-forward"])
    assert line["metric"] == "dfinity_31n_2seeds_agg_sim_ms_per_sec_ff"
    assert (line["engine"], line["superstep"], line["chunk"]) == (
        "fast_forward", 2, 200)
    assert 0 < line["skipped_ms"] < line["sim_ms"] == 400
    assert line["progress"] > 0 and line["dropped"] == 0


def test_quiet_p2pflood_line(capsys):
    line = _line(capsys, ["--proto", "p2pflood", "--nodes", "32", "--seeds",
                          "2", "--ms", "200"])
    assert line["metric"] == "p2pflood_32n_2seeds_agg_sim_ms_per_sec"
    assert (line["engine"], line["superstep"]) == ("vmapped", 2)
    assert line["progress"] > 0 and line["dropped"] == 0


def test_tracked_dfinity_line(capsys):
    """bench_suite's Dfinity line scaled to 40 attesters in committees of
    10: one run, its checks (no drops, heads within one, a highest head
    of at least 5 at 2,000 ticks)."""
    line = _line(capsys, ["--proto", "dfinity", "--attesters", "40",
                          "--ms", "2000", "--fast-forward"])
    assert line["metric"] == "dfinity_61n_1seeds_agg_sim_ms_per_sec_ff"
    assert (line["engine"], line["chunk"], line["sim_ms"]) == (
        "fast_forward", 2000, 2000)
    assert line["progress"] >= 5 and \
        line["progress"] - line["height_min"] <= 1
    assert line["dropped"] == line["arena_dropped"] == 0


def test_tracked_sanfermin_line(capsys):
    """bench_suite's SanFermin line at 8 nodes: one run at K=2, no drops,
    at most 2% stranded."""
    line = _line(capsys, ["--proto", "sanfermin", "--nodes", "8", "--ms",
                          "500"])
    assert line["metric"] == "sanfermin_8n_1seeds_agg_sim_ms_per_sec"
    assert (line["engine"], line["superstep"], line["chunk"]) == (
        "scan", 2, 500)
    assert line["dropped"] == 0 and line["stranded_pct"] <= 2
    for argv in (["--proto", "sanfermin", "--fast-forward"],
                 ["--proto", "sanfermin", "--seeds", "2"],
                 ["--proto", "p2pflood", "--attesters", "40"]):
        with pytest.raises(SystemExit):
            bench_torch.main(argv)
