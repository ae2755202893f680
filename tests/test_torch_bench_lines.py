"""`bench_torch.py`'s Dfinity, P2PFlood and SanFermin lines end to end
on the CPU at tiny sizes, each passing its check with its JSON line in
`bench.py`'s shape: `bench_quiet`'s Dfinity (31 nodes, 2 seeds,
fast-forwarded) and P2PFlood (32 nodes, 2 seeds), `tools/
bench_suite.py`'s Dfinity line with 40 attesters (one run, 2,000 ticks,
fast-forwarded) and its SanFermin line at 8 nodes (one run, 500 ms);
Casper IMD's line with 5 attesters a round (2 seeds, 402 ticks: the WF
producer's first block) and `try_miner`'s ETHPoW batch with 5 miners (2
seeds from 1, 200 ticks, its CSV row printed); and phase P's HandelEth2
(16 nodes, fast-forwarded to 1,000 ms), P2PHandel (40 signers and 8
relays, 500 ms) and OptimisticP2PSignature (64 nodes, 200 ms), 2 seeds
each.  The obs blocks (``engine_metrics``, ``trace``, ``audit``) of
one PingPong line equal the JAX `bench.py`'s blocks for the same
configuration; the other lines run with those passes off."""

import json

import pytest
import torch

import bench_torch


def _line(capsys, argv, obs=False):
    """The line's JSON; without `obs` its un-timed obs passes are
    switched off (the lines' checks do not read them, and each pass
    reruns the span)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    off = [] if obs else ["--no-metrics", "--no-audit"]
    try:
        assert bench_torch.main(argv + ["--device", "cpu", "--reps", "1"]
                                + off) == 0
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


def test_casper_line(capsys):
    line = _line(capsys, ["--proto", "casper", "--attesters", "5", "--seeds",
                          "2", "--ticks", "402"])
    assert line["metric"] == "casper_23n_2seeds_agg_sim_ms_per_sec"
    assert (line["engine"], line["superstep"], line["sim_ms"]) == (
        "vmapped", 2, 402)
    assert line["progress"] == 1 and line["blocks"] == 2
    assert line["dropped"] == line["arena_dropped"] == 0


def test_ethpow_line(capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert bench_torch.main(["--proto", "ethpow", "--nodes", "5",
                                 "--runs", "2", "--ticks", "200",
                                 "--device", "cpu", "--reps", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["metric"] == "ethpow_5n_2seeds_agg_sim_ms_per_sec"
    assert (line["superstep"], line["sim_ms"]) == (2, 200)
    assert out[-3].startswith("miner, hashrate ratio")
    assert out[-2] == line["csv_row"]
    assert out[-2].startswith("ETHSelfishMiner/NetworkFixedLatency(1000)/")
    assert line["dropped"] == line["arena_dropped"] == 0


def test_handeleth2_line(capsys):
    """Phase P's HandelEth2 at 16 nodes, 2 seeds, fast-forwarded to 1,000
    ms: the first aggregation complete at every node, no drops."""
    line = _line(capsys, ["--proto", "handeleth2", "--nodes", "16",
                          "--seeds", "2", "--ms", "1000", "--fast-forward"])
    assert line["metric"] == "handeleth2_16n_2seeds_agg_sim_ms_per_sec_ff"
    assert (line["engine"], line["superstep"], line["chunk"]) == (
        "fast_forward", 2, 100)
    assert 0 < line["skipped_ms"] < line["sim_ms"] == 1000
    assert line["progress"] == 16 and line["heights"] == [1001]
    assert line["dropped"] == line["clamped"] == 0


def test_p2phandel_line(capsys):
    """Phase P's P2PHandel at 40 signers and 8 relays, 2 seeds, 500 ms
    dense: verifications landed, no drops."""
    line = _line(capsys, ["--proto", "p2phandel", "--nodes", "40",
                          "--seeds", "2", "--ms", "500"])
    assert line["metric"] == "p2phandel_48n_2seeds_agg_sim_ms_per_sec"
    assert (line["engine"], line["superstep"], line["chunk"]) == (
        "vmapped", 2, 500)
    assert line["progress"] > 0 and line["dropped"] == line["clamped"] == 0


def test_optimistic_line(capsys):
    """Phase P's OptimisticP2PSignature at 64 nodes (threshold 33), 2
    seeds, 200 ms: every node done, no drops; it has no fast-forward
    oracle and refuses the flag."""
    line = _line(capsys, ["--proto", "optimistic", "--nodes", "64",
                          "--seeds", "2", "--ms", "200"])
    assert line["metric"] == "optimistic_64n_2seeds_agg_sim_ms_per_sec"
    assert (line["engine"], line["superstep"]) == ("vmapped", 2)
    assert line["progress"] == 128 and line["dropped"] == 0
    with pytest.raises(SystemExit):
        bench_torch.main(["--proto", "optimistic", "--fast-forward"])


def test_obs_blocks_equal_the_jax_lines(capsys):
    """One CPU line carries the ``engine_metrics``, ``trace`` and
    ``audit`` blocks, each equal to the block `bench.py` builds for the
    same configuration (PingPong, 32 nodes, 2 seeds, 200 ms)."""
    import bench
    from wittgenstein_tpu.models.pingpong import PingPong
    line = _line(capsys, ["--proto", "pingpong", "--nodes", "32", "--seeds",
                          "2", "--ms", "200", "--trace"], obs=True)
    jp = PingPong(node_count=32)
    assert line["engine_metrics"] == bench._collect_engine_metrics(
        jp, 2, 200)
    assert line["trace"] == bench._collect_engine_trace(jp, 200, 1 << 16)
    assert line["audit"] == bench._collect_engine_audit(jp, 200)
    assert line["audit"]["clean"] and not line["trace"]["truncated"]
    assert line["engine_metrics"]["metrics_seeds"] == 2
    off = _line(capsys, ["--proto", "pingpong", "--nodes", "32", "--seeds",
                         "2", "--ms", "200"])
    assert not {"engine_metrics", "trace", "audit"} & set(off)
    with pytest.raises(ValueError, match="--trace-cap"):
        bench_torch.main(["--proto", "pingpong", "--nodes", "32", "--ms",
                          "200", "--device", "cpu", "--trace",
                          "--trace-cap", "100"])
