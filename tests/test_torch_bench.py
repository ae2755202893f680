"""The port's benchmark line: `utils/measure.timed_chunks` (median of the
repetitions, the synchronous cross-check and its override) on a stand-in
step, and `bench_torch.py` end to end on the CPU at a small size (32
nodes, 2 seeds, 600 ms: converged, no drops), its JSON line in
`bench.py`'s shape."""

import argparse
import json
import time

import pytest
import torch

import bench_torch
from wittgenstein_tpu_torch.utils.measure import timed_chunks


class _Clock:
    """A state's clock whose read-back takes `delay` seconds, as a
    device synchronisation does."""

    def __init__(self, delay):
        self.delay = delay

    def sum(self):
        return self

    def cpu(self):
        return self

    def __int__(self):
        time.sleep(self.delay)
        return 0


class _Nets:
    def __init__(self, delay):
        self.time = _Clock(delay)


def _measure(step_s, sync_s):
    checks = []

    def step(nets, ps):
        time.sleep(step_s)
        return nets, ps

    def check(nets, ps):
        checks.append(1)
        return {"checked": len(checks)}

    return timed_chunks(step, lambda: (_Nets(sync_s), None), steps=4,
                        batch=3, chunk_ms=10, check=check, reps=3), checks


def test_timed_chunks_protocol():
    res, checks = _measure(0.02, 0.0)
    assert res["crosscheck"] == "ok" and res["reps"] == 3
    assert len(checks) == 4 and res["checked"] == 4  # 3 reps + the sync one
    assert res["wall_min_s"] <= res["wall_median_s"] <= res["wall_max_s"]
    assert res["value"] == pytest.approx(3 * 4 * 10 / res["wall_median_s"],
                                         rel=0.01)


def test_timed_chunks_sync_override():
    """Chunks that return before the work is done (only the read-back
    waits) fail the cross-check: the synchronous rate is reported."""
    res, _ = _measure(0.0, 0.02)
    assert res["crosscheck"] == "sync_override"
    assert res["value"] == res["sync_rate"]


def test_bench_torch_cpu_line(capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert bench_torch.main(["--device", "cpu", "--nodes", "32",
                                 "--seeds", "2", "--ms", "600",
                                 "--reps", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "handel_32n_2seeds_agg_sim_ms_per_sec"
    assert (line["platform"], line["engine"], line["superstep"]) == (
        "cpu", "batched", 2)
    assert line["sim_ms"] == 600 and line["value"] > 0
    assert line["frac_done"] > 0.99
    assert line["dropped"] == line["clamped"] == line["evicted"] == 0


def test_bench_torch_pingpong_cpu_line(capsys):
    """`--proto pingpong`, `bench.py`'s quiet-protocol line, at a small
    size: 64 nodes, 2 seeds, 400 ms in 200-ms chunks at K = 2."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert bench_torch.main(["--proto", "pingpong", "--device", "cpu",
                                 "--nodes", "64", "--seeds", "2", "--ms",
                                 "400", "--reps", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "pingpong_64n_2seeds_agg_sim_ms_per_sec"
    assert (line["platform"], line["engine"], line["superstep"]) == (
        "cpu", "vmapped", 2)
    assert line["sim_ms"] == 400 and line["value"] > 0
    assert line["progress"] > 0
    assert line["dropped"] == line["bc_dropped"] == 0


def _line(capsys, argv):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert bench_torch.main(argv + ["--device", "cpu", "--reps", "1"]) \
            == 0
    finally:
        torch.set_num_threads(threads)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_torch_gsf_cpu_line(capsys):
    """`--proto gsf`, `tools/bench_suite.py`'s GSF line, at a small size:
    32 nodes, 2 seeds, 500 ms in 250-ms chunks at K=1."""
    line = _line(capsys, ["--proto", "gsf", "--nodes", "32", "--seeds",
                          "2", "--ms", "500"])
    assert line["metric"] == "gsf_32n_2seeds_agg_sim_ms_per_sec"
    assert (line["platform"], line["engine"], line["superstep"],
            line["chunk"], line["sim_ms"]) == ("cpu", "vmapped", 1, 250, 500)
    assert line["value"] > 0 and line["frac_done"] > 0.99
    assert line["dropped"] == line["clamped"] == 0
    with pytest.raises(SystemExit):
        bench_torch.main(["--proto", "gsf", "--fast-forward"])


@pytest.mark.parametrize("proto,argv", [
    ("handel", ["--nodes", "32", "--seeds", "2", "--ms", "600"]),
    ("pingpong", ["--nodes", "64", "--seeds", "2", "--ms", "400"])])
def test_bench_torch_fast_forward_cpu_lines(capsys, proto, argv):
    """`--fast-forward`, `bench.py`'s WTPU_FAST_FORWARD=1: the headline on
    `fast_forward_chunk_batched`, PingPong on `fast_forward_chunk` with
    the seed axis; each line passes its check and carries the skip
    counts of one repetition."""
    line = _line(capsys, ["--proto", proto, "--fast-forward"] + argv)
    assert (line["engine"], line["superstep"], line["fast_forward"]) == (
        "fast_forward", 2, True)
    assert 0 < line["skipped_ms"] < line["sim_ms"]
    assert line["jump_count"] > 0 and line["skipped_ms"] % 2 == 0
    assert line["skip_rate"] == round(line["skipped_ms"] / line["sim_ms"],
                                      3)
    assert line["value"] > 0 and line["dropped"] == 0


def test_bench_torch_scale_flags_cpu_line(capsys):
    """The tier-3 switches (`bench.py`'s WTPU_BENCH_MODE=cardinal and
    WTPU_BENCH_BOX_SPLIT) at 32 nodes, 4 seeds in batches of 2: the
    microbatched line, one timed window over both batches, converged
    with no drops, clamps or evictions."""
    line = _line(capsys, ["--mode", "cardinal", "--box-split", "2",
                          "--nodes", "32", "--seeds", "4", "--seed-batch",
                          "2", "--ms", "600"])
    assert line["metric"] == "handel_32n_4seeds_agg_sim_ms_per_sec_cardinal"
    assert (line["engine"], line["superstep"], line["microbatches"],
            line["seed_batch"]) == ("batched", 2, 2, 2)
    assert line["batch_wall_min_s"] <= line["batch_wall_max_s"]
    assert line["value"] > 0 and line["frac_done"] > 0.99
    assert line["dropped"] == line["clamped"] == line["evicted"] == 0
    with pytest.raises(SystemExit):
        bench_torch.main(["--proto", "pingpong", "--mode", "cardinal"])


@pytest.mark.parametrize("argv,params", [
    (["--nodes", "32768", "--emission", "hashed", "--pool", "0",
      "--state-split", "2"], "tier2"),
    (["--nodes", "65536", "--mode", "cardinal"], "tier3")])
def test_bench_torch_flags_map_to_the_scale_lines(argv, params):
    """`bench.py`'s environment mapping (bench.py:389-419): the tier-2
    flags give `tier2_params`, the tier-3 flags `tier3_params`."""
    from wittgenstein_tpu_torch.models import handel
    ap = argparse.ArgumentParser()
    for flag, kw in (("--nodes", dict(type=int)), ("--mode",
                     dict(default="exact")), ("--emission", {}),
                     ("--pool", dict(type=int)),
                     ("--state-split", dict(type=int))):
        ap.add_argument(flag, **kw)
    args = ap.parse_args(argv)
    want = {"mode": "exact", **getattr(handel, f"{params}_params")(
        args.nodes)}
    assert bench_torch.handel_params(args) == want
