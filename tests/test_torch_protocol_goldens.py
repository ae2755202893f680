"""The golden digests that `chip_smoke.py` holds the port's SanFermin,
Cappos, Dfinity and P2PFlood paths against (phases S, C, D and Q), and
its Byzantine sweep point and P2P signature batches (phases B and P),
and its city-latency scenario runs and committee batches (phases L and
A): each file's schema and call, its leaf names those of the port's
state of the same configuration, and its counters; marked slow, the
quiet lines' digests recomputed from the JAX package and the port's CPU
runs of them against the files."""

import dataclasses
import json

import pytest
import torch_parity as tp

from wittgenstein_tpu_torch import convert

#: golden file -> (protocol, port size with the same leaves, box_split)
FILES = {tp.SANFERMIN_GOLDEN_FILE: ("sanfermin", 64, 2),
         tp.CAPPOS_GOLDEN_FILE: ("cappos", 64, 1),
         tp.DFINITY10K_GOLDEN_FILE: ("dfinity", 10, 1),
         tp.DFINITY_QUIET_FILE: ("dfinity", 10, 1),
         tp.P2PFLOOD_QUIET_FILE: ("p2pflood", 64, 1)}
#: the quiet goldens' committed paths
COMMITTED = {"DFINITY_QUIET_FILE": tp.DFINITY_QUIET_FILE,
             "P2PFLOOD_QUIET_FILE": tp.P2PFLOOD_QUIET_FILE}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _leaf_names(protocol, n, box_split):
    proto = tp.port_protocol(protocol, n)
    proto.cfg = dataclasses.replace(proto.cfg, box_split=box_split)
    return sorted(convert.state_digest(*convert.to_numpy(*proto.init(0))))


def _entries(golden):
    """(leaves, counts) of every checkpoint and seed of a golden."""
    if "seeds" in golden:
        return list(zip(golden["seeds"], golden["counts"]))
    if isinstance(golden.get("ms"), dict):
        return [(v["leaves"], v["counts"]) for v in golden["ms"].values()]
    ff = golden.get("fast_forward", {})
    return [(golden["leaves"], golden["counts"])] + (
        [(ff["leaves"], ff["counts"])] if "leaves" in ff else [])


@pytest.mark.parametrize("path", sorted(FILES))
def test_golden_schema(path):
    golden = _load(path)
    assert golden["call"].startswith("jax.jit(")
    assert "scan_chunk(proto," in golden["call"]
    assert {"wall_s", "peak_rss_gb"} <= set(golden["generator"])
    names = _leaf_names(*FILES[path])
    entries = _entries(golden)
    assert entries
    for leaves, counts in entries:
        assert sorted(leaves) == names
        assert counts["dropped"] == counts["clamped"] == 0
        assert counts["sp_dropped"] == 0
    assert len({json.dumps(x, sort_keys=True) for x, _ in entries}) == \
        len(entries)


def test_golden_calls_and_depths():
    """Each golden at the depth and with the skip counts its phase
    reads."""
    sf = _load(tp.SANFERMIN_GOLDEN_FILE)
    assert sorted(map(int, sf["ms"])) == list(tp.SANFERMIN_MS)
    assert sf["config"].startswith(f"SanFermin(node_count={tp.SANFERMIN_N}")
    assert _load(tp.CAPPOS_GOLDEN_FILE)["ms"] == tp.CAPPOS_MS
    d10k = _load(tp.DFINITY10K_GOLDEN_FILE)
    assert d10k["ticks"] == tp.DFINITY10K_TICKS
    assert d10k["counts"]["arena_dropped"] == 0
    ff = d10k["fast_forward"]
    assert "fast_forward_chunk(proto, 400, superstep=2)" in ff["call"]
    assert ff["ticks"] == tp.DFINITY10K_FF_TICKS
    assert len(ff["chunks"]) == tp.DFINITY10K_FF_TICKS // tp.DFINITY10K_TICKS
    assert ff["skipped_ms"] == sum(c["skipped_ms"] for c in ff["chunks"])
    assert 0 < ff["chunks"][0]["skipped_ms"] < tp.DFINITY10K_TICKS
    assert ff["counts"]["arena_dropped"] == 0
    quiet = _load(tp.DFINITY_QUIET_FILE)
    assert quiet["ms"] == tp.QUIET_MS
    assert len(quiet["seeds"]) == tp.QUIET_SEEDS
    ff = quiet["fast_forward"]
    assert len(ff["chunks"]) == tp.QUIET_MS // tp.QUIET_CHUNK
    assert ff["skipped_ms"] == sum(c["skipped_ms"] for c in ff["chunks"])
    flood = _load(tp.P2PFLOOD_QUIET_FILE)
    assert len(flood["seeds"]) == tp.QUIET_SEEDS
    assert all(c["frac_done"] == 1.0 for c in flood["counts"])


@pytest.mark.slow
def test_quiet_goldens_match_jax_and_port(tmp_path, monkeypatch):
    """The quiet lines regenerated from the JAX package into a scratch
    directory equal the committed files; the port's CPU runs of the same
    batches (`network.scan_chunk` at K=2, and Dfinity fast-forwarded)
    equal them seed by seed, with the JAX engine's skip counts."""
    import torch
    from wittgenstein_tpu_torch.core.state import init_batched
    for name in ("DFINITY_QUIET_FILE", "P2PFLOOD_QUIET_FILE"):
        monkeypatch.setattr(tp, name, str(tmp_path / name))
    tp.write_quiet_goldens()
    for name, protocol, n in (("DFINITY_QUIET_FILE", "dfinity", 10),
                              ("P2PFLOOD_QUIET_FILE", "p2pflood", 256)):
        fresh = _load(getattr(tp, name))
        golden = _load(COMMITTED[name])
        assert fresh["seeds"] == golden["seeds"]
        proto = tp.port_protocol(protocol, n)
        runs = [False, True] if "fast_forward" in golden else [False]
        for ff in runs:
            got, stats = tp.port_chunks(
                proto, init_batched(proto, torch.arange(tp.QUIET_SEEDS)),
                tp.QUIET_MS, tp.QUIET_CHUNK, 2, fast_forward=ff)
            assert convert.seed_digests(*got[tp.QUIET_MS]) == \
                golden["seeds"]
            if ff:
                assert stats == golden["fast_forward"]["chunks"]


#: the goldens of `chip_smoke.py` phases B and P: name -> file
SCENARIO_FILES = {"byz": tp.BYZ_GOLDEN_FILE, "eth2": tp.ETH2_GOLDEN_FILE,
                  "p2phandel": tp.P2PHANDEL_GOLDEN_FILE,
                  "optimistic": tp.OPTIMISTIC_GOLDEN_FILE}


def _scenario_leaves(name):
    """Leaf names of the port's state of each golden's configuration, at
    a size with the same leaves."""
    if name == "byz":
        from wittgenstein_tpu_torch.models.handel import Handel
        from wittgenstein_tpu_torch.scenarios.handel_scenarios import \
            default_params
        proto = Handel(**default_params(nodes=32, dead_ratio=0.25,
                                        byzantine_suicide=True), device="cpu")
    elif name == "eth2":
        from wittgenstein_tpu_torch.models.handeleth2 import HandelEth2
        proto = HandelEth2(node_count=16, device="cpu")
    elif name == "p2phandel":
        from wittgenstein_tpu_torch.models.p2phandel import (P2PHandel,
                                                             scenario_params)
        proto = P2PHandel(**scenario_params(40, 8), device="cpu")
    else:
        from wittgenstein_tpu_torch.models.optimistic import (
            OptimisticP2PSignature, main_params)
        proto = OptimisticP2PSignature(**main_params(node_count=64,
                                                     threshold=33),
                                       device="cpu")
    return sorted(convert.state_digest(*convert.to_numpy(*proto.init(0))))


@pytest.mark.parametrize("name", sorted(SCENARIO_FILES))
def test_scenario_golden_schema(name):
    """Each phase B or P golden: its call, 4 seeds with the leaf names of
    the port's state of the same configuration and distinct digests,
    zero drops and clamps, and the generator's wall and memory."""
    golden = _load(SCENARIO_FILES[name])
    assert {"wall_s", "peak_rss_gb"} <= set(golden["generator"])
    names = _scenario_leaves(name)
    parts = ([golden["dense"], golden["fast_forward"]] if name == "eth2"
             else [golden])
    for part in parts:
        assert len(part["seeds"]) == len(part["counts"]) == tp.P_SEEDS
        assert all(sorted(d) == names for d in part["seeds"])
        assert len({json.dumps(d, sort_keys=True)
                    for d in part["seeds"]}) == tp.P_SEEDS
        assert all(c["dropped"] == c["clamped"] == 0 for c in part["counts"])
    if name == "byz":
        assert golden["call"].startswith(
            "wittgenstein_tpu.scenarios.handel_scenarios.byz_suicide_sweep("
            f"ratios=({tp.BYZ_RATIO},), nodes={tp.BYZ_N}, seeds=4)")
        header, row = golden["csv"].splitlines()
        assert header == "byz_ratio,avg_done_ms,max_done_ms,frac_done"
        assert row.startswith("0.25,") and row.endswith(",1.0")
        assert len(set(golden["stopped_at"])) == 1
        assert all(c["honest_blacklisted"] == tp.BYZ_N * 3 // 4 and
                   c["evicted"] == 0 for c in golden["counts"])
    elif name == "eth2":
        assert golden["dense"]["ms"] == tp.ETH2_DENSE_MS
        ff = golden["fast_forward"]
        assert ff["ms"] == tp.ETH2_FF_MS
        assert len(ff["chunks"]) == \
            (tp.ETH2_FF_MS - tp.ETH2_DENSE_MS) // tp.ETH2_FF_CHUNK
        assert ff["skipped_ms"] == sum(c["skipped_ms"] for c in ff["chunks"])
        assert all(c["heights"] == [1001] for c in ff["counts"])
    elif name == "p2phandel":
        assert golden["ms"] == tp.P2PHANDEL_CHUNK * len(golden["chunks"])
        assert golden["skipped_ms"] == sum(c["skipped_ms"]
                                           for c in golden["chunks"])
        assert all(0 < c["done_max"] <= golden["ms"]
                   for c in golden["counts"])
    else:
        assert golden["ms"] % tp.OPTIMISTIC_CHUNK == 0
        assert all(c["min_cardinality"] >= 501 and
                   0 < c["done_max"] <= golden["ms"]
                   for c in golden["counts"])


#: the goldens of `chip_smoke.py` phases L and A: name -> (file, seeds)
LA_FILES = {"p2phandel_city": (tp.CITY_P2PHANDEL_FILE, tp.P_SEEDS),
            "optimistic_city": (tp.CITY_OPTIMISTIC_FILE,
                                tp.CITY_OPTIMISTIC_SEEDS),
            "enr": (tp.ENR_GOLDEN_FILE, tp.A_SEEDS),
            "enr_churn": (tp.ENR_CHURN_FILE, tp.A_SEEDS),
            **{name.lower(): (path, tp.A_SEEDS)
               for name, path in tp.AVALANCHE_GOLDEN_FILES.items()},
            "paxos": (tp.PAXOS_GOLDEN_FILE, tp.A_SEEDS)}


def _la_proto(name):
    """The port's protocol of each phase L or A golden, at a size with
    the same leaves."""
    if name == "p2phandel_city":
        from wittgenstein_tpu_torch.models.p2phandel import P2PHandel
        from wittgenstein_tpu_torch.scenarios.p2phandel_scenarios import \
            default_params
        return P2PHandel(**default_params(40, 8), device="cpu")
    if name == "optimistic_city":
        from wittgenstein_tpu_torch.models.optimistic import \
            OptimisticP2PSignature
        from wittgenstein_tpu_torch.scenarios.optimistic_scenarios import \
            default_params
        return OptimisticP2PSignature(**default_params(32), device="cpu")
    if name.startswith("enr"):
        from wittgenstein_tpu_torch.models.enr import ENRGossiping
        return ENRGossiping(nodes=16, device="cpu")
    if name == "paxos":
        from wittgenstein_tpu_torch.models.paxos import Paxos
        return Paxos(device="cpu")
    from wittgenstein_tpu_torch.models import avalanche
    return getattr(avalanche, name.capitalize())(node_count=16, device="cpu")


@pytest.mark.parametrize("name", sorted(LA_FILES))
def test_city_and_committee_golden_schema(name):
    """Each phase L or A golden: its seeds with the leaf names of the
    port's state of the same configuration and distinct digests, zero
    drops and clamps, stop times on its chunk grid (the fast-forwarded
    ones with their skip counts summed), and the generator's wall and
    memory."""
    path, seeds = LA_FILES[name]
    golden = _load(path)
    assert {"wall_s", "peak_rss_gb"} <= set(golden["generator"])
    names = sorted(convert.state_digest(*convert.to_numpy(
        *_la_proto(name).init(0))))
    assert len(golden["seeds"]) == len(golden["counts"]) == seeds
    assert all(sorted(d) == names for d in golden["seeds"])
    assert len({json.dumps(d, sort_keys=True)
                for d in golden["seeds"]}) == seeds
    assert all(c["dropped"] == c["clamped"] == 0 for c in golden["counts"])
    if name.endswith("_city"):
        assert "run_multiple_times(proto" in golden["call"]
        assert all(t % 500 == 0 and c["done_max"] <= t for t, c in
                   zip(golden["stopped_at"], golden["counts"]))
    if name == "p2phandel_city":
        assert set(golden["stats"]) == {"done_min", "done_avg", "done_max",
                                        "msg_min", "msg_avg", "msg_max",
                                        "bytes_avg"}
    if name == "optimistic_city":
        header, row = golden["csv"].splitlines()
        assert header == "nodes,done_avg,done_max,msg_avg"
        assert row.startswith(f"{tp.CITY_OPTIMISTIC_N},")
        assert all(c["all_done"] and c["min_cardinality"] >=
                   int(tp.CITY_OPTIMISTIC_N * 0.99)
                   for c in golden["counts"])
    if name == "enr":
        assert golden["ms"] == tp.ENR_MS and golden["params"] == {}
        assert golden["first_seed"] == 0
        assert golden["hint"] == {"join_ms": [], "change_ms": []}
    if name == "enr_churn":
        # the batch holds a join, capability changes and an exit
        assert golden["ms"] == tp.ENR_CHURN_MS
        assert golden["first_seed"] == tp.ENR_CHURN_FIRST_SEED
        assert golden["params"] == tp.ENR_CHURN_PARAMS
        assert golden["hint"]["join_ms"] and golden["hint"]["change_ms"]
        assert min(c["live"] for c in golden["counts"]) < \
            tp.ENR_CHURN_PARAMS["nodes"] + len(golden["hint"]["join_ms"])
    if name in ("slush", "snowflake"):
        assert golden["ms"] == tp.AVALANCHE_CHUNK * len(golden["chunks"])
        assert golden["skipped_ms"] == sum(c["skipped_ms"]
                                           for c in golden["chunks"])
        assert all(c["colors"][0] == 0 and 0 in c["colors"][1:]
                   for c in golden["counts"])
    if name == "paxos":
        assert golden["ms"] % tp.PAXOS_CHUNK == 0
        assert all(0 < c["done_max"] <= golden["ms"] and c["value"] >= 0
                   for c in golden["counts"])
