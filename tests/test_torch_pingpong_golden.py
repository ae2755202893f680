"""The golden digests that `chip_smoke.py` holds the port's PingPong(1000)
runs against (phases 6b and 6c): the JAX package's per-ms run of seed 0
to 800 ms, and its harness chunk (``jax.vmap(scan_chunk(PingPong(1000),
200, superstep=2))``) for seeds 0-15 at 200 ms.  Here: each file's own
consistency and the reference's curve; marked slow (a minute and a few
GB of JAX on the CPU, and a 1000-node run of the port), the digests
recomputed from the JAX package, and the port's CPU run against them."""

import json

import pytest
import torch_parity as tp

from wittgenstein_tpu_torch import convert


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_pingpong_goldens_are_consistent():
    """The per-ms golden's counters follow tests/test_pingpong.py's curve
    with nothing dropped; the harness golden has 16 seeds with the same
    leaves as the per-ms one, no two alike."""
    dense = _load(tp.PINGPONG_GOLDEN_FILE)
    assert dense["ms"] == tp.PINGPONG_MS
    c = dense["counts"]["pongs"]
    assert 80 < c[0] < 400 and 500 < c[2] <= 1000 and c[-1] == 1000
    assert c == sorted(c)
    assert all(dense["counts"][k] == 0 for k in
               ("dropped", "bc_dropped", "clamped", "sp_dropped"))
    harness = _load(tp.PINGPONG_HARNESS_FILE)
    assert harness["ms"] == tp.PINGPONG_HARNESS_MS
    seeds = harness["seeds"]
    assert len(seeds) == tp.PINGPONG_SEEDS
    assert all(sorted(s) == sorted(dense["leaves"]) for s in seeds)
    assert len({json.dumps(s, sort_keys=True) for s in seeds}) == len(seeds)


@pytest.mark.slow
def test_pingpong_goldens_match_jax():
    digest, counts = tp.jax_pingpong_golden()
    dense = _load(tp.PINGPONG_GOLDEN_FILE)
    assert counts == dense["counts"] and digest == dense["leaves"]
    assert tp.jax_pingpong_harness_digests() == \
        _load(tp.PINGPONG_HARNESS_FILE)["seeds"]


@pytest.mark.slow
def test_port_pingpong_matches_golden():
    """The port's CPU run of seed 0: its curve and its state at 800 ms
    equal the JAX golden."""
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    dense = _load(tp.PINGPONG_GOLDEN_FILE)
    proto = PingPong(node_count=tp.PINGPONG_N, device="cpu")
    net, ps = proto.init(0)
    runner = Runner(proto)
    curve = []
    for _ in range(tp.PINGPONG_MS // 100):
        net, ps = runner.run_ms(net, ps, 100)
        curve.append(int(ps.pongs))
    assert curve == dense["counts"]["pongs"]
    assert convert.state_digest(*convert.to_numpy(net, ps)) == \
        dense["leaves"]
