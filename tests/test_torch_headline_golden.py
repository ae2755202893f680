"""The per-seed golden digests that `chip_smoke.py` holds the benchmark
headline's batch against (16 seeds of the 2048-node reference-default
Handel after 200 ms of the JAX package's seed-folded engine, superstep
K=2, phase hints): the file's own consistency, and, marked slow (about 5
minutes and 4.5 GB of JAX on the CPU), the digests recomputed from
the JAX package."""

import json

import pytest
import torch_parity as tp


def _golden():
    with open(tp.HEADLINE_GOLDEN_FILE) as f:
        return json.load(f)


def test_headline_golden_is_consistent():
    """16 seeds, each with every leaf; seed 0 equals the dense engine's
    golden at the same ms (the JAX package's engines are bit-identical),
    and no two seeds share a state."""
    golden = _golden()
    assert golden["ms"] == tp.HEADLINE_MS == tp.GOLDEN_MS
    seeds = golden["seeds"]
    assert len(seeds) == tp.HEADLINE_SEEDS
    with open(tp.GOLDEN_FILE) as f:
        dense = json.load(f)["leaves"]
    assert seeds[0] == dense
    assert all(sorted(s) == sorted(dense) for s in seeds)
    states = {json.dumps(s, sort_keys=True) for s in seeds}
    assert len(states) == tp.HEADLINE_SEEDS


@pytest.mark.slow
def test_headline_golden_matches_jax():
    assert tp.jax_headline_digests() == _golden()["seeds"]
