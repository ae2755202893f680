"""The golden digest that `chip_smoke.py` holds the port's 2048-node run
against: recomputed here from the JAX package (the reference-default
Handel, seed 0, 200 ms through `Runner.run_ms` on the CPU) and compared
with the committed file leaf by leaf."""

import json

import torch_parity as tp


def test_golden_digest_matches_jax():
    with open(tp.GOLDEN_FILE) as f:
        golden = json.load(f)
    assert golden["ms"] == tp.GOLDEN_MS
    fresh = tp.jax_golden_digest()
    assert sorted(fresh) == sorted(golden["leaves"])
    bad = [k for k in sorted(fresh) if fresh[k] != golden["leaves"][k]]
    assert not bad, f"golden leaves differ from the JAX run: {bad}"
