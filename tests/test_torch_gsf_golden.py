"""The GSF golden digest that `chip_smoke.py` holds the port's 4096-node
GSF run against: recomputed here from the JAX package
(`GSFSignature(node_count=4096)` with its defaults, seed 0, the whole
600-ms run through `Runner.run_ms` on the CPU) and compared with the
committed file leaf by leaf, with the run's counters."""

import json

import torch_parity as tp


def test_gsf_golden_digest_matches_jax():
    with open(tp.GSF_GOLDEN_FILE) as f:
        golden = json.load(f)
    assert golden["ms"] == tp.GSF_GOLDEN_MS
    fresh, counts = tp.jax_gsf_golden()
    assert counts == golden["counts"]
    assert counts["evicted"] > 0 and counts["frac_done"] > 0.99
    assert counts["dropped"] == 0 and counts["clamped"] == 0
    assert sorted(fresh) == sorted(golden["leaves"])
    bad = [k for k in sorted(fresh) if fresh[k] != golden["leaves"][k]]
    assert not bad, f"golden leaves differ from the JAX run: {bad}"
