"""GSF at the reference's 32,768 nodes, on the CPU: the int32 guards that
its extents reach, the snapshot pool written in place (the state handed
to a step is donated, and the harness keeps its stopped runs' rows),
and, slow-marked, the regeneration of the 32,768-node JAX golden that
`chip_smoke.py` phase G32 holds the port to (`tests/torch_parity.py
gsf32k-golden`: about 5 minutes and 32 GB of JAX on the CPU)."""

import dataclasses
import json

import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch.core.harness import run_multiple_times
from wittgenstein_tpu_torch.core.network import Runner
from wittgenstein_tpu_torch.core.state import init_net
from wittgenstein_tpu_torch.models.gsf import GSFSignature
from wittgenstein_tpu_torch.ops import flat


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_int32_guards_at_32768_nodes():
    """The extents of `GSFSignature(node_count=32768)` fit int32 (the
    ring's cells, the pool's words, every flat row index), and each
    guard refuses the first size that does not."""
    g = GSFSignature(node_count=32768, device="cpu")
    cfg = g.cfg
    assert (g.levels, g.w, cfg.horizon, cfg.payload_words,
            cfg.out_deg, g.rounds) == (16, 1024, 512, 3, 25, 53)
    assert cfg.horizon * cfg.split_n * cfg.inbox_cap == 268_435_456
    assert g.node_count * g.rounds * g.w == 1_778_384_896 < 1 << 31
    # the ring guard (core/state.init_net, the JAX message) checks the
    # sub-plane's cells before anything is allocated
    with pytest.raises(ValueError, match="int32 flat indexing"):
        init_net(dataclasses.replace(cfg, horizon=4096), None, 0)
    # flat row indices: refused from A * B = 2^31 rows on, before any
    # index is formed (no element is allocated here)
    big = torch.empty((1 << 16, 1 << 15, 0), dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        flat.gather_rows(big, idx, idx)
    with pytest.raises(ValueError, match="overflows int32"):
        flat.set_rows(big, idx, idx, torch.zeros(3, 0, dtype=torch.int32))
    wide = torch.zeros(1, dtype=torch.int32).expand(1 << 16, 1 << 15)
    for fn in (flat.gather2d, flat.set2d, flat.add2d):
        args = (wide, idx, idx) + ((idx,) if fn is not flat.gather2d
                                   else ())
        with pytest.raises(ValueError, match="overflows int32"):
            fn(*args)
    ok = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert flat.gather2d(ok, torch.tensor([2]), torch.tensor([1])).item() \
        == 9


def test_pool_written_in_place_and_equal_to_jax():
    """The pool's round slot is written into the state handed to the
    step (donated: the caller's pool is the result's), and the run
    equals the JAX package's, leaf for leaf."""
    import jax
    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu.models.gsf import GSFSignature as JGSF
    proto = GSFSignature(node_count=64, device="cpu")
    net, ps = proto.init(0)
    pool = ps.pool
    before = pool.clone()
    net2, ps2 = Runner(proto).run_ms(net, ps, 60)
    assert ps2.pool is pool                      # written in place
    assert not torch.equal(pool, before)         # the caller's pool moved
    jp = JGSF(node_count=64)
    tp.assert_port_jax_states(jax.jit(jscan(jp, 60))(*jp.init(0)),
                              (net2, ps2))


def test_harness_keeps_stopped_runs_pools():
    """Under `run_multiple_times` a stopped run's pool is its pool at its
    stop time, though the step writes the pool in place: seed 0 stops
    after the first chunk, seed 1 runs on; each equals its own run."""
    proto = GSFSignature(node_count=32, device="cpu")
    res = run_multiple_times(proto, 2, max_time=60, chunk=20,
                             cont_if=lambda net, ps: net.seed != 0,
                             fail_on_drop=False)
    assert res.stopped_at.tolist() == [20, 0]
    for seed, ms in ((0, 20), (1, 60)):
        net, ps = Runner(proto).run_ms(*proto.init(seed), ms)
        batch = tp.convert.to_numpy(res.nets, res.pstates)
        tp.assert_states_equal(tp.convert.to_numpy(net, ps),
                               tuple(tp.seed_state(x, seed) for x in batch),
                               f"seed {seed}")


@pytest.mark.slow
def test_gsf32k_golden_matches_jax(tmp_path):
    with open(tp.GSF32K_GOLDEN_FILE) as f:
        golden = json.load(f)
    fresh = tp.write_gsf32k_golden(path=str(tmp_path / "g.json"))
    assert sorted(fresh["ms"]) == sorted(golden["ms"])
    for t, want in golden["ms"].items():
        got = fresh["ms"][t]
        assert got["counts"] == want["counts"]
        assert got["counts"]["dropped"] == got["counts"]["clamped"] == 0
        bad = [k for k in sorted(want["leaves"])
               if got["leaves"].get(k) != want["leaves"][k]]
        assert not bad, f"{t} ms: golden leaves differ: {bad}"
