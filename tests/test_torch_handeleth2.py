"""HandelEth2 in the port (`wittgenstein_tpu_torch/models/handeleth2.py`)
against the JAX package's, bit for bit (tolerance 0): the geometric hash
draws over many ids, heights and seeds (a float32 threshold product);
the merge helpers on `tests/test_handeleth2_merge.py`'s cases; a 2-seed
batch at 16 nodes dense over the first aggregation (K=2) and then
fast-forwarded past the second one's start (the skip counts the JAX
engine's); nodes down; and `convert.py`'s round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.models.handeleth2 import (PERIOD_TIME, R,
                                                      HandelEth2,
                                                      hash_thresholds)

N, MS, CHUNK, FF_MS, FF_CHUNK = 16, 600, 200, 5500, 500
LAT = "NetworkLatencyByDistanceWJitter"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(**kw):
    from wittgenstein_tpu.models.handeleth2 import HandelEth2 as JHandelEth2
    return JHandelEth2(**kw)


def test_hash_draws_match_jax():
    """The jitted JAX draw and the port's over 4,096 ids x 64 heights x
    4 seeds; the thresholds are the float32 running product."""
    proto, jproto = HandelEth2(node_count=64, device="cpu"), _jax()
    ids = np.arange(4096, dtype=np.int32)
    draw = jax.jit(jproto._own_hash_draw)
    for seed in range(4):
        for height in range(1000, 1064):
            want = np.asarray(draw(jnp.int32(seed), jnp.asarray(ids),
                                   jnp.full(4096, height, jnp.int32)))
            got = proto._own_hash_draw(
                torch.tensor(seed, dtype=torch.int32), torch.tensor(ids),
                torch.full((4096,), height, dtype=torch.int32))
            assert np.array_equal(want, got.numpy()), (seed, height)
    assert 0.15 < (want > 0).mean() < 0.25
    pr = np.float32(1)
    for k, thr in enumerate(hash_thresholds(4)):
        pr = np.float32(pr * np.float32(0.2))
        assert thr == float(pr) and np.float32(thr) == pr, k


def test_proved_superstep_matches_jax():
    """may_self_send = False and the distance latency's 2-ms floor: the
    gate would prove K = 3, but the 1,024-ms ring takes K | horizon, so
    K = 2, as in the JAX package."""
    from wittgenstein_tpu.core import network as jnetwork
    proto = HandelEth2(network_latency_name=LAT, device="cpu")
    assert network.pick_superstep(proto, CHUNK, t0=0) == 2 == \
        jnetwork.pick_superstep(_jax(network_latency_name=LAT), CHUNK, t0=0)
    assert network.unicast_floor_ms(proto) == 2


def _bits(*ids, w=1):
    row = np.zeros(w, np.uint32)
    for i in ids:
        row[i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return row[None, :]


@pytest.mark.parametrize("case", ["empty", "disjoint", "overlap",
                                  "repair", "multi_hash"])
def test_size_if_merged_matches_jax(case):
    """sizeIfMerged on tests/test_handeleth2_merge.py:40-101's cases."""
    proto, jproto = HandelEth2(node_count=64, device="cpu"), _jax()
    w, z = proto.w, np.zeros((1, 1, 2), np.uint32)
    ours, ind, theirs = {
        "empty": (_bits(4, 5, w=w)[:, None], z, z),
        "disjoint": (_bits(4, 5, w=w)[:, None], z, _bits(6, 7, w=w)[:, None]),
        "overlap": (_bits(4, 5, 6, w=w)[:, None], z,
                    _bits(6, 7, w=w)[:, None]),
        "repair": (_bits(4, 5, 6, w=w)[:, None], _bits(4, 5, w=w)[:, None],
                   _bits(6, 7, w=w)[:, None]),
        "multi_hash": (np.concatenate([_bits(4, 5, w=w), _bits(6, w=w), z[0],
                                       z[0]])[None], np.zeros((1, 4, 2),
                                                              np.uint32),
                       np.concatenate([z[0], _bits(7, w=w), _bits(4, w=w),
                                       z[0]])[None])}[case]
    want = jproto._size_if_merged(
        jnp.asarray(ours), jnp.asarray(ind), jnp.asarray(theirs),
        jproto._range_mask_dyn(jnp.asarray([0]), jnp.asarray([3]))[:, None])

    def t(a):
        return torch.tensor(np.ascontiguousarray(a).view(np.int32))
    got = proto._size_if_merged(
        t(ours), t(ind), t(theirs),
        proto._range_mask_dyn(torch.tensor([0], dtype=torch.int32),
                              torch.tensor([3], dtype=torch.int32))[:, None])
    assert int(got[0]) == int(want[0]) == {"empty": 2, "disjoint": 4,
                                           "overlap": 3, "repair": 4,
                                           "multi_hash": 5}[case]


def _merge_both(n, hash_values, steps):
    """tests/test_handeleth2_merge.py:104-120's `_merge_once`, applied
    step by step in both packages from the same init state; the port's
    protocol state after each step, beside the JAX one's."""
    jproto = _jax(node_count=n, hash_values=hash_values)
    proto = HandelEth2(node_count=n, hash_values=hash_values, device="cpu")
    jnet, jps = jproto.init(jnp.asarray(0, jnp.int32))
    net, ps = convert.from_reference(*tp.jax_state(jnet, jps), "cpu")
    out = []
    for node, frm, lvl, h, ids in steps:
        sig = np.zeros((n, hash_values, proto.w), np.uint32)
        sig[node, h] = _bits(*ids, w=proto.w)[0]

        def pend(dtype, fill, value):
            a = np.full(n, fill, dtype)
            a[node] = value
            return a
        fields = dict(
            pend_on=pend(bool, False, True), pend_at=np.zeros(n, np.int32),
            pend_from=pend(np.int32, -1, frm), pend_lvl=pend(np.int32, 0, lvl),
            pend_slot=np.zeros(n, np.int32), pend_hash=pend(np.int32, 0, h),
            pend_sig=sig)
        jps = jproto._apply_pending(
            jps.replace(**{k: jnp.asarray(v) for k, v in fields.items()}),
            jnp.asarray(10, jnp.int32))
        ps = proto._apply_pending(ps.replace(**{
            k: torch.tensor(v.view(np.int32) if v.dtype == np.uint32 else v)
            for k, v in fields.items()}), 10)
        out.append((tp.jax_state(jnet, jps), convert.to_numpy(net, ps)))
    return out


@pytest.mark.parametrize("n,hash_values,steps", [
    # tests/test_handeleth2_merge.py:123: level 1, then disjoint level-2
    # merges under one hash, then a non-improving overlap
    (4, 4, [(0, 1, 1, 2, (1,)), (0, 2, 2, 2, (2,)), (0, 3, 2, 2, (3,)),
            (0, 2, 2, 2, (2,))]),
    # :157: best-of with the individuals' repair
    (8, 2, [(0, 4, 3, 0, (4,)), (0, 5, 3, 0, (5,)), (0, 6, 3, 0, (5, 6, 7))]),
    # :179: the fast-path trigger
    (4, 2, [(0, 1, 1, 0, (1,))])])
def test_apply_pending_matches_jax(n, hash_values, steps):
    for i, (want, got) in enumerate(_merge_both(n, hash_values, steps)):
        tp.assert_states_equal(want, got, f"step {i}")
    inc = got[1]["inc"][0, 0]
    if n == 8:
        assert inc[0][0] == 0b11110000
    elif len(steps) == 1:
        assert got[1]["fast_pending"][0, 0] & (1 << 2)
    else:
        assert inc[2][0] == 0b1110


@pytest.fixture(scope="module")
def runs():
    """Seeds 0 and 1 of both packages at 16 nodes: dense to MS in
    CHUNK-ms calls (the port at K=2), then fast-forwarded in
    FF_CHUNK-ms calls to MS + FF_MS."""
    kw = dict(node_count=N, network_latency_name=LAT)
    jax_out = tp.jax_batch_run(_jax(**kw), [0, 1], MS, CHUNK, FF_MS,
                               FF_CHUNK)
    port_out = tp.port_batch_run(HandelEth2(**kw, device="cpu"), [0, 1], MS,
                                 CHUNK, FF_MS, FF_CHUNK)
    return jax_out, port_out


def test_first_aggregation_matches_jax(runs):
    """Dense over the first aggregation: every leaf of both seeds equal
    at every chunk, and by MS every node's incoming sets cover the
    committee."""
    (want, _), (got, _) = runs
    for t in range(CHUNK, MS + 1, CHUNK):
        tp.assert_batches_equal(want[t], got[t], f"at {t} ms")
    inc = got[MS][1]["inc"][:, :, 1001 % R]              # [R, N, H, W]
    card = np.unpackbits(inc.view(np.uint8), axis=-1).sum((2, 3))
    assert (card == N).all(), card.min()
    assert got[MS][0]["dropped"].sum() == got[MS][0]["clamped"].sum() == 0


def test_fast_forward_matches_jax(runs):
    """Fast-forwarded past the second aggregation's start (6,001 ms):
    every leaf equal after every call, the skip counts the JAX
    engine's, and both aggregations live."""
    (want, jstats), (got, stats) = runs
    assert stats == jstats and sum(s["skipped_ms"] for s in stats) > 0
    for t in range(MS + FF_CHUNK, MS + FF_MS + 1, FF_CHUNK):
        tp.assert_batches_equal(want[t], got[t], f"at {t} ms")
    assert MS + FF_MS > PERIOD_TIME
    assert (got[MS + FF_MS][1]["height"] == 1002).all()
    assert got[MS + FF_MS][1]["active"][:, :, [1001 % R, 1002 % R]].all()


def test_step_without_hint_matches_jax(runs):
    """The step with no `step_hint` (every inbox slot walked, every
    phase run, the reception ranks hashed, not looked up) equals the
    JAX runs too: the hint only leaves out identities."""
    (want, _), _ = runs
    proto = HandelEth2(node_count=N, network_latency_name=LAT, device="cpu")
    proto.step_hint = None
    got, _ = tp.port_batch_run(proto, [0, 1], 2 * CHUNK, CHUNK)
    for t in (CHUNK, 2 * CHUNK):
        tp.assert_batches_equal(want[t], got[t], f"no hint, at {t} ms")


def test_nodes_down_matches_jax():
    """HandelEth2Test's dead nodes: 3 of 32 down, two seeds to 300 ms."""
    kw = dict(node_count=32, nodes_down=3, network_latency_name=LAT)
    want, _ = tp.jax_batch_run(_jax(**kw), [0, 1], 300, 300)
    got, _ = tp.port_batch_run(HandelEth2(**kw, device="cpu"), [0, 1], 300,
                               300)
    tp.assert_batches_equal(want[300], got[300], "nodes down")
    assert got[300][0]["nodes"]["down"].sum(1).tolist() == [3, 3]


def test_convert_round_trip(runs):
    state = [tp.seed_state(x, 1) for x in runs[1][0][MS]]
    tp.assert_states_equal(state, convert.to_numpy(
        *convert.from_reference(*state, "cpu")), "round trip")
