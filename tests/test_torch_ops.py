"""Bit-equality of the port's tensor primitives and latency physics
(wittgenstein_tpu_torch/ops/{prng,bitset,flat}.py, core/latency.py,
core/builders.py) with the JAX package, on the CPU.  Tolerance 0: all
of it is integer math (the one float model is a shipped table, checked
here entry for entry against the JAX function)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu.core import builders as jbuilders
from wittgenstein_tpu.core import latency as jlat
from wittgenstein_tpu.ops import bitset as jbits
from wittgenstein_tpu.ops import flat as jflat
from wittgenstein_tpu.ops import prng as jprng
from wittgenstein_tpu_torch.core import builders as tbuilders
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.ops import bitset as tbits
from wittgenstein_tpu_torch.ops import flat as tflat
from wittgenstein_tpu_torch.ops import prng as tprng

CPU = "cpu"


def _eq(ref, got, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if ref.dtype == np.uint32 and got.dtype == np.int64:
        got = got.astype(np.uint32)
    if ref.dtype == np.uint32 and got.dtype == np.int32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(ref, got, err_msg=what)


def _ids(rng, n=4096):
    """Random int32 ids, negatives and extremes included."""
    ids = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    ids[:4] = [0, -1, 2 ** 31 - 1, -2 ** 31]
    return ids.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, -7, 2 ** 31 - 1, 123456789])
def test_prng_hashes(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    ids = _ids(rng)
    ji, ti = jnp.asarray(ids), torch.tensor(ids)
    js, ts = jnp.int32(seed), torch.tensor(seed, dtype=torch.int32)
    _eq(jprng.mix32(ji), tprng.mix32(ti), "mix32")
    _eq(jprng.hash2(ji, js), tprng.hash2(ti, ts), "hash2")
    _eq(jprng.hash3(js, jprng.TAG_LATENCY, ji),
        tprng.hash3(ts, tprng.TAG_LATENCY, ti), "hash3")
    _eq(jprng.hash3(js, jprng.TAG_LATENCY, 17),
        tprng.hash3(ts, tprng.TAG_LATENCY, 17), "hash3 python int")
    _eq(jprng.uniform_delta(js, ji), tprng.uniform_delta(ts, ti), "delta")
    _eq(jprng.uniform_u32(js, ji), tprng.uniform_u32(ts, ti), "u32")
    _eq(jprng.uniform_float(js, ji), tprng.uniform_float(ts, ti), "float")
    n = rng.integers(0, 5000, ids.shape).astype(np.int32)
    _eq(jprng.uniform_int(js, ji, jnp.asarray(n)),
        tprng.uniform_int(ts, ti, torch.tensor(n)), "uniform_int tensor n")
    _eq(jprng.uniform_int(js, ji, 2000), tprng.uniform_int(ts, ti, 2000),
        "uniform_int")
    _eq(jprng.bernoulli(js, ji, 0.3), tprng.bernoulli(ts, ti, 0.3),
        "bernoulli")


@pytest.mark.parametrize("bits", [1, 5, 11, 16, 31])
def test_prng_permutations(bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 2 ** 32, 2048, dtype=np.uint64).astype(
        np.uint32)
    x = rng.integers(0, 2 ** bits, 2048).astype(np.int32)
    jk, tk = jnp.asarray(keys), torch.tensor(keys.view(np.int32))
    jx, tx = jnp.asarray(x), torch.tensor(x)
    fwd = tprng.bij_perm(tk, tx, bits)
    _eq(jprng.bij_perm(jk, jx, bits), fwd, "bij_perm")
    _eq(jprng.bij_perm_inv(jk, jnp.asarray(fwd.numpy()), bits),
        tprng.bij_perm_inv(tk, fwd, bits), "bij_perm_inv")
    assert torch.equal(tprng.bij_perm_inv(tk, fwd, bits), tx)
    dyn = rng.integers(0, 32, 2048).astype(np.int32)
    _eq(jprng.bij_perm_dyn(jk, jx, jnp.asarray(dyn)),
        tprng.bij_perm_dyn(tk, tx, torch.tensor(dyn)), "bij_perm_dyn")
    _eq(jprng.bij_perm_inv_dyn(jk, jx, jnp.asarray(dyn)),
        tprng.bij_perm_inv_dyn(tk, tx, torch.tensor(dyn)),
        "bij_perm_inv_dyn")
    odd = keys | np.uint32(1)
    _eq(jprng._uinv_odd(jnp.asarray(odd)),
        tprng._uinv_odd(torch.tensor(odd.astype(np.int64))), "_uinv_odd")


def test_bitset_ops():
    rng = np.random.default_rng(3)
    n, w = 300, 9
    a = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)
    b = a & rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(
        np.uint32)
    a[0] = 0xFFFFFFFF
    b[1] = 0
    ta, tb = torch.tensor(a.view(np.int32)), torch.tensor(b.view(np.int32))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert tbits.n_words(300) == jbits.n_words(300) == 10
    _eq(jbits.popcount(ja), tbits.popcount(ta), "popcount")
    idx = rng.integers(0, 32 * w, n).astype(np.int32)
    _eq(jbits.one_bit(jnp.asarray(idx), w),
        tbits.one_bit(torch.tensor(idx), w), "one_bit")
    _eq(jbits.get_bit(ja, jnp.asarray(idx)),
        tbits.get_bit(ta, torch.tensor(idx)), "get_bit")
    base = rng.integers(0, 32 * w, n).astype(np.int32)
    length = rng.integers(0, 32 * w, n).astype(np.int32)
    length[:3] = [0, 32, 32 * w]
    base[:3] = [0, 0, 0]
    _eq(jbits.range_mask(jnp.asarray(base), jnp.asarray(length), w),
        tbits.range_mask(torch.tensor(base), torch.tensor(length), w),
        "range_mask")
    _eq(jbits.includes(ja, jb), tbits.includes(ta, tb), "includes")
    _eq(jbits.includes(jb, ja), tbits.includes(tb, ta), "includes rev")
    _eq(jbits.intersects(ja, jb), tbits.intersects(ta, tb), "intersects")


def test_flat_ops():
    rng = np.random.default_rng(5)
    a, b, c = 7, 5, 3
    arr2 = rng.integers(-99, 99, (a, b)).astype(np.int32)
    arr3 = rng.integers(-99, 99, (a, b, c)).astype(np.int32)
    i = rng.integers(0, a, (4, 6)).astype(np.int32)
    j = rng.integers(0, b, (4, 6)).astype(np.int32)
    ji, jj, ti, tj = (jnp.asarray(i), jnp.asarray(j), torch.tensor(i),
                      torch.tensor(j))
    _eq(jflat.gather2d(jnp.asarray(arr2), ji, jj),
        tflat.gather2d(torch.tensor(arr2), ti, tj), "gather2d")
    # gather_rows clamps out-of-range rows (mode="clip").
    jbig, tbig = jnp.asarray(i + 3), torch.tensor(i + 3)
    _eq(jflat.gather_rows(jnp.asarray(arr3), jbig, jj),
        tflat.gather_rows(torch.tensor(arr3), tbig, tj), "gather_rows")
    _eq(jflat.add2d(jnp.asarray(arr2), ji, jj, jnp.int32(5)),
        tflat.add2d(torch.tensor(arr2), ti, tj, 5), "add2d duplicates")
    # set2d / set_rows need unique targets: one per row.
    ui = np.arange(a, dtype=np.int32)
    uj = rng.integers(0, b, a).astype(np.int32)
    ok = rng.random(a) < 0.6
    vals = rng.integers(-9, 9, a).astype(np.int32)
    _eq(jflat.set2d(jnp.asarray(arr2), jnp.asarray(ui), jnp.asarray(uj),
                    jnp.asarray(vals), ok=jnp.asarray(ok)),
        tflat.set2d(torch.tensor(arr2), torch.tensor(ui), torch.tensor(uj),
                    torch.tensor(vals), ok=torch.tensor(ok)), "set2d")
    rows = rng.integers(-9, 9, (a, c)).astype(np.int32)
    _eq(jflat.set_rows(jnp.asarray(arr3), jnp.asarray(ui), jnp.asarray(uj),
                       jnp.asarray(rows), ok=jnp.asarray(ok)),
        tflat.set_rows(torch.tensor(arr3), torch.tensor(ui),
                       torch.tensor(uj), torch.tensor(rows),
                       ok=torch.tensor(ok)), "set_rows")


def test_shipped_latency_table_matches_jax():
    """Every (distance, delta) entry of the shipped table equals the JAX
    model's float32 computation."""
    shipped = tlat.distance_latency_table(CPU).numpy()
    np.testing.assert_array_equal(tp.jax_latency_table(), shipped)


def test_torus_dist_exhaustive():
    """The port's exact integer root against the JAX float32 sqrt over
    every torus offset (dx in [0, 1000], dy in [0, 556])."""
    dx, dy = np.meshgrid(np.arange(1001), np.arange(557), indexing="ij")
    dx, dy = dx.reshape(-1), dy.reshape(-1)
    k = dx.size
    x = np.concatenate([[1], 1 + dx]).astype(np.int32)
    y = np.concatenate([[1], 1 + dy]).astype(np.int32)
    jnodes = jbuilders.default_nodes(k + 1).replace(x=jnp.asarray(x),
                                                    y=jnp.asarray(y))
    tnodes = tbuilders.default_nodes(k + 1, CPU).replace(
        x=torch.tensor(x), y=torch.tensor(y))
    dst = np.arange(1, k + 1, dtype=np.int32)
    _eq(jlat.torus_dist(jnodes, jnp.zeros(k, jnp.int32), jnp.asarray(dst)),
        tlat.torus_dist(tnodes, torch.zeros(k, dtype=torch.long),
                        torch.tensor(dst)), "torus_dist")


@pytest.mark.parametrize("tor", [0.0, 0.2])
def test_builder_and_full_latency(tor):
    """Built nodes, then `full_latency` over random pairs (self-sends
    included) and every delta, for each ported model."""
    n = 512
    for seed in (0, 3):
        jn = jbuilders.NodeBuilder(tor=tor).build(seed, n)
        tn = tbuilders.NodeBuilder(tor=tor).build(seed, n, CPU)
        for name in ("x", "y", "city", "speed_ratio", "extra_latency",
                     "down", "done_at"):
            _eq(getattr(jn, name), getattr(tn, name), name)
        rng = np.random.default_rng(seed)
        src = rng.integers(0, n, 20000).astype(np.int32)
        dst = rng.integers(0, n, 20000).astype(np.int32)
        dst[:500] = src[:500]
        delta = rng.integers(0, 100, 20000).astype(np.int32)
        for name in (None, "NetworkNoLatency", "NetworkFixedLatency(7)"):
            jm, tm = jlat.get_by_name(name), tlat.get_by_name(name)
            _eq(jlat.full_latency(jm, jn, jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(delta)),
                tlat.full_latency(tm, tn, torch.tensor(src),
                                  torch.tensor(dst), torch.tensor(delta)),
                f"full_latency {name}")
            assert jlat.latency_floor_ms(jm) == tlat.latency_floor_ms(tm)


def test_registries():
    for name in ("RANDOM_SPEED=CONSTANT_TOR=0.33", None,
                 "AWS_SPEED=CONSTANT_TOR=0.00",
                 "CITIES_SPEED=CONSTANT_TOR=0.00"):
        assert tbuilders.get_by_name(name) == tbuilders.NodeBuilder(
            **vars(jbuilders.get_by_name(name)))
    assert tbuilders.registry_name("random", True, 0.1) == \
        jbuilders.registry_name("random", True, 0.1)
    assert tbuilders.get_by_name("AWS_SPEED=GAUSSIAN_TOR=0.00") == \
        tbuilders.NodeBuilder(**vars(jbuilders.get_by_name(
            "AWS_SPEED=GAUSSIAN_TOR=0.00")))
    assert repr(tlat.get_by_name("NetworkLatencyByCity")) == \
        repr(jlat.get_by_name("NetworkLatencyByCity"))
    assert tlat.latency_floor_ms(tlat.get_by_name("NetworkLatencyByCity")) \
        == jlat.latency_floor_ms(jlat.get_by_name("NetworkLatencyByCity"))
    with pytest.raises(KeyError):
        tlat.get_by_name("NoSuchLatency")
    assert repr(tlat.get_by_name("NetworkFixedLatency(100)")) == \
        repr(jlat.get_by_name("NetworkFixedLatency(100)"))
    _eq(jlat.gpd_inverse(jnp.float32(0.0)),
        tlat.gpd_inverse(torch.tensor(0.0)), "gpd_inverse(0)")


def test_level_helpers():
    """models/_levels.py against the JAX package: geometry, keyed peers,
    row bit reads, the level masks and both JAX per-level popcount
    forms (one-hot einsum and prefix sum) against the port's integer
    prefix form."""
    import jax

    from wittgenstein_tpu.models import _levels as jlv
    from wittgenstein_tpu.models.handel import Handel as JH
    from wittgenstein_tpu_torch.models import _levels as tlv
    from wittgenstein_tpu_torch.models.handel import Handel as TH

    n = 256
    jp = JH(node_count=n, threshold=200)
    tq = TH(node_count=n, threshold=200, device=CPU)
    rng = np.random.default_rng(9)
    ids = np.arange(n, dtype=np.int32)
    lvl = rng.integers(0, jp.levels, n).astype(np.int32)
    pos = rng.integers(0, n, n).astype(np.int32)
    ji, tl = jnp.asarray(ids), torch.tensor(ids)
    jl, tlvl = jnp.asarray(lvl), torch.tensor(lvl)
    for half in (1, 4, 64):
        _eq(jlv.sibling_base(ji, half), tlv.sibling_base(tl, half),
            f"sibling_base {half}")
    _eq(jlv.keyed_level_peer(jnp.int32(7), 0x1234, ji, jl,
                             jnp.asarray(pos)),
        tlv.keyed_level_peer(torch.tensor(7, dtype=torch.int32), 0x1234,
                             tl, tlvl, torch.tensor(pos)),
        "keyed_level_peer")
    bits = rng.integers(0, 2 ** 32, (n, jp.w), dtype=np.uint64).astype(
        np.uint32)
    jb, tb = jnp.asarray(bits), torch.tensor(bits.view(np.int32))
    idx = rng.integers(0, n, (n, 5)).astype(np.int32)
    _eq(jlv.get_bit_rows(jb, jnp.asarray(idx)),
        tlv.get_bit_rows(tb, torch.tensor(idx)), "get_bit_rows")
    _eq(jp._range_mask_dyn(ji, jl), tq._range_mask_dyn(tl, tlvl),
        "range_mask_dyn")
    _eq(jp._block_mask_dyn(ji, jl), tq._block_mask_dyn(tl, tlvl),
        "block_mask_dyn")
    _eq(jp._sender_block_mask(ji, jl), tq._sender_block_mask(tl, tlvl),
        "sender_block_mask")
    subm = jp._subword_masks(ji)
    _eq(subm, tq._subword_masks(), "subword masks")
    hi = ids >> 5
    got = tq._level_pc(tb, tq._subword_masks(), torch.tensor(hi))
    _eq(jp._level_pc(jb, jp._word_onehot(ji), subm, jnp.asarray(hi)), got,
        "level_pc vs einsum")
    _eq(jp._level_pc(jb, None, subm, jnp.asarray(hi)), got,
        "level_pc vs prefix")
    x = rng.integers(1, 2 ** 31 - 1, 1000).astype(np.int32)
    x[:3] = [1, 2, 2 ** 30]
    _eq(31 - jax.lax.clz(jnp.asarray(x)), tlv.msb(torch.tensor(x)), "msb")


def test_protocol_helpers():
    from wittgenstein_tpu.core import protocol as jproto
    from wittgenstein_tpu_torch.core import protocol as tproto

    rng = np.random.default_rng(4)
    t = rng.integers(0, 500, 200).astype(np.int32)
    phase = rng.integers(0, 50, 200).astype(np.int32)
    period = rng.integers(-2, 30, 200).astype(np.int32)
    _eq(jproto.next_tick(jnp.asarray(t), jnp.asarray(phase),
                         jnp.asarray(period)),
        tproto.next_tick(torch.tensor(t), torch.tensor(phase),
                         torch.tensor(period)), "next_tick")
    mask = rng.random(200) < 0.3
    for m in (mask, np.zeros(200, bool)):
        assert int(jproto.masked_min(jnp.asarray(t), jnp.asarray(m))) == \
            int(tproto.masked_min(torch.tensor(t), torch.tensor(m)))
    from wittgenstein_tpu_torch.models.handel import Handel
    assert tproto.get_protocol("Handel") is Handel
    with pytest.raises(KeyError):
        tproto.get_protocol("NoSuchProtocol")
