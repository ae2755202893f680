"""The five kernel functions of the port (route, Handel's merge and
score, GSF's merge and score), on the cases of
the JAX package's own kernel tests: each port function on the CPU (its
plain PyTorch version) against the JAX Pallas kernel in interpret mode,
bit for bit; and, marked `cuda`, each hand-written CUDA kernel against
its plain version on the card.

This file imports JAX only inside the tests that compare with it, so the
`cuda` tests also run where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from wittgenstein_tpu_torch.ops import gsf_merge, merge, route, score


def _i32(a):
    a = np.asarray(a)
    return torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _eq(ref, got, what):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    if ref.dtype == np.uint32:
        got = np.asarray(got).view(np.uint32)
    np.testing.assert_array_equal(ref, got, err_msg=what)


# ------------------------------------------------------------------ merge


def _merge_case(rng, n, q_cap, s_cap, w, n_ids, dup_rate=0.3, fill=0.7):
    """Queue + inbox with planted (sender, level) collisions across inbox
    slots and against the queue (tests/test_pallas_merge.py's case)."""
    q_from = np.where(rng.random((n, q_cap)) < fill,
                      rng.integers(0, n_ids, (n, q_cap)), -1).astype(
                          np.int32)
    q_lvl = rng.integers(0, 8, (n, q_cap)).astype(np.int32)
    q_rank = rng.integers(0, 2 * n_ids, (n, q_cap)).astype(np.int32)
    q_bad = rng.random((n, q_cap)) < 0.2
    q_sig = rng.integers(0, 2 ** 32, (n, q_cap, w), dtype=np.uint32)
    src = rng.integers(0, n_ids, (n, s_cap)).astype(np.int32)
    level = rng.integers(0, 8, (n, s_cap)).astype(np.int32)
    for i in range(n):
        for s in range(s_cap):
            r = rng.random()
            if r < dup_rate and s > 0:
                s2 = rng.integers(0, s)
                src[i, s], level[i, s] = src[i, s2], level[i, s2]
            elif r < 2 * dup_rate:
                qq = rng.integers(0, q_cap)
                if q_from[i, qq] >= 0:
                    src[i, s], level[i, s] = q_from[i, qq], q_lvl[i, qq]
    rank_all = rng.integers(0, 2 * n_ids, (n, s_cap)).astype(np.int32)
    ok = rng.random((n, s_cap)) < 0.6
    sig_all = rng.integers(0, 2 ** 32, (n, s_cap, w), dtype=np.uint32)
    return [q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all, ok,
            sig_all]


def _merge_vs_pallas(case):
    import jax.numpy as jnp

    from wittgenstein_tpu.ops.pallas_merge import merge_queue_pallas
    ref = merge_queue_pallas(*[jnp.asarray(a) for a in case],
                             q_cap=case[0].shape[1], interpret=True)
    got = merge.merge_queue(*[_i32(a) for a in case])
    for name, r, g in zip(("from", "lvl", "rank", "bad", "sig", "evicted"),
                          ref, got):
        _eq(r, g, name)


@pytest.mark.parametrize("q_cap,s_cap,w", [(16, 12, 8), (8, 4, 2),
                                           (4, 16, 4)])
def test_merge_random(q_cap, s_cap, w):
    rng = np.random.default_rng(q_cap * 100 + s_cap)
    _merge_vs_pallas(_merge_case(rng, 64, q_cap, s_cap, w, n_ids=256))


@pytest.mark.parametrize("regime", ["empty_queue", "full_queue"])
def test_merge_empty_and_full(regime):
    rng = np.random.default_rng(7)
    case = _merge_case(rng, 32, 8, 8, 4, n_ids=128)
    if regime == "empty_queue":
        case[0] = np.full_like(case[0], -1)
        case[8] = np.ones_like(case[8])
    else:
        case[0] = np.abs(case[0])
        case[8] = np.zeros_like(case[8])
    _merge_vs_pallas(case)


def test_merge_rank_ties():
    """Equal ranks: queued entries win, then inbox slots in order."""
    q_cap, s_cap, w, n = 4, 4, 2, 16
    case = [np.full((n, q_cap), 5, np.int32),
            np.tile(np.arange(q_cap, dtype=np.int32), (n, 1)),
            np.full((n, q_cap), 7, np.int32),
            np.zeros((n, q_cap), bool),
            np.arange(n * q_cap * w, dtype=np.uint32).reshape(n, q_cap, w),
            np.full((n, s_cap), 9, np.int32),
            np.tile(np.arange(s_cap, dtype=np.int32) + 4, (n, 1)),
            np.full((n, s_cap), 7, np.int32),
            np.ones((n, s_cap), bool),
            (np.arange(n * s_cap * w, dtype=np.uint32) + 999).reshape(
                n, s_cap, w)]
    _merge_vs_pallas(case)


def test_merge_refuses_wide_rows():
    rng = np.random.default_rng(1)
    case = _merge_case(rng, 2, 200, 60, 1, n_ids=16)
    with pytest.raises(ValueError, match="255"):
        merge.merge_queue(*[_i32(a) for a in case])


# ------------------------------------------------------------------ score


def _score_vs_pallas(n, levels, sig, elvl, ti, vi, la):
    import jax.numpy as jnp

    from wittgenstein_tpu.ops.pallas_score import score_queue_pallas
    ids = np.arange(n, dtype=np.int32)
    args = (sig, elvl, ids, ti, vi, la)
    ref = score_queue_pallas(*[jnp.asarray(a) for a in args],
                             interpret=True)
    got = score.score_queue(*[_i32(a) for a in args])
    for name, r, g in zip(("s_inc", "pc_sig", "pc_sv", "inter_agg"),
                          ref, got):
        _eq(r, g, name)


def test_score_random():
    n, q, levels = 256, 8, 9
    w = n // 32
    rng = np.random.default_rng(11)
    u32 = dict(dtype=np.uint32)
    _score_vs_pallas(n, levels, rng.integers(0, 2 ** 32, (n, q, w), **u32),
                     rng.integers(0, levels, (n, q)).astype(np.int32),
                     rng.integers(0, 2 ** 32, (n, w), **u32),
                     rng.integers(0, 2 ** 32, (n, w), **u32),
                     rng.integers(0, 2 ** 32, (n, w), **u32))


def test_score_zero_and_full_rows():
    """All-zero sigs and all-ones bitsets at level 0 (empty range), 1,
    the top level (full range) and 3."""
    n, q, levels = 64, 4, 7
    w = n // 32
    elvl = np.tile(np.array([0, 1, levels - 1, 3], np.int32), (n, 1))
    ones = np.full((n, w), 0xFFFFFFFF, np.uint32)
    _score_vs_pallas(n, levels, np.zeros((n, q, w), np.uint32), elvl, ones,
                     ones, ones)


# -------------------------------------------------------------- GSF merge


def _gsf_merge_case(rng, n, q_cap, s_cap, w, n_ids, levels=8, fill=0.7,
                    got_rate=0.3):
    """A queue and an inbox with planted same-sender and same-(sender,
    level) duplicates and queued entries the inbox supersedes; ex_keep,
    agg_ok and ind_ok are derived as `models/gsf._receive` derives them,
    with a random got_indiv row consuming some senders' individuals."""
    q_from = np.where(rng.random((n, q_cap)) < fill,
                      rng.integers(0, n_ids, (n, q_cap)), -1).astype(
                          np.int32)
    q_lvl = rng.integers(0, levels, (n, q_cap)).astype(np.int32)
    q_indiv = rng.random((n, q_cap)) < 0.3
    q_sig = rng.integers(0, 2 ** 32, (n, q_cap, w), dtype=np.uint32)
    src = rng.integers(0, n_ids, (n, s_cap)).astype(np.int32)
    level = rng.integers(0, levels, (n, s_cap)).astype(np.int32)
    for i in range(n):
        for s in range(s_cap):
            r = rng.random()
            if r < 0.25 and s > 0:
                s2 = rng.integers(0, s)
                src[i, s] = src[i, s2]
                if r < 0.15:
                    level[i, s] = level[i, s2]
            elif r < 0.5:
                qq = rng.integers(0, q_cap)
                if q_from[i, qq] >= 0:
                    src[i, s], level[i, s] = q_from[i, qq], q_lvl[i, qq]
    valid = rng.random((n, s_cap)) < 0.7
    got = rng.random((n, n_ids)) < got_rate
    same = src[:, :, None] == src[:, None, :]
    later = np.triu(np.ones((s_cap, s_cap), bool), 1)[None]
    earlier = np.tril(np.ones((s_cap, s_cap), bool), -1)[None]
    dup = (same & (level[:, :, None] == level[:, None, :]) &
           valid[:, None, :] & later).any(2)
    agg_ok = valid & ~dup
    sup = ((q_from[:, :, None] == src[:, None, :]) &
           (q_lvl[:, :, None] == level[:, None, :]) &
           ~q_indiv[:, :, None] & agg_ok[:, None, :]).any(2)
    ex_keep = (q_from >= 0) & ~sup
    dup_ind = (same & valid[:, None, :] & earlier).any(2)
    ind_ok = valid & ~dup_ind & ~np.take_along_axis(got, src, 1)
    sig_all = rng.integers(0, 2 ** 32, (n, s_cap, w), dtype=np.uint32)
    return [q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok,
            ind_ok, sig_all]


def _gsf_merge_vs_pallas(case, levels=8):
    import jax.numpy as jnp

    from wittgenstein_tpu.ops.pallas_gsf_merge import gsf_merge_pallas
    ref = gsf_merge_pallas(*[jnp.asarray(a) for a in case], levels=levels,
                           interpret=True)
    got = gsf_merge.gsf_merge(*[_i32(a) for a in case], levels)
    for name, r, g in zip(("from", "lvl", "indiv", "sig", "got_add",
                           "kept_ex_agg"), ref, got):
        _eq(r, g, name)
    return got


@pytest.mark.parametrize("q_cap,s_cap,w", [(16, 16, 8), (4, 8, 4),
                                           (8, 3, 2)])
def test_gsf_merge_random(q_cap, s_cap, w):
    rng = np.random.default_rng(q_cap * 100 + s_cap)
    case = _gsf_merge_case(rng, 64, q_cap, s_cap, w, n_ids=32 * w)
    got = _gsf_merge_vs_pallas(case)
    assert case[8].any() and (case[2] & case[3]).any()
    if q_cap > s_cap:                           # room left for individuals
        assert int(got[4].ne(0).sum()) > 0


@pytest.mark.parametrize("regime", ["empty_queue", "full_queue",
                                    "all_consumed"])
def test_gsf_merge_regimes(regime):
    """An empty queue with a full inbox; a queue of valid entries with an
    empty inbox; every sender's individual already in got_indiv."""
    rng = np.random.default_rng(9)
    case = _gsf_merge_case(rng, 32, 8, 8, 4, n_ids=128,
                           got_rate=1.0 if regime == "all_consumed" else 0.3)
    if regime == "empty_queue":
        case[0] = np.full_like(case[0], -1)
        case[3] = np.zeros_like(case[3])
    elif regime == "full_queue":
        case[0] = np.abs(case[0])
        case[3] = np.ones_like(case[3])
        case[7] = np.zeros_like(case[7])
        case[8] = np.zeros_like(case[8])
    got = _gsf_merge_vs_pallas(case)
    if regime == "all_consumed":
        assert not case[8].any() and int(got[4].ne(0).sum()) == 0


def test_gsf_merge_refuses_wide_rows():
    rng = np.random.default_rng(1)
    case = _gsf_merge_case(rng, 2, 200, 28, 1, n_ids=16)
    with pytest.raises(ValueError, match="255"):
        gsf_merge.gsf_merge(*[_i32(a) for a in case], 8)
    with pytest.raises(ValueError, match="255"):
        gsf_merge.gsf_merge_plain(*[_i32(a) for a in case], 8)


# -------------------------------------------------------------- GSF score


def _gsf_score_vs_pallas(sig, elvl, ver, ind, ids=None):
    import jax.numpy as jnp

    from wittgenstein_tpu.ops.pallas_score import gsf_score_pallas
    n = sig.shape[0]
    ids = np.arange(n, dtype=np.int32) if ids is None else ids
    args = (sig, elvl, ids, ver, ind)
    ref = gsf_score_pallas(*[jnp.asarray(a) for a in args], interpret=True)
    got = score.gsf_score(*[_i32(a) for a in args])
    for name, r, g in zip(("ver_l_card", "card_sig", "inter", "pc_wi",
                           "pc_wv", "inter_ind"), ref, got):
        _eq(r, g, name)


def test_gsf_score_random():
    """tests/test_pallas_score.py::test_gsf_score_kernel_bit_equal's case:
    256 nodes, q 8, levels 0 to the top, random dense bitsets."""
    n, q, levels = 256, 8, 9
    w = n // 32
    rng = np.random.default_rng(23)
    u32 = dict(dtype=np.uint32)
    _gsf_score_vs_pallas(rng.integers(0, 2 ** 32, (n, q, w), **u32),
                         rng.integers(0, levels, (n, q)).astype(np.int32),
                         rng.integers(0, 2 ** 32, (n, w), **u32),
                         rng.integers(0, 2 ** 32, (n, w), **u32))


def test_gsf_score_w1024():
    """GSF 32k's width: 8 rows of W 1,024 (32,768 node ids, levels 0 to
    16), nodes spread over the id space so the level ranges fall in
    every part of the row, against the Pallas kernel in interpret
    mode."""
    n, q, w, levels = 8, 16, 1024, 16
    rng = np.random.default_rng(31)
    u32 = dict(dtype=np.uint32)
    _gsf_score_vs_pallas(rng.integers(0, 2 ** 32, (n, q, w), **u32),
                         rng.integers(0, levels + 1, (n, q)).astype(np.int32),
                         rng.integers(0, 2 ** 32, (n, w), **u32),
                         rng.integers(0, 2 ** 32, (n, w), **u32),
                         ids=rng.choice(32 * w, n, replace=False).astype(
                             np.int32))


def test_gsf_merge_w1024():
    """GSF 32k's width: 8 rows, Q 16, S 16, W 1,024, senders drawn from
    32,768 ids over 16 levels, against the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(32)
    case = _gsf_merge_case(rng, 8, 16, 16, 1024, n_ids=32768, levels=16)
    got = _gsf_merge_vs_pallas(case, levels=16)
    assert case[8].any() and int(got[4].ne(0).sum()) > 0


@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF])
def test_gsf_score_zero_and_full_rows(fill):
    """All-zero and all-ones sigs against all-ones and all-zero bitsets,
    at level 0 (empty range), 1, the top level (full range) and 3."""
    n, q, levels = 64, 4, 7
    w = n // 32
    elvl = np.tile(np.array([0, 1, levels - 1, 3], np.int32), (n, 1))
    sig = np.full((n, q, w), fill, np.uint32)
    other = np.full((n, w), 0xFFFFFFFF - fill, np.uint32)
    _gsf_score_vs_pallas(sig, elvl, other, np.full((n, w), 0xFFFFFFFF,
                                                   np.uint32))


# ------------------------------------------------------------------ route


def _ring(rng, r, f, hz, n, c, fill):
    data = rng.integers(0, 1 << 20, (r, f, hz, n, c)).astype(np.int32)
    src = rng.integers(0, n, (r, hz, n, c)).astype(np.int32)
    size = rng.integers(0, 99, (r, hz, n, c)).astype(np.int32)
    count = rng.integers(0, c + 1, (r, hz, n)).astype(np.int32) * fill
    return data, src, size, count


def _route_vs_pallas(ring, h, dest, msrc, msize, payload, valid,
                     wrap=0):
    """One seed (R = 1): the JAX kernel on flat planes vs the port.  The
    JAX launcher takes the ring row ``h``; the port takes the arrival ms
    and reduces it itself, so it gets ``h + wrap * H``."""
    import jax.numpy as jnp

    from wittgenstein_tpu.ops.pallas_route import bin_into_ring_planes
    data, src, size, count = ring
    _, f, hz, n, c = data.shape
    ref = bin_into_ring_planes(
        tuple(jnp.asarray(data[0, i].reshape(-1)) for i in range(f)),
        (jnp.asarray(src[0].reshape(-1)),),
        (jnp.asarray(size[0].reshape(-1)),), jnp.asarray(count[0]),
        jnp.asarray(h), jnp.asarray(dest), jnp.asarray(msrc),
        jnp.asarray(msize), jnp.asarray(payload), jnp.asarray(valid),
        horizon=hz, cap=c, n=n, split=1, payload_words=f, interpret=True)
    t = [torch.tensor(a) for a in ring]
    dropped = route.bin_into_ring(
        *t, torch.tensor(h + wrap * hz)[None],
        *[torch.tensor(a)[None] for a in (dest, msrc, msize)],
        torch.tensor(payload)[None], torch.tensor(valid)[None])
    for i in range(f):
        _eq(ref[0][i], t[0][0, i].reshape(-1), f"data plane {i}")
    _eq(ref[1][0], t[1][0].reshape(-1), "src plane")
    _eq(ref[2][0], t[2][0].reshape(-1), "size plane")
    _eq(ref[3], t[3][0], "count")
    _eq(ref[4], dropped[0], "dropped")
    return int(dropped[0])


def _messages(rng, m, n, hz, f, n_dest):
    return (rng.integers(0, hz, m).astype(np.int32),
            rng.integers(0, n_dest, m).astype(np.int32),
            rng.integers(0, n, m).astype(np.int32),
            rng.integers(1, 99, m).astype(np.int32),
            rng.integers(0, 1 << 20, (m, f)).astype(np.int32),
            rng.random(m) < 0.8)


@pytest.mark.parametrize("m", [40, 600])
def test_route_random(m):
    """Few distinct cells, so (row, dest) groups are deep and overflow;
    invalid entries interleaved; m = 600 spans several kernel waves;
    the ring starts partly filled."""
    rng = np.random.default_rng(m)
    hz, n, c, f = 32, 16, 3, 2
    ring = _ring(rng, 1, f, hz, n, c, fill=1)
    drops = _route_vs_pallas(ring, *_messages(rng, m, n, hz, f, 5))
    if m == 600:
        assert drops > 0


def test_route_arrival_past_the_ring():
    """Arrivals several horizons ahead land in row arrival % H, as the
    JAX launcher's reduced rows do."""
    rng = np.random.default_rng(5)
    hz, n, c, f = 16, 16, 3, 2
    ring = _ring(rng, 1, f, hz, n, c, fill=1)
    assert _route_vs_pallas(ring, *_messages(rng, 300, n, hz, f, 6),
                            wrap=7) > 0


def test_route_full_cell_drop_order():
    """cap 4, eight messages to one empty cell: the first four in input
    order take slots 0..3, the rest are dropped."""
    hz, n, c, f = 8, 8, 4, 2
    ring = _ring(np.random.default_rng(0), 1, f, hz, n, c, fill=0)
    m = 8
    msrc = np.arange(m, dtype=np.int32)
    drops = _route_vs_pallas(ring, np.full(m, 3, np.int32),
                             np.zeros(m, np.int32), msrc,
                             np.full(m, 5, np.int32),
                             np.stack([msrc, msrc], 1), np.ones(m, bool))
    assert drops == 4
    src_plane = torch.tensor(ring[1])
    route.bin_into_ring(*[torch.tensor(a) for a in ring[:1]], src_plane,
                        *[torch.tensor(a) for a in ring[2:]],
                        torch.full((1, m), 3, dtype=torch.int32),
                        torch.zeros((1, m), dtype=torch.int32),
                        torch.tensor(msrc)[None],
                        torch.full((1, m), 5, dtype=torch.int32),
                        torch.tensor(np.stack([msrc, msrc], 1))[None],
                        torch.ones((1, m), dtype=torch.bool))
    assert src_plane[0, 3, 0].tolist() == [0, 1, 2, 3]


def test_route_same_cell_tie_break():
    """Room for everyone: slots hold the senders in input order."""
    hz, n, c, f = 8, 6, 8, 3
    ring = _ring(np.random.default_rng(1), 1, f, hz, n, c, fill=0)
    m = 6
    msrc = np.arange(m, dtype=np.int32)[::-1].copy()
    assert _route_vs_pallas(ring, np.full(m, 2, np.int32),
                            np.full(m, 4, np.int32), msrc,
                            np.ones(m, np.int32),
                            np.stack([msrc] * f, 1),
                            np.ones(m, bool)) == 0


# ------------------------------------------------------ CUDA vs plain


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_route_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(2)
    hz, n, c, f, m = 64, 512, 4, 3, 20000
    ring = _ring(rng, 2, f, hz, n, c, fill=1)
    msg = [np.stack([a, b]) for a, b in zip(
        _messages(rng, m, n, hz, f, n), _messages(rng, m, n, hz, f, 40))]
    msg[0][1] += 5 * hz                 # arrivals past the ring wrap
    plain = [torch.tensor(a) for a in ring]
    kern = [torch.tensor(a, device=dev) for a in ring]
    dp = route.bin_into_ring(*plain, *[torch.tensor(a) for a in msg])
    dk = route.bin_into_ring(*kern, *[torch.tensor(a, device=dev)
                                      for a in msg])
    torch.cuda.synchronize()
    for a, b in zip(plain + [dp], kern + [dk]):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_merge_matches_plain():
    dev = _cuda()
    case = _merge_case(np.random.default_rng(3), 512, 16, 12, 64,
                       n_ids=2048)
    plain = merge.merge_queue(*[_i32(a) for a in case])
    kern = merge.merge_queue(*[_i32(a).to(dev) for a in case])
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_score_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(4)
    n, q, w, levels = 2048, 16, 64, 12
    args = [rng.integers(0, 2 ** 32, (n, q, w), dtype=np.uint32),
            rng.integers(0, levels, (n, q)).astype(np.int32),
            np.arange(n, dtype=np.int32)] + [
        rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32) for _ in range(3)]
    plain = score.score_queue(*[_i32(a) for a in args])
    kern = score.score_queue(*[_i32(a).to(dev) for a in args])
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_gsf_merge_matches_plain():
    dev = _cuda()
    case = _gsf_merge_case(np.random.default_rng(5), 512, 16, 16, 128,
                           n_ids=4096, levels=13)
    plain = gsf_merge.gsf_merge(*[_i32(a) for a in case], 13)
    kern = gsf_merge.gsf_merge(*[_i32(a).to(dev) for a in case], 13)
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_gsf_kernels_w1024_match_plain():
    """K4 and K5 at GSF 32k's width (W 1,024; K4's unstaged branch), 256
    rows, against their plain versions."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    n, q, w, levels = 256, 16, 1024, 16
    args = [rng.integers(0, 2 ** 32, (n, q, w), dtype=np.uint32),
            rng.integers(0, levels + 1, (n, q)).astype(np.int32),
            rng.choice(32 * w, n, replace=False).astype(np.int32)] + [
        rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32) for _ in range(2)]
    plain = score.gsf_score(*[_i32(a) for a in args])
    kern = score.gsf_score(*[_i32(a).to(dev) for a in args])
    case = _gsf_merge_case(rng, n, 16, 16, w, n_ids=32768, levels=levels)
    plain += gsf_merge.gsf_merge(*[_i32(a) for a in case], levels)
    kern += gsf_merge.gsf_merge(*[_i32(a).to(dev) for a in case], levels)
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_gsf_score_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(6)
    n, q, w, levels = 4096, 16, 128, 13
    args = [rng.integers(0, 2 ** 32, (n, q, w), dtype=np.uint32),
            rng.integers(0, levels, (n, q)).astype(np.int32),
            np.arange(n, dtype=np.int32)] + [
        rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32) for _ in range(2)]
    plain = score.gsf_score(*[_i32(a) for a in args])
    kern = score.gsf_score(*[_i32(a).to(dev) for a in args])
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


# ------------------------------------- route kernel's bucket index math


def _route_consts():
    """TILE, RT, CB_MIN and MAX_B as `csrc/route.cu` declares them."""
    import os
    import re
    path = os.path.join(os.path.dirname(route.__file__), os.pardir, "csrc",
                        "route.cu")
    with open(path) as f:
        text = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
            for k in ("TILE", "RT", "CB_MIN", "MAX_B")}


def _cells_per_bucket(cells):
    """`dims` in route.cu: CB_MIN cells a bucket, more (a multiple of 16)
    where that would make more than MAX_B buckets."""
    k = _route_consts()
    cb = -(-cells // k["MAX_B"])
    return k["CB_MIN"] if cb < k["CB_MIN"] else -(-cb // 16) * 16


def _warp_groups(keys):
    """Per lane of one warp: rank among the earlier lanes with the same
    key (`__popc(peers & lanemask_lt)`) and the group size."""
    rank = np.zeros(len(keys), np.int64)
    size = np.zeros(len(keys), np.int64)
    for lane, k in enumerate(keys):
        same = keys == k
        rank[lane] = same[:lane].sum()
        size[lane] = same.sum()
    return rank, size


def _bucket_model(arrival, dest, valid, count, cb):
    """numpy model of `route_bucket_kernel` for one seed, with cb cells a
    bucket: per tile of TILE messages, the members sorted stably by
    bucket (cell // cb, cells row-major) into the tile's stretch of the
    lists, and the tile's segment starts off[t, 0..B] from the [32 x B]
    warp-count table.  Returns the lists as message indices (where the
    kernel copies the message's fields), the cells within the bucket,
    the cells' counts before the batch, and off."""
    tile = _route_consts()["TILE"]
    hz, n = count.shape
    m = len(arrival)
    n_t = max(1, -(-m // tile))
    n_b = max(1, -(-(hz * n) // cb))
    lidx = np.full(n_t * tile, -1, np.int64)
    lkey = np.full(n_t * tile, -1, np.int64)
    lcnt = np.full(n_t * tile, -1, np.int64)
    off = np.zeros((n_t, n_b + 1), np.int64)
    for t in range(n_t):
        i = np.arange(t * tile, (t + 1) * tile)
        ic = np.minimum(i, m - 1)
        ok = (i < m) & valid[ic] & (dest[ic] >= 0) & (dest[ic] < n)
        cell = (arrival[ic] % hz) * n + dest[ic]
        b = np.where(ok, cell // cb, -1)
        rank_w = np.zeros(tile, np.int64)
        size_w = np.zeros(tile, np.int64)
        for w in range(tile // 32):
            sl = slice(32 * w, 32 * w + 32)
            rank_w[sl], size_w[sl] = _warp_groups(b[sl])
        warp = np.arange(tile) // 32
        wc = np.zeros((tile // 32, n_b), np.int64)
        lead = ok & (rank_w == 0)
        wc[warp[lead], b[lead]] = size_w[lead]
        wex = np.cumsum(wc, 0) - wc
        tot = wc.sum(0)
        seg = np.cumsum(tot) - tot
        pos = seg[b] + wex[warp, b] + rank_w
        off[t, :n_b] = seg
        off[t, n_b] = ok.sum()
        at = t * tile + pos[ok]
        lidx[at] = i[ok]
        lkey[at] = cell[ok] % cb
        lcnt[at] = count.reshape(-1)[cell[ok]]
    return lidx, lkey, lcnt, off


def _bucket_members(lidx, off, b, tile):
    """Bucket b's list as the rank kernel walks it: each tile's segment
    off[t, b] .. off[t, b+1], tiles in order."""
    return np.concatenate([lidx[t * tile + off[t, b]:t * tile + off[t, b + 1]]
                           for t in range(off.shape[0])])


def _rank_model(ring, lidx, lkey, lcnt, off, cb, msrc, msize, payload,
                rt=None):
    """numpy model of `route_rank_kernel` for one seed, in place on the
    ring arrays; returns dropped.  Tile groups of RT, chunks of RT
    members, each member found by the binary search over the group's
    member prefix; a member's slot is its cell's count before the
    batch, the bucket's running count of the cell, the group sizes of
    the chunk's earlier warps and its rank in its warp; the last warp
    holding a cell advances the running count and writes the count."""
    k = _route_consts()
    tile, rt = k["TILE"], rt or k["RT"]
    f, hz, n, c = ring[0].shape[1:]
    data = ring[0][0].reshape(f, hz * n, c)       # views, cells row-major
    src = ring[1][0].reshape(hz * n, c)
    size = ring[2][0].reshape(hz * n, c)
    count = ring[3][0].reshape(-1)
    n_t, n_b = off.shape[0], off.shape[1] - 1
    dropped = 0
    for b in range(n_b):
        run = np.zeros(cb, np.int64)
        for t0 in range(0, n_t, rt):
            ts = np.arange(t0, min(n_t, t0 + rt))
            lens = off[ts, b + 1] - off[ts, b]
            pre = np.cumsum(lens) - lens
            segst = ts * tile + off[ts, b]
            total = int(lens.sum())
            for c0 in range(0, total, rt):
                js = np.arange(c0, min(total, c0 + rt))
                s = np.searchsorted(pre, js, side="right") - 1
                at = segst[s] + js - pre[s]
                mi, key, cnt0 = lidx[at], lkey[at], lcnt[at]
                posted = []                     # per warp: {key: size}
                for w0 in range(0, len(js), 32):
                    rank_w, size_w = _warp_groups(key[w0:w0 + 32])
                    posted.append((rank_w, size_w))
                sizes = [dict(zip(key[32 * w:32 * w + 32], sz))
                         for w, (_, sz) in enumerate(posted)]
                new_run = run.copy()
                for w, (rank_w, _) in enumerate(posted):
                    for lane in range(len(rank_w)):
                        j = 32 * w + lane
                        kk = key[j]
                        before = run[kk] + sum(sizes[v].get(kk, 0)
                                               for v in range(w))
                        if rank_w[lane] == 0 and not any(
                                kk in sizes[v]
                                for v in range(w + 1, len(sizes))):
                            new_run[kk] = before + sizes[w][kk]
                            cell = b * cb + kk
                            count[cell] = cnt0[j] + max(
                                0, min(c - cnt0[j], new_run[kk]))
                        slot = cnt0[j] + before + rank_w[lane]
                        if slot < c:
                            cell = b * cb + kk
                            data[:, cell, slot] = payload[mi[j]]
                            src[cell, slot] = msrc[mi[j]]
                            size[cell, slot] = msize[mi[j]]
                        else:
                            dropped += 1
                run = new_run
    return dropped


def _route_model_cases():
    """The route cases of the tests above (random 40 and 600, arrivals
    past the ring, the full-cell drop order, the same-cell tie break),
    plus three tiles of messages over 300 destinations."""
    cases = {}
    for m in (40, 600):
        rng = np.random.default_rng(m)
        ring = _ring(rng, 1, 2, 32, 16, 3, fill=1)
        cases[f"random{m}"] = (ring, _messages(rng, m, 16, 32, 2, 5))
    rng = np.random.default_rng(5)
    ring = _ring(rng, 1, 2, 16, 16, 3, fill=1)
    msg = list(_messages(rng, 300, 16, 16, 2, 6))
    msg[0] = msg[0] + 7 * 16
    cases["past_ring"] = (ring, tuple(msg))
    msrc = np.arange(8, dtype=np.int32)
    cases["full_cell"] = (
        _ring(np.random.default_rng(0), 1, 2, 8, 8, 4, fill=0),
        (np.full(8, 3, np.int32), np.zeros(8, np.int32), msrc,
         np.full(8, 5, np.int32), np.stack([msrc, msrc], 1),
         np.ones(8, bool)))
    msrc = np.arange(6, dtype=np.int32)[::-1].copy()
    cases["tie_break"] = (
        _ring(np.random.default_rng(1), 1, 3, 8, 6, 8, fill=0),
        (np.full(6, 2, np.int32), np.full(6, 4, np.int32), msrc,
         np.ones(6, np.int32), np.stack([msrc] * 3, 1), np.ones(6, bool)))
    rng = np.random.default_rng(8)
    ring = _ring(rng, 1, 2, 16, 300, 4, fill=1)
    cases["three_tiles"] = (ring, _messages(rng, 2500, 300, 16, 2, 300))
    return cases


@pytest.mark.parametrize("cells", ["kernel", 16], ids=["cb_kernel",
                                                       "cb_16"])
@pytest.mark.parametrize("case", ["random40", "random600", "past_ring",
                                  "full_cell", "tie_break", "three_tiles"])
def test_route_bucket_model(case, cells):
    """The route kernel's index math, rehearsed in numpy: the bucket
    lists, read bucket by bucket as the rank kernel reads them, are the
    stable argsort of the valid messages by bucket; ranking them as the
    rank kernel does reproduces `bin_into_ring_plain` (tile groups of 2
    in a second pass, to walk several groups).  Once with the kernel's
    cells per bucket, once with 16, for many buckets."""
    tile = _route_consts()["TILE"]
    ring, (arrival, dest, msrc, msize, payload, valid) = \
        _route_model_cases()[case]
    _, f, hz, n, c = ring[0].shape
    cb = _cells_per_bucket(hz * n) if cells == "kernel" else cells
    lidx, lkey, lcnt, off = _bucket_model(arrival, dest, valid, ring[3][0],
                                          cb)
    lists = np.concatenate([_bucket_members(lidx, off, b, tile)
                            for b in range(off.shape[1] - 1)])
    members = np.nonzero(valid)[0]
    cell = (arrival[members] % hz) * n + dest[members]
    want = members[np.argsort(cell // cb, kind="stable")]
    np.testing.assert_array_equal(lists, want)

    plain = [torch.tensor(a) for a in ring]
    dp = route.bin_into_ring_plain(
        *plain, torch.tensor(arrival)[None],
        *[torch.tensor(a)[None] for a in (dest, msrc, msize, payload,
                                          valid)])
    for rt in (None, 2):
        model = [a.copy() for a in ring]
        dm = _rank_model(model, lidx, lkey, lcnt, off, cb, msrc, msize,
                         payload, rt)
        for name, a, b in zip(("data", "src", "size", "count"), plain,
                              model):
            _eq(b, a, f"{name} (rt {rt})")
        assert dm == int(dp[0])


def test_route_cells_per_bucket():
    """Buckets hold CB_MIN cells until the ring has more than
    CB_MIN x MAX_B cells, then grow (in multiples of 16) so that there
    are at most MAX_B."""
    k = _route_consts()
    assert _cells_per_bucket(256 * 2048) == k["CB_MIN"]
    big = 3 * k["CB_MIN"] * k["MAX_B"] + 5
    cb = _cells_per_bucket(big)
    assert cb % 16 == 0 and -(-big // cb) <= k["MAX_B"]


def _route_cuda_vs_plain(ring, msg):
    dev = _cuda()
    plain = [torch.tensor(a) for a in ring]
    kern = [torch.tensor(a, device=dev) for a in ring]
    dp = route.bin_into_ring(*plain, *[torch.tensor(a) for a in msg])
    dk = route.bin_into_ring(*kern, *[torch.tensor(a, device=dev)
                                      for a in msg])
    torch.cuda.synchronize()
    for a, b in zip(plain + [dp], kern + [dk]):
        assert torch.equal(a, b.cpu())
    return int(dp.sum())


def _route_cuda_case(name):
    """(ring, messages [R, ...]) for the route kernel's layout limits."""
    k = _route_consts()
    rng = np.random.default_rng(len(name))
    if name == "one_cell":              # one bucket holds all of M
        hz, n, c, f, m = 16, 64, 6, 2, 20000
        msg = list(_messages(rng, m, n, hz, f, n))
        msg[0][:], msg[1][:], msg[5][:] = 7 + 3 * hz, 33, True
    elif name == "ragged_tile":         # M not a multiple of the tile
        hz, n, c, f, m = 32, 256, 4, 3, 3 * k["TILE"] + 77
        msg = list(_messages(rng, m, n, hz, f, n))
    elif name == "no_valid":
        hz, n, c, f, m = 32, 256, 4, 3, 5000
        msg = list(_messages(rng, m, n, hz, f, n))
        msg[5][:] = False
    elif name == "max_buckets":         # MAX_B buckets of CB_MIN cells
        hz, n, c, f, m = 64, k["CB_MIN"] * k["MAX_B"] // 64, 2, 1, 60000
        msg = list(_messages(rng, m, n, hz, f, n))
        msg[1][: m // 10] = rng.integers(0, 40, m // 10)
    else:                               # "tables_in_scratch": wider ring
        hz, n, c, f, m = 2, 9_000_000, 1, 1, 60000
        msg = list(_messages(rng, m, n, hz, f, n))
        msg[0][: m // 10], msg[1][: m // 10] = 5, 123    # one deep cell
    ring = _ring(rng, 1, f, hz, n, c, fill=1)
    return ring, [a[None] for a in msg]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_cell", "ragged_tile", "no_valid",
                                  "max_buckets", "tables_in_scratch"])
def test_cuda_route_layouts(case):
    """The route kernel bit-equal to its plain version where its layout
    has limits: one bucket holding every message, a ragged last tile,
    no valid message, the most buckets (the bucket kernel's largest
    table), and a ring so wide that a bucket's tables go to device
    scratch (the rank kernel's second path)."""
    ring, msg = _route_cuda_case(case)
    drops = _route_cuda_vs_plain(ring, msg)
    if case == "one_cell":
        assert drops > 0
    if case == "no_valid":
        assert drops == 0


def _route_pingpong_case(name, r):
    """PingPong's K1 batches at its ring's shapes (H 1024, N 1000, C 32,
    F 1): ``window``, one K = 2 window of pongs (M = 2 x 1000 a seed,
    1% valid, all to the witness, rel in [2, H]); ``drain``, a spill
    drain of S = 4096 entries, half selected, rel in [1, H - 2], to any
    node.  The ring starts empty but for a few counts."""
    rng = np.random.default_rng(len(name) + r)
    hz, n, c, f, t = 1024, 1000, 32, 1, 4096 + 6
    data = np.zeros((r, f, hz, n, c), np.int32)
    src = np.zeros((r, hz, n, c), np.int32)
    size = np.zeros((r, hz, n, c), np.int32)
    count = rng.integers(0, 3, (r, hz, n)).astype(np.int32)
    if name == "window":
        m, lo, hi, share, dests = 2 * n, 2, hz + 1, 0.01, 1
    else:
        m, lo, hi, share, dests = 4096, 1, hz - 1, 0.5, n
    msg = [t + rng.integers(lo, hi, (r, m)), rng.integers(0, dests, (r, m)),
           rng.integers(0, n, (r, m)), rng.integers(1, 9, (r, m)),
           rng.integers(0, 2, (r, m, f))]
    valid = rng.random((r, m)) < share
    return (data, src, size, count), [a.astype(np.int32) for a in msg] + [
        valid]


@pytest.mark.cuda
@pytest.mark.parametrize("name,r", [("window", 2), ("drain", 1)])
def test_cuda_route_pingpong_batches(name, r):
    """K1 on PingPong's own batches (its K = 2 window of pongs, two
    seeds, and a spill drain) bit-equal to its plain version."""
    ring, msg = _route_pingpong_case(name, r)
    assert msg[5].sum() > 0
    _route_cuda_vs_plain(ring, msg)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,levels", [(64, 5, 7), (4096, 16, 13)],
                         ids=["odd_q_w2", "q16_w128"])
def test_cuda_gsf_score_shapes(n, q, levels):
    """W 2 with odd Q (rows not 16-byte multiples: the ordinary-load
    path) and the GSF path's Q 16, W 128 (bulk copies), with node ids
    not equal to the row index."""
    dev = _cuda()
    rng = np.random.default_rng(n + q)
    w = n // 32
    args = [rng.integers(0, 2 ** 32, (n, q, w), dtype=np.uint32),
            rng.integers(0, levels, (n, q)).astype(np.int32),
            rng.permutation(n).astype(np.int32)] + [
        rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32) for _ in range(2)]
    plain = score.gsf_score(*[_i32(a) for a in args])
    kern = score.gsf_score(*[_i32(a).to(dev) for a in args])
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


# ------------------------------ merge and score kernels' warp designs


def _warp_merge_model(case):
    """numpy model of `csrc/merge.cu`'s narrow path, one warp per row:
    lane c holds candidate c; its match group is the lanes with the same
    (from, lvl) (`__match_any_sync`); an ok inbox lane is dropped if its
    group holds a later ok inbox lane, a queued lane if its group holds a
    kept inbox lane; output position = count of smaller keys; columns and
    sig rows gathered through the position map."""
    q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all, ok, \
        sig_all = case
    n, q = q_from.shape
    s = src.shape[1]
    c_all = q + s
    big0 = 0x7FFFFF00
    out = [np.zeros((n, q), np.int32) for _ in range(3)] + [
        np.zeros((n, q), bool), np.zeros_like(q_sig)]
    evicted = 0
    for i in range(n):
        frm = np.concatenate([q_from[i], src[i]]).astype(np.int64)
        lvl = np.concatenate([q_lvl[i], level[i]]).astype(np.int64)
        rnk = np.concatenate([q_rank[i], rank_all[i]]).astype(np.int64)
        bad = np.concatenate([q_bad[i], np.zeros(s, bool)])
        lane = np.arange(c_all)
        inbox = lane >= q
        raw_ok = np.concatenate([np.zeros(q, bool), ok[i]])
        key64 = (frm & 0xFFFFFFFF) << 32 | (lvl & 0xFFFFFFFF)
        peers = key64[:, None] == key64[None, :]          # [lane, other]
        ok_in = inbox & raw_ok
        keep_inc = ok_in & ~(peers & ok_in[None, :] &
                             (lane[None, :] > lane[:, None])).any(1)
        ex_keep = ~inbox & (frm >= 0) & ~(peers & keep_inc[None, :]).any(1)
        valid = np.where(inbox, keep_inc, ex_keep)
        key = np.where(valid, rnk * (c_all + 1) + lane, big0 + lane)
        pos = (key[None, :] < key[:, None]).sum(1)
        from_c = np.zeros(q, np.int64)
        from_c[pos[pos < q]] = lane[pos < q]
        evicted += int(ex_keep.sum() - (ex_keep & (pos < q)).sum())
        out[0][i] = np.where(valid, frm, -1)[from_c]
        out[1][i] = lvl[from_c]
        out[2][i] = rnk[from_c]
        out[3][i] = bad[from_c]
        rows = np.concatenate([q_sig[i], sig_all[i]])
        out[4][i] = rows[from_c]
    return out + [np.int32(evicted)]


@pytest.mark.parametrize("q_cap,s_cap,w,seed", [(16, 12, 64, 0),
                                                (8, 4, 2, 1), (4, 16, 8, 2),
                                                (16, 16, 4, 3)])
def test_merge_warp_model(q_cap, s_cap, w, seed):
    """The merge kernel's warp arithmetic (match groups for dup and
    supersede, position = count of smaller keys) against the plain
    version, on random rows with planted collisions, empty and full
    queues among them."""
    rng = np.random.default_rng(40 + seed)
    case = _merge_case(rng, 48, q_cap, s_cap, w, n_ids=64, dup_rate=0.3)
    case[0][:4] = -1                                    # empty queues
    case[0][4:8] = np.abs(case[0][4:8])                 # full queues
    got = _warp_merge_model(case)
    want = merge.merge_queue_plain(*[_i32(a) for a in case])
    for name, a, b in zip(("from", "lvl", "rank", "bad", "sig", "evicted"),
                          want, got):
        _eq(b, a, name)


def _level_range(ids, lvl):
    """`level_range` of csrc/warp_util.cuh, elementwise: the range's first
    word w0, its word count nw and the word mask pm."""
    ids = ids.astype(np.int64)
    lvl = lvl.astype(np.int64)
    h = np.where(lvl > 0, 1 << np.clip(lvl - 1, 0, 30), 0)
    h_nz = np.maximum(h, 1)
    base = np.where(h > 0, (ids & ~(2 * h_nz - 1)) +
                    np.where(ids & h_nz, 0, h_nz), 0)
    nw = np.where(h >= 32, h >> 5, 1)
    pm = np.where(h >= 32, 0xFFFFFFFF,
                  np.where(h == 0, 0, ((1 << np.minimum(h, 31)) - 1)
                           << (base & 31))) & 0xFFFFFFFF
    return base >> 5, nw, pm


def _popc(a):
    a = a.astype(np.uint64)
    return np.unpackbits(a.astype(np.uint32).view(np.uint8)).reshape(
        a.shape + (32,)).sum(-1).astype(np.int64)


def _warp_score_model(sig, lvl, ids, inc, ver, agg):
    """numpy model of `csrc/score.cu`'s vector path: pc_sig over every
    word; x_all = popc((inc_e | ver_e) & ~sig), x_sv = popc(ver_e & ~sig)
    and the hit flags over the 16-byte vectors of the level range only;
    the lanes' sums packed two fields a word as the kernel packs them
    (each field checked against its width); s_inc = hit_inc ? n_sv :
    n_all."""
    m, q, w = sig.shape
    nv = w // 4
    sig = sig.astype(np.uint32)
    w0, nw, pm = _level_range(np.repeat(ids[:, None], q, 1), lvl)
    word = np.arange(w)
    em = np.where((word[None, None] >= w0[..., None]) &
                  (word[None, None] < (w0 + nw)[..., None]), pm[..., None],
                  0).astype(np.uint32)
    vec = np.arange(nv)
    in_rng = ((4 * vec[None, None] < (w0 + nw)[..., None]) &
              (4 * vec[None, None] + 4 > w0[..., None]) &
              (pm != 0)[..., None])                       # [m, q, nv]
    in_word = np.repeat(in_rng, 4, -1)
    inc_e = inc.astype(np.uint32)[:, None] & em
    ver_e = ver.astype(np.uint32)[:, None] & em
    agg_e = agg.astype(np.uint32)[:, None] & em
    n_sig = _popc(sig).sum(-1)
    x_all = np.where(in_word, _popc((inc_e | ver_e) & ~sig), 0).sum(-1)
    x_sv = np.where(in_word, _popc(ver_e & ~sig), 0).sum(-1)
    hit_inc = (np.where(in_word, sig & inc_e, 0).reshape(m, q, nv, 4) != 0
               ).any(-1).sum(-1)
    hit_agg = (np.where(in_word, sig & agg_e, 0).reshape(m, q, nv, 4) != 0
               ).any(-1).sum(-1)
    assert n_sig.max() < 1 << 16 and x_sv.max() < 1 << 16
    assert x_all.max() < 1 << 16 and max(hit_inc.max(), hit_agg.max()) < 256
    p1 = (n_sig + (x_sv << 16)) & 0xFFFFFFFF
    p2 = (x_all + (hit_inc << 16) + (hit_agg << 24)) & 0xFFFFFFFF
    pc_sig = p1 & 0xFFFF
    n_sv = pc_sig + (p1 >> 16)
    n_all = pc_sig + (p2 & 0xFFFF)
    s_inc = np.where((p2 >> 16) & 0xFF, n_sv, n_all)
    return s_inc, pc_sig, n_sv, (p2 >> 24) != 0


@pytest.mark.parametrize("n,q,w,fill", [(2048, 4, 64, None),
                                        (256, 8, 8, None),
                                        (4096, 3, 128, None),
                                        (8192, 2, 256, None),
                                        (2048, 4, 64, 0),
                                        (2048, 4, 64, 0xFFFFFFFF)])
def test_score_range_model(n, q, w, fill):
    """The score kernel's range-only identities for n_all, n_sv and the
    two hits, with its packed sums, against the plain version: every
    level 0..log2(n) present, node ids spread over n, random rows or
    all-zero / all-ones sigs against all-ones / all-zero rows."""
    rng = np.random.default_rng(n + q + w)
    levels = int(np.log2(n)) + 1
    m = 48
    ids = rng.choice(n, m, replace=False).astype(np.int32)
    lvl = rng.integers(0, levels, (m, q)).astype(np.int32)
    lvl.reshape(-1)[:levels] = np.arange(levels)
    if fill is None:
        sig = rng.integers(0, 2 ** 32, (m, q, w), dtype=np.uint32)
        rows = [rng.integers(0, 2 ** 32, (m, w), dtype=np.uint32)
                for _ in range(3)]
    else:
        sig = np.full((m, q, w), fill, np.uint32)
        rows = [np.full((m, w), 0xFFFFFFFF - fill, np.uint32),
                np.full((m, w), 0xFFFFFFFF, np.uint32),
                np.full((m, w), 0xFFFFFFFF - fill, np.uint32)]
    got = _warp_score_model(sig, lvl, ids, *rows)
    want = score.score_queue_plain(*[_i32(a) for a in (sig, lvl, ids,
                                                        *rows)])
    for name, a, b in zip(("s_inc", "pc_sig", "pc_sv", "inter_agg"), want,
                          got):
        _eq(b, a, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,s,w,offset", [
    (2048, 16, 12, 64, 0), (512, 32, 32, 64, 0), (64, 8, 4, 2, 0),
    (256, 16, 12, 8, 0), (512, 16, 16, 128, 0), (512, 16, 12, 64, 1)],
    ids=["path", "c64_wide", "w2", "w8", "w128", "unaligned"])
def test_cuda_merge_shapes(n, q, s, w, offset):
    """The merge kernel bit-equal to its plain version: at the Handel
    path's shapes; at C = 64 > 32 (the wide path); at W 2 (word-by-word
    gather), W 8 and W 128; and with sig rows 4 bytes off a 16-byte
    boundary (the word-by-word gather at W 64)."""
    dev = _cuda()
    rng = np.random.default_rng(n + q + s + w + offset)
    case = _merge_case(rng, n, q, s, w, n_ids=max(64, n))
    case[0][:8] = -1
    case[0][8:16] = np.abs(case[0][8:16])
    plain = merge.merge_queue(*[_i32(a) for a in case])
    args = [_i32(a).to(dev) for a in case]
    if offset:
        for i in (4, 9):                # sig planes at an odd word offset
            flat = torch.empty(args[i].numel() + offset, dtype=torch.int32,
                               device=dev)
            args[i] = flat[offset:].view(args[i].shape).copy_(args[i])
    kern = merge.merge_queue(*args)
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,w,fill", [
    (2048, 16, 64, None), (2048, 16, 64, 0), (2048, 16, 64, 0xFFFFFFFF),
    (64, 5, 2, None), (256, 16, 8, None), (4096, 16, 128, None),
    (8192, 16, 256, None), (32768, 3, 1024, None)],
    ids=["path", "path_zero", "path_ones", "w2", "w8", "w128", "w256",
         "w1024"])
def test_cuda_score_shapes(n, q, w, fill):
    """The score kernel bit-equal to its plain version, every level
    0..log2(n) present, node ids permuted: at the path's shapes with
    random, all-zero and all-ones sigs (against all-ones and all-zero
    rows); W 2 (ordinary loads), W 8 (sixteen entries a pass), W 128 (one
    entry a pass), W 256 (two vectors a lane), W 1024 (beyond the packed
    sums: ordinary loads)."""
    dev = _cuda()
    rng = np.random.default_rng(n + q + w)
    levels = int(np.log2(n)) + 1
    m = min(n, 2048)
    ids = rng.permutation(n)[:m].astype(np.int32)
    lvl = rng.integers(0, levels, (m, q)).astype(np.int32)
    lvl.reshape(-1)[:levels] = np.arange(levels)
    if fill is None:
        sig = rng.integers(0, 2 ** 32, (m, q, w), dtype=np.uint32)
        rows = [rng.integers(0, 2 ** 32, (m, w), dtype=np.uint32)
                for _ in range(3)]
    else:
        sig = np.full((m, q, w), fill, np.uint32)
        rows = [np.full((m, w), 0xFFFFFFFF - fill, np.uint32)] * 3
    args = [sig, lvl, ids] + rows
    plain = score.score_queue(*[_i32(a) for a in args])
    kern = score.score_queue(*[_i32(a).to(dev) for a in args])
    torch.cuda.synchronize()
    assert kern[3].dtype == torch.bool
    for a, b in zip(plain, kern):
        assert torch.equal(a, b.cpu())


# ------------------------------------------- the seed-folded engine's shapes


@pytest.mark.cuda
def test_cuda_route_seed_batch_window():
    """The route kernel with R = 4 seeds on one K=2 window's batch (the
    seed axis is the kernel's grid.y): arrivals t + rel for rel in
    [2, H], some on the just-cleared rows, bit-equal to the plain
    version."""
    rng = np.random.default_rng(21)
    r, hz, n, c, f, m, t = 4, 256, 2048, 12, 3, 2 * 2048 * 21, 6
    ring = list(_ring(rng, r, f, hz, n, c, fill=1))
    ring[3][:, t:t + 2] = 0
    msg = [np.stack(a) for a in zip(*[_messages(rng, m, n, hz, f, n)
                                      for _ in range(r)])]
    msg[0] = t + rng.integers(2, hz + 1, (r, m)).astype(np.int32)
    msg[0][:, ::9] = t + hz
    assert _route_cuda_vs_plain(ring, msg) > 0


def _vmapped(fn, args, in_dims, dev):
    got = torch.func.vmap(fn, in_dims=in_dims)(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    return [g.cpu() for g in got]


@pytest.mark.cuda
def test_cuda_merge_vmap_rule():
    """K2 through its vmap rule (16 seeds x 2048 rows folded into one
    launch of 32,768 rows, evictions counted per seed) against the plain
    version called per seed."""
    dev = _cuda()
    r, n = 16, 2048
    cases = [_merge_case(np.random.default_rng(40 + i), n, 16, 12, 64,
                         n_ids=n, fill=0.9) for i in range(r)]
    args = [torch.stack([_i32(c[j]) for c in cases]) for j in range(10)]
    before = merge.merge_queue.launches
    got = _vmapped(merge.merge_queue, args, 0, dev)
    assert merge.merge_queue.launches == before + 1
    for i in range(r):
        want = merge.merge_queue(*[a[i] for a in args])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    assert got[5].sum() > 0


@pytest.mark.cuda
def test_cuda_score_vmap_rule():
    """K3 through its vmap rule, the node ids unbatched (repeated per
    seed), 16 seeds x 2048 rows in one launch."""
    dev = _cuda()
    rng = np.random.default_rng(41)
    r, n, q, w, levels = 16, 2048, 16, 64, 12
    args = [_i32(rng.integers(0, 2 ** 32, (r, n, q, w), dtype=np.uint32)),
            _i32(rng.integers(0, levels, (r, n, q)).astype(np.int32)),
            torch.arange(n, dtype=torch.int32)] + [
        _i32(rng.integers(0, 2 ** 32, (r, n, w), dtype=np.uint32))
        for _ in range(3)]
    before = score.score_queue.launches
    got = _vmapped(score.score_queue, args, (0, 0, None, 0, 0, 0), dev)
    assert score.score_queue.launches == before + 1
    for i in range(r):
        want = score.score_queue(args[0][i], args[1][i], args[2],
                                 *[a[i] for a in args[3:]])
        for g, w_ in zip(got, want):
            assert torch.equal(g[i], w_)


# ------------------------------------------- Handel's scale modes' shapes


def _cuda_ints(g, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32,
                         device="cuda")


def _cuda_window(g, r, f, hz, n, c, m, t, n_dest, lo=0):
    """A ring (counts part full, eight full rows) and one K=2 window's
    messages, made on the card: arrivals t + [2, H], dests in
    [lo, lo + n_dest), 70% valid."""
    ring = [_cuda_ints(g, 0, 1 << 20, (r, f, hz, n, c)),
            _cuda_ints(g, 0, n, (r, hz, n, c)),
            _cuda_ints(g, 0, 300, (r, hz, n, c)),
            _cuda_ints(g, 0, 4, (r, hz, n))]
    ring[3][:, :8] = c
    ring[3][:, t % hz:t % hz + 2] = 0
    msg = [t + _cuda_ints(g, 2, hz + 1, (r, m)),
           lo + _cuda_ints(g, 0, n_dest, (r, m)),
           _cuda_ints(g, 0, n, (r, m)), _cuda_ints(g, 1, 300, (r, m)),
           _cuda_ints(g, 0, 1 << 20, (r, m, f)),
           torch.rand((r, m), generator=g, device="cuda") < 0.7]
    return ring, msg


def _route_kernel_vs_plain(ring, msg):
    plain = [x.clone() for x in ring]
    kern = [x.clone() for x in ring]
    dp = route.bin_into_ring_plain(*plain, *msg)
    dk = route.bin_into_ring(*kern, *msg)
    torch.cuda.synchronize()
    for a, b in zip(plain + [dp], kern + [dk]):
        assert torch.equal(a, b)
    return kern


@pytest.mark.cuda
def test_cuda_route_tier3_window():
    """K1 at the tier-3 line's shapes (cardinal 65,536 nodes: H 256, C
    12, F 2, one K=2 window of 2 x 65,536 x 26 sends): H*N is 16.8 M
    cells, so a bucket is 8,192 cells and its rank tables (160 KB) live
    in device scratch, the rank kernel's global-table branch; bit-equal
    to the plain version."""
    _cuda()
    k = _route_consts()
    hz, n = 256, 65536
    cb = _cells_per_bucket(hz * n)
    assert cb == 8192 and cb * (4 + k["RT"] // 32) > 96 * 1024
    g = torch.Generator("cuda").manual_seed(8)
    ring, msg = _cuda_window(g, 1, 2, hz, n, 12, 2 * n * 26, 600, n)
    _route_kernel_vs_plain(ring, msg)


@pytest.mark.cuda
def test_cuda_route_sub_planes():
    """K1 on a ring split into 2 node-range sub-planes (the tier-2 line:
    32,768 nodes, H 256, C 12, F 3, a K=2 window of 2 x 32,768 x 25
    sends), through the engine's `_bin_into_ring`: one launch a
    sub-plane, each bit-equal to the plain version on its own messages,
    and the sub-planes side by side equal to the unsplit ring binned in
    one launch."""
    from wittgenstein_tpu_torch.core.network import RING, _bin_into_ring
    _cuda()
    hz, n, c, f, ns = 256, 32768, 12, 3, 16384
    g = torch.Generator("cuda").manual_seed(9)
    ring, msg = _cuda_window(g, 1, f, hz, n, c, 2 * n * 25, 600, n)
    whole = dict(zip(RING, (x.clone() for x in ring)))
    subs = {k: tuple(x.narrow(x.dim() - (1 if k == "box_count" else 2),
                              j * ns, ns).contiguous() for j in range(2))
            for k, x in zip(RING, ring)}
    for j in range(2):
        d = msg[1] - j * ns
        _route_kernel_vs_plain(
            [subs[k][j].clone() for k in RING],
            msg[:1] + [d] + msg[2:5] + [msg[5] & (d >= 0) & (d < ns)])
    before = route.bin_into_ring.launches
    d_split = _bin_into_ring(subs, *msg)
    assert route.bin_into_ring.launches == before + 2
    d_whole = _bin_into_ring(whole, *msg)
    torch.cuda.synchronize()
    assert torch.equal(d_split, d_whole)
    for k in RING:
        axis = whole[k].dim() - (1 if k == "box_count" else 2)
        assert torch.equal(torch.cat(subs[k], axis), whole[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("piece", ["own", "slice"])
def test_cuda_merge_score_w1024_piece(piece):
    """K2 and K3 at the tier-2 line's shapes: one q_sig piece of 16,384
    rows, Q 16, S 12, W 1,024 (32,768 nodes in two pieces), as its own
    tensor (the merge's output) or as the second half of a 32,768-row
    tensor (16-byte aligned all the same: the vector gathers run);
    bit-equal to the plain versions on the card."""
    from wittgenstein_tpu_torch.ops.merge import merge_queue_plain
    from wittgenstein_tpu_torch.ops.score import score_queue_plain
    _cuda()
    m, q, s, w, levels = 16384, 16, 12, 1024, 16
    g = torch.Generator("cuda").manual_seed(10)
    sig = _cuda_ints(g, -2 ** 31, 2 ** 31 - 1, (2 * m, q, w))
    q_sig = sig[m:] if piece == "slice" else sig[m:].clone()
    assert q_sig.is_contiguous() and q_sig.data_ptr() % 16 == 0
    q_from = torch.where(torch.rand((m, q), generator=g, device="cuda")
                         < 0.7, _cuda_ints(g, 0, 2 * m, (m, q)), -1)
    q_lvl = _cuda_ints(g, 0, levels, (m, q))
    src = _cuda_ints(g, 0, 2 * m, (m, s))
    level = _cuda_ints(g, 0, levels, (m, s))
    dup = torch.rand((m, s), generator=g, device="cuda") < 0.3
    src = torch.where(dup, q_from[:, :s].abs(), src)
    level = torch.where(dup, q_lvl[:, :s], level)
    args = [q_from, q_lvl, _cuda_ints(g, 0, 4 * m, (m, q)),
            torch.rand((m, q), generator=g, device="cuda") < 0.2, q_sig,
            src, level, _cuda_ints(g, 0, 4 * m, (m, s)),
            torch.rand((m, s), generator=g, device="cuda") < 0.6,
            _cuda_ints(g, -2 ** 31, 2 ** 31 - 1, (m, s, w))]
    for a, b in zip(merge_queue_plain(*args), merge.merge_queue(*args)):
        assert torch.equal(a, b)
    ids = m + torch.arange(m, dtype=torch.int32, device="cuda")
    rows = [_cuda_ints(g, -2 ** 31, 2 ** 31 - 1, (m, w)) for _ in range(3)]
    sargs = [q_sig, q_lvl, ids] + rows
    for a, b in zip(score_queue_plain(*sargs), score.score_queue(*sargs)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
