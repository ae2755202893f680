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


def _gsf_score_vs_pallas(sig, elvl, ver, ind):
    import jax.numpy as jnp

    from wittgenstein_tpu.ops.pallas_score import gsf_score_pallas
    n = sig.shape[0]
    ids = np.arange(n, dtype=np.int32)
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
