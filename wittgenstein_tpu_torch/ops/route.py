"""Mailbox-ring binning — the port of the TPU routing kernel
`wittgenstein_tpu/ops/pallas_route.py` (`_make_kernel`, launched by
`bin_into_ring_planes`).

`bin_into_ring` bins one batch of messages into the ring planes.  On a
CUDA tensor it launches the hand-written kernel `csrc/route.cu`; on a
CPU tensor it runs `bin_into_ring_plain`, the plain PyTorch version of
the same function (the XLA branch of `core/network._bin_into_ring`,
wittgenstein_tpu/core/network.py:233-285).

Layout, with a leading seed axis R as the JAX launcher has it:
ring payload planes ``data [R, F, H, N, C]``, ``src``/``size``
``[R, H, N, C]``, ``count [R, H, N]``; messages ``arrival``, ``dest``,
``msrc``, ``msize``, ``valid`` (bool) ``[R, M]`` and ``payload [R, M, F]``.
A message goes to ring row ``arrival % H``, so the JAX launcher's
already reduced row ``h`` passes unchanged.  `dest` lies in [0, N) for
valid messages.
"""

from __future__ import annotations

import torch

from . import _build

I32 = torch.int32
BIG = 0x7FFFFFFF

# csrc/route.cu's launch geometry (`dims`)
_CB_MIN = 4096           # cells per bucket, at least
_MAX_B = 2048            # buckets, at most
_RANK_WARPS = 512 // 32  # rank-kernel warps
_RANK_SMEM = 96 * 1024   # rank tables in shared memory up to this size


def smem_bytes(m: int, h: int, n: int) -> dict:
    """The dynamic shared memory `csrc/route.cu` launches with for M
    messages into an [H, N] ring (`dims`, `bucket_smem`, `rank_tables`,
    `launch_smem` there; M sets only the grid): each kernel's bytes,
    and the branch its rank kernel takes — its count tables in shared
    memory up to 96 KB, else in device scratch (T3, G32)."""
    cells = h * n
    cb = -(-cells // _MAX_B)
    cb = _CB_MIN if cb < _CB_MIN else (cb + 15) // 16 * 16
    b = -(-cells // cb) if cells > 0 else 1
    tables = cb * (4 + _RANK_WARPS)
    in_smem = tables <= _RANK_SMEM
    return {"route_bucket_kernel": b * (32 * 2 + 4),
            "route_rank_kernel": tables if in_smem else 0,
            "branch": "tables_in_smem" if in_smem else "tables_in_scratch"}


def bin_into_ring_plain(data, src, size, count, arrival, dest, msrc, msize,
                        payload, valid):
    """Plain PyTorch binning, in place; returns dropped [R] int32.

    The two-pass stable radix sort of
    wittgenstein_tpu/core/network.py:233-285 on (row, dest): equal to
    its (rel, dest) grouping because the engine's arrivals span at most
    H - 1 consecutive values of rel = arrival - t, on which rel -> rel %
    H is injective: [1, H-1] for the per-ms step, [K, H+K-2] for a K-ms
    window, whose rel >= H land on the window's own rows, cleared before
    the bin.  Then the group rank by `cummax`, the slot test, masked
    scatters of the accepted rows and a count scatter-add of the
    accepted ones."""
    r_, f_, hz, n, c = data.shape
    m = arrival.shape[1]
    dropped = torch.zeros(r_, dtype=I32, device=arrival.device)
    idx = torch.arange(m, device=arrival.device)
    for r in range(r_):
        ok = valid[r]
        h = arrival[r] % hz
        h_k = torch.where(ok, h, BIG)
        d_k = torch.where(ok, dest[r], BIG)
        o1 = torch.argsort(d_k, stable=True)
        order = o1[torch.argsort(h_k[o1], stable=True)]
        hs, ds = h_k[order], d_k[order]
        new_grp = (hs != hs.roll(1)) | (ds != ds.roll(1))
        new_grp[0] = True
        rank = idx - torch.cummax(torch.where(new_grp, idx, 0), 0).values
        ok_s = ok[order]
        h_s = torch.where(ok_s, h[order], 0).long()
        d_s = torch.where(ok_s, dest[r][order], 0).long()
        slot = count[r][h_s, d_s].long() + rank
        acc = ok_s & (slot < c)
        cell = ((h_s * n + d_s) * c + slot)[acc]
        rows = order[acc]
        for fi in range(f_):
            data[r, fi].view(-1)[cell] = payload[r, rows, fi]
        src[r].view(-1)[cell] = msrc[r][rows]
        size[r].view(-1)[cell] = msize[r][rows]
        count[r].index_put_((h_s, d_s), acc.to(I32), accumulate=True)
        dropped[r] = (ok_s & ~acc).sum()
    return dropped


def _check(data, src, size, count, arrival, dest, msrc, msize, payload,
           valid):
    r_, f_, hz, n, c = data.shape
    m = arrival.shape[-1]
    want = {"src": (src, (r_, hz, n, c)), "size": (size, (r_, hz, n, c)),
            "count": (count, (r_, hz, n)), "arrival": (arrival, (r_, m)),
            "dest": (dest, (r_, m)), "msrc": (msrc, (r_, m)),
            "msize": (msize, (r_, m)), "valid": (valid, (r_, m)),
            "payload": (payload, (r_, m, f_)), "data": (data, data.shape)}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"bin_into_ring: {name} has shape "
                             f"{tuple(t.shape)}, want {tuple(shape)}")
        if t.device != data.device:
            raise ValueError(f"bin_into_ring: {name} is on {t.device}, "
                             f"data on {data.device}")
        want_dtype = torch.bool if name == "valid" else I32
        if t.dtype != want_dtype:
            raise ValueError(f"bin_into_ring: {name} must be {want_dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"bin_into_ring: {name} must be contiguous")


def bin_into_ring(data, src, size, count, arrival, dest, msrc, msize,
                  payload, valid):
    """Bin one batch of messages into the ring; the ring planes and
    count are updated IN PLACE.  Returns dropped [R] int32.

    A CUDA tensor launches `csrc/route.cu` (its two phases, bucketing
    and ranking, with scratch allocated here) on the current stream; a
    CPU tensor runs `bin_into_ring_plain`.  `bin_into_ring.launches`
    counts calls that launched the kernel."""
    _check(data, src, size, count, arrival, dest, msrc, msize, payload,
           valid)
    if data.device.type == "cpu":
        return bin_into_ring_plain(data, src, size, count, arrival, dest,
                                   msrc, msize, payload, valid)
    if data.device.type != "cuda":
        raise ValueError(f"bin_into_ring: no kernel for {data.device}")
    r_, f_, hz, n, c = data.shape
    m = arrival.shape[1]
    lib = _build.lib()
    # The kernel sets dropped to 0 before it adds the drops.
    dropped = torch.empty(r_, dtype=I32, device=data.device)
    scratch = torch.empty(lib.wtpu_route_scratch(r_, m, f_, hz, n), dtype=I32,
                          device=data.device)
    err = lib.wtpu_route(
        arrival.data_ptr(), dest.data_ptr(), valid.data_ptr(),
        msrc.data_ptr(),
        msize.data_ptr(), payload.data_ptr(), data.data_ptr(),
        src.data_ptr(), size.data_ptr(), count.data_ptr(),
        dropped.data_ptr(), scratch.data_ptr(), r_, m, f_, hz, n, c,
        _build.stream_of(data))
    _build.check(err, "wtpu_route")
    bin_into_ring.launches += 1
    return dropped


bin_into_ring.launches = 0
