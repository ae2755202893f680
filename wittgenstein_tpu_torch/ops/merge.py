"""Handel's bounded verification-queue merge — the port of the TPU kernel
`wittgenstein_tpu/ops/pallas_merge.py` (`_merge_kernel`, launched by
`merge_queue_pallas`).

`merge_queue` launches `csrc/merge.cu` on CUDA tensors and runs
`merge_queue_plain` (the XLA path, `_levels.merge_bounded_queue` +
`select_queue` in the Handel receive configuration,
wittgenstein_tpu/models/_levels.py:132-207) on CPU tensors.
"""

from __future__ import annotations

import torch

from ..models._levels import merge_bounded_queue
from . import _build

I32 = torch.int32


def merge_queue_plain(q_from, q_lvl, q_rank, q_bad, q_sig, src, level,
                      rank_all, ok, sig_all):
    """Plain PyTorch merge (wittgenstein_tpu/models/_levels.py:132-207
    with cols2d={"bad"}, cols3d={"sig"}, as called at
    wittgenstein_tpu/models/handel.py:497-501)."""
    sel2, sel3, ev = merge_bounded_queue(
        q_from, q_lvl, q_rank, src, level, rank_all, ok, q_from.shape[1],
        {"bad": (q_bad, torch.zeros_like(ok))}, {"sig": (q_sig, sig_all)})
    return (sel2["from"], sel2["lvl"], sel2["rank"], sel2["bad"],
            sel3["sig"], ev)


def _check(q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all, ok,
           sig_all):
    m, q = q_from.shape
    s = src.shape[1]
    w = q_sig.shape[-1]
    want = {"q_from": (q_from, (m, q)), "q_lvl": (q_lvl, (m, q)),
            "q_rank": (q_rank, (m, q)), "q_bad": (q_bad, (m, q)),
            "q_sig": (q_sig, (m, q, w)), "src": (src, (m, s)),
            "level": (level, (m, s)), "rank_all": (rank_all, (m, s)),
            "ok": (ok, (m, s)), "sig_all": (sig_all, (m, s, w))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"merge_queue: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != q_from.device:
            raise ValueError(f"merge_queue: {name} is on {t.device}")
        want_dtype = torch.bool if name in ("q_bad", "ok") else I32
        if t.dtype != want_dtype:
            raise ValueError(f"merge_queue: {name} must be {want_dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"merge_queue: {name} must be contiguous")
    if q + s > 255:
        # Invalid candidates take the unique keys BIG0 + position, with
        # 255 units of headroom (wittgenstein_tpu/ops/pallas_merge.py:238-246).
        raise ValueError(f"merge_queue supports q_cap + s_cap <= 255 "
                         f"(got {q} + {s})")


def merge_queue(q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all,
                ok, sig_all):
    """Bounded-queue merge.  Queue columns [M, Q] (q_bad bool), q_sig
    [M, Q, W] int32 words; incoming columns [M, S] (ok bool), sig_all
    [M, S, W].  Returns (q_from', q_lvl', q_rank', q_bad', q_sig',
    evicted) with evicted an int32 scalar.  The outputs are fresh
    tensors; the inputs are not modified.  The kernel reads and writes
    the bool columns as bytes and sums `evicted` itself, so the launch
    is the only op besides the allocations and one zero fill.  `merge_queue.launches`
    counts kernel launches."""
    _check(q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all, ok,
           sig_all)
    if q_from.device.type == "cpu":
        return merge_queue_plain(q_from, q_lvl, q_rank, q_bad, q_sig, src,
                                 level, rank_all, ok, sig_all)
    if q_from.device.type != "cuda":
        raise ValueError(f"merge_queue: no kernel for {q_from.device}")
    m, q = q_from.shape
    s = src.shape[1]
    w = q_sig.shape[-1]
    o_from, o_lvl, o_rank = (torch.empty_like(q_from) for _ in range(3))
    o_bad = torch.empty_like(q_bad)
    o_sig = torch.empty_like(q_sig)
    o_ev = torch.zeros((), dtype=I32, device=q_from.device)
    err = _build.lib().wtpu_merge(
        q_from.data_ptr(), q_lvl.data_ptr(), q_rank.data_ptr(),
        q_bad.data_ptr(), q_sig.data_ptr(), src.data_ptr(),
        level.data_ptr(), rank_all.data_ptr(), ok.data_ptr(),
        sig_all.data_ptr(), o_from.data_ptr(), o_lvl.data_ptr(),
        o_rank.data_ptr(), o_bad.data_ptr(), o_sig.data_ptr(),
        o_ev.data_ptr(), m, q, s, w, _build.stream_of(q_from))
    _build.check(err, "wtpu_merge")
    merge_queue.launches += 1
    return o_from, o_lvl, o_rank, o_bad, o_sig, o_ev


merge_queue.launches = 0
