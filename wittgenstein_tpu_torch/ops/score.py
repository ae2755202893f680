"""Handel verification scoring — the port of the TPU kernel
`wittgenstein_tpu/ops/pallas_score.py` (`_score_kernel` with
`_emask_for` and `_popcount_u32`, launched by `score_queue_pallas`).

`score_queue` launches `csrc/score.cu` on CUDA tensors and runs
`score_queue_plain` (the XLA block of
wittgenstein_tpu/models/handel.py:638-647) on CPU tensors.
"""

from __future__ import annotations

import torch

from ..models._levels import range_mask_dyn
from . import _build, bitset

I32 = torch.int32


def score_queue_plain(q_sig, q_lvl, ids, total_inc, ver_ind, last_agg):
    """Plain PyTorch scoring (wittgenstein_tpu/models/handel.py:638-647)."""
    emask = range_mask_dyn(ids[:, None], q_lvl, q_sig.shape[-1])
    inc_e = total_inc[:, None, :] & emask
    ver_e = ver_ind[:, None, :] & emask
    agg_e = last_agg[:, None, :] & emask
    disj = ~bitset.intersects(q_sig, inc_e)
    merged = torch.where(disj[..., None], q_sig | inc_e, q_sig)
    return (bitset.popcount(merged | ver_e), bitset.popcount(q_sig),
            bitset.popcount(q_sig | ver_e), bitset.intersects(q_sig, agg_e))


def _check(q_sig, q_lvl, ids, total_inc, ver_ind, last_agg):
    m, q, w = q_sig.shape
    want = {"q_sig": (q_sig, (m, q, w)), "q_lvl": (q_lvl, (m, q)),
            "ids": (ids, (m,)), "total_inc": (total_inc, (m, w)),
            "ver_ind": (ver_ind, (m, w)), "last_agg": (last_agg, (m, w))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"score_queue: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != q_sig.device:
            raise ValueError(f"score_queue: {name} is on {t.device}")
        if t.dtype != I32:
            raise ValueError(f"score_queue: {name} must be int32, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"score_queue: {name} must be contiguous")


def score_queue(q_sig, q_lvl, ids, total_inc, ver_ind, last_agg):
    """Per-entry verification summaries.  q_sig [M, Q, W] int32 words,
    q_lvl [M, Q], ids [M] (global node ids), bitset rows [M, W].
    Returns (s_inc, pc_sig, pc_sig_ver) int32 [M, Q] and inter_agg bool
    [M, Q].  `score_queue.launches` counts kernel launches."""
    _check(q_sig, q_lvl, ids, total_inc, ver_ind, last_agg)
    if q_sig.device.type == "cpu":
        return score_queue_plain(q_sig, q_lvl, ids, total_inc, ver_ind,
                                 last_agg)
    if q_sig.device.type != "cuda":
        raise ValueError(f"score_queue: no kernel for {q_sig.device}")
    m, q, w = q_sig.shape
    s_inc, pc_sig, pc_sv, inter = (torch.empty_like(q_lvl)
                                   for _ in range(4))
    err = _build.lib().wtpu_score(
        q_sig.data_ptr(), q_lvl.data_ptr(), ids.data_ptr(),
        total_inc.data_ptr(), ver_ind.data_ptr(), last_agg.data_ptr(),
        s_inc.data_ptr(), pc_sig.data_ptr(), pc_sv.data_ptr(),
        inter.data_ptr(), m, q, w, _build.stream_of(q_sig))
    _build.check(err, "wtpu_score")
    score_queue.launches += 1
    return s_inc, pc_sig, pc_sv, inter != 0


score_queue.launches = 0
