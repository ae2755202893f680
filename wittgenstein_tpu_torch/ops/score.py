"""Verification scoring — the port of the two TPU scoring kernels of
`wittgenstein_tpu/ops/pallas_score.py` (with their shared `_emask_for`
and `_popcount_u32`).

Handel: `score_queue` (`_score_kernel`, launched by
`score_queue_pallas`) launches `csrc/score.cu` on CUDA tensors and runs
`score_queue_plain` (the XLA block of
wittgenstein_tpu/models/handel.py:638-647) on CPU tensors.

GSF: `gsf_score` (`_gsf_score_kernel`, launched by `gsf_score_pallas`)
launches `csrc/gsf_score.cu` on CUDA tensors and runs `gsf_score_plain`
(the XLA block of wittgenstein_tpu/models/gsf.py:450-459) on CPU
tensors.
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


def _check(fn, q_sig, q_lvl, ids, **rows):
    m, q, w = q_sig.shape
    want = {"q_sig": (q_sig, (m, q, w)), "q_lvl": (q_lvl, (m, q)),
            "ids": (ids, (m,))}
    want.update({k: (v, (m, w)) for k, v in rows.items()})
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != q_sig.device:
            raise ValueError(f"{fn}: {name} is on {t.device}")
        if t.dtype != I32:
            raise ValueError(f"{fn}: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def score_queue(q_sig, q_lvl, ids, total_inc, ver_ind, last_agg):
    """Per-entry verification summaries.  q_sig [M, Q, W] int32 words,
    q_lvl [M, Q], ids [M] (global node ids), bitset rows [M, W].
    Returns (s_inc, pc_sig, pc_sig_ver) int32 [M, Q] and inter_agg bool
    [M, Q].  The kernel writes inter_agg as bytes, so the launch is the
    only op besides the allocations.  `score_queue.launches` counts
    kernel launches."""
    _check("score_queue", q_sig, q_lvl, ids, total_inc=total_inc,
           ver_ind=ver_ind, last_agg=last_agg)
    if q_sig.device.type == "cpu":
        return score_queue_plain(q_sig, q_lvl, ids, total_inc, ver_ind,
                                 last_agg)
    if q_sig.device.type != "cuda":
        raise ValueError(f"score_queue: no kernel for {q_sig.device}")
    m, q, w = q_sig.shape
    s_inc, pc_sig, pc_sv = (torch.empty_like(q_lvl) for _ in range(3))
    inter = torch.empty(q_lvl.shape, dtype=torch.bool, device=q_lvl.device)
    err = _build.lib().wtpu_score(
        q_sig.data_ptr(), q_lvl.data_ptr(), ids.data_ptr(),
        total_inc.data_ptr(), ver_ind.data_ptr(), last_agg.data_ptr(),
        s_inc.data_ptr(), pc_sig.data_ptr(), pc_sv.data_ptr(),
        inter.data_ptr(), m, q, w, _build.stream_of(q_sig))
    _build.check(err, "wtpu_score")
    score_queue.launches += 1
    return s_inc, pc_sig, pc_sv, inter


score_queue.launches = 0


def gsf_score_plain(q_sig, q_lvl, ids, verified, ver_indiv):
    """Plain PyTorch GSF scoring (wittgenstein_tpu/models/gsf.py:450-459)."""
    emask = range_mask_dyn(ids[:, None], q_lvl, q_sig.shape[-1])
    ver_l = verified[:, None, :] & emask
    indiv_l = ver_indiv[:, None, :] & emask
    with_indiv = indiv_l | q_sig
    return (bitset.popcount(ver_l), bitset.popcount(q_sig),
            bitset.intersects(q_sig, ver_l), bitset.popcount(with_indiv),
            bitset.popcount(with_indiv | ver_l),
            bitset.intersects(q_sig, indiv_l))


def gsf_score(q_sig, q_lvl, ids, verified, ver_indiv):
    """GSF per-entry score inputs (evaluateSig, GSFSignature.java:482-580).
    q_sig [M, Q, W] int32 words, q_lvl [M, Q], ids [M] (global node ids),
    verified and ver_indiv rows [M, W].  Returns (ver_l_card, card_sig,
    inter_verl bool, pc_with_indiv, pc_with_indiv_or_verl, inter_indivl
    bool), each [M, Q].  The kernel writes the two bool outputs as
    bytes, so the launch is the only op besides the allocations.
    `gsf_score.launches` counts kernel launches."""
    _check("gsf_score", q_sig, q_lvl, ids, verified=verified,
           ver_indiv=ver_indiv)
    if q_sig.device.type == "cpu":
        return gsf_score_plain(q_sig, q_lvl, ids, verified, ver_indiv)
    if q_sig.device.type != "cuda":
        raise ValueError(f"gsf_score: no kernel for {q_sig.device}")
    m, q, w = q_sig.shape
    vlc, cs, pwi, pwv = (torch.empty_like(q_lvl) for _ in range(4))
    inter, inter_ind = (torch.empty(q_lvl.shape, dtype=torch.bool,
                                    device=q_lvl.device) for _ in range(2))
    err = _build.lib().wtpu_gsf_score(
        q_sig.data_ptr(), q_lvl.data_ptr(), ids.data_ptr(),
        verified.data_ptr(), ver_indiv.data_ptr(), vlc.data_ptr(),
        cs.data_ptr(), inter.data_ptr(), pwi.data_ptr(), pwv.data_ptr(),
        inter_ind.data_ptr(), m, q, w, _build.stream_of(q_sig))
    _build.check(err, "wtpu_gsf_score")
    gsf_score.launches += 1
    return vlc, cs, inter, pwi, pwv, inter_ind


gsf_score.launches = 0
