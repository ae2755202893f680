"""GSF's three-tier verification-queue merge — the port of the TPU kernel
`wittgenstein_tpu/ops/pallas_gsf_merge.py` (`_gsf_kernel`, launched by
`gsf_merge_pallas`).

`gsf_merge` launches `csrc/gsf_merge.cu` on CUDA tensors and runs
`gsf_merge_plain` (the `select_queue` tail of `_receive`,
wittgenstein_tpu/models/gsf.py:291-337) on CPU tensors.  It is a
`torch.library` custom op whose vmap rule folds the seed axis into the
rows (`ops/merge.folded_vmap`): under `torch.func.vmap` over a seed
batch one launch serves every seed.

The candidates of a node row are its Q queued entries, its S incoming
aggregates and its S incoming individuals (one-bit sig rows built from
the sender id), C = Q + 2S in all.  A valid candidate's key is
``(tier*(L+1) + (lvl if tier == 1 else 0))*C + c`` with tier 0 for a
queued individual, 1 for an aggregate and 2 for an incoming individual;
invalid candidates sort last in position order.  The Q lowest keys stay.
"""

from __future__ import annotations

import torch

from ..models._levels import select_queue
from . import _build, bitset
from .merge import folded_vmap

I32 = torch.int32


def _refuse_wide(q: int, s: int) -> None:
    if q + 2 * s > 255:
        # Invalid candidates take the unique keys BIG0 + position, with
        # 255 units of headroom
        # (wittgenstein_tpu/ops/pallas_gsf_merge.py:174-176).
        raise ValueError(f"gsf_merge supports q_cap + 2*s_cap <= 255 "
                         f"(got {q} + 2*{s})")


def gsf_merge_plain(q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level,
                    agg_ok, ind_ok, sig_all, levels: int):
    """Plain PyTorch merge (wittgenstein_tpu/models/gsf.py:291-337)."""
    q = q_from.shape[1]
    s = src.shape[1]
    _refuse_wide(q, s)
    w = q_sig.shape[-1]
    c_tot = q + 2 * s
    dev = q_from.device
    u_from = torch.cat([torch.where(ex_keep, q_from, -1),
                        torch.where(agg_ok, src, -1),
                        torch.where(ind_ok, src, -1)], dim=1)
    u_lvl = torch.cat([q_lvl, level, level], dim=1)
    u_indiv = torch.cat([q_indiv, torch.zeros_like(agg_ok),
                         torch.ones_like(ind_ok)], dim=1)
    u_sig = torch.cat([q_sig, sig_all,
                       torch.where(ind_ok[..., None], bitset.one_bit(src, w),
                                   0)], dim=1)
    valid_u = u_from >= 0
    pos = torch.arange(c_tot, dtype=I32, device=dev)[None, :]
    is_inc_ind = pos >= q + s
    tier = torch.where(is_inc_ind, 2, torch.where(u_indiv, 0, 1)).to(I32)
    lvl_term = torch.where(tier == 1, u_lvl, 0)
    sel2, sel3, order = select_queue(
        (tier * (levels + 1) + lvl_term) * c_tot + pos, valid_u, q,
        {"from": u_from, "lvl": u_lvl, "indiv": u_indiv}, {"sig": u_sig})
    o_from = sel2["from"]

    # got_indiv delta: the sender bits of the admitted incoming
    # individuals, OR-ed over the queue axis (a sum would carry).
    sel_new_ind = torch.gather(is_inc_ind.expand_as(valid_u), 1, order) & \
        (o_from >= 0)
    ind_bits = torch.where(sel_new_ind[..., None],
                           bitset.one_bit(o_from.clamp_min(0), w), 0)
    got_add = ind_bits[:, 0]
    for j in range(1, q):
        got_add = got_add | ind_bits[:, j]
    kept_ex_agg = ((order < q) & torch.gather(valid_u & ~u_indiv, 1,
                                              order)).sum(1, dtype=I32)
    return (o_from, sel2["lvl"], sel2["indiv"], sel3["sig"], got_add,
            kept_ex_agg)


def _check(q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok,
           ind_ok, sig_all):
    m, q = q_from.shape
    s = src.shape[1]
    w = q_sig.shape[-1]
    want = {"q_from": (q_from, (m, q)), "q_lvl": (q_lvl, (m, q)),
            "q_indiv": (q_indiv, (m, q)), "ex_keep": (ex_keep, (m, q)),
            "q_sig": (q_sig, (m, q, w)), "src": (src, (m, s)),
            "level": (level, (m, s)), "agg_ok": (agg_ok, (m, s)),
            "ind_ok": (ind_ok, (m, s)), "sig_all": (sig_all, (m, s, w))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"gsf_merge: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != q_from.device:
            raise ValueError(f"gsf_merge: {name} is on {t.device}")
        want_dtype = (torch.bool if name in ("q_indiv", "ex_keep", "agg_ok",
                                             "ind_ok") else I32)
        if t.dtype != want_dtype:
            raise ValueError(f"gsf_merge: {name} must be {want_dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gsf_merge: {name} must be contiguous")
    _refuse_wide(q, s)


def smem_bytes(w: int) -> dict:
    """The dynamic shared memory `csrc/gsf_merge.cu` launches with
    (`launch_smem` there): a node's W-word OR-delta.  Past the opt-in
    limit (W > 58,112 words, 1.86M nodes) the wrapper refuses the shape
    before the launch (`_build.check_smem`)."""
    return {"gsf_merge_kernel": 4 * w, "branch": "one"}


def _gsf_merge(q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok,
               ind_ok, sig_all, levels):
    _check(q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok,
           ind_ok, sig_all)
    if q_from.device.type == "cpu":
        return gsf_merge_plain(q_from, q_lvl, q_indiv, ex_keep, q_sig, src,
                               level, agg_ok, ind_ok, sig_all, levels)
    if q_from.device.type != "cuda":
        raise ValueError(f"gsf_merge: no kernel for {q_from.device}")
    m, q = q_from.shape
    s = src.shape[1]
    w = q_sig.shape[-1]
    _build.check_smem("gsf_merge", smem_bytes(w)["gsf_merge_kernel"])
    o_from, o_lvl = torch.empty_like(q_from), torch.empty_like(q_lvl)
    o_indiv = torch.empty_like(q_indiv)
    o_sig = torch.empty_like(q_sig)
    o_got = torch.empty((m, w), dtype=I32, device=q_from.device)
    o_kept = torch.empty(m, dtype=I32, device=q_from.device)
    err = _build.lib().wtpu_gsf_merge(
        q_from.data_ptr(), q_lvl.data_ptr(), q_indiv.data_ptr(),
        ex_keep.data_ptr(), q_sig.data_ptr(), src.data_ptr(),
        level.data_ptr(), agg_ok.data_ptr(), ind_ok.data_ptr(),
        sig_all.data_ptr(), o_from.data_ptr(), o_lvl.data_ptr(),
        o_indiv.data_ptr(), o_sig.data_ptr(), o_got.data_ptr(),
        o_kept.data_ptr(), m, q, s, w, levels, _build.stream_of(q_from))
    _build.check(err, "wtpu_gsf_merge")
    gsf_merge.launches += 1
    return o_from, o_lvl, o_indiv, o_sig, o_got, o_kept


@torch.library.custom_op("wtpu::gsf_merge", mutates_args=())
def gsf_merge(q_from: torch.Tensor, q_lvl: torch.Tensor,
              q_indiv: torch.Tensor, ex_keep: torch.Tensor,
              q_sig: torch.Tensor, src: torch.Tensor, level: torch.Tensor,
              agg_ok: torch.Tensor, ind_ok: torch.Tensor,
              sig_all: torch.Tensor, levels: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three-tier queue merge.  Queue columns [M, Q] (q_indiv, ex_keep
    bool), q_sig [M, Q, W] int32 words; incoming columns [M, S] (agg_ok,
    ind_ok bool), sig_all [M, S, W].  Returns (q_from', q_lvl',
    q_indiv' bool, q_sig', got_add [M, W], kept_ex_agg [M]): fresh
    tensors, the inputs are not modified (a kept entry can change
    slots); under vmap each comes back as [R, N, ...].  The kernel reads
    and writes the bool columns as bytes, so the launch is the only op
    besides the allocations.  `gsf_merge.launches` counts kernel
    launches."""
    return _gsf_merge(q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level,
                      agg_ok, ind_ok, sig_all, levels)


torch.library.register_vmap(gsf_merge, folded_vmap(_gsf_merge))
gsf_merge.launches = 0
