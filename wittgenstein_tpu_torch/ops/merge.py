"""Handel's bounded verification-queue merge — the port of the TPU kernel
`wittgenstein_tpu/ops/pallas_merge.py` (`_merge_kernel`, launched by
`merge_queue_pallas`).

`merge_queue` launches `csrc/merge.cu` on CUDA tensors and runs
`merge_queue_plain` (the XLA path, `_levels.merge_bounded_queue` +
`select_queue` in the Handel receive configuration,
wittgenstein_tpu/models/_levels.py:132-207) on CPU tensors.

`merge_queue` is a `torch.library` custom op with a vmap rule, so that
the protocol step runs under `torch.func.vmap` over a seed batch (the
seed-folded engine, `core/batched.py`): the rule folds the seed axis R
into the kernel's row axis, M = R x rows, and launches the kernel once
for all seeds, with one eviction counter a seed.
"""

from __future__ import annotations

import torch

from ..models._levels import merge_bounded_queue
from . import _build

I32 = torch.int32


def merge_queue_plain(q_from, q_lvl, q_rank, q_bad, q_sig, src, level,
                      rank_all, ok, sig_all, seeds=None):
    """Plain PyTorch merge (wittgenstein_tpu/models/_levels.py:132-207
    with cols2d={"bad"}, cols3d={"sig"}, as called at
    wittgenstein_tpu/models/handel.py:497-501).  The eviction count is
    a scalar, or [seeds] over equal runs of rows when `seeds` is
    given."""
    sel2, sel3, ev = merge_bounded_queue(
        q_from, q_lvl, q_rank, src, level, rank_all, ok, q_from.shape[1],
        {"bad": (q_bad, torch.zeros_like(ok))}, {"sig": (q_sig, sig_all)})
    ev = (ev.sum(dtype=I32) if seeds is None else
          ev.reshape(seeds, -1).sum(1, dtype=I32))
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


def _merge(q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all, ok,
           sig_all, seeds=None):
    """The merge of M rows; `seeds` splits the rows into that many equal
    runs, each with its own eviction counter (None: one scalar)."""
    args = (q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank_all, ok,
            sig_all)
    _check(*args)
    if q_from.device.type == "cpu":
        return merge_queue_plain(*args, seeds=seeds)
    if q_from.device.type != "cuda":
        raise ValueError(f"merge_queue: no kernel for {q_from.device}")
    m, q = q_from.shape
    s = src.shape[1]
    w = q_sig.shape[-1]
    o_from, o_lvl, o_rank = (torch.empty_like(q_from) for _ in range(3))
    o_bad = torch.empty_like(q_bad)
    o_sig = torch.empty_like(q_sig)
    o_ev = torch.zeros(() if seeds is None else (seeds,), dtype=I32,
                       device=q_from.device)
    err = _build.lib().wtpu_merge(
        q_from.data_ptr(), q_lvl.data_ptr(), q_rank.data_ptr(),
        q_bad.data_ptr(), q_sig.data_ptr(), src.data_ptr(),
        level.data_ptr(), rank_all.data_ptr(), ok.data_ptr(),
        sig_all.data_ptr(), o_from.data_ptr(), o_lvl.data_ptr(),
        o_rank.data_ptr(), o_bad.data_ptr(), o_sig.data_ptr(),
        o_ev.data_ptr(), m, q, s, w, m // (seeds or 1),
        _build.stream_of(q_from))
    _build.check(err, "wtpu_merge")
    merge_queue.launches += 1
    # The kernel's 16-byte gathers need W % 4 == 0 and 16-byte aligned
    # sig planes (csrc/merge.cu); otherwise it gathers word by word.
    if w % 4 or any(t.data_ptr() % 16 for t in (q_sig, sig_all, o_sig)):
        merge_queue.word_launches += 1
    return o_from, o_lvl, o_rank, o_bad, o_sig, o_ev


@torch.library.custom_op("wtpu::merge_queue", mutates_args=())
def merge_queue(q_from: torch.Tensor, q_lvl: torch.Tensor,
                q_rank: torch.Tensor, q_bad: torch.Tensor,
                q_sig: torch.Tensor, src: torch.Tensor, level: torch.Tensor,
                rank_all: torch.Tensor, ok: torch.Tensor,
                sig_all: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bounded-queue merge.  Queue columns [M, Q] (q_bad bool), q_sig
    [M, Q, W] int32 words; incoming columns [M, S] (ok bool), sig_all
    [M, S, W].  Returns (q_from', q_lvl', q_rank', q_bad', q_sig',
    evicted) with evicted an int32 scalar ([R] under vmap).  The outputs
    are fresh tensors; the inputs are not modified.  The kernel reads
    and writes the bool columns as bytes and sums `evicted` itself, so
    the launch is the only op besides the allocations and one zero fill.
    `merge_queue.launches` counts kernel launches, and
    `merge_queue.word_launches` those of them whose sig rows were
    gathered word by word rather than 16 bytes at a time."""
    return _merge(q_from, q_lvl, q_rank, q_bad, q_sig, src, level,
                  rank_all, ok, sig_all)


def fold_seeds(x, in_dim, r):
    """A vmapped argument as one contiguous tensor with the seed axis
    folded into its first axis: [R * rows, ...]; an unbatched argument
    (in_dim None) is repeated R times."""
    x = (x.expand(r, *x.shape) if in_dim is None else x.movedim(in_dim, 0))
    return x.reshape(r * x.shape[1], *x.shape[2:]).contiguous()


def folded_vmap(fn):
    """A vmap rule for a row-wise op: every tensor argument with the seed
    axis folded into its rows (`fold_seeds`, which makes it contiguous
    and repeats an unbatched one, such as the node ids, for each seed),
    ONE call of `fn` for all seeds, each output split back to [R, rows,
    ...].  Other arguments (ints) pass as they are."""
    def rule(info, in_dims, *args):
        r = info.batch_size
        outs = fn(*(fold_seeds(x, d, r) if isinstance(x, torch.Tensor)
                    else x for x, d in zip(args, in_dims)))
        return (tuple(o.reshape(r, -1, *o.shape[1:]) for o in outs),
                (0,) * len(outs))
    return rule


def _merge_vmap(info, in_dims, *args):
    r = info.batch_size
    outs = _merge(*(fold_seeds(x, d, r) for x, d in zip(args, in_dims)),
                  seeds=r)
    return (tuple(o.reshape(r, -1, *o.shape[1:]) for o in outs[:5]) +
            (outs[5],)), (0,) * 6


torch.library.register_vmap(merge_queue, _merge_vmap)
merge_queue.launches = 0
merge_queue.word_launches = 0
