"""Row-major gather/scatter helpers — the port of
`wittgenstein_tpu/ops/flat.py`.

The JAX forms scatter with ``mode="drop"`` and an out-of-bounds sentinel
for masked entries; an out-of-bounds index is a device-side assert in
PyTorch on CUDA, so here masked entries are routed to one trailing dump
cell that is cut off afterwards, and indices are never out of range.
"""

from __future__ import annotations

import torch


def _flat(i, j, a, b):
    """Row-major index ``i * b + j`` into an [A, B, ...] array.  The
    product is taken in the indices' int32, as the JAX forms take it,
    which is exact only while every index of the array fits in int32:
    a shape check, no device operation."""
    if a * b >= 1 << 31:
        raise ValueError(
            f"flat index of a {a}x{b} array overflows int32 ({a}*{b} >= "
            "2^31): split the array's leading axis")
    return (i * b + j).to(torch.int64)


def _values(vals, like, shape):
    """`vals` (tensor or Python scalar) broadcast to `shape`; a scalar is
    filled on the device, never copied from the host."""
    if isinstance(vals, torch.Tensor):
        return vals.to(like.dtype).expand(shape)
    return torch.full(shape, vals, dtype=like.dtype, device=like.device)


def gather2d(arr, i, j):
    """``arr[A, B][i, j]`` elementwise (wittgenstein_tpu/ops/flat.py:16-19)."""
    flat = _flat(i, j, arr.numel() // arr.shape[-1], arr.shape[-1])
    return arr.reshape(-1)[flat]


def gather_rows(arr3, i, j):
    """``arr[A, B, C][i, j] -> [..., C]``, row indices clamped like the
    JAX ``mode="clip"`` take (wittgenstein_tpu/ops/flat.py:22-39)."""
    a, b, c = arr3.shape
    flat = _flat(i, j, a, b).clamp(0, a * b - 1)
    return arr3.reshape(a * b, c)[flat]


def set2d(arr2, i, j, vals, ok=None):
    """``arr[i, j] = vals`` where ok, on a copy
    (wittgenstein_tpu/ops/flat.py:42-51)."""
    a, b = arr2.shape
    flat = _flat(i, j, a, b)
    if ok is not None:
        flat = torch.where(ok, flat, a * b)
    out = torch.cat([arr2.reshape(-1), arr2.new_zeros(1)])
    out[flat.reshape(-1)] = _values(vals, arr2, flat.shape).reshape(-1)
    return out[:a * b].reshape(a, b)


def add2d(arr2, i, j, vals):
    """``arr[i, j] += vals``, duplicates accumulating
    (wittgenstein_tpu/ops/flat.py:54-59)."""
    a, b = arr2.shape
    flat = _flat(i, j, a, b).reshape(-1)
    out = arr2.reshape(-1).clone()
    out.index_add_(0, flat, _values(vals, arr2, i.shape).reshape(-1))
    return out.reshape(a, b)


def set_rows(arr3, i, j, vals, ok=None):
    """Row ``arr[i, j, :] = vals`` where ok, on a copy
    (wittgenstein_tpu/ops/flat.py:62-72)."""
    a, b, c = arr3.shape
    flat = _flat(i, j, a, b)
    if ok is not None:
        flat = torch.where(ok, flat, a * b)
    out = torch.cat([arr3.reshape(a * b, c), arr3.new_zeros(1, c)])
    out[flat.reshape(-1)] = vals.expand(flat.shape + (c,)).reshape(-1, c)
    return out[:a * b].reshape(a, b, c)
