"""Counter-based (stateless) pseudo-random draws — the port of
`wittgenstein_tpu/ops/prng.py`.

Every draw is a pure function of (seed, purpose tag, ids), so a run is
reproducible from its seed alone and the port draws exactly the JAX
package's bits.  The JAX code works in uint32 with wrapping multiplies;
PyTorch has no right shift on uint32 tensors on the CPU, so here every
uint32 value is held in int64 in ``[0, 2**32)`` and each multiply is
split into two 16-bit halves so that no product leaves int64's range.
All functions also accept Python ints (seeds and tags often are).
Results that the JAX package returns as int32 come back as int32
tensors; raw uint32 hashes stay int64.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

# Domain-separation tags (wittgenstein_tpu/ops/prng.py:26-29).
TAG_BUILDER = 0x4E4F4445   # node builder draws
TAG_LATENCY = 0x4C415443   # engine unicast latency deltas
TAG_BCAST = 0x42434153     # engine broadcast latency seeds
TAG_PROTO = 0x50524F54     # protocol-internal draws


def u32(x):
    """A value as uint32 bits held in int64 (int32 -1 -> 0xFFFFFFFF)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _mul(a, b):
    """``a * b mod 2**32`` for a, b in [0, 2**32): two 16-bit partial
    products keep every intermediate below 2**49."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _i32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) else int(x)


def mix32(x):
    """murmur3 fmix32 (wittgenstein_tpu/ops/prng.py:32-40)."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash2(a, b):
    """Combine two uint32 streams (wittgenstein_tpu/ops/prng.py:43-47)."""
    return mix32(mix32(a) ^ _mul(u32(b), 0x9E3779B9))


def hash3(a, b, c):
    """wittgenstein_tpu/ops/prng.py:50-51."""
    return hash2(hash2(a, b), c)


def uniform_delta(seed, ids):
    """Uniform int32 in [0, 100) per id (wittgenstein_tpu/ops/prng.py:54-59)."""
    return _i32(hash2(ids, seed) % 100)


def uniform_u32(seed, ids):
    """uint32 per id, as int64 (wittgenstein_tpu/ops/prng.py:62-64)."""
    return hash2(ids, seed)


def uniform_float(seed, ids):
    """float32 in [0, 1) from the top 24 bits, exact
    (wittgenstein_tpu/ops/prng.py:67-72)."""
    return (uniform_u32(seed, ids) >> 8).to(torch.float32) * \
        (1.0 / (1 << 24))


def uniform_int(seed, ids, n):
    """int32 in [0, n) per id; n may be a tensor
    (wittgenstein_tpu/ops/prng.py:75-78)."""
    n = u32(n)
    if isinstance(n, torch.Tensor):
        n = n.clamp_min(1)
    else:
        n = max(n, 1)
    return _i32(hash2(ids, seed) % n)


def bernoulli(seed, ids, p):
    """wittgenstein_tpu/ops/prng.py:81-83."""
    return uniform_float(seed, ids) < p


def _uinv_odd(m):
    """Inverse of odd m modulo 2**32 by Newton-Hensel
    (wittgenstein_tpu/ops/prng.py:102-109)."""
    inv = m
    for _ in range(5):
        inv = _mul(inv, (2 - _mul(m, inv)) & M32)
    return inv


def _bits_parts(bits):
    """(mask, s1, s2) of the keyed permutation over [0, 2**bits)."""
    if isinstance(bits, torch.Tensor):
        b = bits.to(torch.int64)
        mask = (1 << b.clamp(0, 31)) - 1
        s1 = ((b + 1) // 2).clamp_min(1)
        s2 = ((2 * b) // 3).clamp_min(1)
    else:
        b = int(bits)
        mask = (1 << min(max(b, 0), 31)) - 1
        s1 = max(1, (b + 1) // 2)
        s2 = max(1, (2 * b) // 3)
    return mask, s1, s2


def bij_perm_dyn(key, x, bits):
    """Keyed bijection of [0, 2**bits) with a per-element bit count
    (wittgenstein_tpu/ops/prng.py:154-173)."""
    mask, s1, s2 = _bits_parts(bits)
    x = u32(x) & mask
    key = u32(key)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35):
        k = mix32(key ^ c)
        x = (x ^ (k & mask)) & mask
        x = _mul(x, k | 1) & mask
        x = x ^ (x >> s1)
        x = _mul(x, 0x6A09E667 | 1) & mask
        x = x ^ (x >> s2)
    return _i32(x & mask)


def bij_perm(key, x, bits: int):
    """Keyed bijective permutation of [0, 2**bits)
    (wittgenstein_tpu/ops/prng.py:86-99)."""
    if not 1 <= bits <= 31:
        raise ValueError(f"bits must be in [1, 31], got {bits}")
    return bij_perm_dyn(key, x, bits)


def bij_perm_inv_dyn(key, y, bits):
    """Inverse of `bij_perm_dyn` (wittgenstein_tpu/ops/prng.py:126-151)."""
    mask, s1, s2 = _bits_parts(bits)
    y = u32(y) & mask
    key = u32(key)

    def unshift(x, s):
        r = x
        for _ in range(3):
            r = x ^ (r >> s)
        return r & mask

    minv2 = _uinv_odd(0x6A09E667 | 1)
    for c in (0xC2B2AE35, 0x85EBCA6B, 0x9E3779B9):
        k = mix32(key ^ c)
        y = unshift(y, s2)
        y = _mul(y, minv2) & mask
        y = unshift(y, s1)
        y = _mul(y, _uinv_odd(k | 1)) & mask
        y = (y ^ (k & mask)) & mask
    return _i32(y & mask)


def bij_perm_inv(key, y, bits: int):
    """Inverse of `bij_perm` (wittgenstein_tpu/ops/prng.py:112-123)."""
    if not 1 <= bits <= 31:
        raise ValueError(f"bits must be in [1, 31], got {bits}")
    return bij_perm_inv_dyn(key, y, bits)
