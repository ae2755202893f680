"""Word-packed bitsets — the port of `wittgenstein_tpu/ops/bitset.py`.

A bitset over [0, n) is a row of ``ceil(n/32)`` words.  The JAX package
stores the words as uint32; the port stores the SAME bits in int32
(PyTorch lacks uint32 shifts on the CPU), so ``&``, ``|``, ``^`` and
``~`` act identically, and every right shift is made logical by masking.
`convert.py` reinterprets the words as uint32 at the boundary.
"""

from __future__ import annotations

import torch

WORD = 32
I32 = torch.int32


def n_words(n: int) -> int:
    """wittgenstein_tpu/ops/bitset.py:23-24."""
    return (n + WORD - 1) // WORD


def popcount_words(bits):
    """Per-word population count of int32 words (the SWAR form of
    wittgenstein_tpu/ops/pallas_score.py:36-43, in int64 so that every
    shift is logical)."""
    v = bits.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(I32)


def popcount(bits, axis=-1):
    """Total set bits along the word axis (wittgenstein_tpu/ops/bitset.py:27-30)."""
    return popcount_words(bits).sum(dim=axis, dtype=I32)


def to_i32(v):
    """int64 holding uint32 bits -> the int32 word with the same bits."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(I32)


def word_bit(k):
    """``1 << k`` as an int32 word for k in [0, 32) (bit 31 is the sign)."""
    return to_i32(torch.ones_like(k, dtype=torch.int64) << k.to(torch.int64))


def low_mask(k):
    """int32 word with the low k bits set, k in [0, 32]
    (``(1 << k) - 1`` with the k == 32 full word)."""
    return to_i32((torch.ones_like(k, dtype=torch.int64) << k.to(
        torch.int64)) - 1)


def one_bit(idx, w: int):
    """[..., W] bitset with exactly bit `idx` set
    (wittgenstein_tpu/ops/bitset.py:33-39)."""
    word = torch.arange(w, dtype=I32, device=idx.device)
    hit = (idx[..., None] // WORD) == word
    return torch.where(hit, word_bit(idx[..., None] % WORD),
                       torch.zeros((), dtype=I32, device=idx.device))


def get_bit(bits, idx):
    """Read bit `idx` from [..., W] bitsets
    (wittgenstein_tpu/ops/bitset.py:42-45)."""
    word = torch.gather(bits, -1, (idx[..., None] // WORD).to(
        torch.int64))[..., 0]
    return ((word >> (idx % WORD)) & 1) != 0


def range_mask(base, length, w: int):
    """[..., W] mask of the bit range [base, base+length)
    (wittgenstein_tpu/ops/bitset.py:48-62)."""
    base = base.to(I32)[..., None]
    end = base + length.to(I32)[..., None]
    wlo = torch.arange(w, dtype=I32, device=base.device) * WORD
    lo = (base - wlo).clamp(0, WORD)
    hi = (end - wlo).clamp(0, WORD)
    return low_mask(hi) & ~low_mask(lo)


def includes(a, b, axis=-1):
    """True where bitset a includes b (wittgenstein_tpu/ops/bitset.py:65-68)."""
    return ((b & ~a) == 0).all(dim=axis)


def intersects(a, b, axis=-1):
    """wittgenstein_tpu/ops/bitset.py:71-72."""
    return ((a & b) != 0).any(dim=axis)


def pack(flags):
    """[..., n] bools -> [..., n_words(n)] words, bit i of the row set
    where ``flags[..., i]``: the OR of their `one_bit` words.  Each word
    is the sum of distinct powers of two, so the JAX package's forms
    that ADD distinct one-hot words (``.at[:, word].add``) and those
    that OR-reduce them (``lax.reduce(..., bitwise_or)``) both equal
    it."""
    n = flags.shape[-1]
    w = n_words(n)
    if w * WORD != n:
        flags = torch.cat([flags, flags.new_zeros(
            flags.shape[:-1] + (w * WORD - n,))], -1)
    weights = torch.ones(WORD, dtype=torch.int64, device=flags.device) << \
        torch.arange(WORD, dtype=torch.int64, device=flags.device)
    words = (flags.reshape(flags.shape[:-1] + (w, WORD)).to(torch.int64) *
             weights).sum(-1)
    return to_i32(words)


def bits_of(idx, mask, n: int):
    """[N, S] indices in [0, n) -> [N, n_words(n)] words with bit
    ``idx[i, s]`` of row i set for every ``mask[i, s]``: the JAX
    package's ``lax.reduce(where(mask[..., None], one_bit(idx, w), 0),
    0, bitwise_or, (1,))``, a repeated index setting its bit once.  The
    indices are scattered into an [N, n + 1] bool row (the last column a
    dump for the masked-off slots) and packed, never expanded to [N, S,
    W] words."""
    rows = idx.shape[0]
    slot = torch.where(mask, idx, n).long()
    flags = torch.zeros((rows, n + 1), dtype=torch.bool, device=idx.device)
    flags = flags.scatter(1, slot, torch.ones_like(mask))
    return pack(flags[:, :n])


def lowest_bit(word):
    """Position of the lowest set bit of each int32 word, 0 for the zero
    word: the JAX package's ``31 - clz(max(low, 1).astype(int32))`` with
    ``low = word & (~word + 1)`` on uint32 words
    (wittgenstein_tpu/models/dfinity.py:462-463).  ``low`` is isolated in
    int64, where the negation cannot overflow and the comparison with 1
    is unsigned; ``low - 1`` then has exactly that many bits set."""
    w = word.to(torch.int64) & 0xFFFFFFFF
    low = w & (-w)
    return popcount_words(to_i32((low - 1).clamp_min(0)))
