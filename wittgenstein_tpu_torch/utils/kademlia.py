"""Kademlia XOR-distance helpers (core/utils/Kademlia.java:5-29) — the
port of `wittgenstein_tpu/utils/kademlia.py` in torch integer ops.

Node ids are ``[..., B]`` uint8 tensors (the SHA-256 node hashes of
`NodeBuilder`, say); `distance` maps over any leading axes, so one call
scores a node against its whole routing table.  No shipped protocol
uses it (as in the reference); the k-bucket semantics a discv4/discv5
model would build on are in the JAX module's docstring.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def distance(a, b):
    """Bit length of the XOR distance of two byte ids
    (Kademlia.java:8-29; wittgenstein_tpu/utils/kademlia.py:27-47).

    a, b: broadcast-compatible uint8 tensors ``[..., B]`` -> int32
    ``[...]``: 0 for equal ids, else the number of significant bits of
    ``a ^ b`` counted from the most significant byte."""
    a = torch.as_tensor(a, dtype=torch.uint8)
    b = torch.as_tensor(b, dtype=torch.uint8, device=a.device)
    x = (a ^ b).to(I32)                                 # [..., B]
    nbytes = x.shape[-1]
    nz = x != 0
    # the first nonzero byte (B if none): argmax of a 0/1 row is its
    # first 1
    first = torch.where(nz.any(-1), nz.to(I32).argmax(-1).to(I32),
                        nbytes)
    byte = torch.gather(x, -1, first.clamp_max(nbytes - 1)[..., None]
                        .long())[..., 0]
    # bit length of a byte in [0, 255]: 8 minus its leading zeros
    blen = torch.zeros_like(byte)
    for bit in range(8):
        blen = torch.where((byte >> bit) > 0, bit + 1, blen)
    return torch.where(first >= nbytes, 0,
                       (nbytes - 1 - first) * 8 + blen).to(I32)


def bucket_index(a, b, n_buckets: int = 256):
    """The k-bucket of peer b as a sees it: distance - 1 clamped to the
    table (bucket i spans distances (2^i, 2^(i+1)]; discv4 uses 256
    buckets of k=16)."""
    return (distance(a, b) - 1).clamp(0, n_buckets - 1)
