"""ETHPoW's tick-scaled latency wrapper — from
`wittgenstein_tpu/models/ethpow.py`.

This module holds only `_TickScaled`, which Dfinity imports from here as
the JAX package's Dfinity does.  ETHPoW itself (the proof-of-work chain,
its difficulty and uncle rules) is queued under A8 in ROADMAP.md.
"""

from __future__ import annotations

import torch

from ..core.latency import latency_floor_ms


class _TickScaled:
    """Wraps a ms latency model: its output is ceil-divided into engine
    ticks (wittgenstein_tpu/models/ethpow.py:98-120)."""

    def __init__(self, inner, tick_ms):
        self.inner = inner
        self.tick_ms = tick_ms
        self.name = f"TickScaled({inner!r}, {tick_ms})"

    def validate(self, nodes):
        v = getattr(self.inner, "validate", None)
        if v is not None:
            v(nodes)

    def extended(self, nodes, src, dst, delta):
        ms = self.inner.extended(nodes, src, dst, delta)
        return -torch.div(-ms, self.tick_ms, rounding_mode="floor")

    def latency_floor_ms(self):
        # Ceil-scaling is monotone, so the wrapped floor ceil-divides
        # through (>= 1 either way).
        return max(1, -(-latency_floor_ms(self.inner) // self.tick_ms))

    def __repr__(self):
        return self.name
