"""Protocol contract helpers — the port of
`wittgenstein_tpu/core/protocol.py`.

A protocol holds `cfg` (EngineConfig), `latency` (a latency model) and
its parameters; ``init(seed) -> (NetState, pstate)`` builds the state
and ``step(pstate, nodes, inbox, t) -> (pstate, nodes, outbox)`` is the
per-ms transition for all nodes at once.  The JAX contract also passes
a `jax.random` key; no ported protocol reads it, so the port drops it.
"""

from __future__ import annotations

import torch

FAR_FUTURE = 1 << 30


def next_tick(t: int, phase, period):
    """Earliest ``u >= max(t, phase)`` on the ``phase + k*period`` grid
    (wittgenstein_tpu/core/protocol.py:45-53): `phase` an int32 tensor,
    `t` and `period` int32 tensors or Python ints."""
    period = (period.clamp_min(1) if isinstance(period, torch.Tensor)
              else max(1, period))
    base = phase.clamp_min(t)
    return base + (phase - base) % period


def masked_min(values, mask):
    """Min of `values` where `mask`, else FAR_FUTURE
    (wittgenstein_tpu/core/protocol.py:56-59); `values` broadcast
    against `mask`."""
    return torch.where(mask, values, FAR_FUTURE).min().to(torch.int32)


PROTOCOLS: dict[str, type] = {}


def register(cls):
    """Class decorator: adds the protocol to the name registry
    (wittgenstein_tpu/core/protocol.py:65-68)."""
    PROTOCOLS[cls.__name__] = cls
    return cls


def get_protocol(name: str):
    """wittgenstein_tpu/core/protocol.py:71-75."""
    if name not in PROTOCOLS:
        raise KeyError(
            f"unknown protocol {name!r}; known: {sorted(PROTOCOLS)}")
    return PROTOCOLS[name]
