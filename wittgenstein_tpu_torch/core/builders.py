"""Node builders — the port of `wittgenstein_tpu/core/builders.py`.

The slice ports the random-position, constant-speed builder with the
Tor extra-latency aspect; the AWS and city placements and the other
speed models raise `NotImplementedError` (queued in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import prng
from .state import MAX_X, MAX_Y, NodeState, default_nodes

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class NodeBuilder:
    """Declarative node spec (wittgenstein_tpu/core/builders.py:41-115)."""

    location: str = "random"
    speed: str = "constant"
    tor: float = 0.0

    def __post_init__(self):
        if self.location != "random" or self.speed != "constant":
            raise NotImplementedError(
                f"node builder location={self.location!r} "
                f"speed={self.speed!r} is not ported yet (ROADMAP.md, "
                "'the other latency models and builders')")

    def build(self, seed, n: int, device) -> NodeState:
        """wittgenstein_tpu/core/builders.py:54-90, random placement."""
        nodes = default_nodes(n, device)
        seed = prng.hash2(seed, prng.TAG_BUILDER)
        ids = torch.arange(n, dtype=I32, device=device)
        x = 1 + prng.uniform_int(prng.hash2(seed, 1), ids, MAX_X)
        y = 1 + prng.uniform_int(prng.hash2(seed, 2), ids, MAX_Y)
        city = torch.full((n,), -1, dtype=I32, device=device)
        speed = torch.ones(n, dtype=torch.float32, device=device)
        if self.tor > 1e-3:
            u = prng.uniform_float(prng.hash2(seed, 5), ids)
            extra = torch.where(
                u < torch.tensor(self.tor, dtype=torch.float32,
                                 device=device), 500, 0).to(I32)
        else:
            extra = torch.zeros(n, dtype=I32, device=device)
        return nodes.replace(x=x.to(I32), y=y.to(I32), city=city,
                             speed_ratio=speed, extra_latency=extra)


def registry_name(location: str, speed_constant: bool, tor: float) -> str:
    """Reference builder name, e.g. 'RANDOM_SPEED=CONSTANT_TOR=0.33'
    (wittgenstein_tpu/core/builders.py:118-124)."""
    site = {"aws": "AWS", "cities": "CITIES", "random": "RANDOM"}[location]
    speed = "CONSTANT" if speed_constant else "GAUSSIAN"
    tor_s = (repr(tor) + "000")[:4]
    return f"{site}_speed={speed}_tor={tor_s}".upper()


def _registry():
    """name -> (location, speed, tor) for every registered builder
    (wittgenstein_tpu/core/builders.py:128-140); specs are turned into
    `NodeBuilder`s only on lookup."""
    reg = {}
    for loc in ("aws", "cities", "random"):
        for const in (True, False):
            for tor in (0.0, 0.01, 0.10, 0.20, 0.33, 0.5, 0.6, 0.8, 1.0):
                reg[registry_name(loc, const, tor)] = (
                    loc, "constant" if const else "uniform", tor)
    return reg


def get_by_name(name: str | None) -> NodeBuilder:
    """String-keyed lookup (wittgenstein_tpu/core/builders.py:143-150)."""
    if not name or not name.strip():
        name = registry_name("random", True, 0.0)
    reg = _registry()
    if name not in reg:
        raise KeyError(f"{name} not in the builder registry")
    loc, speed, tor = reg[name]
    return NodeBuilder(location=loc, speed=speed, tor=tor)
