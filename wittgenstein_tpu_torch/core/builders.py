"""Node builders — the port of `wittgenstein_tpu/core/builders.py`.

Ported: the random, AWS and city placements with constant speed and
the Tor extra-latency aspect.  Cities are drawn by population: the
cumulative share is built in float64 and cast to float32, as the JAX
package builds it, and searched with the float32 draw.  The uniform,
gaussian and pareto speed models raise `NotImplementedError` (queued
in ROADMAP.md; gaussian's erfinv and pareto's GPD inverse are float
hazards).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..ops import prng
from . import geo
from .state import MAX_X, MAX_Y, NodeState, default_nodes

I32 = torch.int32

# GeoAWS city positions on the 2000x1112 map, in the JAX package's
# AWS_REGIONS order (wittgenstein_tpu/core/builders.py:22-27).
AWS_CITY_X = np.array([271, 513, 1344, 1641, 1507, 1773, 1708, 422, 985, 891,
                       937], np.int32)
AWS_CITY_Y = np.array([261, 316, 426, 312, 532, 777, 316, 256, 226, 200, 205],
                      np.int32)


@lru_cache(maxsize=1)
def _city_table():
    """(x, y, float32 cumulative population share) of the city
    database (wittgenstein_tpu/core/builders.py:30-37, 76-80)."""
    db = geo.load()
    pops = db.population.astype(np.float64)
    cum = np.cumsum(pops / pops.sum()).astype(np.float32)
    return db.x.astype(np.int32), db.y.astype(np.int32), cum


@dataclasses.dataclass(frozen=True)
class NodeBuilder:
    """Declarative node spec (wittgenstein_tpu/core/builders.py:41-115)."""

    location: str = "random"
    speed: str = "constant"
    tor: float = 0.0

    def __post_init__(self):
        if self.location not in ("random", "aws", "cities"):
            raise ValueError(f"unknown location {self.location!r}")
        if self.speed != "constant":
            raise NotImplementedError(
                f"node builder speed={self.speed!r} is not ported yet "
                "(ROADMAP.md, 'the other latency models and builders')")

    def build(self, seed, n: int, device) -> NodeState:
        """wittgenstein_tpu/core/builders.py:54-90."""
        nodes = default_nodes(n, device)
        seed = prng.hash2(seed, prng.TAG_BUILDER)
        ids = torch.arange(n, dtype=I32, device=device)
        if self.location == "random":
            x = 1 + prng.uniform_int(prng.hash2(seed, 1), ids, MAX_X)
            y = 1 + prng.uniform_int(prng.hash2(seed, 2), ids, MAX_Y)
            city = torch.full((n,), -1, dtype=I32, device=device)
        else:
            if self.location == "aws":
                cx, cy = AWS_CITY_X, AWS_CITY_Y
                # equal-weighted regions
                city = prng.uniform_int(prng.hash2(seed, 3), ids, len(cx))
            else:
                cx, cy, cum = _city_table()
                u = prng.uniform_float(prng.hash2(seed, 3), ids)
                city = torch.searchsorted(
                    torch.tensor(cum, device=device), u).to(I32)
                city = city.clamp_max(len(cx) - 1)
            x = torch.tensor(cx, device=device)[city.long()]
            y = torch.tensor(cy, device=device)[city.long()]
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
