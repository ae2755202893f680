"""Node builders — the port of `wittgenstein_tpu/core/builders.py`.

The random, AWS and city placements, the Tor extra-latency aspect and
the four speed models.  Cities are drawn by population: the cumulative
share is built in float64 and cast to float32, as the JAX package
builds it, and searched with the float32 draw.

A speed ratio is float32 math on a draw from the 2^-24 grid, and its
consumers truncate ``pairing_time * speed_ratio`` to an integer ms, so
each ratio equals the JAX package's bit for bit.  The JAX package
builds nodes in a protocol's `init`, which it never compiles: its
speeds are the op-by-op (eager) values, each operation rounded on its
own, and they differ from a `jax.jit` of the same function on 27%
(uniform), 15% (gaussian) and 0.04% (pareto) of the grid.  The port
computes the eager values:

- uniform: ``0.33 + u2 * 0.67`` and ``1 + u2 * 2``, two roundings;
- gaussian: ``sqrt(2) * erfinv(2u - 1) + 1``, with the JAX package's
  own float32 erfinv (`ops/fmath.erfinv_f32`), not `torch.erfinv`;
- pareto: ``min(3, 1 + (1 - u)^-1 - 1)``.  The JAX package's ``pow``
  is the C library's ``powf``, which differs from the correctly
  rounded reciprocal on 6,428 grid values; those values are shipped
  (``data/pareto_speed_fixes.npy``, regenerated by the tests).
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache

import numpy as np
import torch

from ..ops import fmath, prng
from . import geo
from .state import MAX_X, MAX_Y, NodeState, default_nodes

I32 = torch.int32
F32 = torch.float32

_PARETO_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "pareto_speed_fixes.npy")
SPEEDS = ("constant", "uniform", "gaussian", "pareto")

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
        if self.speed not in SPEEDS:
            raise ValueError(f"unknown speed model {self.speed!r}")

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
        speed = self._speed_ratios(seed, ids)
        if self.tor > 1e-3:
            u = prng.uniform_float(prng.hash2(seed, 5), ids)
            extra = torch.where(
                u < torch.tensor(self.tor, dtype=torch.float32,
                                 device=device), 500, 0).to(I32)
        else:
            extra = torch.zeros(n, dtype=I32, device=device)
        return nodes.replace(x=x.to(I32), y=y.to(I32), city=city,
                             speed_ratio=speed, extra_latency=extra)


    def _speed_ratios(self, seed, ids):
        """wittgenstein_tpu/core/builders.py:92-115."""
        u = prng.uniform_float(prng.hash2(seed, 4), ids)
        u2 = (prng.uniform_float(prng.hash2(seed, 6), ids)
              if self.speed == "uniform" else None)
        return speed_ratio(self.speed, u, u2)


_F033, _F067 = fmath.f32c(0.33), fmath.f32c(0.67)
_SQRT2 = fmath.f32c(np.sqrt(np.float32(2.0)))
_CLIP = fmath.f32c(0.999999)


_PARETO: dict = {}


def _pareto_fixes(device):
    """(grid index, float32 ratio) of the grid values where the JAX
    package's pareto speed (its ``powf``) differs from the correctly
    rounded reciprocal."""
    key = str(torch.device(device))
    if key not in _PARETO:
        fix = np.load(_PARETO_FILE).astype(np.int32)
        _PARETO[key] = (torch.tensor(fix[:, 0], device=device),
                        torch.tensor(fix[:, 1].view(np.float32),
                                     device=device))
    return _PARETO[key]


def speed_ratio(speed: str, u, u2=None):
    """float32 speed ratios from the builder's draws `u` (and `u2` for
    the uniform model), as the JAX package's `init` computes them (see
    the module docstring)."""
    if speed == "constant":
        return torch.ones_like(u)
    if speed == "uniform":
        # half the nodes fast in [0.33, 1), half slow in [1, 3)
        fast = u2 * _F067 + _F033
        slow = u2 * 2.0 + 1.0
        return torch.where(u < 0.5, fast, slow)
    if speed == "gaussian":
        # max(0.33, N(0,1) + 1) by the inverse CDF
        x = (2.0 * u - 1.0).clamp(-_CLIP, _CLIP)
        return torch.clamp_min(fmath.erfinv_f32(x) * _SQRT2 + 1.0, _F033)
    if speed == "pareto":
        # min(3, 1 + GPD(shape 1, location 0, scale 1))
        y = u.clamp(0.0, _CLIP)
        main = torch.ones_like(y) / (1.0 - y) - 1.0
        gpd = torch.where(y < 1e-6, 0.0, main)
        out = torch.clamp_max(gpd + 1.0, 3.0)
        idx, val = _pareto_fixes(u.device)
        k = (u * float(1 << 24)).to(I32)
        pos = torch.searchsorted(idx, k).clamp_max(len(idx) - 1)
        return torch.where(idx[pos] == k, val[pos], out)
    raise ValueError(f"unknown speed model {speed!r}")


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
