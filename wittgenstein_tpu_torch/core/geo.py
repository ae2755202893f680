"""The vendored city database — the port of `wittgenstein_tpu/core/geo.py`.

`wittgenstein_tpu_torch/data/citydata.npz` is a byte-for-byte copy of
the JAX package's file: city names, map positions (2000 x 1112),
populations and the measured round-trip matrix.  The city index space
(NodeState.city for nodes placed by city) is the file's order.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache

import numpy as np

NPZ = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                   "citydata.npz")


@dataclasses.dataclass(frozen=True)
class CityDB:
    """wittgenstein_tpu/core/geo.py:24-38."""

    names: tuple            # city names, '+' for spaces
    x: np.ndarray           # int32 [C] map positions
    y: np.ndarray           # int32 [C]
    population: np.ndarray  # int64 [C]
    rtt: np.ndarray         # float32 [C, C] round-trip ms; diagonal 30

    @property
    def n(self):
        return len(self.names)

    def index(self, name: str) -> int:
        return self.names.index(name)


@lru_cache(maxsize=1)
def load() -> CityDB:
    """wittgenstein_tpu/core/geo.py:41-46."""
    with np.load(NPZ) as z:
        return CityDB(names=tuple(str(s) for s in z["names"]),
                      x=z["x"], y=z["y"], population=z["population"],
                      rtt=z["rtt"])
