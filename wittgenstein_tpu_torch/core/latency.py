"""Network latency models — the port of `wittgenstein_tpu/core/latency.py`.

Each model is ``extended(nodes, src, dst, delta) -> int32 ms`` over
index tensors and per-message draws ``delta in [0, 100)``;
`full_latency` applies the shared wrapper (same node -> 1 ms, else
``max(1, extra[src] + extra[dst] + extended)``).

The distance model is the one place on the main path where the JAX
package does float math whose result is truncated to an integer: a
float32 ``pow`` in the Pareto jitter and a float32 miles conversion.
One ulp of difference between two math libraries flips an integer ms.
So the port never redoes that float math on the device: it looks the
latency up in an int32 table over every ``(dist, delta)`` pair
(``dist in [0, MAX_DIST]``, ``delta in [0, 100)``), generated once from
the JAX function and shipped in ``data/`` (the tests regenerate it and
compare it entry for entry).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .state import MAX_DIST, MAX_X, MAX_Y

I32 = torch.int32

_TABLE_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "latency_by_distance_w_jitter.npy")


def isqrt(v):
    """Exact integer square root of non-negative int64 values."""
    r = torch.sqrt(v.to(torch.float64)).floor().to(torch.int64)
    r = r - (r * r > v).to(torch.int64)
    return r + ((r + 1) * (r + 1) <= v).to(torch.int64)


def torus_dist(nodes, src, dst):
    """Distance on the 2000x1112 torus map
    (wittgenstein_tpu/core/latency.py:39-45).  The JAX form truncates
    a float32 sqrt of an integer below 2**24; a correctly rounded sqrt
    truncates to the exact integer root, which is computed here."""
    dx = (nodes.x[src] - nodes.x[dst]).abs()
    dy = (nodes.y[src] - nodes.y[dst]).abs()
    dx = torch.minimum(dx, MAX_X - dx).to(torch.int64)
    dy = torch.minimum(dy, MAX_Y - dy).to(torch.int64)
    return isqrt(dx * dx + dy * dy).to(I32)


def gpd_inverse(y, shape=1.4, location=-0.3, scale=0.35):
    """Generalized Pareto inverse CDF in float32
    (wittgenstein_tpu/core/latency.py:48-53).  Not used on the device
    path: see the module docstring and `distance_latency_table`."""
    y = torch.as_tensor(y, dtype=torch.float32).clamp(0.0, 0.999999)
    main = location + scale / shape * (torch.pow(1.0 - y, -shape) - 1.0)
    return torch.where(y < 1e-6, torch.full_like(y, location), main)


class NetworkNoLatency:
    """Always 1 ms (wittgenstein_tpu/core/latency.py:56-69)."""

    positional = False
    name = "NetworkNoLatency"

    def extended(self, nodes, src, dst, delta):
        return torch.ones_like(delta)

    def latency_floor_ms(self):
        return 1

    def __repr__(self):
        return self.name


class NetworkFixedLatency:
    """Constant latency (wittgenstein_tpu/core/latency.py:72-88)."""

    positional = False

    def __init__(self, fixed: int):
        self.fixed = max(1, int(fixed))
        self.name = f"NetworkFixedLatency({self.fixed})"

    def extended(self, nodes, src, dst, delta):
        return torch.full_like(delta, self.fixed)

    def latency_floor_ms(self):
        return self.fixed

    def __repr__(self):
        return self.name


class NetworkUniformLatency:
    """Uniform in [0, max]: ``(delta / 99) * max``
    (wittgenstein_tpu/core/latency.py:91-107), looked up in a 100-entry
    table made at construction.  The JAX function is float32 math
    truncated to an integer, and the reference is what it computes
    under `jax.jit`: XLA folds the division by the constant into
    ``delta * (max * float32(1/99))``, which truncates differently from
    the written ``(delta / 99) * max`` (and from eager JAX) for 97 of
    the max values 1..1000.  The table is made with the folded form in
    numpy float32, and the tests hold it against the jitted JAX
    function."""

    positional = False

    def __init__(self, max_latency: int):
        self.max_latency = max(1, int(max_latency))
        self.name = f"NetworkUniformLatency({self.max_latency})"
        scale = np.float32(self.max_latency) * np.float32(1.0 / 99.0)
        self.table = (np.arange(100, dtype=np.float32) * scale).astype(
            np.int32)
        self._tables: dict = {}

    def extended(self, nodes, src, dst, delta):
        key = str(delta.device)
        if key not in self._tables:
            self._tables[key] = torch.tensor(self.table, device=delta.device)
        return self._tables[key][delta.long()]

    def latency_floor_ms(self):
        return 1                        # delta == 0 -> extended == 0

    def __repr__(self):
        return self.name


_TABLES: dict = {}


def distance_latency_table(device) -> torch.Tensor:
    """The shipped ``[MAX_DIST + 1, 100]`` int32 latency table of
    `NetworkLatencyByDistanceWJitter`, on `device` (loaded once per
    device)."""
    key = str(torch.device(device))
    if key not in _TABLES:
        table = np.load(_TABLE_FILE).astype(np.int32)
        if table.shape != (MAX_DIST + 1, 100):
            raise ValueError(f"{_TABLE_FILE} has shape {table.shape}, "
                             f"want {(MAX_DIST + 1, 100)}")
        _TABLES[key] = torch.tensor(table, device=device)
    return _TABLES[key]


class NetworkLatencyByDistanceWJitter:
    """One-way latency = (0.022 * miles + 4.862 + ParetoJitter) / 2
    (wittgenstein_tpu/core/latency.py:110-133), looked up by
    ``(torus_dist, delta)`` in the shipped table."""

    name = "NetworkLatencyByDistanceWJitter"

    def extended(self, nodes, src, dst, delta):
        table = distance_latency_table(delta.device)
        dist = torus_dist(nodes, src, dst).to(torch.int64)
        return table.reshape(-1)[dist * 100 + delta.to(torch.int64)]

    def latency_floor_ms(self):
        # Smallest table entry: int((4.862 + gpd_inverse(0)) / 2) == 2
        # (wittgenstein_tpu/core/latency.py:125-130).
        return max(1, int(np.load(_TABLE_FILE).min()))

    def __repr__(self):
        return self.name


#: registry names (wittgenstein_tpu/core/latency.py) the port does not
#: serve yet; each belongs to a later slice in ROADMAP.md
_LATER = ("AwsRegionNetworkLatency",
          "MeasuredNetworkLatency", "EthScanNetworkLatency",
          "NetworkLatencyByCity", "NetworkLatencyByCityWJitter",
          "IC3NetworkLatency", "NetworkHeterogeneousLatency",
          "NetworkCSVLatency", "MathisNetworkThroughput")


def get_by_name(name: str | None):
    """String-keyed latency lookup (wittgenstein_tpu/core/latency.py:504-534)
    for the models the port has; None is the distance model."""
    if not name:
        return NetworkLatencyByDistanceWJitter()
    if name == "NetworkNoLatency":
        return NetworkNoLatency()
    if name == "NetworkLatencyByDistanceWJitter":
        return NetworkLatencyByDistanceWJitter()
    for cls in (NetworkFixedLatency, NetworkUniformLatency):
        head = cls.__name__ + "("
        if name.startswith(head) and name.endswith(")"):
            try:
                return cls(int(name[len(head):-1]))
            except ValueError:
                raise ValueError(
                    f"bad parameters in latency name {name!r} (expected "
                    f"e.g. '{cls.__name__}(100)')") from None
    if name.split("(", 1)[0] in _LATER:
        raise NotImplementedError(
            f"latency model {name!r} is not ported yet (ROADMAP.md, "
            "'the other latency models and builders')")
    raise KeyError(f"unknown latency model {name!r}")


def full_latency(model, nodes, src, dst, delta):
    """The shared `getLatency` wrapper
    (wittgenstein_tpu/core/latency.py:537-541)."""
    base = nodes.extra_latency[src] + nodes.extra_latency[dst]
    lat = (base + model.extended(nodes, src, dst, delta)).clamp_min(1)
    return torch.where(src == dst, torch.ones_like(lat), lat)


def latency_floor_ms(model) -> int:
    """The model's provable distinct-pair floor, or 1
    (wittgenstein_tpu/core/latency.py:544-552)."""
    fn = getattr(model, "latency_floor_ms", None)
    if fn is None:
        return 1
    return max(1, int(fn()))
