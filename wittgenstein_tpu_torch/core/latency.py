"""Network latency models — the port of `wittgenstein_tpu/core/latency.py`.

Each model is ``extended(nodes, src, dst, delta) -> int32 ms`` over
index tensors and per-message draws ``delta in [0, 100)``;
`full_latency` applies the shared wrapper (same node -> 1 ms, else
``max(1, extra[src] + extra[dst] + extended)``).  A model with a
``validate(nodes)`` hook refuses node layouts it cannot serve; the
engine's `Runner` calls it once, as the JAX `Runner` does.

Where the JAX package does float math whose result is truncated or
rounded to an integer, one ulp of difference between two math
libraries flips an integer ms.  So the port never redoes float math it
cannot reproduce exactly on the device: what depends on a float32
``pow`` comes from tables generated once from the JAX functions under
`jax.jit` (as the engine's step runs them) and shipped in ``data/``,
and the tests regenerate each table and compare it entry for entry:

- the distance model, an int32 table over every ``(dist, delta)``
  pair (``dist in [0, MAX_DIST]``);
- the generalized-Pareto jitter ``gpd_inverse(delta / 100)`` of the
  city-jitter and AWS models, the 100 float32 values stored as their
  bits;
- IC3's latency over every ``dist`` (its float32 area ratio, with the
  division by the map area as XLA folds it).

What remains is float32 math that IEEE arithmetic fixes (an add, a
halving, a round to nearest even), done in float32 on the device.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..ops import prng
from .state import MAX_DIST, MAX_X, MAX_Y

I32 = torch.int32
F32 = torch.float32

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
_TABLE_FILE = os.path.join(_DATA, "latency_by_distance_w_jitter.npy")
_JITTER_FILE = os.path.join(_DATA, "gpd_jitter_bits.npy")
_IC3_FILE = os.path.join(_DATA, "ic3_latency_by_distance.npy")

_CONSTS: dict = {}


def _on(device, key: str, make, owner=None):
    """The constant tensor `key` on `device`, made by ``make()`` (a
    numpy array) once per device: module-wide, or per `owner` (a
    model holding its own table)."""
    cache = _CONSTS if owner is None else owner.__dict__.setdefault(
        "_tensors", {})
    k = (key, str(torch.device(device)))
    if k not in cache:
        cache[k] = torch.tensor(make(), device=device)
    return cache[k]


def isqrt(v):
    """Exact integer square root of non-negative int64 values below
    2**24 (a torus distance squared is below 2**21): the float32 root
    of such a value is within one of the integer root, which the two
    steps below correct, so no 64-bit float enters the step."""
    r = torch.sqrt(v.to(torch.float32)).floor().to(torch.int64)
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
    path: the models read the JAX function's values from the shipped
    tables (see the module docstring)."""
    y = torch.as_tensor(y, dtype=F32).clamp(0.0, 0.999999)
    main = location + scale / shape * (torch.pow(1.0 - y, -shape) - 1.0)
    return torch.where(y < 1e-6, torch.full_like(y, location), main)


def jitter_table(device) -> torch.Tensor:
    """float32 [100]: the JAX package's jitted ``gpd_inverse(delta /
    100)`` for every delta, from the shipped bits."""
    return _on(device, "jitter", lambda: np.load(_JITTER_FILE).astype(
        np.int32).view(np.float32))


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

    def extended(self, nodes, src, dst, delta):
        return _on(delta.device, "table", lambda: self.table, self)[
            delta.long()]

    def latency_floor_ms(self):
        return 1                        # delta == 0 -> extended == 0

    def __repr__(self):
        return self.name


def distance_latency_table(device) -> torch.Tensor:
    """The shipped ``[MAX_DIST + 1, 100]`` int32 latency table of
    `NetworkLatencyByDistanceWJitter`, on `device` (loaded once per
    device)."""
    def make():
        table = np.load(_TABLE_FILE).astype(np.int32)
        if table.shape != (MAX_DIST + 1, 100):
            raise ValueError(f"{_TABLE_FILE} has shape {table.shape}, "
                             f"want {(MAX_DIST + 1, 100)}")
        return table
    return _on(device, "distance", make)


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


# AWS inter-region ping matrix, ms RTT (wittgenstein_tpu/core/latency.py:
# 136-155), in the region order of the AWS placement.
AWS_REGIONS = ["Oregon", "Virginia", "Mumbai", "Seoul", "Singapore", "Sydney",
               "Tokyo", "Canada central", "Frankfurt", "Ireland", "London"]
_AWS_UPPER = np.array([
    [0, 81, 216, 126, 165, 138, 97, 64, 164, 131, 141],
    [0, 0, 182, 181, 232, 195, 167, 13, 88, 80, 75],
    [0, 0, 0, 152, 62, 223, 123, 194, 111, 122, 113],
    [0, 0, 0, 0, 97, 133, 35, 184, 259, 254, 264],
    [0, 0, 0, 0, 0, 169, 69, 218, 162, 174, 171],
    [0, 0, 0, 0, 0, 0, 105, 210, 282, 269, 271],
    [0, 0, 0, 0, 0, 0, 0, 156, 235, 222, 234],
    [0, 0, 0, 0, 0, 0, 0, 0, 101, 78, 87],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 13],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]], dtype=np.int32)
AWS_RTT = _AWS_UPPER + _AWS_UPPER.T


def _require_cities(name: str, nodes, builder: str, why: str = ""):
    if bool((nodes.city < 0).any()):
        raise ValueError(
            f"{name} needs city-positioned nodes "
            f"(NodeBuilder(location='{builder}')){why}")


class AwsRegionNetworkLatency:
    """11-region measured ping matrix, halved, plus the Pareto jitter
    truncated to an integer; same region 1 ms
    (wittgenstein_tpu/core/latency.py:158-186).  Node ``city`` indexes
    AWS_REGIONS."""

    name = "AwsRegionNetworkLatency"

    def validate(self, nodes):
        _require_cities(self.name, nodes, "aws", "; got city == -1 nodes")

    def extended(self, nodes, src, dst, delta):
        r1, r2 = nodes.city[src].long(), nodes.city[dst].long()
        jitter = jitter_table(delta.device)[delta.long()].to(I32)
        rtt = _on(delta.device, "aws", lambda: AWS_RTT)
        lat = (torch.div(rtt[r1, r2], 2, rounding_mode="floor")
               + jitter).clamp_min(1)
        return torch.where(r1 == r2, 1, lat).to(I32)

    def latency_floor_ms(self):
        return 1                        # same-region distinct pairs: 1 ms

    def __repr__(self):
        return self.name


def build_distribution(proportions, values):
    """The 100-bucket table of a (proportions %, values ms) histogram
    spec (wittgenstein_tpu/core/latency.py:189-208)."""
    table = np.zeros(100, np.int32)
    li, cur, total = 0, 0, 0
    for prop, val in zip(proportions, values):
        if prop == 0:
            cur = val
            continue
        total += prop
        step = (val - cur) // prop
        for _ in range(prop):
            cur += step
            table[li] = cur
            li += 1
    if total != 100 or li != 100:
        raise ValueError(f"proportions must sum to 100 (got {total}, {li})")
    return table


class MeasuredNetworkLatency:
    """Arbitrary 100-bucket latency distribution
    (wittgenstein_tpu/core/latency.py:211-228); `table` is int32 numpy."""

    positional = False

    def __init__(self, proportions, values, name="MeasuredNetworkLatency"):
        self.table = build_distribution(proportions, values)
        self.name = name

    def extended(self, nodes, src, dst, delta):
        return _on(delta.device, "table", lambda: self.table, self)[
            delta.long()]

    def latency_floor_ms(self):
        return max(1, int(np.asarray(self.table).min()))

    def __repr__(self):
        return self.name


# ethstats.net block-propagation distribution
# (wittgenstein_tpu/core/latency.py:231-234).
ETHSCAN_PROP = [16, 18, 17, 12, 8, 5, 4, 3, 3, 1, 1, 2, 1, 1, 8]
ETHSCAN_VAL = [250, 500, 1000, 1250, 1500, 1750, 2000, 2250, 2500, 2750,
               4500, 6000, 8500, 9750, 10000]


class EthScanNetworkLatency(MeasuredNetworkLatency):
    """wittgenstein_tpu/core/latency.py:237-239."""

    def __init__(self):
        super().__init__(ETHSCAN_PROP, ETHSCAN_VAL, name="EthScanNetworkLatency")


def _city_rtt():
    from . import geo
    return np.asarray(geo.load().rtt)


class NetworkLatencyByCity:
    """Measured city-to-city RTT halved, rounded half to even, at least
    1 ms (wittgenstein_tpu/core/latency.py:242-276).  Node ``city``
    indexes the vendored city database (`core/geo.py`)."""

    name = "NetworkLatencyByCity"

    def __init__(self):
        self.rtt = _city_rtt()          # float32 [C, C]

    def _rtt(self, device):
        return _on(device, "rtt", lambda: self.rtt, self)

    def validate(self, nodes):
        _require_cities("NetworkLatencyByCity", nodes, "cities",
                        "; the reference throws IllegalStateException for "
                        "DEFAULT_CITY nodes (NetworkLatency.java:175-178)")

    def extended(self, nodes, src, dst, delta):
        half = 0.5 * self._rtt(delta.device)[nodes.city[src].long(),
                                             nodes.city[dst].long()]
        return torch.round(half).clamp_min(1).to(I32)

    def latency_floor_ms(self):
        # Exhaustive min over the finite (c1, c2) pair space, diagonal
        # included (distinct nodes in one city).
        return max(1, int(np.maximum(
            1, np.round(0.5 * np.asarray(self.rtt))).min()))

    def __repr__(self):
        return self.name


class NetworkLatencyByCityWJitter(NetworkLatencyByCity):
    """City matrix plus the generalized-Pareto jitter; 10 ms intra-city
    RTT (wittgenstein_tpu/core/latency.py:279-300): ``round((jitter +
    rtt) / 2)`` in float32, the jitter from the shipped table."""

    name = "NetworkLatencyByCityWJitter"

    def extended(self, nodes, src, dst, delta):
        c1, c2 = nodes.city[src].long(), nodes.city[dst].long()
        raw = jitter_table(delta.device)[delta.long()] + torch.where(
            c1 == c2, 10.0, self._rtt(delta.device)[c1, c2])
        return torch.round(0.5 * raw).clamp_min(1).to(I32)

    def latency_floor_ms(self):
        # Same-city pairs use the 10 ms constant, cross-city pairs the
        # off-diagonal entries; the jitter's infimum is its location.
        m = np.asarray(self.rtt).astype(np.float64)
        off = m + np.eye(m.shape[0]) * np.float64(1 << 30)
        rtt_min = min(10.0, float(off.min()))
        jit0 = float(np.load(_JITTER_FILE).astype(np.int32).view(
            np.float32)[0])
        return max(1, int(np.round(0.5 * (rtt_min + jit0))))

    def __repr__(self):
        return self.name


class IC3NetworkLatency:
    """IC3 paper percentile table keyed by covered-area ratio
    (wittgenstein_tpu/core/latency.py:303-324), looked up by torus
    distance in the shipped table."""

    name = "IC3NetworkLatency"

    def extended(self, nodes, src, dst, delta):
        table = _on(delta.device, "ic3", lambda: np.load(_IC3_FILE).astype(
            np.int32))
        return table[torus_dist(nodes, src, dst).long()]

    def latency_floor_ms(self):
        return 92 // 2                  # min of the halved percentile table

    def __repr__(self):
        return self.name


class NetworkHeterogeneousLatency:
    """Per-link heterogeneous, asymmetric latency
    (wittgenstein_tpu/core/latency.py:327-384): every unordered pair a
    stable draw in ``[base, base + spread]`` plus every ordered pair a
    skew in ``[0, skew]``, keyed on the model's own `seed` by counter
    hashes; `delta` is unused."""

    positional = False
    _TAG = 0x4845544C

    def __init__(self, base: int, spread: int = 0, skew: int = 0,
                 seed: int = 0):
        base, spread, skew, seed = (int(base), int(spread), int(skew),
                                    int(seed))
        if base < 1 or spread < 0 or skew < 0 or seed < 0:
            raise ValueError(
                f"NetworkHeterogeneousLatency wants base >= 1, "
                f"spread >= 0, skew >= 0, seed >= 0; got ({base}, "
                f"{spread}, {skew}, {seed})")
        self.base, self.spread, self.skew, self.seed = (base, spread,
                                                        skew, seed)
        self.name = (f"NetworkHeterogeneousLatency({base},{spread},"
                     f"{skew},{seed})")

    def extended(self, nodes, src, dst, delta):
        key = prng.hash2(self.seed, self._TAG)
        lo = torch.minimum(src, dst)
        hi = torch.maximum(src, dst)
        pair = prng.uniform_int(prng.hash2(key, 1), prng.hash2(lo, hi),
                                self.spread + 1)
        skew = prng.uniform_int(prng.hash2(key, 2), prng.hash2(src, dst),
                                self.skew + 1)
        return (self.base + pair + skew).to(I32)

    def latency_floor_ms(self):
        return self.base

    def __repr__(self):
        return self.name


class NetworkCSVLatency(NetworkLatencyByCity):
    """Measured per-city-pair RTTs from a CSV file
    (wittgenstein_tpu/core/latency.py:387-479): a header row naming the
    cities (an optional leading label cell is ignored), then one row per
    source city, its name and its RTT in ms to each header city.  The
    matrix may be asymmetric; `extended` and the floor are the vendored
    city model's.  A missing or malformed file refuses at construction
    with the JAX package's texts and remedies."""

    def __init__(self, path: str):
        self.path = str(path)
        self.name = f"NetworkCSVLatency({self.path})"
        if not os.path.isfile(self.path):
            raise ValueError(
                f"NetworkCSVLatency: no CSV at {self.path!r}. Fix: "
                "point the name at a readable file of the form "
                "'city,CityA,CityB,...' header + one 'CityA,rtt,...' "
                "row per city (RTT in ms)")
        with open(self.path, newline="") as f:
            rows = [r for r in csv.reader(f)
                    if r and any(c.strip() for c in r)]
        if len(rows) < 2:
            raise ValueError(
                f"NetworkCSVLatency: {self.path!r} holds no matrix "
                "(need a header row + at least one city row)")
        header = [c.strip() for c in rows[0]]
        cities = header[1:] if len(header) == len(rows[1]) else header
        n = len(cities)
        if n < 1 or len(set(cities)) != n:
            raise ValueError(
                f"NetworkCSVLatency: {self.path!r} header names "
                f"{cities!r} are empty or duplicated — one distinct "
                "city per column")
        mat = np.zeros((n, n), np.int32)
        names = []
        for i, row in enumerate(rows[1:]):
            cells = [c.strip() for c in row]
            if len(cells) != n + 1:
                raise ValueError(
                    f"NetworkCSVLatency: {self.path!r} row {i + 1} has "
                    f"{len(cells)} cell(s); expected a city name + "
                    f"{n} RTT values (header order: {cities})")
            names.append(cells[0])
            for j, cell in enumerate(cells[1:]):
                try:
                    val = float(cell)
                except ValueError:
                    raise ValueError(
                        f"NetworkCSVLatency: {self.path!r} row "
                        f"{i + 1} column {cities[j]!r}: {cell!r} is "
                        "not a number (RTT in ms)") from None
                if val < 0:
                    raise ValueError(
                        f"NetworkCSVLatency: {self.path!r} row "
                        f"{i + 1} column {cities[j]!r}: RTT {val} "
                        "must be >= 0 ms")
                mat[i, j] = np.int32(round(val))
        if len(names) != n or [x.lower() for x in names] != \
                [x.lower() for x in cities]:
            raise ValueError(
                f"NetworkCSVLatency: {self.path!r} row names {names} "
                f"do not match the header {cities} in order — the "
                "matrix must be square over one city list")
        self.cities = tuple(cities)
        self.rtt = mat                  # int32, as the JAX model holds it

    def extended(self, nodes, src, dst, delta):
        rtt = self._rtt(delta.device)[nodes.city[src].long(),
                                      nodes.city[dst].long()]
        return torch.round(0.5 * rtt.to(F32)).clamp_min(1).to(I32)

    def validate(self, nodes):
        if bool((nodes.city < 0).any()):
            raise ValueError(
                f"{self.name} needs city-positioned nodes "
                "(NodeBuilder(location='cities')); got city == -1 "
                "nodes")
        if bool((nodes.city >= len(self.cities)).any()):
            raise ValueError(
                f"{self.name} covers {len(self.cities)} cities but "
                f"nodes reference city id {int(nodes.city.max())} — the "
                "CSV must name every city the node builder assigns")


def latency_name(kind: str, fixed: int) -> str:
    """Registry names such as 'NetworkFixedLatency(100)'
    (wittgenstein_tpu/core/latency.py:482-487)."""
    cls = {"FIXED": "NetworkFixedLatency",
           "UNIFORM": "NetworkUniformLatency"}[kind.upper()]
    return f"{cls}({int(fixed)})"


#: parametrised registry constructors — name(int[,int...]) forms
_PARAM_MODELS = {
    "NetworkFixedLatency": NetworkFixedLatency,
    "NetworkUniformLatency": NetworkUniformLatency,
    "NetworkHeterogeneousLatency": NetworkHeterogeneousLatency,
}

#: parametrised constructors taking one raw string argument (a path)
_PATH_MODELS = {
    "NetworkCSVLatency": NetworkCSVLatency,
}

#: the models a bare class name builds (those that take parameters
#: raise TypeError, as in the JAX package)
_BY_NAME = {cls.__name__: cls for cls in (
    NetworkNoLatency, NetworkFixedLatency, NetworkUniformLatency,
    NetworkLatencyByDistanceWJitter, AwsRegionNetworkLatency,
    MeasuredNetworkLatency, EthScanNetworkLatency, NetworkLatencyByCity,
    NetworkLatencyByCityWJitter, IC3NetworkLatency,
    NetworkHeterogeneousLatency, NetworkCSVLatency)}


def get_by_name(name: str | None):
    """String-keyed latency lookup (wittgenstein_tpu/core/latency.py:
    504-534): parametrised ``Class(int[,int...])`` names and
    ``NetworkCSVLatency(path.csv)``, then bare class names; None is the
    distance model.  An unknown name is a KeyError; a malformed
    parameter list, or a missing or malformed CSV, a ValueError."""
    if not name:
        return NetworkLatencyByDistanceWJitter()
    if "(" in name and name.endswith(")"):
        cls, arg = name[:-1].split("(", 1)
        if cls in _PATH_MODELS:
            return _PATH_MODELS[cls](arg.strip())
        ctor = _PARAM_MODELS.get(cls)
        if ctor is None:
            raise KeyError(f"unknown parametrised latency {name!r}; "
                           f"known: {sorted(_PARAM_MODELS) + sorted(_PATH_MODELS)}")
        try:
            args = [int(x) for x in arg.split(",")] if arg.strip() else []
            return ctor(*args)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad parameters in latency name {name!r}: {e} "
                f"(expected comma-separated ints, e.g. "
                f"'NetworkFixedLatency(100)' or "
                f"'NetworkHeterogeneousLatency(20,10,6)')") from None
    model = _BY_NAME.get(name)
    if model is None:
        raise KeyError(f"unknown latency model {name!r}")
    return model()


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


class MathisNetworkThroughput:
    """Size-dependent delay from the TCP Mathis equation
    (wittgenstein_tpu/core/latency.py:555-588): the wrapped model's
    latency, plus the transfer time at ``min(MSS*8 / (RTT sqrt(loss)),
    window / RTT)`` for messages of at least one segment.  float32, in
    the JAX function's operation order, each operation rounded on its
    own (a tensor divided into a scalar is written as a division, not
    PyTorch's reciprocal-times-scalar)."""

    MSS = 1460
    LOSS = 0.004

    def __init__(self, latency_model, window_bytes=87380 * 1024):
        self.latency_model = latency_model
        self.window_bits = 8 * window_bytes
        self.name = f"MathisNetworkThroughput({latency_model!r})"

    def delay(self, nodes, src, dst, delta, msg_size):
        st = full_latency(self.latency_model, nodes, src, dst,
                          delta).to(F32)
        rtt = st * 2.0
        bandwidth = torch.full_like(rtt, self.MSS * 8) / (
            rtt * float(np.float32(np.sqrt(self.LOSS))))
        w_max = torch.full_like(rtt, float(np.float32(self.window_bits))) \
            / rtt
        av = torch.minimum(bandwidth, w_max)
        slow = (8.0 * msg_size.to(F32)) / av + st
        return torch.where(msg_size < self.MSS, st,
                           slow.to(I32).to(F32)).to(I32)

    def latency_floor_ms(self):
        return latency_floor_ms(self.latency_model)

    def __repr__(self):
        return self.name


def _quantile_table(lat, name):
    """The 100-quantile `MeasuredNetworkLatency` of observed latencies
    (wittgenstein_tpu/core/latency.py:591-602)."""
    lat = np.sort(np.asarray(lat))
    qs = np.quantile(lat, (np.arange(100) + 1) / 100.0,
                     method="lower").astype(np.int32)
    qs = np.maximum.accumulate(np.maximum(qs, 1))
    table = MeasuredNetworkLatency.__new__(MeasuredNetworkLatency)
    table.table = qs
    table.name = name
    return table


def estimate_latency(model, nodes, rounds=100, seed=0):
    """Monte-Carlo sample of a latency model into a
    `MeasuredNetworkLatency` (wittgenstein_tpu/core/latency.py:605-622)."""
    n = int(nodes.x.shape[0])
    ids = torch.arange(rounds * n, dtype=I32, device=nodes.x.device)
    s = prng.hash2(seed, 0x4C455354)
    src = prng.uniform_int(prng.hash2(s, 1), ids, n)
    dst = prng.uniform_int(prng.hash2(s, 2), ids, n)
    delta = prng.uniform_delta(prng.hash2(s, 3), ids)
    lat = full_latency(model, nodes, src, dst, delta)[src != dst]
    return _quantile_table(
        lat.cpu().numpy(), f"MeasuredNetworkLatency(estimate of {model!r})")


def estimate_p2p_latency(model, nodes, peers, degree, rounds=100, seed=0):
    """`estimate_latency` over each sampled source's direct peers
    (wittgenstein_tpu/core/latency.py:625-645): `peers` [N, D] and
    `degree` [N] from `core/p2p.build_peer_graph`."""
    n = int(nodes.x.shape[0])
    ids = torch.arange(rounds * n, dtype=I32, device=nodes.x.device)
    s = prng.hash2(seed, 0x50325045)
    src = prng.uniform_int(prng.hash2(s, 1), ids, n)
    deg = degree[src.long()].clamp_min(1)
    col = prng.uniform_int(prng.hash2(s, 2), ids, deg)
    dst = peers[src.long(), col.long()]
    delta = prng.uniform_delta(prng.hash2(s, 3), ids)
    keep = (dst >= 0) & (dst != src)
    lat = full_latency(model, nodes, src, dst.clamp_min(0), delta)[keep]
    return _quantile_table(
        lat.cpu().numpy(),
        f"MeasuredNetworkLatency(p2p estimate of {model!r})")
