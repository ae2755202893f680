"""Every latency model of the port (`wittgenstein_tpu_torch/core/
latency.py`) against the JAX package's, bit for bit (tolerance 0): the
shipped jitter bits and IC3 table regenerated from the jitted JAX
functions; the whole city-jitter and city tables ([218, 218, 100]) and
the AWS one ([11, 11, 100]) against the jitted JAX models; every model's
`extended`, `full_latency` and `latency_floor_ms` on the cases of
`tests/test_latency.py` (each model on its builder's layout at 16, 64
and 256 nodes, 4,096 sampled pairs); Mathis over every latency in
[1, 4096] ms against a grid of sizes, eager and jitted; the two
estimators' tables; the registry's names and refusals; the CSV model's
round trip and refusals with the JAX texts; and the `Runner`'s
`validate` hook."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp

import jax
import jax.numpy as jnp

from wittgenstein_tpu.core import builders as jbuilders
from wittgenstein_tpu.core import latency as jlat
from wittgenstein_tpu.core import state as jstate
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.state import NodeState, default_nodes

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_nodes(jnodes):
    """The JAX package's NodeState as the port's, on the CPU."""
    return NodeState(**{f.name: torch.tensor(np.asarray(getattr(jnodes,
                                                                 f.name)))
                        for f in dataclasses.fields(jnodes)})


def _eq(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, what
    bad = np.argwhere(want != got)
    assert not len(bad), (f"{what}: {len(bad)} entries differ, first at "
                          f"{tuple(bad[0])}: JAX {want[tuple(bad[0])]}, "
                          f"port {got[tuple(bad[0])]}")


def test_shipped_tables_match_jax():
    """The shipped jitter bits and IC3 table, regenerated from the
    jitted JAX functions, entry for entry."""
    _eq(tp.jax_jitter_bits(), np.load(tlat._JITTER_FILE), "jitter bits")
    _eq(tp.jax_ic3_table(), np.load(tlat._IC3_FILE), "IC3 table")


@pytest.mark.parametrize("name,cities", [
    ("NetworkLatencyByCityWJitter", 218), ("NetworkLatencyByCity", 218),
    ("AwsRegionNetworkLatency", 11)])
def test_city_tables_match_jax(name, cities):
    """`extended` over every (source city, destination city, delta)."""
    c1, c2, d = (x.reshape(-1).astype(np.int32) for x in np.meshgrid(
        np.arange(cities), np.arange(cities), np.arange(100),
        indexing="ij"))
    jn = jstate.default_nodes(cities).replace(
        city=jnp.arange(cities, dtype=jnp.int32))
    tn = default_nodes(cities, CPU).replace(
        city=torch.arange(cities, dtype=torch.int32))
    jm, tm = jlat.get_by_name(name), tlat.get_by_name(name)
    want = jax.jit(jm.extended)(jn, jnp.asarray(c1), jnp.asarray(c2),
                                jnp.asarray(d))
    got = tm.extended(tn, torch.tensor(c1), torch.tensor(c2),
                      torch.tensor(d))
    _eq(want, got.numpy(), name)
    assert jlat.latency_floor_ms(jm) == tlat.latency_floor_ms(tm)


def test_ic3_over_every_distance():
    """IC3's `extended` on node pairs realising every torus distance."""
    jn, src, dst = tp.distance_pairs()
    want = jax.jit(jlat.IC3NetworkLatency().extended)(
        jn, src, dst, jnp.zeros_like(src))
    got = tlat.IC3NetworkLatency().extended(
        _port_nodes(jn), torch.tensor(np.asarray(src)),
        torch.tensor(np.asarray(dst)), torch.zeros(len(src),
                                                   dtype=torch.int32))
    _eq(want, got.numpy(), "IC3")


def _models(tmp_path):
    """(name, builder keyword arguments) of `tests/test_latency.py`'s
    floor models, plus the CSV model on three cities."""
    csv = tmp_path / "m.csv"
    csv.write_text(CSV_OK)
    return [
        ("NetworkNoLatency", {}), ("NetworkFixedLatency(25)", {}),
        ("NetworkUniformLatency(80)", {}),
        ("NetworkHeterogeneousLatency(20,10,6,3)", {}),
        ("NetworkLatencyByDistanceWJitter", {}),
        ("AwsRegionNetworkLatency", {"location": "aws"}),
        ("EthScanNetworkLatency", {}),
        ("NetworkLatencyByCity", {"location": "cities"}),
        ("NetworkLatencyByCityWJitter", {"location": "cities"}),
        ("IC3NetworkLatency", {}),
        (f"NetworkCSVLatency({csv})", {}),
    ]


MODEL_NAMES = ["NetworkNoLatency", "NetworkFixedLatency(25)",
               "NetworkUniformLatency(80)",
               "NetworkHeterogeneousLatency(20,10,6,3)",
               "NetworkLatencyByDistanceWJitter", "AwsRegionNetworkLatency",
               "EthScanNetworkLatency", "NetworkLatencyByCity",
               "NetworkLatencyByCityWJitter", "IC3NetworkLatency",
               "NetworkCSVLatency"]


@pytest.mark.parametrize("which", MODEL_NAMES)
def test_models_match_jax(tmp_path, which):
    """`extended`, `full_latency` (with Tor extra latency on a third of
    the runs) and `latency_floor_ms` of each model on its layout, and
    the floor sound for the port as for JAX."""
    from wittgenstein_tpu.ops import prng as jprng
    name, layout = next(m for m in _models(tmp_path)
                        if m[0].startswith(which))
    jm, tm = jlat.get_by_name(name), tlat.get_by_name(name)
    assert repr(jm) == repr(tm)
    assert jlat.latency_floor_ms(jm) == tlat.latency_floor_ms(tm)
    floor = tlat.latency_floor_ms(tm)
    for n, seed, tor in ((16, 0, 0.0), (64, 1, 0.2), (256, 7, 0.0)):
        jn = jbuilders.NodeBuilder(tor=tor, **layout).build(seed, n)
        if which == "NetworkCSVLatency":
            jn = jn.replace(city=jnp.arange(n, dtype=jnp.int32) % 3)
        tn = _port_nodes(jn)
        ids = jnp.arange(4096, dtype=jnp.int32)
        s = jprng.hash2(jnp.asarray(seed, jnp.int32), jnp.int32(0xF100))
        src = jprng.uniform_int(jprng.hash2(s, 1), ids, n)
        dst = jprng.uniform_int(jprng.hash2(s, 2), ids, n)
        delta = jprng.uniform_delta(jprng.hash2(s, 3), ids)
        targs = [torch.tensor(np.asarray(x)) for x in (src, dst, delta)]
        _eq(jax.jit(jm.extended)(jn, src, dst, delta),
            tm.extended(tn, *targs).numpy(), f"{name} extended n={n}")
        lat = tlat.full_latency(tm, tn, *targs).numpy()
        _eq(jax.jit(lambda *a: jlat.full_latency(jm, *a))(jn, src, dst,
                                                           delta),
            lat, f"{name} full_latency n={n}")
        keep = np.asarray(src != dst)
        assert lat[keep].min() >= floor


def test_mathis_exhaustive():
    """`MathisNetworkThroughput.delay` for every wrapped latency st in
    [1, 4096] ms against 733 message sizes (every 7th below 3,000 and a
    log grid to 10^9), equal to the JAX function op by op and under
    `jax.jit`."""
    st = np.arange(1, 4097, dtype=np.int32)
    sizes = np.unique(np.concatenate([
        np.arange(0, 3000, 7), np.logspace(3, 9, 300).astype(np.int64)]))
    s, z = (x.reshape(-1).astype(np.int32)
            for x in np.meshgrid(st, sizes.astype(np.int32), indexing="ij"))

    class Given:
        """A latency model whose `extended` is the given array."""
        def __init__(self, lat):
            self.lat = lat

        def extended(self, nodes, src, dst, delta):
            return self.lat

    m = len(s)
    zeros, ones = np.zeros(m, np.int32), np.ones(m, np.int32)
    jm = jlat.MathisNetworkThroughput(Given(jnp.asarray(s)))
    jn = jstate.default_nodes(2)
    jargs = [jnp.asarray(x) for x in (zeros, ones, zeros, z)]
    got = tlat.MathisNetworkThroughput(Given(torch.tensor(s))).delay(
        default_nodes(2, CPU), *[torch.tensor(x) for x in
                                 (zeros, ones, zeros, z)]).numpy()
    _eq(jm.delay(jn, *jargs), got, "Mathis op by op")
    _eq(jax.jit(lambda *a: jm.delay(jn, *a))(*jargs), got, "Mathis jitted")
    assert tlat.latency_floor_ms(tlat.MathisNetworkThroughput(
        tlat.NetworkFixedLatency(25))) == 25


def test_estimators_match_jax():
    """`estimate_latency` and `estimate_p2p_latency` tables
    (tests/test_latency.py:171, :188)."""
    from wittgenstein_tpu.core import p2p as jp2p
    jn = jbuilders.NodeBuilder().build(7, 256)
    tn = _port_nodes(jn)
    jm = jlat.NetworkLatencyByDistanceWJitter()
    tm = tlat.NetworkLatencyByDistanceWJitter()
    want = jlat.estimate_latency(jm, jn, rounds=20)
    got = tlat.estimate_latency(tm, tn, rounds=20)
    _eq(want.table, got.table, "estimate_latency")
    assert want.name == got.name
    jn = jbuilders.NodeBuilder().build(7, 128)
    peers, degree, _ = jp2p.build_peer_graph(7, 128, 8, minimum=True)
    want = jlat.estimate_p2p_latency(jm, jn, peers, degree, rounds=20)
    got = tlat.estimate_p2p_latency(
        tm, _port_nodes(jn), torch.tensor(np.asarray(peers)),
        torch.tensor(np.asarray(degree)), rounds=20)
    _eq(want.table, got.table, "estimate_p2p_latency")
    assert tlat.latency_floor_ms(got) == jlat.latency_floor_ms(want)


def _outcome(fn):
    try:
        m = fn()
    except Exception as e:          # noqa: BLE001 (the type is compared)
        return type(e).__name__, str(e)
    return type(m).__name__, repr(m)


def test_registry_matches_jax():
    """Every bare, parametrised and malformed name: the same model (its
    class and repr), or the same exception type and text."""
    names = [None, "", "NetworkNoLatency", "NetworkLatencyByDistanceWJitter",
             "AwsRegionNetworkLatency", "EthScanNetworkLatency",
             "NetworkLatencyByCity", "NetworkLatencyByCityWJitter",
             "IC3NetworkLatency", "NetworkFixedLatency(100)",
             "NetworkUniformLatency(80)", "NetworkHeterogeneousLatency(25)",
             "NetworkHeterogeneousLatency(20,10,6,3)",
             "NetworkHeterogeneousLatency(20,10,6,3,9)",
             "NetworkHeterogeneousLatency(fast)",
             "NetworkHeterogeneousLatency(0,5)", "NetworkMadeUpLatency(3)",
             "NoSuchLatency", "MathisNetworkThroughput", "NetworkFixedLatency",
             "MeasuredNetworkLatency", "gpd_inverse"]
    for name in names:
        assert _outcome(lambda: jlat.get_by_name(name)) == \
            _outcome(lambda: tlat.get_by_name(name)), name
    assert tlat.latency_name("fixed", 100) == jlat.latency_name("fixed", 100)
    assert tlat.latency_name("UNIFORM", 7) == jlat.latency_name("UNIFORM", 7)
    _eq(jlat.build_distribution(jlat.ETHSCAN_PROP, jlat.ETHSCAN_VAL),
        tlat.build_distribution(tlat.ETHSCAN_PROP, tlat.ETHSCAN_VAL),
        "build_distribution")
    with pytest.raises(ValueError, match="sum to 100"):
        tlat.build_distribution([50, 40], [100, 200])


CSV_OK = ("city,Alpha,Beta,Gamma\n"
          "Alpha,10,42,80\n"
          "Beta,44,8,120\n"
          "Gamma,78,118,6\n")

CSV_BAD = {
    "a.csv": "city,Alpha,Beta\nAlpha,10\nBeta,44,8\n",
    "n.csv": "city,Alpha,Beta\nAlpha,10,x\nBeta,44,8\n",
    "g.csv": "city,Alpha,Beta\nAlpha,10,-4\nBeta,44,8\n",
    "o.csv": "city,Alpha,Beta\nBeta,10,4\nAlpha,44,8\n",
    "e.csv": "city,Alpha,Beta\n",
    "d.csv": "city,Alpha,Alpha\nAlpha,1,2\nAlpha,3,4\n",
}


def test_csv_round_trip_and_refusals(tmp_path):
    """tests/test_latency.py:354 and :384: the measured matrix's
    latencies, floor and `validate`, and every refusal with the JAX
    text."""
    path = tmp_path / "m.csv"
    path.write_text(CSV_OK)
    jm = jlat.get_by_name(f"NetworkCSVLatency({path})")
    tm = tlat.get_by_name(f"NetworkCSVLatency({path})")
    assert tm.cities == jm.cities == ("Alpha", "Beta", "Gamma")
    jn = jbuilders.NodeBuilder().build(0, 6).replace(
        city=jnp.asarray([0, 1, 2, 0, 1, 2], jnp.int32))
    tn = _port_nodes(jn)
    src, dst = [0, 1, 3], [1, 0, 5]
    lat = tlat.full_latency(tm, tn, torch.tensor(src), torch.tensor(dst),
                            torch.zeros(3, dtype=torch.int32)).numpy()
    _eq(jlat.full_latency(jm, jn, jnp.asarray(src), jnp.asarray(dst),
                          jnp.zeros(3, jnp.int32)), lat, "CSV latency")
    assert lat.tolist() == [21, 22, 40]
    assert tm.latency_floor_ms() == jm.latency_floor_ms() == 3
    for city in (-1, 7):
        bad = jn.replace(city=jn.city.at[0].set(city))
        assert _outcome(lambda: jm.validate(bad)) == \
            _outcome(lambda: tm.validate(_port_nodes(bad)))
    cases = [str(tmp_path / "nope.csv")]
    for name, text in CSV_BAD.items():
        (tmp_path / name).write_text(text)
        cases.append(str(tmp_path / name))
    for p in cases:
        want = _outcome(lambda: jlat.get_by_name(f"NetworkCSVLatency({p})"))
        assert want[0] == "ValueError"
        assert _outcome(
            lambda: tlat.get_by_name(f"NetworkCSVLatency({p})")) == want


@pytest.mark.parametrize("latency,location", [
    ("NetworkLatencyByCity", "random"), ("AwsRegionNetworkLatency", "random"),
    ("NetworkLatencyByCityWJitter", "cities")])
def test_runner_validate_hook(latency, location):
    """The `Runner`'s first call hands the nodes to the model's
    `validate`, as the JAX `Runner` does: city models refuse nodes
    placed without a city with the JAX text, and accept city nodes."""
    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    kw = dict(node_count=16, network_latency_name=latency)
    jproto = JPingPong(node_builder=jbuilders.NodeBuilder(location=location),
                       **kw)
    from wittgenstein_tpu_torch.core import builders as tbuilders
    proto = PingPong(node_builder=tbuilders.NodeBuilder(location=location),
                     device=CPU, **kw)
    want = _outcome(lambda: JRunner(jproto, donate=False).run_ms(
        *jproto.init(0), 1))
    got = _outcome(lambda: Runner(proto).run_ms(*proto.init(0), 1))
    if location == "random":
        assert want[0] == "ValueError" and got == want
    else:
        assert got[0] == want[0] == "tuple"
