"""The port's spec layer: `serve/spec.ScenarioSpec`, the parameter gate
of `server/core.py`, `obs/ledger.digest` and `matrix/grid.py` +
`matrix/planner.py`, held to the JAX package's.

Over a set of specs that covers every field (``"auto"`` K, an attack, a
fault schedule, the tenancy trio, every engine and obs plane), the
canonical JSON, `digest()`, `compile_key()` and the resolved spec of
`validate()` equal the JAX package's; so do the refusal texts, the
parameter templates (the port's ``device`` keyword left out),
`from_env`'s capture, and a grid's `grid_digest()`, cells and plan.
"""

import pytest
import torch

from wittgenstein_tpu_torch.matrix import SweepGrid, plan
from wittgenstein_tpu_torch.serve import ScenarioSpec, int_env
from wittgenstein_tpu_torch.server.core import (list_protocols,
                                                protocol_parameters,
                                                validate_parameters)

BASE = dict(protocol="PingPong", params={"node_count": 64}, seeds=(0, 1),
            sim_ms=240, chunk_ms=40)
HANDEL = dict(protocol="Handel",
              params={"node_count": 64, "threshold": 50, "nodes_down": 6,
                      "pairing_time": 4}, seeds=(0,), sim_ms=200,
              chunk_ms=40)

SPECS = {
    "plain": BASE,
    "auto": dict(BASE, superstep="auto"),
    "k2_obs": dict(BASE, superstep=2, obs=("trace", "metrics", "audit"),
                   stat_each_ms=20, trace_capacity=4096),
    "fast_forward": dict(BASE, engine="fast_forward", obs=()),
    "attack": dict(BASE, attack={"at_ms": 30, "leaf": "pongs", "node": 0,
                                 "delta": 2}),
    "partition": dict(BASE, partition=(7, 3)),
    "latency": dict(BASE, latency_model="NetworkFixedLatency(10)"),
    "route_kernel": dict(BASE, route_kernel="pallas"),
    "schedule": dict(BASE, fault_schedule={
        "churn": [[3, 20, 60]], "partitions": [[30, 90, 1, 0, 32]],
        "loss": [[0, 120, 250, 0, 64, 0, 64]],
        "delay": [[10, 50, 3, 0, 64, 0, 64]]}),
    "schedule_auto": dict(BASE, superstep="auto",
                          fault_schedule={"churn": [[3, 21, 60]]}),
    "tenancy": dict(BASE, tenant="campaign", priority=3, deadline_ms=5000),
    "batched": dict(HANDEL, engine="batched", superstep="auto"),
    "handel_ff": dict(HANDEL, engine="fast_forward", superstep=2,
                      obs=("metrics",), stat_each_ms=20),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jspec():
    import wittgenstein_tpu.models  # noqa: F401 — fills the registry
    from wittgenstein_tpu.serve.spec import ScenarioSpec as JSpec
    return JSpec


def test_protocol_templates_equal_jax():
    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.server import core as jcore
    assert list_protocols() == jcore.list_protocols()
    for name in list_protocols():
        port, ref = protocol_parameters(name), jcore.protocol_parameters(name)
        assert port == ref and list(port) == list(ref), name
    for name, params in (("PingPong", {"node_count": 8, "bogus": 1}),
                         ("PingPong", {"device": "cpu"}),
                         ("NoSuch", {})):
        with pytest.raises(ValueError) as port:
            validate_parameters(name, params)
        with pytest.raises(ValueError) as ref:
            jcore.validate_parameters(name, params)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_forms_equal_jax(name):
    kw = SPECS[name]
    spec, ref = ScenarioSpec(**kw), _jspec()(**kw)
    assert spec.to_json() == ref.to_json()
    assert spec.canonical_json() == ref.canonical_json()
    assert spec.digest() == ref.digest()
    assert spec.compile_key() == ref.compile_key()
    assert ScenarioSpec.from_json(spec.canonical_json()) == spec
    resolved, jresolved = spec.validate(), ref.validate()
    assert resolved.canonical_json() == jresolved.canonical_json()
    assert resolved.compile_key() == jresolved.compile_key()


REFUSED = {
    "engine": dict(BASE, engine="warp"),
    "seeds": dict(BASE, seeds=()),
    "dup": dict(BASE, seeds=(1, 1)),
    "span": dict(BASE, sim_ms=250),
    "attack_keys": dict(BASE, attack={"at_ms": 3, "leaf": "pongs"}),
    "attack_node": dict(BASE, attack={"at_ms": 3, "leaf": "pongs",
                                      "node": 99}),
    "attack_ms": dict(BASE, attack={"at_ms": 300, "leaf": "pongs",
                                    "node": 1}),
    "partition": dict(BASE, partition=(64,)),
    "batched_k1": dict(HANDEL, engine="batched", superstep=1),
    "stat": dict(BASE, stat_each_ms=30),
    "stat_k": dict(BASE, superstep=2, stat_each_ms=5, chunk_ms=40),
    "trace_cap": dict(BASE, obs=("trace",), trace_capacity=100),
    "latency": dict(BASE, latency_model="NoSuchLatency"),
    "latency_twice": dict(BASE, latency_model="NetworkFixedLatency(5)",
                          params={"node_count": 64,
                                  "network_latency_name": "x"}),
    "params": dict(BASE, params={"node_count": 64, "witness_count": 2}),
    "overlap": dict(BASE, fault_schedule={
        "partitions": [[10, 50, 1, 0, 32], [20, 60, 2, 16, 48]]}),
    "churn_owns": dict(BASE, partition=(3,),
                       fault_schedule={"churn": [[3, 100, 120]]}),
    "misaligned": dict(BASE, superstep=2,
                       fault_schedule={"churn": [[3, 21, 60]]}),
    "superstep": dict(BASE, superstep="fast"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_validate_refusals_equal_jax(name):
    kw = REFUSED[name]
    with pytest.raises(ValueError) as port:
        ScenarioSpec(**kw).validate()
    with pytest.raises(ValueError) as ref:
        _jspec()(**kw).validate()
    assert str(port.value) == str(ref.value)


def test_construction_refusals_equal_jax():
    cases = (dict(BASE, obs=("metric",)), dict(BASE, route_kernel="cuda"),
             dict(BASE, tenant=""), dict(BASE, priority=True),
             dict(BASE, deadline_ms=0), dict(BASE, fault_schedule={"z": []}))
    for kw in cases:
        with pytest.raises(ValueError) as port:
            ScenarioSpec(**kw)
        with pytest.raises(ValueError) as ref:
            _jspec()(**kw)
        assert str(port.value) == str(ref.value)
    for data in ('{"params": {}}', '{"protocol": "PingPong", "x": 1}', "[]"):
        with pytest.raises(ValueError) as port:
            ScenarioSpec.from_json(data)
        with pytest.raises(ValueError) as ref:
            _jspec().from_json(data)
        assert str(port.value) == str(ref.value)


ENVS = [
    {},
    {"WTPU_BENCH_PROTO": "pingpong", "WTPU_BENCH_NODES": "256",
     "WTPU_SUPERSTEP": "auto", "WTPU_TRACE": "1", "WTPU_AUDIT": "0"},
    {"WTPU_BENCH_MODE": "cardinal", "WTPU_BENCH_QUEUE": "16",
     "WTPU_BENCH_POOL": "1", "WTPU_PALLAS_ROUTE": "1",
     "WTPU_FAST_FORWARD": "1",
     "WTPU_CHAOS": '{"loss": [[0, 9, 5, 0, 8, 0, 8]]}'},
    {"WTPU_BENCH_PROTO": "p2pflood", "WTPU_BENCH_LATENCY":
     "NetworkFixedLatency(10)", "WTPU_BENCH_MS": "900",
     "WTPU_BENCH_CHUNK": "200", "WTPU_BENCH_SEEDS": "bad"},
    {"WTPU_BENCH_PROTO": "dfinity", "WTPU_LATENCY": "NetworkFixedLatency(7)",
     "WTPU_BENCH_BATCHED": "0", "WTPU_METRICS_EACH_MS": "20"},
]


@pytest.mark.parametrize("i", range(len(ENVS)))
def test_from_env_equal_jax(i):
    spec, ref = ScenarioSpec.from_env(ENVS[i]), _jspec().from_env(ENVS[i])
    assert spec.canonical_json() == ref.canonical_json()
    assert spec.digest() == ref.digest()


def test_int_env():
    from wittgenstein_tpu.serve.spec import int_env as jint_env
    for env in ({}, {"N": "12"}, {"N": "x"}, {"N": "-3"}):
        assert int_env("N", 7, env=env) == jint_env("N", 7, env=env)


def _grid(cls, base):
    return cls(name="g", base=base, axes=(
        {"name": "N", "field": "params.node_count", "values": [32, 64]},
        {"name": "chaos", "field": "fault_schedule",
         "values": [None, {"loss": [[120, 240, 400, 0, 32, 0, 32]]}],
         "labels": ["clean", "adverse"]},
        {"name": "ek", "values": [{"engine": "vmapped", "superstep": 1},
                                  {"engine": "fast_forward",
                                   "superstep": 2}],
         "labels": ["dense", "ff"]}),
        exclude=({"N": "64", "ek": "ff"},))


def test_grid_and_plan_equal_jax():
    from wittgenstein_tpu.matrix import SweepGrid as JGrid
    from wittgenstein_tpu.matrix import plan as jplan
    base = dict(BASE, seeds=[0], obs=["metrics"])
    grid, ref = _grid(SweepGrid, base), _grid(JGrid, base)
    assert grid.canonical_json() == ref.canonical_json()
    assert grid.grid_digest() == ref.grid_digest()
    cells, jcells = grid.expand(), ref.expand()
    assert [c.id for c in cells] == [c.id for c in jcells]
    assert [c.spec.digest() for c in cells] == \
        [c.spec.digest() for c in jcells]
    assert [grid.twin_id(c.labels) for c in cells] == \
        [ref.twin_id(c.labels) for c in jcells]
    mplan, jmplan = plan(grid), jplan(ref)
    assert mplan.summary() == jmplan.summary()
    assert [(g.compile_key, [c.id for c in g.cells], g.builds)
            for g in mplan.groups] == \
        [(g.compile_key, [c.id for c in g.cells], g.builds)
         for g in jmplan.groups]
    assert SweepGrid.from_json(grid.canonical_json()).grid_digest() == \
        grid.grid_digest()
    with pytest.raises(ValueError) as port:
        SweepGrid(base=base, axes=({"name": "x", "values": [{"a": 1}]},))
    with pytest.raises(ValueError) as jref:
        JGrid(base=base, axes=({"name": "x", "values": [{"a": 1}]},))
    assert str(port.value) == str(jref.value)


def test_ledger_digest_equal_jax():
    from wittgenstein_tpu.obs.ledger import digest as jdigest
    from wittgenstein_tpu_torch.obs.ledger import digest
    for obj in ({"b": 1, "a": [1, 2, {"z": None}]}, [1.5, "x"], {"s": {1}}):
        assert digest(obj) == jdigest(obj)
