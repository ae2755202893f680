"""Broadcasts and the spill buffer in the port's engine
(`wittgenstein_tpu_torch/core/network.py`) against the JAX package's: the
port twins of `tests/test_engine.py`'s broadcast, clamp and spill tests
and of `tests/test_pallas_route.py`'s spill tests, each with the JAX
test's own numbers and the full state equal to the JAX run's, bit for
bit; a spill drain whose parked messages cross ``arrival - t == H - 2``
in the same ms as fresh sends to the same cells; and the
`NetworkUniformLatency` table against the jitted JAX function.

The probes are the JAX tests' own (`OneShot`, `Broadcaster`), each with
a port twin below that makes the same sends."""

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import builders, network
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core.state import (EngineConfig, empty_outbox,
                                               init_net)

I32 = torch.int32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class OneShot:
    """Port twin of tests/test_engine.py's probe: node 0 sends one
    unicast to `dest` at t = 0 (with `all_send`, every node i to i + 1);
    every node records the messages it sees and when it first saw
    one.  tests/test_pallas_route.py's copy sends payload 0, not 42."""

    def __init__(self, n=4, latency=None, dest=1, size=7, cfg=None,
                 delay=0, all_send=False, payload=42):
        self.latency = latency or tlat.NetworkFixedLatency(10)
        self.cfg = cfg or EngineConfig(n=n, horizon=64, inbox_cap=4,
                                       payload_words=2, out_deg=1,
                                       bcast_slots=2)
        self.dest, self.size, self.delay = dest, size, delay
        self.all_send, self.payload = all_send, payload

    def init(self, seed):
        n = self.cfg.n
        nodes = builders.NodeBuilder().build(
            torch.tensor(seed, dtype=I32), n, "cpu")
        return init_net(self.cfg, nodes, seed), {
            "got": torch.zeros(n, dtype=I32),
            "when": torch.full((n,), -1, dtype=I32)}

    def record(self, pstate, inbox, t):
        got = inbox.valid.sum(1, dtype=I32)
        return {"got": pstate["got"] + got,
                "when": torch.where((got > 0) & (pstate["when"] < 0), t,
                                    pstate["when"])}

    def step(self, pstate, nodes, inbox, t):
        n, f = self.cfg.n, self.cfg.payload_words
        ids = torch.arange(n, dtype=I32)
        sender = torch.ones(n, dtype=torch.bool) if self.all_send else \
            ids == 0
        dest = (ids + 1) % n if self.all_send else torch.full_like(
            ids, self.dest)
        out = empty_outbox(self.cfg, "cpu").replace(
            dest=torch.where(sender & (t == 0), dest, -1)[:, None],
            payload=torch.where(sender[:, None, None], self.payload, 0).to(
                I32).expand(n, 1, f),
            size=torch.full((n, 1), self.size, dtype=I32),
            delay=torch.full((n, 1), self.delay, dtype=I32))
        return self.record(pstate, inbox, t), nodes, out


class Broadcaster(OneShot):
    """Port twin of tests/test_engine.py's `Broadcaster`: node 0 sends
    all at t = 0, 3 bytes a copy."""

    def step(self, pstate, nodes, inbox, t):
        n = self.cfg.n
        out = empty_outbox(self.cfg, "cpu").replace(
            bcast=(torch.arange(n) == 0) & (t == 0),
            bcast_size=torch.full((n,), 3, dtype=I32))
        return self.record(pstate, inbox, t), nodes, out


def _jax_probe(name, latency, kind="engine", **kw):
    """The JAX tests' probe `name` with the JAX twin of `latency`."""
    import test_engine
    import test_pallas_route
    from wittgenstein_tpu.core import latency as jlat
    from wittgenstein_tpu.core.state import EngineConfig as JConfig
    if "cfg" in kw:
        kw["cfg"] = JConfig(**vars(kw["cfg"]))
    jl = jlat.get_by_name(repr(latency))
    if kind == "route":
        return getattr(test_pallas_route, name)(jl, **kw)
    return getattr(test_engine, name)(latency=jl, **kw)


def _run_both(proto, ms, seed=0, kind="engine", kernel=None):
    """The probe through the JAX package's `Runner` (the route kernel
    forced to `kernel` when given, as tests/test_pallas_route.py runs
    it) and through the port's: the full states equal.  Returns the
    port's."""
    import contextlib

    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu.ops.pallas_route import forced
    kw = dict(cfg=proto.cfg, delay=proto.delay, all_send=proto.all_send)
    if kind == "engine":
        kw.update(n=proto.cfg.n, dest=proto.dest, size=proto.size)
    jproto = _jax_probe(type(proto).__name__, proto.latency, kind, **kw)
    with forced(kernel) if kernel else contextlib.nullcontext():
        jnet, jp = JRunner(jproto, donate=False).run_ms(
            *jproto.init(seed), ms)
        ref = tp.jax_state(jnet, jp)
    net, p = network.Runner(proto).run_ms(*proto.init(seed), ms)
    tp.assert_states_equal(ref, convert.to_numpy(net, p),
                           f"{type(proto).__name__} seed {seed}")
    return net, p


def test_broadcast_reaches_everyone_once():
    """tests/test_engine.py:123."""
    proto = Broadcaster(n=8, latency=tlat.NetworkUniformLatency(30))
    net, p = _run_both(proto, 40)
    assert p["got"].tolist() == [1] * 8
    # sendAll counts n attempted sends, its own node included
    assert int(net.nodes.msg_sent[0]) == 8
    assert int(net.nodes.bytes_sent[0]) == 24
    assert int(p["when"].min()) >= 2 and int(p["when"].max()) <= 33
    assert int(net.bc_dropped) == 0 and int(net.clamped) == 0


def test_broadcast_latencies_are_stable_recomputation():
    """tests/test_engine.py:135: same seed, same arrival times; another
    seed, others."""
    proto = Broadcaster(n=16, latency=tlat.NetworkUniformLatency(200))
    _, p1 = _run_both(proto, 250, seed=5)
    _, p2 = network.Runner(proto).run_ms(*proto.init(5), 250)
    _, p3 = _run_both(proto, 250, seed=9)
    assert torch.equal(p1["when"], p2["when"])
    assert not torch.equal(p1["when"], p3["when"])


def test_far_future_clamps_without_spill():
    """tests/test_engine.py:164: delay 500 past horizon 64 with no spill
    buffer is clamped to the ring's edge and counted."""
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), delay=500)
    net, p = _run_both(proto, 80)
    assert int(net.clamped) == 1
    assert int(p["when"][1]) == 63          # t0 send -> 1 + (horizon-2)


SPILL8 = EngineConfig(n=4, horizon=64, inbox_cap=4, payload_words=2,
                      out_deg=1, bcast_slots=2, spill_cap=8)
SPILL2 = EngineConfig(n=4, horizon=64, inbox_cap=4, payload_words=2,
                      out_deg=1, bcast_slots=2, spill_cap=2)


def _check_exact_delivery(net, p):
    assert int(p["when"][1]) == 511         # send t=0 + 1 + delay 500 + 10
    assert int(p["got"][1]) == 1 and int(p["got"].sum()) == 1
    assert int(net.clamped) == 0 and int(net.sp_dropped) == 0
    assert int(net.dropped) == 0
    assert int((net.sp_arrival >= 0).sum()) == 0    # slot freed


def _check_overflow(net, p):
    assert int(net.sp_dropped) == 2         # 4 far sends, 2 spill slots
    assert int(p["got"].sum()) == 2         # the parked ones delivered
    assert int((net.sp_arrival >= 0).sum()) == 0
    # the two lowest-index senders parked (stable free-slot order)
    assert p["got"].tolist() == [0, 1, 1, 0]


def test_spill_delivers_far_future_arrivals_exactly():
    """tests/test_engine.py:173."""
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), cfg=SPILL8,
                    delay=500)
    _check_exact_delivery(*_run_both(proto, 520))


def test_spill_overflow_counts():
    """tests/test_engine.py:189."""
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), cfg=SPILL2,
                    delay=500, all_send=True)
    _check_overflow(*_run_both(proto, 520))


ROUTE_KERNELS = pytest.mark.parametrize("kernel", ["xla", "pallas"])


@ROUTE_KERNELS
def test_spill_park_unpark_exact_delivery(kernel):
    """tests/test_pallas_route.py:331, the JAX side on both of its
    binning paths (the Pallas one in interpret mode)."""
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), cfg=SPILL8,
                    delay=500, payload=0)
    _check_exact_delivery(*_run_both(proto, 520, kind="route",
                                     kernel=kernel))


@ROUTE_KERNELS
def test_spill_overflow_drop_ordering(kernel):
    """tests/test_pallas_route.py:349."""
    proto = OneShot(latency=tlat.NetworkFixedLatency(10), cfg=SPILL2,
                    delay=500, all_send=True, payload=0)
    _check_overflow(*_run_both(proto, 520, kind="route", kernel=kernel))


DELAYS = [60, 60, 50, 53]


class Crossing(OneShot):
    """At t = 0 every node i sends to node i % 2, each with its own
    delay: arrivals at rel 62 = H - 2 (nodes 0 and 1, self-sends at
    1 ms), 61 (node 2) and 64 (node 3, parked): the cells the drained
    entries land in."""

    def step(self, pstate, nodes, inbox, t):
        pstate, nodes, out = super().step(pstate, nodes, inbox, t)
        n = self.cfg.n
        # rel = 1 + delay + latency (1 to itself, 10 elsewhere)
        delay = torch.tensor(DELAYS, dtype=I32)[:, None]
        return pstate, nodes, out.replace(
            dest=torch.where(torch.tensor(t == 0), torch.arange(
                n, dtype=I32) % 2, -1)[:, None],
            delay=delay)


def test_drain_crossing_the_ring_edge_with_fresh_sends():
    """A hand-built spill table whose entries sit at arrival - t = H - 3,
    H - 2 (drained this ms, one of them clamped from the past), H - 1
    and H + 5 (left parked) for destinations 0 and 1, then one ms in
    which fresh sends land on the same (row, dest) cells: the drained
    entries take their slots first, in spill-slot order, each cell
    grouped by (row, dest) as the JAX package's `_bin_into_ring` groups
    by (rel, dest).  The state after the ms and after the run equals the
    JAX package's, from the same state."""
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu.core.network import step_ms as jstep_ms
    cfg = EngineConfig(n=4, horizon=64, inbox_cap=4, payload_words=2,
                       out_deg=1, bcast_slots=2, spill_cap=8)
    proto = Crossing(latency=tlat.NetworkFixedLatency(10), cfg=cfg)
    jproto = _jax_probe("OneShot", proto.latency, cfg=cfg, n=4)
    jproto.step = _jax_crossing_step(jproto)

    hz, t = cfg.horizon, 0
    rel = np.array([hz - 2, hz - 3, hz - 1, hz - 2, -5, hz + 5, hz - 2, -1])
    table = dict(sp_arrival=np.where(rel >= 0, t + rel, 0).astype(np.int32),
                 sp_src=np.arange(8, dtype=np.int32) % 4,
                 sp_dest=np.array([0, 1, 0, 1, 0, 1, 0, 0], np.int32),
                 sp_size=np.arange(8, dtype=np.int32) + 20,
                 sp_payload=np.arange(16, dtype=np.int32).reshape(8, 2))
    table["sp_arrival"][7] = -1         # a free slot
    table["sp_arrival"][4] = 0          # already past: drains at t + 1
    jnet, jp = jproto.init(0)
    jnet = jnet.replace(**{k: jnp.asarray(v) for k, v in table.items()})
    net, p = convert.from_reference(*tp.jax_state(jnet, jp), "cpu")
    jnet, jp = jstep_ms(jproto, jnet, jp)
    net, p = network.step_ms(proto, net, p)
    tp.assert_states_equal(tp.jax_state(jnet, jp), convert.to_numpy(net, p),
                           "after the crossing ms")
    row = (t + hz - 2) % hz
    # cell (H-2, dest 0): spill slots 0 and 6, then the fresh send of
    # node 0 (self-send at latency 1 + delay 61 = 62)
    assert net.box_count[row, 0].item() == 3
    assert net.box_src[row, 0, :3].tolist() == [0, 2, 0]
    assert net.box_count[row, 1].item() == 2    # slot 3, then node 1's
    assert net.box_src[row, 1, :2].tolist() == [3, 1]
    assert net.box_count[1, 0].item() == 1      # the clamped entry
    assert (net.sp_arrival >= 0).sum().item() == 3   # H-1, H+5, node 3
    jnet, jp = JRunner(jproto, donate=False).run_ms(jnet, jp, 80)
    net, p = network.Runner(proto).run_ms(net, p, 80)
    tp.assert_states_equal(tp.jax_state(jnet, jp), convert.to_numpy(net, p),
                           "after the run")
    assert int(p["got"].sum()) == 11 and int(net.dropped) == 0


def _jax_crossing_step(jproto):
    """`Crossing.step` for the JAX probe."""
    import jax.numpy as jnp
    base = jproto.step

    def step(pstate, nodes, inbox, t, key):
        pstate, nodes, out = base(pstate, nodes, inbox, t, key)
        n = jproto.cfg.n
        return pstate, nodes, out.replace(
            dest=jnp.where(t == 0, jnp.arange(n, dtype=jnp.int32) % 2,
                           -1)[:, None],
            delay=jnp.asarray(DELAYS, jnp.int32)[:, None])
    return step


@pytest.mark.parametrize("max_latency", [30, 200, 1, 7, 99, 227, 1000,
                                         65536])
def test_uniform_latency_table_matches_jitted_jax(max_latency):
    """`NetworkUniformLatency` for every delta in 0..99 against the JAX
    function compiled with `jax.jit`, as the engine runs it (eager JAX
    differs for 7 and 227 among these)."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.latency import NetworkUniformLatency as J
    jm = J(max_latency)
    delta = jnp.arange(100, dtype=jnp.int32)
    want = np.asarray(jax.jit(lambda d: jm.extended(None, None, None, d))(
        delta))
    tm = tlat.get_by_name(f"NetworkUniformLatency({max_latency})")
    got = tm.extended(None, None, None, torch.arange(100, dtype=I32))
    assert np.array_equal(want, got.numpy())
    assert repr(tm) == repr(jm)
    assert tlat.latency_floor_ms(tm) == 1
