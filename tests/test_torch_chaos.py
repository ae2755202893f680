"""The port's chaos plane (`wittgenstein_tpu_torch/chaos`): the
counterparts of tests/test_chaos.py, held to the JAX package.

Every run compares at tolerance 0 with the JAX package on the CPU: the
schedule's refusals word for word; the per-step key's two threefry words
against ``jax.random.fold_in(jax.random.PRNGKey(s), t)``; the canonical
schedule through the dense per-ms engine, the superstep-K window engine,
the fast-forward engine and the seed-folded engine (and its fast-forward
twin), each equal to the JAX run leaf for leaf; total loss, exact delay
inflation; zero residue (an empty schedule equals the unwrapped protocol
and issues the same PyTorch ops a simulated ms, as does every protocol
without `apply_faults`); the `ScenarioSpec` carriage and `from_env`; and
`bench_torch.py --chaos`.  The obs planes under chaos are in
tests/test_torch_chaos_planes.py; the sharded twin waits for the port's
multi-device engine (ROADMAP.md A15).  The `cuda` test holds the faulted
headline engine on the card against the CPU.
"""

import json

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch.chaos import ChaosProtocol, FaultSchedule
from wittgenstein_tpu_torch.core import batched, network
from wittgenstein_tpu_torch.models.handel import Handel
from wittgenstein_tpu_torch.models.pingpong import PingPong
from wittgenstein_tpu_torch.ops import prng

#: tests/test_chaos.py:48-52's canonical adversity: two outages, one
#: partition that heals, lossy links, a delay window (transitions even)
SCHED = dict(churn=((3, 20, 60), (5, 40, 100)),
             partitions=((30, 90, 1, 0, 32),),
             loss=((0, 120, 250, 0, 64, 0, 64),),
             delay=((10, 50, 3, 0, 64, 0, 64),))

#: tests/test_chaos.py:122-124's batched schedule and Handel
BATCH_SCHED = dict(churn=((3, 20, 60), (9, 40, 104)),
                   partitions=((40, 80, 1, 0, 32),),
                   loss=((0, 120, 200, 0, 64, 0, 64),))
BATCH_HANDEL = dict(node_count=64, threshold=50, nodes_down=6,
                    pairing_time=4,
                    network_latency_name="NetworkFixedLatency(16)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jchaos():
    from wittgenstein_tpu import chaos
    return chaos


def _pair(inner_kw, sched, cls="pingpong"):
    """(JAX ChaosProtocol, port ChaosProtocol on the CPU)."""
    jc = _jchaos()
    if cls == "pingpong":
        from wittgenstein_tpu.models.pingpong import PingPong as JP
        jin, pin = JP(**inner_kw), PingPong(**inner_kw, device="cpu")
    else:
        from wittgenstein_tpu.models.handel import Handel as JH
        jin, pin = JH(**inner_kw), Handel(**inner_kw, device="cpu")
    return (jc.ChaosProtocol(jin, jc.FaultSchedule(**sched)),
            ChaosProtocol(pin, FaultSchedule(**sched)))


# ----------------------------------------------------------- validation

REFUSALS = [
    ("window", lambda F: F(churn=((3, 60, 20),)).validate()),
    ("range", lambda F: F(churn=((99, 0, 10),)).validate(n=64)),
    ("overlap", lambda F: F(churn=((3, 0, 50), (3, 40, 80))).validate()),
    ("partitions", lambda F: F(partitions=((10, 50, 1, 0, 32),
                                           (20, 60, 2, 16, 48))).validate()),
    ("reserved", lambda F: F(partitions=((10, 50, 0, 0, 32),)).validate()),
    ("permille", lambda F: F(loss=((0, 10, 2000, 0, 8, 0, 8),)).validate()),
    ("delay", lambda F: F(delay=((0, 10, -1, 0, 8, 0, 8),)).validate()),
    ("link", lambda F: F(loss=((0, 10, 5, 0, 80, 0, 8),)).validate(n=64)),
    ("never", lambda F: F(**SCHED).validate(n=64, sim_ms=10)),
    ("unknown", lambda F: F.from_json({"churns": [[1, 0, 10]]})),
    ("arity", lambda F: F.from_json({"churn": [[1, 0]]})),
    ("row", lambda F: F.from_json({"churn": [5]})),
    ("class", lambda F: F.from_json({"churn": 5})),
    ("ints", lambda F: F.from_json({"churn": [["a", 0, 1]]})),
    ("object", lambda F: F.from_json("[1, 2]")),
]


@pytest.mark.parametrize("case", [c[0] for c in REFUSALS])
def test_schedule_refusals_equal_jax(case):
    make = dict(REFUSALS)[case]
    with pytest.raises(ValueError) as port:
        make(FaultSchedule)
    with pytest.raises(ValueError) as ref:
        make(_jchaos().FaultSchedule)
    assert str(port.value) == str(ref.value)
    assert str(port.value).startswith("FaultSchedule: ")


def test_schedule_roundtrip_and_alignment():
    sched, jsched = FaultSchedule(**SCHED), _jchaos().FaultSchedule(**SCHED)
    assert FaultSchedule.from_json(sched.to_json()) == sched
    assert sched.to_json() == jsched.to_json()
    assert sched.transition_times() == (20, 30, 40, 60, 90, 100)
    assert sched.superstep_aligned(2) and not sched.superstep_aligned(4)
    assert sched.align_gcd() == 10
    assert sched.counts() == jsched.counts()
    assert sched.mutates_state and not FaultSchedule(
        loss=SCHED["loss"]).mutates_state
    assert FaultSchedule().empty and FaultSchedule().superstep_aligned(8)
    FaultSchedule(partitions=((10, 50, 1, 0, 32), (10, 50, 2, 32, 64),
                              (50, 60, 3, 0, 64))).validate(n=64)


def test_step_key_words_equal_jax():
    """`prng.fold_in_key` is ``jax.random.fold_in(PRNGKey(s), t)`` word
    for word, for sampled seeds up to 2**31 - 1 and t up to 65,535, on a
    scalar seed and on a batch's [R] seeds; `_key_seed` folds it as the
    JAX wrapper does."""
    import jax

    from wittgenstein_tpu.chaos.wrap import _key_seed as jkey_seed
    from wittgenstein_tpu_torch.chaos.wrap import _key_seed
    rng = np.random.default_rng(14)
    seeds = np.concatenate([[0, 1, 2 ** 31 - 1],
                            rng.integers(0, 2 ** 31, 40)]).astype(np.int32)
    ts = np.concatenate([[0, 1, 65535], rng.integers(0, 65536, 40)])
    for s, t in zip(seeds, ts):
        jkey = jax.random.fold_in(jax.random.PRNGKey(s), int(t))
        key = prng.fold_in_key(torch.tensor(s), int(t))
        np.testing.assert_array_equal(np.asarray(jkey).astype(np.int64),
                                      key.numpy())
        assert int(_key_seed(key)) == int(jkey_seed(jkey))
    batch = prng.fold_in_key(torch.from_numpy(seeds), 777)
    want = np.stack([np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(s), 777)) for s in seeds]).astype(np.int64)
    np.testing.assert_array_equal(batch.numpy(), want)


def test_superstep_gate_and_demotion():
    from wittgenstein_tpu.core.network import \
        check_chunk_config as jcheck
    jc, cp = _pair(dict(node_count=64), dict(churn=((3, 21, 60),)))
    with pytest.raises(ValueError, match="window boundary") as port:
        network.check_chunk_config(cp, 120, superstep=2)
    with pytest.raises(ValueError) as ref:
        jcheck(jc, 120, superstep=2)
    assert str(port.value) == str(ref.value)
    assert not network.superstep_ok(cp, 2)
    assert network.pick_superstep(cp, 120, t0=0) == 1
    cp2 = ChaosProtocol(PingPong(node_count=64, device="cpu"),
                        FaultSchedule(churn=((3, 20, 60),)))
    assert network.pick_superstep(cp2, 120, t0=0) == 2
    with pytest.raises(ValueError, match="window boundary"):
        batched.scan_chunk_batched(cp, 120, superstep=2)


# ----------------------------------------------------- engine identity


def test_dense_superstep_ff_equal_jax():
    import jax

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    jc, cp = _pair(dict(node_count=64), SCHED)
    ref = jax.jit(jscan(jc, 120))(*jc.init(0))
    for k in (1, 2):
        tp.assert_port_jax_states(
            ref, network.scan_chunk(cp, 120, superstep=k)(*cp.init(0)),
            f"K={k}")
    net, ps, stats = network.fast_forward_chunk(cp, 120)(*cp.init(0))
    tp.assert_port_jax_states(ref, (net, ps), "fast-forward")
    assert stats["skipped_ms"] > 0
    # a seed batch through the same engines
    jref = jax.jit(jax.vmap(jscan(jc, 120)))(*tp.jax_batch(jc, 2))
    tp.assert_port_jax_states(
        jref, network.scan_chunk(cp, 120, superstep=2)(*tp.port_batch(cp, 2)),
        "batch K=2")
    nets, ps, _ = network.fast_forward_chunk(cp, 120, seed_axis=True,
                                             superstep=2)(
        *tp.port_batch(cp, 2))
    tp.assert_port_jax_states(jref, (nets, ps), "batch fast-forward")


def test_batched_engine_equal_jax():
    """tests/test_chaos.py:117-131: the seed-folded engine at K=4 equals
    ``jax.vmap(scan_chunk(cp, 120, superstep=4))``; so do the port's
    vmapped engine and the seed-folded fast-forward engine."""
    import jax

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    jc, cp = _pair(BATCH_HANDEL, BATCH_SCHED, "handel")
    ref = jax.jit(jax.vmap(jscan(jc, 120, superstep=4)))(
        *tp.jax_batch(jc, 3))
    tp.assert_port_jax_states(ref, batched.scan_chunk_batched(
        cp, 120, superstep=4)(*tp.port_batch(cp, 3)), "seed-folded")
    tp.assert_port_jax_states(ref, network.scan_chunk(
        cp, 120, superstep=4)(*tp.port_batch(cp, 3)), "vmapped")
    nets, ps, _ = batched.fast_forward_chunk_batched(cp, 120, superstep=4)(
        *tp.port_batch(cp, 3))
    tp.assert_port_jax_states(ref, (nets, ps), "seed-folded fast-forward")


def test_empty_schedule_zero_residue_and_ops(monkeypatch):
    """An empty schedule is bit-identical to the unwrapped protocol, and
    neither it nor any protocol without `apply_faults` issues an extra
    PyTorch op a simulated ms: PingPong and Handel count what they
    counted before the chaos plane (tests/test_torch_obs.py's pin)."""
    import chip_smoke
    from test_torch_obs import OPS_PIN
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name in ("PingPong", "Handel"):
        _, inner = tp.obs_protocols(name)
        cp = ChaosProtocol(inner, FaultSchedule())
        tp.assert_states_equal(
            tp.convert.to_numpy(*network.scan_chunk(inner, 120)(
                *inner.init(0))),
            tp.convert.to_numpy(*network.scan_chunk(cp, 120)(*cp.init(0))),
            f"{name} empty schedule")
        for k in (1, 2):
            for proto in (inner, cp):
                net, ps = network.scan_chunk(proto, 20)(*proto.init(0), t=0)
                window = network.scan_chunk(proto, 2, superstep=k)
                assert chip_smoke.ops_per_ms(
                    lambda: window(net, ps, t=20), 2) == OPS_PIN[name, k], \
                    (name, k, type(proto).__name__)


# ------------------------------------------------------------ adversary


def test_total_loss_blocks_unicasts():
    cp = ChaosProtocol(PingPong(node_count=64, device="cpu"), FaultSchedule(
        loss=((0, 120, 1000, 0, 64, 0, 64),)))
    base = PingPong(node_count=64, device="cpu")
    net, ps = network.scan_chunk(cp, 120)(*cp.init(0))
    net0, ps0 = network.scan_chunk(base, 120)(*base.init(0))
    assert int(ps.pongs) == 0 and int(ps0.pongs) > 0
    assert int(net.nodes.msg_received.sum()) < \
        int(net0.nodes.msg_received.sum())


def test_delay_inflation_shifts_arrivals_exactly():
    from wittgenstein_tpu_torch import obs
    from wittgenstein_tpu_torch.core.latency import NetworkFixedLatency
    base = PingPong(node_count=8, latency=NetworkFixedLatency(5),
                    device="cpu")
    cp = ChaosProtocol(base, FaultSchedule(delay=((0, 200, 7, 0, 8, 0, 8),)))
    spec = obs.TraceSpec(capacity=2048, events=("send", "deliver"))

    def first_pong_ms(proto):
        tc = obs.scan_chunk_trace(proto, 60, spec)(*proto.init(0))[2]
        fr = obs.TraceFrame.from_carry(spec, tc).filter(kinds=("deliver",))
        t = fr.column("time_ms")[fr.column("src") != 0]
        assert t.size > 0
        return int(t.min())

    assert first_pong_ms(cp) == first_pong_ms(base) + 7


# ---------------------------------------------------------- serve plane


def test_scenario_spec_fault_schedule():
    from wittgenstein_tpu_torch.serve import ScenarioSpec

    base = dict(protocol="PingPong", params={"node_count": 64},
                seeds=(0,), sim_ms=120, chunk_ms=60)
    plain = ScenarioSpec(**base)
    spec = ScenarioSpec(**base, fault_schedule=FaultSchedule(
        **SCHED).to_json())
    assert spec.digest() != plain.digest()
    assert spec.compile_key() != plain.compile_key()
    noisy = dict(spec.fault_schedule)
    noisy["delay"] = list(noisy["delay"])
    assert ScenarioSpec(**base, fault_schedule=noisy).digest() == \
        spec.digest()
    assert ScenarioSpec(**base, fault_schedule={}).digest() == \
        plain.digest()
    assert ScenarioSpec.from_json(spec.canonical_json()) == spec
    resolved = spec.validate()
    assert isinstance(resolved.superstep, int)
    proto = resolved.build_protocol(device="cpu")
    assert isinstance(proto, ChaosProtocol)
    for bad, pat in (
            (dict(fault_schedule={"partitions": [[10, 50, 1, 0, 32],
                                                 [20, 60, 2, 16, 48]]}),
             "ONE partition at a time"),
            (dict(fault_schedule={"churn": [[999, 0, 10]]}), "out of range"),
            (dict(fault_schedule={"churn": [[3, 500, 600]]}), "never fire"),
            (dict(partition=(3,), fault_schedule={"churn": [[3, 100, 120]]}),
             "churn owns"),
            (dict(superstep=2, fault_schedule={"churn": [[3, 21, 60]]}),
             "window boundary")):
        with pytest.raises(ValueError, match=pat):
            ScenarioSpec(**base, **bad).validate()
    with pytest.raises(ValueError, match="unknown fault class"):
        ScenarioSpec(**base, fault_schedule={"zaps": []})
    auto = ScenarioSpec(**base, superstep="auto", fault_schedule={
        "churn": [[3, 21, 60]]}).validate()
    assert auto.superstep == 1


def test_from_env_captures_chaos():
    from wittgenstein_tpu.serve.spec import ScenarioSpec as JSpec
    from wittgenstein_tpu_torch.serve.spec import ScenarioSpec

    env = {"WTPU_BENCH_PROTO": "pingpong", "WTPU_BENCH_NODES": "64",
           "WTPU_CHAOS": '{"churn": [[3, 20, 60]]}'}
    spec = ScenarioSpec.from_env(env)
    assert spec.fault_schedule == {"churn": [[3, 20, 60]]}
    assert spec.digest() == JSpec.from_env(env).digest()
    assert ScenarioSpec.from_env(
        dict(env, WTPU_CHAOS="{broken")).fault_schedule is None
    assert ScenarioSpec.from_env(
        dict(env, WTPU_CHAOS="{}")).fault_schedule is None


# ------------------------------------------------------------ bench line


def test_bench_chaos_block(capsys):
    """`bench_torch.py --chaos` adds the JAX package's ``chaos`` block
    keys (bench.py:300-305), and refuses a malformed or out-of-range
    schedule before the run with a non-zero exit."""
    import bench_torch
    sched = json.dumps({"churn": [[3, 20, 60]],
                        "loss": [[0, 100, 300, 0, 32, 0, 32]]})
    args = ["--proto", "pingpong", "--device", "cpu", "--nodes", "32",
            "--seeds", "1", "--ms", "200", "--reps", "1", "--no-metrics",
            "--no-audit"]
    assert bench_torch.main(args + ["--chaos", sched]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    blk = line["chaos"]
    assert set(blk) == {"schedule", "transitions", "audit", "faulted",
                        "baseline"}
    assert blk["schedule"] == {"churn": 1, "partitions": 0, "loss": 1,
                               "delay": 0}
    assert blk["transitions"] == 2 and blk["audit"]["clean"]
    assert set(blk["faulted"]) == {"done_count", "live_count", "msg_sent",
                                   "msg_received"}
    assert blk["faulted"] != blk["baseline"]
    for bad in ("{broken", '{"churn": [[99, 0, 10]]}',
                '{"churn": [[3, 500, 600]]}'):
        with pytest.raises(SystemExit) as e:
            bench_torch.main(args + ["--chaos", bad])
        assert e.value.code != 0
    assert "FaultSchedule" in capsys.readouterr().err


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_cuda_chaos_headline_matches_cpu():
    """The faulted seed-folded engine on the card (K1, K2 and K3 under
    churn, partition, loss and delay) equals the CPU run, 2 seeds of a
    256-node reference-default Handel to 100 ms."""
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    from wittgenstein_tpu_torch.models.handel import reference_default_params
    out = {}
    for d in ("cpu", "cuda"):
        proto = Handel(**reference_default_params(256), device=d)
        nets, ps = tp.port_batch(proto, 2)
        sched = tp.chaos_headline_schedule(nets.nodes.down.cpu().numpy(),
                                           256, churn=8)
        cp = ChaosProtocol(proto, FaultSchedule.from_json(sched))
        nets, ps = batched.scan_chunk_batched(cp, 100, t0_mod=0)(
            *tp.port_batch(cp, 2), t=0)
        out[d] = tp.convert.seed_digests(*tp.convert.to_numpy(nets, ps))
    assert out["cpu"] == out["cuda"]
