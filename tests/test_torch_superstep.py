"""The superstep engine of the port (`core/network.step_kms`, K=2, with
and without phase hints) against the JAX package, full state leaf for
leaf every 100 ms to 400 ms, for the reference-default Handel at 64 and
256 nodes; and the superstep gate (`check_chunk_config`,
`pick_superstep`) on `tests/test_superstep.py`'s Handel cases, each
refusal with the JAX package's own text.

The JAX reference is `Runner(superstep=2)`: the JAX package holds its
superstep, phase-specialized and per-ms engines bit-equal to one another
(tests/test_superstep.py, tests/test_phase_hints.py), so the port's
phase-hinted chunk is held against the same states."""

import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu.core import network as jnetwork
from wittgenstein_tpu.models.handel import Handel as JHandel
from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.models.handel import (Handel,
                                                  reference_default_params)

CHECKPOINTS = (100, 200, 300, 400)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[64, 256])
def reference(request):
    """(n, {ms: JAX state}) of `Runner(superstep=2)` from seed 1."""
    n = request.param
    jproto = JHandel(**reference_default_params(n))
    runner = jnetwork.Runner(jproto, superstep=2)
    state = jproto.init(1)
    ref = {}
    for t in CHECKPOINTS:
        state = runner.run_ms(*state, 100)
        ref[t] = tp.jax_state(*state)
    return n, ref


def _check_run(reference, advance):
    n, ref = reference
    proto = Handel(**reference_default_params(n), device="cpu")
    net, ps = proto.init(1)
    for t in CHECKPOINTS:
        net, ps = advance(proto, net, ps)
        tp.assert_states_equal(ref[t], convert.to_numpy(net, ps),
                               f"n={n} at {t} ms")
    assert int(ps.sigs_checked.sum()) > 0


def test_scan_chunk_superstep_phase_hints_match_jax(reference):
    """`scan_chunk(superstep=2, t0_mod=0)`: 2-ms windows with Handel's
    phase hints (verification every 4th ms, dissemination every 20th)."""
    runs = {}

    def advance(proto, net, ps):
        run = runs.setdefault(id(proto), network.scan_chunk(
            proto, 100, t0_mod=0, superstep=2))
        return run(net, ps)
    _check_run(reference, advance)


def test_runner_superstep_matches_jax(reference):
    def advance(proto, net, ps):
        return network.Runner(proto, superstep=2).run_ms(net, ps, 100)
    _check_run(reference, advance)


def _floor_protos(**kw):
    """Handel on a floor-rich model (fixed 16 ms), in both packages:
    floor + 1 = 17 licenses every K in {1, 2, 4, 8, 16}."""
    params = dict(node_count=64, threshold=56, nodes_down=6,
                  pairing_time=4, dissemination_period_ms=20,
                  level_wait_time=50, fast_path=10, horizon=64,
                  network_latency_name="NetworkFixedLatency(16)")
    params.update(kw)
    return JHandel(**params), Handel(**params, device="cpu")


def _same_refusal(protos, match, *args, **kw):
    """scan_chunk(*args, **kw) refused by both packages, in one text."""
    texts = []
    for proto, mod in zip(protos, (jnetwork, network)):
        with pytest.raises(ValueError, match=match) as e:
            mod.scan_chunk(proto, *args, **kw)
        texts.append(str(e.value))
    assert texts[0] == texts[1]


def _both_admit(protos, *args, **kw):
    jnetwork.scan_chunk(protos[0], *args, **kw)
    network.scan_chunk(protos[1], *args, **kw)


def test_superstep_rejects_bad_configs():
    import dataclasses
    kw = dict(node_count=64, threshold=60, nodes_down=0)
    protos = (JHandel(**kw), Handel(**kw, device="cpu"))
    _same_refusal(protos, "even chunk", 41, superstep=2)
    _same_refusal(protos, "even entry", 40, t0_mod=1, superstep=2)
    for p in protos:
        p.cfg = dataclasses.replace(p.cfg, spill_cap=8)
    _same_refusal(protos, "spill_cap", 40, superstep=2)


def test_superstep_k_gate_floor_and_alignment():
    kw = dict(node_count=64, threshold=56, nodes_down=6)
    protos = (JHandel(**kw, horizon=64), Handel(**kw, horizon=64,
                                                device="cpu"))
    assert network.unicast_floor_ms(protos[1]) == 2
    _same_refusal(protos, "latency_floor_ms", 40, superstep=8)
    _both_admit((JHandel(**kw, horizon=66),
                 Handel(**kw, horizon=66, device="cpu")), 42, superstep=3)
    floor16 = _floor_protos()
    _same_refusal(floor16, "multiple-of-4 chunk", 42, superstep=4)
    _same_refusal(floor16, "entry time", 40, t0_mod=2, superstep=4)
    _same_refusal(_floor_protos(horizon=96), "divide the horizon", 40,
                  superstep=5)


def test_superstep_k_gate_t0_mod_gcd():
    """K=8 does not divide the schedule lcm 20: t0_mod=2 admits no
    K-aligned entry and is refused, t0_mod=4 admits t=24."""
    protos = _floor_protos()
    assert protos[1].schedule_lcm == 20
    _same_refusal(protos, "gcd", 80, t0_mod=2, superstep=8)
    _both_admit(protos, 80, t0_mod=4, superstep=8)


@pytest.mark.parametrize("call", [
    dict(ms=80, t0=0), dict(ms=40, t0=0), dict(ms=40, t0=0, max_k=4),
    dict(ms=40, t0=4), dict(ms=40, t0=1), dict(ms=40, t0=None),
    dict(ms=40, t0=0, also_divides=10), dict(ms=40, t0=0, lcm=20),
    dict(ms=20, t0=0, lcm=20), dict(ms=80, t0=24, lcm=20),
    dict(ms=80, t0=20, lcm=20)])
def test_pick_superstep(call):
    """The demoting half of the gate, on tests/test_superstep.py's
    cases (floor 16, horizon 64), equal to the JAX package's pick."""
    jproto, proto = _floor_protos()
    want = jnetwork.pick_superstep(jproto, **call)
    assert network.pick_superstep(proto, **call) == want


def test_pick_superstep_distance_floor():
    """The default distance model floors at 2, so K <= 3; horizon 66
    admits both 2 and 3."""
    kw = dict(node_count=64, threshold=56, nodes_down=6, horizon=66)
    proto = Handel(**kw, device="cpu")
    assert network.pick_superstep(proto, 40, t0=0) == 2
    assert network.pick_superstep(proto, 42, t0=0) == 3
    assert jnetwork.pick_superstep(JHandel(**kw), 42, t0=0) == 3


def test_phase_hints_and_schedule_match_jax():
    jproto, proto = _floor_protos()
    assert proto.schedule_lcm == jproto.schedule_lcm
    assert proto.may_self_send is False
    for tmod in range(proto.schedule_lcm):
        assert proto.phase_hints(tmod) == jproto.phase_hints(tmod)
    kw = dict(node_count=64, desynchronized_start=5)
    assert Handel(**kw, device="cpu").schedule_lcm is None
    assert JHandel(**kw).schedule_lcm is None


def test_step_2ms_equals_two_step_ms():
    """One K=2 window with hints against two per-ms steps."""
    proto = Handel(**reference_default_params(64), device="cpu")
    a = proto.init(2)
    a = network.Runner(proto).run_ms(*a, 40)
    b = convert.from_reference(*convert.to_numpy(*a), "cpu")
    hints = [proto.phase_hints(t % 20) for t in (40, 41)]
    a = network.step_2ms(proto, *a, hints2=hints)
    for t in (40, 41):
        b = network.step_ms(proto, *b, t, hints=proto.phase_hints(t % 20))
    tp.assert_states_equal(convert.to_numpy(*a), convert.to_numpy(*b),
                           "step_2ms")
