"""PingPong in the port (`wittgenstein_tpu_torch/models/pingpong.py`) on
its per-ms engine and at superstep K=2, against the JAX package's
PingPong: the full state leaf for leaf every 100 ms to 800 ms, bit for
bit, at 64 and 200 nodes (`torch_parity.check`); determinism per seed;
the superstep gate's self-send cap with the JAX package's text; the
reference's convergence curve at 1000 nodes (slow, as the JAX one is);
and, marked `cuda`, a 200-node run on the card against the CPU run.

JAX is imported inside the tests that compare with it, so the `cuda`
test also runs where JAX is not installed."""

import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import latency as tlat
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.models.pingpong import PingPong


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [64, 200])
def test_pingpong_matches_jax(n, k):
    """Every leaf equal to the JAX package's per-ms run at 100, 200, ...,
    800 ms, on the port's per-ms engine (K=1) and in K=2 windows."""
    assert tp.check(n, 800, "pingpong", 100, k) == 0


def test_pingpong_deterministic_per_seed():
    """tests/test_pingpong.py:37, with the full state of the two runs of
    one seed compared."""
    proto = PingPong(node_count=200, device="cpu")
    runner = network.Runner(proto)
    out = [runner.run_ms(*proto.init(seed), 400) for seed in (0, 0, 1)]
    states = [convert.to_numpy(*s) for s in out]
    tp.assert_states_equal(states[0], states[1], "seed 0 twice")
    pongs = [int(p.pongs) for _, p in out]
    assert pongs[0] > 0
    assert pongs[0] != pongs[2] or pongs[0] > 190


def test_superstep_self_send_cap():
    """tests/test_superstep.py:240: the witness pongs itself (a 1-ms
    self-send), so no latency floor licenses K > 2; the gate refuses
    with the JAX package's text, K=2 stays valid."""
    from wittgenstein_tpu.core import latency as jlat
    from wittgenstein_tpu.core import network as jnetwork
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    jproto = JPingPong(node_count=64, latency=jlat.NetworkFixedLatency(50))
    proto = PingPong(node_count=64, latency=tlat.NetworkFixedLatency(50),
                     device="cpu")
    assert network.unicast_floor_ms(proto) == 1
    texts = []
    for p, mod in ((jproto, jnetwork), (proto, network)):
        with pytest.raises(ValueError, match="may_self_send") as e:
            mod.scan_chunk(p, 40, superstep=4)
        texts.append(str(e.value))
        mod.scan_chunk(p, 40, superstep=2)
    assert texts[0] == texts[1]
    assert network.pick_superstep(proto, 40, t0=0) == 2 == \
        jnetwork.pick_superstep(jproto, 40, t0=0)


@pytest.mark.slow
def test_pingpong_convergence_curve():
    """tests/test_pingpong.py:22 on the port: ~22% of the pongs inside
    100 ms, most inside 300 ms, all 1000 by 800 ms."""
    proto = PingPong(node_count=1000, device="cpu")
    net, p = proto.init(0)
    runner = network.Runner(proto)
    curve = []
    for _ in range(8):
        net, p = runner.run_ms(net, p, 100)
        curve.append(int(p.pongs))
    assert 80 < curve[0] < 400
    assert 500 < curve[2] <= 1000
    assert curve[-1] == 1000
    assert curve == sorted(curve)
    assert int(net.dropped) == int(net.bc_dropped) == int(net.clamped) == 0


@pytest.mark.cuda
def test_cuda_pingpong_matches_cpu():
    """PingPong(200), seed 0, 400 ms on the card (the route kernel bins
    the pongs, once a ms) against the CPU run (its plain version):
    every leaf equal."""
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    from wittgenstein_tpu_torch.ops.route import bin_into_ring
    states = []
    for dev in ("cpu", "cuda"):
        proto = PingPong(node_count=200, device=dev)
        launches = bin_into_ring.launches
        states.append(convert.to_numpy(*network.Runner(proto).run_ms(
            *proto.init(0), 400)))
    assert bin_into_ring.launches - launches == 400
    tp.assert_states_equal(states[0], states[1], "card against CPU")
    assert int(states[1][1]["pongs"]) > 100
