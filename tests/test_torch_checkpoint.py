"""The port's checkpoints (`wittgenstein_tpu_torch/utils/checkpoint.py`):
the counterparts of tests/test_checkpoint.py, and the file format shared
with the JAX package.

A resumed run equals an uninterrupted one leaf for leaf — through
`Runner`, the dense chunk, the seed-folded engine, the fast-forward
engine and the chaos plane (saved at ms 40, inside an outage and a
partition) — and equals the JAX package's run.  A file written by the
JAX package's `checkpoint.save` loads in the port equal to `convert`'s
state, and a file the port writes loads in the JAX package equal to
its own state (PingPong, a 2-seed Handel batch with uint32 bitsets and
a tuple q_sig, Dfinity's arena, whose ancestor bitset the port rebuilds).
The staleness audit's verdicts equal the JAX package's.
"""

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch.core import batched, network
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.utils import checkpoint

HANDEL_128 = dict(node_count=128, threshold=115, nodes_down=12,
                  network_latency_name="NetworkLatencyByDistanceWJitter")
HANDEL_64 = dict(node_count=64, threshold=50, nodes_down=6, pairing_time=4,
                 network_latency_name="NetworkFixedLatency(16)")
CHAOS = dict(churn=((3, 20, 60), (5, 40, 100)),
             partitions=((30, 90, 1, 0, 32),),
             loss=((0, 120, 250, 0, 64, 0, 64),))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_pingpong():
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    return PingPong(node_count=64, device="cpu")


def _np(state):
    return tp.convert.to_numpy(*state)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint.py:21-52: 500 ms, save, load into a fresh
    state, 500 ms more, through `Runner` in 250-ms calls."""
    from wittgenstein_tpu_torch.models.handel import Handel
    p = Handel(**HANDEL_128, device="cpu")
    r = network.Runner(p)
    state_a = p.init(0)
    for _ in range(4):
        state_a = r.run_ms(*state_a, 250)
    state_b = p.init(0)
    for _ in range(2):
        state_b = r.run_ms(*state_b, 250)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, *state_b, meta={"time": int(state_b[0].time)})
    assert checkpoint.peek_meta(path) == {"time": 500}
    net_c, ps_c, meta = checkpoint.load(path, p, seed=0)
    assert meta["time"] == 500
    state_c = (net_c, ps_c)
    for _ in range(2):
        state_c = r.run_ms(*state_c, 250)
    tp.assert_states_equal(_np(state_a), _np(state_c), "resumed Handel")
    assert int(state_c[0].time) == 1000
    assert float((state_c[0].nodes.done_at[~state_c[0].nodes.down] > 0)
                 .float().mean()) > 0.9


def _roundtrip(proto, run, init, tmp_path, chunks=3):
    """`chunks` chunks straight; one, save at the boundary, restore, the
    rest: the whole states equal.  Returns the straight run's state."""
    state_a = init()
    for i in range(chunks):
        state_a = run(*state_a, i)
    state_b = run(*init(), 0)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, *state_b)
    net_c, ps_c, _ = checkpoint.load(path, proto, seed=0)
    state_c = (net_c, ps_c)
    for i in range(1, chunks):
        state_c = run(*state_c, i)
    tp.assert_states_equal(_np(state_a), _np(state_c), "resumed")
    return state_a


def test_chunk_boundary_roundtrip_dense(tmp_path):
    proto = _port_pingpong()
    run = network.scan_chunk(proto, 40)
    _roundtrip(proto, lambda n, p, i: run(n, p, t=40 * i),
               lambda: proto.init(0), tmp_path)


def test_chunk_boundary_roundtrip_batched(tmp_path):
    from wittgenstein_tpu_torch.models.handel import Handel
    proto = Handel(**HANDEL_64, device="cpu")
    run = batched.scan_chunk_batched(proto, 40, superstep=4)
    _roundtrip(proto, lambda n, p, i: run(n, p, t=40 * i),
               lambda: init_batched(proto, torch.arange(2)), tmp_path)


def test_chunk_boundary_roundtrip_fast_forward(tmp_path):
    proto = _port_pingpong()
    run = network.fast_forward_chunk(proto, 40)
    _roundtrip(proto, lambda n, p, i: run(n, p, t=40 * i)[:2],
               lambda: proto.init(0), tmp_path)


def test_chunk_boundary_roundtrip_chaos(tmp_path):
    """tests/test_checkpoint.py:103-126: the save at ms 40 lands inside
    both fault windows; the resumed run equals the uninterrupted one and
    the JAX package's."""
    import jax

    from wittgenstein_tpu.chaos import ChaosProtocol as JC
    from wittgenstein_tpu.chaos import FaultSchedule as JF
    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu.models.pingpong import PingPong as JP
    from wittgenstein_tpu_torch.chaos import ChaosProtocol, FaultSchedule
    cp = ChaosProtocol(_port_pingpong(), FaultSchedule(**CHAOS))
    run = network.scan_chunk(cp, 40)
    state = _roundtrip(cp, lambda n, p, i: run(n, p, t=40 * i),
                       lambda: cp.init(0), tmp_path)
    jc = JC(JP(node_count=64), JF(**CHAOS))
    jrun = jax.jit(jscan(jc, 40))
    jstate = jc.init(0)
    for _ in range(3):
        jstate = jrun(*jstate)
    tp.assert_port_jax_states(jstate, state, "resumed chaos vs JAX")


def _jax_and_port(name):
    """(JAX protocol, port protocol, JAX state) of a cross-package
    file case: one PingPong run, a 2-seed Handel batch, one Dfinity run
    (each advanced so that its leaves are not the init's)."""
    import jax

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    if name == "pingpong":
        from wittgenstein_tpu.models.pingpong import PingPong as JP
        jp, pp, seeds = JP(node_count=64), _port_pingpong(), None
    elif name == "handel":
        from wittgenstein_tpu.models.handel import Handel as JH
        from wittgenstein_tpu_torch.models.handel import Handel
        jp, pp, seeds = JH(**HANDEL_64), Handel(**HANDEL_64, device="cpu"), 2
    else:
        jp, pp = tp.obs_protocols("Dfinity")
        seeds = None
    run = jscan(jp, 40)
    if seeds:
        state = jax.jit(jax.vmap(run))(*tp.jax_batch(jp, seeds))
    else:
        state = jax.jit(run)(*jp.init(0))
    return jp, pp, state


@pytest.mark.parametrize("name", ["pingpong", "handel", "dfinity"])
def test_files_cross_packages(name, tmp_path):
    from wittgenstein_tpu.utils import checkpoint as jcheckpoint
    jp, pp, jstate = _jax_and_port(name)
    want = tp.jax_state(*jstate)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcheckpoint.save(jpath, *jstate, meta={"by": "jax"})
    net, ps, meta = checkpoint.load(jpath, pp, seed=0)
    assert meta == {"by": "jax"}
    tp.assert_states_equal(want, _np((net, ps)), f"{name}: JAX file")
    ref = tp.convert.from_reference(*want, "cpu")
    tp.assert_states_equal(_np(ref), _np((net, ps)), f"{name}: convert")
    checkpoint.save(ppath, net, ps, meta={"by": "port"})
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype and np.array_equal(
                    a[k], b[k]), (name, k)
    jnet, jps, jmeta = jcheckpoint.load(ppath, jp, seed=0)
    assert jmeta == {"by": "port"}
    tp.assert_states_equal(want, tp.jax_state(jnet, jps),
                           f"{name}: port file in JAX")


def test_uncompressed_files_and_buffers(tmp_path):
    """``compress=False`` writes the same entries stored: `np.load`
    reads them, `load` reads them in place from a file and from an
    in-memory buffer, equal to the state; a flipped byte in an entry
    fails its CRC check."""
    import io

    from wittgenstein_tpu_torch.chaos import ChaosProtocol, FaultSchedule
    cp = ChaosProtocol(_port_pingpong(), FaultSchedule(**CHAOS))
    state = network.scan_chunk(cp, 40, superstep=2)(
        *init_batched(cp, torch.arange(2)), t=0)
    path, buf = str(tmp_path / "stored.npz"), io.BytesIO()
    for dest in (path, buf):
        checkpoint.save(dest, *state, meta={"t": 40}, compress=False)
    with np.load(path) as z:
        leaves = checkpoint.state_leaves(*state)
        assert all(np.array_equal(z[f"leaf_{i}"], x)
                   for i, x in enumerate(leaves))
    for src in (path, buf):
        if src is buf:
            buf.seek(0)
        net, ps, meta = checkpoint.load(src, cp)
        assert meta == {"t": 40}
        tp.assert_states_equal(_np(state), _np((net, ps)), "stored")
    raw = bytearray(buf.getvalue())
    raw[len(raw) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="CRC mismatch"):
        checkpoint.load(io.BytesIO(bytes(raw)), cp)

def test_stale_meta_problems_equal_jax():
    from wittgenstein_tpu.utils import checkpoint as jcheckpoint
    from wittgenstein_tpu_torch.serve import ScenarioSpec
    spec = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                        sim_ms=120, chunk_ms=40)
    good = {"schema": 2, "requests": [
        {"id": "r1", "spec": spec.to_json(), "spec_digest": spec.digest()}]}
    edited = {"schema": 2, "requests": [
        {"id": "r1", "spec": dict(spec.to_json(), sim_ms=240),
         "spec_digest": spec.digest()}]}
    torn = {"schema": 2, "requests": [
        {"id": "r2", "spec": {"protocol": "PingPong", "bogus": 1},
         "spec_digest": "x"}]}
    old = {"schema": 1, "requests": []}
    for meta, n in ((good, 0), (edited, 1), (torn, 1), (old, 1)):
        got = checkpoint.stale_meta_problems(meta)
        assert got == jcheckpoint.stale_meta_problems(meta)
        assert len(got) == n, got


@pytest.mark.cuda
def test_cuda_checkpoint_across_devices():
    """A faulted batch on the card saved uncompressed into memory at 40
    ms inside both windows: loaded on the card it continues equal to the
    uninterrupted run, and loaded on the CPU it equals the card's
    state."""
    import io

    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    from wittgenstein_tpu_torch.chaos import ChaosProtocol, FaultSchedule
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    cp = ChaosProtocol(PingPong(node_count=64, device="cuda"),
                       FaultSchedule(**CHAOS))
    run = network.scan_chunk(cp, 40, superstep=2)
    state = run(*init_batched(cp, torch.arange(2)), t=0)
    buf = io.BytesIO()
    checkpoint.save(buf, *state, meta={"t": 40}, compress=False)
    buf.seek(0)
    net, ps, meta = checkpoint.load(buf, cp, device="cpu")
    assert meta == {"t": 40}
    tp.assert_states_equal(_np(state), _np((net, ps)), "card -> CPU")
    buf.seek(0)
    resumed = checkpoint.load(buf, cp)[:2]
    for t in (40, 80):
        state = run(*state, t=t)
        resumed = run(*resumed, t=t)
    tp.assert_states_equal(_np(state), _np(resumed), "resumed on the card")
