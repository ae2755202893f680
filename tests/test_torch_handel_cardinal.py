"""Cardinal-mode Handel (the O(N*L)-state variant,
`wittgenstein_tpu_torch/models/handel_cardinal.py`) against the JAX
package's `HandelCardinal`, full state leaf for leaf, bit for bit: on the
per-ms engine to convergence, under both attacks, on the seed-folded
engine at superstep K=2 with phase hints (vmap's per-seed fallback an
error), through the fast-forward engine, and at the tier-3 line's
parameters (`tier3_params`) cut to 64 nodes.  The cases of
tests/test_handel_cardinal.py and the HandelCardinal case of
tests/test_fast_forward.py, at 64 nodes with one intra-op thread."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_parity as tp
from test_torch_batched import no_vmap_fallback

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core.batched import scan_chunk_batched
from wittgenstein_tpu_torch.core.network import (Runner, fast_forward_chunk,
                                                 fast_forward_ok)
from wittgenstein_tpu_torch.core.protocol import PROTOCOLS
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.models.handel import Handel, tier3_params
from wittgenstein_tpu_torch.models.handel_cardinal import HandelCardinal
from wittgenstein_tpu_torch.ops import bitset

ATTACK = dict(node_count=64, threshold=56, nodes_down=8, pairing_time=3,
              level_wait_time=20, dissemination_period_ms=10,
              network_latency_name="NetworkFixedLatency(20)")


def _params(n=64, down=6, **kw):
    """tests/test_handel_cardinal.py's `_cardinal` parameters."""
    return dict(node_count=n, nodes_down=down,
                threshold=int(0.99 * (n - down)), pairing_time=4,
                dissemination_period_ms=20, fast_path=10, mode="cardinal",
                **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_checkpoints(params, seed, checkpoints):
    """The JAX package's state at each checkpoint of one per-ms run."""
    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu.models.handel import Handel as JHandel
    jproto = JHandel(**params)
    runner = JRunner(jproto, donate=False)
    state, t, out = jproto.init(seed), 0, {}
    for cp in checkpoints:
        state = runner.run_ms(*state, cp - t)
        t = cp
        out[cp] = tp.jax_state(*state)
    return out


def _port_checkpoints(params, seed, checkpoints, ref):
    proto = Handel(**params, device="cpu")
    runner = Runner(proto)
    state, t = proto.init(seed), 0
    for cp in checkpoints:
        state = runner.run_ms(*state, cp - t)
        t = cp
        tp.assert_states_equal(ref[cp], convert.to_numpy(*state),
                               f"{params} at {cp} ms")
    return proto, state


def test_mode_dispatch_and_registry():
    p = Handel(node_count=256, nodes_down=25, threshold=229, mode="cardinal",
               device="cpu")
    assert isinstance(p, HandelCardinal)
    assert not isinstance(p, Handel)
    assert isinstance(Handel(node_count=256, device="cpu"), Handel)
    assert PROTOCOLS["HandelCardinal"] is HandelCardinal
    with pytest.raises(ValueError, match="unknown Handel mode"):
        Handel(node_count=256, mode="nope", device="cpu")
    with pytest.raises(TypeError):
        # exact-only scale switches are not cardinal parameters
        Handel(node_count=256, mode="cardinal", emission_mode="hashed",
               device="cpu")
    with pytest.raises(ValueError, match="blacklist"):
        HandelCardinal(node_count=1 << 18, nodes_down=100,
                       byzantine_suicide=True, device="cpu")


def test_cardinal_converges_equal_to_jax():
    """Every leaf equal at 200 and 700 ms, every live node done by then,
    per-level bests within their level sizes, done nodes at the
    threshold (tests/test_handel_cardinal.py:49-63)."""
    params = _params()
    cps = (200, 700)
    proto, (net, ps) = _port_checkpoints(params, 0, cps,
                                         _jax_checkpoints(params, 0, cps))
    done_at, down = net.nodes.done_at.numpy(), net.nodes.down.numpy()
    assert (done_at[~down] > 0).all()
    assert int(net.dropped) == 0 and int(net.clamped) == 0
    lvl_best = ps.lvl_best.numpy()
    assert (lvl_best <= proto.half[None, :]).all() and (lvl_best >= 0).all()
    total = 1 + lvl_best.sum(axis=1)
    assert (total[~down & (done_at > 0)] >= proto.threshold).all()
    assert int(ps.sigs_checked.sum()) > 0
    assert ps.blacklist.shape == (1, 1) and ps.byz_seen.shape == (1, 1)


def test_cardinal_determinism():
    proto = Handel(**_params(), device="cpu")
    runner = Runner(proto)

    def run(seed):
        return convert.flatten(dict(zip(("net", "pstate"), convert.to_numpy(
            *runner.run_ms(*proto.init(seed), 120)))))

    a, b, c = run(5), run(5), run(6)
    assert convert.first_difference(a, b) is None
    assert convert.first_difference(a, c) is not None


@pytest.mark.parametrize("attack", ["byzantine_suicide", "hidden_byzantine"])
def test_cardinal_attacks_equal_to_jax(attack):
    """Both attacks (tests/test_handel_cardinal.py:80-140) at 64 nodes,
    every leaf equal at 200 ms, with the attack seen in the state: the
    suicide plants blacklist their senders, the hidden ones raise the
    byz_seen rank floors."""
    params = dict(ATTACK, mode="cardinal", **{attack: True})
    _, (net, ps) = _port_checkpoints(params, 0, (200,),
                                     _jax_checkpoints(params, 0, (200,)))
    assert (net.nodes.done_at[~net.nodes.down] > 0).float().mean() > 0.5
    if attack == "byzantine_suicide":
        assert int(bitset.popcount(ps.blacklist).sum()) > 0
    else:
        assert int((ps.byz_seen >= 0).sum()) > 0


@pytest.mark.parametrize("line", ["cardinal", "tier3"])
def test_cardinal_batched_equal_to_jax(line):
    """The seed-folded engine, K=2 with phase hints, 2 seeds, against the
    JAX package's without them (tests/test_batched.py::
    test_batched_matches_vmapped_cardinal; the JAX hinted engine is
    bit-equal to it and takes far longer to compile here, and the
    tier-3 golden holds the hinted one at full size on the card);
    `tier3` is the tier-3 line's parameters at 64 nodes with ring
    sub-planes (box_split 2)."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import scan_chunk_batched as jscb
    from wittgenstein_tpu.models.handel import Handel as JHandel
    params = _params() if line == "cardinal" else tier3_params(64)
    jproto, proto = JHandel(**params), Handel(**params, device="cpu")
    if line == "tier3":
        for p in (jproto, proto):
            p.cfg = dataclasses.replace(p.cfg, box_split=2)
    nets, ps = jax.vmap(jproto.init)(jnp.arange(2, dtype=jnp.int32))
    ref = tp.jax_state(*jax.jit(jscb(jproto, 60, superstep=2))(nets, ps))
    with no_vmap_fallback():
        got = scan_chunk_batched(proto, 60, t0_mod=0)(
            *init_batched(proto, torch.arange(2)))
    tp.assert_states_equal(ref, convert.to_numpy(*got), line)
    assert isinstance(got[0].box_count, tuple) == (line == "tier3")


def test_cardinal_fast_forward_equal_to_jax():
    """tests/test_fast_forward.py's HandelCardinal case: the port's
    fast-forward chunk on 2 seeds equal to the JAX package's dense
    vmapped chunk at 320 ms, with ms skipped."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu.models.handel import Handel as JHandel
    params = _params()
    jproto, proto = JHandel(**params), Handel(**params, device="cpu")
    assert fast_forward_ok(proto)
    nets, ps = jax.vmap(jproto.init)(jnp.arange(2, dtype=jnp.int32))
    ref = tp.jax_state(*jax.jit(jax.vmap(jscan(jproto, 320)))(nets, ps))
    with no_vmap_fallback():
        net, ps, stats = fast_forward_chunk(proto, 320, seed_axis=True)(
            *init_batched(proto, torch.arange(2)))
    tp.assert_states_equal(ref, convert.to_numpy(net, ps), "fast-forward")
    assert stats["skipped_ms"] > 0


def test_cardinal_state_roundtrip_through_convert():
    proto = Handel(**dict(ATTACK, mode="cardinal", hidden_byzantine=True),
                   device="cpu")
    state = Runner(proto).run_ms(*proto.init(2), 60)
    once = convert.to_numpy(*state)
    twice = convert.to_numpy(*convert.from_reference(*once, "cpu"))
    tp.assert_states_equal(once, twice, "roundtrip")
    assert once[1]["blacklist"].dtype == np.uint32
    assert convert.state_class(once[1]).__name__ == "HandelCardinalState"
