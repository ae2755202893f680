"""P2PHandel and OptimisticP2PSignature in the port
(`wittgenstein_tpu_torch/models/p2phandel.py`, `models/optimistic.py`)
against the JAX package's, bit for bit (tolerance 0): `compressed_size`
on `tests/test_p2psig.py:42`'s cases and on random rows; P2PHandel's four
send strategies, both verification strategies and `send_state` on a
2-seed batch over a short window (K=2), and fast-forwarded (the skip
counts the JAX engine's); OptimisticP2PSignature at 64 nodes until every
node is done; its refusal past 4,096 nodes; and `convert.py`'s round
trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.models.optimistic import (OptimisticP2PSignature,
                                                      cont_if_optimistic)
from wittgenstein_tpu_torch.models.p2phandel import (ALL, CMP_ALL, CMP_DIFF,
                                                     DIF, P2PHandel,
                                                     compressed_size,
                                                     cont_if_p2phandel)

LAT = "NetworkLatencyByDistanceWJitter"
#: tests/test_p2psig.py's small P2PHandel, the 40 + 8 nodes sized so that
#: the window sees verifications, sends and thresholds
SMALL = dict(signing_node_count=40, relaying_node_count=8, threshold=39,
             connection_count=8, pairing_time=10, sigs_send_period=50,
             network_latency_name=LAT)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_p2phandel(**kw):
    from wittgenstein_tpu.models.p2phandel import P2PHandel as J
    return J(**kw)


def test_compressed_size_matches_jax():
    """The bit strings of tests/test_p2psig.py:42 (LSB first), then 256
    random rows of 4 words with runs of full pairs, at two signer
    counts."""
    from wittgenstein_tpu.models.p2phandel import compressed_size as jcs

    def row(bits_str):
        return np.array([[sum(1 << i for i, c in enumerate(bits_str)
                              if c == "1")]], np.uint32)
    for bits_str, n_sign, want in (("11010111", 16, 4), ("11111111", 16, 1),
                                   ("01110111", 16, 4), ("1" * 16, 16, 1)):
        got = compressed_size(torch.tensor(row(bits_str).view(np.int32)),
                              n_sign)
        assert int(got[0]) == want == int(jcs(jnp.asarray(row(bits_str)),
                                              n_sign)[0])
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (256, 4), dtype=np.uint64)
    dense = rng.random((256, 4)) < 0.5
    rows = np.where(dense, words | 0xFFFF0FF0, words).astype(np.uint32)
    rows[:8] = np.uint32(0xFFFFFFFF)
    rows[8:16] = 0
    for n_sign in (100, 128):
        want = np.asarray(jax.jit(jcs, static_argnums=1)(
            jnp.asarray(rows), n_sign))
        got = compressed_size(torch.tensor(rows.view(np.int32)), n_sign)
        assert np.array_equal(want, got.numpy())


def test_proved_superstep_matches_jax():
    from wittgenstein_tpu.core import network as jnetwork
    from wittgenstein_tpu.models.optimistic import \
        OptimisticP2PSignature as JOpt
    proto = P2PHandel(**SMALL, device="cpu")
    assert network.pick_superstep(proto, 200, t0=0) == 2 == \
        jnetwork.pick_superstep(_jax_p2phandel(**SMALL), 200, t0=0)
    opt = dict(node_count=64, threshold=33, connection_count=8,
               network_latency_name=LAT)
    assert network.pick_superstep(
        OptimisticP2PSignature(**opt, device="cpu"), 100, t0=0) == 2 == \
        jnetwork.pick_superstep(JOpt(**opt), 100, t0=0)


@pytest.mark.parametrize("strategy,double_agg,send_state", [
    (DIF, True, False), (ALL, True, True), (CMP_ALL, False, False),
    (CMP_DIFF, False, True)])
def test_strategies_match_jax(strategy, double_agg, send_state):
    """Each send strategy, checkSigs2 (double aggregation) or checkSigs1
    (the queue) and the State messages: two seeds in one batch at K=2,
    every leaf equal at 150 and 300 ms."""
    kw = dict(SMALL, send_sigs_strategy=strategy,
              double_aggregate_strategy=double_agg, send_state=send_state)
    want, _ = tp.jax_batch_run(_jax_p2phandel(**kw), [0, 1], 300, 150)
    got, _ = tp.port_batch_run(P2PHandel(**kw, device="cpu"), [0, 1], 300,
                               150)
    for t in (150, 300):
        tp.assert_batches_equal(want[t], got[t], f"{strategy} at {t} ms")
    assert (got[300][0]["nodes"]["bytes_sent"].sum() > 0 and
            got[300][0]["nodes"]["done_at"].max() > 0)


def test_step_without_hint_matches_hinted():
    """The step with no `step_hint` (every inbox slot walked, the
    verifications and sends run every ms) gives the hinted runs' state
    (held against JAX above): the hint only leaves out identities."""
    kw = dict(SMALL, send_state=True)
    hinted = P2PHandel(**kw, device="cpu")
    plain = P2PHandel(**kw, device="cpu")
    plain.step_hint = None
    want, _ = tp.port_batch_run(hinted, [0, 1], 300, 150)
    got, _ = tp.port_batch_run(plain, [0, 1], 300, 150)
    for t in (150, 300):
        tp.assert_batches_equal(want[t], got[t], f"no hint, at {t} ms")


def test_fast_forward_until_done_matches_jax():
    """Fast-forwarded from init in 100-ms calls until every node of both
    seeds is done: every leaf equal after every call, the skip counts
    the JAX engine's, and cont_if_p2phandel false at the end."""
    want, jstats = tp.jax_batch_run(_jax_p2phandel(**SMALL), [0, 1], 0, 100,
                                    600, 100)
    proto = P2PHandel(**SMALL, device="cpu")
    got, stats = tp.port_batch_run(proto, [0, 1], 0, 100, 600, 100)
    assert stats == jstats and sum(s["skipped_ms"] for s in stats) > 0
    for t in range(100, 601, 100):
        tp.assert_batches_equal(want[t], got[t], f"at {t} ms")
    nets, ps = convert.from_reference(*got[600], "cpu")
    assert not torch.func.vmap(cont_if_p2phandel)(nets, ps).any()


def test_optimistic_matches_jax():
    """tests/test_p2psig.py:16's run at 64 nodes (threshold 33, 13
    peers, pairing 3): two seeds in one batch at K=2 until every node is
    done, every leaf equal after every call; cardinality at least the
    threshold, zero drops and clamps; `done_pred` as JAX's."""
    from wittgenstein_tpu.models.optimistic import \
        OptimisticP2PSignature as JOpt
    kw = dict(node_count=64, threshold=33, connection_count=13,
              pairing_time=3, network_latency_name=LAT)
    want, _ = tp.jax_batch_run(JOpt(**kw), [0, 1], 300, 100)
    proto = OptimisticP2PSignature(**kw, device="cpu")
    got, _ = tp.port_batch_run(proto, [0, 1], 300, 100)
    for t in (100, 200, 300):
        tp.assert_batches_equal(want[t], got[t], f"at {t} ms")
    nets, ps = convert.from_reference(*got[300], "cpu")
    assert not torch.func.vmap(cont_if_optimistic)(nets, ps).any()
    assert torch.func.vmap(proto.done_pred)(ps, nets.nodes).all()
    assert (nets.nodes.done_at > 0).all()
    card = np.unpackbits(got[300][1]["received"].view(np.uint8), axis=-1)
    assert (card.sum(-1) >= 33).all()
    assert int(nets.dropped.sum()) == int(nets.clamped.sum()) == 0
    state = [tp.seed_state(x, 0) for x in got[300]]
    tp.assert_states_equal(state, convert.to_numpy(
        *convert.from_reference(*state, "cpu")), "round trip")


def test_optimistic_refuses_past_4096():
    with pytest.raises(ValueError, match="4096"):
        OptimisticP2PSignature(node_count=4097, device="cpu")
    assert OptimisticP2PSignature(node_count=4096, device="cpu").w == 128
