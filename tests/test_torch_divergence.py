"""First-divergence triage in the port (`wittgenstein_tpu_torch/obs/diff`)
and the cross-package bisector (`tests/torch_parity.first_divergence_
cross`): the counterparts of tests/test_divergence.py.

A deliberately injected one-node divergence (`FaultInjector`) must be
localized to the exact (ms, leaf, node) with the decoded flight-recorder
window from both runs, as the JAX bisector localizes it; bit-identical
variant pairs must come back clean.  The cross-package bisector runs the
JAX package and the port side by side from one seed and must find
nothing on a faithful port, and the exact (ms, leaf, index) of a fault
planted in the port.  The port's command line
(`wittgenstein_tpu_torch/cli/divergence.py`, the twin of
`tools/divergence.py`) is held in tests/test_torch_cli.py.
"""

import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch.obs.diff import (VARIANT_KEYS, FaultInjector,
                                             build_variant,
                                             first_divergence,
                                             variant_granularity)
from wittgenstein_tpu_torch.obs.trace import TraceSpec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pingpongs(n=32):
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    return JPingPong(node_count=n), PingPong(node_count=n, device="cpu")


def test_bisector_localizes_injected_one_node_divergence():
    from wittgenstein_tpu.obs import diff as jdiff
    from wittgenstein_tpu.obs.trace import TraceSpec as JTraceSpec
    jp, pp = _pingpongs()
    kw = dict(at_ms=37, leaf="nodes.done_at", node=5, delta=1000)
    div = first_divergence(pp, {"superstep": 1}, {"superstep": 1},
                           total_ms=128, chunk_ms=32,
                           protocol_b=FaultInjector(pp, **kw),
                           trace_spec=TraceSpec(capacity=2048))
    assert div is not None
    assert div.ms == 37 and div.granularity == 1
    assert "done_at" in div.leaf
    assert div.index == (0, 5)          # (run, node)
    assert int(div.value_b) - int(div.value_a) == 1000
    assert div.n_diff_leaves == 1
    lo, hi = div.trace_window
    assert lo <= 37 < hi
    assert div.trace_a.n_events == div.trace_b.n_events > 0
    report = div.format(trace_limit=6)
    assert "ms 37" in report and "done_at" in report
    assert "trace A" in report and "trace B" in report
    # the JAX bisector on the same fault: the same window, element and
    # decoded events
    jdiv = jdiff.first_divergence(jp, {"superstep": 1}, {"superstep": 1},
                                  total_ms=128, chunk_ms=32,
                                  protocol_b=jdiff.FaultInjector(jp, **kw),
                                  trace_spec=JTraceSpec(capacity=2048))
    assert (jdiv.ms, jdiv.index, jdiv.n_diff_leaves, jdiv.trace_window) == \
        (div.ms, div.index, div.n_diff_leaves, div.trace_window)
    assert (int(jdiv.value_a), int(jdiv.value_b)) == \
        (int(div.value_a), int(div.value_b))
    assert (jdiv.trace_a.events == div.trace_a.events).all()
    assert (jdiv.trace_b.events == div.trace_b.events).all()


def test_bisector_clean_on_bit_identical_variants():
    _, pp = _pingpongs()
    assert first_divergence(pp, {"superstep": 1}, {"superstep": 2},
                            total_ms=128, chunk_ms=32,
                            trace_spec=False) is None
    assert first_divergence(pp, {"superstep": 1}, {"fast_forward": True},
                            total_ms=64, chunk_ms=32,
                            trace_spec=False) is None


def test_bisector_fault_in_protocol_state_leaf():
    """A fault in the protocol's own state (Handel's per-node start
    times), found at the coarser variant's K=2 window boundary."""
    _, pp = tp.obs_protocols("Handel")
    bad = FaultInjector(pp, at_ms=10, leaf="start_at", node=3, delta=7)
    div = first_divergence(pp, {"superstep": 2}, {"superstep": 2,
                                                  "batched": True},
                           total_ms=40, chunk_ms=20, protocol_b=bad,
                           trace_spec=False)
    assert div is not None
    assert div.granularity == 2
    assert div.ms == 10
    assert "start_at" in div.leaf and div.index == (0, 3)


def test_variant_helpers():
    _, pp = _pingpongs()
    assert VARIANT_KEYS == ("superstep", "batched", "fast_forward")
    assert variant_granularity({"superstep": 1}) == 1
    assert variant_granularity({"batched": True}) == 2
    assert variant_granularity({"superstep": 4, "batched": True}) == 4
    with pytest.raises(ValueError, match="unknown variant keys"):
        build_variant(pp, 32, {"warp": 9})
    # the port has no kernel switch to pin
    with pytest.raises(ValueError, match="unknown variant keys"):
        build_variant(pp, 32, {"pallas_route": True})


def test_cross_package_bisector_clean_and_localizes_a_port_fault():
    jp, pp = _pingpongs()
    assert tp.first_divergence_cross(jp, pp, 64, chunk_ms=32) is None
    bad = FaultInjector(pp, at_ms=37, leaf="nodes.done_at", node=5,
                        delta=1000)
    got = tp.first_divergence_cross(jp, bad, 64, chunk_ms=32)
    assert got["ms"] == 37
    assert got["leaf"] == "net.nodes.done_at" and got["index"] == (5,)
    assert int(got["port"]) - int(got["jax"]) == 1000
