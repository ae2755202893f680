"""Instrumented engine chunk builders — the metrics-ON twins of
`core/network.scan_chunk` / `fast_forward_chunk` and of the seed-folded
pair in `core/batched`; the port of `wittgenstein_tpu/obs/engine.py`.

Each builder returns the uninstrumented engine's result tuple with a
`MetricsCarry` appended; the simulation is the SAME functions
(`step_kms`, the oracle, the jump), and the recorder only reads the
state between windows, which is what the bit-identity tests in
tests/test_torch_obs.py pin.  One engine serves one run and a seed
batch (`core/network.py`), so the batched builders are the dense ones
on a batch, behind the batched engine's own checks.

The uninstrumented builders never import this module: metrics-OFF runs
exactly the operations it ran before (tests/test_torch_obs.py pins the
op count of a window).
"""

from __future__ import annotations

from ..core.network import (check_chunk_config, fast_forward_chunk,
                            fast_forward_ok, step_kms, step_ms,
                            superstep_ok)
from .plane import init_metrics, record_jump, record_step
from .spec import MetricsSpec


def step_ms_metrics(protocol, spec: MetricsSpec, net, pstate, mc, t0: int,
                    t: int | None = None):
    """One instrumented millisecond: `step_ms` then the interval
    recorder, in a chunk entered at `t0` (`t`: the current time, read
    from the device when omitted).  The building block of the dense
    builders below."""
    if t is None:
        t = int(net.time.reshape(-1)[0])
    net, pstate = step_ms(protocol, net, pstate, t=t)
    return net, pstate, record_step(spec, mc, net, t0, t + 1)


def _check_superstep_interval(spec: MetricsSpec, superstep: int):
    """K-window recording samples at window boundaries, so a window must
    never straddle a `stat_each_ms` row
    (wittgenstein_tpu/obs/engine.py:40-51)."""
    if superstep > 1 and spec.stat_each_ms % superstep:
        raise ValueError(
            f"the superstep={superstep} engine advances in fused "
            f"{superstep}-ms windows, so stat_each_ms must be a multiple "
            f"of it (got {spec.stat_each_ms}) — a straddling interval "
            "would sample mid-window state the fused step never "
            "materializes. Fix: pick stat_each_ms divisible by the "
            "superstep, or a smaller superstep")


class _Recorder:
    """The metrics plane as `network.fast_forward_chunk`'s observer:
    each window is `step_kms` followed by one recording of its K ms,
    each jump lands in its origin interval."""

    def __init__(self, protocol, spec: MetricsSpec, mc, t0: int):
        self.protocol, self.spec, self.mc, self.t0 = protocol, spec, mc, t0

    def window(self, net, pstate, k: int, t: int):
        net, pstate = step_kms(self.protocol, net, pstate, k, t=t)
        self.mc = record_step(self.spec, self.mc, net, self.t0, t + k,
                              n_steps=k)
        return net, pstate

    def jump(self, t: int, dt: int):
        self.mc = record_jump(self.spec, self.mc, self.t0, t, dt)


def scan_chunk_metrics(protocol, ms: int, spec: MetricsSpec,
                       superstep: int = 1):
    """Returns ``run(net, pstate, t=None) -> (net, pstate,
    MetricsCarry)`` advancing `ms` milliseconds with the recorder beside
    the state — the instrumented twin of ``scan_chunk(protocol, ms,
    superstep=K)`` (wittgenstein_tpu/obs/engine.py:54-82), for one run
    or a seed batch.  K-window bodies record once per window with
    ``n_steps=K``; `stat_each_ms` must be a multiple of K."""
    check_chunk_config(protocol, ms, superstep=superstep)
    _check_superstep_interval(spec, superstep)
    k = superstep

    def run(net, pstate, t=None):
        t = int(net.time.reshape(-1)[0]) if t is None else t
        rec = _Recorder(protocol, spec, init_metrics(spec, ms, net.time), t)
        for _ in range(ms // k):
            net, pstate = rec.window(net, pstate, k, t)
            t += k
        return net, pstate, rec.mc

    return run


def fast_forward_chunk_metrics(protocol, ms: int, spec: MetricsSpec,
                               seed_axis: bool = False,
                               superstep: int = 1):
    """Instrumented twin of `fast_forward_chunk`
    (wittgenstein_tpu/obs/engine.py:85-150): returns ``run(net, pstate,
    t=None) -> (net, pstate, stats, MetricsCarry)``.  Jumps land in the
    `ff_skipped_ms`/`ff_jumps` columns of their origin interval;
    intervals wholly inside a quiet window keep ``samples == 0`` (the
    host forward-fills them).  ``seed_axis=True`` takes a seed batch:
    per-seed recorders (series ``[R, T, K]``), lockstep rows."""
    check_chunk_config(protocol, ms, superstep=superstep,
                       fast_forward=True)
    _check_superstep_interval(spec, superstep)

    def run(net, pstate, t=None):
        t = int(net.time.reshape(-1)[0]) if t is None else t
        rec = _Recorder(protocol, spec, init_metrics(spec, ms, net.time), t)
        net, pstate, stats = fast_forward_chunk(
            protocol, ms, seed_axis=seed_axis, superstep=superstep,
            observer=rec)(net, pstate, t)
        return net, pstate, stats, rec.mc

    return run


def _check_batched(protocol, ms: int, spec: MetricsSpec,
                   superstep: int = 2):
    """wittgenstein_tpu/obs/engine.py:153-163."""
    if (superstep < 2 or ms % superstep or protocol.cfg.spill_cap
            or protocol.cfg.bcast_slots
            or not superstep_ok(protocol, superstep)):
        raise ValueError("the batched metrics builders need a chunk that "
                         f"is a multiple of superstep={superstep} (>= 2) "
                         "and a spill-free, broadcast-free, superstep-"
                         "eligible protocol (core/batched.py scope)")
    _check_superstep_interval(spec, superstep)


def scan_chunk_batched_metrics(protocol, ms: int, spec: MetricsSpec,
                               superstep: int = 2):
    """Instrumented twin of `scan_chunk_batched`
    (wittgenstein_tpu/obs/engine.py:166-193): per-seed recorders over
    the seed-folded engine, one recording per K-ms window."""
    _check_batched(protocol, ms, spec, superstep)
    return scan_chunk_metrics(protocol, ms, spec, superstep=superstep)


def fast_forward_chunk_batched_metrics(protocol, ms: int,
                                       spec: MetricsSpec,
                                       superstep: int = 2):
    """Instrumented twin of `fast_forward_chunk_batched` (batch-minimum
    oracle, K-aligned jumps; wittgenstein_tpu/obs/engine.py:196-239):
    returns ``run(net, pstate, t=None) -> (net, pstate, stats,
    MetricsCarry)`` with per-seed recorders."""
    check_chunk_config(protocol, ms, superstep=superstep,
                       fast_forward=True)
    _check_batched(protocol, ms, spec, superstep)
    if not fast_forward_ok(protocol):
        raise ValueError("fast_forward_chunk_batched_metrics needs a "
                         "protocol implementing next_action_time — same "
                         "precondition as the uninstrumented engine")
    return fast_forward_chunk_metrics(protocol, ms, spec, seed_axis=True,
                                      superstep=superstep)
