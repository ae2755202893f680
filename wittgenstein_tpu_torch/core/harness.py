"""Experiment harness: Monte-Carlo multi-seed runs and time series — the
port of `wittgenstein_tpu/core/harness.py`.

The reference runs seeds one after the other (core/RunMultipleTimes.java:
41-87).  Here all seeds run at once, as the JAX harness's
``jax.vmap(scan_chunk(...))`` runs them: `network.scan_chunk` on a seed
batch (the engine of `core/batched.py`, bit-identical seed by seed to
the per-seed engine), one batch of state, one kernel launch per window
for every seed, at whatever superstep K the shared gate proves for the
protocol, the chunk and the entry time (K = 1 included), with
broadcasts and the spill buffer.

Per-run stopping is faithful: after every `chunk` simulated ms each run's
continue-predicate is evaluated and finished runs are *frozen*, so every
run's final state is exactly its state at its own stop time, ring
included, and stats match the sequential semantics run for run.

Not ported: the JAX package's `devices=`/`mesh=` sharding and its
persistent compile cache (one card, no compiler; ROADMAP.md A15),
`progress_per_time_on_device` and `capture_trace` (the obs planes).
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.utils import _pytree as pytree

from ..utils import stats as stats_mod
from .network import pick_superstep, scan_chunk
from .state import init_batched


def cont_until_done(net, pstate):
    """RunMultipleTimes.contUntilDone (:90-97): continue while any live
    node has doneAt == 0."""
    live = ~net.nodes.down
    return (live & (net.nodes.done_at == 0)).any()


def _freeze_chunk(protocol, chunk, cont, t0=0):
    """Advance every run by `chunk` ms, keeping stopped runs frozen at
    their stop-time state (wittgenstein_tpu/core/harness.py:68-116).
    `t0` is the runs' actual entry time.  Returns ``chunk_all(nets, ps,
    stopped, stopped_at, t) -> (nets, ps, stopped, stopped_at,
    dropped)`` with `t` the batch's time at entry.

    When `chunk` is a multiple of the schedule lcm every chunk enters at
    phase ``t0 % lcm`` and is phase-specialized; the superstep is the
    largest K `pick_superstep` proves for the chunk and entry time (1
    for a spill protocol or an unaligned entry).  The ring is updated in
    place, so stopped runs are kept out of its clear and its binning,
    the spill drain's included (`frozen`); their other leaves are
    selected back."""
    lcm = getattr(protocol, "schedule_lcm", None)
    use_spec = bool(lcm and chunk % lcm == 0)
    ss = pick_superstep(protocol, chunk, t0=t0,
                        lcm=lcm if use_spec else None)
    one_chunk = scan_chunk(protocol, chunk,
                           t0_mod=(t0 % lcm) if use_spec else None,
                           superstep=ss)

    def chunk_all(nets, ps, stopped, stopped_at, t):
        nets2, ps2 = one_chunk(nets, ps, t=t, frozen=stopped)

        def sel(old, new):
            if old is new:                # the ring, updated in place
                return new
            shape = (stopped.shape[0],) + (1,) * (new.dim() - 1)
            return torch.where(stopped.reshape(shape), old, new)

        nets3 = pytree.tree_map(sel, nets, nets2)
        ps3 = pytree.tree_map(sel, ps, ps2)
        still = torch.func.vmap(cont)(nets3, ps3)
        newly_stopped = (~stopped) & (~still)
        stopped_at = torch.where(newly_stopped, nets3.time, stopped_at)
        dropped = (nets3.dropped.sum() + nets3.bc_dropped.sum() +
                   nets3.clamped.sum() + nets3.sp_dropped.sum())
        return nets3, ps3, stopped | ~still, stopped_at, dropped

    return chunk_all


def _check_drops(dropped, where):
    if int(dropped) > 0:
        raise RuntimeError(
            f"{int(dropped)} messages dropped/clamped during {where}: the "
            "protocol's inbox_cap / bcast_slots / horizon are undersized for "
            "this scenario (pass fail_on_drop=False if that is intended)")


class _BatchDriver:
    """Shared multi-seed scaffolding of `run_multiple_times` and
    `progress_per_time` (wittgenstein_tpu/core/harness.py:192-267):
    batched init over the seeds, frozen-run chunk advance and the
    drop/clamp guard."""

    def __init__(self, protocol, run_count, chunk, cont_if, first_seed,
                 fail_on_drop, where):
        self.cont = cont_if or cont_until_done
        self.seeds = torch.arange(first_seed, first_seed + run_count,
                                  dtype=torch.int32)
        self.nets, self.ps = init_batched(protocol, self.seeds)
        dev = self.nets.time.device
        self.stopped = torch.zeros(run_count, dtype=torch.bool, device=dev)
        self.stopped_at = torch.zeros(run_count, dtype=torch.int32,
                                      device=dev)
        # The runs' actual entry time: alignment is decided against it.
        self.t = int(self.nets.time[0])
        self._chunk = chunk
        self._chunk_all = _freeze_chunk(protocol, chunk, self.cont,
                                        t0=self.t)
        self._fail_on_drop = fail_on_drop
        self._where = where

    def advance(self):
        """One chunk for every run; returns True when all runs have
        stopped."""
        (self.nets, self.ps, self.stopped, self.stopped_at,
         dropped) = self._chunk_all(self.nets, self.ps, self.stopped,
                                    self.stopped_at, self.t)
        self.t += self._chunk
        if self._fail_on_drop:
            _check_drops(dropped, self._where)
        return bool(self.stopped.all())


@dataclasses.dataclass
class MultiRunResult:
    nets: object          # NetState batch [R]; each frozen at its stop time
    pstates: object       # protocol state batch
    stopped_at: torch.Tensor  # int32 [R]: each run's stop time (0: none)
    stats: dict           # getter name -> averaged stat dict (floats)
    per_run: dict         # getter name -> stat dict with leading run axis


def run_multiple_times(protocol, run_count, max_time=0, chunk=10,
                       cont_if=None, stats_getters=(), final_check=None,
                       first_seed=0, fail_on_drop=True, max_wall_s=None,
                       on_chunk=None):
    """RunMultipleTimes.run on a seed batch (wittgenstein_tpu/core/
    harness.py:278-318).  Seeds are first_seed..first_seed+run_count-1.
    max_time=0 means no time limit: the loop runs until every run's
    predicate stops it, under a wall-clock bound (`max_wall_s`, 1800 s
    by default when max_time=0).  `on_chunk(t, nets, pstates)`, when
    given, sees the batch after each chunk (`t` the batch's time).
    Returns averaged stats across runs plus per-run values."""
    drv = _BatchDriver(protocol, run_count, chunk, cont_if, first_seed,
                       fail_on_drop, f"run_multiple_times({protocol})")
    steps = 10**9 if max_time == 0 else -(-max_time // chunk)
    if max_time == 0 and max_wall_s is None:
        max_wall_s = 1800.0
    deadline = None if max_wall_s is None else time.monotonic() + max_wall_s
    for _ in range(steps):
        all_stopped = drv.advance()
        if on_chunk is not None:
            on_chunk(drv.t, drv.nets, drv.ps)
        if all_stopped:
            break
        if deadline is not None and time.monotonic() > deadline:
            raise RuntimeError(
                f"run_multiple_times({protocol}) exceeded the "
                f"{max_wall_s:.0f}s wall-clock bound at sim time "
                f"{int(drv.nets.time.max())} ms with "
                f"{int((~drv.stopped).sum())}/{run_count} runs still "
                "going; pass max_time or a larger max_wall_s")
    nets, ps, stopped_at, seeds = drv.nets, drv.ps, drv.stopped_at, drv.seeds

    if final_check is not None:
        ok = torch.func.vmap(final_check)(nets, ps)
        if not bool(ok.all()):
            bad = [int(s) for s in seeds[~ok.cpu()]]
            raise AssertionError(f"finalCheck failed for seeds {bad}")

    per_run, averaged = {}, {}
    for g in stats_getters:
        vals = torch.func.vmap(g)(nets.nodes)
        per_run[g.stat_name] = vals
        averaged[g.stat_name] = stats_mod.avg_stats(vals)
    return MultiRunResult(nets=nets, pstates=ps, stopped_at=stopped_at,
                          stats=averaged, per_run=per_run)


@dataclasses.dataclass
class TimeSeries:
    times: list           # sample times (ms)
    per_run: dict         # getter name -> list over time of stat dicts [R]
    merged: dict          # "<getter>.<component>" -> {"min"/"max"/"avg"}


def progress_per_time(protocol, run_count=1, max_time=20_000,
                      stat_each_ms=10, stats_getters=(), cont_if=None,
                      first_seed=0, fail_on_drop=True):
    """Time-series variant (core/ProgressPerTime.java:53-149; wittgenstein_
    tpu/core/harness.py:397-439): sample the getters every
    `stat_each_ms` across all runs and merge min/avg/max across the run
    axis per sample point.  Stopped runs are frozen, so each run's
    samples flatline at its own stop-time values."""
    drv = _BatchDriver(protocol, run_count, stat_each_ms, cont_if, first_seed,
                       fail_on_drop, f"progress_per_time({protocol})")

    def sample(nets):
        return {g.stat_name: torch.func.vmap(g)(nets.nodes)
                for g in stats_getters}

    times, series = [], {g.stat_name: [] for g in stats_getters}
    t = 0
    while t < max_time:
        all_stopped = drv.advance()
        t += stat_each_ms
        vals = sample(drv.nets)
        times.append(t)
        for k, v in vals.items():
            series[k].append(v)
        if all_stopped:
            break
    nets, ps = drv.nets, drv.ps

    # Merge across the run axis per sample point (Graph.statSeries,
    # tools/Graph.java:214-251).
    merged = {}
    for k, samples in series.items():
        for comp in samples[0]:
            merged[f"{k}.{comp}"] = {
                "min": [float(s[comp].min()) for s in samples],
                "max": [float(s[comp].max()) for s in samples],
                "avg": [stats_mod.mean(s[comp]) for s in samples],
            }
    return TimeSeries(times=times, per_run=series, merged=merged), nets, ps
