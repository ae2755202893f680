"""Device side of the invariant audit plane: conservation-law monitors in
the engine chunk — the port of `wittgenstein_tpu/obs/audit.py` (its
dense, batched and fast-forward halves; the sharded engine's monitors
wait for the port's multi-device engine, ROADMAP.md A15).

An `AuditSpec(invariants, mode)` runs a fixed-shape int32 `AuditCarry`
(per-invariant violation counters and an optional first-violation
``(ms, invariant, index, observed, expected)`` record) beside the state
through the same `step_kms` tap hook the flight recorder uses.
Everything observed is a pure function of ``(t, state, outbox)``: no
host read, no extra random draw.  So audit-ON is bit-identical on the
``(NetState, pstate)`` trajectory (tests/test_torch_audit.py), and the
default ``tap=None`` engine runs no extra operation.

The invariants, their codes and their checks are the JAX package's
(wittgenstein_tpu/obs/audit.py:27-61): ring_conservation (per-origin-ms
exact: Δ ring occupancy == routed ring sends + spill re-injections −
consumed ring rows − Δ overflow drops), ring_capacity, spill_budget,
clock_monotone, done_monotone, counter_monotone, bc_consistency and
shard_conservation (sharded engine only, so never compiled here).  The
carry also samples final counter totals (``TOTALS``) for the host
cross-check against a `MetricsCarry` of the same run
(`obs.audit_report.cross_check_metrics`).  On a seed batch every
monitor runs per run under `torch.func.vmap`, one carry a seed.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.latency import full_latency
from ..core.network import (check_chunk_config, fast_forward_chunk,
                            step_kms, step_ms)
from ..core.state import _Struct, register_struct
from ..ops import prng

I32 = torch.int32

#: Canonical invariants; the invariant CODE is the index here and is
#: stable regardless of which subset a spec enables (decode uses this).
INVARIANTS = (
    "ring_conservation",
    "ring_capacity",
    "spill_budget",
    "clock_monotone",
    "done_monotone",
    "counter_monotone",
    "bc_consistency",
    "shard_conservation",
)
INV = {name: i for i, name in enumerate(INVARIANTS)}

#: First-violation record columns, in buffer order.
FIRST_FIELDS = ("ms", "invariant", "index", "observed", "expected")

#: Cumulative engine counters `counter_monotone` snapshots per window
#: (the "index" a counter_monotone first-violation record points into).
MONO_COUNTERS = ("msg_sent", "msg_received", "bytes_sent",
                 "bytes_received", "dropped", "bc_dropped", "clamped",
                 "sp_dropped")

#: Audit totals sampled at the last window, cross-checkable against the
#: metrics plane's identically-named counters.
TOTALS = ("msg_sent", "msg_received", "drop_count", "done_count")

MODES = ("count", "first")


@dataclasses.dataclass(frozen=True)
class AuditSpec:
    """Static audit-plane parameters (hashable;
    wittgenstein_tpu/obs/audit.py:98-133).

    invariants — enabled subset (canonical INVARIANTS order); disabled
    invariants are never computed.
    mode — "count" runs the per-invariant violation counters only;
    "first" (default) also keeps the first-violation record ``(ms,
    invariant, index, observed, expected)``: ms is the window entry
    time, index the violating node/row/counter (-1 = global).
    spill_budget — HWM budget for `spill_budget` (None = the config's
    full ``spill_cap``).
    """

    invariants: tuple = INVARIANTS
    mode: str = "first"
    spill_budget: int | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        unknown = [i for i in self.invariants if i not in INVARIANTS]
        if unknown:
            raise ValueError(f"unknown invariants {unknown}; known: "
                             f"{INVARIANTS}")
        object.__setattr__(
            self, "invariants",
            tuple(i for i in INVARIANTS if i in set(self.invariants)))
        if self.spill_budget is not None and self.spill_budget < 0:
            raise ValueError(f"spill_budget must be >= 0, got "
                             f"{self.spill_budget}")

    def enabled(self, name: str) -> bool:
        return name in self.invariants


def monitored_invariants(spec: AuditSpec, cfg,
                         sharded: bool = False) -> tuple:
    """The invariants a build with this spec ACTUALLY runs for an engine
    config (wittgenstein_tpu/obs/audit.py:136-153): `shard_conservation`
    only in a sharded engine, `spill_budget` only with a spill buffer,
    `bc_consistency` only with broadcast slots."""
    out = []
    for name in spec.invariants:
        if name == "shard_conservation" and not sharded:
            continue
        if name == "spill_budget" and (sharded or cfg.spill_cap == 0):
            continue
        if name == "bc_consistency" and cfg.bcast_slots == 0:
            continue
        out.append(name)
    return tuple(out)


@register_struct
@dataclasses.dataclass(frozen=True)
class AuditCarry(_Struct):
    """The on-device audit state (wittgenstein_tpu/obs/audit.py:
    156-173): ``counts[i]`` accumulates invariant i's violations (full
    INVARIANTS indexing); ``first`` holds the earliest violation record
    (ms == -1 while clean; written only in "first" mode);
    ``prev_done``/``prev_counters`` are the previous window's snapshots
    the monotonicity invariants difference against; ``totals`` samples
    the TOTALS counters at the last folded window.  A seed batch has a
    leading R axis on every leaf."""

    counts: torch.Tensor         # int32 [len(INVARIANTS)]
    first: torch.Tensor          # int32 [5] — FIRST_FIELDS order
    prev_done: torch.Tensor      # int32 [N]
    prev_counters: torch.Tensor  # int32 [len(MONO_COUNTERS)]
    totals: torch.Tensor         # int32 [len(TOTALS)]


def _per_run(fn, batch: bool, in_dims=0):
    """`fn` for one run, or under `torch.func.vmap` for a seed batch."""
    return torch.func.vmap(fn, in_dims=in_dims) if batch else fn


def _box_count(net):
    """``box_count`` as one [H, N] tensor (a split ring's sub-planes
    joined on the node axis)."""
    bc = net.box_count
    return torch.cat(bc, -1) if isinstance(bc, tuple) else bc


def _mono_counters(net):
    nodes = net.nodes
    return torch.stack([
        nodes.msg_sent.sum(dtype=I32), nodes.msg_received.sum(dtype=I32),
        nodes.bytes_sent.sum(dtype=I32),
        nodes.bytes_received.sum(dtype=I32),
        net.dropped, net.bc_dropped, net.clamped, net.sp_dropped]).to(I32)


def _init_one(net) -> AuditCarry:
    dev = net.time.device
    return AuditCarry(
        counts=torch.zeros(len(INVARIANTS), dtype=I32, device=dev),
        first=torch.full((len(FIRST_FIELDS),), -1, dtype=I32, device=dev),
        prev_done=net.nodes.done_at.to(I32),
        prev_counters=_mono_counters(net),
        totals=torch.zeros(len(TOTALS), dtype=I32, device=dev))


def init_audit(spec: AuditSpec, net) -> AuditCarry:
    """Fresh carry with the monotonicity snapshots taken from the chunk
    ENTRY state (wittgenstein_tpu/obs/audit.py:187-197), one a seed for
    a batch."""
    return _per_run(_init_one, net.time.dim() > 0)(net)


def _routed_ring_candidates(cfg, model, net, out, t: int):
    """How many of this outbox's sends the engine bins into the unicast
    ring at ms `t` (wittgenstein_tpu/obs/audit.py:200-225): the audit's
    replay of the routing validity, keyed on the same (seed, t,
    full-width slot id) latency draw, so the count is the engine's."""
    nodes = net.nodes
    n, kk = cfg.n, out.dest.shape[1]
    m = n * kk
    dev = nodes.down.device
    src = torch.arange(n, dtype=I32, device=dev).repeat_interleave(kk)
    dest = out.dest.reshape(m)
    want = (dest >= 0) & (~nodes.down[src])
    dest_c = dest.clamp(0, n - 1)
    seed_t = prng.hash3(net.seed, prng.TAG_LATENCY, t)
    midx = src * cfg.out_deg + out.slot0 + \
        torch.arange(kk, dtype=I32, device=dev).repeat(n)
    delta = prng.uniform_delta(seed_t, midx)
    lat = full_latency(model, nodes, src, dest_c, delta)
    valid = want & (lat < cfg.msg_discard_time) & (~nodes.down[dest_c]) & (
        nodes.partition[src] == nodes.partition[dest_c])
    if cfg.spill_cap > 0:
        # far-future sends park in the spill buffer instead of the ring
        raw_total = out.delay.reshape(m).clamp_min(0) + lat.clamp_min(1)
        valid = valid & ~(raw_total > cfg.horizon - 2)
    return valid.sum(dtype=I32)


def audit_tap(protocol, spec: AuditSpec, cell):
    """The `step_kms` observation hook bound to a mutable 1-cell
    ``[window_obs]`` (wittgenstein_tpu/obs/audit.py:228-268): entry taps
    accumulate the window's consumed ring rows and spill drain set (and
    take entry occupancy and drops at the first one); post taps
    accumulate each origin ms's routed-send count.  The builder folds
    the window after the step returns (`fold_window`)."""
    cfg, model = protocol.cfg, protocol.latency
    want_cons = spec.enabled("ring_conservation")

    def first_obs(net):
        zero = torch.zeros((), dtype=I32, device=net.time.device)
        return {"occ_entry": _box_count(net).sum(dtype=I32),
                "dropped_entry": net.dropped, "consumed": zero,
                "candidates": zero, "drained": zero}

    def entry(obs, net, t):
        obs = dict(obs)
        obs["consumed"] = obs["consumed"] + \
            _box_count(net)[t % cfg.horizon].sum(dtype=I32)
        if cfg.spill_cap > 0:
            sel = (net.sp_arrival >= 0) & \
                (net.sp_arrival - t <= cfg.horizon - 2)
            obs["drained"] = obs["drained"] + sel.sum(dtype=I32)
        return obs

    def post(net, out, t):
        return _routed_ring_candidates(cfg, model, net, out, t)

    def tap(t, net, out):
        batch = net.time.dim() > 0
        if out is None:
            if cell[0] is None:
                cell[0] = _per_run(first_obs, batch)(net)
            if want_cons:
                cell[0] = _per_run(entry, batch, (0, 0, None))(cell[0],
                                                               net, t)
        elif want_cons:
            cell[0]["candidates"] = cell[0]["candidates"] + _per_run(
                post, batch, (0, 0, None))(net, out, t)

    return tap


def _apply(spec: AuditSpec, ac: AuditCarry, t_ms: int,
           results) -> AuditCarry:
    """Fold one window's invariant results ``[(inv_id, count, index,
    observed, expected), ...]`` into the carry
    (wittgenstein_tpu/obs/audit.py:271-292)."""
    results = sorted(results, key=lambda r: r[0])
    add = [torch.zeros_like(ac.counts[0])] * len(INVARIANTS)
    for inv_id, cnt, _, _, _ in results:
        add[inv_id] = add[inv_id] + cnt
    counts = ac.counts + torch.stack(add)
    first = ac.first
    if spec.mode == "first":
        # canonical order, so the within-window "first" is deterministic
        for inv_id, cnt, idx, obs_v, exp_v in results:
            hit = (cnt > 0) & (first[0] < 0)
            rec = torch.stack([
                torch.full_like(cnt, t_ms), torch.full_like(cnt, inv_id),
                idx.to(I32), obs_v.to(I32), exp_v.to(I32)])
            first = torch.where(hit, rec, first)
    return ac.replace(counts=counts, first=first)


def _at(x, i):
    """``x[i]`` for a 0-d index tensor `i`, read on the device (indexing
    with a 0-d tensor would read it back to the host first)."""
    return x.gather(0, i.reshape(1)).squeeze(0)


def _common_results(spec: AuditSpec, cfg, ac: AuditCarry, t_entry: int,
                    net, k: int, cur) -> list:
    """The invariant checks of every engine flavour
    (wittgenstein_tpu/obs/audit.py:295-352): clock advance, ring
    capacity, done fixed point, cumulative-counter monotonicity and
    broadcast-table consistency."""
    nodes = net.nodes
    t_after = net.time
    results = []

    def add(name, count, index, observed, expected):
        if spec.enabled(name):
            results.append((INV[name], count.to(I32), index, observed,
                            expected))

    minus = torch.full_like(t_after, -1)
    d = (t_after - t_entry).to(I32)
    add("clock_monotone", (d != k).to(I32), minus, d,
        torch.full_like(t_after, k))

    box = _box_count(net)
    over = box > cfg.inbox_cap
    n_over = over.sum(dtype=I32)
    add("ring_capacity", n_over,
        torch.where(n_over > 0, over.reshape(-1).to(I32).argmax().to(I32),
                    -1),
        box.max().to(I32), torch.full_like(t_after, cfg.inbox_cap))

    viol = (ac.prev_done > 0) & (nodes.done_at != ac.prev_done)
    nv = viol.sum(dtype=I32)
    vi = viol.to(I32).argmax()
    add("done_monotone", nv, torch.where(nv > 0, vi.to(I32), -1),
        _at(nodes.done_at, vi).to(I32), _at(ac.prev_done, vi))

    dec = cur < ac.prev_counters
    nc = dec.sum(dtype=I32)
    ci = dec.to(I32).argmax()
    add("counter_monotone", nc, torch.where(nc > 0, ci.to(I32), -1),
        _at(cur, ci), _at(ac.prev_counters, ci))

    if cfg.bcast_slots > 0 and spec.enabled("bc_consistency"):
        # after the window's last retire (at t_after - 1) no active
        # record may be older than the horizon
        age = (t_after - 1 - net.bc_time).to(I32)
        stale = net.bc_active & (age >= cfg.horizon)
        ns = stale.sum(dtype=I32)
        si = stale.to(I32).argmax()
        add("bc_consistency", ns, torch.where(ns > 0, si.to(I32), -1),
            _at(age, si), torch.full_like(t_after, cfg.horizon - 1))
    return results


def _done_count(nodes):
    return ((~nodes.down) & (nodes.done_at > 0)).sum(dtype=I32)


def _fold_one(spec: AuditSpec, cfg, ac: AuditCarry, obs: dict, net,
              k: int, t_entry: int) -> AuditCarry:
    nodes = net.nodes
    t_after = net.time
    cur = _mono_counters(net)
    results = _common_results(spec, cfg, ac, t_entry, net, k, cur)

    def add(name, count, index, observed, expected):
        if spec.enabled(name):
            results.append((INV[name], count.to(I32), index, observed,
                            expected))

    minus = torch.full_like(t_after, -1)
    if spec.enabled("ring_conservation"):
        occ_after = _box_count(net).sum(dtype=I32)
        ddrop = (net.dropped - obs["dropped_entry"]).to(I32)
        lhs = occ_after - obs["occ_entry"]
        rhs = obs["candidates"] + obs["drained"] - obs["consumed"] - ddrop
        add("ring_conservation", (lhs != rhs).to(I32), minus, lhs, rhs)

    if cfg.spill_cap > 0 and spec.enabled("spill_budget"):
        budget = cfg.spill_cap if spec.spill_budget is None \
            else spec.spill_budget
        parked = net.sp_arrival >= 0
        occ_sp = parked.sum(dtype=I32)
        overdue = parked & (net.sp_arrival <= t_after)
        n_bad = (occ_sp - budget).clamp_min(0) + overdue.sum(dtype=I32)
        add("spill_budget", n_bad,
            torch.where(overdue.any(), overdue.to(I32).argmax().to(I32),
                        -1),
            occ_sp, torch.full_like(t_after, budget))

    drop_total = (net.dropped + net.bc_dropped + net.clamped +
                  net.sp_dropped).to(I32)
    totals = torch.stack([cur[0], cur[1], drop_total, _done_count(nodes)])
    return _apply(spec, ac, t_entry, results).replace(
        prev_done=nodes.done_at.to(I32), prev_counters=cur, totals=totals)


def fold_window(spec: AuditSpec, cfg, ac: AuditCarry, obs: dict, net,
                k: int, t_entry: int) -> AuditCarry:
    """Evaluate every enabled invariant over one executed window (entry
    observations in `obs`, the window entered at `t_entry`, exit state
    in `net`) and fold the verdicts and refreshed snapshots into the
    carry (wittgenstein_tpu/obs/audit.py:359-407).  Pure reductions over
    state the engine keeps; per run under `torch.func.vmap` on a
    batch."""
    def one(ac_, obs_, net_):
        return _fold_one(spec, cfg, ac_, obs_, net_, k, t_entry)

    return _per_run(one, net.time.dim() > 0)(ac, obs, net)


def audit_jump(spec: AuditSpec, ac: AuditCarry, t_from: int,
               dt: int) -> AuditCarry:
    """Audit one quiet-window fast-forward jump: the only invariant a
    pure clock move can break is monotonicity, dt < 0
    (wittgenstein_tpu/obs/audit.py:410-425).  The port's jump is a host
    int, so a jump the engine made cannot be negative; the check stays
    for a caller's own jumps."""
    if not spec.enabled("clock_monotone") or dt >= 0:
        return ac
    i = INV["clock_monotone"]
    counts = ac.counts.clone()
    counts[..., i] += 1
    ac = ac.replace(counts=counts)
    if spec.mode == "first":
        rec = torch.tensor([t_from, i, -1, dt, 0], dtype=I32,
                           device=ac.first.device)
        ac = ac.replace(first=torch.where(ac.first[..., :1] < 0, rec,
                                          ac.first))
    return ac


# ------------------------------------------------------ chunk builders


def step_ms_audit(protocol, spec: AuditSpec, net, pstate, ac,
                  t: int | None = None):
    """One audited millisecond: `step_ms` with the monitors tapped in
    (wittgenstein_tpu/obs/audit.py:431-438)."""
    if t is None:
        t = int(net.time.reshape(-1)[0])
    cell = [None]
    net, pstate = step_ms(protocol, net, pstate, t=t,
                          tap=audit_tap(protocol, spec, cell))
    return net, pstate, fold_window(spec, protocol.cfg, ac, cell[0], net,
                                    1, t)


def _step_window_audit(protocol, spec: AuditSpec, k: int):
    """One audited K-ms window (k == 1 is a plain audited ms), for one
    run or a seed batch."""

    def one(net, pstate, ac, t):
        cell = [None]
        net, pstate = step_kms(protocol, net, pstate, k, t=t,
                               tap=audit_tap(protocol, spec, cell))
        return net, pstate, fold_window(spec, protocol.cfg, ac, cell[0],
                                        net, k, t)

    return one


def scan_chunk_audit(protocol, ms: int, spec: AuditSpec,
                     superstep: int = 1):
    """Returns ``run(net, pstate, t=None) -> (net, pstate, AuditCarry)``
    advancing `ms` milliseconds with the invariant monitors beside the
    state — the audited twin of ``scan_chunk(protocol, ms,
    superstep=K)`` (wittgenstein_tpu/obs/audit.py:454-475), for one run
    or a seed batch.  Inside a K window the taps fire per simulated ms,
    so the conservation balance is exact per origin ms."""
    check_chunk_config(protocol, ms, superstep=superstep)
    step = _step_window_audit(protocol, spec, superstep)

    def run(net, pstate, t=None):
        t = int(net.time.reshape(-1)[0]) if t is None else t
        ac = init_audit(spec, net)
        for _ in range(ms // superstep):
            net, pstate, ac = step(net, pstate, ac, t)
            t += superstep
        return net, pstate, ac

    return run


def scan_chunk_batched_audit(protocol, ms: int, spec: AuditSpec,
                             superstep: int = 2):
    """Audited twin of `core/batched.scan_chunk_batched`
    (wittgenstein_tpu/obs/audit.py:478-505): per-seed monitors over the
    K-ms window engine on the seed batch."""
    from ..core.batched import _check_batched_scope

    check_chunk_config(protocol, ms, superstep=superstep)
    _check_batched_scope(protocol, ms, superstep)
    return scan_chunk_audit(protocol, ms, spec, superstep=superstep)


class _Auditor:
    """The audit plane as `network.fast_forward_chunk`'s observer."""

    def __init__(self, protocol, spec: AuditSpec, ac, k: int):
        self.spec, self.ac = spec, ac
        self.step = _step_window_audit(protocol, spec, k)

    def window(self, net, pstate, k: int, t: int):
        net, pstate, self.ac = self.step(net, pstate, self.ac, t)
        return net, pstate

    def jump(self, t: int, dt: int):
        self.ac = audit_jump(self.spec, self.ac, t, dt)


def fast_forward_chunk_audit(protocol, ms: int, spec: AuditSpec,
                             seed_axis: bool = False, superstep: int = 1):
    """Audited twin of `core/network.fast_forward_chunk`
    (wittgenstein_tpu/obs/audit.py:508-559): returns ``run(net, pstate,
    t=None) -> (net, pstate, stats, AuditCarry)``.  Each executed window
    balances its own conservation equation; each jump is audited for
    clock monotonicity.  ``seed_axis=True`` takes a seed batch with
    per-seed carries and lockstep jumps."""
    check_chunk_config(protocol, ms, superstep=superstep,
                       fast_forward=True)

    def run(net, pstate, t=None):
        au = _Auditor(protocol, spec, init_audit(spec, net), superstep)
        net, pstate, stats = fast_forward_chunk(
            protocol, ms, seed_axis=seed_axis, superstep=superstep,
            observer=au)(net, pstate, t)
        return net, pstate, stats, au.ac

    return run
