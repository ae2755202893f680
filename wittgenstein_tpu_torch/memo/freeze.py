"""Fixed-point lane freezing — the port of
`wittgenstein_tpu/memo/freeze.py`: the pure synthesis of a frozen
lane's tail (its final state and its obs carries), over the port's
engine and carries.  (The scheduler's `_freeze_pass` that drives it
waits for the port's scheduler, ROADMAP.md A14.)

A done lane is a fixed point the dense engines recompute every ms: once
the `next_work` oracle proves no ring row, broadcast arrival or
protocol timer can fire before the lane's end, every remaining
millisecond is bit-identical to a no-op step (the fast-forward
soundness contract, core/network.next_work).  The serve scheduler can
therefore slice the lane out of the running batch at a chunk boundary
and STITCH its tail analytically:

  * final state — `core/network._jump` to the lane's end: the clock
    moves (it IS the ring head) and broadcasts retire exactly as the
    per-ms path would have retired them; every other leaf is constant
    by the oracle's guarantee.
  * metrics     — every remaining interval row samples the SAME frozen
    counter values (`samples == stat_each_ms` per row — the dense
    recorder's count); only `bc_live` can still move (records retire
    by age), so its rows are computed through the `_jump` retirement
    formula per interval.
  * audit       — a quiet chunk violates nothing: zero counts, no
    first record, monotonicity snapshots and totals equal to the
    frozen state's (exactly what `fold_window` over no-op steps
    produces).
  * trace       — no events (nothing sends, delivers, finishes, or
    churns inside a provably-quiet window): an empty ring per chunk.

Scope: the dense `vmapped` and lockstep `batched` engines with
``spill_cap == 0`` (the oracle cannot see a spill buffer), and only
past any configured attack `at_ms` (the FaultInjector perturbs outside
the oracle's view).  The `fast_forward` engine is excluded on purpose:
it already skips quiet windows, and its batch-level `ff_*` metrics
columns record the JUMP pattern — slicing lanes there would change an
artifact the contract pins.  Chaos schedules are safe by construction:
`ChaosProtocol.next_action_time` clamps the oracle at every pending
churn/partition transition, so a lane with adversity still ahead is
never frozen.

The scheduler drives this (`serve/scheduler.py` `_freeze_pass`,
enabled via ``Scheduler(freeze=True)`` / ``WTPU_MEMO=1``); this module
holds the pure synthesis so the tail construction is testable against
the real engines' output bit for bit (tests/test_memo.py:
audit verdicts stay CLEAN and `cross_check_metrics` == []).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

#: engines whose lanes may freeze (module docstring)
FREEZE_ENGINES = ("vmapped", "batched")


def freeze_supported(spec, cfg) -> bool:
    """Static half of the eligibility gate: engine + spill scope."""
    return spec.engine in FREEZE_ENGINES and cfg.spill_cap == 0


def build_probe(protocol):
    """The per-lane convergence oracle (wittgenstein_tpu/memo/
    freeze.py:62-73): ``probe(nets, pstates) -> int32 [B]``, the port's
    `next_work` of each run of a seed batch at that run's own clock.
    The clocks are read from the device once; the result stays there
    (one [B] fetch per chunk boundary is the caller's).  A lane whose
    every seed's next work lands at or past its end is a fixed
    point."""
    from ..core.network import next_work

    def probe(nets, pstates):
        times = nets.time.tolist()
        return torch.stack([
            next_work(protocol,
                      *pytree.tree_map(lambda x, r=r: x[r], (nets, pstates)),
                      int(t)).reshape(())
            for r, t in enumerate(times)]).to(torch.int32)

    return probe


def _lane_time(net) -> int:
    times = set(net.time.reshape(-1).tolist())
    if len(times) != 1:
        raise ValueError(f"a frozen lane's runs share one clock; got "
                         f"times {sorted(times)}")
    return times.pop()


def frozen_final(cfg, state, t_end: int):
    """The lane's end-of-run state in one hop (module docstring;
    wittgenstein_tpu/memo/freeze.py:76-87): the port's `_jump` over the
    provably-quiet tail — bit-identical to stepping it, including
    broadcast retirement.  `state` is one run or a seed batch at one
    clock."""
    from ..core.network import _jump

    net, ps = state
    t_end = int(t_end)
    return _jump(cfg, net, t_end - _lane_time(net), t_end), ps


def _host(x, dtype=np.int64):
    return x.detach().cpu().numpy().astype(dtype)


def _per_seed(x):
    """Sum a [w, ...] leaf over every non-lane axis -> [w] int64."""
    a = _host(x)
    return a.reshape(a.shape[0], -1).sum(axis=1) if a.ndim > 1 else a


def _tensors(cls, **arrays):
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in arrays.items()})


def frozen_carries(spec, cfg, state, t0: int, n_chunks: int) -> dict:
    """Synthesize the frozen lane's remaining per-chunk obs carries for
    every plane in ``spec.obs`` (module docstring; wittgenstein_tpu/
    memo/freeze.py:97-188), on the host with numpy, once per frozen
    lane: the port's carry classes with CPU tensors.  `state` is the
    lane's (net, pstate) with a leading seed axis of width w, at chunk
    boundary `t0`.  The ring's two reductions run where the ring is; only
    their [w] results and the small leaves come to the host."""
    net = state[0]
    nodes = net.nodes
    down = _host(nodes.down, bool)
    done_at = _host(nodes.done_at)
    w = down.shape[0]
    msg_sent = _per_seed(nodes.msg_sent)
    msg_received = _per_seed(nodes.msg_received)
    bytes_sent = _per_seed(nodes.bytes_sent)
    bytes_received = _per_seed(nodes.bytes_received)
    drops = (_per_seed(net.dropped) + _per_seed(net.bc_dropped) +
             _per_seed(net.clamped) + _per_seed(net.sp_dropped))
    done_count = ((done_at > 0) & ~down).sum(axis=1)
    live_count = (~down).sum(axis=1)
    box = net.box_count
    box = torch.cat(box, -1) if isinstance(box, tuple) else box
    ring_rows = _host((box > 0).any(-1).sum(-1))
    ring_occ = _host(box.reshape(w, -1).sum(1, dtype=torch.int64))
    spill = (_host(net.sp_arrival).reshape(w, -1) >= 0).sum(axis=1)
    bc_active = _host(net.bc_active, bool).reshape(w, -1)
    bc_time = _host(net.bc_time).reshape(w, -1)
    chunk = int(spec.chunk_ms)
    out: dict = {}

    if "metrics" in spec.obs:
        from ..obs.plane import MetricsCarry
        from ..obs.spec import MetricsSpec
        mspec = MetricsSpec(stat_each_ms=spec.stat_each_ms)
        stat = mspec.stat_each_ms
        rows = mspec.n_intervals(chunk)
        const = {
            "msg_sent": msg_sent, "msg_received": msg_received,
            "bytes_sent": bytes_sent, "bytes_received": bytes_received,
            "done_count": done_count, "live_count": live_count,
            "ring_rows": ring_rows, "ring_occupancy": ring_occ,
            "spill_hwm": spill, "drop_count": drops,
        }
        chunks = []
        for c in range(int(n_chunks)):
            t0c = int(t0) + c * chunk
            series = np.zeros((w, rows, len(mspec.columns)), np.int32)
            for i, name in enumerate(mspec.columns):
                if name == "samples":
                    series[:, :, i] = stat
                elif name in ("ff_skipped_ms", "ff_jumps"):
                    pass            # the dense engines never jump
                elif name == "bc_live":
                    if cfg.bcast_slots > 0:
                        for r in range(rows):
                            # last executed ms of row r; a record older
                            # than the horizon at that ms is retired
                            tau = t0c + (r + 1) * stat - 1
                            series[:, r, i] = (
                                bc_active &
                                (tau - bc_time < cfg.horizon)
                            ).sum(axis=1)
                else:
                    series[:, :, i] = const[name][:, None]
            chunks.append(_tensors(MetricsCarry,
                                   t0=np.full((w,), t0c, np.int32),
                                   series=series))
        out["metrics"] = chunks

    if "audit" in spec.obs:
        from ..obs.audit import FIRST_FIELDS, INVARIANTS, AuditCarry
        mono = np.stack([msg_sent, msg_received, bytes_sent,
                         bytes_received, _per_seed(net.dropped),
                         _per_seed(net.bc_dropped),
                         _per_seed(net.clamped),
                         _per_seed(net.sp_dropped)],
                        axis=1).astype(np.int32)
        totals = np.stack([msg_sent, msg_received, drops, done_count],
                          axis=1).astype(np.int32)
        ac = _tensors(AuditCarry,
                      counts=np.zeros((w, len(INVARIANTS)), np.int32),
                      first=np.full((w, len(FIRST_FIELDS)), -1, np.int32),
                      prev_done=done_at.astype(np.int32),
                      prev_counters=mono, totals=totals)
        out["audit"] = [ac] * int(n_chunks)

    if "trace" in spec.obs:
        from ..obs.trace import FIELDS, TraceCarry
        tc = _tensors(TraceCarry,
                      buf=np.zeros((w, spec.trace_capacity, len(FIELDS)),
                                   np.int32),
                      cursor=np.zeros((w,), np.int32),
                      dropped=np.zeros((w,), np.int32),
                      down=down.copy())
        out["trace"] = [tc] * int(n_chunks)
    return out
