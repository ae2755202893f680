"""`FaultSchedule` — adversity as data: a copy of
`wittgenstein_tpu/chaos/schedule.py` (pure Python, the same refusal
texts), so that a schedule, its JSON form and its validation are one
thing in both packages.

The reference simulator's core workload is adversity: nodes stop and
start mid-run (Node.java stop()/start()), partitions open and heal
(Network.java partition/endPartition :639-649), messages are lost and
delayed by a hostile network.  Our reproduction only expressed "nodes
down at entry" and the single-point `FaultInjector` probe; this module
makes the whole adversity axis DECLARATIVE: one frozen, hashable,
JSON-able schedule that compiles into every engine variant
(core/network.step_ms / step_kms, the batched twin, the fast-forward
while loop, the sharded runner) through `chaos.wrap.ChaosProtocol`.

Fault classes (all times are absolute simulated ms, all windows
half-open ``[start, end)``):

  churn       ``(node, down_ms, up_ms)`` — the node is down (cannot
              send, cannot receive) during the window and recovers at
              `up_ms`.  State loss is the engine's own delivery
              semantics: every unicast ARRIVING while the node is down
              is consumed undelivered (the ring row is cleared after
              its ms — the message is gone, not delayed), and
              broadcasts recomputed during the window skip it — the
              node's in-flight inbound state is lost.  Its protocol
              state is retained across the outage (the reference's
              stop()/start() contract: Node objects survive).
  partitions  ``(start_ms, end_ms, part_id, lo, hi)`` — nodes with id
              in ``[lo, hi)`` move to partition `part_id` (>= 1)
              during the window and HEAL back to the global partition
              0 at `end_ms` — the reference's mid-run
              partition/endPartition as data.  Windows that would
              assign one node two ids at once are refused.
  loss        ``(start_ms, end_ms, permille, src_lo, src_hi, dst_lo,
              dst_hi)`` — each unicast EMITTED during the window on a
              matching (src, dst) link is lost with probability
              permille/1000, decided by a counter-based draw keyed on
              (run seed, emit ms, stable message slot id) — the same
              keying discipline as the engine's latency draws, so the
              realization is bit-deterministic and engine-layout
              independent.  Overlapping windows compose:
              p = 1 - prod(1 - p_i).  Unicast only (a broadcast is one
              O(1) record; per-destination broadcast loss would need
              the delivery-recompute path and is out of scope).
  delay       ``(start_ms, end_ms, extra_ms, src_lo, src_hi, dst_lo,
              dst_hi)`` — unicasts emitted during the window on a
              matching link have `extra_ms` added to their
              sender-chosen delay (latency inflation; overlapping
              windows add).  Unicast only, like loss.

Determinism contract: the schedule is static data closed over by the
compiled program, loss draws are pure functions of (seed, t, slot id),
and churn/partition state is a STATELESS function of t evaluated at
every engine window entry — so the same (schedule, seed) yields
bit-identical trajectories across dense, superstep-K, batched,
fast-forward and sharded engines (tests/test_chaos.py).  The one
alignment obligation that buys this: churn/partition transition times
must be multiples of any superstep K the run uses (liveness is
evaluated at window entry; a mid-window transition would be visible to
the per-ms engine but not the fused window).  `superstep_aligned` is
the predicate; `core/network.check_chunk_config` raises the remedy and
`pick_superstep` demotes K automatically.
"""

from __future__ import annotations

import dataclasses
import math

#: schedule schema version (the ScenarioSpec `fault_schedule` field
#: carries this structure; readers key on the spec's own schema).
FIELDS = ("churn", "partitions", "loss", "delay")

_ARITY = {"churn": 3, "partitions": 5, "loss": 7, "delay": 7}
_SHAPE = {
    "churn": "(node, down_ms, up_ms)",
    "partitions": "(start_ms, end_ms, part_id, lo, hi)",
    "loss": "(start_ms, end_ms, permille, src_lo, src_hi, dst_lo, dst_hi)",
    "delay": "(start_ms, end_ms, extra_ms, src_lo, src_hi, dst_lo, "
             "dst_hi)",
}


def _err(msg: str) -> ValueError:
    return ValueError(f"FaultSchedule: {msg}")


def _norm(name: str, events) -> tuple:
    out = []
    try:
        events = tuple(events or ())
    except TypeError:
        raise _err(f"{name} must be a list of {_SHAPE[name]} rows, got "
                   f"{events!r}") from None
    for i, ev in enumerate(events):
        try:
            ev = tuple(ev)
        except TypeError:
            raise _err(f"{name}[{i}] must be a {_SHAPE[name]} row, got "
                       f"{ev!r}") from None
        if len(ev) != _ARITY[name]:
            raise _err(f"{name}[{i}] must be {_SHAPE[name]}, got "
                       f"{len(ev)} value(s) {ev!r}")
        try:
            out.append(tuple(int(x) for x in ev))
        except (TypeError, ValueError):
            raise _err(f"{name}[{i}] must be all ints, got {ev!r}") \
                from None
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """One declarative adversity schedule (frozen, hashable — safe to
    close over in jit; see the module docstring for event semantics)."""

    churn: tuple = ()
    partitions: tuple = ()
    loss: tuple = ()
    delay: tuple = ()

    def __post_init__(self):
        for name in FIELDS:
            object.__setattr__(self, name, _norm(name, getattr(self,
                                                               name)))

    # ------------------------------------------------------------- shape

    @property
    def empty(self) -> bool:
        return not (self.churn or self.partitions or self.loss
                    or self.delay)

    @property
    def mutates_state(self) -> bool:
        """True when the schedule needs the engine's window-entry
        `apply_faults` hook (churn/partition state); loss/delay act on
        the outbox inside the per-ms protocol step and need no hook."""
        return bool(self.churn or self.partitions)

    def transition_times(self) -> tuple:
        """Every ms at which churn/partition state CHANGES, sorted —
        the times the fast-forward engine must never jump across
        (`ChaosProtocol.next_action_time` clamps to them) and the times
        the superstep alignment contract is about."""
        times = set()
        for node, dm, um in self.churn:
            times.update((dm, um))
        for s, e, pid, lo, hi in self.partitions:
            times.update((s, e))
        return tuple(sorted(times))

    def superstep_aligned(self, k: int) -> bool:
        """True iff every churn/partition transition lands on a K-ms
        window boundary — the condition under which the window-entry
        fault application is bit-identical to the per-ms one (module
        docstring).  Loss/delay windows are applied per-ms inside the
        step and never constrain K."""
        if k <= 1:
            return True
        return all(t % k == 0 for t in self.transition_times())

    def align_gcd(self) -> int:
        """gcd of all transition times (0 when there are none): every
        valid superstep K divides it."""
        g = 0
        for t in self.transition_times():
            g = math.gcd(g, t)
        return g

    def counts(self) -> dict:
        """Event counts per fault class (the bench `chaos` block /
        summary form)."""
        return {name: len(getattr(self, name)) for name in FIELDS}

    # -------------------------------------------------------- validation

    def validate(self, n: int | None = None,
                 sim_ms: int | None = None) -> "FaultSchedule":
        """Refuse a malformed schedule with remedy text (the serve
        plane's 400 path).  `n` (node count) and `sim_ms` bound ids and
        windows when known.  Returns self on success."""
        for i, (node, dm, um) in enumerate(self.churn):
            if node < 0 or (n is not None and node >= n):
                raise _err(f"churn[{i}] node {node} out of range for a "
                           f"{n}-node network")
            if not 0 <= dm < um:
                raise _err(
                    f"churn[{i}] window [{dm}, {um}) is malformed: needs "
                    "0 <= down_ms < up_ms (use up_ms past the simulated "
                    "span for a crash that never recovers)")
        by_node: dict = {}
        for i, (node, dm, um) in enumerate(self.churn):
            by_node.setdefault(node, []).append((dm, um, i))
        for node, wins in by_node.items():
            wins.sort()
            for (d0, u0, i0), (d1, u1, i1) in zip(wins, wins[1:]):
                if d1 < u0:
                    raise _err(
                        f"churn[{i0}] and churn[{i1}] overlap on node "
                        f"{node} ([{d0}, {u0}) vs [{d1}, {u1})): one "
                        "outage per node at a time. Fix: merge them "
                        "into one window")
        for i, (s, e, pid, lo, hi) in enumerate(self.partitions):
            if not 0 <= s < e:
                raise _err(f"partitions[{i}] window [{s}, {e}) is "
                           "malformed: needs 0 <= start_ms < end_ms")
            if pid < 1:
                raise _err(
                    f"partitions[{i}] part_id {pid} is reserved: 0 is "
                    "the global partition every healed node returns to "
                    "(the reference's endPartition). Fix: use "
                    "part_id >= 1")
            if not (0 <= lo < hi and (n is None or hi <= n)):
                raise _err(f"partitions[{i}] node range [{lo}, {hi}) is "
                           f"malformed for a {n}-node network: needs "
                           "0 <= lo < hi <= n")
        for i, a in enumerate(self.partitions):
            for j in range(i + 1, len(self.partitions)):
                b = self.partitions[j]
                t_overlap = a[0] < b[1] and b[0] < a[1]
                r_overlap = a[3] < b[4] and b[3] < a[4]
                if t_overlap and r_overlap:
                    raise _err(
                        f"partitions[{i}] and partitions[{j}] overlap "
                        f"(times [{a[0]}, {a[1]}) vs [{b[0]}, {b[1]}), "
                        f"nodes [{a[3]}, {a[4]}) vs [{b[3]}, {b[4]})): "
                        "a node can live in ONE partition at a time. "
                        "Fix: split the windows so no node is claimed "
                        "twice, or merge them into one window")
        for kind in ("loss", "delay"):
            label = "permille" if kind == "loss" else "extra_ms"
            for i, (s, e, val, slo, shi, dlo, dhi) in enumerate(
                    getattr(self, kind)):
                if not 0 <= s < e:
                    raise _err(f"{kind}[{i}] window [{s}, {e}) is "
                               "malformed: needs 0 <= start_ms < end_ms")
                if kind == "loss" and not 0 <= val <= 1000:
                    raise _err(f"loss[{i}] permille {val} out of range "
                               "[0, 1000] (1000 = every matching "
                               "unicast lost)")
                if kind == "delay" and val < 0:
                    raise _err(f"delay[{i}] extra_ms {val} must be >= 0")
                for which, (rlo, rhi) in (("src", (slo, shi)),
                                          ("dst", (dlo, dhi))):
                    if not (0 <= rlo < rhi and (n is None or rhi <= n)):
                        raise _err(
                            f"{kind}[{i}] {which} range [{rlo}, {rhi}) "
                            f"is malformed for a {n}-node network: "
                            "needs 0 <= lo < hi <= n")
        if sim_ms is not None:
            for name in FIELDS:
                for i, ev in enumerate(getattr(self, name)):
                    start = ev[1] if name == "churn" else ev[0]
                    if start >= sim_ms:
                        raise _err(
                            f"{name}[{i}] starts at ms {start}, outside "
                            f"the simulated span [0, {sim_ms}): the "
                            "fault would never fire. Fix: move it into "
                            "the span or extend sim_ms")
        return self

    # ----------------------------------------------------- serialization

    def to_json(self) -> dict:
        """JSON form (lists of lists) — the `ScenarioSpec.fault_schedule`
        field's wire shape; omits empty fault classes for a compact
        canonical form."""
        return {name: [list(ev) for ev in getattr(self, name)]
                for name in FIELDS if getattr(self, name)}

    @classmethod
    def from_json(cls, data) -> "FaultSchedule":
        """Inverse of `to_json` (dict or JSON string).  Unknown keys are
        refused with the known field list — a typo'd fault class
        silently dropped would run a different adversity than the
        requester meant."""
        import json as _json

        if isinstance(data, (str, bytes)):
            data = _json.loads(data)
        if not isinstance(data, dict):
            raise _err(f"expected a JSON object with keys from {FIELDS}, "
                       f"got {type(data).__name__}")
        unknown = set(data) - set(FIELDS)
        if unknown:
            raise _err(f"unknown fault class(es) {sorted(unknown)}; "
                       f"known: {FIELDS} — each maps to a list of "
                       f"{', '.join(_SHAPE[f] for f in FIELDS)} rows")
        # row normalization (incl. the non-iterable-row refusals) is
        # _norm's job in __post_init__ — pass values through verbatim
        return cls(**data)
