"""The chaos plane of the port (the port of `wittgenstein_tpu/chaos`):
declarative fault schedules run by every engine variant.

  FaultSchedule  — adversity as data: node crash/recover churn,
                   mid-run partition/heal windows, per-link message
                   loss and delay inflation, all bit-deterministic
                   from (schedule, seed) (chaos/schedule.py, a copy of
                   the JAX package's);
  ChaosProtocol  — the protocol proxy that carries a schedule into the
                   dense, superstep-K, seed-folded and fast-forward
                   engines through the window-entry `apply_faults` hook
                   and the per-ms outbox adversary (chaos/wrap.py).

`serve.ScenarioSpec.fault_schedule` carries schedules in a spec.  Not
ported yet: the sharded engine's half and `tools/chaos.py` (ROADMAP.md
A14, A15).
"""

from .schedule import FaultSchedule
from .wrap import ChaosProtocol, impact_summary

__all__ = ["FaultSchedule", "ChaosProtocol", "impact_summary"]
