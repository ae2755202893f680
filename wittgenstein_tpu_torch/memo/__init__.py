"""The memo plane of the port (the port of `wittgenstein_tpu/memo`),
its planning and synthesis half:

  prefix — snapshot-fork planning: `plan_prefixes` groups the cells of
           a `matrix.plan` whose adversity-stripped specs are equal and
           gives each group its chunk-aligned fork point;
           `chaos_noop_before_fork` is the runtime soundness gate;
  freeze — fixed-point lane freezing: `build_probe` (the per-run
           `next_work` oracle), `frozen_final` (`_jump` over the quiet
           tail) and `frozen_carries` (the tail's metrics, audit and
           trace carries synthesized on the host);
  table  — `MemoTable`, the content-addressed on-disk store of
           completed prefixes (the JAX package's key and layout).

The acceptance bar is bit-identity: a frozen lane's final state and
carries equal stepping its quiet chunks (tests/test_torch_memo.py).
The scheduler's fork seam and `_freeze_pass`, and `run_grid(memo=...)`,
wait for the port's scheduler (ROADMAP.md A14).  `MemoConfig` is the
campaign runner's knob bundle (`run_grid(memo=...)`).
"""

from __future__ import annotations

import dataclasses

from .freeze import (FREEZE_ENGINES, build_probe,  # noqa: F401
                     freeze_supported, frozen_carries, frozen_final)
from .prefix import (ForkGroup, ForkPlan,  # noqa: F401
                     chaos_noop_before_fork, first_adversity_ms,
                     plan_prefixes, strip_adversity)
from .table import MemoTable  # noqa: F401


@dataclasses.dataclass(frozen=True)
class MemoConfig:
    """The campaign runner's memo knobs (``run_grid(memo=...)``)."""

    #: snapshot-fork shared honest prefixes (prefix.py)
    fork: bool = True
    #: minimum cells sharing a prefix before an IN-RUN fork pays for
    #: itself; a configured table keeps singletons too (cross-run value)
    min_cells: int = 2
    #: cross-run memo table directory (None = in-run memoization only)
    table: object = None

    @classmethod
    def coerce(cls, memo) -> "MemoConfig":
        """``True`` / dict / MemoConfig -> MemoConfig."""
        if isinstance(memo, cls):
            return memo
        if memo is True:
            return cls()
        if isinstance(memo, dict):
            return cls(**memo)
        raise ValueError(f"memo must be True, a dict of MemoConfig "
                         f"fields, or a MemoConfig; got {memo!r}")

    def open_table(self) -> MemoTable | None:
        if self.table is None:
            return None
        return self.table if isinstance(self.table, MemoTable) \
            else MemoTable(self.table)


__all__ = ["MemoConfig", "MemoTable", "ForkGroup", "ForkPlan",
           "plan_prefixes", "strip_adversity", "first_adversity_ms",
           "chaos_noop_before_fork", "FREEZE_ENGINES", "build_probe",
           "freeze_supported", "frozen_carries", "frozen_final"]
