"""The sweep-grid subsystem of the port, its planning half: `SweepGrid`
(`grid.py`: a frozen, JSON-able scenario matrix that expands
deterministically into cells, with a stable `grid_digest()`) and
`plan()` (`planner.py`: validate every cell, group by compile key,
largest group first).  The campaign runner (`run_grid`), report and
search wait for ROADMAP.md A14."""

from .grid import Axis, Cell, SweepGrid  # noqa: F401
from .planner import MatrixPlan, plan  # noqa: F401

__all__ = ["SweepGrid", "Axis", "Cell", "MatrixPlan", "plan"]
