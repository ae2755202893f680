"""The sweep-grid subsystem of the port (the port of
`wittgenstein_tpu/matrix`): thousands of scenario cells,
compile-key-minimal scheduling, one comparable report.

  grid     — `SweepGrid`: a frozen, JSON-able declarative matrix that
             expands deterministically into cells with a stable
             `grid_digest()` (the JAX package's digests);
  planner  — `plan()`: validate every cell, group by `compile_key()`,
             order groups largest-first;
  driver   — `run_grid()`: groups through the port's serve `Scheduler`
             (coalescing, retry/degradation, checkpoint/resume, the
             memo fork seam) with per-cell ledger rows carrying the grid
             digest, or through a fleet of worker processes
             (`run_grid_fleet`); `verify_cell()` is the pinned-subset
             bit-identity oracle against sequential `Runner` runs;
  report   — `MatrixReport`: per-cell metrics + audit verdicts + impact
             deltas against each cell's fault-free twin, aggregated per
             axis, as ONE JSON artifact;
  search   — `run_search()`: adaptive boundary search over the grid — a
             `SearchSpec` (axis + predicate) compiles to a deterministic
             coarse-bracket + bisection probe plan whose probes fork
             from shared memo prefixes and join the ledger.

Surfaces: the `/w/matrix/*` routes of `server/http.py`, and the
command lines `python -m wittgenstein_tpu_torch.cli.matrix` and
`... cli.search` (the ports of `tools/matrix.py` and `tools/search.py`).
"""

from .driver import MatrixRun, pick_spot_cells, run_grid, verify_cell  # noqa: F401
from .grid import Axis, Cell, SweepGrid  # noqa: F401
from .planner import MatrixPlan, plan  # noqa: F401
from .report import MatrixReport  # noqa: F401
from .search import (SearchPlan, SearchReport, SearchRun,  # noqa: F401
                     SearchSpec, compile_search, run_search)

__all__ = ["SweepGrid", "Axis", "Cell", "MatrixPlan", "plan",
           "MatrixRun", "run_grid", "verify_cell", "pick_spot_cells",
           "MatrixReport", "SearchSpec", "SearchPlan", "SearchReport",
           "SearchRun", "compile_search", "run_search"]
