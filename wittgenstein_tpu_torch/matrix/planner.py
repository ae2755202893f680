"""Compile-key-minimal planning — a copy of
`wittgenstein_tpu/matrix/planner.py` over the port's `SweepGrid` and
`ScenarioSpec` (`run_grid`, which runs a plan, waits for ROADMAP.md A14).

`plan(grid)` expands the grid, VALIDATES every cell (the full
refusal-with-remedy `ScenarioSpec.validate` pass, so every config
error in a thousand-cell campaign surfaces here — the CLI's exit-2 /
HTTP-400 boundary — before anything compiles), then groups cells by
`compile_key()` and orders the groups largest-first.  The campaign runner runs
groups CONTIGUOUSLY: each compiled program is built exactly once,
serves its whole group (the serve scheduler coalesces the group's
cells into vmapped seed-batched launches), and is never re-entered —
so total program builds == the plan's `expected_builds`, which the
campaign runner asserts against the registry's miss counter.

Accounting vocabulary (what "compiles" means here, consistently with
tests/test_serve.py's registry pins): `planned_compiles` counts
distinct compile KEYS — distinct chunk programs at the spec level;
`expected_builds` counts registry program builds, i.e. one per
(compile key, obs plane) pair the scheduler will request (the primary
pass plus one shadow per extra plane).
"""

from __future__ import annotations

import dataclasses

from .grid import SweepGrid


def _builds_per_key(spec) -> int:
    """Registry builds the scheduler requests for one group: the
    primary program (metrics when captured, else the plain engine)
    plus one shadow program per remaining obs plane — mirrors
    `Scheduler._run_group`'s primary/shadow split."""
    planes = list(spec.obs)
    return 1 + len(planes) - (1 if "metrics" in planes else 0)


@dataclasses.dataclass(frozen=True)
class Group:
    """One compile-key group: the cells one compiled program serves."""

    compile_key: str
    cells: tuple                    # Cell objects, grid expansion order
    builds: int                     # registry programs this group needs


@dataclasses.dataclass(frozen=True)
class MatrixPlan:
    grid: SweepGrid
    grid_digest: str
    cells: tuple                    # every included cell, expansion order
    groups: tuple                   # largest-first, ties by key
    #: resolved specs by cell id (validate() output — superstep an int)
    resolved: dict

    @property
    def planned_compiles(self) -> int:
        """Distinct compile keys == distinct chunk programs."""
        return len(self.groups)

    @property
    def expected_builds(self) -> int:
        """Registry program builds a cold run performs (see module
        docstring for the compiles-vs-builds vocabulary)."""
        return sum(g.builds for g in self.groups)

    def summary(self) -> dict:
        return {"grid_digest": self.grid_digest,
                "cells": len(self.cells),
                "planned_compiles": self.planned_compiles,
                "expected_builds": self.expected_builds,
                "largest_group": max(len(g.cells) for g in self.groups)}

    def remaining(self, done_ids) -> tuple:
        """The RE-PLAN of a resumed campaign: the same groups in the
        same largest-first order, each narrowed to the cells NOT in
        `done_ids` (cells already served from ledger rows or requeued
        from a group checkpoint); emptied groups drop out.  Build
        accounting stays honest — a group with any live cell still
        needs its full (key, plane) program set, a fully-served group
        needs none."""
        done = set(done_ids)
        out = []
        for g in self.groups:
            live = tuple(c for c in g.cells if c.id not in done)
            if live:
                out.append(Group(compile_key=g.compile_key, cells=live,
                                 builds=g.builds))
        return tuple(out)


def plan(grid: SweepGrid) -> MatrixPlan:
    """Expand + validate + group (module docstring).  Raises
    ValueError with the offending cell id on any malformed cell."""
    cells = grid.expand()
    resolved = {}
    by_key: dict = {}
    order: list = []
    for cell in cells:
        try:
            rspec = cell.spec.validate()
        except ValueError as e:
            raise ValueError(f"SweepGrid: cell {cell.id!r}: {e}") \
                from None
        resolved[cell.id] = rspec
        key = rspec.compile_key()
        if key not in by_key:
            by_key[key] = []
            order.append(key)
        by_key[key].append(cell)
    groups = [Group(compile_key=k, cells=tuple(by_key[k]),
                    builds=_builds_per_key(resolved[by_key[k][0].id]))
              for k in order]
    # largest-first, stable: the widest coalesced program starts
    # amortizing immediately; ties keep first-appearance order so the
    # plan is a pure function of the grid
    groups.sort(key=lambda g: (-len(g.cells), order.index(g.compile_key)))
    return MatrixPlan(grid=grid, grid_digest=grid.grid_digest(),
                      cells=tuple(cells), groups=tuple(groups),
                      resolved=resolved)
