"""Snapshot-fork prefix planning — the port of
`wittgenstein_tpu/memo/prefix.py`: the same groups and fork points over
the port's `ScenarioSpec` and `matrix.plan`, and the chaos no-op gate
over the port's torch states; `matrix/driver.run_grid(memo=...)` and
`matrix/search.run_search` run the prefixes through the scheduler's
fork seam.

The memoization half of the fast-forward paper (PAPERS.md 2602.10615,
ROADMAP item 3): BFT-scale campaigns (2208.14745) sweep adversity —
attack timings, chaos windows, loss rates — over a base scenario, and
every cell of such a sweep resimulates an identical honest prefix
before its adversity opens.  This module makes that redundancy a
planned, audited artifact:

  `strip_adversity(spec)`     — the spec with `attack` and
      `fault_schedule` removed: the program every adverse sibling
      provably runs until its first window opens (the ChaosProtocol
      wrap is bitwise inert before any window — loss keeps
      probability 0, delay adds 0, churn/partition vectors match the
      entry state — and the FaultInjector perturbs nothing before
      `at_ms`), so the stripped spec's trajectory IS the shared prefix.
  `first_adversity_ms(spec)`  — the earliest simulated ms at which the
      spec's adversity can act (attack `at_ms`, the schedule's first
      churn/partition/loss/delay window start); None for a clean spec.
  `plan_prefixes(plan)`       — for a `MatrixPlan`, group cells whose
      ADVERSITY-STRIPPED specs are identical (same protocol, params,
      seeds, engine, K, chunking, obs, latency, partition, span — only
      the post-fork adversity differs), and give each group the longest
      chunk-aligned fork point `fork_ms <= min(first_adversity)`.  The
      campaign runner runs each group's `prefix_spec` (the stripped spec cut to
      `fork_ms`) ONCE through the serve scheduler and forks every cell
      from the restored state with the prefix's obs carries — a
      126-seed x 8-chaos-window grid then simulates the honest prefix
      8x fewer times.
  `chaos_noop_before_fork`    — the runtime soundness gate for
      state-mutating schedules (churn/partition): fork only when the
      window-entry fault write is a bitwise no-op on the forked state
      (and the protocol does not mutate liveness mid-prefix, so no-op
      at the fork boundary implies no-op at every earlier entry).  A
      veto falls back to the unforked path — never a wrong trajectory.

Bit-identity is the contract everywhere: a forked cell's final pytree
and stitched metrics/trace/audit artifacts equal an unforked sequential
`Runner` run's (tests/test_memo.py; `tools/memo.py` drives the
`first_divergence` bisector on any violation).
"""

from __future__ import annotations

import dataclasses

from ..serve.spec import ScenarioSpec

#: memo-prefix schema version (the checkpoint/table meta `prefix_digest`
#: readers key on it)
SCHEMA = 1


def strip_adversity(spec: ScenarioSpec) -> ScenarioSpec:
    """The spec with every post-fork adversity source removed (module
    docstring) — the program the honest prefix runs."""
    return dataclasses.replace(spec, attack=None, fault_schedule=None)


def first_adversity_ms(spec: ScenarioSpec):
    """Earliest simulated ms the spec's adversity can act, or None for
    a clean spec.  Window STARTS are what matter: before the first
    start the chaos wrap is bitwise inert (loss probability 0, delay
    +0, churn/partition vectors equal to the honest state — the
    `chaos_noop_before_fork` gate re-verifies the state-mutating
    classes on the actual forked state)."""
    starts = []
    if spec.attack is not None:
        starts.append(int(spec.attack["at_ms"]))
    if spec.fault_schedule is not None:
        from ..chaos import FaultSchedule
        fs = FaultSchedule.from_json(spec.fault_schedule)
        starts += [dm for _, dm, _ in fs.churn]
        starts += [s for s, *_ in fs.partitions]
        starts += [s for s, *_ in fs.loss]
        starts += [s for s, *_ in fs.delay]
    return min(starts) if starts else None


@dataclasses.dataclass(frozen=True)
class ForkGroup:
    """One shared honest prefix and the cells that fork from it."""

    #: the stripped spec cut to the fork point — what the campaign runs
    #: once (as-authored form: the serve provenance convention)
    prefix_spec: ScenarioSpec
    #: resolved compile key of the prefix program (build accounting)
    prefix_key: str
    #: registry builds the prefix needs if its key is new to the plan
    prefix_builds: int
    fork_ms: int                    # chunk-aligned fork point
    cells: tuple                    # cell ids forking from this prefix
    #: digest of the prefix spec (adversity stripped, span = fork) —
    #: the `forked_from` provenance every forked ledger row carries
    prefix_digest: str

    @property
    def fork_chunks(self) -> int:
        return self.fork_ms // self.prefix_spec.chunk_ms


@dataclasses.dataclass(frozen=True)
class ForkPlan:
    """Every plannable fork of a `MatrixPlan` + why the rest were not."""

    groups: tuple
    skipped: dict                   # strip digest -> human-readable why

    @property
    def predicted_chunks_saved(self) -> int:
        """Chunks of honest prefix the fork plan avoids resimulating
        (each group's prefix runs once instead of once per cell) — the
        number the campaign runner's reported `prefix_chunks_saved` must match
        on a veto-free, table-cold run (the acceptance pin)."""
        return sum((len(g.cells) - 1) * g.fork_chunks
                   for g in self.groups)

    def by_cell(self) -> dict:
        return {cid: g for g in self.groups for cid in g.cells}


def plan_prefixes(mplan, min_cells: int = 2, done_ids=(),
                  include_singles: bool = False) -> ForkPlan:
    """Fork plan for a `MatrixPlan` (module docstring).  `done_ids`
    excludes already-served cells (campaign resume); groups smaller
    than `min_cells` are skipped unless `include_singles` (a cross-run
    memo table makes even a singleton's prefix worth keeping)."""
    from ..matrix.planner import _builds_per_key

    done = set(done_ids)
    by_strip: dict = {}
    order: list = []
    for cell in mplan.cells:
        if cell.id in done:
            continue
        stripped = strip_adversity(cell.spec)
        key = stripped.digest()
        if key not in by_strip:
            by_strip[key] = {"strip": stripped, "cells": [], "adv": []}
            order.append(key)
        by_strip[key]["cells"].append(cell.id)
        by_strip[key]["adv"].append(
            first_adversity_ms(mplan.resolved[cell.id]))
    groups, skipped = [], {}
    floor = 1 if include_singles else int(min_cells)
    for key in order:
        rec = by_strip[key]
        chunk = int(rec["strip"].chunk_ms)
        bounds = [a for a in rec["adv"] if a is not None]
        if not bounds:
            skipped[key] = ("no adversity to strip — the cells already "
                            "share a compile-key group end to end")
            continue
        if len(rec["cells"]) < floor:
            skipped[key] = (f"only {len(rec['cells'])} cell(s) share "
                            "this honest prefix — nothing to dedup "
                            "(a memo table makes singletons reusable "
                            "across runs)")
            continue
        fork_ms = (min(bounds) // chunk) * chunk
        if fork_ms < chunk:
            skipped[key] = (f"adversity opens at ms {min(bounds)}, "
                            "inside the first chunk — no chunk-aligned "
                            "honest prefix exists")
            continue
        prefix_spec = dataclasses.replace(rec["strip"], sim_ms=fork_ms)
        try:
            resolved = prefix_spec.validate()
        except ValueError as e:     # belt and braces: the stripped
            # spec is strictly more permissive than its cells', which
            # the planner already validated
            skipped[key] = f"prefix spec fails validation: {e}"
            continue
        groups.append(ForkGroup(
            prefix_spec=prefix_spec, prefix_key=resolved.compile_key(),
            prefix_builds=_builds_per_key(resolved), fork_ms=fork_ms,
            cells=tuple(rec["cells"]),
            prefix_digest=prefix_spec.digest()))
    return ForkPlan(groups=tuple(groups), skipped=skipped)


def chaos_noop_before_fork(rspec: ScenarioSpec, state, fork_ms: int) \
        -> bool:
    """Runtime soundness gate for forking under a state-mutating
    schedule (module docstring; wittgenstein_tpu/memo/prefix.py:
    182-212).  `state` is the prefix's final (net, pstate) with the
    lane/seed axis leading; `rspec` the RESOLVED cell spec whose chaos
    wrap will run the suffix.  True iff applying the cell's window-entry
    faults at ``fork_ms - 1`` is a bitwise no-op on the forked state
    (every leaf of the net equal), PROVIDED the protocol does not mutate
    liveness itself.  The cell's protocol is built on the state's
    device."""
    if rspec.fault_schedule is None:
        return True
    from ..chaos import FaultSchedule
    fs = FaultSchedule.from_json(rspec.fault_schedule)
    if not fs.mutates_state:
        return True                 # loss/delay act on emitted outboxes
    import torch
    from torch.utils import _pytree as pytree
    net = state[0]
    proto = rspec.build_protocol(device=net.time.device)
    if getattr(proto, "mutates_liveness", False):
        return False
    mutated = proto.apply_faults(net, int(fork_ms) - 1)
    return all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(net), pytree.tree_leaves(mutated)))
