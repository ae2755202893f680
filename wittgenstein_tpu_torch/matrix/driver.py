"""The matrix campaign runner: a planned grid through the serve `Scheduler` — the
port of `wittgenstein_tpu/matrix/driver.py` over the port's scheduler,
its report rows, ledger rows and journal entries the JAX package's.
Every cell runs on the scheduler's device (``cuda`` unless the caller
builds the scheduler, or passes ``device=``, otherwise), through the
engine and its kernels.

Groups run CONTIGUOUSLY in plan order; within a group, cells are
submitted in waves of at most `max_wave` cells and drained — every
wave after the first is a registry HIT (same compile key, seeds are
data), so the whole group runs on the programs the first wave built
while wave batching bounds the coalesced lane width (a thousand
single-seed cells never concatenate into one thousand-lane state).
Retry-with-backoff, batch-width degradation and chunk-boundary
checkpoint/resume all ride along for free — they are `Scheduler`
properties, not the runner's.

The runner ASSERTS the compile-key-minimal contract: with a cold
registry, program builds after the run must equal the plan's
`expected_builds` (one build per (compile key, obs plane) — see
planner.py's vocabulary note); a warm registry may only build fewer.
A violated assertion is a scheduling bug, raised loudly rather than
recorded.

Per-cell `RunManifest` ledger rows are labelled ``matrix:<cell id>``
and carry the grid digest + axis labels in `extra`, so a sweep's
provenance is one ``grep grid_digest`` over the ledger.
"""

from __future__ import annotations

import dataclasses
import time

from ..serve.scheduler import Scheduler
from .grid import SweepGrid
from .planner import MatrixPlan, plan
from .report import MatrixReport


@dataclasses.dataclass
class MatrixRun:
    """One grid run: the report artifact plus the in-memory per-cell
    products the artifact deliberately leaves out (full obs blocks,
    kept final states for bit-identity verification)."""

    report: MatrixReport
    artifacts: dict                 # cell id -> scheduler artifacts
    states: dict                    # cell id -> final (net, ps) slices
    requests: dict                  # cell id -> request id


def _drain(sch: Scheduler, rids: list, poll_s: float = 0.05):
    """Drive the scheduler until every request settles.  `run_pending`
    is single-drainer (a concurrent service worker may own the drain);
    polling statuses instead of trusting our own processed count keeps
    the runner correct in both in-process and service-threaded use."""
    ins = getattr(sch, "_ins", None)
    t0 = 0.0 if ins is None else ins.now()
    while True:
        sch.run_pending()
        statuses = []
        for rid in rids:
            req = sch.peek(rid)
            # evicted == already-done (keep_done retention bound)
            statuses.append("done" if req is None else req.status)
        if all(s in ("done", "error") for s in statuses):
            if ins is not None:
                from ..serve.instrument import GRID_DRAIN
                ins.end(GRID_DRAIN, t0, n=len(rids))
            return
        time.sleep(poll_s)


def _harvest(sch: Scheduler, pairs, results, artifacts, states,
             keep_all, keep) -> int:
    """Pull settled requests into the per-cell result tables
    (IMMEDIATELY after each drain: the scheduler's keep_done eviction
    may drop finished records once later waves pile up).  Returns the
    number of cells done."""
    ins = getattr(sch, "_ins", None)
    t0 = 0.0 if ins is None else ins.now()
    done = 0
    for cell, rid in pairs:
        req = sch.peek(rid)
        if req is None:
            results[cell.id] = {
                "status": "error",
                "error": "request evicted before harvest "
                         "(raise Scheduler keep_done above max_wave)"}
            continue
        if req.status == "done":
            results[cell.id] = {"status": "done",
                                "artifacts": req.artifacts}
            artifacts[cell.id] = req.artifacts
            if keep_all or cell.id in keep:
                states[cell.id] = req.final_state
            done += 1
        else:
            results[cell.id] = {"status": "error",
                                "error": req.error or req.status}
    if ins is not None:
        from ..serve.instrument import GRID_HARVEST
        ins.end(GRID_HARVEST, t0, n=len(pairs), done=done)
    return done


def _row_artifacts(row) -> dict:
    """Rebuild the artifact subset a `MatrixReport` cell row needs
    from a finished cell's `RunManifest` ledger row (the durable
    completion facts `Scheduler._finalize` rides in `extra`).  The
    resulting report row is IDENTICAL to the live run's — summary,
    audit verdict/violations and the time_to_done headline were all
    computed once at finalize from the same blocks."""
    ex = row.extra or {}
    art = {"summary": dict(ex["summary"]), "from_ledger": True,
           "ledger_row": row.run}
    if row.audit_clean is not None:
        art["audit"] = {"clean": bool(row.audit_clean),
                        "violations": dict(ex.get("violations", {}))}
    if ex.get("time_to_done_ms") is not None:
        art["time_to_done_ms"] = int(ex["time_to_done_ms"])
    if ex.get("forked_from"):
        # fork provenance survives the ledger round trip, so a resumed
        # campaign's report rows stay identical to the live run's
        art["forked_from"] = dict(ex["forked_from"])
    return art


def _load_resume(plan_: MatrixPlan, sch: Scheduler, ledger_path):
    """The campaign-resume join (run_grid(resume=True)): per-group
    checkpoints re-enqueued through `Scheduler.resume_checkpoints`
    (spec digests verified file-side), the scheduler's durable
    submission journal replayed through `Scheduler.resume_journal`
    (queued-but-never-launched cells survive the kill too), plus
    finished-cell ledger rows keyed on the grid digest — and, for
    cells not in THIS grid's rows, a cross-grid dedup by exact config
    digest.  Returns ``(served, pre, counts)``: ledger-served results
    by cell id, checkpoint/journal-requeued (cell, rid) pairs, and the
    resume accounting.  Refuses LOUDLY (ValueError with remedy) on
    checkpoints from a different grid or cells whose spec no longer
    digests to the checkpointed one — silently mixing trajectories of
    two different campaigns is the one thing resume must never do."""
    from ..obs import ledger as ledger_mod

    cells_by_id = {c.id: c for c in plan_.cells}
    rids = sch.resume_checkpoints()
    # mid-flight MEMO PREFIX checkpoints are withdrawn, not resumed:
    # the killed process took the prefix's pre-crash obs carries with
    # it, and a prefix resumed without them could not stitch full-span
    # artifacts for its forked cells — the prefix re-runs (or table-
    # hits) instead, which is cheap relative to the campaign it saves
    prefix_rids = [rid for rid in rids
                   if (sch.request(rid).ledger_extra or {}
                       ).get("memo_prefix")]
    if prefix_rids:
        drop_keys = set()
        for rid in prefix_rids:
            req = sch.request(rid)
            if (req.ledger_extra or {}).get("grid_digest") \
                    == plan_.grid_digest:
                # only this grid's prefix files are discarded — a
                # foreign campaign's checkpoint stays for ITS resume
                drop_keys.add(req.compile_key)
        sch.withdraw(prefix_rids)
        for key in drop_keys:
            sch.discard_checkpoint(key)
        rids = [rid for rid in rids if rid not in set(prefix_rids)]
    # the durable submission journal: cells that were ACCEPTED but
    # never launched (no checkpoint, no ledger row) replay here —
    # entries a checkpoint already restored are skipped by rid inside
    # resume_journal.  This grid's replayed CELLS are adopted below
    # exactly like checkpoint-requeued ones (they re-run their full
    # span from scratch, bit-identically); replayed memo-PREFIX
    # entries are withdrawn (the fork machinery re-runs or table-hits
    # them); entries from OTHER campaigns stay queued — they are that
    # campaign's durable submits, and the drain completes them with
    # their own ledger rows.
    journal_rids = sch.resume_journal()
    adopt, foreign = [], 0
    for rid in journal_rids:
        ex = sch.request(rid).ledger_extra or {}
        if ex.get("grid_digest") == plan_.grid_digest:
            if ex.get("memo_prefix"):
                sch.withdraw([rid])
            else:
                adopt.append(rid)
        else:
            foreign += 1
    if foreign:
        import sys
        print(f"matrix resume: {foreign} journal-replayed request(s) "
              "belong to other campaigns; left queued for their own "
              "resume/drain", file=sys.stderr)
    rids = rids + adopt
    pre = []
    try:
        for rid in rids:
            req = sch.request(rid)
            ex = req.ledger_extra or {}
            cid = ex.get("cell")
            if ex.get("grid_digest") != plan_.grid_digest \
                    or cid not in cells_by_id:
                raise ValueError(
                    f"matrix resume: checkpoint request {rid} belongs "
                    f"to grid {ex.get('grid_digest')!r} / cell "
                    f"{cid!r}, not this grid ({plan_.grid_digest}). "
                    "Fix: point --checkpoint-dir at the directory "
                    "this grid's interrupted run used, or delete the "
                    "stale checkpoints to restart those groups from "
                    "scratch")
            want = cells_by_id[cid].spec.digest()
            got = (req.requested or req.spec).digest()
            if got != want:
                raise ValueError(
                    f"matrix resume: cell {cid!r} now digests to "
                    f"{want} but its checkpoint was written for {got} "
                    "— the spec was edited since the interrupted run. "
                    "Fix: restore the original grid, or delete the "
                    "stale checkpoint to re-run the cell under the "
                    "new spec")
            pre.append((cells_by_id[cid], rid))
    except ValueError:
        # roll back EVERY re-enqueued request before refusing: on a
        # shared scheduler, valid earlier files' requests left queued
        # would run with no harvester (wasted device time + surprise
        # ledger rows)
        sch.withdraw(rids)
        raise
    requeued = {c.id for c, _ in pre}
    by_cell: dict = {}
    by_digest: dict = {}
    for row in ledger_mod.read_all(ledger_path):
        ex = row.extra or {}
        if "summary" not in ex or row.audit_clean is False:
            continue        # unclean / summary-less rows cannot serve cells
        if ex.get("grid_digest") == plan_.grid_digest and ex.get("cell"):
            by_cell[ex["cell"]] = row
        by_digest.setdefault(row.config_digest, row)
    served: dict = {}
    counts = {"from_ledger": 0, "deduped": 0,
              "resumed_requests": len(pre),
              "journal_replayed": len(adopt)}
    for cell in plan_.cells:
        if cell.id in requeued:
            continue        # mid-flight, not finished — must re-run
        dig = cell.spec.digest()
        row, dedup = by_cell.get(cell.id), False
        if row is not None and row.config_digest != dig:
            row = None      # same id, edited spec: never serve stale
        if row is None:
            row, dedup = by_digest.get(dig), True
        if row is None:
            continue
        served[cell.id] = {"status": "done",
                           "artifacts": _row_artifacts(row)}
        counts["deduped" if dedup else "from_ledger"] += 1
    return served, pre, counts


def _run_prefixes(sch: Scheduler, plan_: MatrixPlan, fplan, table,
                  stats: dict, max_wave: int) -> dict:
    """The memo fork phase: run (or table-load) every fork group's
    honest prefix ONCE through the scheduler, then hand each cell its
    `ForkState` (state + obs carries + fork point + prefix digest).
    Prefix requests coalesce among themselves like any other same-key
    submissions; waves bound how many finished prefix states sit in
    the scheduler's done table at once (its keep_done eviction must
    never race the harvest).  Returns ``{cell id: ForkState}``."""
    forks: dict = {}
    run_groups = []
    for fg in fplan.groups:
        chunk = fg.prefix_spec.chunk_ms
        if table is not None:
            hit = table.get(fg.prefix_spec, device=sch.device)
            if hit is not None:
                state, carries = hit
                stats["table_hits"] += 1
                served = _assign_forks(forks, fg, plan_, state, carries,
                                       stats)
                stats["prefix_chunks_saved"] += \
                    served * (fg.fork_ms // chunk)
                continue
        run_groups.append(fg)
    for lo in range(0, len(run_groups), max_wave):
        wave = run_groups[lo:lo + max_wave]
        pending = []
        for fg in wave:
            rid = sch.submit(
                fg.prefix_spec,
                label=f"memo:prefix:{fg.prefix_digest[:8]}",
                ledger_extra={"grid_digest": plan_.grid_digest,
                              "memo_prefix": fg.prefix_digest},
                keep_carries=True)
            pending.append((fg, rid))
        _drain(sch, [rid for _, rid in pending])
        for fg, rid in pending:
            req = sch.peek(rid)
            if req is None or req.status != "done":
                stats["prefix_failed"] += 1
                continue        # cells fall back to the unforked path
            stats["prefix_runs"] += 1
            chunk = fg.prefix_spec.chunk_ms
            state, carries = req.final_state, req.final_carries or {}
            if table is not None:
                table.put(fg.prefix_spec, state, carries)
            served = _assign_forks(forks, fg, plan_, state, carries,
                                   stats)
            # honest accounting: the prefix itself cost fork_chunks,
            # each forked cell saves them (a fully-vetoed group goes
            # NEGATIVE — the prefix ran for nothing)
            stats["prefix_chunks_saved"] += \
                (served - 1) * (fg.fork_ms // chunk)
    return forks


def _assign_forks(forks: dict, fg, plan_: MatrixPlan, state, carries,
                  stats: dict) -> int:
    """Hand one completed prefix to its cells, gated per cell by the
    runtime chaos-no-op soundness check (memo/prefix.py); a vetoed
    cell runs unforked.  Returns how many cells were forked."""
    from ..memo import chaos_noop_before_fork
    from ..serve.scheduler import ForkState

    served = 0
    for cid in fg.cells:
        if cid not in plan_.resolved:
            continue
        if not chaos_noop_before_fork(plan_.resolved[cid], state,
                                      fg.fork_ms):
            stats["fork_vetoed"] += 1
            continue
        forks[cid] = ForkState(
            state=state,
            carries={p: list(cs) for p, cs in carries.items()},
            at_ms=fg.fork_ms, prefix_digest=fg.prefix_digest)
        served += 1
    stats["forked_cells"] += served
    return served


def run_grid(grid: SweepGrid, scheduler: Scheduler | None = None,
             plan_: MatrixPlan | None = None, *, ledger_path=None,
             checkpoint_dir=None, journal_dir=None, max_wave: int = 64,
             keep_states=("*",), progress=None,
             strict_builds: bool = True,
             resume: bool = False, memo=None,
             workers: int | None = None, fleet_dir=None,
             fleet_opts: dict | None = None, device=None) -> MatrixRun:
    """Run every cell of `grid` (module docstring) and build the
    `MatrixReport`.

    keep_states — cell ids whose final (net, pstate) slices to retain
        for bit-identity verification ("*" keeps all; device memory
        scales with it, so thousand-cell campaigns pass a pinned
        subset).
    progress    — optional callback(dict) at every wave boundary:
        cells done/total, groups done, program builds so far, wall.
    strict_builds — raise when measured registry builds disagree with
        the plan (the compile-key-minimal contract).  The measurement
        is the registry's GLOBAL miss counter, so it can only be
        attributed to this run when the scheduler is ours alone; pass
        False when sharing a scheduler with concurrent traffic (the
        service's auto mode) — the report still records the measured
        delta, it just can't be an assertion there.
    resume      — end-to-end campaign resume: re-enqueue this grid's
        per-group checkpoints (the scheduler needs the interrupted
        run's `checkpoint_dir`), serve already-finished cells from
        their ledger rows (keyed on the grid digest; an exact config-
        digest match from ANOTHER grid is served too and counted as
        `deduped`), and re-plan only the unfinished cells.  Refuses
        loudly on spec/digest mismatches with stale checkpoints.  The
        resulting report's cell rows are bit-identical to an
        uninterrupted run's (tests/test_matrix.py kill-mid-campaign
        pin); the run-local accounting (wall, program_builds, the
        `resume` block) honestly differs.
    memo        — memoized supersteps (wittgenstein_tpu/memo; True, a
        `MemoConfig`, or a dict of its fields): cells differing only
        in post-fork adversity share ONE honest-prefix run and fork
        from its chunk-boundary state (+ obs carries), bit-identical
        to unforked runs; a configured `table` additionally reuses
        completed prefixes ACROSS runs (content-addressed on-disk
        store).  The report grows a `memo` block (prefix runs, table
        hits, `prefix_chunks_saved` — matching the fork plan's
        prediction on a veto-free cold-table run) and forked cell rows
        carry `forked_from` provenance.
    workers     — fleet mode: enqueue every cell into the
        shared fleet journal and complete the campaign with N worker
        PROCESSES over `fleet_dir` (serve/fleet.py's directory-sharing
        contract) instead of this process's scheduler.  Results come
        back through the shared-ledger join, so the report's cell rows
        are bit-identical to a single-process run's; final states stay
        in the worker processes (`MatrixRun.states` is empty — pass
        cells through `verify_cell` for verification).
        `fleet_opts` forwards run_grid_fleet keywords (lease_ttl_s,
        timeout_s, on_spawned, device, ...).
    device      — where a scheduler this call builds runs (``cuda``
        unless given); ignored with ``scheduler=``.
    """
    if workers is not None:
        if scheduler is not None or resume or memo:
            raise ValueError(
                "run_grid(workers=N) is a separate-process fleet: it "
                "cannot reuse an in-process scheduler, and resume/memo "
                "are single-process modes (the fleet serves finished "
                "cells from the shared ledger automatically). Fix: "
                "drop workers=, or drop scheduler=/resume=/memo=")
        if fleet_dir is None:
            raise ValueError(
                "run_grid(workers=N) needs fleet_dir= — the one shared "
                "directory every worker process derives journal/"
                "checkpoints/ledger paths from (serve.fleet_paths)")
        return run_grid_fleet(grid, plan_, fleet_dir=fleet_dir,
                              workers=workers, progress=progress,
                              **dict(fleet_opts or {}))
    plan_ = plan_ or plan(grid)
    sch = scheduler or Scheduler(ledger_path=ledger_path,
                                 checkpoint_dir=checkpoint_dir,
                                 journal_dir=journal_dir, device=device)
    keep_all = "*" in keep_states
    keep = set(keep_states)
    stats0 = sch.registry.stats()
    cold = stats0["entries"] == 0
    t0 = time.time()
    results: dict = {}
    artifacts: dict = {}
    states: dict = {}
    requests: dict = {}
    done_cells = 0
    resume_counts = None
    groups = plan_.groups
    expected_builds = plan_.expected_builds
    mcfg = table = None
    memo_stats = None
    forks: dict = {}
    if memo:
        from ..memo import MemoConfig
        mcfg = MemoConfig.coerce(memo)
        table = mcfg.open_table()
    if resume:
        served, pre, resume_counts = _load_resume(
            plan_, sch, ledger_path or sch.ledger_path)
        results.update(served)
        done_cells += len(served)
        # the resumed run's build CEILING: ledger-served groups never
        # compile; checkpoint-requeued groups do (during the pre-drain
        # below, inside this run's accounting window) and so stay in
        # the ceiling
        expected_builds = sum(
            g.builds for g in plan_.remaining(set(served)))
        # drive the checkpoint-requeued groups to completion first —
        # they re-enter mid-flight and harvest like any other cell
        if pre:
            requests.update({c.id: rid for c, rid in pre})
            _drain(sch, [rid for _, rid in pre])
            done_cells += _harvest(sch, pre, results, artifacts,
                                   states, keep_all, keep)
        groups = plan_.remaining(set(results))
    if mcfg is not None and mcfg.fork:
        from ..memo import plan_prefixes
        fplan = plan_prefixes(plan_, min_cells=mcfg.min_cells,
                              done_ids=set(results),
                              include_singles=table is not None)
        memo_stats = {"fork_groups": len(fplan.groups),
                      "predicted_chunks_saved":
                      fplan.predicted_chunks_saved,
                      "prefix_runs": 0, "prefix_failed": 0,
                      "table_hits": 0, "forked_cells": 0,
                      "fork_vetoed": 0, "prefix_chunks_saved": 0}
        # build-accounting ceiling: a prefix whose compile key is new
        # to the plan (no clean sibling in the grid) adds its own
        # program builds; a prefix sharing a plan key just performs
        # that group's builds EARLY (the group then registry-hits)
        plan_keys = {g.compile_key for g in groups}
        seen = set()
        for fg in fplan.groups:
            if fg.prefix_key not in plan_keys \
                    and fg.prefix_key not in seen:
                seen.add(fg.prefix_key)
                expected_builds += fg.prefix_builds
        forks = _run_prefixes(sch, plan_, fplan, table, memo_stats,
                              max_wave)
        if table is not None:
            memo_stats["table"] = table.stats()
    ins = getattr(sch, "_ins", None)
    for gi, group in enumerate(groups):
        cells = list(group.cells)
        for lo in range(0, len(cells), max_wave):
            wave = cells[lo:lo + max_wave]
            t_sub = 0.0 if ins is None else ins.now()
            rids = []
            for cell in wave:
                try:
                    # the AS-AUTHORED cell spec, not the resolved one:
                    # provenance digests what the grid requested (the
                    # serve convention); submit re-validates cheaply
                    rid = sch.submit(
                        cell.spec,
                        label=f"matrix:{cell.id}",
                        ledger_extra={"grid_digest": plan_.grid_digest,
                                      "cell": cell.id,
                                      "axes": dict(cell.labels)},
                        fork=forks.get(cell.id))
                except ValueError as e:     # plan validated; belt and
                    # braces for env drift between plan and run
                    results[cell.id] = {"status": "error",
                                        "error": str(e)}
                    continue
                requests[cell.id] = rid
                rids.append((cell, rid))
            if ins is not None:
                from ..serve.instrument import GRID_SUBMIT
                ins.end(GRID_SUBMIT, t_sub, key=group.compile_key,
                        n=len(rids))
            _drain(sch, [rid for _, rid in rids])
            done_cells += _harvest(sch, rids, results, artifacts,
                                   states, keep_all, keep)
            if progress is not None:
                reg = sch.registry.stats()
                progress({"done": done_cells,
                          "total": len(plan_.cells),
                          "errors": sum(1 for r in results.values()
                                        if r["status"] == "error"),
                          "groups_done": gi + (1 if lo + max_wave >=
                                               len(cells) else 0),
                          "groups_total": len(groups),
                          "planned_compiles": plan_.planned_compiles,
                          "program_builds": reg["misses"]
                          - stats0["misses"],
                          "wall_s": round(time.time() - t0, 3)})
    wall = time.time() - t0
    reg = sch.registry.stats()
    builds = reg["misses"] - stats0["misses"]
    # the compile-key-minimal contract, ASSERTED (module docstring).
    # An errored cell may legitimately leave its group's programs
    # unbuilt (builds < expected), so the exact-equality check only
    # applies to fully-clean cold runs — errored cells are the
    # report's/CLI's exit-1 story, not a scheduling bug.  A resumed
    # run asserts only the CEILING, but against its narrowed
    # expected_builds (live + checkpoint-requeued groups): a served
    # group that somehow re-compiles is a scheduling bug there too.
    clean = all(r["status"] == "done" for r in results.values())
    # a memo-table hit or a failed prefix legitimately leaves prefix
    # programs unbuilt: the exact-equality contract only applies when
    # every planned program (cells + prefixes) actually ran cold
    memo_partial = bool(memo_stats) and (
        memo_stats["table_hits"] or memo_stats["prefix_failed"])
    if strict_builds and cold and clean and not resume \
            and not memo_partial and builds != expected_builds:
        raise RuntimeError(
            f"matrix: compile-key-minimal contract violated — "
            f"{builds} program builds for {expected_builds} "
            f"expected ({plan_.planned_compiles} distinct compile "
            "keys); a group was re-built mid-run")
    if strict_builds and builds > expected_builds:
        raise RuntimeError(
            f"matrix: {builds} program builds exceed the "
            f"{'resume-narrowed ' if resume else ''}expected "
            f"{expected_builds} even on a warm registry")
    report = MatrixReport.build(
        plan_, results, wall_s=wall,
        compiles={"program_builds": builds,
                  "distinct_compile_keys": plan_.planned_compiles,
                  "registry": reg},
        scheduler_stats=sch.resilience,
        resume=resume_counts, memo=memo_stats)
    return MatrixRun(report=report, artifacts=artifacts, states=states,
                     requests=requests)


# ------------------------------------------------------------ fleet mode


def _fleet_join(plan_: MatrixPlan, ledger_path):
    """One scan of the shared ledger -> ``(by_cell, by_digest)`` clean
    summary-bearing rows (the `_load_resume` join, re-read every poll
    because worker processes append concurrently)."""
    from ..obs import ledger as ledger_mod

    by_cell: dict = {}
    by_digest: dict = {}
    for row in ledger_mod.read_all(ledger_path):
        ex = row.extra or {}
        if "summary" not in ex or row.audit_clean is False:
            continue
        if ex.get("grid_digest") == plan_.grid_digest and ex.get("cell"):
            by_cell.setdefault(ex["cell"], row)
        by_digest.setdefault(row.config_digest, row)
    return by_cell, by_digest


def fleet_enqueue(plan_: MatrixPlan, fleet_dir) -> dict:
    """Append one durable journal entry per not-yet-finished cell of
    the grid (fsync'd submit rows — the fleet's shared work queue) and
    return ``{cell id: rid}`` for the cells enqueued.  Cells already
    served by a clean ledger row, or already live in the journal from
    an interrupted fleet run of the SAME grid, are skipped — re-running
    a campaign over an existing fleet directory resumes it."""
    import uuid

    from ..serve.fleet import fleet_paths
    from ..serve.journal import SubmissionJournal

    paths = fleet_paths(fleet_dir)
    journal = SubmissionJournal(paths["journal_dir"])
    by_cell, by_digest = _fleet_join(plan_, paths["ledger_path"])
    live = {}
    for e in journal.replay():
        ex = e.get("ledger_extra") or {}
        if ex.get("grid_digest") == plan_.grid_digest and ex.get("cell"):
            live[ex["cell"]] = e["rid"]
    nonce = uuid.uuid4().hex[:8]
    rids = {}
    for i, cell in enumerate(plan_.cells):
        if cell.id in by_cell or cell.spec.digest() in by_digest:
            continue                    # the row IS the result
        if cell.id in live:
            rids[cell.id] = live[cell.id]
            continue                    # survivor of an interrupted run
        rid = f"mx{nonce}-{i:04d}"
        journal.record_submit(
            rid, cell.spec, label=f"matrix:{cell.id}",
            ledger_extra={"grid_digest": plan_.grid_digest,
                          "cell": cell.id, "axes": dict(cell.labels)})
        rids[cell.id] = rid
    return rids


def fleet_wait(plan_: MatrixPlan, fleet_dir, *, procs=(),
               timeout_s: float = 900.0, poll_s: float = 0.5,
               progress=None) -> dict:
    """Poll the shared ledger until every cell of the grid has a clean
    row (or a quarantine tombstone), building the per-cell results
    table.  Raises RuntimeError when every worker process has exited
    with cells still unserved (their logs are named), or on timeout —
    a wedged fleet must fail loudly, not hang a campaign forever."""
    from ..serve.fleet import fleet_paths
    from ..serve.journal import SubmissionJournal

    paths = fleet_paths(fleet_dir)
    journal = SubmissionJournal(paths["journal_dir"])
    cells = plan_.cells
    t0 = time.time()
    saw_all_exited = False
    while True:
        by_cell, by_digest = _fleet_join(plan_, paths["ledger_path"])
        results: dict = {}
        counts = {"from_ledger": 0, "deduped": 0, "quarantined": 0}
        for cell in cells:
            row = by_cell.get(cell.id)
            dedup = False
            if row is None:
                row, dedup = by_digest.get(cell.spec.digest()), True
            if row is not None:
                results[cell.id] = {"status": "done",
                                    "artifacts": _row_artifacts(row)}
                counts["deduped" if dedup else "from_ledger"] += 1
        # a quarantined entry never grows a ledger row — surface it as
        # the cell's error instead of waiting for the timeout
        for rid, st in journal.settled().items():
            if st != "quarantined":
                continue
            ex = (journal.lookup(rid) or {}).get("ledger_extra") or {}
            cid = ex.get("cell")
            if ex.get("grid_digest") == plan_.grid_digest \
                    and cid and cid not in results:
                results[cid] = {
                    "status": "error",
                    "error": f"fleet: entry {rid} quarantined (poison "
                             "lane) — see the workers' logs"}
                counts["quarantined"] += 1
        if progress is not None:
            progress({"done": len(results), "total": len(cells),
                      "journal_lag": journal.lag(),
                      "wall_s": round(time.time() - t0, 3)})
        if len(results) == len(cells):
            return {"results": results, "counts": counts}
        if procs and all(p.poll() is not None for p in procs):
            if not saw_all_exited:
                # one more immediate join: a worker may have appended
                # the final ledger row just after this poll's scan
                saw_all_exited = True
                continue
            missing = [c.id for c in cells if c.id not in results]
            logs = sorted({getattr(p, "log_path", "?") for p in procs})
            raise RuntimeError(
                f"fleet: all {len(procs)} worker process(es) exited "
                f"with {len(missing)} cell(s) unserved "
                f"({missing[:4]}{'...' if len(missing) > 4 else ''}). "
                f"Worker logs: {logs}")
        if time.time() - t0 > timeout_s:
            missing = [c.id for c in cells if c.id not in results]
            raise RuntimeError(
                f"fleet: campaign incomplete after {timeout_s:.0f}s — "
                f"{len(missing)} cell(s) unserved ({missing[:4]}...). "
                "The journal entries survive; re-running the campaign "
                "over the same fleet_dir resumes them")
        time.sleep(poll_s)


def run_grid_fleet(grid: SweepGrid, plan_: MatrixPlan | None = None, *,
                   fleet_dir, workers: int = 2,
                   lease_ttl_s: float = 10.0, idle_exit_s: float = 2.0,
                   poll_s: float = 0.5, timeout_s: float = 900.0,
                   progress=None, on_spawned=None,
                   spawn: bool = True, timeline=None,
                   device=None) -> MatrixRun:
    """`run_grid(workers=N)`'s engine, decomposed (enqueue / spawn /
    wait / report) so a crash harness can SIGKILL workers between the
    pieces.  Enqueues the grid into the shared fleet journal,
    spawns `workers` worker subprocesses over `fleet_dir`, waits for
    the shared-ledger join to serve every cell, and builds the same
    `MatrixReport` a single-process run would — cell rows are ledger
    round-trips, bit-identical by the `_row_artifacts` contract; the
    run-local accounting (wall, aggregate program builds, the `resume`
    block's fleet counters) honestly differs and is exactly the
    volatile set a comparison leaves out.

    `on_spawned(procs)` fires after the workers launch (the crash
    harness's kill hook); `spawn=False` skips launching (the caller
    runs its own workers).  A dead worker needs no respawn: its leases
    expire and survivors adopt its work (serve/fleet.py).  `timeline`
    (a directory) turns each worker's host-plane flight recorder ON —
    one ``spans-<worker>.jsonl`` per worker under it, a dead worker's
    torn tail included.  `device` is each worker's ``--device``
    (``cuda`` unless given)."""
    from ..serve.fleet import aggregate_worker_stats, spawn_worker

    plan_ = plan_ or plan(grid)
    t0 = time.time()
    requests = fleet_enqueue(plan_, fleet_dir)
    procs = []
    if spawn:
        procs = [spawn_worker(fleet_dir, f"w{i}",
                              lease_ttl_s=lease_ttl_s,
                              idle_exit_s=idle_exit_s,
                              max_wall_s=timeout_s,
                              timeline=timeline, device=device)
                 for i in range(int(workers))]
    if on_spawned is not None:
        on_spawned(procs)
    try:
        waited = fleet_wait(plan_, fleet_dir, procs=procs,
                            timeout_s=timeout_s, poll_s=poll_s,
                            progress=progress)
    finally:
        # reap: workers idle-exit on their own once the journal is
        # fully settled (their final stats snapshot lands in their
        # `finally`); only a wedged/errored fleet gets terminated
        deadline = time.time() + max(10.0, 3 * idle_exit_s)
        for p in procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.terminate()
    results = waited["results"]
    agg = aggregate_worker_stats(fleet_dir)
    wall = time.time() - t0
    resume_counts = {
        "fleet_workers": int(workers),
        **waited["counts"],
        "resumed_requests": 0,
        "journal_replayed": agg["counters"].get("claimed", 0),
        "worker_deduped": agg["counters"].get("deduped", 0),
        "adopted_checkpoints": agg["counters"].get(
            "adopted_checkpoints", 0)}
    compiles = {"program_builds": agg["registry"].get("misses", 0),
                "distinct_compile_keys": plan_.planned_compiles,
                "registry": agg["registry"]}
    report = MatrixReport.build(
        plan_, results, wall_s=wall, compiles=compiles,
        scheduler_stats=agg["resilience"] or None,
        resume=resume_counts)
    artifacts = {cid: r["artifacts"] for cid, r in results.items()
                 if r.get("status") == "done"}
    return MatrixRun(report=report, artifacts=artifacts, states={},
                     requests=requests)


# ---------------------------------------------------------- verification


def _runner_reference(spec, seed, device):
    """One seed of a cell run twice through `Runner` on `device` (one obs
    plane per pass — bit-identical on the trajectory), one `run_ms` call
    a chunk as the scheduler runs it: the sequential-reference shape,
    the matrix's pinned-subset oracle."""
    import torch

    from ..core.network import Runner
    from ..obs.audit import AuditSpec
    from ..obs.spec import MetricsSpec

    proto = spec.build_protocol(device=device)

    def run(runner):
        net, ps = proto.init(int(seed))
        if spec.partition:
            idx = torch.as_tensor(spec.partition, device=net.time.device)
            down = net.nodes.down.clone()
            down[idx] = True
            net = net.replace(nodes=net.nodes.replace(down=down))
        for _ in range(spec.sim_ms // spec.chunk_ms):
            net, ps = runner.run_ms(net, ps, spec.chunk_ms)
        return net, ps

    frame = audit = None
    runner = Runner(proto,
                    metrics=MetricsSpec(stat_each_ms=spec.stat_each_ms)
                    if "metrics" in spec.obs else None)
    state = run(runner)
    if "metrics" in spec.obs:
        frame = runner.metrics_frame()
    if "audit" in spec.obs:
        auditor = Runner(proto, audit=AuditSpec())
        run(auditor)
        audit = auditor.audit_report()
    return state, frame, audit


def verify_cell(spec, final_state, artifacts) -> list:
    """Bit-identity check of one matrix cell against per-seed `Runner`
    runs on the final state's device: full final state per lane, plus
    the metrics/audit blocks (exact for single-seed cells; seed-summed
    series/totals for wider ones, matching the blocks' own batch
    aggregation).  Returns human-readable mismatch strings — empty
    means bit-identical."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    mismatches = []
    spec = spec if isinstance(spec.superstep, int) else spec.validate()
    device = final_state[0].time.device
    refs = [_runner_reference(spec, s, device) for s in spec.seeds]
    for i, (state, frame, audit) in enumerate(refs):
        lane = pytree.tree_map(lambda x, i=i: x[i], final_state)
        la, lb = pytree.tree_leaves(lane), pytree.tree_leaves(state)
        if len(la) != len(lb) or not all(
                a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b) for a, b in zip(la, lb)):
            mismatches.append(
                f"seed {spec.seeds[i]}: final-state pytree differs "
                "from the sequential Runner run")
    if "metrics" in spec.obs and "engine_metrics" in artifacts:
        blk = artifacts["engine_metrics"]
        frames = [f for _, f, _ in refs]
        if len(frames) == 1:
            from ..obs.export import engine_metrics_block
            ref_blk = engine_metrics_block(
                frames[0], extra={"metrics_seeds": 1})
            if blk != ref_blk:
                mismatches.append("engine_metrics block differs from "
                                  "the sequential reference")
        elif "series" in blk:
            for name in blk["series"]:
                if name == "time":
                    continue
                want = np.sum([f.column(name) for f in frames],
                              axis=0)
                if list(map(int, want)) != blk["series"][name]:
                    mismatches.append(
                        f"metrics series {name!r} != the seed-summed "
                        "sequential reference")
    if "audit" in spec.obs and "audit" in artifacts:
        blk = artifacts["audit"]
        audits = [a for _, _, a in refs]
        if len(audits) == 1:
            from ..obs.audit_report import audit_block
            ref_blk = audit_block(audits[0], extra={"audit_seeds": 1})
            if blk != ref_blk:
                mismatches.append("audit block differs from the "
                                  "sequential reference")
        else:
            want_totals = {
                k: sum(a.totals_dict()[k] for a in audits)
                for k in audits[0].totals_dict()}
            if blk["totals"] != want_totals:
                mismatches.append("audit totals != the seed-summed "
                                  "sequential reference")
            if blk["clean"] != all(a.clean for a in audits):
                mismatches.append("audit verdict differs from the "
                                  "sequential reference")
    return mismatches


def pick_spot_cells(cells, k: int) -> list:
    """A deterministic spread of `k` cell ids over the expansion order
    (first/last/evenly between) — the pinned verification subset."""
    if k <= 0 or not cells:
        return []
    k = min(k, len(cells))
    if k == 1:
        return [cells[0].id]
    idx = sorted({round(i * (len(cells) - 1) / (k - 1))
                  for i in range(k)})
    return [cells[i].id for i in idx]
