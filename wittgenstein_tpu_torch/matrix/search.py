"""Adaptive boundary search over the memoized matrix — the port of
`wittgenstein_tpu/matrix/search.py`: the same `SearchSpec` digests, the
same probe sequence and the same `SearchReport` JSON, over the port's
scheduler (probes run on its device, ``cuda`` unless given) or a fleet
of the port's worker processes.

Production questions about the simulated protocols are boundary-shaped
("at what loss permille does PingPong stop finishing?").  The
exhaustive `SweepGrid` answers them by running every cell; this module
answers them with a deterministic probe plan — coarse bracketing over
the search axis, then bisection refinement — where every probe is one
grid cell submitted through the serve `Scheduler`:

  * probes near the boundary differ only post-fork, so they fork from
    the shared honest prefix (memo/prefix.py) instead of re-running it;
  * re-probes (and re-RUNS of the whole search) are served from the
    ledger join and the cross-run memo table — an immediate re-run
    simulates ZERO new chunks;
  * a killed search resumes through the scheduler's checkpoint +
    submission-journal path (`resume=True`), bit-identically.

The probe sequence is a pure function of ``(grid_digest, search spec
digest)``: the slice ladder, the coarse indices and every bisection
midpoint are derived from the frozen `SearchSpec` alone, and each
round's verdicts are computed from per-cell report rows that are
themselves bit-identical across live/ledger/fleet serving paths.  Two
cold runs therefore produce byte-identical `SearchReport` JSON (modulo
wall-clock), and the fleet path (`run_search(workers=N)`) matches the
single-process path row for row.

Ledger rows are labelled ``search:<cell id>`` and carry the grid
digest + axis labels in `extra` — the same provenance shape as matrix
rows, so campaign resume and cross-campaign dedup reuse the matrix
join unchanged.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import operator
import time

from .grid import SweepGrid
from .planner import MatrixPlan, plan
from .report import _cell_row

#: search spec / report schema version (readers key on it)
SCHEMA = 1

#: predicate comparators (the full spec surface — keep it enumerable
#: so a spec digest can never smuggle code)
OPS = {">=": operator.ge, "<=": operator.le,
       ">": operator.gt, "<": operator.lt}


def _err(msg: str) -> ValueError:
    return ValueError(f"SearchSpec: {msg}")


# ------------------------------------------------------------------ spec


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One boundary question, frozen and JSON-able.

    grid      — the base `SweepGrid` (or its JSON form): every probe is
                one of its cells, so the search inherits the grid's
                validation, compile-key grouping and provenance.
    axis      — name of the grid axis to search along (its declared
                value order IS the ordinal scale).
    predicate — ``{"field", "op", "value"}`` over per-cell report
                fields: ``time_to_done_ms``, the derived
                ``summary.done_frac``, or any ``summary.<counter>``;
                op one of ``>= <= > <``.
    coarse    — how many evenly-spread axis indices the bracketing
                round probes (>= 2; 2 = endpoints only).
    """

    grid: SweepGrid
    axis: str
    predicate: dict
    coarse: int = 2
    name: str = "search"
    schema: int = SCHEMA

    def __post_init__(self):
        if isinstance(self.grid, dict):
            object.__setattr__(self, "grid",
                               SweepGrid.from_json(self.grid))
        if not isinstance(self.grid, SweepGrid):
            raise _err("grid must be a SweepGrid or its JSON form, "
                       f"got {type(self.grid).__name__}")
        if self.schema != SCHEMA:
            raise _err(f"schema {self.schema!r} != {SCHEMA} — this "
                       "tree speaks search schema 1 only")
        if self.grid.exclude:
            raise _err("the base grid has exclusion rules; bisection "
                       "needs the full lattice (every slice must hold "
                       "a cell at every search-axis value). Fix: drop "
                       "'exclude' from the grid, or narrow the other "
                       "axes instead")
        names = [a.name for a in self.grid.axes]
        if self.axis not in names:
            raise _err(f"axis {self.axis!r} is not one of the grid's "
                       f"axes {names}")
        ax = self.search_axis()
        if len(ax.values) < 2:
            raise _err(f"search axis {self.axis!r} has "
                       f"{len(ax.values)} value(s); a boundary needs "
                       "at least 2 (the declared order is the scale)")
        if not isinstance(self.coarse, int) \
                or isinstance(self.coarse, bool) or self.coarse < 2:
            raise _err(f"coarse={self.coarse!r} must be an int >= 2 "
                       "(2 probes just the axis endpoints)")
        if self.coarse > len(ax.values):
            raise _err(f"coarse={self.coarse} exceeds the "
                       f"{len(ax.values)}-value search axis — that "
                       "is the exhaustive sweep; run the grid instead")
        p = self.predicate
        if not isinstance(p, dict) or set(p) != {"field", "op",
                                                 "value"}:
            raise _err("predicate must be exactly {'field', 'op', "
                       f"'value'}}, got {p!r}")
        if p["op"] not in OPS:
            raise _err(f"predicate op {p['op']!r} not in "
                       f"{sorted(OPS)}")
        if isinstance(p["value"], bool) \
                or not isinstance(p["value"], (int, float)):
            raise _err(f"predicate value {p['value']!r} must be a "
                       "number")
        f = p["field"]
        if not isinstance(f, str) or not (
                f == "time_to_done_ms"
                or (f.startswith("summary.") and len(f) > 8)):
            raise _err(f"predicate field {f!r} must be "
                       "'time_to_done_ms', 'summary.done_frac' or "
                       "'summary.<counter>'")
        object.__setattr__(self, "predicate",
                           {"field": str(f), "op": str(p["op"]),
                            "value": p["value"]})

    def search_axis(self):
        for a in self.grid.axes:
            if a.name == self.axis:
                return a
        raise _err(f"axis {self.axis!r} vanished from the grid")

    # ---------------------------------------------------- serialization

    def to_json(self) -> dict:
        return {"schema": self.schema, "name": self.name,
                "grid": self.grid.to_json(), "axis": self.axis,
                "predicate": {"field": self.predicate["field"],
                              "op": self.predicate["op"],
                              "value": self.predicate["value"]},
                "coarse": int(self.coarse)}

    def canonical_json(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, data) -> "SearchSpec":
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        if not isinstance(data, dict):
            raise _err(f"expected a JSON object, got "
                       f"{type(data).__name__}")
        known = {"schema", "name", "grid", "axis", "predicate",
                 "coarse"}
        unknown = set(data) - known
        if unknown:
            raise _err(f"unknown key(s) {sorted(unknown)} — this tree "
                       f"knows {sorted(known)}")
        missing = {"grid", "axis", "predicate"} - set(data)
        if missing:
            raise _err(f"missing required key(s) {sorted(missing)}")
        kw = {k: data[k] for k in known if k in data}
        return cls(**kw)

    def digest(self) -> str:
        """Content digest of the whole question (grid included) — the
        identity the probe sequence is a pure function of."""
        from ..obs.ledger import digest
        return digest(self.to_json())

    def __hash__(self):
        return hash(self.canonical_json())


# ------------------------------------------------------------ predicate


def probe_verdict(predicate: dict, row: dict, rspec):
    """Evaluate one predicate over one report cell row (the
    `_cell_row` shape — identical for live, ledger-served and fleet
    rows, which is what makes verdicts serving-path-independent).
    Returns ``(verdict, value, error)``: verdict None means the row
    could not answer (errored cell / missing field) and `error` says
    why."""
    if row.get("status") != "done":
        return None, None, str(row.get("error", "probe errored"))
    field = predicate["field"]
    summary = row.get("summary") or {}
    if field == "time_to_done_ms":
        val = row.get("time_to_done_ms")
        if val is None:
            return None, None, (
                "no time_to_done_ms on this cell (the run never "
                "completed inside sim_ms, or the spec lacks the "
                "metrics plane) — predicate cannot be answered")
    elif field == "summary.done_frac":
        if "done_count" not in summary:
            return None, None, "summary has no done_count"
        val = summary["done_count"] / (len(rspec.seeds)
                                       * int(rspec.params["node_count"]))
    else:
        key = field[len("summary."):]
        if key not in summary:
            return None, None, (f"summary has no {key!r} (fields: "
                                f"{sorted(summary)})")
        val = summary[key]
    return bool(OPS[predicate["op"]](val, predicate["value"])), val, \
        None


# ----------------------------------------------------------------- plan


@dataclasses.dataclass(frozen=True)
class SearchSlice:
    """One swept slice: a fixed assignment of every non-search axis,
    holding the ordered cell ladder along the search axis."""

    id: str
    labels: dict                    # non-search axis name -> label
    cell_ids: tuple                 # ordered along the search axis


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """The compiled probe plan: the spec, the underlying `MatrixPlan`
    (validated cells, compile-key groups), the slices and the coarse
    probe indices.  Everything downstream — probe order, report rows,
    chunk accounting — derives from this frozen object."""

    spec: SearchSpec
    mplan: MatrixPlan
    slices: tuple
    coarse_idx: tuple
    axis_labels: tuple
    search_digest: str

    @property
    def grid_digest(self) -> str:
        return self.mplan.grid_digest

    def chunks_exhaustive(self) -> int:
        """Chunks the exhaustive grid would simulate cold — the
        denominator of the probe-savings ratio."""
        total = 0
        for cell in self.mplan.cells:
            rspec = self.mplan.resolved[cell.id]
            total += rspec.sim_ms // rspec.chunk_ms
        return total

    def summary(self) -> dict:
        """The `--plan-only` block: what would run, without running."""
        gaps = [b - a for a, b in zip(self.coarse_idx,
                                      self.coarse_idx[1:])]
        worst, bisect = max(gaps) if gaps else 0, 0
        while (1 << bisect) < worst:
            bisect += 1
        return {
            "search_digest": self.search_digest,
            "grid_digest": self.grid_digest,
            "axis": self.spec.axis,
            "axis_labels": list(self.axis_labels),
            "coarse_labels": [self.axis_labels[i]
                              for i in self.coarse_idx],
            "slices": len(self.slices),
            "cells_exhaustive": len(self.mplan.cells),
            "max_probes": len(self.slices)
            * (len(self.coarse_idx) + bisect),
            "chunks_exhaustive": self.chunks_exhaustive(),
            "planned_compiles": self.mplan.planned_compiles,
        }


def compile_search(spec: SearchSpec) -> SearchPlan:
    """Compile a `SearchSpec` into its deterministic probe plan.
    Validates every grid cell (via `matrix.plan`) and the predicate's
    data requirements up front — a search must refuse at compile time,
    never discover mid-campaign that its cells cannot answer."""
    mplan = plan(spec.grid)
    if spec.predicate["field"] == "summary.done_frac":
        for cell in mplan.cells:
            if "node_count" not in mplan.resolved[cell.id].params:
                raise _err(
                    "predicate 'summary.done_frac' needs "
                    "params.node_count on every cell (it is the "
                    f"done_count denominator) but {cell.id!r} lacks "
                    "it. Fix: set node_count explicitly in the grid's "
                    "base params")
    ax = spec.search_axis()
    others = [a for a in spec.grid.axes if a.name != spec.axis]
    slices = []
    for combo in itertools.product(*[a.labels for a in others]):
        labels = {a.name: lab for a, lab in zip(others, combo)}
        sid = "/".join(f"{a.name}={labels[a.name]}"
                       for a in others) or "*"
        cids = tuple(spec.grid.cell_id({**labels, spec.axis: lab})
                     for lab in ax.labels)
        slices.append(SearchSlice(id=sid, labels=labels,
                                  cell_ids=cids))
    n, k = len(ax.labels), spec.coarse
    coarse_idx = tuple(sorted({round(i * (n - 1) / (k - 1))
                               for i in range(k)}))
    return SearchPlan(spec=spec, mplan=mplan, slices=tuple(slices),
                      coarse_idx=coarse_idx,
                      axis_labels=tuple(ax.labels),
                      search_digest=spec.digest())


# ------------------------------------------------------ slice bisection


class _SliceState:
    """The per-slice bracketing/bisection automaton.  Driven purely by
    observed verdicts at axis indices — no clock, no randomness — so
    the emitted probe sequence is a function of the spec alone."""

    def __init__(self, sl: SearchSlice, coarse_idx):
        self.sl = sl
        self.coarse = list(coarse_idx)
        self.verdicts: dict = {}
        self.values: dict = {}
        self.status = "probing"
        self.bracket = None         # (lo, hi) axis indices, v differs
        self.divergent = False      # >1 coarse flip (non-monotone)
        self.boundary_idx = None
        self.error = None
        self.n_probes = 0

    def next_probes(self) -> list:
        """Axis indices this slice needs next (empty = settled)."""
        if self.status != "probing":
            return []
        missing = [i for i in self.coarse if i not in self.verdicts]
        if missing:
            return missing
        if self.bracket is None:
            self._bracket_from_coarse()
            if self.status != "probing":
                return []
        lo, hi = self.bracket
        if hi - lo <= 1:
            self.boundary_idx = hi
            self.status = "divergent" if self.divergent else "boundary"
            return []
        return [(lo + hi) // 2]

    def _bracket_from_coarse(self):
        vs = [(i, self.verdicts[i]) for i in self.coarse]
        flips = [(a, b) for (a, va), (b, vb) in zip(vs, vs[1:])
                 if va != vb]
        if not flips:
            self.status = "all_pass" if vs[0][1] else "all_fail"
            return
        # >1 flip: the predicate is non-monotone over the coarse net;
        # still refine the FIRST bracket (deterministically) but tag
        # the slice divergent — the CLI's exit-1 story
        self.divergent = len(flips) > 1
        self.bracket = flips[0]

    def observe(self, idx: int, verdict, value, err):
        if self.status != "probing":
            return
        self.n_probes += 1
        if err is not None:
            self.status, self.error = "error", err
            return
        self.verdicts[idx] = verdict
        self.values[idx] = value
        if self.bracket is not None:
            lo, hi = self.bracket
            if idx == (lo + hi) // 2:
                self.bracket = (idx, hi) \
                    if verdict == self.verdicts[lo] else (lo, idx)


def exhaustive_boundaries(splan: SearchPlan, rows_by_cell: dict) \
        -> dict:
    """The ground-truth oracle (tests): evaluate the predicate on
    EVERY cell of every slice (rows from an exhaustive `run_grid`
    report) and return ``{slice id: first-flip cell id or None}`` —
    what the bisection must agree with on monotone slices."""
    out = {}
    for sl in splan.slices:
        verdicts = []
        for cid in sl.cell_ids:
            v, _, err = probe_verdict(splan.spec.predicate,
                                      rows_by_cell[cid],
                                      splan.mplan.resolved[cid])
            if err is not None:
                raise ValueError(f"exhaustive_boundaries: cell "
                                 f"{cid!r} cannot answer: {err}")
            verdicts.append(v)
        bnd = None
        for i in range(1, len(verdicts)):
            if verdicts[i] != verdicts[0]:
                bnd = sl.cell_ids[i]
                break
        out[sl.id] = bnd
    return out


# --------------------------------------------------------- memo overlay


class _OverlayTable:
    """In-memory prefix store layered over an optional on-disk
    `MemoTable`.  Within one search, later bisection rounds re-fork
    from prefixes earlier rounds ran — without forcing a disk table —
    while a configured disk table additionally shares them across runs
    and processes.  Duck-types the `get`/`put`/`stats` surface
    `_run_prefixes` drives."""

    def __init__(self, disk=None):
        self.disk = disk
        self._mem: dict = {}
        self.hits = self.mem_hits = self.misses = self.puts = 0

    def get(self, spec, device=None):
        k = spec.digest()
        hit = self._mem.get(k)
        if hit is not None:
            self.hits += 1
            self.mem_hits += 1
            return hit
        if self.disk is not None:
            hit = self.disk.get(spec, device=device)
            if hit is not None:
                self.hits += 1
                self._mem[k] = hit
                return hit
        self.misses += 1
        return None

    def put(self, spec, state, carries):
        self._mem[spec.digest()] = (state, carries)
        self.puts += 1
        if self.disk is not None:
            self.disk.put(spec, state, carries)

    def stats(self) -> dict:
        return {"hits": self.hits, "mem_hits": self.mem_hits,
                "misses": self.misses, "puts": self.puts,
                "disk": self.disk.stats()
                if self.disk is not None else None}


# --------------------------------------------------------------- report


@dataclasses.dataclass
class SearchReport:
    """One search campaign's artifact: boundary per slice with its
    bracket, every probed cell id + verdict, and the savings
    accounting vs the exhaustive grid.  Rides ``reports/`` like
    `MatrixReport` (atomic save, schema-pinned load)."""

    data: dict

    @classmethod
    def build(cls, splan: SearchPlan, states, probes, rows,
              wall_s: float, counts: dict, chunks: dict,
              memo_stats=None, resume=None) -> "SearchReport":
        ax = splan.axis_labels
        slices = []
        for st in states:
            row = {"slice": st.sl.id, "labels": dict(st.sl.labels),
                   "status": st.status, "probes": st.n_probes,
                   "bracket": None, "boundary_cell": None,
                   "boundary_label": None}
            if st.bracket is not None:
                lo, hi = st.bracket
                row["bracket"] = [ax[lo], ax[hi]]
            if st.boundary_idx is not None:
                row["boundary_cell"] = st.sl.cell_ids[st.boundary_idx]
                row["boundary_label"] = ax[st.boundary_idx]
            if st.error is not None:
                row["error"] = str(st.error)[:500]
            slices.append(row)
        found = sum(1 for r in slices if r["status"] == "boundary")
        sim, exh = chunks["simulated"], chunks["exhaustive"]
        accounting = dict(counts)
        if memo_stats is not None:
            accounting["memo"] = dict(memo_stats)
        if resume is not None:
            accounting["resume"] = dict(resume)
        data = {
            "schema": SCHEMA,
            "name": splan.spec.name,
            "search_digest": splan.search_digest,
            "grid_digest": splan.grid_digest,
            "spec": splan.spec.to_json(),
            "axis": splan.spec.axis,
            "predicate": dict(splan.spec.predicate),
            "axis_labels": list(ax),
            "slices": slices,
            "boundaries_found": found,
            "probes": list(probes),
            "cells": list(rows),
            "cells_probed": len(rows),
            "cells_exhaustive": len(splan.mplan.cells),
            "chunks_simulated": int(sim),
            "chunks_exhaustive": int(exh),
            "probe_savings_ratio": round(exh / sim, 2) if sim else
            None,
            "accounting": accounting,
            "wall_s": round(float(wall_s), 3),
        }
        return cls(data=data)

    # -------------------------------------------------------------- views

    @property
    def clean(self) -> bool:
        """Every slice located its boundary (the CLI's exit 0)."""
        return all(r["status"] == "boundary"
                   for r in self.data["slices"])

    @property
    def search_digest(self) -> str:
        return self.data["search_digest"]

    def slice(self, slice_id: str) -> dict:
        for row in self.data["slices"]:
            if row["slice"] == slice_id:
                return row
        raise KeyError(f"unknown slice {slice_id!r}")

    # ------------------------------------------------------- serialization

    def to_json(self) -> dict:
        return self.data

    @classmethod
    def from_json(cls, data) -> "SearchReport":
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        if not isinstance(data, dict) or "search_digest" not in data:
            raise ValueError("SearchReport: expected a report JSON "
                             "object with a 'search_digest'")
        if data.get("schema") != SCHEMA:
            raise ValueError(f"SearchReport: schema "
                             f"{data.get('schema')!r} != {SCHEMA} — "
                             "re-run the search with this tree")
        return cls(data=dict(data))

    def save(self, path) -> str:
        """Atomic write (temp + fsync + os.replace): the report is
        what a resume run or an operator reads after a crash, so a
        kill mid-write must leave the previous report or the new one,
        never a torn file."""
        import os
        import pathlib
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = str(p) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, str(p))
        return str(p)

    # -------------------------------------------------------------- human

    def format(self) -> str:
        d = self.data
        pred = d["predicate"]
        lines = [
            f"search {d['name']!r} [{d['search_digest']}] over grid "
            f"[{d['grid_digest']}]: {pred['field']} {pred['op']} "
            f"{pred['value']} along {d['axis']!r} — "
            f"{d['boundaries_found']}/{len(d['slices'])} boundaries, "
            f"{d['cells_probed']}/{d['cells_exhaustive']} cells "
            f"probed, {d['chunks_simulated']}/{d['chunks_exhaustive']}"
            f" chunks simulated"
            + (f" ({d['probe_savings_ratio']}x saved)"
               if d["probe_savings_ratio"] else "")
            + f", wall {d['wall_s']} s"]
        for r in d["slices"]:
            bit = f"  slice {r['slice']}: {r['status']}"
            if r["bracket"]:
                bit += f" bracket [{r['bracket'][0]}, " \
                       f"{r['bracket'][1]}]"
            if r["boundary_label"] is not None:
                bit += f" -> {d['axis']}={r['boundary_label']}"
            if r.get("error"):
                bit += f" ({r['error'][:120]})"
            lines.append(bit)
        return "\n".join(lines)


@dataclasses.dataclass
class SearchRun:
    """One search campaign: the report artifact plus the in-memory
    per-probe products it leaves out (full obs blocks, request ids)."""

    report: SearchReport
    plan: SearchPlan
    artifacts: dict                 # cell id -> scheduler artifacts
    requests: dict                  # cell id -> request id


# --------------------------------------------------------------- runner


def _bank_from_ledger(mplan: MatrixPlan, ledger_path) -> dict:
    """Pre-serve probes from the ledger: every plan cell with a clean
    summary-bearing row (this grid's, or a cross-campaign exact-digest
    match) enters the bank and costs ZERO simulated chunks when
    probed."""
    from .driver import _fleet_join, _row_artifacts

    bank: dict = {}
    if ledger_path is None:
        return bank
    by_cell, by_digest = _fleet_join(mplan, ledger_path)
    for cell in mplan.cells:
        dig = cell.spec.digest()
        row, dedup = by_cell.get(cell.id), False
        if row is not None and row.config_digest != dig:
            row = None              # same id, edited spec: never stale
        if row is None:
            row, dedup = by_digest.get(dig), True
        if row is None:
            continue
        bank[cell.id] = {"status": "done",
                         "artifacts": _row_artifacts(row),
                         "_dedup": dedup}
    return bank


def _probe_round(sch, splan: SearchPlan, cids, bank, results,
                 artifacts, requests, overlay, mcfg, memo_stats,
                 counts, chunks, max_wave: int):
    """Run one round's probe cells through the scheduler: serve from
    the bank first (ledger hits — zero chunks), then plan + run the
    round's shared prefixes, then submit the remaining probes in waves
    (forked where sound).  Chunk accounting is exact: prefix cost is
    what `_run_prefixes` actually simulated, probe cost is the
    post-fork remainder."""
    from ..memo import plan_prefixes
    from .driver import _drain, _harvest, _run_prefixes

    mplan = splan.mplan
    cells_by_id = {c.id: c for c in mplan.cells}
    to_run = []
    for cid in cids:
        if cid in results:
            continue
        r = bank.get(cid)
        if r is not None:
            results[cid] = r
            counts["deduped" if r.get("_dedup") else
                   "ledger_hits"] += 1
            continue
        to_run.append(cid)
    if not to_run:
        return
    forks: dict = {}
    if overlay is not None:
        done_ids = {c.id for c in mplan.cells} - set(to_run)
        fplan = plan_prefixes(mplan, min_cells=mcfg.min_cells,
                              done_ids=done_ids, include_singles=True)
        memo_stats["fork_groups"] += len(fplan.groups)
        memo_stats["predicted_chunks_saved"] += \
            fplan.predicted_chunks_saved
        saved0 = memo_stats["prefix_chunks_saved"]
        forks = _run_prefixes(sch, mplan, fplan, overlay, memo_stats,
                              max_wave)
        # exact prefix cost this round: what the forks would have
        # saved, minus what the accounting says was actually saved
        # (a table/overlay HIT nets to 0; a live prefix nets to its
        # own fork_chunks; a fully-vetoed prefix still cost its run)
        would = sum(int(f.at_ms) // mplan.resolved[cid].chunk_ms
                    for cid, f in forks.items())
        chunks["simulated"] += \
            would - (memo_stats["prefix_chunks_saved"] - saved0)
    for lo in range(0, len(to_run), max_wave):
        wave = to_run[lo:lo + max_wave]
        pending = []
        for cid in wave:
            cell = cells_by_id[cid]
            try:
                rid = sch.submit(
                    cell.spec,
                    label=f"search:{cell.id}",
                    ledger_extra={"grid_digest": mplan.grid_digest,
                                  "cell": cell.id,
                                  "axes": dict(cell.labels),
                                  "search_digest":
                                  splan.search_digest},
                    fork=forks.get(cid))
            except ValueError as e:     # plan validated; belt and
                # braces for env drift between compile and run
                results[cid] = {"status": "error", "error": str(e)}
                continue
            requests[cid] = rid
            pending.append((cell, rid))
            counts["live_probes"] += 1
            rspec = mplan.resolved[cid]
            fk = forks.get(cid)
            chunks["simulated"] += rspec.sim_ms // rspec.chunk_ms \
                - (int(fk.at_ms) // rspec.chunk_ms
                   if fk is not None else 0)
        _drain(sch, [rid for _, rid in pending])
        _harvest(sch, pending, results, artifacts, {}, False, set())


def run_search(spec: SearchSpec, scheduler=None,
               splan: SearchPlan | None = None, *, ledger_path=None,
               checkpoint_dir=None, journal_dir=None,
               max_wave: int = 64, resume: bool = False, memo=True,
               progress=None, workers: int | None = None,
               fleet_dir=None, fleet_opts: dict | None = None,
               device=None) -> SearchRun:
    """Answer a `SearchSpec` (module docstring) and build the
    `SearchReport`.

    memo    — memoized supersteps for the probes (True, a `MemoConfig`
        or its dict): each round's probes that differ only post-fork
        share ONE honest-prefix run; a configured `table` additionally
        reuses prefixes across runs/processes.  An in-memory overlay
        always spans the rounds of THIS search, so bisection re-forks
        from round-0 prefixes even without a disk table.
    resume  — campaign resume over the journal/checkpoint path:
        finished probes serve from their ledger rows, mid-flight ones
        re-enter through `Scheduler.resume_checkpoints` +
        `resume_journal`, and the rebuilt report is bit-identical to
        an uninterrupted run's (modulo the accounting block).
    workers — fleet mode: probes become durable journal entries
        completed by N worker processes over `fleet_dir`
        (serve/fleet.py); workers spawn with ``--memo-table`` pointed
        at the shared table so probes on different workers reuse each
        other's prefixes.  `fleet_opts` forwards the fleet keywords
        (lease_ttl_s, timeout_s, poll_s, spawn, on_spawned, timeline,
        device).
    device  — where a scheduler this call builds runs (``cuda`` unless
        given); ignored with ``scheduler=``.
    """
    splan = splan or compile_search(spec)
    if workers is not None:
        if scheduler is not None or resume:
            raise ValueError(
                "run_search(workers=N) is a separate-process fleet: "
                "it cannot reuse an in-process scheduler, and resume "
                "is implicit (the fleet serves finished probes from "
                "the shared ledger automatically). Fix: drop "
                "workers=, or drop scheduler=/resume=")
        if fleet_dir is None:
            raise ValueError(
                "run_search(workers=N) needs fleet_dir= — the shared "
                "directory every worker derives journal/checkpoints/"
                "ledger paths from (serve.fleet_paths)")
        return _run_search_fleet(spec, splan, fleet_dir=fleet_dir,
                                 workers=workers, memo=memo,
                                 progress=progress,
                                 **dict(fleet_opts or {}))
    from ..serve.scheduler import Scheduler
    from .driver import _drain, _harvest, _load_resume

    mplan = splan.mplan
    sch = scheduler or Scheduler(ledger_path=ledger_path,
                                 checkpoint_dir=checkpoint_dir,
                                 journal_dir=journal_dir, device=device)
    t0 = time.time()
    mcfg = overlay = memo_stats = None
    if memo:
        from ..memo import MemoConfig
        mcfg = MemoConfig.coerce(memo)
        if mcfg.fork:
            overlay = _OverlayTable(mcfg.open_table())
            memo_stats = {"fork_groups": 0,
                          "predicted_chunks_saved": 0,
                          "prefix_runs": 0, "prefix_failed": 0,
                          "table_hits": 0, "forked_cells": 0,
                          "fork_vetoed": 0, "prefix_chunks_saved": 0}
    results: dict = {}
    artifacts: dict = {}
    requests: dict = {}
    counts = {"ledger_hits": 0, "deduped": 0, "live_probes": 0}
    chunks = {"simulated": 0, "exhaustive": splan.chunks_exhaustive()}
    resume_counts = None
    lp = ledger_path if ledger_path is not None else sch.ledger_path
    if resume:
        served, pre, resume_counts = _load_resume(mplan, sch, lp)
        bank = {cid: dict(r) for cid, r in served.items()}
        if pre:
            # mid-flight probe requests re-enter here and simulate
            # their post-checkpoint remainder — drive them now so the
            # round loop below serves them from the bank
            requests.update({c.id: rid for c, rid in pre})
            _drain(sch, [rid for _, rid in pre])
            _harvest(sch, pre, bank, artifacts, {}, False, set())
            for cell, _rid in pre:
                r = bank.get(cell.id)
                if r is None or r.get("status") != "done":
                    continue
                rspec = mplan.resolved[cell.id]
                from_ms = (r.get("artifacts") or {}) \
                    .get("resumed_from_ms") or 0
                chunks["simulated"] += \
                    (rspec.sim_ms - int(from_ms)) // rspec.chunk_ms
                counts["live_probes"] += 1
    else:
        bank = _bank_from_ledger(mplan, lp)
    states = [_SliceState(sl, splan.coarse_idx) for sl in splan.slices]
    probes: list = []
    rows: list = []
    row_ids: set = set()
    round_no = 0
    while True:
        wanted = []
        for st in states:
            for i in st.next_probes():
                wanted.append((st, i))
        if not wanted:
            break
        cids = []
        for st, i in wanted:
            cid = st.sl.cell_ids[i]
            if cid not in cids:
                cids.append(cid)
        _probe_round(sch, splan, cids, bank, results, artifacts,
                     requests, overlay, mcfg, memo_stats, counts,
                     chunks, max_wave)
        for st, i in wanted:
            cid = st.sl.cell_ids[i]
            result = results.get(cid, {"status": "error",
                                       "error": "never scheduled"})
            row = _cell_row(
                next(c for c in mplan.cells if c.id == cid),
                mplan.resolved[cid], result, None)
            if cid not in row_ids:
                row_ids.add(cid)
                rows.append(row)
            v, val, err = probe_verdict(spec.predicate, row,
                                        mplan.resolved[cid])
            st.observe(i, v, val, err)
            probes.append({"cell": cid, "slice": st.sl.id,
                           "label": splan.axis_labels[i],
                           "round": round_no, "verdict": v,
                           "value": val})
        round_no += 1
        if progress is not None:
            progress({"round": round_no, "probed": len(rows),
                      "slices_open": sum(1 for s in states
                                         if s.status == "probing"),
                      "chunks_simulated": chunks["simulated"],
                      "wall_s": round(time.time() - t0, 3)})
    if memo_stats is not None:
        memo_stats["table"] = overlay.stats()
    report = SearchReport.build(
        splan, states, probes, rows, wall_s=time.time() - t0,
        counts=counts, chunks=chunks, memo_stats=memo_stats,
        resume=resume_counts)
    return SearchRun(report=report, plan=splan, artifacts=artifacts,
                     requests=requests)


# ---------------------------------------------------------- fleet mode


def _fleet_serve(mplan: MatrixPlan, by_cell: dict, by_digest: dict,
                 cids, results: dict, counts: dict | None) -> list:
    """Serve round cells from one shared-ledger join; returns the ids
    still unserved.  `counts` is only charged at first serving (the
    probe-submission pass) — the wait loop passes None."""
    from .driver import _row_artifacts

    cells_by_id = {c.id: c for c in mplan.cells}
    missing = []
    for cid in cids:
        if cid in results:
            continue
        dig = cells_by_id[cid].spec.digest()
        row, dedup = by_cell.get(cid), False
        if row is not None and row.config_digest != dig:
            row = None
        if row is None:
            row, dedup = by_digest.get(dig), True
        if row is None:
            missing.append(cid)
            continue
        results[cid] = {"status": "done",
                        "artifacts": _row_artifacts(row)}
        if counts is not None:
            counts["deduped" if dedup else "ledger_hits"] += 1
    return missing


def _fleet_prefixes(splan: SearchPlan, journal, table, mcfg, to_run,
                    memo_stats, chunks, nonce, seq, procs,
                    timeout_s: float, poll_s: float) -> dict:
    """The fleet fork phase: plan this round's shared prefixes, serve
    them from the shared memo table where possible, enqueue the rest
    as durable journal entries for the workers (whose ``--memo-table``
    makes them `put` the finished state), and poll the table until
    every prefix resolves.  Returns ``{cell id: memo_fork extra}`` —
    the fork INSTRUCTION probes carry; the executing worker re-loads
    the state from the same table.  A prefix that never lands falls
    back to unforked probes with a stderr note (bit-identical, just
    slower).  The campaign side reads table entries on the CPU: it
    only runs the chaos soundness gate on them, and needs no card.
    A port worker puts a prefix in the table before its journal
    tombstone (serve/fleet.py), so a settled prefix that is not in the
    table means a worker without ``--memo-table``."""
    import sys

    from ..memo import chaos_noop_before_fork, plan_prefixes

    mplan = splan.mplan
    fplan = plan_prefixes(mplan, min_cells=mcfg.min_cells,
                          done_ids={c.id for c in mplan.cells}
                          - set(to_run), include_singles=True)
    memo_stats["fork_groups"] += len(fplan.groups)
    memo_stats["predicted_chunks_saved"] += fplan.predicted_chunks_saved
    got: dict = {}
    ran: set = set()
    pending = {}
    for fg in fplan.groups:
        hit = table.get(fg.prefix_spec, device="cpu")
        if hit is not None:
            got[fg.prefix_digest] = (fg, hit)
        else:
            pending[fg.prefix_digest] = fg
    if pending:
        live = {e["rid"] for e in journal.replay()}
        rids: dict = {}
        for dig in sorted(pending):
            fg = pending[dig]
            rid = f"sp{nonce}-{next(seq):04d}"
            if rid in live:         # paranoia: nonce+seq never collide
                continue
            journal.record_submit(
                rid, fg.prefix_spec,
                label=f"memo:prefix:{fg.prefix_digest[:8]}",
                ledger_extra={"grid_digest": mplan.grid_digest,
                              "memo_prefix": fg.prefix_digest})
            rids[dig] = rid
            ran.add(dig)
        deadline = time.time() + timeout_s
        settled_seen: set = set()
        while pending:
            for dig in sorted(pending):
                fg = pending[dig]
                hit = table.get(fg.prefix_spec, device="cpu")
                if hit is not None:
                    got[dig] = (fg, hit)
                    del pending[dig]
            if not pending:
                break
            # a SETTLED prefix entry whose state still isn't in the
            # table means its worker runs without --memo-table (or the
            # put failed): fall back to unforked probes for that group
            # now instead of burning the whole timeout.  A port worker
            # puts before it tombstones, so the next poll's table read
            # hits; the extra confirmation poll absorbs the
            # settle-then-put window of a JAX worker sharing the
            # directory, which puts after its drain returns.
            settled = journal.settled()
            for dig in sorted(pending):
                if settled.get(rids.get(dig)) is None:
                    continue
                if dig not in settled_seen:
                    settled_seen.add(dig)
                    continue
                print(f"fleet search: prefix {dig[:8]} settled "
                      f"({settled[rids[dig]]}) without landing in the "
                      "memo table — its worker runs without "
                      "--memo-table?  Its probes run unforked "
                      "(bit-identical, just slower)", file=sys.stderr)
                memo_stats["prefix_failed"] += 1
                if settled[rids[dig]] == "done":
                    # the worker DID simulate the prefix — charge it
                    chunks["simulated"] += pending[dig].fork_chunks
                del pending[dig]
            if not pending:
                break
            if procs and all(p.poll() is not None for p in procs):
                logs = sorted({getattr(p, "log_path", "?")
                               for p in procs})
                raise RuntimeError(
                    f"fleet search: all {len(procs)} worker "
                    f"process(es) exited with {len(pending)} "
                    f"prefix(es) unserved. Worker logs: {logs}")
            if time.time() > deadline:
                print(f"fleet search: {len(pending)} prefix(es) "
                      f"never landed in the memo table after "
                      f"{timeout_s:.0f}s; their probes run unforked "
                      "(bit-identical, just slower)", file=sys.stderr)
                for dig in sorted(pending):
                    memo_stats["prefix_failed"] += 1
                break
            time.sleep(poll_s)
    forks_meta: dict = {}
    for dig in sorted(got):
        fg, (state, carries) = got[dig]
        served = 0
        for cid in fg.cells:
            if cid not in mplan.resolved:
                continue
            # the same campaign-side soundness gate as the in-process
            # path, on the same state bits — the worker re-checks but
            # can never disagree
            if not chaos_noop_before_fork(mplan.resolved[cid], state,
                                          fg.fork_ms):
                memo_stats["fork_vetoed"] += 1
                continue
            forks_meta[cid] = {"prefix_digest": fg.prefix_digest,
                               "fork_ms": int(fg.fork_ms),
                               "prefix_spec": fg.prefix_spec.to_json()}
            served += 1
        memo_stats["forked_cells"] += served
        if dig in ran:
            memo_stats["prefix_runs"] += 1
            chunks["simulated"] += fg.fork_chunks
            memo_stats["prefix_chunks_saved"] += \
                (served - 1) * fg.fork_chunks
        else:
            memo_stats["table_hits"] += 1
            memo_stats["prefix_chunks_saved"] += \
                served * fg.fork_chunks
    return forks_meta


def _fleet_probe_round(splan: SearchPlan, paths, journal, cids,
                       results, requests, table, mcfg, memo_stats,
                       counts, chunks, nonce, seq, procs,
                       timeout_s: float, poll_s: float):
    """One fleet round: serve from the shared ledger, resolve shared
    prefixes through the memo table, enqueue the remaining probes as
    durable journal entries (forked where sound), and poll the ledger
    join until every probe lands (quarantine tombstones become the
    cell's error — the same loud-failure contract as `fleet_wait`)."""
    from .driver import _fleet_join

    mplan = splan.mplan
    cells_by_id = {c.id: c for c in mplan.cells}
    by_cell, by_digest = _fleet_join(mplan, paths["ledger_path"])
    to_run = _fleet_serve(mplan, by_cell, by_digest, cids, results,
                          counts)
    if not to_run:
        return
    forks_meta: dict = {}
    if table is not None and mcfg is not None and mcfg.fork:
        forks_meta = _fleet_prefixes(
            splan, journal, table, mcfg, to_run, memo_stats, chunks,
            nonce, seq, procs, timeout_s, poll_s)
    live = {}
    for e in journal.replay():
        ex = e.get("ledger_extra") or {}
        if ex.get("grid_digest") == mplan.grid_digest \
                and ex.get("cell"):
            live[ex["cell"]] = e["rid"]
    for cid in to_run:
        if cid in live:
            # survivor of an interrupted search over this fleet dir:
            # its entry (fork instruction included) is already durable
            requests[cid] = live[cid]
            continue
        cell = cells_by_id[cid]
        extra = {"grid_digest": mplan.grid_digest, "cell": cid,
                 "axes": dict(cell.labels),
                 "search_digest": splan.search_digest}
        if cid in forks_meta:
            extra["memo_fork"] = forks_meta[cid]
        rid = f"sr{nonce}-{next(seq):04d}"
        journal.record_submit(rid, cell.spec, label=f"search:{cid}",
                              ledger_extra=extra)
        requests[cid] = rid
        counts["live_probes"] += 1
        rspec = mplan.resolved[cid]
        chunks["simulated"] += rspec.sim_ms // rspec.chunk_ms \
            - (forks_meta[cid]["fork_ms"] // rspec.chunk_ms
               if cid in forks_meta else 0)
    t0 = time.time()
    saw_all_exited = False
    while True:
        by_cell, by_digest = _fleet_join(mplan, paths["ledger_path"])
        missing = _fleet_serve(mplan, by_cell, by_digest, to_run,
                               results, None)
        if missing:
            for rid, st in journal.settled().items():
                if st != "quarantined":
                    continue
                ex = (journal.lookup(rid) or {}) \
                    .get("ledger_extra") or {}
                cid = ex.get("cell")
                if ex.get("grid_digest") == mplan.grid_digest \
                        and cid in missing:
                    results[cid] = {
                        "status": "error",
                        "error": f"fleet: entry {rid} quarantined "
                                 "(poison lane) — see the workers' "
                                 "logs"}
                    missing.remove(cid)
        if not missing:
            return
        if procs and all(p.poll() is not None for p in procs):
            if not saw_all_exited:
                saw_all_exited = True
                continue
            logs = sorted({getattr(p, "log_path", "?")
                           for p in procs})
            raise RuntimeError(
                f"fleet search: all {len(procs)} worker process(es) "
                f"exited with {len(missing)} probe(s) unserved "
                f"({missing[:4]}{'...' if len(missing) > 4 else ''})."
                f" Worker logs: {logs}")
        if time.time() - t0 > timeout_s:
            raise RuntimeError(
                f"fleet search: round incomplete after "
                f"{timeout_s:.0f}s — {len(missing)} probe(s) "
                f"unserved ({missing[:4]}...). The journal entries "
                "survive; re-running the search over the same "
                "fleet_dir resumes them")
        time.sleep(poll_s)


def _run_search_fleet(spec: SearchSpec, splan: SearchPlan, *,
                      fleet_dir, workers: int = 2, memo=True,
                      progress=None, lease_ttl_s: float = 10.0,
                      poll_s: float = 0.3, timeout_s: float = 900.0,
                      spawn: bool = True, on_spawned=None,
                      timeline=None, device=None) -> SearchRun:
    """`run_search(workers=N)`'s engine: the same round loop as the
    in-process path, with probes completed by worker PROCESSES over
    the shared fleet directory and prefixes shared through the on-disk
    memo table every worker opens (``--memo-table``).  Workers are
    spawned without an idle-exit (a search has quiet gaps between
    rounds) and reaped in the `finally`; `spawn=False` skips spawning
    (the caller runs its own workers — they must share the table for
    forked probes to match the single-process rows).  `device` is each
    spawned worker's ``--device`` (``cuda`` unless given)."""
    import os
    import uuid

    from ..serve.fleet import (aggregate_worker_stats, fleet_paths,
                               spawn_worker)
    from ..serve.journal import SubmissionJournal

    mplan = splan.mplan
    paths = fleet_paths(fleet_dir)
    journal = SubmissionJournal(paths["journal_dir"])
    t0 = time.time()
    mcfg = table = memo_stats = None
    table_dir = None
    if memo:
        from ..memo import MemoConfig
        from ..memo.table import MemoTable
        mcfg = MemoConfig.coerce(memo)
        if mcfg.fork:
            table_dir = mcfg.table if mcfg.table is not None \
                else os.path.join(str(fleet_dir), "memo_table")
            table = MemoTable(table_dir)
            memo_stats = {"fork_groups": 0,
                          "predicted_chunks_saved": 0,
                          "prefix_runs": 0, "prefix_failed": 0,
                          "table_hits": 0, "forked_cells": 0,
                          "fork_vetoed": 0, "prefix_chunks_saved": 0}
    results: dict = {}
    requests: dict = {}
    counts = {"ledger_hits": 0, "deduped": 0, "live_probes": 0}
    chunks = {"simulated": 0, "exhaustive": splan.chunks_exhaustive()}
    nonce = uuid.uuid4().hex[:8]
    seq = itertools.count()
    procs = []
    if spawn:
        procs = [spawn_worker(fleet_dir, f"w{i}",
                              lease_ttl_s=lease_ttl_s,
                              idle_exit_s=None, max_wall_s=timeout_s,
                              memo_table=table_dir, timeline=timeline,
                              device=device)
                 for i in range(int(workers))]
    if on_spawned is not None:
        on_spawned(procs)
    states = [_SliceState(sl, splan.coarse_idx)
              for sl in splan.slices]
    probes: list = []
    rows: list = []
    row_ids: set = set()
    round_no = 0
    try:
        while True:
            wanted = []
            for st in states:
                for i in st.next_probes():
                    wanted.append((st, i))
            if not wanted:
                break
            cids = []
            for st, i in wanted:
                cid = st.sl.cell_ids[i]
                if cid not in cids:
                    cids.append(cid)
            _fleet_probe_round(splan, paths, journal, cids, results,
                               requests, table, mcfg, memo_stats,
                               counts, chunks, nonce, seq, procs,
                               timeout_s, poll_s)
            for st, i in wanted:
                cid = st.sl.cell_ids[i]
                result = results.get(cid, {"status": "error",
                                           "error": "never scheduled"})
                row = _cell_row(
                    next(c for c in mplan.cells if c.id == cid),
                    mplan.resolved[cid], result, None)
                if cid not in row_ids:
                    row_ids.add(cid)
                    rows.append(row)
                v, val, err = probe_verdict(spec.predicate, row,
                                            mplan.resolved[cid])
                st.observe(i, v, val, err)
                probes.append({"cell": cid, "slice": st.sl.id,
                               "label": splan.axis_labels[i],
                               "round": round_no, "verdict": v,
                               "value": val})
            round_no += 1
            if progress is not None:
                progress({"round": round_no, "probed": len(rows),
                          "slices_open": sum(1 for s in states
                                             if s.status ==
                                             "probing"),
                          "chunks_simulated": chunks["simulated"],
                          "wall_s": round(time.time() - t0, 3)})
    finally:
        # search workers run without idle-exit (rounds have quiet
        # gaps) — reap them explicitly; their stats snapshots land
        # every poll cycle, so SIGTERM loses at most one cycle
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10.0
        for p in procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                p.kill()
    agg = aggregate_worker_stats(fleet_dir)
    resume_counts = {
        "fleet_workers": int(workers),
        "journal_replayed": agg["counters"].get("claimed", 0),
        "worker_deduped": agg["counters"].get("deduped", 0),
        "adopted_checkpoints": agg["counters"].get(
            "adopted_checkpoints", 0),
        "memo_table_hits": agg["counters"].get("memo_table_hits", 0),
        "memo_table_misses": agg["counters"].get(
            "memo_table_misses", 0)}
    if memo_stats is not None:
        memo_stats["table"] = table.stats()
    report = SearchReport.build(
        splan, states, probes, rows, wall_s=time.time() - t0,
        counts=counts, chunks=chunks, memo_stats=memo_stats,
        resume=resume_counts)
    return SearchRun(report=report, plan=splan, artifacts={},
                     requests=requests)
