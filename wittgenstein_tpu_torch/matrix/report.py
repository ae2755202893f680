"""`MatrixReport` — one comparable artifact for a whole sweep grid; the
port of `wittgenstein_tpu/matrix/report.py`, pure host code over the
scheduler's artifacts, so the same results give byte-equal JSON in both
packages.

Per cell: the scheduler's final-state summary, the audit verdict, a
`time_to_done_ms` headline (earliest metrics interval at which the
run's final done_count was already reached — the time-to-aggregate
number the reference's protocol tables print), and, for every adverse
cell with a resolvable fault-free/attack-free twin in the SAME grid,
the impact deltas against that twin (what the adversity actually
cost, `chaos.impact_summary`'s counters).  Per axis: marginal aggregates
over the done cells at each label (mean done_count / msg_sent /
time_to_done, audit-clean and error counts) — "time-to-aggregate vs N
at each latency model" is then one `by_axis` lookup away, and the
per-cell rows keep every cross-tab computable offline.

The report is ONE JSON-able artifact (`to_json`/`from_json` round-trip
exactly; per-cell obs blocks stay OUT of it — they live in the
scheduler's in-memory artifacts and the per-cell ledger rows, keyed by
the same `grid_digest`), plus `format()` for humans and `clean` for
exit codes.
"""

from __future__ import annotations

import dataclasses
import json

#: shared with the serve scheduler (it persists the headline into each
#: ledger row's extra, which is how a resumed campaign's report rows
#: stay bit-identical to live ones); re-exported here for callers
from ..obs.export import time_to_done_ms  # noqa: F401

#: report schema version (bump on field changes; readers key on it)
SCHEMA = 1

#: the summary counters impact deltas are computed over — the
#: chaos.impact_summary fingerprint, shared so the matrix and the
#: chaos CLI can never disagree about what "impact" means
IMPACT_KEYS = ("done_count", "live_count", "msg_sent", "msg_received")


def _cell_row(cell, rspec, result, twin_summary) -> dict:
    row = {"cell": cell.id, "axes": dict(cell.labels),
           "spec_digest": cell.spec.digest(),
           "compile_key": rspec.compile_key(),
           "status": result.get("status", "error")}
    if row["status"] != "done":
        row["error"] = str(result.get("error", "unknown"))[:500]
        return row
    art = result["artifacts"]
    row["summary"] = dict(art["summary"])
    row["seeds"] = len(rspec.seeds)
    if "audit" in art:
        row["audit_clean"] = bool(art["audit"]["clean"])
        if not art["audit"]["clean"]:
            row["violations"] = {k: v for k, v in
                                 art["audit"]["violations"].items() if v}
    # a ledger-served cell (campaign resume / cross-grid dedup) carries
    # the headline directly — computed by the scheduler at finalize
    # from the same engine_metrics block, so the row is identical
    ttd = art.get("time_to_done_ms")
    if ttd is None:
        ttd = time_to_done_ms(art.get("engine_metrics"))
    if ttd is not None:
        row["time_to_done_ms"] = ttd
    if art.get("resumed_from_ms"):
        row["resumed_from_ms"] = art["resumed_from_ms"]
    if art.get("forked_from"):
        # snapshot-fork provenance (memo): the prefix-checkpoint digest
        # + fork ms, so `verify_cell` checks forked cells against
        # sequential twins instead of skipping them
        row["forked_from"] = dict(art["forked_from"])
    if twin_summary is not None:
        row["impact_vs_twin"] = {
            k: row["summary"][k] - twin_summary[k] for k in IMPACT_KEYS
            if k in row["summary"] and k in twin_summary}
    return row


def _axis_aggregates(grid, rows) -> dict:
    """Marginal per-axis tables: label -> aggregate over done cells."""
    out = {}
    for axis in grid.axes:
        table = {}
        for label in axis.labels:
            sel = [r for r in rows if r["axes"].get(axis.name) == label]
            done = [r for r in sel if r["status"] == "done"]
            agg = {"cells": len(sel), "done": len(done),
                   "errors": len(sel) - len(done)}
            if done:
                agg["audit_clean"] = sum(
                    1 for r in done if r.get("audit_clean", True))
                for key in ("done_count", "live_count", "msg_sent"):
                    vals = [r["summary"][key] for r in done
                            if key in r.get("summary", {})]
                    if vals:
                        agg[f"{key}_mean"] = round(
                            sum(vals) / len(vals), 2)
                ttds = [r["time_to_done_ms"] for r in done
                        if "time_to_done_ms" in r]
                if ttds:
                    agg["time_to_done_ms_mean"] = round(
                        sum(ttds) / len(ttds), 1)
                deltas = [r["impact_vs_twin"]["done_count"] for r in done
                          if "impact_vs_twin" in r
                          and "done_count" in r["impact_vs_twin"]]
                if deltas:
                    agg["done_delta_vs_twin_mean"] = round(
                        sum(deltas) / len(deltas), 2)
            table[label] = agg
        out[axis.name] = table
    return out


@dataclasses.dataclass
class MatrixReport:
    """One grid run's artifact (module docstring)."""

    data: dict

    # ----------------------------------------------------------- building

    @classmethod
    def build(cls, plan, results: dict, wall_s: float,
              compiles: dict | None = None,
              scheduler_stats: dict | None = None,
              resume: dict | None = None,
              memo: dict | None = None) -> "MatrixReport":
        """Assemble from a `MatrixPlan` + per-cell results
        (cell id -> {"status", "artifacts"|"error"}).  `resume` is the
        campaign runner's resume accounting (cells served from ledger
        rows / deduped across grids / checkpoint-resumed requests) —
        recorded as its own block so the cell rows stay identical to
        an uninterrupted run's.  `memo` is the snapshot-fork
        accounting (prefix runs, table hits, `prefix_chunks_saved`) —
        its own block for the same reason."""
        grid = plan.grid
        summaries = {cid: r["artifacts"]["summary"]
                     for cid, r in results.items()
                     if r.get("status") == "done"
                     and r.get("artifacts")}
        rows = []
        for cell in plan.cells:
            twin = grid.twin_id(cell.labels)
            rows.append(_cell_row(
                cell, plan.resolved[cell.id],
                results.get(cell.id, {"status": "error",
                                      "error": "never scheduled"}),
                summaries.get(twin) if twin else None))
        done = [r for r in rows if r["status"] == "done"]
        data = {
            "schema": SCHEMA,
            "name": grid.name,
            "grid_digest": plan.grid_digest,
            "grid": grid.to_json(),
            "cells_total": len(rows),
            "cells_done": len(done),
            "cells_error": len(rows) - len(done),
            "audit_violations": sum(
                1 for r in done if r.get("audit_clean") is False),
            "planned_compiles": plan.planned_compiles,
            "expected_builds": plan.expected_builds,
            "wall_s": round(float(wall_s), 3),
            "cells": rows,
            "by_axis": _axis_aggregates(grid, rows),
        }
        if compiles:
            data.update(compiles)       # program_builds / registry block
        if scheduler_stats:
            data["resilience"] = dict(scheduler_stats)
        if resume:
            data["resume"] = dict(resume)
        if memo:
            data["memo"] = dict(memo)
        return cls(data=data)

    # -------------------------------------------------------------- views

    @property
    def clean(self) -> bool:
        """No errored cells, no audit violations."""
        return (self.data["cells_error"] == 0
                and self.data["audit_violations"] == 0)

    @property
    def grid_digest(self) -> str:
        return self.data["grid_digest"]

    def cell(self, cell_id: str) -> dict:
        for row in self.data["cells"]:
            if row["cell"] == cell_id:
                return row
        raise KeyError(f"unknown cell {cell_id!r}")

    # ------------------------------------------------------- serialization

    def to_json(self) -> dict:
        return self.data

    @classmethod
    def from_json(cls, data) -> "MatrixReport":
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        if not isinstance(data, dict) or "grid_digest" not in data:
            raise ValueError("MatrixReport: expected a report JSON "
                             "object with a 'grid_digest'")
        if data.get("schema") != SCHEMA:
            raise ValueError(f"MatrixReport: schema "
                             f"{data.get('schema')!r} != {SCHEMA} — "
                             "re-run the grid with this tree")
        return cls(data=dict(data))

    def save(self, path) -> str:
        """Write the report atomically (write-temp + fsync +
        os.replace): the campaign report is what a resume run or an
        operator reads after a crash, so a kill mid-write must leave
        either the previous report or the new one — never a torn
        file (the crash-test parent reads this exact artifact)."""
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
        lines = [
            f"matrix {d['name']!r} [{d['grid_digest']}]: "
            f"{d['cells_done']}/{d['cells_total']} cells done, "
            f"{d['cells_error']} errors, "
            f"{d['audit_violations']} audit violation(s), "
            f"{d['planned_compiles']} compile keys"
            + (f", {d['program_builds']} program builds"
               if "program_builds" in d else "")
            + f", wall {d['wall_s']} s"]
        if "memo" in d:
            m = d["memo"]
            lines.append(
                f"  memo: {m.get('forked_cells', 0)} cells forked from "
                f"{m.get('prefix_runs', 0)} prefix run(s) "
                f"(+{m.get('table_hits', 0)} table hits), "
                f"{m.get('prefix_chunks_saved', 0)} prefix chunks saved"
                f" (plan predicted {m.get('predicted_chunks_saved', 0)})")
        for axis, table in d["by_axis"].items():
            lines.append(f"  axis {axis}:")
            for label, agg in table.items():
                bits = [f"{agg['done']}/{agg['cells']} done"]
                for k in ("done_count_mean", "time_to_done_ms_mean",
                          "msg_sent_mean", "done_delta_vs_twin_mean"):
                    if k in agg:
                        bits.append(f"{k.replace('_mean', '')}~"
                                    f"{agg[k]}")
                if agg.get("errors"):
                    bits.append(f"ERRORS={agg['errors']}")
                lines.append(f"    {label:>16}: {', '.join(bits)}")
        bad = [r for r in d["cells"]
               if r["status"] != "done" or r.get("audit_clean") is False]
        for r in bad[:20]:
            what = r.get("error") or f"violations {r.get('violations')}"
            lines.append(f"  !! {r['cell']}: {what}")
        if len(bad) > 20:
            lines.append(f"  !! ... and {len(bad) - 20} more")
        return "\n".join(lines)
