"""`Service` — the submit/status/result surface of the request plane;
the port of `Service` from `wittgenstein_tpu/serve/service.py`.

Transport-agnostic like `server/core.Server`: the HTTP layer
(`server/http.py` `/w/batch/*`) and in-process callers drive the same
object.  JSON in, JSON out, every payload the JAX service's:

  submit(spec_json)  -> {"id", "status", "compile_key"}; a bad spec
                        raises ValueError with remedy text (the HTTP
                        layer's 400)
  status(id)         -> lifecycle + the streaming-progress snapshot the
                        scheduler refreshes from the metrics plane at
                        every chunk boundary
  result(id)         -> the finished request's artifacts (engine_metrics
                        / trace / audit blocks, summary, manifest path);
                        a not-yet-done request answers with its status
  registry_stats(), tenancy_stats(), memo_stats(), health(), metrics()
                     -> the `/w/batch/{registry,tenancy,memo,health,
                        metrics}` blocks
  programs()         -> the program observatory's report
                        (`obs/programs.ProgramCatalog.report`), or
                        ``{"catalog": "off", ...}`` without a catalog
  recover(), stream(id, after_ms, timeout_s)

Sweep grids (`matrix/`) ride the same scheduler through the
`/w/matrix/*` trio: `matrix_submit(grid_json)` plans eagerly (cells +
planned compiles come back immediately; auto mode starts the run on its
own thread), `matrix_status(id)` streams cells done / program builds /
wall, and `matrix_report(id)` returns the ONE cross-cell `MatrixReport`
artifact; `matrix_run(id)` is the manual-mode synchronous drive.
Boundary searches (`matrix/search.py`) have the same four under
`search_*`.

``auto=True`` (the server default) drains the queue on a background
worker thread; with ``auto=False`` (tests, the chip smoke) the caller
drains explicitly via `run_pending()`.  The service's scheduler runs on
`device` (``cuda`` unless given).

`FleetService` is the front tier over a shared fleet directory
(serve/fleet.py): the same JSON surface for the batch routes and the
searches, backed by the journal, the lease table and the shared ledger;
its `programs` summarizes the workers' ``programs-*.jsonl`` catalogs.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from .scheduler import AdmissionError, Scheduler, TenantPolicy
from .spec import ScenarioSpec


@dataclasses.dataclass
class _MatrixJob:
    """One submitted sweep grid (service-internal mutable record)."""

    id: str
    grid: object                    # matrix.SweepGrid
    plan: object                    # matrix.MatrixPlan
    status: str = "planned"         # planned | running | done | error
    progress: dict = dataclasses.field(default_factory=dict)
    report: dict | None = None
    error: str | None = None
    submitted: float = dataclasses.field(default_factory=time.time)
    finished: float | None = None

    def status_json(self) -> dict:
        out = {"id": self.id, "status": self.status,
               "grid_digest": self.plan.grid_digest,
               "cells_total": len(self.plan.cells),
               "planned_compiles": self.plan.planned_compiles}
        if self.progress:
            out["progress"] = dict(self.progress)
        if self.error:
            out["error"] = self.error
        return out


@dataclasses.dataclass
class _SearchJob:
    """One submitted boundary search (service-internal mutable
    record — the `_MatrixJob` shape with search identities)."""

    id: str
    spec: object                    # matrix.SearchSpec
    plan: object                    # matrix.SearchPlan
    status: str = "planned"         # planned | running | done | error
    progress: dict = dataclasses.field(default_factory=dict)
    report: dict | None = None
    error: str | None = None
    submitted: float = dataclasses.field(default_factory=time.time)
    finished: float | None = None

    def status_json(self) -> dict:
        out = {"id": self.id, "status": self.status,
               "search_digest": self.plan.search_digest,
               "grid_digest": self.plan.grid_digest,
               "slices": len(self.plan.slices),
               "cells_exhaustive": len(self.plan.mplan.cells)}
        if self.progress:
            out["progress"] = dict(self.progress)
        if self.error:
            out["error"] = self.error
        return out


class Service:
    """See module docstring."""

    #: lock inventory (analysis rule ``host_locks``): the matrix- and
    #: search-job tables are shared between the caller's thread
    #: (submit/status) and the per-job threads; `_wake`/`_stop`
    #: are intentionally unowned (Event is self-synchronizing; `_stop`
    #: is a monotonic close flag read by the drain loop).
    _LOCK_OWNS = {"_matrix_mu": ("_matrix", "_matrix_n",
                                 "_search", "_search_n",
                                 "_search_counters")}

    def __init__(self, scheduler: Scheduler | None = None,
                 auto: bool = True, device=None):
        self.scheduler = scheduler or Scheduler(device=device)
        self._auto = auto
        self._wake = threading.Event()
        self._stop = False
        self._worker = None
        self._matrix: dict = {}
        self._matrix_n = 0
        self._search: dict = {}
        self._search_n = 0
        #: monotone lifetime sums over finished searches' accounting
        #: (memo table hits/misses, prefix chunks saved, probes) —
        #: what `metrics()` projects via the max-keeping counters
        self._search_counters: dict = {}
        self._matrix_mu = threading.Lock()

    # ------------------------------------------------------------ worker

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain_loop,
                                            daemon=True,
                                            name="wtpu-serve-worker")
            self._worker.start()

    def _drain_loop(self):
        while not self._stop:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            if self._stop:
                return
            if self.scheduler.pending():
                self.scheduler.run_pending()

    def close(self):
        self._stop = True
        self._wake.set()
        if self._worker is not None:
            self._worker.join(timeout=5)

    # --------------------------------------------------------- endpoints

    def submit(self, body: dict) -> dict:
        """POST /w/batch/submit — body is a `ScenarioSpec` JSON object."""
        spec = ScenarioSpec.from_json(body or {})
        rid = self.scheduler.submit(spec)
        if self._auto:
            self._ensure_worker()
            self._wake.set()
        req = self.scheduler.request(rid)
        return {"id": rid, "status": req.status,
                "compile_key": req.compile_key}

    def status(self, rid: str) -> dict:
        """GET /w/batch/status/{id}."""
        return self.scheduler.request(rid).status_json()

    def result(self, rid: str) -> dict:
        """GET /w/batch/result/{id} — artifacts when done, else the
        status snapshot (poll until ``"status" == "done"``)."""
        req = self.scheduler.request(rid)
        if req.status != "done":
            return req.status_json()
        out = dict(req.artifacts)
        out["status"] = "done"
        if req.manifest_path:
            out["manifest_path"] = req.manifest_path
        return out

    def run_pending(self) -> dict:
        """POST /w/batch/run — synchronous drain (manual mode / ops)."""
        return self.scheduler.run_pending()

    def registry_stats(self) -> dict:
        """GET /w/batch/registry."""
        return self.scheduler.registry.registry_block()

    def tenancy_stats(self) -> dict:
        """GET /w/batch/tenancy — per-tenant queue depth + lifetime
        counters, the DRR knobs, and the chunk-wall EMA behind
        retry-after estimates."""
        return self.scheduler.tenancy_stats()

    def memo_stats(self) -> dict:
        """GET /w/batch/memo — snapshot-fork / lane-freeze accounting."""
        return self.scheduler.memo_stats()

    def health(self) -> dict:
        """GET /w/batch/health — uptime, per-tenant queue depths,
        journal lag, quarantine count, watchdog trips and the chunk-wall
        EMA (`Scheduler.health_stats`)."""
        return self.scheduler.health_stats()

    def metrics(self) -> str:
        """GET /w/batch/metrics — Prometheus text exposition
        (wittgenstein_tpu/serve/service.py:205-224): the counters
        project from the scheduler's own monotone state, the finished
        searches' sums and the program catalog when one is attached,
        with or without an `Instrumentation`."""
        from ..obs.metrics import MetricsRegistry
        from .instrument import (refresh_scheduler_metrics,
                                 refresh_search_counters)
        ins = getattr(self.scheduler, "_ins", None)
        metrics = ins.metrics if ins is not None else MetricsRegistry()
        refresh_scheduler_metrics(metrics, self.scheduler)
        with self._matrix_mu:
            sc = dict(self._search_counters)
        refresh_search_counters(metrics, sc)
        cat = getattr(self.scheduler, "catalog", None)
        if cat is not None:
            from ..obs.programs import refresh_catalog_metrics
            refresh_catalog_metrics(metrics, cat)
        return metrics.exposition()

    def programs(self) -> dict:
        """GET /w/batch/programs — the program observatory report
        (obs/programs.ProgramCatalog.report): the program table, the
        top compile-wall consumers and the working-set pass.
        ``{"catalog": "off"}`` when no catalog is attached."""
        cat = getattr(self.scheduler, "catalog", None)
        if cat is None:
            return {"catalog": "off", "programs": [], "count": 0}
        return cat.report()

    def recover(self) -> dict:
        """Crash-only restart seam: replay group checkpoints, then the
        submission journal (`Scheduler.recover`), and — in auto mode —
        kick the worker so the survivors drain immediately."""
        out = self.scheduler.recover()
        if self._auto and (out["checkpoints"] or out["journal"]):
            self._ensure_worker()
            self._wake.set()
        return out

    def stream(self, rid: str, after_ms=None, timeout_s=25.0) -> dict:
        """GET /w/batch/stream/{id}[?after=MS&timeout=S] — long-poll
        streaming partial metrics (`Scheduler.stream_chunks`)."""
        return self.scheduler.stream_chunks(
            rid, after_ms=after_ms,
            timeout_s=float(timeout_s if timeout_s is not None
                            else 25.0))

    # ---------------------------------------------- matrix (sweep grids)

    def matrix_submit(self, body: dict) -> dict:
        """POST /w/matrix/submit — body is a `SweepGrid` JSON object.
        Plans EAGERLY (every cell validated, grouped by compile key —
        a malformed grid or cell raises ValueError with the cell named,
        the HTTP layer's 400) and, in auto mode, starts the run on a
        worker thread; in manual mode the caller drives it with
        `matrix_run(id)` (POST /w/matrix/run/{id})."""
        from ..matrix import SweepGrid, plan

        grid = SweepGrid.from_json(body or {})
        mplan = plan(grid)
        with self._matrix_mu:
            self._matrix_n += 1
            mid = f"m{self._matrix_n:04d}"
            job = _MatrixJob(id=mid, grid=grid, plan=mplan)
            self._matrix[mid] = job
        if self._auto:
            threading.Thread(target=self._matrix_drive, args=(job,),
                             daemon=True,
                             name=f"wtpu-matrix-{mid}").start()
        return {"id": mid, "status": job.status,
                "grid_digest": mplan.grid_digest,
                "cells": len(mplan.cells),
                "planned_compiles": mplan.planned_compiles}

    def _matrix_job(self, mid: str) -> _MatrixJob:
        with self._matrix_mu:
            if mid not in self._matrix:
                raise KeyError(f"unknown matrix job {mid!r}")
            return self._matrix[mid]

    def _matrix_drive(self, job: _MatrixJob):
        """Run one planned grid on the shared scheduler.  States are
        not retained (the report + ledger rows are the service
        products; bit-identity verification is the CLI/tests' job).
        strict_builds=False: the scheduler is shared with /w/batch
        traffic and other matrix jobs, so the registry's global miss
        counter cannot be attributed to this run — the report records
        the measured delta without asserting on it."""
        from ..matrix import run_grid

        with self._matrix_mu:
            if job.status != "planned":
                return                  # one drive per job
            job.status = "running"
        try:
            run = run_grid(job.grid, self.scheduler, plan_=job.plan,
                           keep_states=(), strict_builds=False,
                           progress=lambda p: job.progress.update(p))
            job.report = run.report.to_json()
            job.status = "done"
        except Exception as e:          # noqa: BLE001 — a broken grid
            # must not take the service thread down silently
            job.status, job.error = "error", f"{type(e).__name__}: " \
                                            f"{e!s:.500}"
        finally:
            job.finished = time.time()
            self._evict_matrix()

    #: finished matrix jobs retained for report polling (the batch
    #: plane's keep_done convention — each done job holds a full
    #: MatrixReport JSON, megabytes for thousand-cell campaigns)
    keep_done_matrix = 64

    def _evict_matrix(self):
        """Drop the oldest finished jobs past `keep_done_matrix` so a
        long-lived server's matrix table cannot grow without bound."""
        with self._matrix_mu:
            done = sorted((j for j in self._matrix.values()
                           if j.status in ("done", "error")),
                          key=lambda j: j.finished or 0.0)
            for j in done[:max(0, len(done) - self.keep_done_matrix)]:
                del self._matrix[j.id]

    def matrix_run(self, mid: str) -> dict:
        """POST /w/matrix/run/{id} — synchronous drive (manual mode /
        ops; a no-op returning status when already running or done)."""
        job = self._matrix_job(mid)
        if job.status == "planned":
            self._matrix_drive(job)
        return job.status_json()

    def matrix_status(self, mid: str) -> dict:
        """GET /w/matrix/status/{id} — lifecycle + live progress (cells
        done / program builds / wall)."""
        return self._matrix_job(mid).status_json()

    def matrix_report(self, mid: str) -> dict:
        """GET /w/matrix/report/{id} — the `MatrixReport` artifact when
        done, else the status snapshot (poll-friendly, the
        /w/batch/result convention)."""
        job = self._matrix_job(mid)
        if job.status != "done":
            return job.status_json()
        out = dict(job.report)
        out["status"] = "done"
        return out

    # ------------------------------------------ search (boundary scans)

    def search_submit(self, body: dict) -> dict:
        """POST /w/matrix/search/submit — body is a `SearchSpec` JSON
        object (grid + axis + predicate).  Compiles EAGERLY (every
        grid cell validated, the probe plan derived — a malformed spec
        raises ValueError with remedy text, the HTTP layer's 400) and,
        in auto mode, starts the campaign on a worker thread; manual
        mode drives it with `search_run(id)`."""
        from ..matrix import SearchSpec, compile_search

        spec = SearchSpec.from_json(body or {})
        splan = compile_search(spec)
        with self._matrix_mu:
            self._search_n += 1
            sid = f"s{self._search_n:04d}"
            job = _SearchJob(id=sid, spec=spec, plan=splan)
            self._search[sid] = job
        if self._auto:
            threading.Thread(target=self._search_drive, args=(job,),
                             daemon=True,
                             name=f"wtpu-search-{sid}").start()
        return {"id": sid, "status": job.status,
                "search_digest": splan.search_digest,
                "grid_digest": splan.grid_digest,
                "slices": len(splan.slices),
                "cells_exhaustive": len(splan.mplan.cells)}

    def _search_job(self, sid: str) -> _SearchJob:
        with self._matrix_mu:
            if sid not in self._search:
                raise KeyError(f"unknown search job {sid!r}")
            return self._search[sid]

    def _search_drive(self, job: _SearchJob):
        """Run one compiled search on the shared scheduler.  Probes
        ride the same memo fork seam as `run_grid(memo=True)`; the
        finished report's accounting folds into the service's monotone
        search counters (the metrics projection source)."""
        from ..matrix import run_search

        with self._matrix_mu:
            if job.status != "planned":
                return                  # one drive per job
            job.status = "running"
        try:
            run = run_search(job.spec, self.scheduler, splan=job.plan,
                             progress=lambda p: job.progress.update(p))
            job.report = run.report.to_json()
            job.status = "done"
            acct = job.report.get("accounting") or {}
            memo = acct.get("memo") or {}
            table = memo.get("table") or {}
            with self._matrix_mu:
                sc = self._search_counters
                sc["search_probes_total"] = \
                    sc.get("search_probes_total", 0) \
                    + job.report.get("cells_probed", 0)
                sc["prefix_chunks_saved"] = \
                    sc.get("prefix_chunks_saved", 0) \
                    + memo.get("prefix_chunks_saved", 0)
                sc["memo_table_hits"] = sc.get("memo_table_hits", 0) \
                    + table.get("hits", 0)
                sc["memo_table_misses"] = \
                    sc.get("memo_table_misses", 0) \
                    + table.get("misses", 0)
        except Exception as e:          # noqa: BLE001 — a broken
            # search must not take the service thread down silently
            job.status, job.error = "error", f"{type(e).__name__}: " \
                                            f"{e!s:.500}"
        finally:
            job.finished = time.time()
            self._evict_search()

    #: finished search jobs retained for report polling
    keep_done_search = 64

    def _evict_search(self):
        """Drop the oldest finished search jobs past
        `keep_done_search` (the matrix eviction convention)."""
        with self._matrix_mu:
            done = sorted((j for j in self._search.values()
                           if j.status in ("done", "error")),
                          key=lambda j: j.finished or 0.0)
            for j in done[:max(0, len(done) - self.keep_done_search)]:
                del self._search[j.id]

    def search_run(self, sid: str) -> dict:
        """POST /w/matrix/search/run/{id} — synchronous drive (manual
        mode / ops; a no-op returning status when already running or
        done)."""
        job = self._search_job(sid)
        if job.status == "planned":
            self._search_drive(job)
        return job.status_json()

    def search_status(self, sid: str) -> dict:
        """GET /w/matrix/search/status/{id} — lifecycle + live
        progress (round / probes / chunks simulated / wall)."""
        return self._search_job(sid).status_json()

    def search_report(self, sid: str) -> dict:
        """GET /w/matrix/search/report/{id} — the `SearchReport`
        artifact when done, else the status snapshot
        (poll-friendly)."""
        job = self._search_job(sid)
        if job.status != "done":
            return job.status_json()
        out = dict(job.report)
        out["status"] = "done"
        return out


class FleetService:
    """Front tier over a shared fleet directory (serve/fleet.py): the
    `Service` JSON surface for the core batch routes, backed by FILES
    instead of an in-process scheduler.  Submits are fsync'd journal
    appends (durable-ack — the same fsync-before-ack promise as
    `Scheduler.submit` with a journal, minus the in-process queue),
    status reads journal tombstones + the lease table (a leased entry
    is "running", with the holding worker named), results are served
    from the shared ledger's completion rows (the digest join —
    bit-identical to the worker's live artifacts by construction), and
    health/registry aggregate the workers' atomically-published stats
    snapshots.

    The 429 tenancy contract is preserved front-side: a tenant's LIVE
    (accepted-but-unsettled) journal entries count against its
    `max_queued`, and refusals carry a retry-after derived from the
    fleet's aggregated chunk-wall EMA — `AdmissionError` flows through
    `server/http.py` exactly as the single-process path does.  Fairness
    WITHIN the fleet stays with the workers' own schedulers (DRR over
    whatever each worker has leased).

    Long-poll streaming and the matrix routes need an in-process
    scheduler and are not served by the front tier — drive those
    against a worker, or use `matrix.run_grid(workers=N)`.
    """

    #: lock inventory (analysis rule ``host_locks``): the rid counter,
    #: the rid->digest result-join cache and the search-job table are
    #: touched from every HTTP thread (plus the search
    #: threads).
    _LOCK_OWNS = {"_mu": ("_n", "_digests", "_search", "_search_n")}

    def __init__(self, fleet_dir, *, front_id: str | None = None,
                 tenants: dict | None = None):
        import os

        from .fleet import fleet_paths
        from .journal import LeaseTable, SubmissionJournal
        self.paths = fleet_paths(fleet_dir)
        self.journal = SubmissionJournal(self.paths["journal_dir"])
        self.leases = LeaseTable(self.paths["journal_dir"])
        #: rid prefix — pid-salted by default so a restarted front
        #: tier can never re-mint a rid the journal already holds
        self.front_id = str(front_id) if front_id \
            else f"front{os.getpid()}"
        self.tenants = {name: (pol if isinstance(pol, TenantPolicy)
                               else TenantPolicy(**pol))
                        for name, pol in (tenants or {}).items()}
        self._mu = threading.Lock()
        self._n = 0
        self._digests: dict = {}    # rid -> as-submitted spec digest
        self._search: dict = {}     # sid -> _SearchJob
        self._search_n = 0

    # ---------------------------------------------------------- admission

    def policy(self, tenant: str) -> TenantPolicy:
        pol = self.tenants.get(tenant) or self.tenants.get("*")
        return pol or TenantPolicy()

    def _admit(self, resolved: ScenarioSpec):
        """The front-side 429: live journal entries are the fleet's
        queue, so they are what bounds a tenant (mirrors
        `Scheduler._admit`, which counts in-process queued requests)."""
        pol = self.policy(resolved.tenant)
        if not pol.max_queued:
            return
        mine = [e for e in self.journal.replay()
                if (e.get("spec") or {}).get("tenant", "default")
                == resolved.tenant]
        if len(mine) < pol.max_queued:
            return
        backlog_chunks = 0
        for e in mine:
            s = e.get("spec") or {}
            try:
                backlog_chunks += (int(s.get("sim_ms", 0))
                                   // max(1, int(s.get("chunk_ms", 1))))
            except (TypeError, ValueError) as ex:
                import sys
                print(f"fleet front: journal entry {e.get('rid')!r} "
                      f"has non-numeric sim_ms/chunk_ms ({ex}); it "
                      "still counts against the tenant's queue but "
                      "not the retry-after backlog", file=sys.stderr)
        retry = max(pol.retry_after_s,
                    backlog_chunks * self._fleet_ema())
        raise AdmissionError(
            f"tenant {resolved.tenant!r} fleet backlog is full "
            f"({len(mine)}/{pol.max_queued} unsettled submissions): "
            f"retry after ~{retry:.1f}s, raise the tenant's "
            "max_queued, or split the submission across tenants",
            retry_after_s=retry)

    # --------------------------------------------------------- endpoints

    def submit(self, body: dict) -> dict:
        """POST /w/batch/submit — validate, admit, fsync the journal
        row, THEN ack (the durable-ack order; an OSError from the
        append raises through as a loud 500-equivalent, never a silent
        ack)."""
        spec = ScenarioSpec.from_json(body or {})
        resolved = spec.validate()
        self._admit(resolved)
        with self._mu:
            self._n += 1
            rid = f"{self.front_id}-r{self._n:04d}"
        self.journal.record_submit(rid, spec)
        with self._mu:
            self._digests[rid] = spec.digest()
        return {"id": rid, "status": "queued",
                "compile_key": resolved.compile_key()}

    def status(self, rid: str) -> dict:
        """GET /w/batch/status/{id} — journal tombstone beats lease
        beats queue; unknown rids raise KeyError (the 400 path, like
        `Scheduler.request`)."""
        settled = self.journal.settled()
        if rid in settled:
            return {"id": rid, "status": settled[rid]}
        if any(e.get("rid") == rid for e in self.journal.replay()):
            w = self.leases.holder(rid)
            if w is not None:
                return {"id": rid, "status": "running", "worker": w}
            return {"id": rid, "status": "queued"}
        raise KeyError(f"unknown request {rid!r}")

    def _digest_of(self, rid: str):
        with self._mu:
            dig = self._digests.get(rid)
        if dig is not None:
            return dig
        # a restarted front tier recovers the digest from the journal's
        # submit row (still present until a quiescent compaction)
        row = self.journal.lookup(rid)
        if row is not None:
            try:
                return ScenarioSpec.from_json(row["spec"]).digest()
            except (KeyError, ValueError, TypeError) as e:
                import sys
                print(f"fleet front: journal row for {rid!r} has no "
                      f"parseable spec ({type(e).__name__}: "
                      f"{e!s:.120}); result() falls back to the "
                      "status snapshot", file=sys.stderr)
                return None
        return None

    def result(self, rid: str) -> dict:
        """GET /w/batch/result/{id} — the ledger row's durable
        completion facts when done (summary, audit verdict,
        time_to_done), else the status snapshot (poll-friendly)."""
        out = self.status(rid)
        if out["status"] != "done":
            return out
        from ..matrix.driver import _row_artifacts
        from .fleet import clean_rows_by_digest
        dig = self._digest_of(rid)
        row = clean_rows_by_digest(
            self.paths["ledger_path"]).get(dig) if dig else None
        if row is None:
            out["note"] = ("completed (journal tombstone) but no clean "
                           "ledger row found — ledger compacted or "
                           "spec digest unrecoverable")
            return out
        return {**out, "artifacts": _row_artifacts(row)}

    def run_pending(self) -> dict:
        """POST /w/batch/run — the workers drain; the front tier has
        nothing to run (kept so manual-mode callers get an honest
        answer instead of a 404)."""
        return {"processed": 0, "fleet": True,
                "journal_lag": self.journal.lag()}

    # ------------------------------------------------------- aggregation

    def worker_stats(self) -> dict:
        """worker id -> its last atomically-published stats snapshot
        (serve/fleet.py `FleetWorker.write_stats`); unreadable files
        are skipped with a stderr note (a worker mid-first-write)."""
        import glob
        import json
        import os
        import sys
        out: dict = {}
        for path in sorted(glob.glob(os.path.join(
                self.paths["stats_dir"], "worker-*.json"))):
            try:
                with open(path) as f:
                    row = json.load(f)
            except (OSError, ValueError) as e:
                print(f"fleet front: unreadable worker stats {path} "
                      f"({e}); skipped", file=sys.stderr)
                continue
            out[str(row.get("worker")
                    or os.path.basename(path))] = row
        return out

    def _fleet_ema(self) -> float:
        """Mean chunk-wall EMA across workers that have one — the
        front tier's retry-after unit cost (1.0 s while cold)."""
        emas = [w.get("health", {}).get("chunk_wall_ema_s") or 0.0
                for w in self.worker_stats().values()]
        emas = [e for e in emas if e > 0]
        return sum(emas) / len(emas) if emas else 1.0

    def health(self) -> dict:
        """GET /w/batch/health — the fleet aggregation: journal lag,
        the lease table (who runs what), queue depths derived from
        live-but-unleased entries, and each worker's own health
        block."""
        live = self.journal.replay()
        leased = self.leases.live()
        queued_by_tenant: dict = {}
        for e in live:
            if e.get("rid") in leased:
                continue
            t = (e.get("spec") or {}).get("tenant", "default")
            queued_by_tenant[t] = queued_by_tenant.get(t, 0) + 1
        workers = self.worker_stats()
        return {"fleet": True,
                "queued": sum(queued_by_tenant.values()),
                "queued_by_tenant": queued_by_tenant,
                "running": len(leased),
                "journal": True,
                "journal_lag": len(live),
                "leases": self.leases.workers(),
                "chunk_wall_ema_s": round(self._fleet_ema(), 4),
                "workers": {wid: w.get("health", {})
                            for wid, w in workers.items()},
                "worker_counters": {
                    wid: {k: w[k] for k in
                          ("claimed", "deduped", "released",
                           "adopted_checkpoints", "processed")
                          if k in w}
                    for wid, w in workers.items()}}

    def metrics(self) -> str:
        """GET /w/batch/metrics — the fleet exposition: each worker's
        monotone counters (published atomically via write_stats)
        summed fleet-wide, front-tier admission counts, and the
        queue/lag gauges.  Sums of per-worker monotone series stay
        monotone, so repeated scrapes never read backwards."""
        from ..obs.metrics import MetricsRegistry
        from .instrument import (FLEET_COUNTERS, RESILIENCE_COUNTERS,
                                 SEARCH_COUNTERS)
        reg = MetricsRegistry()
        sums: dict = {}
        for w in self.worker_stats().values():
            for k, v in w.items():
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    sums[k] = sums.get(k, 0) + v
            for k, v in (w.get("resilience") or {}).items():
                if isinstance(v, (int, float)):
                    sums["res_" + k] = sums.get("res_" + k, 0) + v
        for k, name in FLEET_COUNTERS.items():
            reg.set_counter(name, sums.get(k, 0))
        for k, name in RESILIENCE_COUNTERS.items():
            reg.set_counter(name, sums.get("res_" + k, 0))
        for k, name in SEARCH_COUNTERS.items():
            reg.set_counter(name, sums.get(k, 0))
        with self._mu:
            front_n = self._n
        reg.set_counter("wtpu_serve_submits_total",
                        front_n + sums.get("res_rejected", 0))
        h = self.health()
        reg.set_gauge("wtpu_serve_queue_depth", h["queued"])
        reg.set_gauge("wtpu_serve_running", h["running"])
        reg.set_gauge("wtpu_serve_journal_lag", h["journal_lag"])
        ema = h.get("chunk_wall_ema_s")
        if ema:
            reg.set_gauge("wtpu_serve_chunk_wall_ema_seconds", ema)
        return reg.exposition()

    def programs(self) -> dict:
        """GET /w/batch/programs — the fleet's program observatory:
        every worker's ``programs-*.jsonl`` catalog under the shared
        directory (written by workers launched with ``--catalog``; a
        JAX worker's rows read too), summarized as one cross-worker
        table.  No catalog rows = ``{"catalog": "off"}``."""
        import glob
        import os

        from ..obs.programs import read_catalog, summarize_programs
        files = sorted(glob.glob(os.path.join(self.paths["dir"],
                                              "programs*.jsonl")))
        rows = []
        for f in files:
            rows.extend(read_catalog(f))
        if not rows:
            return {"catalog": "off", "programs": [], "count": 0,
                    "fleet": True}
        out = summarize_programs(rows)
        out["catalog"] = {"fleet": True, "files": len(files),
                          "durable": True}
        return out

    def registry_stats(self) -> dict:
        """GET /w/batch/registry — numeric fields summed across the
        workers' registry blocks (requests-per-build across the fleet
        needs the SUM of builds, not any one worker's)."""
        agg: dict = {}
        per: dict = {}
        for wid, w in self.worker_stats().items():
            reg = w.get("registry") or {}
            per[wid] = reg
            for k, v in reg.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
        return {"fleet": True, "aggregate": agg, "workers": per}

    def tenancy_stats(self) -> dict:
        """GET /w/batch/tenancy — front-side queue depths + policies
        (per-worker DRR counters live in each worker's own stats)."""
        h = self.health()
        out = {"tenants": {}, "fleet": True,
               "chunk_wall_ema_s": h["chunk_wall_ema_s"]}
        for t in set(h["queued_by_tenant"]) | set(
                k for k in self.tenants if k != "*"):
            pol = self.policy(t)
            out["tenants"][t] = {
                "queued": h["queued_by_tenant"].get(t, 0),
                "weight": pol.weight, "max_queued": pol.max_queued}
        return out

    # ------------------------------------------ search (boundary scans)

    def search_submit(self, body: dict) -> dict:
        """POST /w/matrix/search/submit — the fleet front tier's
        search entry: compile eagerly, then drive the fleet round loop
        on a front-side thread.  Probes become durable journal entries
        the EXISTING workers complete (spawn=False — a FleetService
        deployment already runs its workers; point them at
        ``--memo-table`` for cross-worker prefix reuse)."""
        from ..matrix import SearchSpec, compile_search

        spec = SearchSpec.from_json(body or {})
        splan = compile_search(spec)
        with self._mu:
            self._search_n += 1
            sid = f"{self.front_id}-s{self._search_n:04d}"
            job = _SearchJob(id=sid, spec=spec, plan=splan)
            self._search[sid] = job
        threading.Thread(target=self._search_drive, args=(job,),
                         daemon=True,
                         name=f"wtpu-fleet-search-{sid}").start()
        return {"id": sid, "status": job.status,
                "search_digest": splan.search_digest,
                "grid_digest": splan.grid_digest,
                "slices": len(splan.slices),
                "cells_exhaustive": len(splan.mplan.cells)}

    def _search_job(self, sid: str) -> _SearchJob:
        with self._mu:
            if sid not in self._search:
                raise KeyError(f"unknown search job {sid!r}")
            return self._search[sid]

    def _search_drive(self, job: _SearchJob):
        from ..matrix.search import _run_search_fleet

        with self._mu:
            if job.status != "planned":
                return                  # one drive per job
            job.status = "running"
        try:
            run = _run_search_fleet(
                job.spec, job.plan, fleet_dir=self.paths["dir"],
                workers=0, spawn=False,
                progress=lambda p: job.progress.update(p))
            job.report = run.report.to_json()
            job.status = "done"
        except Exception as e:          # noqa: BLE001 — a broken
            # search must not take the front-tier thread down silently
            job.status, job.error = "error", f"{type(e).__name__}: " \
                                            f"{e!s:.500}"
        finally:
            job.finished = time.time()
            with self._mu:
                done = sorted((j for j in self._search.values()
                               if j.status in ("done", "error")),
                              key=lambda j: j.finished or 0.0)
                for j in done[:max(0, len(done)
                                   - Service.keep_done_search)]:
                    del self._search[j.id]

    def search_run(self, sid: str) -> dict:
        """POST /w/matrix/search/run/{id} — synchronous drive (manual
        mode; a no-op returning status when already running/done)."""
        job = self._search_job(sid)
        if job.status == "planned":
            self._search_drive(job)
        return job.status_json()

    def search_status(self, sid: str) -> dict:
        """GET /w/matrix/search/status/{id}."""
        return self._search_job(sid).status_json()

    def search_report(self, sid: str) -> dict:
        """GET /w/matrix/search/report/{id} — the `SearchReport` when
        done, else the status snapshot (poll-friendly)."""
        job = self._search_job(sid)
        if job.status != "done":
            return job.status_json()
        out = dict(job.report)
        out["status"] = "done"
        return out

    def close(self):
        """Symmetry with `Service.close` (nothing to stop: the front
        tier owns no threads)."""
