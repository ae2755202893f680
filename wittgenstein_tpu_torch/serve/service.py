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
  programs()         -> ``{"catalog": "off", ...}``: the program
                        observatory is not ported yet, and this is what
                        the JAX service answers without a catalog
  recover(), stream(id, after_ms, timeout_s)

``auto=True`` (the server default) drains the queue on a background
worker thread; with ``auto=False`` (tests, the chip smoke) the caller
drains explicitly via `run_pending()`.  The service's scheduler runs on
`device` (``cuda`` unless given).

Not ported yet (ROADMAP.md A14b): the sweep-grid and boundary-search
jobs (`matrix_*`, `search_*`; `_MatrixJob`, `_SearchJob`) and
`FleetService`.  Their methods raise `NotPorted`, which the HTTP layer
answers with 501 and the ROADMAP item — never a silent no-op.
"""

from __future__ import annotations

import threading

from .scheduler import Scheduler
from .spec import ScenarioSpec


class NotPorted(NotImplementedError):
    """A request-plane entry point of the JAX package that the port does
    not have yet; `http_status` is what `server/http.py` answers."""

    http_status = 501


def _not_ported(what: str):
    raise NotPorted(
        f"{what} is not ported yet: the sweep-grid and boundary-search "
        "planes (matrix/driver.py, matrix/search.py) and the fleet wait "
        "for ROADMAP.md A14b")


class Service:
    """See module docstring."""

    def __init__(self, scheduler: Scheduler | None = None,
                 auto: bool = True, device=None):
        self.scheduler = scheduler or Scheduler(device=device)
        self._auto = auto
        self._wake = threading.Event()
        self._stop = False
        self._worker = None

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
        (wittgenstein_tpu/serve/service.py:205-224, without the program
        catalog and with no search counters yet): the counters project
        from the scheduler's own monotone state, with or without an
        `Instrumentation`."""
        from ..obs.metrics import MetricsRegistry
        from .instrument import refresh_scheduler_metrics
        ins = getattr(self.scheduler, "_ins", None)
        metrics = ins.metrics if ins is not None else MetricsRegistry()
        refresh_scheduler_metrics(metrics, self.scheduler)
        return metrics.exposition()

    def programs(self) -> dict:
        """GET /w/batch/programs — the JAX service's answer when no
        program catalog is attached (the port has none yet)."""
        return {"catalog": "off", "programs": [], "count": 0}

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

    # ------------------------------- sweep grids and searches (A14b)

    def matrix_submit(self, body: dict) -> dict:
        _not_ported("POST /w/matrix/submit")

    def matrix_run(self, mid: str) -> dict:
        _not_ported("POST /w/matrix/run")

    def matrix_status(self, mid: str) -> dict:
        _not_ported("GET /w/matrix/status")

    def matrix_report(self, mid: str) -> dict:
        _not_ported("GET /w/matrix/report")

    def search_submit(self, body: dict) -> dict:
        _not_ported("POST /w/matrix/search/submit")

    def search_run(self, sid: str) -> dict:
        _not_ported("POST /w/matrix/search/run")

    def search_status(self, sid: str) -> dict:
        _not_ported("GET /w/matrix/search/status")

    def search_report(self, sid: str) -> dict:
        _not_ported("GET /w/matrix/search/report")
