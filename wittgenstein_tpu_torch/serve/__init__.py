"""The request plane of the port (the port of `wittgenstein_tpu/serve`):
many concurrent scenario requests coalesced into few device programs,
in one process or across a fleet of worker processes.

  `spec`       — `ScenarioSpec`: the serializable unit of work, its
                 canonical JSON, digest and compile key (the JAX
                 package's, byte for byte);
  `registry`   — `CompileRegistry`: compile key x plane -> the port's
                 chunk programs (`ChunkProgram`: every obs plane in one
                 engine pass), with the JAX registry's hit/miss
                 accounting;
  `scheduler`  — `Scheduler`: coalescing by compile key, continuous
                 batching, retry/halving/poison-lane quarantine on
                 launches that run on their own copy of the in-place
                 leaves, the watchdog, group checkpoints, DRR tenancy
                 with chunk-boundary preemption, the snapshot-fork seam
                 and lane freezing, streaming, per-request artifacts and
                 ledger rows;
  `service`    — `Service`: the submit/status/result surface behind
                 `server/http.py`'s `/w/batch/*` routes, with the sweep
                 grids and searches of `/w/matrix/*`; `FleetService`:
                 the same surface over a shared fleet directory;
  `fleet`      — `FleetWorker`/`spawn_worker`: lease-based worker
                 processes sharing one journal, ledger, memo table and
                 checkpoint directory (`fleet_paths`);
  `journal`    — `SubmissionJournal` (the WAL behind
                 `Scheduler(journal_dir=)`) and `LeaseTable`;
  `instrument` — `Instrumentation`: host spans + the Prometheus
                 registry.
"""

from .fleet import FleetWorker, fleet_paths, spawn_worker  # noqa: F401
from .instrument import Instrumentation  # noqa: F401
from .journal import LeaseTable, SubmissionJournal  # noqa: F401
from .registry import ChunkProgram, CompileRegistry  # noqa: F401
from .scheduler import (AdmissionError, ForkState, Request,  # noqa: F401
                        Scheduler, StaleCheckpointError, TenantPolicy,
                        WatchdogTimeout)
from .service import FleetService, Service  # noqa: F401
from .spec import (ATTACK_KEYS, ENGINES, OBS_PLANES,  # noqa: F401
                   ROUTE_KERNELS, ScenarioSpec, int_env)

__all__ = ["ScenarioSpec", "ENGINES", "OBS_PLANES", "ROUTE_KERNELS",
           "ATTACK_KEYS", "int_env", "CompileRegistry", "ChunkProgram",
           "Scheduler", "Request", "ForkState", "TenantPolicy",
           "AdmissionError", "StaleCheckpointError", "WatchdogTimeout",
           "Service", "FleetService", "FleetWorker",
           "fleet_paths", "spawn_worker", "SubmissionJournal",
           "LeaseTable", "Instrumentation"]
