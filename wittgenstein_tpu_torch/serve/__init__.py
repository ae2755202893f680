"""The request plane of the port (the port of `wittgenstein_tpu/serve`),
in one process: many concurrent scenario requests coalesced into few
device programs.

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
                 `server/http.py`'s `/w/batch/*` routes;
  `journal`    — `SubmissionJournal` (the WAL behind
                 `Scheduler(journal_dir=)`) and `LeaseTable`;
  `instrument` — `Instrumentation`: host spans + the Prometheus
                 registry.

Not ported yet (ROADMAP.md A14b): the fleet (`serve/fleet.py`,
`FleetService`) and the sweep-grid and search jobs of `Service`.
"""

from .instrument import Instrumentation  # noqa: F401
from .journal import LeaseTable, SubmissionJournal  # noqa: F401
from .registry import ChunkProgram, CompileRegistry  # noqa: F401
from .scheduler import (AdmissionError, ForkState, Request,  # noqa: F401
                        Scheduler, StaleCheckpointError, TenantPolicy,
                        WatchdogTimeout)
from .service import NotPorted, Service  # noqa: F401
from .spec import (ATTACK_KEYS, ENGINES, OBS_PLANES,  # noqa: F401
                   ROUTE_KERNELS, ScenarioSpec, int_env)

__all__ = ["ScenarioSpec", "ENGINES", "OBS_PLANES", "ROUTE_KERNELS",
           "ATTACK_KEYS", "int_env", "CompileRegistry", "ChunkProgram",
           "Scheduler", "Request", "ForkState", "TenantPolicy",
           "AdmissionError", "StaleCheckpointError", "WatchdogTimeout",
           "Service", "NotPorted", "SubmissionJournal", "LeaseTable",
           "Instrumentation"]
