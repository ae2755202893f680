"""Coalescing scheduler — many requests, few device programs; the port
of `wittgenstein_tpu/serve/scheduler.py`, every behavior below kept, on
the port's engine (PyTorch on a CUDA device; ``device="cpu"`` runs the
plain PyTorch versions, as the tests do).

Two designs are the port's own, because the JAX scheduler rests on two
facts that do not hold here:

  * a JAX chunk program is a pure function of its entry state; the
    port's engine writes the mailbox ring (and a protocol's `IN_PLACE`
    leaves, GSF's snapshot pool) in place.  So (a) every obs plane a
    spec asks for rides ONE engine pass a chunk (`registry.ChunkProgram`;
    each plane's carry equals its own builder's), where the JAX
    scheduler runs shadow passes from the entry state; and (b) a launch
    that can be retried (a retry, the width halving, the poison-lane
    bisection) runs on its OWN copy of the in-place leaves
    (`_launch_state`, a device-to-device copy before each attempt), so
    a chunk that failed halfway, or ran to its end and then raised,
    leaves the entry state as it was: the next attempt starts from the
    true chunk boundary;
  * an abandoned JAX launch stops touching the state; a port launch is
    Python that would go on launching kernels.  The watchdog sets the
    launch's abandon flag, which its chunk checks at every window's
    entry (`registry.LaunchAbandoned`), and the abandoned launch was
    running on its private copy anyway, so it writes nothing that
    anything else reads.

The scheduler keeps each run's clock on the host (the third element of
its lane-state triples ``(net, pstate, times)``), read from the device
once when a lane enters; a chunk adds one synchronising call, the copy
of its obs carries to the host (or, without a plane, a device
synchronize) that makes the chunk-wall EMA honest.

Requests whose specs share a `compile_key()` are the same compiled
chunk program over different DATA (seeds, partitions, spans).  The
scheduler exploits that: pending compatible requests are grouped and
run as ONE vmapped seed-batched program, one chunk at a time, with
continuous seed batching — on the `vmapped` engine, a compatible
request submitted while a group is in flight joins at the next chunk
boundary (freshly-initialized lanes concatenate onto the batch; each
lane carries its own clock, so mixed entry times are sound for the
per-lane dense engine: the port runs one engine pass per distinct clock,
`registry.ChunkProgram`).  The `batched` and `fast_forward` engines
assume LOCKSTEP times across the batch (one fused mailbox / one shared
jump), so their groups close at launch and later arrivals form the
next group.

Per chunk the scheduler advances state with ONE pass carrying every
obs plane the spec asks for (module head); the metrics plane is what
streams progress.  Every plane is bit-identical on the trajectory
(tests/test_torch_obs.py, test_torch_trace.py, test_torch_audit.py).

Each finished request gets per-request artifacts (ProgressPerTime-style
`engine_metrics` block, `trace` block, `audit` block, final-state
summary) and ONE `RunManifest` ledger row whose `config_digest` is the
spec digest (obs/ledger.py).

Resilience: every device-program launch goes through
`_launch` — a failed chunk is retried with exponential backoff
(`max_retries`, `retry_backoff_s`; `launcher` is the injectable seam
the fault-injection tests drive), and a launch that keeps failing at
full batch width DEGRADES instead of dropping requests: the lane batch
is split in half and the halves run sequentially (recursively, down to
one lane), then re-concatenated — bit-identical state for the scan
engines, since the per-lane trajectory never depends on its batch
neighbors.  With `checkpoint_dir` set, the group state is written at
every chunk boundary (utils/checkpoint .npz + request metadata) and
`resume_checkpoints()` re-enqueues interrupted groups after a crash:
the resumed trajectory is bit-identical to an uninterrupted run
(chunk-boundary restore of a deterministic pure engine is exact —
tests/test_serve_resilience.py), with obs-plane artifacts covering the
post-restore span and the ledger row carrying `resumed_from_ms`.
Checkpoint metadata is schema 2: each stored request carries its spec
digest, and `resume_checkpoints` REFUSES a file whose stored spec no
longer digests to its recorded value (a stale .npz from an edited
spec would otherwise be silently restored into the wrong trajectory).

Tenancy: the FIFO single-tenant queue becomes a multi-tenant one.

  * Admission control: `Scheduler(tenants={name: TenantPolicy})`
    bounds each tenant's QUEUED depth (`max_queued`); an over-budget
    `submit` raises `AdmissionError` — carrying `retry_after_s`
    estimated from the tenant's queued chunk backlog times a running
    EMA of chunk wall time — which the HTTP layer maps to 429 +
    Retry-After instead of letting the queue grow without bound.
  * Weighted-fair queueing: `run_pending` picks the next group by
    DEFICIT ROUND ROBIN over the tenants with queued work (strict
    priority classes first — only the highest queued `spec.priority`
    competes; within a tenant, earliest `deadline_ms` first, then
    FIFO).  Each tenant's turn adds `weight x quantum_chunks` to its
    deficit; the selected group runs with that deficit as its chunk
    budget and pays back what it consumed, so a thousand-cell campaign
    wave and an interactive spec INTERLEAVE instead of the campaign
    starving everything behind it.
  * Checkpoint-based preemption: a running group yields at the next
    CHUNK BOUNDARY — never mid-program — when (a) its DRR budget is
    exhausted and non-coalescable work waits, (b) a strictly
    higher-priority request waits, or (c) every deadline-carrying lane
    in the group is past its deadline and other work waits.  Yielding
    re-enqueues the requests with their chunk-boundary lane states
    (and their stashed obs-plane carries) held in memory — the group
    checkpoint file, when `checkpoint_dir` is set, covers the
    process-death case exactly as above — so a preempted-then-
    resumed run is BIT-IDENTICAL to an uninterrupted one, including
    its metrics/trace/audit artifacts (tests/test_tenancy.py).

With no `tenants=` config the scheduler behaves exactly as before
(FIFO within the top priority class, no slice preemption): tenancy is
scheduler-side only, and the compiled programs are untouched — the
`PingPong+tenancy` analysis target pins carry_extra_leaves=0 /
transfer_ops=0 over a tenancy-labelled spec.

Memo (the port's `memo` package):

  * Snapshot-fork seam: ``submit(spec, fork=ForkState(...))`` enqueues
    a request that enters at a mid-run chunk boundary with a shared
    honest-prefix state AND the prefix's per-chunk obs carries — the
    in-memory preemption machinery reused as a fork: `_init_lanes`
    consumes the state, `_Lane` the carries, so the finished artifacts
    stitch the WHOLE span and the trajectory is bit-identical to an
    unforked run.  `forked_from` provenance (prefix digest + fork ms)
    rides the artifacts and the ledger row.
  * Fixed-point lane freezing: with ``freeze=True`` (default: the
    ``WTPU_MEMO=1`` env flag), lanes the `next_work` oracle proves
    quiet to their end are sliced out of the batch at chunk boundaries
    and their tails synthesized analytically (memo/freeze.py) —
    bit-identical state and artifacts, engine scope and soundness
    conditions documented there.
  * `memo_stats()` is the `/w/batch/memo` block (forked requests,
    frozen lanes/chunks, freeze flag).

Streaming (ROADMAP item 5 leftover): every chunk boundary appends the
request's primary-pass totals (and their per-chunk DELTA) to
`Request.chunk_totals` and notifies a condition variable;
`stream_chunks` long-polls it — the `/w/batch/stream/{id}` endpoint
blocks until the next boundary and returns the new per-chunk deltas.
A stream always TERMINATES: settling a request any way at all (done,
error, quarantined, withdrawn) notifies the boundary condition, so a
long-poll on a failed request returns its final error/quarantined
record instead of hanging until the client timeout.

Crash-only serve: every failure mode either recovers
bit-identically or is isolated to exactly the request that caused it.

  * Durable submission journal: `Scheduler(journal_dir=)` appends
    every ACCEPTED submit (canonical spec JSON + rid + label/
    ledger_extra) to an append-only JSONL WAL — fsync'd BEFORE the
    submit acks — and tombstones it when the request completes, is
    quarantined or is withdrawn (serve/journal.py; transient group
    errors stay replayable).  `resume_journal()` replays un-tombstoned
    entries after a crash; composed with `resume_checkpoints()` (use
    `recover()`, which orders them) a kill at ANY point — queued,
    mid-chunk, between groups — loses nothing: checkpointed groups
    resume from their chunk boundary, queued-but-unlaunched requests
    re-run from their journaled specs, and both continuations are
    bit-identical (deterministic pure engine).  Torn tail lines are
    tolerated loudly (utils/jsonl.py).
  * Poison-lane quarantine: when `_launch` exhausts retries and width
    degradation still fails, the halving recursion bottoms out at ONE
    lane (log2 launches — the bisection IS the degradation tree) and
    that request alone is QUARANTINED: status error with a
    `quarantined` artifact, its own ledger row, a per-tenant stat and
    a journal tombstone — while every coalesced neighbor completes
    bit-identically to a solo run (per-lane trajectories never depend
    on batch neighbors; tests/test_serve_resilience.py pins it with a
    deterministic always-fails-for-one-lane launcher).  A launch where
    EVERY lane fails is a dead device, not poison (a bisection that
    eliminates everything isolated nothing): it keeps the
    group-failure semantics — error + RETAINED group checkpoint, so a
    recovered device resumes mid-run work.
  * Hung-launch watchdog: with `watchdog_factor` set, every launch
    gets a wall deadline of max(`watchdog_floor_s`, factor x the
    chunk-wall EMA) — the floor covers cold compiles.  A launch
    past deadline is ABANDONED on its daemon worker thread and
    surfaces as a `WatchdogTimeout` failure into the existing
    retry -> degrade -> quarantine ladder, so a wedged device stalls
    one group (at worst one request) — the drain loop's waits are
    bounded by the deadline per launch attempt, never by the hang, and
    only the top-level attempt retries a timeout (bisection subsets of
    a wedged device would all time out identically).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.state import resolve_device
from .registry import CompileRegistry
from .spec import ScenarioSpec

#: request lifecycle states
STATUSES = ("queued", "running", "done", "error")

#: group-checkpoint metadata schema (bump on field changes).  2 (PR
#: 13): per-request `spec_digest` — resume verifies each stored spec
#: still digests to it and refuses a tampered/stale file with remedy
#: text instead of silently restoring the wrong trajectory.
CKPT_META_SCHEMA = 2


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's admission + fairness budget (module docstring)."""

    #: DRR weight — this tenant's share of chunk budget per rotation
    weight: int = 1
    #: max QUEUED requests before submit is refused with 429/retry-
    #: after (0 = unbounded, the single-tenant default)
    max_queued: int = 0
    #: floor of the retry-after estimate an over-budget submit carries
    retry_after_s: float = 1.0

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(f"TenantPolicy: weight must be >= 1, got "
                             f"{self.weight} (a zero-weight tenant "
                             "would starve by construction)")
        if self.max_queued < 0 or self.retry_after_s < 0:
            raise ValueError("TenantPolicy: max_queued and "
                             "retry_after_s must be >= 0")


class WatchdogTimeout(RuntimeError):
    """A device-program launch abandoned past its per-chunk wall
    deadline (module docstring).  The abandoned launch stops at its
    next window's entry and only ever wrote its private copy of the
    in-place leaves; the retried launch recomputes the identical chunk
    from the untouched entry state, so the trajectory stays
    bit-identical."""


class StaleCheckpointError(ValueError):
    """A checkpoint refused by the staleness gate (schema mismatch or
    a stored spec that no longer digests to its recorded value) — the
    ONE resume failure that must raise through `resume_checkpoints`
    instead of being skipped: silently restoring a different spec's
    trajectory is worse than restarting.  Plain IO/decode failures
    (torn files, garbage .npz) keep the skip-with-stderr
    behavior."""


@dataclasses.dataclass
class ForkState:
    """A snapshot-fork handoff (`submit(spec, fork=...)`): the shared
    honest prefix's final (net, pstate) lane state, its per-chunk
    obs carries (plane -> [carry, ...]) covering ``[entry, at_ms)``,
    the chunk-aligned fork point, and the prefix-spec digest the
    forked request's provenance records."""

    state: tuple
    carries: dict
    at_ms: int
    prefix_digest: str


class AdmissionError(RuntimeError):
    """An over-budget submission, refused — the HTTP layer's 429 (the
    `http_status` attribute is what `server/http.py` keys on; the
    worker never crashes, the client retries after `retry_after_s`)."""

    http_status = 429

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = round(float(retry_after_s), 3)


@dataclasses.dataclass
class Request:
    """One submitted scenario (scheduler-internal mutable record)."""

    id: str
    spec: ScenarioSpec              # RESOLVED (validate() output)
    compile_key: str
    #: the spec AS SUBMITTED (e.g. superstep="auto" before resolution)
    #: — provenance digests THIS one, like bench/bench_suite digest
    #: their requested configs, so a client correlating by its own
    #: spec digest always matches the ledger row
    requested: ScenarioSpec | None = None
    status: str = "queued"
    submitted: float = dataclasses.field(default_factory=time.time)
    started: float | None = None
    finished: float | None = None
    progress_ms: int = 0
    progress: dict = dataclasses.field(default_factory=dict)
    error: str | None = None
    artifacts: dict | None = None
    #: final (net, pstate) slices, seed axis kept — in-process consumers
    final_state: tuple | None = None
    manifest_path: str | None = None
    #: EngineConfig captured at lane init (protocol construction is
    #: heavy host work at tier-2 sizes — never rebuilt just for .cfg)
    cfg: object = None
    #: checkpoint-restored (net, pstate) lane slices — consumed by
    #: `_init_lanes` instead of a fresh init (see resume_checkpoints)
    restored_state: tuple | None = None
    #: chunk boundary this request resumed from (0 = never resumed)
    resumed_from_ms: int = 0
    #: ledger-row label override (default "serve:<id>") — the matrix
    #: driver labels rows "matrix:<cell>" so a sweep's provenance reads
    #: by cell, not by scheduler-internal request id
    label: str | None = None
    #: extra keys merged into the ledger row's `extra` dict (the matrix
    #: driver rides the grid digest + axis labels here, so every
    #: per-cell RunManifest row is joinable back to its SweepGrid)
    ledger_extra: dict | None = None
    #: chunk-boundary preemptions this request absorbed (tenancy)
    preempted: int = 0
    #: obs-plane carries stashed before a preemption — restored into
    #: the next `_Lane` so the final artifacts cover the WHOLE span
    saved_carries: dict | None = None
    #: group-level fast-forward skip stats accumulated across
    #: preemption segments (the artifact's `fast_forward` block)
    ff_accum: dict | None = None
    #: snapshot-fork provenance: {"prefix_digest", "fork_ms"} — the
    #: honest prefix this request entered from (memo; rides artifacts
    #: AND the ledger row so forked cells verify, not skip)
    forked_from: dict | None = None
    #: fixed-point freeze marker: the chunk boundary this request's
    #: lane was proven quiet-to-end and sliced out of the batch
    frozen_from_ms: int | None = None
    #: stash the raw per-chunk obs carries on the finished request
    #: (the memo driver's prefix handoff needs them; artifacts keep
    #: only the decoded blocks)
    keep_carries: bool = False
    final_carries: dict | None = None
    #: per-chunk-boundary primary-pass totals + deltas (the streaming
    #: endpoint's backing store; evicted with the request)
    chunk_totals: list = dataclasses.field(default_factory=list)
    #: monotonic enqueue timestamp on the INSTRUMENT's clock (set only
    #: when the scheduler is instrumented; reset on preempt/resume so
    #: the queue-wait span covers the current wait, not the lifetime)
    enq_mono: float | None = None

    @property
    def tenant(self) -> str:
        return self.spec.tenant

    @property
    def deadline_at(self) -> float | None:
        """Absolute wall-clock deadline (None = none).  A checkpoint-
        resumed request's clock restarts at re-submission — the
        original process is gone, and so is its wall budget."""
        if self.spec.deadline_ms is None:
            return None
        return self.submitted + self.spec.deadline_ms / 1000.0

    def status_json(self) -> dict:
        out = {"id": self.id, "status": self.status,
               "compile_key": self.compile_key,
               "progress_ms": self.progress_ms,
               "sim_ms": self.spec.sim_ms,
               "tenant": self.spec.tenant}
        if self.spec.priority:
            out["priority"] = self.spec.priority
        if self.spec.deadline_ms is not None:
            out["deadline_ms"] = self.spec.deadline_ms
        if self.preempted:
            out["preempted"] = self.preempted
        if self.progress:
            out["progress"] = dict(self.progress)
        if self.error:
            out["error"] = self.error
        return out


class _Lane:
    """One request's slice of the running batch."""

    def __init__(self, req: Request):
        self.req = req
        self.width = len(req.spec.seeds)
        # a checkpoint-restored request re-enters with progress already
        # made — only the remaining chunks run
        self.remaining = (req.spec.sim_ms -
                          req.progress_ms) // req.spec.chunk_ms
        # a PREEMPTED request re-enters with its pre-yield obs carries
        # intact, so the finished artifacts stitch the whole span
        self.carries: dict = req.saved_carries or {}
        req.saved_carries = None    # plane -> [per-chunk carry slices]

    def stash(self, plane: str, carry, lo: int):
        sl = pytree.tree_map(lambda x: x[lo:lo + self.width], carry)
        self.carries.setdefault(plane, []).append(sl)


def _lane_slice(state, lo: int, w: int):
    """Lanes ``[lo, lo + w)`` of a lane-state triple ``(net, pstate,
    times)`` (views of its tensors)."""
    net, ps, times = state
    net, ps = pytree.tree_map(lambda x: x[lo:lo + w], (net, ps))
    return net, ps, tuple(times[lo:lo + w])


def _host_times(net) -> tuple:
    """The runs' clocks of a seed batch, read from the device once."""
    return tuple(int(t) for t in net.time.reshape(-1).tolist())


class Scheduler:
    """See module docstring.  Thread-compat: `submit`/`request`/
    `status` are safe from any thread; `run_pending` drains from one
    thread at a time (a second concurrent call returns immediately)."""

    #: lock inventory (checked by analysis rule ``host_locks``): every
    #: read or write of these attributes must hold `_mu`.  Listed:
    #: the queue/request tables, tenancy accounting, the resilience
    #: and memo counters (mutated from drain, watchdog and HTTP
    #: threads), and the chunk-wall EMA the watchdog deadline reads.
    _LOCK_OWNS = {"_mu": ("_requests", "_queue", "_n", "_draining",
                          "_deficit", "_last_tenant", "_tstats",
                          "resilience", "memo", "chunk_wall_ema_s")}
    #: `_boundary` is Condition(self._mu): holding it IS holding `_mu`
    _LOCK_ALIASES = {"_boundary": "_mu"}

    def __init__(self, registry: CompileRegistry | None = None,
                 ledger_path=None, on_boundary=None, keep_done: int = 256,
                 launcher=None, max_retries: int = 2,
                 retry_backoff_s: float = 0.05, checkpoint_dir=None,
                 tenants: dict | None = None,
                 quantum_chunks: int | None = None,
                 freeze: bool | None = None, journal_dir=None,
                 watchdog_factor: float | None = None,
                 watchdog_floor_s: float = 30.0,
                 worker_id: str | None = None,
                 instrument=None, catalog=None, device=None):
        #: the device every group runs on (``cuda`` unless given; no
        #: card and no ``device=`` raises, never a CPU fallback)
        self.device = resolve_device(device)
        self.registry = registry or CompileRegistry(catalog=catalog)
        #: host flight recorder + metrics bundle
        #: (serve/instrument.Instrumentation; None = OFF, the default).
        #: Every instrumented site guards on ``self._ins is not None``
        #: — one attribute load, zero allocations when off.
        self._ins = instrument
        #: program observatory (obs/programs.ProgramCatalog; None =
        #: OFF, the default — one is-None branch per chunk, nothing
        #: imported).  A caller-provided registry adopts it unless it
        #: already carries its own; with both instrumentation and a
        #: catalog on, chunk-wall samples also feed the shared metrics
        #: registry's wtpu_program_chunk_seconds histogram.
        self.catalog = catalog
        if catalog is not None:
            if self.registry.catalog is None:
                self.registry.catalog = catalog
            if instrument is not None and catalog.metrics is None:
                catalog.metrics = instrument.metrics
        if instrument is not None and worker_id \
                and instrument.spans.worker is None:
            instrument.spans.worker = str(worker_id)
        #: fleet identity (None = the single-process default, nothing
        #: changes).  When set, this scheduler is ONE worker among N
        #: sharing a journal/ledger/checkpoint directory: request ids
        #: and checkpoint filenames are prefixed with the worker id so
        #: two workers can never mint the same rid or clobber each
        #: other's group checkpoint.  The id rides in checkpoint meta
        #: so a survivor can tell whose file it is adopting.  Uses "-"
        #: as the separator (the HTTP id route accepts [A-Za-z0-9_-]).
        self.worker_id = str(worker_id) if worker_id else None
        #: ``settle_hook(req, final_state, carries)`` is called with
        #: each finished request, its final lane state and its
        #: per-chunk obs carries (plane -> [carry, ...]) before its
        #: ledger row and its journal tombstone (None = nothing): the
        #: fleet worker publishes a finished memo prefix into the
        #: shared table and its own stats snapshot here, so both are on
        #: disk by the time a reader sees the request's completion
        #: (serve/fleet.py).  It must not raise.
        self.settle_hook = None
        self.ledger_path = ledger_path      # None = the shared default
        #: the device-program launch seam: ``launcher(fn, *args)``
        #: (default: call fn), args the lane-state triple ``(net,
        #: pstate, times)``.  Tests inject flaky/width-limited
        #: launchers to drive the retry and degradation paths.
        self.launcher = launcher
        #: failed-launch retries per width level before degrading
        self.max_retries = int(max_retries)
        #: base backoff (doubles per attempt); 0 disables sleeping
        self.retry_backoff_s = float(retry_backoff_s)
        #: directory for chunk-boundary group checkpoints (None = off)
        self.checkpoint_dir = checkpoint_dir
        #: durable submission journal (None = off): every accepted
        #: submit is WAL'd before ack, settled requests are
        #: tombstoned, `resume_journal()` replays the survivors
        if journal_dir:
            from .journal import SubmissionJournal
            self.journal = SubmissionJournal(journal_dir)
        else:
            self.journal = None
        #: hung-launch watchdog (None = off): per-launch wall deadline
        #: = max(floor, factor x chunk_wall_ema_s); the floor alone
        #: applies while the EMA is cold (first chunk = compile time)
        self.watchdog_factor = (None if watchdog_factor is None
                                else float(watchdog_factor))
        self.watchdog_floor_s = float(watchdog_floor_s)
        #: tenancy: tenant name -> `TenantPolicy` (plain dicts accepted
        #: for JSON-authored configs; "*" sets the default policy).
        #: Empty = the single-tenant behavior: FIFO within the top
        #: priority class, no DRR slicing.
        self.tenants = {name: (pol if isinstance(pol, TenantPolicy)
                               else TenantPolicy(**pol))
                        for name, pol in (tenants or {}).items()}
        #: DRR quantum in CHUNKS per weight point per rotation; None
        #: defaults to 4 when any tenant policy exists.  Slicing is
        #: active iff this resolves non-None.
        if quantum_chunks is None and self.tenants:
            quantum_chunks = 4
        self.quantum_chunks = quantum_chunks
        self._deficit: dict = {}            # tenant -> chunk deficit
        #: DRR rotation pointer: the last-served tenant NAME (the ring
        #: itself is rebuilt per selection from the tenants with
        #: queued work, so bookkeeping stays bounded by live tenants —
        #: client-supplied tenant strings must not leak memory in a
        #: long-lived service)
        self._last_tenant: str | None = None
        #: EMA of one coalesced chunk's wall seconds — the retry-after
        #: estimate's unit cost (0.0 until the first chunk lands)
        self.chunk_wall_ema_s = 0.0
        #: per-tenant lifetime counters (tenancy_stats())
        self._tstats: dict = {}
        #: resilience accounting, surfaced in per-request artifacts
        self.resilience = {"retries": 0, "demotions": 0, "resumed": 0,
                           "preemptions": 0, "rejected": 0,
                           "quarantined": 0, "watchdog_trips": 0,
                           "replayed": 0, "repacked": 0}
        #: scheduler birth time — the health endpoint's uptime anchor
        self._t0 = time.time()
        #: fixed-point lane freezing (memo/freeze.py); None defers to
        #: the WTPU_MEMO env flag so an operator can flip a deployed
        #: service without touching code
        if freeze is None:
            import os
            freeze = os.environ.get("WTPU_MEMO", "0") == "1"
        self.freeze = bool(freeze)
        #: memo accounting (the `/w/batch/memo` block)
        self.memo = {"forked": 0, "frozen_lanes": 0, "frozen_chunks": 0}
        #: test/ops hook: called at every chunk boundary of a running
        #: group, BEFORE admission — a callback may `submit()` and see
        #: its request join this group (the continuous-batching pin)
        self.on_boundary = on_boundary
        #: finished-request retention bound: a long-lived service must
        #: not pin every past request's final-state device arrays —
        #: beyond this many done/errored records the OLDEST are evicted
        #: (their ledger row is the durable artifact; status() then
        #: answers unknown).  0 = unbounded (tests, short-lived tools).
        self.keep_done = int(keep_done)
        self._mu = threading.RLock()
        #: chunk-boundary pulse for the streaming long-poll
        self._boundary = threading.Condition(self._mu)
        self._requests: dict[str, Request] = {}
        self._queue: list[str] = []         # FIFO of queued request ids
        self._n = 0
        self._draining = False

    # ------------------------------------------------------------ tenancy

    def policy(self, tenant: str) -> TenantPolicy:
        """The tenant's admission/fairness policy ("*" = the default
        for unlisted tenants; unbounded weight-1 otherwise)."""
        pol = self.tenants.get(tenant) or self.tenants.get("*")
        return pol or TenantPolicy()

    #: lifetime-counter retention bound for UNCONFIGURED tenants —
    #: tenant is a client-supplied string, so a long-lived service
    #: must not let per-name stat dicts grow without limit (configured
    #: tenants are never evicted)
    MAX_TENANT_STATS = 4096

    def _tstat(self, tenant: str) -> dict:
        """Per-tenant lifetime counters (caller holds the lock)."""
        if tenant not in self._tstats and \
                len(self._tstats) >= self.MAX_TENANT_STATS:
            queued_now = {self._requests[r].spec.tenant
                          for r in self._queue}
            for victim in list(self._tstats):    # oldest-first (dict
                # insertion order); skip configured/live tenants
                if victim not in self.tenants and \
                        victim not in queued_now:
                    del self._tstats[victim]
                    break
        return self._tstats.setdefault(
            tenant, {"submitted": 0, "rejected": 0, "done": 0,
                     "errors": 0, "preemptions": 0, "quarantined": 0})

    def _admit(self, spec: ScenarioSpec):
        """Refuse an over-budget submission with a retry-after remedy
        (caller holds the lock).  Only QUEUED requests count against
        the budget — a running request's slot is already freed for the
        next submit, which is what keeps the queue bounded while the
        device stays busy."""
        pol = self.policy(spec.tenant)
        self._tstat(spec.tenant)["submitted"] += 1
        if not pol.max_queued:
            return
        mine = [self._requests[r] for r in self._queue
                if self._requests[r].spec.tenant == spec.tenant]
        if len(mine) < pol.max_queued:
            return
        self.resilience["rejected"] += 1
        self._tstat(spec.tenant)["rejected"] += 1
        backlog_chunks = sum(
            (r.spec.sim_ms - r.progress_ms) // r.spec.chunk_ms
            for r in mine)
        retry = max(pol.retry_after_s,
                    backlog_chunks * self.chunk_wall_ema_s)
        raise AdmissionError(
            f"tenant {spec.tenant!r} queue is full ({len(mine)}/"
            f"{pol.max_queued} queued requests): retry after "
            f"~{retry:.1f}s, raise the tenant's max_queued, or split "
            "the submission across tenants", retry_after_s=retry)

    def memo_stats(self) -> dict:
        """The `/w/batch/memo` block: snapshot-fork and lane-freeze
        accounting plus the freeze flag (memo/freeze.py scope)."""
        with self._mu:
            return {"freeze": self.freeze, **self.memo}

    def stream_chunks(self, rid: str, after_ms: int | None = None,
                      timeout_s: float = 25.0) -> dict:
        """Long-poll one request's per-chunk primary-pass totals
        (module docstring): block until a chunk boundary newer than
        `after_ms` lands (or the request settles / `timeout_s`
        expires), then return the new ``{"t_ms", "totals", "delta"}``
        entries.  ``eof`` is True once the request has settled and no
        newer boundary is pending — the client stops polling.  Raises
        KeyError on an unknown/evicted id (the HTTP 400)."""
        after = -1 if after_ms is None else int(after_ms)
        deadline = time.time() + max(0.0, min(float(timeout_s), 60.0))
        with self._boundary:
            while True:
                if rid not in self._requests:
                    raise KeyError(f"unknown request {rid!r}")
                req = self._requests[rid]
                fresh = [dict(c) for c in req.chunk_totals
                         if c["t_ms"] > after]
                status = req.status
                if fresh or status in ("done", "error") \
                        or time.time() >= deadline:
                    break
                self._boundary.wait(
                    timeout=max(0.05, deadline - time.time()))
        out = {"id": rid, "status": status, "after_ms": after,
               "chunks": fresh,
               "next_after_ms": fresh[-1]["t_ms"] if fresh else after,
               "eof": status in ("done", "error") and not fresh}
        if status == "error" and req.error:
            # the stream TERMINATES with the final failure record — a
            # failed/quarantined request must never leave its client
            # long-polling until timeout (module docstring)
            out["error"] = req.error
            if (req.artifacts or {}).get("quarantined"):
                out["quarantined"] = True
        return out

    def tenancy_stats(self) -> dict:
        """The `/w/batch/tenancy` block: per-tenant queue depth +
        lifetime counters, plus the scheduler-level knobs a load
        generator needs to interpret them."""
        with self._mu:
            out = {"tenants": {}, "quantum_chunks": self.quantum_chunks,
                   "chunk_wall_ema_s": round(self.chunk_wall_ema_s, 4),
                   "rejected": self.resilience["rejected"],
                   "preemptions": self.resilience["preemptions"]}
            queued: dict = {}
            for rid in self._queue:
                t = self._requests[rid].spec.tenant
                queued[t] = queued.get(t, 0) + 1
            for t in set(self._tstats) | set(queued) | set(
                    k for k in self.tenants if k != "*"):
                pol = self.policy(t)
                out["tenants"][t] = {
                    **self._tstat(t), "queued": queued.get(t, 0),
                    "weight": pol.weight, "max_queued": pol.max_queued}
            return out

    # ------------------------------------------------------------- submit

    def submit(self, spec: ScenarioSpec, label: str | None = None,
               ledger_extra: dict | None = None,
               keep_carries: bool = False,
               fork: ForkState | None = None) -> str:
        """Validate (raises `ValueError` with remedy text — the HTTP
        layer's 400) and enqueue; returns the request id.  An
        over-budget tenant raises `AdmissionError` (the 429 path; see
        `_admit`).  `label` / `ledger_extra` ride into the request's
        ledger row (the matrix driver's per-cell provenance — see the
        Request fields).  `fork` (a `ForkState`) enters the request at
        a mid-run chunk boundary from a shared honest-prefix state
        with the prefix's obs carries (module docstring: the memo
        snapshot-fork seam); `keep_carries` stashes the raw per-chunk
        carries on the finished request (the prefix handoff)."""
        ins = self._ins
        t_sub = 0.0 if ins is None else ins.now()
        resolved = spec.validate()
        key = resolved.compile_key()
        if fork is not None:
            self._check_fork(resolved, fork)
        with self._mu:
            self._admit(resolved)
            rid = self._rid_locked()
            req = Request(id=rid, spec=resolved, compile_key=key,
                          requested=spec, label=label,
                          keep_carries=bool(keep_carries),
                          ledger_extra=dict(ledger_extra)
                          if ledger_extra else None)
            if ins is not None:
                # set under the lock so a concurrent drain marking the
                # request running always sees the enqueue time
                req.enq_mono = t_sub
            if fork is not None:
                req.restored_state = fork.state
                req.saved_carries = {p: list(cs) for p, cs
                                     in (fork.carries or {}).items()}
                req.progress_ms = int(fork.at_ms)
                req.forked_from = {"prefix_digest": fork.prefix_digest,
                                   "fork_ms": int(fork.at_ms)}
                req.ledger_extra = {**(req.ledger_extra or {}),
                                    "forked_from": dict(req.forked_from)}
                self.memo["forked"] += 1
            self._requests[rid] = req
            self._queue.append(rid)
            if self.journal is not None:
                # the WAL write precedes the ack BY CONSTRUCTION: a
                # journal failure un-accepts the request — promising
                # durability the disk refused would be worse than a
                # loud 500.  The append+fsync deliberately runs under
                # the scheduler lock: releasing first would let the
                # drain launch (or even finalize) the request before
                # its submit row exists — a tombstone-before-submit
                # ordering the replay would mis-resurrect.  The cost
                # is one fsync of lock hold per submit; the journal
                # is an explicit opt-in for deployments that want
                # durability over submit throughput.
                try:
                    self.journal.record_submit(
                        rid, spec, label=label,
                        ledger_extra=req.ledger_extra)
                except OSError as e:
                    self._queue.remove(rid)
                    del self._requests[rid]
                    raise RuntimeError(
                        f"serve: submission journal append failed "
                        f"({e}); request NOT accepted — fix the "
                        f"journal_dir volume or disable journaling"
                    ) from e
        if ins is not None:
            from .instrument import SPAN_SUBMIT
            ins.end(SPAN_SUBMIT, t_sub, rid=rid, key=key,
                    tenant=resolved.tenant)
        return rid

    @staticmethod
    def _check_fork(resolved: ScenarioSpec, fork: ForkState) -> None:
        """Refuse (ValueError with remedy text) a `ForkState` that
        cannot soundly enter `resolved` mid-run: off-boundary fork
        point, wrong lane width, or carries that don't cover the
        prefix span (shared by `submit` and the journal-adoption
        path)."""
        at = int(fork.at_ms)
        if at < resolved.chunk_ms or at % resolved.chunk_ms or \
                at >= resolved.sim_ms:
            raise ValueError(
                f"fork.at_ms={at} must be a positive multiple of "
                f"chunk_ms={resolved.chunk_ms} inside the span "
                f"[chunk_ms, sim_ms={resolved.sim_ms}): requests "
                "enter and leave groups only on chunk boundaries")
        width = pytree.tree_leaves(fork.state)[0].shape[0]
        if width != len(resolved.seeds):
            raise ValueError(
                f"fork state carries {width} lane(s) but the spec "
                f"has {len(resolved.seeds)} seed(s): the prefix "
                "must have been run with exactly the cell's seeds")
        # the stitched-artifact contract: every captured plane must
        # arrive with one carry per prefix CHUNK, or the finished
        # artifacts would silently claim a full span they don't
        # cover (same refuse-with-remedy discipline as above)
        want_chunks = at // resolved.chunk_ms
        carries = fork.carries or {}
        for plane in resolved.obs:
            got = len(carries.get(plane, ()))
            if got != want_chunks:
                raise ValueError(
                    f"fork carries cover {got} chunk(s) of the "
                    f"{plane!r} plane but the prefix spans "
                    f"{want_chunks} chunk(s) ([0, {at}) at "
                    f"chunk_ms={resolved.chunk_ms}): the forked "
                    "request could not stitch a full-span "
                    "artifact. Fix: hand over the prefix run's "
                    "complete per-chunk carries (submit the "
                    "prefix with keep_carries=True), or drop the "
                    "plane from the spec's obs")

    def _rid_locked(self) -> str:
        """Mint the next request id (caller holds the lock).  Worker-
        prefixed under a fleet identity so N workers sharing one
        journal can never collide; checkpoint-restored requests keep
        their original ids, which may sit ahead of this counter — the
        skip loop never overwrites one."""
        prefix = f"{self.worker_id}-r" if self.worker_id else "r"
        self._n += 1
        rid = f"{prefix}{self._n:04d}"
        while rid in self._requests:
            self._n += 1
            rid = f"{prefix}{self._n:04d}"
        return rid

    def request(self, rid: str) -> Request:
        with self._mu:
            if rid not in self._requests:
                raise KeyError(f"unknown request {rid!r}")
            return self._requests[rid]

    def peek(self, rid: str) -> Request | None:
        """The Request for `rid`, or None when unknown — which for a
        previously-valid rid means the keep_done eviction already
        dropped the finished record (its ledger row is the durable
        artifact).  The lookup drivers polling after a drain want,
        without the try/except-KeyError dance at every site."""
        with self._mu:
            return self._requests.get(rid)

    def pending(self) -> list:
        with self._mu:
            return list(self._queue)

    def withdraw(self, rids) -> int:
        """Remove still-QUEUED requests from the scheduler (running/
        settled ones are left alone); returns how many were removed.
        The matrix driver's resume rollback: when a later checkpoint
        fails validation, the earlier files' re-enqueued requests must
        not be left orphaned on a shared scheduler — they would run
        with no harvester."""
        gone = []
        with self._mu:
            for rid in rids:
                req = self._requests.get(rid)
                if req is not None and req.status == "queued":
                    if rid in self._queue:
                        self._queue.remove(rid)
                    del self._requests[rid]
                    gone.append(rid)
            # a long-poll streaming a withdrawn id must terminate NOW
            # (it re-checks membership on wake and raises the 400),
            # not at its client timeout
            self._boundary.notify_all()
        if self.journal is not None:
            for rid in gone:
                self.journal.record_settled(rid, "withdrawn")
        return len(gone)

    # -------------------------------------------------------------- drain

    def run_pending(self) -> dict:
        """Drain the queue: pick the next group (DRR over tenants
        within the top priority class — `_next_head`), run it up to
        its chunk budget, repeat until empty.  A preempted group goes
        back on the queue and is re-picked on a later rotation, so the
        loop terminates: every `_run_group` call advances at least one
        chunk or settles a request.  Returns ``{"processed": N,
        "registry": stats}``."""
        with self._mu:
            if self._draining:
                return {"processed": 0, "registry": self.registry.stats()}
            self._draining = True
        processed = 0
        try:
            while True:
                key, budget, tenant = self._next_head()
                if key is None:
                    break
                try:
                    done, used = self._run_group(key, budget)
                    processed += done
                except Exception as e:      # noqa: BLE001 — a broken
                    # group must not wedge the whole queue
                    self._fail_group(key, e)
                    used = 0
                with self._mu:
                    if tenant in self._deficit:
                        self._deficit[tenant] -= used
                        if not any(self._requests[r].spec.tenant == tenant
                                   for r in self._queue):
                            # classic DRR: an emptied tenant forfeits
                            # its leftover deficit (no banking idle
                            # credit against future contention) — and
                            # its entry, so arbitrary client-supplied
                            # tenant names never accumulate
                            del self._deficit[tenant]
        finally:
            with self._mu:
                self._draining = False
        return {"processed": processed, "registry": self.registry.stats()}

    def _next_head(self):
        """Pick the next group to run: ``(compile_key, budget_chunks,
        tenant)`` or ``(None, None, None)`` on an empty queue.

        Strict priority classes first: only requests at the highest
        queued `spec.priority` compete.  Without tenancy config the
        winner is the class's FIFO head with an unbounded budget (the
        single-tenant behavior).  With tenancy, deficit round robin over the
        class's tenants: the rotation pointer advances tenant by
        tenant, each turn adds ``weight x quantum_chunks`` to the
        tenant's deficit, and the tenant's EDF-then-FIFO head runs
        with the accumulated deficit as its chunk budget (floor 1 —
        a group always makes progress)."""
        with self._mu:
            if not self._queue:
                return None, None, None
            reqs = [self._requests[r] for r in self._queue]
            top = max(r.spec.priority for r in reqs)
            cand = [r for r in reqs if r.spec.priority == top]
            if self.quantum_chunks is None:
                return cand[0].compile_key, None, cand[0].spec.tenant
            import bisect
            # the rotation ring is the sorted set of tenants with
            # candidate work, entered just AFTER the last-served name
            # (circular) — equivalent to a persistent round robin, but
            # bounded: nothing is remembered for tenants with no
            # queued work except their banked deficit (pruned by
            # run_pending when they empty)
            ring = sorted({r.spec.tenant for r in cand})
            i = bisect.bisect_right(ring, self._last_tenant) \
                if self._last_tenant is not None else 0
            tenant = ring[i % len(ring)]
            self._last_tenant = tenant
            self._deficit[tenant] = (
                self._deficit.get(tenant, 0)
                + self.policy(tenant).weight * self.quantum_chunks)
            mine = [r for r in cand if r.spec.tenant == tenant]
            # earliest deadline first; deadline-less requests keep
            # FIFO order behind every deadline-carrying one
            head = min(mine, key=lambda r: (
                r.deadline_at if r.deadline_at is not None
                else float("inf"), r.submitted))
            budget = max(1, int(self._deficit[tenant]))
            return head.compile_key, budget, tenant

    def _fail_group(self, key: str, e: Exception):
        """Mark every unfinished request of this compile key errored —
        including ones already popped from the queue but not yet
        marked running (a group that dies in lane init)."""
        msg = f"{type(e).__name__}: {e!s:.500}"
        with self._mu:
            for req in self._requests.values():
                if req.compile_key == key and req.status in ("queued",
                                                             "running"):
                    if req.id in self._queue:
                        self._queue.remove(req.id)
                    req.status, req.error = "error", msg
                    self._tstat(req.spec.tenant)["errors"] += 1
            self._boundary.notify_all()     # wake stream long-polls
        # deliberately NO journal tombstone: a group failure is
        # presumed transient (dead device, wedged runtime) — the
        # journal's crash-only contract is redo-beats-lose, so these
        # entries REPLAY on the next recovery.  Only a completed,
        # quarantined (deterministic verdict) or withdrawn request
        # tombstones.

    # ----------------------------------------------------------- grouping

    def _take_compatible(self, key: str,
                         progress_ms: int | None = None) -> list:
        """Pop every queued request with this compile key (FIFO
        order).  With `progress_ms` set (the lockstep lane-repack
        admission), only requests that can soundly join a RUNNING
        group at that chunk boundary: equal progress AND a restored
        state (checkpoint, preemption or fork) — a fresh request
        enters at progress 0 and can never match a mid-run boundary,
        while equal progress under one compile key implies equal
        device time arrays, which is all the fused mailbox/shared-jump
        engines require."""
        with self._mu:
            taken = []
            for rid in self._queue:
                r = self._requests[rid]
                if r.compile_key != key:
                    continue
                if progress_ms is not None and (
                        r.progress_ms != progress_ms
                        or r.restored_state is None):
                    continue
                taken.append(rid)
            for rid in taken:
                self._queue.remove(rid)
            return [self._requests[rid] for rid in taken]

    def _init_lanes(self, reqs: list, proto):
        """Fresh state for each request's seeds (+ partition applied —
        data, not program), concatenated along the seed axis.  `proto`
        is the GROUP's shared protocol instance: requests in a group
        have equal compile keys, hence equal protocol/params — one
        construction serves them all (heavy host work at tier-2
        sizes)."""
        from ..core.state import init_batched
        states = []
        for req in reqs:
            spec = req.spec
            req.cfg = proto.cfg
            if req.restored_state is not None:
                # checkpoint-restored lanes re-enter with their saved
                # chunk-boundary state (partition/faults already in it),
                # copied: the engine writes the ring in place, and a
                # fork's state is another request's final state
                nets, ps = pytree.tree_map(
                    lambda x: x.to(self.device, copy=True),
                    req.restored_state)
                states.append((nets, ps, _host_times(nets)))
                req.restored_state = None
                continue
            nets, ps = init_batched(proto, torch.as_tensor(spec.seeds))
            if spec.partition:
                idx = torch.as_tensor(spec.partition,
                                      device=nets.time.device)
                down = nets.nodes.down.clone()
                down[:, idx] = True
                nets = nets.replace(nodes=nets.nodes.replace(down=down))
            t = _host_times(nets)
            k = spec.superstep
            if k > 1:
                if any(x % k for x in t):
                    raise ValueError(
                        f"request {req.id}: {spec.protocol}.init enters "
                        f"at time(s) {sorted(set(t))}, not "
                        f"multiples of superstep={k} — the fused window "
                        "contract needs a K-aligned entry. Fix: "
                        "superstep=1 (or 'auto') for this protocol")
            states.append((nets, ps, t))
        return states

    @staticmethod
    def _concat(states: list):
        """Lane-state triples concatenated on the seed axis."""
        if len(states) == 1:
            return states[0]
        net, ps = pytree.tree_map(lambda *xs: torch.cat(xs, 0),
                                  *[(n, p) for n, p, _ in states])
        return net, ps, tuple(t for _, _, ts in states for t in ts)

    @staticmethod
    def _take_lanes(state, idx):
        """Rows `idx` of a lane-state triple (a copy)."""
        net, ps, times = state
        ix = torch.as_tensor(idx, dtype=torch.long,
                             device=net.time.device)
        net, ps = pytree.tree_map(lambda x: x.index_select(0, ix),
                                  (net, ps))
        return net, ps, tuple(times[i] for i in idx)

    # --------------------------------------------------------- resilience

    @staticmethod
    def _split_state(state, w: int):
        n = len(state[2])
        return _lane_slice(state, 0, w), _lane_slice(state, w, n - w)

    @staticmethod
    def _combine(a, b, engine: str):
        """Re-concatenate two half-batch chunk results into the full-
        width result the callers index (``out[0], out[1]`` the state,
        ``out[2]`` the clocks, ``out[3]`` the fast-forward stats,
        ``out[4]`` the plane carries).  State, clocks and carries
        concatenate on the seed axis; the fast-forward skip stats are
        batch-level counts and sum, as the JAX scheduler sums them."""
        net, ps = pytree.tree_map(lambda x, y: torch.cat([x, y], 0),
                                  (a[0], a[1]), (b[0], b[1]))
        stats = None
        if engine == "fast_forward":
            stats = {k: a[3][k] + b[3][k] for k in a[3]}
        carries = {p: pytree.tree_map(lambda x, y: torch.cat([x, y], 0),
                                      a[4][p], b[4][p]) for p in a[4]}
        return net, ps, tuple(a[2]) + tuple(b[2]), stats, carries

    @staticmethod
    def _launch_state(fn, entry):
        """The launch's own copy of the leaves its chunk writes in place
        (module docstring): the ring of `entry`'s net and the
        protocol's `IN_PLACE` leaves, copied device to device; every
        other leaf is shared (the engine replaces them, never writes
        them).  A launch on the copy leaves `entry` as it was, whatever
        happens to the launch."""
        from ..core.network import RING
        net, ps, times = entry
        net = net.replace(**{k: pytree.tree_map(torch.clone,
                                                getattr(net, k))
                             for k in RING})
        names = getattr(getattr(fn, "proto", None), "IN_PLACE", ())
        if names:
            fresh = {n: ps[n].clone() if isinstance(ps, dict)
                     else getattr(ps, n).clone() for n in names}
            ps = {**ps, **fresh} if isinstance(ps, dict) \
                else ps.replace(**fresh)
        return net, ps, times

    def launch_deadline_s(self) -> float | None:
        """The watchdog's per-launch wall deadline (None = watchdog
        off): max(floor, factor x chunk-wall EMA); the floor alone
        while the EMA is cold, so a first-chunk compile is never
        mistaken for a hang."""
        if self.watchdog_factor is None:
            return None
        with self._mu:      # EMA is written at chunk boundaries
            ema = self.chunk_wall_ema_s
        if not ema:
            return self.watchdog_floor_s
        return max(self.watchdog_floor_s, self.watchdog_factor * ema)

    def _call_bounded(self, call, fn, entry):
        """One launch attempt under the watchdog deadline (module
        docstring).  Past deadline the worker thread is ABANDONED
        (daemon — its late result is discarded): its abandon flag is
        set, so its chunk stops at the next window's entry, and it was
        running on its own copy of the in-place leaves.  The hang
        surfaces as a `WatchdogTimeout` failure into the retry ->
        degrade -> quarantine ladder, so the drain loop's wait is
        bounded by the deadline, never by the wedged call."""
        deadline = self.launch_deadline_s()
        if deadline is None:
            return call(fn, *entry)
        box: dict = {}
        settled = threading.Event()
        abandon = threading.Event()
        bound = functools.partial(fn, abandon=abandon)

        def work():
            try:
                box["out"] = call(bound, *entry)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["err"] = e
            finally:
                settled.set()

        t = threading.Thread(target=work, daemon=True,
                             name="wtpu-launch")
        t.start()
        if not settled.wait(deadline):
            abandon.set()
            with self._mu:      # drain thread holds no lock here
                self.resilience["watchdog_trips"] += 1
                ema = self.chunk_wall_ema_s
            if self._ins is not None:
                from .instrument import MARK_WATCHDOG
                self._ins.mark(MARK_WATCHDOG,
                               deadline_s=round(deadline, 3))
            raise WatchdogTimeout(
                f"launch exceeded its {deadline:.2f}s wall deadline "
                f"(chunk-wall EMA {ema:.3f}s x "
                f"factor {self.watchdog_factor}, floor "
                f"{self.watchdog_floor_s}s); abandoned on its worker "
                "thread and fed to the retry->degrade->quarantine "
                "ladder")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _try_launch(self, fn, entry, retry_timeouts: bool = True,
                    keep: bool = True):
        """One width level of the resilience ladder: retry-with-backoff
        around the (watchdog-bounded) launch; raises the last failure
        once retries are exhausted.  `retry_timeouts=False` (the
        bisection's inner nodes) gives a `WatchdogTimeout` ONE attempt:
        a transient hang earns its retries at full width, but once the
        ladder is bisecting a wedged device every subset would time out
        identically — re-retrying each one would multiply the total
        stall by (max_retries+1) for no information.  With `keep` each
        attempt runs on its own copy of the in-place leaves
        (`_launch_state`), so `entry` is intact for whatever follows a
        failure."""
        call = self.launcher or (lambda f, *a: f(*a))
        ins = self._ins
        last = None
        for attempt in range(self.max_retries + 1):
            t0 = 0.0 if ins is None else ins.now()
            try:
                work = self._launch_state(fn, entry) if keep else entry
                out = self._call_bounded(call, fn, work)
                del work
                if ins is not None:
                    from .instrument import SPAN_LAUNCH
                    ins.end(SPAN_LAUNCH, t0, attempt=attempt)
                return out
            except Exception as e:      # noqa: BLE001 — retry any launch
                last = e
                work = None
                if ins is not None:
                    from .instrument import MARK_RETRY, SPAN_LAUNCH
                    ins.end(SPAN_LAUNCH, t0, attempt=attempt,
                            error=type(e).__name__)
                if isinstance(e, WatchdogTimeout) and not retry_timeouts:
                    break
                if attempt < self.max_retries:
                    with self._mu:
                        self.resilience["retries"] += 1
                    if ins is not None:
                        ins.mark(MARK_RETRY, attempt=attempt,
                                 error=type(e).__name__)
                    if self.retry_backoff_s:
                        time.sleep(self.retry_backoff_s * (2 ** attempt))
        raise last

    def _launch(self, fn, entry, widths, engine: str,
                _nested: bool = False):
        """Run one chunk program through the full resilience ladder:
        retry-with-backoff (+ watchdog), then batch-width degradation,
        then poison-lane quarantine (module docstring).  `entry` is
        the concatenated (net, pstate) batch; `widths` the per-lane
        seed counts — the only legal split points (a lane's seeds stay
        together so carry slicing by lane offset keeps working).

        Returns ``(out, lane_errors)``: `lane_errors` has one entry
        per lane (None = healthy); `out` is the chunk result for the
        healthy lanes ONLY, concatenated in lane order (None when every
        lane failed).  The halving recursion IS the bisection —
        isolating one poison lane among 2^k costs log2 launches, and
        every healthy lane's result comes from a launch that ran it
        (possibly at reduced width — bit-identical per lane, since a
        lane's trajectory never depends on its batch neighbors).

        Wedged-device bound: only the TOP-level attempt retries a
        `WatchdogTimeout` (`_try_launch(retry_timeouts=)`), so a fully
        hung device costs at most (max_retries + deadline-per-
        bisection-node) deadlines before the all-lanes-failed
        dead-device raise — bounded per launch attempt, never by the
        hang itself.

        The launch state is kept (`_try_launch`'s `keep`) whenever a
        failure can be followed by another launch from this `entry`: a
        retry, a halving (more than one lane) or a watchdog."""
        keep = (self.max_retries > 0 or len(widths) > 1
                or self.watchdog_factor is not None)
        try:
            return (self._try_launch(fn, entry,
                                     retry_timeouts=not _nested,
                                     keep=keep),
                    [None] * len(widths))
        except Exception as e:      # noqa: BLE001 — the ladder continues
            if len(widths) == 1:
                # bottom of the bisection: exactly this lane is the
                # poison — the caller quarantines its request alone
                return None, [e]
            # graceful degradation: halve the lane batch and run the
            # halves sequentially instead of dropping the requests
            with self._mu:
                self.resilience["demotions"] += 1
            if self._ins is not None:
                from .instrument import MARK_DEGRADE
                self._ins.mark(MARK_DEGRADE, lanes=len(widths),
                               error=type(e).__name__)
            mid = len(widths) // 2
            w_left = int(sum(widths[:mid]))
            left, right = self._split_state(entry, w_left)
            out_l, err_l = self._launch(fn, left, widths[:mid], engine,
                                        _nested=True)
            out_r, err_r = self._launch(fn, right, widths[mid:],
                                        engine, _nested=True)
            errs = err_l + err_r
            if out_l is None:
                return out_r, errs
            if out_r is None:
                return out_l, errs
            return self._combine(out_l, out_r, engine), errs

    def _quarantine(self, ln: _Lane, err: Exception):
        """Settle ONE poison request (module docstring): status error
        with a `quarantined` artifact, its own ledger row (extra
        carries `quarantined` + the chunk boundary it died at), a
        per-tenant stat and a journal tombstone — its coalesced
        neighbors keep running untouched."""
        req = ln.req
        spec = req.spec
        requested = req.requested or spec
        msg = (f"quarantined: the lane bisection isolated this request "
               f"after retry+width-degradation failed — "
               f"{type(err).__name__}: {err!s:.300}")
        art = {"request": req.id, "compile_key": req.compile_key,
               "quarantined": True, "error": msg,
               "spec_digest": requested.digest(),
               "spec": requested.to_json(),
               "seeds": list(spec.seeds), "sim_ms": spec.sim_ms,
               "tenant": spec.tenant, "progress_ms": req.progress_ms}
        line = {"metric": f"serve_{req.id}", "sim_ms": spec.sim_ms,
                "superstep": spec.superstep, "batch": len(spec.seeds),
                "quarantined": True}
        req.ledger_extra = {**(req.ledger_extra or {}),
                            "quarantined": True,
                            "quarantined_at_ms": req.progress_ms}
        path = self._append_ledger(req, line)
        with self._mu:
            self.resilience["quarantined"] += 1
            st = self._tstat(spec.tenant)
            st["quarantined"] = st.get("quarantined", 0) + 1
            st["errors"] += 1
            req.artifacts = art
            req.status, req.error = "error", msg
            req.finished = time.time()
            req.manifest_path = path
            self._evict_old_done()
            # the stream long-poll must terminate with this final
            # quarantined record, not hang until its client timeout
            self._boundary.notify_all()
        if self.journal is not None:
            self.journal.record_settled(req.id, "quarantined")
        if self._ins is not None:
            from .instrument import MARK_QUARANTINE
            self._ins.mark(MARK_QUARANTINE, rid=req.id,
                           key=req.compile_key, tenant=spec.tenant,
                           at_ms=req.progress_ms)
        import sys
        print(f"serve: QUARANTINED request {req.id} "
              f"({spec.tenant}/{req.label or 'serve'}): {msg}",
              file=sys.stderr)

    def _quarantine_failed(self, lanes: list, lane_errors: list,
                           *trees):
        """Quarantine every lane with a recorded error and narrow the
        given state trees (seed axis) to the survivors.  Returns
        ``(surviving_lanes, *narrowed_trees)`` (trees become None when
        no lane survives)."""
        offsets = np.cumsum([0] + [ln.width for ln in lanes])
        keep_lanes, keep_idx = [], []
        for ln, lo, err in zip(lanes, offsets, lane_errors):
            if err is None:
                keep_lanes.append(ln)
                keep_idx.extend(range(int(lo), int(lo) + ln.width))
            else:
                self._quarantine(ln, err)
        narrowed = tuple(
            self._take_lanes(t, keep_idx) if keep_lanes and t is not None
            else None
            for t in trees)
        return (keep_lanes, *narrowed)

    # -------------------------------------------------------- checkpoints

    def _ckpt_path(self, key: str) -> str | None:
        if not self.checkpoint_dir:
            return None
        import os
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        # fleet workers share one checkpoint_dir: the worker prefix
        # keeps two workers running the same compile key from
        # clobbering each other's boundary file (single-process
        # filenames are unchanged)
        tag = f"{self.worker_id}-" if self.worker_id else ""
        return os.path.join(self.checkpoint_dir,
                            f"group-{tag}{key[:16]}.npz")

    def _save_checkpoint(self, key: str, lanes: list, state):
        """Write the group's chunk-boundary state + request metadata
        (atomic replace — a crash mid-write leaves the previous
        boundary's file intact).  Never raises into the drain loop:
        checkpointing is insurance, not a dependency."""
        path = self._ckpt_path(key)
        if path is None:
            return
        import os

        from ..utils import checkpoint
        meta = {"compile_key": key, "schema": CKPT_META_SCHEMA,
                "worker": self.worker_id,
                "requests": [
                    {"id": ln.req.id,
                     "spec": ln.req.spec.to_json(),
                     # the resume-time staleness gate: the stored spec
                     # must still digest to this value, or the file
                     # predates a spec edit and is refused
                     "spec_digest": ln.req.spec.digest(),
                     "requested": (ln.req.requested
                                   or ln.req.spec).to_json(),
                     "progress_ms": ln.req.progress_ms,
                     "width": ln.width,
                     "label": ln.req.label,
                     "ledger_extra": ln.req.ledger_extra}
                    for ln in lanes]}
        try:
            tmp = path + ".tmp.npz"
            # stored, not deflated (the JAX scheduler deflates): deflate
            # runs at about 0.2 GB/s on one core and a batch's ring is
            # GBs; either package loads either form
            checkpoint.save(tmp, state[0], state[1], meta=meta,
                            compress=False)
            os.replace(tmp, path)
        except Exception as e:      # noqa: BLE001 — insurance only
            import sys
            print(f"serve: checkpoint write failed for group {key[:8]}: "
                  f"{type(e).__name__}: {e!s:.200}", file=sys.stderr)

    def _drop_checkpoint(self, key: str):
        path = self._ckpt_path(key)
        if path is None:
            return
        import contextlib
        import os
        with contextlib.suppress(OSError):
            os.remove(path)

    def discard_checkpoint(self, key: str):
        """Drop one compile key's group checkpoint file (public seam:
        the matrix driver's memo resume discards mid-prefix checkpoints
        — a prefix resumed without its pre-crash obs carries could not
        stitch full-span artifacts for its forked cells, so the prefix
        re-runs instead)."""
        self._drop_checkpoint(key)

    def resume_checkpoints(self, accept=None) -> list:
        """Re-enqueue every interrupted group found in
        `checkpoint_dir`; returns the re-created request ids.  Each
        request resumes from its group's last written chunk boundary —
        the continuation is bit-identical to an uninterrupted run
        (chunk-boundary restore of the deterministic pure engine), so
        `first_divergence`-style full-pytree comparison passes
        (tests/test_serve_resilience.py).  Run `run_pending()` (or the
        service worker) afterwards to drive them to completion.

        `accept(path, meta) -> bool` filters candidate files by their
        metadata BEFORE the leaf arrays load (the fleet seam: a
        survivor adopting a dead worker's checkpoints must take only
        files whose every request it holds the lease for — adopting a
        LIVE worker's file would fork the run's identity).  None
        accepts everything (the single-process restart).

        Staleness refusal (module docstring): a `StaleCheckpointError`
        — checkpoint meta from another schema, or a stored spec that
        no longer digests to its recorded `spec_digest` — RAISES
        through with remedy text; any other failure (torn file,
        garbage .npz) keeps the
        one-bad-file-must-not-block-the-others behavior."""
        import glob
        import os
        if not self.checkpoint_dir:
            return []
        resumed = []
        for path in sorted(glob.glob(os.path.join(
                self.checkpoint_dir, "group-*.npz"))):
            try:
                resumed += self._resume_one(path, accept=accept)
            except StaleCheckpointError:
                raise       # a staleness refusal, never swallowed
            except Exception as e:      # noqa: BLE001 — one bad file
                # must not block the others
                import sys
                print(f"serve: checkpoint resume failed for {path}: "
                      f"{type(e).__name__}: {e!s:.300}", file=sys.stderr)
        return resumed

    def _resume_one(self, path: str, accept=None) -> list:
        from ..utils import checkpoint
        specs_meta = checkpoint.peek_meta(path)
        for problem in checkpoint.stale_meta_problems(specs_meta):
            raise StaleCheckpointError(
                f"serve: refusing checkpoint {path}: {problem}. "
                "Fix: delete the stale file (the run restarts from "
                "scratch), or resume with the tree/spec that wrote it")
        if accept is not None and not accept(path, specs_meta):
            return []
        ins = self._ins
        t0 = 0.0 if ins is None else ins.now()
        reqs_meta = specs_meta["requests"]
        spec0 = ScenarioSpec.from_json(reqs_meta[0]["spec"])
        proto = spec0.build_protocol(device=self.device)
        net, ps, _ = checkpoint.load(path, proto, seed=0,
                                     device=self.device)
        rids = []
        lo = 0
        with self._mu:
            for rm in reqs_meta:
                spec = ScenarioSpec.from_json(rm["spec"])
                w = int(rm["width"])
                sl = pytree.tree_map(lambda x, lo=lo, w=w: x[lo:lo + w],
                                     (net, ps))
                lo += w
                rid = rm["id"] if rm["id"] not in self._requests \
                    else self._rid_locked()
                req = Request(
                    id=rid, spec=spec,
                    compile_key=specs_meta["compile_key"],
                    requested=ScenarioSpec.from_json(rm["requested"]),
                    label=rm.get("label"),
                    ledger_extra=rm.get("ledger_extra"))
                req.progress_ms = int(rm["progress_ms"])
                req.resumed_from_ms = int(rm["progress_ms"])
                req.restored_state = sl
                self._requests[rid] = req
                self._queue.append(rid)
                rids.append(rid)
            self.resilience["resumed"] += len(rids)
        if ins is not None:
            from .instrument import SPAN_RESUME
            t1 = ins.now()
            resumed_at = {}
            with self._mu:
                for rid in rids:
                    r = self._requests[rid]
                    r.enq_mono = t1
                    resumed_at[rid] = r.resumed_from_ms
            attrs = {"key": specs_meta["compile_key"]}
            if specs_meta.get("worker") is not None:
                attrs["from_worker"] = specs_meta["worker"]
            for rid in rids:
                ins.end(SPAN_RESUME, t0, t1, rid=rid,
                        from_ms=resumed_at[rid], **attrs)
        # adoption CONSUMES a foreign worker's file: this scheduler
        # checkpoints the group under its OWN name from the next
        # boundary on, so a dead worker's file left behind would go
        # stale immediately — and a stale same-key file is exactly
        # what a second adopter could fork the run's identity from.
        # (Our own file keeps its lifecycle: overwritten each
        # boundary, dropped at group completion.)
        import contextlib
        import os
        own = self._ckpt_path(specs_meta["compile_key"])
        if own is not None and os.path.abspath(path) != \
                os.path.abspath(own):
            with contextlib.suppress(OSError):
                os.remove(path)
        return rids

    # ------------------------------------------------------------ journal

    def resume_journal(self) -> list:
        """Replay the durable submission journal (module docstring):
        every un-tombstoned entry re-enters the queue from its
        journaled spec, with its ORIGINAL request id, label and
        ledger_extra.  Run AFTER `resume_checkpoints()` — `recover()`
        orders the two — so a request that ALSO left a group
        checkpoint resumes from the checkpoint (its rid is already
        live here and the journal entry is skipped), never re-run from
        scratch.  A second replay is a no-op: duplicate rids are
        refused with a stderr note.  Finishes by compacting the
        journal down to the live entries.  Returns the re-enqueued
        request ids."""
        if self.journal is None:
            return []
        entries = self.journal.replay()
        rids = []
        with self._mu:
            for e in entries:
                rid = self._adopt_entry_locked(e)
                if rid is not None:
                    rids.append(rid)
            self.resilience["replayed"] += len(rids)
        if self._ins is not None and rids:
            from .instrument import SPAN_REPLAY
            for rid in rids:
                self._ins.mark(SPAN_REPLAY, rid=rid)
        self.journal.compact()
        return rids

    def _adopt_entry_locked(self, e: dict,
                            fork: ForkState | None = None,
                            keep_carries: bool = False) -> str | None:
        """Re-enqueue ONE journal entry under its original rid (caller
        holds the lock).  Returns the rid, or None when refused
        (already live — re-running a live request would fork its
        identity) or skipped (no longer validates) — both with the
        stderr notes the crash tests pin.  `fork` enters the adopted
        request mid-run from a memo-table prefix (the fleet search
        path); a fork that no longer validates degrades LOUDLY to an
        unforked full-span re-run, which is bit-identical."""
        import sys
        rid = e.get("rid")
        if rid in self._requests:
            print(f"serve: journal entry {rid} is already "
                  "live (checkpoint-resumed or double "
                  "replay); refused", file=sys.stderr)
            return None
        try:
            spec = ScenarioSpec.from_json(e["spec"])
            resolved = spec.validate()
        except (KeyError, ValueError, TypeError) as err:
            print(f"serve: journal entry {rid} no longer "
                  f"validates ({err!s:.200}); skipped — the "
                  "request must be re-submitted under the "
                  "current tree", file=sys.stderr)
            return None
        if fork is not None:
            try:
                self._check_fork(resolved, fork)
            except ValueError as err:
                print(f"serve: journal entry {rid} fork rejected "
                      f"({err!s:.200}); adopting unforked — the "
                      "full-span re-run is bit-identical",
                      file=sys.stderr)
                fork = None
        extra = dict(e.get("ledger_extra") or {})
        # an UNFORKED replay re-runs its full span (the fork state
        # died with the process): the provenance must not claim a
        # fork the re-run didn't take.  A memo-table fork below
        # re-stamps it.
        extra.pop("forked_from", None)
        req = Request(id=rid, spec=resolved,
                      compile_key=resolved.compile_key(),
                      requested=spec, label=e.get("label"),
                      keep_carries=bool(keep_carries),
                      ledger_extra=extra or None)
        if self._ins is not None:
            req.enq_mono = self._ins.now()
        if fork is not None:
            req.restored_state = fork.state
            req.saved_carries = {p: list(cs) for p, cs
                                 in (fork.carries or {}).items()}
            req.progress_ms = int(fork.at_ms)
            req.forked_from = {"prefix_digest": fork.prefix_digest,
                               "fork_ms": int(fork.at_ms)}
            req.ledger_extra = {**(req.ledger_extra or {}),
                                "forked_from": dict(req.forked_from)}
            self.memo["forked"] += 1
        self._requests[rid] = req
        self._queue.append(rid)
        return rid

    def adopt_journal_entry(self, entry: dict,
                            fork: ForkState | None = None,
                            keep_carries: bool = False) -> str | None:
        """Re-enqueue ONE journal entry under its original rid — the
        fleet worker's per-lease admission path (`resume_journal` is
        the adopt-everything restart variant; a fleet worker adopts
        exactly the entries whose lease it holds, so it must not
        vacuum the whole journal).  `fork` / `keep_carries` mirror
        `submit` — the fleet memo-table seam: a worker that finds the
        entry's honest prefix in the shared table enters it mid-run.
        Counts into ``resilience["replayed"]``; returns the rid or
        None."""
        with self._mu:
            rid = self._adopt_entry_locked(entry, fork=fork,
                                           keep_carries=keep_carries)
            if rid is not None:
                self.resilience["replayed"] += 1
        if rid is not None and self._ins is not None:
            from .instrument import SPAN_REPLAY
            self._ins.mark(SPAN_REPLAY, rid=rid)
        return rid

    def recover(self) -> dict:
        """Crash-only restart, one call: checkpoints first (mid-run
        groups restore their chunk-boundary state under their original
        ids), then the journal (queued-but-unlaunched submits replay
        from their specs; entries a checkpoint already restored are
        skipped by rid).  Returns the two request-id lists.  Drive
        with `run_pending()` (or the service worker) afterwards."""
        return {"checkpoints": self.resume_checkpoints(),
                "journal": self.resume_journal()}

    # -------------------------------------------------------------- health

    def health_stats(self) -> dict:
        """The `/w/batch/health` block: uptime, per-tenant queue
        depths, journal lag (accepted-but-unsettled entries),
        quarantine count, watchdog trips and the chunk-wall EMA — the
        numbers an operator needs to decide whether a serve process is
        healthy, wedged, or bleeding requests."""
        # journal lag reads the WAL file — outside the lock (IO)
        lag = self.journal.lag() if self.journal is not None else None
        deadline = self.launch_deadline_s()
        with self._mu:
            queued: dict = {}
            running = 0
            for r in self._requests.values():
                if r.status == "queued":
                    queued[r.spec.tenant] = queued.get(r.spec.tenant,
                                                       0) + 1
                elif r.status == "running":
                    running += 1
            out = {"uptime_s": round(time.time() - self._t0, 3),
                   "queued": sum(queued.values()),
                   "queued_by_tenant": queued,
                   "running": running,
                   "submitted": self._n,
                   "journal": self.journal is not None,
                   "journal_lag": lag,
                   "quarantined": self.resilience["quarantined"],
                   "watchdog_trips": self.resilience["watchdog_trips"],
                   "watchdog_deadline_s": (round(deadline, 3)
                                           if deadline is not None
                                           else None),
                   "chunk_wall_ema_s": round(self.chunk_wall_ema_s, 4),
                   "resilience": dict(self.resilience),
                   "draining": self._draining}
        if self._ins is not None:
            # span-derived phase p50/p99 (queue-wait/compile/launch) —
            # the EMA says how long a chunk takes, this says where a
            # request's wall actually went (outside the lock: reads
            # the recorder's own ring under its own lock)
            out["phases"] = self._ins.health_phases()
        return out

    # --------------------------------------------------------- preemption

    def _waiting_elsewhere(self, key: str, engine: str,
                           progress_ms: int | None = None) -> list:
        """Queued requests that CANNOT join the running group (caller
        holds the lock): a different compile key, or a lockstep lane
        the repack admission can't absorb at the group's current
        boundary (fresh request, or a restored one at a different
        progress).  Only these justify yielding — a same-key vmapped
        request late-joins for free, and a same-key restored lockstep
        request at the group's progress repacks in for free too."""
        out = []
        for rid in self._queue:
            r = self._requests[rid]
            if r.compile_key != key:
                out.append(r)
            elif engine != "vmapped" and not (
                    progress_ms is not None
                    and r.progress_ms == progress_ms
                    and r.restored_state is not None):
                out.append(r)
        return out

    def _should_yield(self, key: str, lanes: list, chunks_run: int,
                      budget: int | None) -> str | None:
        """The chunk-boundary preemption decision (module docstring).
        Returns the reason ("priority" | "slice" | "deadline") or
        None."""
        engine = lanes[0].req.spec.engine
        now = time.time()
        with self._mu:
            others = self._waiting_elsewhere(
                key, engine, progress_ms=lanes[0].req.progress_ms)
            if not others:
                return None
            group_pri = max(ln.req.spec.priority for ln in lanes)
            if any(r.spec.priority > group_pri for r in others):
                return "priority"
            if budget is not None and chunks_run >= budget:
                return "slice"
            deadlines = [d for d in (ln.req.deadline_at for ln in lanes)
                         if d is not None]
            if deadlines and all(now >= d for d in deadlines):
                # every deadline-CARRYING lane blew its wall budget:
                # the group no longer holds the device against waiting
                # work (soft — the run continues on a later rotation,
                # never killed; deadline-less lanes ride the yield and
                # resume bit-identically)
                return "deadline"
        return None

    def _preempt(self, key: str, lanes: list, state, ff_stats,
                 reason: str):
        """Yield at a chunk boundary: slice each lane's state out of
        the batch and re-enqueue its request carrying that state (and
        its stashed obs carries) — the in-memory twin of the group
        checkpoint, consumed by `_init_lanes` exactly like a
        checkpoint restore, so the continuation is bit-identical."""
        offsets = np.cumsum([0] + [ln.width for ln in lanes])
        slices = [_lane_slice(state, int(lo), ln.width)[:2]
                  for ln, lo in zip(lanes, offsets)]
        ins = self._ins
        t_pre = 0.0 if ins is None else ins.now()
        with self._mu:
            self.resilience["preemptions"] += 1
            for ln, sl in zip(lanes, slices):
                req = ln.req
                req.restored_state = sl
                req.saved_carries = ln.carries
                if ff_stats is not None:
                    acc = req.ff_accum or {"skipped_ms": 0,
                                           "jump_count": 0}
                    req.ff_accum = {k: acc[k] + ff_stats[k]
                                    for k in acc}
                req.preempted += 1
                req.status = "queued"
                if ins is not None:
                    # queue-wait restarts at the re-enqueue boundary
                    req.enq_mono = t_pre
                self._queue.append(req.id)
                self._tstat(req.spec.tenant)["preemptions"] += 1
        if ins is not None:
            from .instrument import MARK_PREEMPT
            for ln in lanes:
                ins.mark(MARK_PREEMPT, rid=ln.req.id, key=key,
                         reason=reason,
                         at_ms=ln.req.progress_ms)

    # ------------------------------------------------------------ the run

    def _run_group(self, key: str,
                   budget_chunks: int | None = None) -> tuple:
        """Run one compile-key group until it finishes or yields
        (`_should_yield`); returns ``(requests_done, chunks_run)``."""
        reqs = self._take_compatible(key)
        if not reqs:
            return 0, 0
        spec0 = reqs[0].spec
        if spec0.engine != "vmapped" and len(reqs) > 1:
            # lockstep engines (one fused mailbox / one shared jump)
            # need equal clocks across the batch: a checkpoint-resumed
            # request's progress differs from a fresh one's, so only
            # same-progress requests group together; the rest go back
            # to the queue head and form the next group
            head_prog = reqs[0].progress_ms
            defer = [r for r in reqs if r.progress_ms != head_prog]
            if defer:
                with self._mu:
                    self._queue[0:0] = [r.id for r in defer]
                reqs = [r for r in reqs if r.progress_ms == head_prog]
        planes = list(spec0.obs)
        primary = "metrics" if "metrics" in planes else None
        shadows = [p for p in planes if p != primary]
        # the JAX scheduler's carry order: the primary plane, then the
        # shadows (the port runs them all in one pass)
        order = ([primary] if primary is not None else []) + shadows
        # The per-lane dense engine admits ANY same-key late joiner at
        # every chunk boundary; lockstep engines (one fused mailbox /
        # one shared jump over the whole batch) admit only restored
        # requests whose clock matches the group's — see the repack
        # branch at the bottom of the loop.
        admit_inflight = spec0.engine == "vmapped"
        lanes = [_Lane(r) for r in reqs]
        # ONE construction per group
        proto0 = spec0.build_protocol(device=self.device)
        state = self._concat(self._init_lanes(reqs, proto0))
        now = time.time()
        with self._mu:
            for r in reqs:
                r.status, r.started = "running", now
        ins = self._ins
        if ins is not None:
            # queue-wait ends where the group marks its requests
            # running (enq_mono is drain-private once dequeued)
            from .instrument import SPAN_COMPILE, SPAN_QUEUE_WAIT
            t_run = ins.now()
            for r in reqs:
                if r.enq_mono is not None:
                    ins.end(SPAN_QUEUE_WAIT, r.enq_mono, t_run,
                            rid=r.id, key=key, tenant=r.spec.tenant)
                    r.enq_mono = None
        ff_stats = {"skipped_ms": 0, "jump_count": 0}
        done = 0
        chunks_run = 0
        # One registry lookup per plane per GROUP (the programs are
        # constant across chunks) — hit/miss counters then reflect
        # warm/cold submits, not chunk counts.
        # The port then runs the group's ONE-pass program over all of
        # them (registry module docstring).
        t_cmp = 0.0 if ins is None else ins.now()
        progs = [self.registry.chunk_fn(spec0, primary, proto=proto0)]
        progs += [self.registry.chunk_fn(spec0, p, proto=proto0)
                  for p in shadows]
        fn = self.registry.fused(spec0, progs)
        if ins is not None:
            ins.end(SPAN_COMPILE, t_cmp, key=key, lanes=len(reqs))
        freeze_probe = None
        if self.freeze:
            from ..memo import build_probe, freeze_supported
            if freeze_supported(spec0, proto0.cfg):
                freeze_probe = build_probe(proto0)
        while lanes:
            entry = state
            widths = [ln.width for ln in lanes]
            t_chunk = time.time()
            tc0 = 0.0 if ins is None else ins.now()
            out, lane_errs = self._launch(fn, entry, widths,
                                          spec0.engine)
            if out is None:
                # EVERY lane failed: that is a dead device, not a
                # poison verdict (a bisection that eliminates
                # everything isolated nothing) — keep the
                # group-failure semantics: raise into _fail_group,
                # group checkpoint RETAINED for a later resume
                raise lane_errs[0]
            if any(e is not None for e in lane_errs):
                # poison-lane quarantine: a lane that failed while its
                # batch siblings succeeded is the poison — it settles
                # alone; `out` already covers the survivors
                lanes = self._quarantine_failed(lanes, lane_errs)[0]
                widths = [ln.width for ln in lanes]
            state = (out[0], out[1], out[2])
            if spec0.engine == "fast_forward":
                st = out[3]
                ff_stats["skipped_ms"] += int(st["skipped_ms"])
                ff_stats["jump_count"] += int(st["jump_count"])
            # the chunk's one synchronising call: its carries to the
            # host (the lanes keep them there), or a device synchronize
            carries = pytree.tree_map(lambda x: x.cpu(), out[4])
            if not carries and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            offsets = np.cumsum([0] + [ln.width for ln in lanes])
            for plane in order:
                for ln, lo in zip(lanes, offsets):
                    ln.stash(plane, carries[plane], int(lo))
            # snapshots force a device sync — compute them OUTSIDE the
            # lock (lane fields are drain-thread-private; only the
            # request records need the lock) so submit/status threads
            # never stall on a chunk's device_get
            updates = []
            for ln in lanes:
                ln.remaining -= 1
                t_ms = ln.req.progress_ms + spec0.chunk_ms
                updates.append((ln.req, t_ms, self._snapshot(ln, t_ms)))
            with self._mu:
                for req, t_ms, snap in updates:
                    req.progress_ms = t_ms
                    req.progress = snap
                    # the streaming endpoint's backing store: this
                    # boundary's primary-pass totals + their delta vs
                    # the previous boundary (cumulative counters become
                    # per-chunk contributions client-side for free)
                    totals = {k: v for k, v in snap.items()
                              if k not in ("t_ms", "sim_ms")}
                    prev = req.chunk_totals[-1]["totals"] \
                        if req.chunk_totals else {}
                    req.chunk_totals.append(
                        {"t_ms": t_ms, "totals": totals,
                         "delta": {k: v - prev.get(k, 0)
                                   for k, v in totals.items()}})
                self._boundary.notify_all()
            finished = [ln for ln in lanes if ln.remaining == 0]
            if finished:
                for ln, lo in zip(lanes, offsets):
                    if ln.remaining == 0:
                        final = _lane_slice(state, int(lo), ln.width)[:2]
                        self._finalize(ln, final,
                                       ff_stats if spec0.engine ==
                                       "fast_forward" else None)
                done += len(finished)
                keep = [i for s, ln in zip(offsets, lanes)
                        if ln.remaining > 0
                        for i in range(int(s), int(s) + ln.width)]
                lanes = [ln for ln in lanes if ln.remaining > 0]
                if lanes:
                    state = self._take_lanes(state, keep)
            if freeze_probe is not None and lanes:
                state, lanes, n_frozen = self._freeze_pass(
                    spec0, proto0, freeze_probe, lanes, state)
                done += n_frozen
            if self.checkpoint_dir:
                if lanes:
                    self._save_checkpoint(key, lanes, state)
                else:
                    self._drop_checkpoint(key)
            chunks_run += 1
            # the retry-after estimate's unit cost: an EMA of one
            # coalesced chunk's wall time (the snapshot above already
            # synced the device, so this is honest compute time)
            dt = time.time() - t_chunk
            with self._mu:      # read by watchdog/health threads
                ema = self.chunk_wall_ema_s
                self.chunk_wall_ema_s = (dt if not ema
                                         else 0.8 * ema + 0.2 * dt)
            if self.catalog is not None:
                # per-launch chunk-wall sample into the program
                # observatory (drift pass: measured walls next to the
                # capture row's predicted/analyzed costs)
                self.catalog.observe_chunk(key, dt, lanes=len(widths))
            if ins is not None:
                from .instrument import SPAN_CHUNK
                ins.end(SPAN_CHUNK, tc0, key=key, lanes=len(widths))
            if self.on_boundary is not None:
                self.on_boundary()
            if lanes:
                reason = self._should_yield(key, lanes, chunks_run,
                                            budget_chunks)
                if reason is not None:
                    self._preempt(key, lanes, state,
                                  ff_stats if spec0.engine ==
                                  "fast_forward" else None, reason)
                    return done, chunks_run
            if admit_inflight:
                joiners = self._take_compatible(key)
            elif lanes:
                # lockstep lane repacking: a restored request
                # (checkpoint, preemption or fork) whose saved boundary
                # equals this group's clock re-enters HERE instead of
                # stranding until the group finishes — equal progress
                # under one compile key means equal device time arrays,
                # so the fused mailbox / shared jump stays sound and
                # the continuation is the same program it would have
                # run solo (the bit-identity tests pin this)
                joiners = self._take_compatible(
                    key, progress_ms=lanes[0].req.progress_ms)
            else:
                joiners = []
            if joiners:
                now = time.time()
                with self._mu:
                    if not admit_inflight:
                        self.resilience["repacked"] += len(joiners)
                    for r in joiners:
                        r.status, r.started = "running", now
                if ins is not None:
                    from .instrument import SPAN_QUEUE_WAIT
                    t_run = ins.now()
                    for r in joiners:
                        if r.enq_mono is not None:
                            ins.end(SPAN_QUEUE_WAIT, r.enq_mono,
                                    t_run, rid=r.id, key=key,
                                    tenant=r.spec.tenant)
                            r.enq_mono = None
                new = self._init_lanes(joiners, proto0)
                state = self._concat(
                    ([state] if lanes else []) + new)
                lanes.extend(_Lane(r) for r in joiners)
        return done, chunks_run

    # -------------------------------------------------------------- memo

    def _freeze_pass(self, spec0, proto0, probe, lanes: list, state):
        """Fixed-point lane freezing at one chunk boundary (module
        docstring + memo/freeze.py): lanes whose every seed's
        `next_work` lands at or past the lane's end are finalized NOW —
        final state via the quiet-window jump, remaining obs carries
        synthesized — and sliced out of the batch, so the surviving
        lanes stop paying for converged neighbors.  Returns the
        narrowed ``(state, lanes, frozen_count)``."""
        nw = probe(state[0], state[1]).cpu().numpy().reshape(-1)
        times = state[2]
        offsets = np.cumsum([0] + [ln.width for ln in lanes])
        attack = spec0.attack
        frozen = []
        for ln, lo in zip(lanes, offsets):
            lo = int(lo)
            t_lane = int(times[lo])
            if attack is not None and t_lane <= int(attack["at_ms"]):
                continue        # a pending FaultInjector perturbation
                # is outside the oracle's view — never freeze across it
            t_end = t_lane + ln.remaining * spec0.chunk_ms
            if int(nw[lo:lo + ln.width].min()) >= t_end:
                frozen.append((ln, lo, t_lane, t_end))
        if not frozen:
            return state, lanes, 0
        from ..memo import frozen_carries, frozen_final
        for ln, lo, t_lane, t_end in frozen:
            lane_state = _lane_slice(state, lo, ln.width)[:2]
            final = frozen_final(proto0.cfg, lane_state, t_end)
            tails = frozen_carries(spec0, proto0.cfg, lane_state,
                                   t_lane, ln.remaining)
            for plane, chunks in tails.items():
                ln.carries.setdefault(plane, []).extend(chunks)
            # the stream must see every boundary the ARTIFACT claims:
            # synthesized tail chunks get their (constant — the lane is
            # a fixed point) totals appended like executed ones, so a
            # /w/batch/stream client and serve_load's --stream smoke
            # count sim_ms/chunk_ms entries whether or not lanes froze
            snap = self._snapshot(ln, t_end)
            totals = {k: v for k, v in snap.items()
                      if k not in ("t_ms", "sim_ms")}
            with self._mu:
                for i in range(int(ln.remaining)):
                    prev = ln.req.chunk_totals[-1]["totals"] \
                        if ln.req.chunk_totals else {}
                    ln.req.chunk_totals.append(
                        {"t_ms": t_lane + (i + 1) * spec0.chunk_ms,
                         "totals": dict(totals),
                         "delta": {k: v - prev.get(k, 0)
                                   for k, v in totals.items()}})
                self._boundary.notify_all()
                ln.req.frozen_from_ms = t_lane
                self.memo["frozen_lanes"] += 1
                self.memo["frozen_chunks"] += int(ln.remaining)
            self._finalize(ln, final, None)
        gone = {id(ln) for ln, *_ in frozen}
        keep = [i for s, ln in zip(offsets, lanes)
                if id(ln) not in gone
                for i in range(int(s), int(s) + ln.width)]
        lanes = [ln for ln in lanes if id(ln) not in gone]
        if lanes:
            state = self._take_lanes(state, keep)
        return state, lanes, len(frozen)

    # ------------------------------------------------------- per-request

    def _snapshot(self, ln: _Lane, t_ms: int) -> dict:
        """Streaming-progress snapshot from the LAST metrics carry (the
        on-device metrics plane is what status() streams); falls back
        to the clock alone when metrics are off.  Forces a device sync
        — callers run it outside the scheduler lock."""
        snap = {"t_ms": t_ms, "sim_ms": ln.req.spec.sim_ms}
        carries = ln.carries.get("metrics")
        if carries:
            from ..obs.export import MetricsFrame
            from ..obs.spec import MetricsSpec
            mspec = MetricsSpec(stat_each_ms=ln.req.spec.stat_each_ms)
            totals = MetricsFrame.from_carry(mspec, carries[-1]).totals()
            for name in ("done_count", "live_count", "msg_sent",
                         "drop_count"):
                if name in totals:
                    snap[name] = totals[name]
        return snap

    def _finalize(self, ln: _Lane, final_state, ff_stats):
        ins = self._ins
        t_set = 0.0 if ins is None else ins.now()
        req, spec = ln.req, ln.req.spec
        proto_cfg = req.cfg
        requested = req.requested or spec
        art = {"request": req.id, "compile_key": req.compile_key,
               "spec_digest": requested.digest(),
               "spec": requested.to_json(),
               "seeds": list(spec.seeds), "sim_ms": spec.sim_ms,
               "engine": spec.engine, "superstep": spec.superstep}
        nodes = final_state[0].nodes
        down = nodes.down.cpu().numpy()
        done_at = nodes.done_at.cpu().numpy()
        art["summary"] = {
            "done_count": int(((done_at > 0) & ~down).sum()),
            "live_count": int((~down).sum()),
            "msg_sent": int(nodes.msg_sent.cpu().numpy()
                            .astype(np.int64).sum()),
            "msg_received": int(nodes.msg_received.cpu().numpy()
                                .astype(np.int64).sum()),
        }
        if ff_stats is not None:
            acc = req.ff_accum or {}
            art["fast_forward"] = {k: ff_stats[k] + acc.get(k, 0)
                                   for k in ff_stats}   # group-level
        with self._mu:      # watchdog/retry threads mutate counters
            art["resilience"] = dict(self.resilience)   # scheduler-level
        art["tenant"] = spec.tenant
        if req.preempted:
            art["preempted"] = req.preempted
        if req.forked_from:
            # snapshot-fork provenance: the artifacts (and the ledger
            # row, via ledger_extra at submit) name the honest prefix
            # this request entered from, so verification tooling checks
            # forked cells against sequential twins instead of skipping
            art["forked_from"] = dict(req.forked_from)
        if req.frozen_from_ms is not None:
            art["memo"] = {"frozen_from_ms": req.frozen_from_ms,
                           "frozen_chunks":
                           (spec.sim_ms - req.frozen_from_ms)
                           // spec.chunk_ms}
        line = {"metric": f"serve_{req.id}", "sim_ms": spec.sim_ms,
                "superstep": spec.superstep, "batch": len(spec.seeds)}
        if req.resumed_from_ms:
            # the obs-plane blocks below cover the post-restore span;
            # the trajectory itself is bit-identical to an
            # uninterrupted run (module docstring)
            art["resumed_from_ms"] = req.resumed_from_ms
            line["resumed_from_ms"] = req.resumed_from_ms
        if "metrics" in ln.carries:
            from ..obs.export import MetricsFrame, engine_metrics_block
            from ..obs.spec import MetricsSpec
            mspec = MetricsSpec(stat_each_ms=spec.stat_each_ms)
            frame = MetricsFrame.from_carries(mspec, ln.carries["metrics"])
            art["engine_metrics"] = engine_metrics_block(
                frame, extra={"metrics_seeds": len(spec.seeds)})
            line["engine_metrics"] = art["engine_metrics"]
        if "trace" in ln.carries:
            from ..obs.decode import TraceFrame, trace_block
            from ..obs.trace import TraceSpec
            tspec = TraceSpec(capacity=spec.trace_capacity)
            tframe = TraceFrame.from_carries(tspec, ln.carries["trace"])
            art["trace"] = trace_block(tframe,
                                       extra={"trace_seeds":
                                              len(spec.seeds)})
            line["trace"] = art["trace"]
        if "audit" in ln.carries:
            from ..obs.audit import AuditSpec, monitored_invariants
            from ..obs.audit_report import AuditReport, audit_block
            aspec = AuditSpec()
            report = AuditReport.from_carries(
                aspec, ln.carries["audit"],
                monitored=monitored_invariants(aspec, proto_cfg))
            art["audit"] = audit_block(report,
                                       extra={"audit_seeds":
                                              len(spec.seeds)})
            line["audit"] = art["audit"]
            if not report.clean:
                import sys
                print(f"serve: AUDIT VIOLATIONS in request {req.id}:\n"
                      f"{report.format()}", file=sys.stderr)
        now = time.time()
        wall = now - (req.started or now)
        if req.deadline_at is not None and now > req.deadline_at:
            # observability only — a deadline demotes the request's
            # hold on the device (_should_yield), it never kills it
            art["deadline_missed"] = True
        line["wall_total_s"] = round(wall, 3)
        # durable completion facts ride the ledger row's extra: the
        # matrix driver's campaign resume / cross-grid dedup rebuilds
        # a finished cell's report row from them without re-running it
        durable = {"summary": dict(art["summary"])}
        if "engine_metrics" in art:
            from ..obs.export import time_to_done_ms
            ttd = time_to_done_ms(art["engine_metrics"])
            if ttd is not None:
                durable["time_to_done_ms"] = ttd
        if "audit" in art and not art["audit"]["clean"]:
            durable["violations"] = {
                k: v for k, v in art["audit"]["violations"].items() if v}
        req.ledger_extra = {**(req.ledger_extra or {}), **durable}
        if ins is not None:
            # the scrapeable registry's state at settle time rides the
            # ledger row — a campaign postmortem reads the metric
            # trajectory from the rows alone, no scraper needed
            from .instrument import ledger_metrics_block
            line["host_metrics"] = ledger_metrics_block(self)
        if self.settle_hook is not None:
            self.settle_hook(req, final_state,
                             {p: list(cs) for p, cs in ln.carries.items()})
        path = self._append_ledger(req, line)
        art["wall_s"] = round(wall, 3)
        art["registry"] = self.registry.stats()
        with self._mu:
            self._tstat(spec.tenant)["done"] += 1
            req.artifacts = art
            req.final_state = final_state
            if req.keep_carries:
                req.final_carries = {p: list(cs)
                                     for p, cs in ln.carries.items()}
            req.finished = now
            req.manifest_path = path
            req.progress_ms = spec.sim_ms
            req.status = "done"
            self._evict_old_done()
            self._boundary.notify_all()     # wake stream long-polls
        if self.journal is not None:
            self.journal.record_settled(req.id, "done")
        if ins is not None:
            from .instrument import SPAN_SETTLE
            ins.end(SPAN_SETTLE, t_set, rid=req.id,
                    key=req.compile_key, tenant=spec.tenant,
                    wall_s=round(wall, 3))

    def _evict_old_done(self):
        """Drop the oldest finished records past `keep_done` (caller
        holds the lock).  Their ledger rows remain the durable
        artifact; in-memory final_state/artifacts are what must not
        accumulate in a long-lived service."""
        if not self.keep_done:
            return
        done = sorted((r for r in self._requests.values()
                       if r.status in ("done", "error")),
                      key=lambda r: r.finished or r.submitted)
        for victim in done[:max(0, len(done) - self.keep_done)]:
            del self._requests[victim.id]

    def _append_ledger(self, req: Request, line: dict) -> str | None:
        """One `RunManifest` row per request; the config digest IS the
        AS-SUBMITTED spec digest (the ledger's promised
        ScenarioSpec hookup — bench and the suite digest their
        requested configs too, so rows correlate across all three).
        The line's own engine/superstep fields carry the resolved
        dispatch.  Never raises — provenance must not fail a finished
        request."""
        from ..obs import ledger
        from ..utils.platform import backend
        try:
            mani = ledger.manifest_from_spec(
                line, req.requested or req.spec,
                label=req.label or f"serve:{req.id}",
                backend=backend(self.device),
                compile_key=req.compile_key,
                **(req.ledger_extra or {}))
            return ledger.append(mani, self.ledger_path)
        except Exception as e:      # noqa: BLE001 — provenance only
            import sys
            print(f"serve: ledger append failed for {req.id}: "
                  f"{type(e).__name__}: {e!s:.200}", file=sys.stderr)
            return None
