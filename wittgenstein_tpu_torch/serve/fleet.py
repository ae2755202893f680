"""Fleet: lease-based multi-process scale-out of the serve plane — the
port of `wittgenstein_tpu/serve/fleet.py`, its directory layout, journal
rows, lease rows, ledger rows and stats snapshots the JAX package's, so
a fleet directory written by one package's workers is read by the
other's.

One scheduler process is bounded by one drain loop; this module adds
ONLY the coordination layer on top of the crash-only substrate:

  * The durable submission journal (journal.py) is the shared work
    queue: a front tier (`FleetService`) appends fsync'd submit rows;
    N `FleetWorker` processes poll the same file.
  * Workers claim entries through `LeaseTable` — append-only fsync'd
    claim rows with a worker id and an absolute deadline.  Expired
    leases are reclaimable; a double claim resolves deterministically
    to the lexicographically smallest worker id (journal.py).
  * Crash recovery of a dead worker IS the journal replay path, run by
    any survivor: the dead worker stops renewing, its leases expire,
    and a survivor either adopts its group checkpoint (lease-gated
    through `Scheduler.resume_checkpoints(accept=)` — resuming from
    the last chunk boundary on a copy of the ring, bit-identical) or
    replays the journal entry from its spec.
  * Cross-worker dedup is the ledger join: an entry whose spec digest
    already has a clean, summary-bearing row in the shared ledger is
    tombstoned as done without running — the row IS the result,
    bit-identical by the determinism contract.
  * Completion facts flow through the shared ledger (every worker's
    `Scheduler._finalize` appends rows to one file), so results
    outlive the worker that computed them.
  * A worker with a memo table publishes a finished ``memo_prefix``
    entry's state into the table BEFORE the entry's journal tombstone
    (`Scheduler.settle_hook`).  A search waiting on the prefix sees
    the table entry no later than the tombstone, so its probes always
    fork.  (The JAX worker publishes after its drain returns, after
    the tombstone; a search polling in between falls back to unforked
    probes, tests/test_search.py:279's intermittent failure.)

Directory-sharing contract (`fleet_paths`): one fleet directory holds
``journal/`` (submissions.jsonl + leases.jsonl), ``checkpoints/``
(worker-prefixed group files — `Scheduler(worker_id=)` keeps two
workers from clobbering each other), ``ledger.jsonl`` and ``workers/``
(per-worker stats snapshots, atomically replaced).  All cross-process
writes are APPENDS to JSONL files or whole-file atomic replaces —
safe under concurrent writers on POSIX.  Compaction (journal or
leases) rewrites a whole file from one process's snapshot and is
therefore a QUIESCENT-TIME operation in a fleet: workers never
compact shared files.

Each worker process runs its scheduler on `device` (``cuda`` unless
``--device`` says otherwise); N workers on one card share it, and a
worker process loads the kernel library its parent's first launch
built (`ops/_build.py`: one library file per source hash).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

from ..utils import jsonl
from .journal import LeaseTable, SubmissionJournal
from .scheduler import Scheduler
from .spec import ScenarioSpec


def fleet_paths(fleet_dir) -> dict:
    """The directory-sharing contract: every fleet participant derives
    the same layout from the one shared directory."""
    d = str(fleet_dir)
    return {"dir": d,
            "journal_dir": os.path.join(d, "journal"),
            "checkpoint_dir": os.path.join(d, "checkpoints"),
            "ledger_path": os.path.join(d, "ledger.jsonl"),
            "stats_dir": os.path.join(d, "workers")}


def clean_rows_by_digest(ledger_path) -> dict:
    """config_digest -> first clean, summary-bearing `RunManifest` row
    of the shared ledger — the dedup/result join, shared by the
    workers (dedup) and the front tier (serving results)."""
    from ..obs import ledger as ledger_mod
    out: dict = {}
    for row in ledger_mod.read_all(ledger_path):
        ex = row.extra or {}
        if "summary" in ex and row.audit_clean is not False:
            out.setdefault(row.config_digest, row)
    return out


def _clean_row(raw: dict):
    """Parse one raw ledger row; return the `RunManifest` iff it is a
    clean, summary-bearing completion row (the dedup-join predicate of
    `clean_rows_by_digest`), else None."""
    from ..obs import ledger as ledger_mod
    try:
        row = ledger_mod.RunManifest.from_json(raw)
    except (TypeError, ValueError) as e:
        print(f"fleet: unparseable ledger row skipped from the dedup "
              f"join ({type(e).__name__}: {e!s:.120})", file=sys.stderr)
        return None
    ex = row.extra or {}
    if "summary" in ex and row.audit_clean is not False:
        return row
    return None


def kernel_stats() -> dict:
    """This process's kernel launch counts (each wrapper's ``launches``,
    which moves only where the wrapper launches its CUDA kernel) and the
    seconds it spent building the kernel library (0 when it loaded the
    library another process built, or launched nothing): a worker
    publishes them in its stats snapshot, so a parent reads which
    kernels a fleet's requests ran."""
    from ..ops import _build
    from ..ops.gsf_merge import gsf_merge
    from ..ops.merge import merge_queue
    from ..ops.route import bin_into_ring
    from ..ops.score import gsf_score, score_queue
    return {"launches": {"route": bin_into_ring.launches,
                         "merge": merge_queue.launches,
                         "score": score_queue.launches,
                         "gsf_merge": gsf_merge.launches,
                         "gsf_score": gsf_score.launches},
            "build_s": round(_build.BUILD_INFO.get("seconds", 0.0), 3)}


def aggregate_worker_stats(fleet_dir) -> dict:
    """Aggregate the fleet's atomically-published per-worker stats
    snapshots (`FleetWorker.write_stats`): summed counters / registry /
    resilience blocks plus the raw per-worker blocks under
    ``workers``.  Unreadable snapshots are skipped loudly — a reader
    never sees a half-written file (atomic replace), but a worker
    SIGKILLed before its first write has no file at all."""
    import glob

    stats_dir = fleet_paths(fleet_dir)["stats_dir"]
    per: dict = {}
    for path in sorted(glob.glob(os.path.join(stats_dir,
                                              "worker-*.json"))):
        try:
            with open(path) as f:
                blk = json.load(f)
        except (OSError, ValueError) as e:
            print(f"fleet: unreadable worker stats {path} ({e}); "
                  "skipped from the aggregate", file=sys.stderr)
            continue
        per[blk.get("worker", os.path.basename(path))] = blk
    agg = {"counters": {}, "registry": {}, "resilience": {}}
    for blk in per.values():
        for k, v in blk.items():
            if isinstance(v, (int, float)) and k != "worker":
                agg["counters"][k] = agg["counters"].get(k, 0) + v
        for sub in ("registry", "resilience"):
            for k, v in (blk.get(sub) or {}).items():
                if isinstance(v, (int, float)):
                    agg[sub][k] = agg[sub].get(k, 0) + v
    agg["workers"] = per
    return agg


class FleetWorker:
    """One worker process of a fleet (module docstring): a standard
    `Scheduler` with a fleet identity, plus the poll-claim-adopt loop
    and a daemon lease-renewal thread.  The scheduler runs on `device`
    (``cuda`` unless given).

    `digest_dir` is an observation seam for `chip_smoke.py` and the
    tests, not a campaign feature: the worker then appends each
    finished request's per-seed state digests (`convert.seed_digests`,
    the leaf sha256s the JAX goldens record) to
    ``digest_dir/digests-<worker>.jsonl`` before its ledger row, at the
    cost of a copy of the whole state to the host and its hash.  A
    fleet's final states stay in its worker processes; this is how a
    check holds them against golden digests.  Campaigns leave it off
    (None)."""

    #: lock inventory (analysis rule ``host_locks``): `_mu` guards the
    #: held-lease set and the counters — both mutated from the step
    #: loop AND read from the renewal thread / stats writer.
    _LOCK_OWNS = {"_mu": ("_held", "counters")}

    def __init__(self, fleet_dir, worker_id: str, *, registry=None,
                 lease_ttl_s: float = 10.0, dedup: bool = True,
                 scheduler_kw: dict | None = None, instrument=None,
                 memo_table=None, device=None, digest_dir=None):
        self.paths = fleet_paths(fleet_dir)
        self.worker_id = str(worker_id)
        self.lease_ttl_s = float(lease_ttl_s)
        self.dedup = bool(dedup)
        self.digest_path = None if digest_dir is None else os.path.join(
            str(digest_dir), f"digests-{self.worker_id}.jsonl")
        #: cross-run memo table: when set, this
        #: worker PUBLISHES finished ``memo_prefix`` entries' states
        #: into the shared on-disk table and RESOLVES probe entries'
        #: ``memo_fork`` instructions against it — concurrent probes
        #: on different workers reuse each other's completed prefixes.
        self.table = None
        if memo_table is not None:
            from ..memo.table import MemoTable
            self.table = memo_table if isinstance(memo_table,
                                                  MemoTable) \
                else MemoTable(memo_table)
        #: host flight recorder + metrics (serve/instrument; None =
        #: OFF) — shared with the scheduler, so one span log carries
        #: the whole worker: lease traffic AND request lifecycle
        self._ins = instrument
        self.sched = Scheduler(
            registry=registry,
            ledger_path=self.paths["ledger_path"],
            checkpoint_dir=self.paths["checkpoint_dir"],
            journal_dir=self.paths["journal_dir"],
            worker_id=self.worker_id,
            instrument=instrument, device=device,
            **dict(scheduler_kw or {}))
        # publish a finished prefix and this worker's stats before the
        # request's ledger row and tombstone (module docstring)
        self.sched.settle_hook = self._on_settle
        self.journal: SubmissionJournal = self.sched.journal
        self.leases = LeaseTable(self.paths["journal_dir"],
                                 ttl_s=self.lease_ttl_s)
        self.counters = {"claimed": 0, "deduped": 0, "released": 0,
                         "renewed": 0,
                         "adopted_checkpoints": 0, "processed": 0,
                         "steps": 0,
                         "memo_table_hits": 0, "memo_table_misses": 0,
                         "prefix_chunks_saved": 0,
                         "search_probes_total": 0}
        self._held: set = set()
        self._keys: dict = {}           # rid -> (digest, compile_key)
        #: incremental dedup view of the shared ledger: each poll
        #: parses only the bytes appended since the last one (the
        #: ledger grows for the life of a campaign; re-reading it
        #: whole every cycle made the idle poll O(file)).  Compaction
        #: resets the reader to 0 and the setdefault accumulator
        #: absorbs the re-parse idempotently.
        self._ledger_tail = jsonl.TailReader(self.paths["ledger_path"],
                                             label="ledger")
        self._ledger_clean: dict = {}   # config_digest -> RunManifest
        #: incremental view of the journal's tombstones, polled after
        #: each successful claim (`_claim_unsettled`): O(new rows) a
        #: claim, not a parse of the whole journal.  Workers never
        #: compact the journal; a compaction by a quiescent front tier
        #: re-parses once and only drops rows already in the set.
        self._journal_tail = jsonl.TailReader(self.journal.path,
                                              label="journal")
        self._tombstoned: set = set()
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._renewer: threading.Thread | None = None

    # ------------------------------------------------------------- leases

    def _claim(self, rid: str) -> bool:
        ins = self._ins
        t0 = 0.0 if ins is None else ins.now()
        ok = self.leases.claim(rid, self.worker_id)
        if ok:
            with self._mu:
                self._held.add(rid)
                self.counters["claimed"] += 1
            if ins is not None:
                from .instrument import FLEET_CLAIM
                ins.end(FLEET_CLAIM, t0, rid=rid)
        return ok

    def _claim_unsettled(self, rid: str) -> bool:
        """`_claim`, refused (and released) when the entry settled after
        this cycle read the journal.  A holder tombstones an entry
        before it releases the lease, so a claim that only succeeds
        once the holder released sees the tombstone here: a finished
        entry is never run twice, nor its leftover checkpoint adopted.
        (The JAX worker claims on the cycle's journal snapshot alone,
        and may run an entry another worker settled meanwhile a second
        time: bit-identical and deduped in the ledger, but a second
        run.)"""
        if not self._claim(rid):
            return False
        self._tombstoned.update(
            row["rid"] for row in self._journal_tail.poll()
            if row.get("kind") == "tombstone" and row.get("rid"))
        if rid in self._tombstoned:
            self._release(rid)
            return False
        return True

    def _release(self, rid: str):
        self.leases.release(rid, self.worker_id)
        with self._mu:
            self._held.discard(rid)
            self.counters["released"] += 1

    def start_renewal(self):
        """The lease heartbeat: a daemon thread re-claims every held
        rid at ttl/3 so a HEALTHY worker's long launch (first-chunk
        compile!) never loses its work mid-flight — only a dead
        worker's leases expire."""
        if self._renewer is not None:
            return
        period = max(0.05, self.lease_ttl_s / 3.0)

        def loop():
            ins = self._ins
            while not self._stop.wait(period):
                with self._mu:
                    held = list(self._held)
                t0 = 0.0 if ins is None else ins.now()
                renewed = 0
                for rid in held:
                    try:
                        self.leases.claim(rid, self.worker_id)
                        renewed += 1
                    except OSError as e:
                        print(f"fleet[{self.worker_id}]: lease renewal "
                              f"failed for {rid} ({e}); the lease may "
                              "expire and be reclaimed",
                              file=sys.stderr)
                if renewed:
                    with self._mu:
                        self.counters["renewed"] += renewed
                    if ins is not None:
                        from .instrument import FLEET_RENEW
                        ins.end(FLEET_RENEW, t0, renewed=renewed)

        self._renewer = threading.Thread(
            target=loop, daemon=True,
            name=f"fleet-renew-{self.worker_id}")
        self._renewer.start()

    def stop(self):
        self._stop.set()
        if self._renewer is not None:
            self._renewer.join(timeout=2.0)
            self._renewer = None

    # -------------------------------------------------------------- steps

    def _adopt_checkpoints(self, live_rids: set) -> list:
        """Lease-gated checkpoint adoption: resume any group file —
        this worker's own (its restart) or a dead worker's — whose
        EVERY request is journal-live, not already running here, and
        claimable.  A live worker's file never passes (its renewal
        keeps the leases held), so adoption can't fork a running
        request's identity.  Adopted foreign files are deleted: the
        state now lives in this scheduler, which re-checkpoints under
        its own worker-prefixed filename at the next boundary (a crash
        before then replays from the journal — redo beats lose)."""
        adopted_foreign: list = []
        adoptions: list = []            # (from_worker, [rids])

        def accept(path, meta) -> bool:
            rids = [rm["id"] for rm in meta.get("requests", ())]
            if not rids:
                return False
            for rid in rids:
                if rid not in live_rids \
                        or self.sched.peek(rid) is not None:
                    return False
            got = []
            for rid in rids:
                if self._claim_unsettled(rid):
                    got.append(rid)
                else:
                    for c in got:       # all-or-nothing: a group file
                        self._release(c)   # restores as one batch
                    return False
            with self._mu:
                self.counters["adopted_checkpoints"] += 1
            adoptions.append((meta.get("worker"), rids))
            if meta.get("worker") != self.worker_id:
                adopted_foreign.append(path)
            return True

        rids = self.sched.resume_checkpoints(accept=accept)
        if self._ins is not None and adoptions:
            # the survivor's side of a reclaim: one mark per adopted
            # request, naming the worker whose lease lapsed — a crash
            # postmortem joins these to the dead worker's span log by
            # rid
            from .instrument import FLEET_ADOPT_CKPT
            for fw, group in adoptions:
                for rid in group:
                    attrs = {"rid": rid}
                    if fw is not None:
                        attrs["from_worker"] = fw
                    self._ins.mark(FLEET_ADOPT_CKPT, **attrs)
        for path in adopted_foreign:
            with contextlib.suppress(OSError):
                os.remove(path)
        return rids

    def _entry_keys(self, e) -> tuple:
        """``(digest, compile_key)`` of a journal entry's spec, cached
        per rid (digesting every live entry once per poll cycle would
        be quadratic over a campaign) — ``(None, None)`` for a spec
        that no longer parses (adopt_journal_entry skips those
        loudly)."""
        rid = e.get("rid")
        hit = self._keys.get(rid)
        if hit is not None:
            return hit
        try:
            spec = ScenarioSpec.from_json(e["spec"])
            # the AS-SUBMITTED digest (what ledger rows' config_digest
            # records); the compile key needs the resolved spec
            out = (spec.digest(), spec.validate().compile_key())
        except (KeyError, ValueError, TypeError) as ex:
            # cached below, so this shouts once per rid, not per poll
            print(f"fleet[{self.worker_id}]: journal entry {rid!r} "
                  f"spec no longer parses ({type(ex).__name__}: "
                  f"{ex!s:.120}); dedup/affinity skip it — "
                  "adopt_journal_entry will record the refusal",
                  file=sys.stderr)
            out = (None, None)
        if rid is not None:
            self._keys[rid] = out
            if len(self._keys) > 4096:      # drop settled entries' keys
                live = {x.get("rid") for x in self.journal.replay()}
                self._keys = {r: v for r, v in self._keys.items()
                              if r in live}
        return out

    def _entry_fork(self, e):
        """Resolve a probe entry's ``memo_fork`` instruction (written
        by the search, matrix/search.py) against the shared
        memo table: a HIT returns a `ForkState` so the adopted request
        skips the prefix chunks another worker (or the search) already
        simulated; a MISS — or any defect in the instruction — returns
        None and the probe runs its full span, bit-identical by the
        memo contract.  Counter writes go through `_mu` (renewal /
        stats threads read them)."""
        ex = e.get("ledger_extra") or {}
        mf = ex.get("memo_fork")
        if mf is None or self.table is None:
            return None
        try:
            pspec = ScenarioSpec.from_json(mf["prefix_spec"])
            fork_ms = int(mf["fork_ms"])
        except (KeyError, ValueError, TypeError) as err:
            print(f"fleet[{self.worker_id}]: entry {e.get('rid')!r} "
                  f"memo_fork instruction unusable "
                  f"({type(err).__name__}: {err!s:.120}); running the "
                  "full span unforked", file=sys.stderr)
            return None
        hit = self.table.get(pspec, device=self.sched.device)
        if hit is None:
            with self._mu:
                self.counters["memo_table_misses"] += 1
            return None
        state, carries = hit
        try:
            rspec = ScenarioSpec.from_json(e["spec"]).validate()
        except (KeyError, ValueError, TypeError) as err:
            print(f"fleet[{self.worker_id}]: entry {e.get('rid')!r} "
                  f"spec unparseable at fork time ({err!s:.120}); "
                  "adopt_journal_entry will record the refusal",
                  file=sys.stderr)
            return None
        # belt and braces: the search veto-checked the same state bits
        # before writing the instruction, but the chaos gate is cheap
        # and a veto here only costs re-simulation, never correctness
        from ..memo import chaos_noop_before_fork
        if not chaos_noop_before_fork(rspec, state, fork_ms):
            return None
        with self._mu:
            self.counters["memo_table_hits"] += 1
            self.counters["prefix_chunks_saved"] += \
                int(fork_ms) // rspec.chunk_ms
        from .scheduler import ForkState
        return ForkState(state=state,
                         carries={p: list(cs)
                                  for p, cs in carries.items()},
                         at_ms=int(fork_ms),
                         prefix_digest=mf.get("prefix_digest"))

    def step(self) -> dict:
        """One poll cycle: read the journal's live entries, adopt every
        checkpoint and entry this worker can lease (dedup'ing against
        the shared ledger first), drain, then release settled leases.

        Claim AFFINITY: entries whose compile key is already warm in
        THIS worker's registry are claimed freely; entries needing a
        fresh build are rationed to ONE new compile key per step (the
        others stay unleased for the rest of the fleet this cycle).
        Compile keys therefore specialize across a fleet — with N
        workers and K keys each program is built ~once fleet-wide, so
        requests-per-build tracks the single-process number instead of
        dividing by N — while a lone worker still drains everything
        (its budget resets every step).  Returns the cycle's
        counters."""
        entries = self.journal.replay()
        live_rids = {e.get("rid") for e in entries}
        adopted = len(self._adopt_checkpoints(live_rids))
        entries.sort(key=lambda e: 0 if (
            (ck := self._entry_keys(e)[1]) is not None
            and self.sched.registry.has_key(ck)) else 1)
        if self.dedup:
            for raw in self._ledger_tail.poll():
                row = _clean_row(raw)
                if row is not None:
                    self._ledger_clean.setdefault(row.config_digest,
                                                  row)
        by_digest = self._ledger_clean if self.dedup else {}
        cold_taken: set = set()
        for e in entries:
            rid = e.get("rid")
            if not rid or self.sched.peek(rid) is not None:
                continue
            dig, ck = self._entry_keys(e)
            if by_digest and dig is not None and dig in by_digest:
                # cross-worker dedup (the ledger join): the clean row
                # IS the result, bit-identical by determinism —
                # settle the entry without running it.  Claim
                # first so two workers can't race the tombstone.
                # Dedup consumes no build, so no affinity budget.
                if self._claim(rid):
                    self.journal.record_settled(rid, "done")
                    self._release(rid)
                    with self._mu:
                        self.counters["deduped"] += 1
                continue
            fresh_key = (ck is not None
                         and not self.sched.registry.has_key(ck)
                         and ck not in cold_taken)
            if fresh_key and cold_taken:
                continue        # second fresh key this step: leave it
            if not self._claim_unsettled(rid):
                continue        # another worker's (live) lease — a
                # REFUSED claim costs no budget, so losing the race
                # for one cold key never starves this step's next one
            if fresh_key:
                cold_taken.add(ck)
            # the search handoff (matrix/search.py): a
            # ``memo_prefix`` entry keeps its carries so its final
            # state is table-publishable on settle; a ``memo_fork``
            # instruction resolves against the shared table so the
            # probe enters mid-run when another worker already ran
            # its prefix
            ex = e.get("ledger_extra") or {}
            keep = bool(ex.get("memo_prefix")) and self.table is not None
            fork = self._entry_fork(e)
            if self.sched.adopt_journal_entry(e, fork=fork,
                                              keep_carries=keep) is None:
                self._release(rid)
                continue
            if (e.get("label") or "").startswith("search:"):
                with self._mu:
                    self.counters["search_probes_total"] += 1
            if self._ins is not None:
                from .instrument import FLEET_ADOPT_JOURNAL
                self._ins.mark(FLEET_ADOPT_JOURNAL, rid=rid)
            adopted += 1
        processed = self.sched.run_pending()["processed"] if adopted \
            or self.sched.health_stats()["queued"] else 0
        with self._mu:
            held = list(self._held)
            self.counters["processed"] += processed
            self.counters["steps"] += 1
        for rid in held:
            req = self.sched.peek(rid)
            if req is None or req.status in ("done", "error"):
                # done/quarantined entries are journal-tombstoned by
                # _finalize; a transient group error's entry stays
                # live, and releasing lets ANY worker (us included)
                # retry it — the crash-only redo contract.  A finished
                # memo prefix is already in the table (`_on_settle` ran
                # before its ledger row and tombstone)
                self._release(rid)
        return {"adopted": adopted, "processed": processed}

    def _on_settle(self, req, final_state, carries):
        """The scheduler's `settle_hook`, called before a finished
        request's ledger row and journal tombstone.  Once either is on
        disk, a search may count the request done and read the fleet's
        stats, or enqueue probes that fork from it which any worker may
        adopt; so first, a finished ``memo_prefix`` request's state and
        carries go into the shared table, and then this worker's stats
        snapshot (whose table counters already count the request: they
        move at adoption).  The table entry is keyed on the AS-SUBMITTED
        spec: `MemoTable.key` digests it, and the search looks prefixes
        up by the spec it journaled, not the resolved one.
        `MemoTable.put` never raises; a failed stats write is a stderr
        note (the next cycle's snapshot replaces it)."""
        if self.table is not None \
                and (req.ledger_extra or {}).get("memo_prefix"):
            self.table.put(req.requested or req.spec, final_state,
                           carries)
        if self.digest_path is not None:
            from .. import convert
            jsonl.append_line(self.digest_path, {
                "rid": req.id, "worker": self.worker_id,
                "spec_digest": (req.requested or req.spec).digest(),
                "seeds": list(req.spec.seeds),
                "digests": convert.seed_digests(
                    *convert.to_numpy(*final_state))}, fsync=True)
        try:
            self.write_stats()
        except OSError as e:
            print(f"fleet[{self.worker_id}]: stats snapshot at settle "
                  f"failed ({e}); the next cycle writes it",
                  file=sys.stderr)

    # ------------------------------------------------------------- stats

    def write_stats(self) -> str:
        """Atomically publish this worker's counters + health block
        (write-temp + fsync + os.replace — a reader aggregating a
        fleet's stats never sees a half-written file, even if this
        worker is SIGKILLed mid-write)."""
        os.makedirs(self.paths["stats_dir"], exist_ok=True)
        path = os.path.join(self.paths["stats_dir"],
                            f"worker-{self.worker_id}.json")
        with self._mu:
            body = {"worker": self.worker_id, **self.counters}
        body["registry"] = self.sched.registry.stats()
        body["kernels"] = kernel_stats()
        body["health"] = self.sched.health_stats()
        with self.sched._mu:
            body["resilience"] = dict(self.sched.resilience)
        if self._ins is not None:
            from .instrument import (refresh_fleet_counters,
                                     refresh_scheduler_metrics,
                                     refresh_search_counters)
            refresh_scheduler_metrics(self._ins.metrics, self.sched)
            refresh_fleet_counters(self._ins.metrics, body)
            refresh_search_counters(self._ins.metrics, body)
            body["host_metrics"] = self._ins.metrics.snapshot()
            body["spans"] = self._ins.spans.stats()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(body, f, sort_keys=True, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    # --------------------------------------------------------------- run

    def run(self, *, poll_s: float = 0.25, idle_exit_s=None,
            max_wall_s=None) -> dict:
        """The worker main loop: step until idle (journal fully
        settled AND nothing held) for `idle_exit_s` seconds, or
        `max_wall_s` elapses, or `stop()`.  Publishes a stats snapshot
        every cycle so an aggregator can read a LIVE fleet."""
        self.start_renewal()
        t0 = time.time()
        idle_since = None
        try:
            while not self._stop.is_set():
                c = self.step()
                self.write_stats()
                now = time.time()
                if max_wall_s is not None and now - t0 >= max_wall_s:
                    break
                worked = c["adopted"] or c["processed"]
                if worked:
                    idle_since = None
                    continue
                if self.journal.lag() > 0:
                    # entries remain but another worker's live lease
                    # covers them: poll (don't exit — its crash would
                    # make them ours), but never hot-spin against the
                    # worker actually running them
                    idle_since = None
                    time.sleep(poll_s)
                    continue
                idle_since = idle_since if idle_since is not None \
                    else now
                if idle_exit_s is not None \
                        and now - idle_since >= idle_exit_s:
                    break
                time.sleep(poll_s)
        finally:
            self.stop()
            self.write_stats()
        with self._mu:
            return dict(self.counters)


# ------------------------------------------------------------ subprocess

def spawn_worker(fleet_dir, worker_id: str, *, lease_ttl_s: float = 10.0,
                 idle_exit_s: float | None = 3.0, max_wall_s=None,
                 poll_s: float = 0.25, dedup: bool = True, env=None,
                 timeline=None, memo_table=None, device=None,
                 state_digests=None):
    """Launch one fleet worker subprocess (the shared helper behind
    `run_grid(workers=N)` and `run_search(workers=N)`).  stdout/stderr
    go to ``worker-<id>.log`` in the fleet
    dir; the returned Popen carries ``log_path``.  `timeline` (a
    directory) turns span recording ON in the child — it appends
    ``spans-<worker>.jsonl`` there, durable line-by-line, so a
    SIGKILLed worker still leaves its timeline behind.  `memo_table`
    (a directory) opens the shared cross-run memo table in the child;
    `idle_exit_s=None` runs the worker until max-wall or signal (the
    a search's mode — probes arrive in rounds with idle gaps
    between them).  `device` is the child's ``--device`` (``cuda``
    unless given); `state_digests` (a directory) its
    ``--state-digests`` (`FleetWorker`'s `digest_dir`: the checks'
    observation seam, off for campaigns)."""
    import subprocess
    paths = fleet_paths(fleet_dir)
    os.makedirs(paths["dir"], exist_ok=True)
    cmd = [sys.executable, "-m", "wittgenstein_tpu_torch.serve.fleet",
           "--dir", paths["dir"], "--worker-id", str(worker_id),
           "--ttl", str(lease_ttl_s), "--poll", str(poll_s)]
    if idle_exit_s is not None:
        cmd += ["--idle-exit", str(idle_exit_s)]
    if max_wall_s is not None:
        cmd += ["--max-wall", str(max_wall_s)]
    if not dedup:
        cmd += ["--no-dedup"]
    if timeline is not None:
        cmd += ["--timeline", str(timeline)]
    if memo_table is not None:
        cmd += ["--memo-table", str(memo_table)]
    if device is not None:
        cmd += ["--device", str(device)]
    if state_digests is not None:
        cmd += ["--state-digests", str(state_digests)]
    log_path = os.path.join(paths["dir"], f"worker-{worker_id}.log")
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                cwd=root, env=env or os.environ.copy())
    proc.log_path = log_path
    return proc


def main(argv=None) -> int:
    t_main = time.time()
    ap = argparse.ArgumentParser(
        prog="python -m wittgenstein_tpu_torch.serve.fleet",
        description="Run one fleet worker over a shared fleet "
                    "directory (module docstring).")
    ap.add_argument("--dir", required=True, metavar="DIR",
                    help="the shared fleet directory (fleet_paths)")
    ap.add_argument("--worker-id", required=True, metavar="ID",
                    help="this worker's identity ([A-Za-z0-9_]; used "
                         "as the rid/checkpoint/lease prefix)")
    ap.add_argument("--ttl", type=float, default=10.0, metavar="S",
                    help="lease ttl seconds (renewal runs at ttl/3)")
    ap.add_argument("--idle-exit", type=float, default=None,
                    metavar="S", help="exit after this long with the "
                    "journal fully settled (default: run forever)")
    ap.add_argument("--max-wall", type=float, default=None,
                    metavar="S", help="hard wall-clock bound")
    ap.add_argument("--poll", type=float, default=0.25, metavar="S",
                    help="idle poll interval")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable the ledger dedup join (every entry "
                         "re-runs even if a clean row exists)")
    ap.add_argument("--timeline", default=None, metavar="DIR",
                    help="record host lifecycle spans to "
                         "DIR/spans-<worker>.jsonl (durable per line)")
    ap.add_argument("--memo-table", default=None, metavar="DIR",
                    help="shared cross-run memo table directory: "
                         "publish finished memo prefixes there and "
                         "resolve search probes' memo_fork "
                         "instructions against it")
    ap.add_argument("--catalog", action="store_true",
                    help="record the program observatory catalog to "
                         "<dir>/programs-<worker>.jsonl (first-launch "
                         "walls, working sets, kernel launches; report "
                         "with python -m wittgenstein_tpu_torch.cli."
                         "programs or GET /w/batch/programs on the "
                         "front tier)")
    ap.add_argument("--device", default=None,
                    help="the device the worker's scheduler runs on "
                         "(default: cuda; 'cpu' runs the plain PyTorch "
                         "versions)")
    ap.add_argument("--state-digests", default=None, metavar="DIR",
                    help="for checks against golden digests: append each "
                         "finished request's per-seed state digests to "
                         "DIR/digests-<worker>.jsonl (a copy of the state "
                         "to the host per request; off for campaigns)")
    args = ap.parse_args(argv)
    # the protocol registry fills as the models import (server/core.py's
    # load_models, as server/http.py's main does)
    from ..core.state import resolve_device
    from ..server.core import load_models
    load_models()
    dev = resolve_device(args.device)
    t0 = time.time()
    if dev.type == "cuda":
        import torch
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    ins = None
    if args.timeline:
        from .instrument import Instrumentation
        os.makedirs(args.timeline, exist_ok=True)
        ins = Instrumentation(
            span_path=os.path.join(args.timeline,
                                   f"spans-{args.worker_id}.jsonl"),
            worker=args.worker_id)
    sched_kw = None
    if args.catalog:
        from ..obs.programs import ProgramCatalog
        sched_kw = {"catalog": ProgramCatalog(
            path=os.path.join(args.dir,
                              f"programs-{args.worker_id}.jsonl"),
            metrics=ins.metrics if ins is not None else None)}
    w = FleetWorker(args.dir, args.worker_id, lease_ttl_s=args.ttl,
                    dedup=not args.no_dedup, instrument=ins,
                    memo_table=args.memo_table, device=dev,
                    digest_dir=args.state_digests, scheduler_kw=sched_kw)
    # the start-up walls (module import to here, and the device's own
    # initialisation) on a line of their own: a parent reads them from
    # the worker's log even when the worker is killed later
    print(json.dumps({"worker": args.worker_id, "device": str(dev),
                      "ready_unix": time.time(),
                      "startup_s": round(time.time() - t_main, 3),
                      "device_init_s": round(time.time() - t0, 3)},
                     sort_keys=True), flush=True)
    counters = w.run(poll_s=args.poll, idle_exit_s=args.idle_exit,
                     max_wall_s=args.max_wall)
    print(json.dumps({"worker": args.worker_id, **counters,
                      "kernels": kernel_stats()}, sort_keys=True),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
