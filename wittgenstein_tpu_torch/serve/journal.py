"""Durable submission journal — the serve plane's write-ahead log.

The group-checkpoint machinery makes a RUNNING group survivable: a
kill mid-chunk resumes from the last chunk boundary.  What it cannot
cover is the window this module exists for — a request that was
ACCEPTED but had not launched when the process died.  Its spec lived
only in the scheduler's in-memory queue, so the client holds an ack
for work that no longer exists anywhere.

`SubmissionJournal` closes that window with the classic WAL shape:

  * `record_submit` appends the accepted request (canonical spec JSON
    + rid + label/ledger_extra — everything `Scheduler.submit` was
    handed) to an append-only JSONL file and fsyncs BEFORE the submit
    acks.  An ack therefore implies a durable record; a journal write
    failure fails the submit loudly instead of promising durability
    the disk refused.
  * `record_settled` appends a tombstone when the request COMPLETES
    (done), is QUARANTINED (a deterministic poison verdict — re-running
    it would only re-quarantine) or is WITHDRAWN.  A generic group
    error is deliberately NOT tombstoned: it is presumed transient
    (dead device), and the crash-only contract is redo-beats-lose —
    those entries replay on the next recovery.  Tombstones are appends
    too — the journal is never edited in place, so a crash at ANY byte
    offset leaves at worst one torn tail line.
  * `replay` returns the un-tombstoned submit entries in submission
    order, reading through the shared torn-tail-tolerant JSONL reader
    (utils/jsonl.py): a line torn by the kill is skipped with a loud
    stderr note (one in-flight row, already un-acked), never raised.
  * `compact` atomically rewrites the file down to the live entries —
    `Scheduler.resume_journal` runs it after a replay so the journal's
    size tracks the live queue, not the service's lifetime.

The journal stores SPECS, not states: a replayed request re-runs from
scratch (bit-identical — the engine is a deterministic pure function
of the spec), and a request that ALSO left a group checkpoint resumes
from the checkpoint instead (`Scheduler.recover` orders the two).  A
memo snapshot-fork submission is journaled as its plain full-span
spec: the fork state died with the process, and an unforked re-run is
bit-identical by the fork contract — the fork provenance is dropped
on replay so the re-run's ledger row never claims a fork it didn't
take.

The port's own copy of `wittgenstein_tpu/serve/journal.py`, which has no JAX in it: the port imports nothing of the JAX package, so it keeps this module line for line (the spans, exposition text, journal rows and ledger rows are byte for byte the JAX package's).
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import jsonl

#: journal entry schema (bump on field changes; replay keys on it)
SCHEMA = 1

#: the journal file inside `journal_dir` (one per scheduler)
FILENAME = "submissions.jsonl"

#: lease claim schema (bump on field changes; `LeaseTable` keys on it)
LEASE_SCHEMA = 1

#: the fleet lease file inside a SHARED journal dir — claim tombstones
#: that partition the journal's live entries across worker processes
LEASE_FILENAME = "leases.jsonl"


class SubmissionJournal:
    """One scheduler's WAL (module docstring)."""

    #: lock inventory (analysis rule ``host_locks``): `_mu` guards the
    #: FILE, not attributes — every append/replay/compact serializes
    #: on it inside the methods below; no self attribute is mutated
    #: after __init__, so the owned set is empty by design.
    _LOCK_OWNS: dict = {"_mu": ()}

    def __init__(self, journal_dir):
        self.dir = str(journal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, FILENAME)
        #: one lock serializes every file operation (append, replay,
        #: compact): a reader can never observe a half-written line
        #: from a concurrent in-process append (no false torn-tail
        #: warnings from `lag()` health polls), and compaction can
        #: never rewrite the file from a stale snapshot and erase a
        #: row appended since — the journal is per-scheduler, so
        #: in-process exclusion is the whole story
        self._mu = threading.Lock()

    # ------------------------------------------------------------ appends

    def record_submit(self, rid: str, spec, label=None,
                      ledger_extra=None) -> None:
        """Durably record one accepted submission (fsync'd — this runs
        BEFORE the submit acks).  Raises OSError through: the caller
        must not ack a request the journal could not hold."""
        with self._mu:
            jsonl.append_line(self.path, {
                "schema": SCHEMA, "kind": "submit", "rid": rid,
                "spec": spec.to_json(), "label": label,
                "ledger_extra": dict(ledger_extra) if ledger_extra
                else None,
                "ts_unix": time.time()}, fsync=True)

    def record_settled(self, rid: str, status: str) -> None:
        """Tombstone a settled request (done/quarantined/withdrawn —
        module docstring; transient group errors stay replayable).
        Never raises — a tombstone lost to a full disk costs one
        redundant (bit-identical) re-run on the next replay, which is
        the crash-only trade: redo beats lose."""
        import sys
        try:
            with self._mu:
                jsonl.append_line(self.path, {
                    "schema": SCHEMA, "kind": "tombstone", "rid": rid,
                    "status": status, "ts_unix": time.time()})
        except OSError as e:
            print(f"journal: tombstone append failed for {rid} ({e}); "
                  "the entry replays once more on the next resume",
                  file=sys.stderr)

    # ------------------------------------------------------------- replay

    def _replay_locked(self) -> list:
        live: dict = {}
        for _, row in jsonl.iter_lines(self.path, label="journal"):
            kind, rid = row.get("kind"), row.get("rid")
            if not rid:
                continue
            if kind == "submit" and row.get("schema") == SCHEMA:
                live.setdefault(rid, row)
            elif kind == "tombstone":
                live.pop(rid, None)
        return list(live.values())

    def replay(self) -> list:
        """The un-tombstoned submit entries, in submission order (the
        crash's survivors).  Torn/malformed lines are skipped loudly by
        the shared reader; a tombstone whose submit line is missing
        (or torn) is simply inert."""
        with self._mu:
            return self._replay_locked()

    def lag(self) -> int:
        """Entries accepted but not yet tombstoned — the health
        endpoint's "journal lag" number (0 = every acked request has
        settled)."""
        return len(self.replay())

    def settled(self) -> dict:
        """rid -> final tombstone status for every settled entry —
        the fleet front tier's status join (done / quarantined /
        withdrawn; compaction eventually drops these rows, at which
        point the ledger row is the durable record)."""
        with self._mu:
            out = {}
            for _, row in jsonl.iter_lines(self.path, label="journal"):
                if row.get("kind") == "tombstone" and row.get("rid"):
                    out[row["rid"]] = row.get("status")
            return out

    def lookup(self, rid: str) -> dict | None:
        """The submit row for `rid` (live OR settled), or None — the
        front tier's result join needs a settled entry's spec to find
        its ledger row by digest."""
        with self._mu:
            for _, row in jsonl.iter_lines(self.path, label="journal"):
                if row.get("kind") == "submit" and row.get("rid") == rid:
                    return row
        return None

    def compact(self) -> None:
        """Atomically rewrite the journal down to its CURRENT live
        entries — recomputed under the lock at rewrite time, so a
        submit or tombstone appended after an earlier `replay()`
        snapshot can never be erased (the fsync-before-ack promise
        survives compaction on a live scheduler).  Crash-safe via
        write-temp + os.replace; a failure leaves the uncompacted
        (still correct) file."""
        import sys
        try:
            with self._mu:
                jsonl.rewrite(self.path, self._replay_locked())
        except OSError as e:
            print(f"journal: compaction failed ({e}); the uncompacted "
                  "journal remains valid", file=sys.stderr)


class LeaseTable:
    """Append-only work-claim table for a fleet of worker processes
    sharing ONE journal directory.

    The journal says what work exists; the lease table says who is
    running it.  A claim is one fsync'd JSONL row (`kind: "claim"`,
    worker id + absolute deadline) — never an edit, so the file has
    the same crash story as the journal: at worst one torn tail line,
    skipped loudly by the shared reader.  The protocol:

      * A worker may append a claim only when no OTHER worker holds a
        live (unexpired, unreleased) claim on the rid — the common
        contention case refuses WITHOUT writing.
      * Two workers that append before seeing each other (the genuine
        race window on a shared file; in-process `_mu` cannot cover a
        second process) both re-read after their fsync and the
        lexicographically SMALLEST worker id holds — deterministic,
        no second append, the loser simply backs off and its row ages
        out at its deadline.
      * Renewal is re-claiming: a holder (or a worker whose lease
        expired un-stolen) appends a fresh row with a new deadline.
        A worker whose expired lease was validly reclaimed by someone
        else gets a refusal — it must NOT resurrect the lease.
      * Expiry is the crash-recovery signal: a dead worker stops
        renewing, its deadlines pass, and any survivor reclaims the
        rid and runs the journal replay path on it.
      * `release` appends a `kind: "release"` row at settle time so
        the rid frees immediately instead of waiting out the ttl.

    Claim and release rows are fsync'd: a claim that is not on the
    platter is a claim another worker may legitimately double-run
    after a crash (wasted, but bit-identical — the ledger join dedups
    it), and the fsync keeps that window out of the common path.
    """

    #: lock inventory (analysis rule ``host_locks``): like the
    #: journal, `_mu` guards the FILE — no attribute is mutated after
    #: __init__, so the owned set is empty by design.
    _LOCK_OWNS: dict = {"_mu": ()}

    def __init__(self, journal_dir, *, ttl_s: float = 10.0):
        self.dir = str(journal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, LEASE_FILENAME)
        self.ttl_s = float(ttl_s)
        self._mu = threading.Lock()

    # ---------------------------------------------------------- read side

    def _live_locked(self, now: float) -> dict:
        """rid -> {worker: latest live claim row}.  A release pops the
        worker's standing claim (a later re-claim re-adds it — row
        order is the truth); expired deadlines filter out at the
        end so history stays append-only."""
        claims: dict = {}
        for _, row in jsonl.iter_lines(self.path, label="leases"):
            rid, w = row.get("rid"), row.get("worker")
            if not rid or not w:
                continue
            kind = row.get("kind")
            if kind == "claim" and row.get("schema") == LEASE_SCHEMA:
                claims.setdefault(rid, {})[w] = row
            elif kind == "release":
                claims.get(rid, {}).pop(w, None)
        live = {}
        for rid, per in claims.items():
            per = {w: r for w, r in per.items()
                   if r.get("deadline_unix", 0) > now}
            if per:
                live[rid] = per
        return live

    @staticmethod
    def _holder_of(per: dict):
        """The deterministic winner among live claimants: the
        lexicographically smallest worker id (module docstring)."""
        return min(per) if per else None

    def holder(self, rid: str, now=None):
        """The worker currently holding `rid`, or None."""
        now = time.time() if now is None else now
        with self._mu:
            return self._holder_of(self._live_locked(now).get(rid, {}))

    def live(self, now=None) -> dict:
        """rid -> holding worker id for every live claim — the fleet
        health endpoint's lease table."""
        now = time.time() if now is None else now
        with self._mu:
            return {rid: self._holder_of(per)
                    for rid, per in self._live_locked(now).items()}

    def workers(self, now=None) -> dict:
        """worker -> sorted list of held rids (health aggregation)."""
        out: dict = {}
        for rid, w in self.live(now).items():
            out.setdefault(w, []).append(rid)
        return {w: sorted(rids) for w, rids in sorted(out.items())}

    # --------------------------------------------------------- write side

    def claim(self, rid: str, worker: str, now=None) -> bool:
        """Try to claim (or renew) `rid` for `worker`.  Returns True
        iff `worker` holds the lease after this call.  Refuses without
        appending when another worker's live claim exists; otherwise
        appends an fsync'd claim row and re-reads — the lexicographic
        rule decides the cross-process race deterministically.  Raises
        OSError through: a worker must not run work whose claim the
        disk refused to hold."""
        now = time.time() if now is None else now
        with self._mu:
            per = self._live_locked(now).get(rid, {})
            if any(w != worker for w in per):
                return False
            jsonl.append_line(self.path, {
                "schema": LEASE_SCHEMA, "kind": "claim", "rid": rid,
                "worker": worker, "deadline_unix": now + self.ttl_s,
                "ts_unix": now}, fsync=True)
            per = self._live_locked(now).get(rid, {})
            return self._holder_of(per) == worker

    def release(self, rid: str, worker: str) -> None:
        """Free `rid` at settle time (fsync'd release row).  Never
        raises — a release lost to a full disk costs only the lease
        aging out at its deadline (redo beats lose, again)."""
        import sys
        try:
            with self._mu:
                jsonl.append_line(self.path, {
                    "schema": LEASE_SCHEMA, "kind": "release",
                    "rid": rid, "worker": worker,
                    "ts_unix": time.time()}, fsync=True)
        except OSError as e:
            print(f"leases: release append failed for {rid} ({e}); "
                  "the lease frees at its deadline instead",
                  file=sys.stderr)

    def compact(self) -> None:
        """Atomically rewrite the file down to the rows backing LIVE
        claims (released/expired/superseded history drops; every
        current holder survives — recomputed under the lock at rewrite
        time).  A failure leaves the uncompacted, still-correct
        file."""
        import sys
        try:
            with self._mu:
                live = self._live_locked(time.time())
                rows = [r for per in live.values() for r in per.values()]
                rows.sort(key=lambda r: (r.get("ts_unix", 0),
                                         str(r.get("rid")),
                                         str(r.get("worker"))))
                jsonl.rewrite(self.path, rows)
        except OSError as e:
            print(f"leases: compaction failed ({e}); the uncompacted "
                  "lease file remains valid", file=sys.stderr)
