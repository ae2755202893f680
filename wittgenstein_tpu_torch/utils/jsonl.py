"""Shared JSONL append/read — the crash-safe append-only-log idiom.

Every append-only JSONL file in the tree (the run ledger, the serve
plane's durable submission journal) has the same two failure modes
under a hard kill: a line torn mid-write at the tail, and a reader
that raises on it and takes the whole log down with it.  This module
is the ONE place both sides live, so "append" and "tolerate a torn
tail" can never mean two different things in two files:

  `append_line`  — serialize + write + flush (and optionally fsync)
      one line under an exclusive append.  The write is a single
      `f.write` of the full line, so on POSIX a crash leaves either
      the whole line or a torn TAIL — never an interleaved middle —
      which is exactly what `iter_lines` is built to skip.
  `iter_lines`   — yield parsed rows, skipping blank lines and
      malformed rows with a stderr note.  A torn FINAL line (the
      kill-mid-append signature) is reported as such; a malformed
      interior row (hand edits, disk rot) is skipped row-by-row so
      one bad line never hides the rest of the log.

Readers that need a list use `read_lines`.  Neither reader raises on
content problems — an append-only log's job is to survive the crash
that wrote it.

This module is the sanctioned write path the `host_durability`
analysis rule points everyone else at (and its one EXEMPT_FILES
entry): raw `open(..., "w")`/`json.dump` on a journal/ledger/
checkpoint path anywhere else in the host plane is a budgeted error —
route it through `append_line`/`rewrite` here, or the write-temp +
fsync + `os.replace` idiom (`MatrixReport.save`).

The port's own copy of `wittgenstein_tpu/utils/jsonl.py`, which has no JAX in it: the port imports nothing of the JAX package, so it keeps this module line for line (the spans, exposition text, journal rows and ledger rows are byte for byte the JAX package's).
"""

from __future__ import annotations

import json
import os
import pathlib
import sys


def append_line(path, obj, fsync: bool = False) -> str:
    """Append one JSON row to `path` (parent dirs created), flush, and
    optionally fsync (the durable-ack case: a submission journal must
    hit the platter BEFORE the submit acks, or a crash loses a request
    the client believes accepted).  Raises OSError on failure — the
    caller decides whether the log is provenance (swallow, stderr) or
    a durability promise (propagate).  Returns the path written."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    line = json.dumps(obj, sort_keys=True, default=str) + "\n"
    with open(p, "a") as f:
        f.write(line)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return str(p)


def iter_lines(path, label: str = "jsonl"):
    """Yield ``(index, row)`` for every parseable row of `path`
    (missing file = empty).  Malformed rows are skipped with a stderr
    note; the FINAL line additionally names the torn-tail case so an
    operator reading the log after a crash knows the loss was one
    in-flight append, not corruption."""
    p = pathlib.Path(path)
    if not p.exists():
        return
    with open(p) as f:
        lines = f.readlines()
    last = len(lines) - 1
    for i, raw in enumerate(lines):
        raw = raw.strip()
        if not raw:
            continue
        try:
            yield i, json.loads(raw)
        except json.JSONDecodeError as e:
            if i == last:
                print(f"{label}: skipping torn final line {i} of {p} "
                      f"(crash mid-append; one in-flight row lost): {e}",
                      file=sys.stderr)
            else:
                print(f"{label}: skipping malformed row {i} of {p}: {e}",
                      file=sys.stderr)


def read_lines(path, label: str = "jsonl") -> list:
    """All parseable rows of `path` as a list (`iter_lines` semantics:
    torn tails and malformed rows skipped with a stderr note)."""
    return [row for _, row in iter_lines(path, label=label)]


class TailReader:
    """Incremental reader for a GROWING append-only log: each `poll()`
    parses only the bytes appended since the last poll, so a fleet
    worker re-scanning a shared ledger/journal every cycle pays
    O(new rows), not O(file).

    Two append-only-log realities are handled explicitly:

      * a torn tail (crash mid-append) is NOT consumed — the partial
        line stays buffered until more bytes arrive, and if the line
        never completes it is reported once via `iter_lines` semantics
        on the next full re-read;
      * a file that SHRANK (compaction's atomic `os.replace`) resets
        the reader to offset 0 — compacted history re-parses once,
        which is correct because compaction only ever rewrites a
        subset of rows the reader may already have seen (callers keep
        idempotent accumulators, e.g. dict-by-digest).

    Rows are returned parsed; malformed COMPLETE interior lines are
    skipped with the same stderr note as `iter_lines`."""

    def __init__(self, path, label: str = "jsonl"):
        self.path = str(path)
        self.label = label
        self._offset = 0

    def poll(self) -> list:
        """Parse and return the rows appended since the last poll."""
        p = pathlib.Path(self.path)
        try:
            size = p.stat().st_size
        except OSError:
            self._offset = 0
            return []
        if size < self._offset:        # compaction replaced the file
            self._offset = 0
        if size == self._offset:
            return []
        with open(p, "rb") as f:        # binary: offsets are bytes
            f.seek(self._offset)
            chunk = f.read(size - self._offset)
        # only consume COMPLETE lines; a torn tail stays unconsumed so
        # the in-flight append (or the crash report) happens later
        keep = chunk.rfind(b"\n") + 1
        if keep == 0:
            return []
        self._offset += keep
        rows = []
        for raw in chunk[:keep].splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                rows.append(json.loads(raw.decode()))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                print(f"{self.label}: skipping malformed row of "
                      f"{p}: {e}", file=sys.stderr)
        return rows


def rewrite(path, rows) -> str:
    """Atomically replace `path` with exactly `rows` (write-temp +
    `os.replace`, so a crash mid-rewrite leaves the previous file
    intact) — the journal's compaction primitive."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = str(p) + ".tmp"
    with open(tmp, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True, default=str) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, str(p))
    return str(p)
