"""Program observatory — what the served chunk programs themselves cost;
the port of `wittgenstein_tpu/obs/programs.py`, redefined for the card.

The JAX catalog records, per (compile key, obs plane), the lower and
compile walls of the jitted chunk, XLA's `memory_analysis()` and
`cost_analysis()`, and the TPU route kernel's VMEM cost-model
predictions.  The port has no trace, no lowering and no ahead-of-time
compile, and XLA's analyses and the VMEM models have no twin.  So the
port keeps the durable-row machinery (`ProgramCatalog`, the row
schema, `read_catalog`, `summarize_programs`, the scrape-time
projection) and MEASURES the program on its first launch instead:

  * `CatalogProgram` wraps a registry program.  On its first launch it
    synchronizes the device, reads `torch.cuda.memory_allocated()` and
    resets the peak, launches, synchronizes again and reads
    `max_memory_allocated()` (`CudaMemoryProbe`); every later launch
    passes straight through, with no synchronization;
  * ``lower_wall_s`` is 0.0 (there is no trace) and ``compile_wall_s``
    is the wall of that first, synchronized launch: the port's cold
    cost (the kernel library's load, the allocator's growth, the first
    launch of every op);
  * ``memory`` holds ``argument_bytes`` and ``output_bytes`` (the
    tensor leaves' ``nbytes``), ``alias_bytes`` for output leaves that
    share storage with an argument (the ring and the protocol's
    `IN_PLACE` leaves, which the engine writes in place, and the leaves
    a chunk hands back unchanged), and on the
    card ``temp_bytes``: the peak during the first launch less the
    bytes allocated before it (the outputs the launch allocates
    included), the analogue of XLA's ``temp_size_in_bytes``;
  * ``cost`` holds ``launches``: each kernel's launch count over that
    first chunk, read from the kernel entry points' ``launches``
    attributes (`ops/route.bin_into_ring`, `ops/merge.merge_queue`,
    `ops/score.score_queue` and `gsf_score`, `ops/gsf_merge.gsf_merge`).
    The counters are process-wide, so a kernel launched by another
    thread during that chunk is counted too.

The drift pass becomes a working-set ratio: `drift_rows` reports
``temp_ratio = temp_bytes / argument_bytes``, how many state-sized
copies a program holds live at its peak, in place of the JAX
``vmem_ratio``; `summarize_programs` ranks ``drift_outliers`` on it and
`refresh_catalog_metrics` sets ``wtpu_program_temp_ratio{key,plane}``
in place of ``wtpu_costmodel_drift``.  The readers take a JAX worker's
rows too (they carry ``predicted``, ``lower_wall_s`` and ``flops``); a
row without ``argument_bytes`` or ``temp_bytes`` gets no
``temp_ratio``.  On the CPU the memory block has no ``temp_bytes`` (the
soft degradation of the JAX `_memory_block`); a catalog takes an
injected ``memory_probe=`` beside ``clock=`` for tests.

Hazard, the peak is global: `torch.cuda.reset_peak_memory_stats` resets
the one counter every reader of `max_memory_allocated` shares.  The
probe keeps the peak it found before its reset (``prior_peak_bytes``);
a reader whose span holds a cataloged first launch resets and reads the
peak through the probe (`CudaMemoryProbe.reset_peak`, `peak`), which
raises that earlier peak back into the reading, as `chip_smoke.py`'s
phases V and M do.

Hazard, concurrent first launches: a watchdog-abandoned launch thread
may still be inside the wrapper when its retry enters.  As in the JAX
design the capture state is one atomically assigned attribute, and
`ProgramCatalog.record_program` dedupes the row per (key, plane) under
its lock; the first capture to finish writes the row.

OFF costs nothing: the registry and the scheduler hold ``catalog=None``
by default and this module is then never imported.  Every row goes
through `utils/jsonl.append_line` with fsync, so a SIGKILL mid-append
leaves at most one torn tail, which `read_catalog` skips.
"""

from __future__ import annotations

import sys
import threading
import time

from torch.utils import _pytree as pytree

from ..utils import jsonl

#: catalog-row schema (bump on field changes)
SCHEMA = 1


def launch_counts() -> dict:
    """Each kernel's launch counter (the kernel entry points'
    ``launches`` attributes), by the kernel's short name."""
    from ..ops.gsf_merge import gsf_merge
    from ..ops.merge import merge_queue
    from ..ops.route import bin_into_ring
    from ..ops.score import gsf_score, score_queue
    return {"route": bin_into_ring.launches,
            "merge": merge_queue.launches,
            "score": score_queue.launches,
            "gsf_merge": gsf_merge.launches,
            "gsf_score": gsf_score.launches}


class CudaMemoryProbe:
    """The default memory probe (module docstring): ``begin(device)``
    synchronizes, reads the allocated bytes and resets the peak;
    ``end(device, token)`` synchronizes and returns the peak less the
    bytes allocated at `begin`.  Off the card both return None (no
    ``temp_bytes``)."""

    def __init__(self):
        #: the peak `begin` found before its reset (module docstring)
        self.prior_peak_bytes = 0

    def begin(self, device):
        if device.type != "cuda":
            return None
        import torch
        torch.cuda.synchronize(device)
        self.prior_peak_bytes = max(self.prior_peak_bytes,
                                    torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    def end(self, device, token):
        if token is None:
            return None
        import torch
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device) - token)

    def reset_peak(self, device=None):
        """Reset the device's peak and the peak kept from before a
        capture: the start of a reader's span."""
        import torch
        torch.cuda.reset_peak_memory_stats(device)
        self.prior_peak_bytes = 0

    def peak(self, device=None) -> int:
        """The device's peak since `reset_peak`, a capture's reset
        included."""
        import torch
        return max(int(torch.cuda.max_memory_allocated(device)),
                   self.prior_peak_bytes)


def _tensors(tree) -> list:
    """The distinct tensor leaves of a pytree."""
    seen, out = set(), []
    for x in pytree.tree_leaves(tree):
        if hasattr(x, "untyped_storage") and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    return out


def _memory_block(args, out, temp) -> dict:
    """The memory block of one captured launch (module docstring)."""
    ins, outs = _tensors(args), _tensors(out)
    ptrs = {x.untyped_storage().data_ptr() for x in ins if x.nbytes}
    mem = {"argument_bytes": sum(x.nbytes for x in ins),
           "output_bytes": sum(x.nbytes for x in outs)}
    alias = sum(x.nbytes for x in outs
                if x.nbytes and x.untyped_storage().data_ptr() in ptrs)
    if alias:
        mem["alias_bytes"] = alias
    if temp is not None:
        mem["temp_bytes"] = int(temp)
    return mem


class CatalogProgram:
    """The registry's launch callable for one chunk program when a
    catalog is attached: ``prog(net, pstate, times, abandon=None)`` as
    the wrapped `ChunkProgram`.  The first launch is measured and
    recorded, one row per plane the program carries (the port runs a
    group's planes in one pass; the JAX scheduler ran one program a
    plane); later launches pass straight through.  Concurrency: module
    docstring."""

    def __init__(self, program, catalog, key: str):
        self.program = program
        self.proto = program.proto
        self.planes = program.planes
        self._catalog = catalog
        self._key = key
        self._captured = False

    def __call__(self, net, pstate, times, abandon=None):
        if self._captured:
            return self.program(net, pstate, times, abandon=abandon)
        cat = self._catalog
        device = net.time.device
        before = launch_counts()
        token = cat.memory_probe.begin(device)
        t0 = cat.now()
        out = self.program(net, pstate, times, abandon=abandon)
        temp = cat.memory_probe.end(device, token)
        wall = cat.now() - t0
        after = launch_counts()
        memory = _memory_block((net, pstate), out, temp)
        cost = {"launches": {k: after[k] - before[k] for k in after}}
        leaves = _tensors((net, pstate))
        for plane in self.planes or (None,):
            cat.record_program(self._key, plane, lower_wall_s=0.0,
                               compile_wall_s=wall, memory=memory,
                               cost=cost, arg_leaves=len(leaves),
                               batch=int(net.time.shape[0]),
                               backend=device.type)
        self._captured = True
        return out


class ProgramCatalog:
    """Durable per-program telemetry: one JSONL row per (compile key,
    plane) (module docstring), plus in-memory chunk-wall aggregates and
    the drift pass.  Thread-safe: build rows land from the drain
    thread, chunk samples from drain/watchdog threads, reads from the
    HTTP scrape thread."""

    #: lock inventory: `_mu` guards the program/pending tables, the
    #: per-key chunk aggregates and the degraded-write counter.
    _LOCK_OWNS = {"_mu": ("_programs", "_pending", "_chunks",
                          "_write_errors")}

    def __init__(self, path=None, *, fsync: bool = True, clock=None,
                 metrics=None, backend: str | None = None,
                 memory_probe=None):
        #: durable JSONL catalog (None = in-memory only); fsync on: the
        #: catalog is sparse (one row per cold program) and exists to
        #: survive the run
        self.path = str(path) if path else None
        self.fsync = bool(fsync)
        #: the ONLY time source (injectable for deterministic tests)
        self.clock = clock if clock is not None else time.perf_counter
        #: optional `MetricsRegistry`: chunk-wall samples feed its
        #: ``wtpu_program_chunk_seconds`` histogram
        self.metrics = metrics
        self.backend = backend
        #: ``begin(device) -> token``, ``end(device, token) -> temp
        #: bytes or None`` (`CudaMemoryProbe` unless given)
        self.memory_probe = memory_probe if memory_probe is not None \
            else CudaMemoryProbe()
        self._programs: dict = {}   # (key, plane) -> catalog row
        self._pending: dict = {}    # (key, plane) -> build-time fields
        self._chunks: dict = {}     # key -> {count, sum, min, max}
        self._write_errors = 0
        self._mu = threading.Lock()

    # ------------------------------------------------------------- write

    def now(self) -> float:
        return self.clock()

    def record_build(self, spec, plane, build_wall_s: float):
        """Stage one build's host-side facts (called by the registry at
        build time).  The row itself is appended by `record_program`
        once the first launch supplies the measured facts."""
        pend = {"key": spec.compile_key(), "plane": plane,
                "protocol": spec.protocol, "engine": spec.engine,
                "chunk_ms": spec.chunk_ms, "superstep": spec.superstep,
                "build_wall_s": round(float(build_wall_s), 6)}
        with self._mu:
            self._pending[(pend["key"], plane)] = pend

    def record_program(self, key: str, plane, *, lower_wall_s: float,
                       compile_wall_s: float, memory: dict, cost: dict,
                       arg_leaves=None, batch=None,
                       backend: str | None = None) -> dict | None:
        """Append THE catalog row for one program, joining the staged
        build facts with the capture's.  Idempotent per (key, plane): a
        duplicate capture (an abandoned watchdog thread racing its
        retry) records nothing."""
        backend = self.backend or backend or "cpu"
        with self._mu:
            if (key, plane) in self._programs:
                return None
            pend = self._pending.pop((key, plane), None) or {}
            row = {"schema": SCHEMA, "kind": "program", "key": key,
                   "plane": plane, "backend": backend,
                   "lower_wall_s": round(float(lower_wall_s), 6),
                   "compile_wall_s": round(float(compile_wall_s), 6),
                   "memory": dict(memory), "cost": dict(cost)}
            for field in ("protocol", "engine", "chunk_ms", "superstep",
                          "build_wall_s"):
                if field in pend:
                    row[field] = pend[field]
            if arg_leaves is not None:
                row["arg_leaves"] = int(arg_leaves)
            if batch is not None:
                row["batch"] = int(batch)
            self._programs[(key, plane)] = row
        if self.path is not None:
            try:
                jsonl.append_line(self.path, row, fsync=self.fsync)
            except OSError as e:
                # the in-memory catalog keeps the row; the durable log
                # degrades loudly (the spans convention)
                with self._mu:
                    self._write_errors += 1
                print(f"programs: append to {self.path} failed ({e}); "
                      "row kept in memory only", file=sys.stderr)
        return row

    def observe_chunk(self, key: str, wall_s: float, lanes=None):
        """One launched chunk's wall seconds for compile key `key` (all
        planes).  Aggregates in memory; feeds the attached metrics
        registry's histogram when one is on."""
        w = float(wall_s)
        with self._mu:
            agg = self._chunks.get(key)
            if agg is None:
                agg = {"count": 0, "sum": 0.0, "min": w, "max": w}
                self._chunks[key] = agg
            agg["count"] += 1
            agg["sum"] += w
            agg["min"] = min(agg["min"], w)
            agg["max"] = max(agg["max"], w)
        if self.metrics is not None:
            self.metrics.observe("wtpu_program_chunk_seconds", w)

    # -------------------------------------------------------------- read

    def programs(self) -> list:
        """The recorded rows, insertion-ordered."""
        with self._mu:
            return list(self._programs.values())

    def chunk_stats(self) -> dict:
        """Per-compile-key chunk-wall aggregates (copies)."""
        with self._mu:
            return {k: dict(v) for k, v in self._chunks.items()}

    def stats(self) -> dict:
        with self._mu:
            return {"programs": len(self._programs),
                    "pending_builds": len(self._pending),
                    "chunk_keys": len(self._chunks),
                    "write_errors": self._write_errors,
                    "durable": self.path is not None}

    def drift(self) -> list:
        """The working-set pass per program (`drift_rows`)."""
        return drift_rows(self.programs(), self.chunk_stats())

    def report(self) -> dict:
        """The ``GET /w/batch/programs`` body: the program table, the
        top compile-wall consumers, the drift pass and the catalog's
        own health."""
        out = summarize_programs(self.programs(), self.chunk_stats())
        out["catalog"] = self.stats()
        if self.path is not None:
            out["catalog"]["path"] = self.path
        return out


# ------------------------------------------------------------ reporting

def drift_rows(rows, chunks=None) -> list:
    """The drift pass over catalog rows (shared by the live catalog and
    `cli/programs.py` reading JSONL files): ``temp_ratio`` where a row
    has both byte counts, and the measured mean chunk wall."""
    chunks = chunks or {}
    out = []
    for row in rows:
        mem = row.get("memory") or {}
        temp, arg = mem.get("temp_bytes"), mem.get("argument_bytes")
        d = {"key": row.get("key"), "plane": row.get("plane"),
             "backend": row.get("backend")}
        if temp is not None and arg:
            d["temp_bytes"] = temp
            d["argument_bytes"] = arg
            d["temp_ratio"] = round(temp / arg, 4)
        agg = chunks.get(row.get("key"))
        if agg and agg["count"]:
            d["chunk_wall_mean_s"] = round(agg["sum"] / agg["count"], 6)
            d["chunks"] = agg["count"]
        out.append(d)
    return out


def summarize_programs(rows, chunks=None) -> dict:
    """One report dict from catalog rows: the program table
    (compile-wall sorted), the top compile-wall consumers, and the
    drift outliers (the largest working sets first)."""
    table = sorted(rows, key=lambda r: -(r.get("compile_wall_s") or 0))
    top = [{"key": r.get("key"), "plane": r.get("plane"),
            "compile_wall_s": r.get("compile_wall_s")}
           for r in table[:3]]
    dr = drift_rows(rows, chunks)
    outliers = sorted((d for d in dr if d.get("temp_ratio") is not None),
                      key=lambda d: -d["temp_ratio"])
    return {"programs": table,
            "count": len(table),
            "compile_wall_total_s": round(
                sum(r.get("compile_wall_s") or 0 for r in rows), 6),
            "top_compile": top,
            "drift": dr,
            "drift_outliers": outliers[:5]}


def read_catalog(path) -> list:
    """Parse one catalog JSONL (torn tail tolerated — the
    `utils/jsonl.iter_lines` contract).  Rows that are not
    program-shaped are skipped with a stderr note, like `read_spans`."""
    out = []
    for i, row in jsonl.iter_lines(path, label="programs"):
        if not isinstance(row, dict) or "key" not in row \
                or "compile_wall_s" not in row:
            print(f"programs: row {i} of {path} is not a program row "
                  "(no key/compile_wall_s); skipped", file=sys.stderr)
            continue
        out.append(row)
    return out


# ---------------------------------------------------------- projection

def _series(name: str, **labels) -> str:
    """A label-styled series name (`parse_exposition` keys on the full
    ``name{labels}`` string).  Only used for gauges: histogram names
    stay bare (the exposition appends its own ``_bucket`` suffix)."""
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return f"{name}{{{inner}}}"


def refresh_catalog_metrics(metrics, catalog) -> None:
    """Project a catalog into a `MetricsRegistry` at scrape time (the
    serve/instrument.py convention: the catalog keeps the source of
    truth; scrape-time `set_counter`/`set_gauge` keeps the exposed
    series monotone where the source is)."""
    rows = catalog.programs()
    chunks = catalog.chunk_stats()
    metrics.set_gauge("wtpu_programs_cataloged", len(rows))
    total = 0.0
    for row in rows:
        labels = {"key": row.get("key"), "plane": row.get("plane") or "none"}
        cw = row.get("compile_wall_s") or 0.0
        total += cw
        metrics.set_gauge(_series("wtpu_program_compile_seconds",
                                  **labels), cw)
        mem = row.get("memory") or {}
        for field in ("temp_bytes", "argument_bytes", "output_bytes"):
            if field in mem:
                metrics.set_gauge(
                    _series(f"wtpu_program_{field}", **labels),
                    mem[field])
    metrics.set_gauge("wtpu_program_compile_wall_total_seconds",
                      round(total, 6))
    for d in drift_rows(rows, chunks):
        if d.get("temp_ratio") is not None:
            metrics.set_gauge(
                _series("wtpu_program_temp_ratio", key=d["key"],
                        plane=d["plane"] or "none"),
                d["temp_ratio"])
    for key, agg in chunks.items():
        metrics.set_counter(
            _series("wtpu_program_chunks_total", key=key),
            agg["count"])
        if agg["count"]:
            metrics.set_gauge(
                _series("wtpu_program_chunk_wall_mean_seconds",
                        key=key),
                round(agg["sum"] / agg["count"], 6))
