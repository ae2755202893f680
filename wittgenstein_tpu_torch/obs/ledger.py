"""Run-ledger manifests: one JSONL row of provenance per measured run —
the port of `wittgenstein_tpu/obs/ledger.py`.

A `RunManifest` records a run's configuration digest, engine variant,
superstep K, seed count, backend, wall time, and content digests of the
metrics/trace/audit blocks (plus the audit verdict), appended as one
JSONL row under ``reports/ledger/`` through the crash-safe append of
`utils/jsonl.py`.  Rows are append-only and self-describing
(``schema``), so two runs claiming the same config are checkable by
digest equality.  The digests (`digest`, `config_digest`,
`metrics_digest`, `trace_digest`, `audit_digest`) are computed as the
JAX package computes them, so a row of the port and a row of the JAX
package for the same spec and the same artifacts carry the same
digests; what differs is what a run cannot share: the backend (the
port's comes from `utils/platform.py`, ``"cuda"`` or ``"cpu"``), the
wall time and the timestamp.  Writing never raises into the caller.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import sys
import time

#: manifest schema version (bump on field changes; readers key on it)
SCHEMA = 1

_REPO = pathlib.Path(__file__).resolve().parents[2]

#: default ledger location (repo-local, append-only JSONL)
LEDGER_DIR = _REPO / "reports" / "ledger"
LEDGER_PATH = LEDGER_DIR / "ledger.jsonl"


def digest(obj) -> str:
    """Short stable content digest of any JSON-serializable object
    (canonical key order; non-serializable leaves stringified;
    wittgenstein_tpu/obs/ledger.py:41-48)."""
    payload = json.dumps(obj, sort_keys=True, default=str,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass
class RunManifest:
    """One run's provenance row (JSONL-serializable)."""

    run: str                        # metric / stage label
    engine: str                     # "batched" | "vmapped" | "fast_forward" | "sharded" | ...
    superstep: int
    seeds: int
    backend: str
    config_digest: str              # digest of the run configuration
    ts_unix: float = dataclasses.field(default_factory=time.time)
    schema: int = SCHEMA
    wall_s: float | None = None
    sim_ms: int | None = None
    value: float | None = None      # the run's headline number, if any
    unit: str | None = None
    metrics_digest: str | None = None
    trace_digest: str | None = None
    audit_digest: str | None = None
    audit_clean: bool | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, row: dict) -> "RunManifest":
        known = {f.name for f in dataclasses.fields(cls)}
        extra_unknown = {k: v for k, v in row.items() if k not in known}
        kw = {k: v for k, v in row.items() if k in known}
        if extra_unknown:       # forward-compat: unknowns ride in extra
            kw.setdefault("extra", {}).update(extra_unknown)
        return cls(**kw)


def manifest_from_bench(line: dict, config: dict, label: str | None = None,
                        backend: str | None = None) -> RunManifest:
    """Build a manifest from a bench/suite JSON line + the knob dict
    that produced it.  `config` should hold everything that selects the
    compiled program (protocol, sizes, engine env knobs) — its digest
    is what makes two runs comparable-by-construction."""
    if backend is None:
        from ..utils.platform import backend as default_backend
        backend = default_backend()
    # callers that know their dispatch pass config["engine"]; guessing
    # an engine from the superstep would mislabel A/B legs (e.g. the
    # vmapped dense calibration leg at K=4), so the fallback is honest
    if line.get("fast_forward") or config.get("fast_forward"):
        engine = "fast_forward"
    else:
        engine = "unspecified"
    audit = line.get("audit") or {}
    wall = line.get("wall_total_s", line.get("wall_median_s"))
    return RunManifest(
        run=label or str(line.get("metric", "run")),
        engine=str(config.get("engine", engine)),
        superstep=int(line.get("superstep", config.get("superstep", 1))
                      or 1),
        seeds=int(line.get("total_seeds",
                           line.get("batch", config.get("seeds", 1)))),
        backend=backend,
        config_digest=digest(config),
        wall_s=float(wall) if wall is not None else None,
        sim_ms=int(line["sim_ms"]) if line.get("sim_ms") else None,
        value=float(line["value"]) if line.get("value") is not None
        else None,
        unit=line.get("unit"),
        metrics_digest=digest(line["engine_metrics"])
        if line.get("engine_metrics") else None,
        trace_digest=digest(line["trace"]) if line.get("trace") else None,
        audit_digest=digest(audit) if audit else None,
        audit_clean=bool(audit["clean"]) if "clean" in audit else None,
        extra={k: line[k] for k in ("metric", "vs_baseline",
                                    "compile_cache") if k in line},
    )


def manifest_from_spec(line: dict, spec, label: str | None = None,
                       backend: str | None = None,
                       **extra) -> RunManifest:
    """Build a manifest whose ``config_digest`` IS the `ScenarioSpec`
    digest (serve/spec.py) — the one config path bench, bench_suite and
    the serve scheduler share, so rows from all three claiming the same
    spec are comparable by digest equality.  `extra` keys (e.g. the
    spec's ``compile_key``) ride in the manifest's extra dict."""
    config = dict(spec.to_json())
    config["engine"] = line.get("engine", spec.engine)
    # manifest_from_bench's seed fallback is a COUNT; the spec's field
    # is the seed list
    config["seeds"] = len(spec.seeds)
    if not isinstance(spec.superstep, int):
        # an unresolved "auto" would hit manifest_from_bench's int()
        # fallback when the line carries no superstep of its own —
        # drop it from the fallback dict (the digest below still
        # covers the requested value)
        config.pop("superstep", None)
    mani = manifest_from_bench(line, config, label=label, backend=backend)
    mani.config_digest = spec.digest()
    if not line.get("superstep") and isinstance(spec.superstep, int):
        mani.superstep = spec.superstep
    mani.extra.update(extra)
    return mani


def append(manifest: RunManifest, path=None) -> str | None:
    """Append one manifest row to the JSONL ledger (default
    ``reports/ledger/ledger.jsonl``) through the shared atomic
    write-then-flush helper (utils/jsonl.py — one append path for
    every append-only log in the tree); returns the path written, or
    None when the write failed (logged to stderr — provenance must
    never kill a metric line)."""
    from ..utils import jsonl
    path = pathlib.Path(path) if path else LEDGER_PATH
    try:
        return jsonl.append_line(path, manifest.to_json())
    except OSError as e:
        print(f"ledger: append failed ({e}); row dropped",
              file=sys.stderr)
        return None


def append_from_spec(line: dict, spec, label: str | None = None,
                     path=None, **extra) -> str | None:
    """`manifest_from_spec` + `append` with the never-raises contract
    of `append_from_env` (provenance must not kill a metric line).
    Returns the path written or None."""
    try:
        return append(manifest_from_spec(line, spec, label=label, **extra),
                      path)
    except Exception as e:      # noqa: BLE001 — provenance only
        print(f"ledger: append_from_spec failed: {type(e).__name__}: "
              f"{e!s:.200}", file=sys.stderr)
        return None


def append_from_env(line: dict, label: str | None = None,
                    **config_extra) -> str | None:
    """The one-call provenance append `bench.py` and
    `tools/bench_suite.py` share: capture the WTPU_*/JAX_PLATFORMS
    engine knobs as the config (ONE definition of what the config
    digest covers — two callers re-implementing the filter would let
    their digests silently diverge for identical configurations),
    merge `config_extra` (callers pass `engine=` from the dispatch
    they actually took), build the manifest, and append.  Never raises
    — provenance must not kill a metric line; returns the path written
    or None."""
    import os

    try:
        config = {k: v for k, v in sorted(os.environ.items())
                  if k.startswith(("WTPU_", "JAX_PLATFORMS"))}
        config.update(config_extra)
        return append(manifest_from_bench(line, config, label=label))
    except Exception as e:      # noqa: BLE001 — provenance only
        print(f"ledger: append_from_env failed: {type(e).__name__}: "
              f"{e!s:.200}", file=sys.stderr)
        return None


def read_all(path=None) -> list:
    """All ledger rows as `RunManifest`s, read through the shared
    torn-tail-tolerant JSONL reader (utils/jsonl.py): a line torn by a
    crash mid-append — or any malformed row — is skipped with a stderr
    note instead of raising, so the matrix campaign resume's dedup
    join and every other consumer survive a kill mid-`append`."""
    from ..utils import jsonl
    path = pathlib.Path(path) if path else LEDGER_PATH
    out = []
    for i, row in jsonl.iter_lines(path, label="ledger"):
        try:
            out.append(RunManifest.from_json(row))
        except TypeError as e:
            print(f"ledger: skipping malformed row {i}: {e}",
                  file=sys.stderr)
    return out
