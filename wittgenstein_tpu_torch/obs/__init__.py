"""On-device observability planes of the port — the port of the device
half of `wittgenstein_tpu/obs` (its metrics, trace and audit planes and
their host decoders).

  metrics (`spec`, `plane`, `engine`, `export`): a `MetricsSpec(
  stat_each_ms, counters)` records a fixed-shape ``[T, K]`` int32
  interval series beside the engine chunk, from pure reductions of the
  state; `MetricsFrame` exports it as a ProgressPerTime-style CSV, a
  Perfetto trace or the bench line's ``engine_metrics`` block;

  trace (`trace`, `decode`, `diff`): a `TraceSpec(capacity, events,
  node_filter)` records a ``[cap, 6]`` int32 event ring through the
  engine's `step_kms` tap hook (per-ms exact inside K windows);
  `TraceFrame` decodes it, and `diff.first_divergence` bisects the
  first state divergence between two engine variants down to the (ms,
  leaf, element);

  audit (`audit`, `audit_report`): an `AuditSpec(invariants, mode)`
  runs conservation-law monitors through the same tap hook;
  `AuditReport` gives the verdict, loudly when violated.

The contract is the JAX package's: every plane is bit-identical on the
``(NetState, pstate)`` trajectory, its carry equals the JAX plane's bit
for bit, the engine without a plane runs no extra operation, and on the
card no plane reads the device from the host inside a chunk.

The host plane: `ledger` (`RunManifest` rows with the JAX package's
digests), `spans` (`SpanRecorder`, the wall-time flight recorder) and
`metrics` (`MetricsRegistry`, the Prometheus exposition behind ``GET
/w/batch/metrics``), with `export.spans_to_perfetto` merging host spans
and device lanes; `programs` (`ProgramCatalog`: each served program's
first-launch wall, working set on the card and kernel launches) and
`regress` (`BenchHistory` and the bench-history gate).  Not ported yet:
the sharded engine's monitors (ROADMAP.md A15).
"""

from .audit import (INVARIANTS, AuditCarry, AuditSpec,  # noqa: F401
                    fast_forward_chunk_audit, init_audit,
                    scan_chunk_audit, scan_chunk_batched_audit)
from .audit_report import (AuditReport, audit_block,  # noqa: F401
                           audit_variant, cross_check_metrics)
from .decode import TraceFrame, trace_block  # noqa: F401
from .engine import (fast_forward_chunk_batched_metrics,  # noqa: F401
                     fast_forward_chunk_metrics, scan_chunk_batched_metrics,
                     scan_chunk_metrics, step_ms_metrics)
from .export import (MetricsFrame, engine_metrics_block,  # noqa: F401
                     spans_to_perfetto, to_perfetto, to_progress_csv,
                     trace_to_perfetto)
from .metrics import MetricsRegistry, parse_exposition  # noqa: F401
from .plane import MetricsCarry, counter_values, init_metrics  # noqa: F401
from .spans import SpanRecorder, read_spans  # noqa: F401
from .spec import COUNTERS, MetricsSpec  # noqa: F401
from .trace import (EVENTS, TraceCarry, TraceSpec,  # noqa: F401
                    fast_forward_chunk_trace, init_trace,
                    scan_chunk_batched_trace, scan_chunk_trace,
                    step_ms_trace, trace_jump, trace_tap)
