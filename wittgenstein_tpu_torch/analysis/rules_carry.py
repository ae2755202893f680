"""Rule ``carry_copy`` — copies of the mailbox ring inside the chunk
(the port's counterpart of `wittgenstein_tpu/analysis/rules_carry.py`).

The JAX package's round-5 regression: XLA copied every ring plane once
a superstep when it could not prove the ring scatters run after the
inbox reads.  The port's engine writes the ring (and a protocol's
`IN_PLACE` leaves) in place; a chunk that clones or copies a whole
plane is the same regression in eager form.  A copy is an op the
recorder saw as ``aten::clone``, ``aten::copy_`` or a same-device
``aten::_to_copy`` (``contiguous`` on a non-contiguous tensor
dispatches a clone); it is attributed to the state leaves whose dtype
and shape its output has.

Metrics (budgeted per target, ratchet-down):
  plane_copies    — copies with a ring data/src/size plane's shape;
  boxcount_copies — copies with the box_count plane's shape (its
                    [R, H, N] shape can collide with protocol leaves,
                    hence its own budget);
  copy_bytes      — total bytes of all >= 1 KB copies;
  dus_bytes       — bytes of the functional slice updates
                    (``slice_scatter``, ``select_scatter``,
                    ``as_strided_scatter``), the eager twin of XLA's
                    dynamic-update-slice; the engine's in-place writes
                    (``index_put_``, ``copy_`` into a view) write only
                    their cells and are not counted.
"""

from __future__ import annotations

import collections
import dataclasses

from .framework import Finding, Rule, register_rule
from .targets import shape_key

_NOISE_BYTES = 1024     # ignore sub-KB copies
COPY_OPS = ("aten::clone", "aten::copy_", "aten::_to_copy")
DUS_OPS = ("aten::slice_scatter", "aten::select_scatter",
           "aten::as_strided_scatter")


@dataclasses.dataclass(frozen=True)
class AuditRow:
    op: str             # "copy" | "dus"
    shape: str
    count: int
    bytes: int
    leaf: str           # attributed state field names ("" when unknown)


def _is_copy(op) -> bool:
    if op.base not in COPY_OPS or op.read or op.h2d:
        return False
    return True


def audit(target) -> list[AuditRow]:
    """Every copy / slice update of the recorded chunk, aggregated by
    (op, shape) and attributed to state leaves by dtype and shape."""
    names = target.leaf_names
    rows: collections.Counter = collections.Counter()
    sizes: collections.Counter = collections.Counter()
    for op in target.recorder.ops:
        kind = "copy" if _is_copy(op) else \
            "dus" if op.base in DUS_OPS else None
        if kind is None or not op.shapes:
            continue
        key = shape_key(op.dtypes[0], op.shapes[0])
        leaf = "/".join(sorted(names.get(key, []))[:3])
        rows[(kind, key, leaf)] += 1
        sizes[(kind, key, leaf)] += op.nbytes
    return [AuditRow(op=k[0], shape=k[1], leaf=k[2], count=c,
                     bytes=sizes[k])
            for k, c in sorted(rows.items(), key=lambda kv: -sizes[kv[0]])]


def _is_plane(leaf: str) -> bool:
    return "box_data" in leaf or "box_src" in leaf or "box_size" in leaf


def metrics_from_rows(rows) -> dict:
    plane_copies = sum(r.count for r in rows
                       if r.op == "copy" and _is_plane(r.leaf))
    boxcount_copies = sum(r.count for r in rows
                          if r.op == "copy" and "box_count" in r.leaf)
    copy_bytes = sum(r.bytes for r in rows
                     if r.op == "copy" and r.bytes // r.count >= _NOISE_BYTES)
    dus_bytes = sum(r.bytes for r in rows if r.op == "dus")
    return {"plane_copies": plane_copies,
            "boxcount_copies": boxcount_copies,
            "copy_bytes": copy_bytes, "dus_bytes": dus_bytes}


def measure(target) -> dict:
    return metrics_from_rows(audit(target))


@register_rule
class CarryCopyRule(Rule):
    name = "carry_copy"
    scope = "protocol"
    budgeted_metrics = ("plane_copies", "boxcount_copies", "copy_bytes",
                        "dus_bytes")
    device_metrics = ("plane_copies", "boxcount_copies")

    def run(self, target, budget):
        if not target.recorder.ops:
            return [Finding(rule=self.name, target=target.name,
                            severity="warning",
                            message="the recorded chunk dispatched no op")]
        return [Finding(rule=self.name, target=target.name, severity="info",
                        metric=m, value=v,
                        message=f"{m}={v} in the chunk")
                for m, v in measure(target).items()]
