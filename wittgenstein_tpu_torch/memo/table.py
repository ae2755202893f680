"""Cross-run memo table — the port of `wittgenstein_tpu/memo/table.py`:
the same key (compile key + entry-state digest + span) and the same
``.npz`` layout, the state's leaves in the JAX flatten order
(`utils/checkpoint.state_leaves`) and each carry's in its field order,
so an entry either package writes is a hit in the other.

The compile registry (serve/registry.py) memoizes PROGRAMS across runs;
this table memoizes simulated WORK: a completed honest prefix (final
state + the per-chunk obs carries that let a forked cell stitch a
full-span artifact) is stored on disk keyed on

    (compile key, entry-state digest, chunk span)

— the program that was run, the state it entered with, and how far it
went.  A prefix always enters at the spec's own `init(seeds)` state, so
the entry component is the stripped spec's content digest (seeds are in
it; `init` is a pure function of spec and seed).  Repeated campaigns
and ``run_grid(resume=True)`` then reuse simulated chunks, not just
compiled programs: a table hit skips the prefix run entirely.

Format: one ``.npz`` per entry (the utils/checkpoint convention —
portable, loads anywhere numpy does) holding the flattened state
leaves, every plane's per-chunk carry leaves, and a JSON ``__meta__``
recording the spec, its digest and the carry layout.  Loads are
verified — a stored spec that no longer digests to its recorded value
is a MISS with a stderr note, never a silently-wrong trajectory (the
checkpoint staleness discipline, degraded from refusal to miss because
a cache may always fall back to simulating).  Writes are atomic and
never raise into the campaign runner: the table is an optimization, not a
dependency.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import numpy as np

#: on-disk entry schema (bump on layout changes; readers treat other
#: schemas as misses)
SCHEMA = 1


def _carry_leaves(carry) -> list:
    from torch.utils import _pytree as pytree
    return [x.detach().cpu().numpy() for x in pytree.tree_leaves(carry)]


class MemoTable:
    """See module docstring.  `root` is the store directory (created
    lazily on the first put)."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.hits = 0
        self.misses = 0
        self.puts = 0

    # ------------------------------------------------------------ keying

    def key(self, spec) -> str:
        """Content address of one prefix entry (module docstring)."""
        from ..obs.ledger import digest
        resolved = spec if isinstance(spec.superstep, int) \
            else spec.validate()
        return digest({"kind": "prefix", "schema": SCHEMA,
                       "compile_key": resolved.compile_key(),
                       "entry_state": f"init:{spec.digest()}",
                       "span": [0, spec.sim_ms],
                       "chunk_ms": spec.chunk_ms})

    def path(self, spec) -> pathlib.Path:
        return self.root / f"prefix-{self.key(spec)}.npz"

    # ------------------------------------------------------------ templates

    @staticmethod
    def _carry_template(spec, plane: str, state_one):
        """A zero carry of the plane's pytree STRUCTURE (leaf shapes
        come from the file, exactly like utils/checkpoint.load)."""
        net = state_one[0]
        if plane == "metrics":
            from ..obs.plane import init_metrics
            from ..obs.spec import MetricsSpec
            return init_metrics(MetricsSpec(
                stat_each_ms=spec.stat_each_ms), spec.chunk_ms, net.time)
        if plane == "trace":
            from ..obs.trace import TraceSpec, init_trace
            return init_trace(TraceSpec(capacity=spec.trace_capacity),
                              net.nodes.down)
        if plane == "audit":
            from ..obs.audit import AuditSpec, init_audit
            return init_audit(AuditSpec(), net)
        raise ValueError(f"unknown obs plane {plane!r}")

    # ------------------------------------------------------------- access

    def get(self, spec, device=None):
        """``(state, carries)`` for the prefix spec on `device` (``cuda``
        unless given), or None on a miss (absent, unreadable, other
        schema, or a stale stored spec)."""
        import torch
        from torch.utils import _pytree as pytree

        from ..utils.checkpoint import state_from_leaves

        path = self.path(spec)
        if not path.exists():
            self.misses += 1
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                problems = self._stale_problems(spec, meta)
                if problems:
                    print(f"memo table: ignoring {path}: "
                          f"{'; '.join(problems)}", file=sys.stderr)
                    self.misses += 1
                    return None
                state_leaves = [z[f"state_{i}"]
                                for i in range(meta["state_leaves"])]
                raw = {plane: [[z[f"{plane}_{c}_{j}"]
                                for j in range(info["leaves"])]
                               for c in range(info["chunks"])]
                       for plane, info in meta["planes"].items()}
        except Exception as e:      # noqa: BLE001 — a torn cache file
            # must degrade to a miss, never break the campaign
            print(f"memo table: unreadable {path}: "
                  f"{type(e).__name__}: {e!s:.200}", file=sys.stderr)
            self.misses += 1
            return None
        proto = spec.build_protocol(device=device)
        state = state_from_leaves(proto, state_leaves)
        template_one = proto.init(0)
        dev = template_one[0].time.device
        carries = {}
        for plane, chunks in raw.items():
            tmpl = self._carry_template(spec, plane, template_one)
            _, cdef = pytree.tree_flatten(tmpl)
            carries[plane] = [pytree.tree_unflatten(
                [torch.from_numpy(np.array(x)).to(dev) for x in leaves],
                cdef) for leaves in chunks]
        self.hits += 1
        return state, carries

    def put(self, spec, state, carries) -> str | None:
        """Store a completed prefix (atomic replace; never raises —
        module docstring).  Returns the path written or None."""
        from ..utils.checkpoint import state_leaves

        try:
            self.root.mkdir(parents=True, exist_ok=True)
            path = self.path(spec)
            arrays = {}
            leaves = state_leaves(*state)
            for i, leaf in enumerate(leaves):
                arrays[f"state_{i}"] = leaf
            planes = {}
            for plane, chunks in (carries or {}).items():
                n_leaves = 0
                for c, carry in enumerate(chunks):
                    cl = _carry_leaves(carry)
                    n_leaves = len(cl)
                    for j, leaf in enumerate(cl):
                        arrays[f"{plane}_{c}_{j}"] = leaf
                planes[plane] = {"chunks": len(chunks),
                                 "leaves": n_leaves}
            meta = {"schema": SCHEMA, "spec": spec.to_json(),
                    "spec_digest": spec.digest(),
                    "prefix_digest": spec.digest(),
                    "state_leaves": len(leaves),
                    "planes": planes}
            arrays["__meta__"] = np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8)
            tmp = str(path) + ".tmp.npz"
            np.savez_compressed(tmp, **arrays)
            os.replace(tmp, path)
            self.puts += 1
            return str(path)
        except Exception as e:      # noqa: BLE001 — insurance only
            print(f"memo table: put failed: {type(e).__name__}: "
                  f"{e!s:.200}", file=sys.stderr)
            return None

    @staticmethod
    def _stale_problems(spec, meta) -> list:
        """Staleness audit of one entry's metadata (the
        utils/checkpoint.stale_meta_problems discipline, degraded to
        miss semantics; wittgenstein_tpu/memo/table.py:173-192)."""
        from ..serve.spec import ScenarioSpec

        if meta.get("schema") != SCHEMA:
            return [f"entry schema {meta.get('schema')!r} != {SCHEMA}"]
        problems = []
        try:
            stored = ScenarioSpec.from_json(meta["spec"])
        except (ValueError, KeyError, TypeError) as e:
            return [f"stored spec no longer parses ({e})"]
        if stored.digest() != meta.get("spec_digest"):
            problems.append("stored spec no longer digests to its "
                            "recorded value (edited after write)")
        if stored.digest() != spec.digest():
            problems.append("entry was written for a different spec "
                            "than the one requested (key collision)")
        return problems

    def stats(self) -> dict:
        return {"root": str(self.root), "hits": self.hits,
                "misses": self.misses, "puts": self.puts}
