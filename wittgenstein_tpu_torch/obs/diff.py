"""First-divergence triage: the bit-identity bisector — the port of
`wittgenstein_tpu/obs/diff.py`, within the port.

Run two engine-variant configurations side by side (dense, superstep-K,
batched, fast-forward), find the first simulated ms at which their
states differ, name the first differing leaf and element, and decode the
flight-recorder window around it from both runs:

  1. COARSE: advance both chunk by chunk and compare the full states at
     every boundary, keeping a copy of the last agreeing one;
  2. FINE: from that copy, re-advance both in steps of the variants'
     finest common granularity ``g = lcm(K_a, K_b)`` up to the first
     differing boundary, the divergent window ``[t*, t* + g)``;
  3. LOCALIZE: the first differing leaf (tree order, named by its
     pytree key path) and element;
  4. REPLAY TRACED: re-run both sides from the saved boundary through
     each variant's traced twin (obs/trace.py) and decode the window.

The engine writes the ring in place, so every state kept for a replay
is a copy (`_copy`).  `FaultInjector` plants a one-(ms, node, leaf)
perturbation: the bisector's own test bench.  The bisector that holds
the port against the JAX package, seed for seed, lives with the tests
that import both (`tests/torch_parity.py`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .decode import TraceFrame
from .trace import TraceSpec, fast_forward_chunk_trace, \
    scan_chunk_batched_trace, scan_chunk_trace

#: variant-dict keys understood by `build_variant` (the JAX package's
#: `pallas_route` key has no counterpart: a wrapper launches its kernel
#: on a CUDA tensor and runs its plain version on a CPU one, with no
#: switch between them)
VARIANT_KEYS = ("superstep", "batched", "fast_forward")


def variant_granularity(variant: dict) -> int:
    """Finest comparison step this engine variant supports: its fused
    window length (the batched engine's floor is the K=2 pair)."""
    k = int(variant.get("superstep", 1) or 1)
    if variant.get("batched"):
        k = max(k, 2)
    return k


def build_variant(protocol, ms: int, variant: dict, trace_spec=None):
    """One chunk callable for an engine-variant configuration, over a
    seed batch (leading seed axis, `core/state.init_batched`'s layout;
    wittgenstein_tpu/obs/diff.py:69-126).

    Untraced: ``(nets, ps) -> (nets, ps)``.  Traced (`trace_spec`):
    ``-> (nets, ps, TraceCarry)`` via the variant's traced twin, so the
    decoded events are the trajectory THIS variant computes."""
    from ..core.batched import scan_chunk_batched
    from ..core.network import fast_forward_chunk, scan_chunk

    unknown = set(variant) - set(VARIANT_KEYS)
    if unknown:
        raise ValueError(f"unknown variant keys {sorted(unknown)}; "
                         f"known: {VARIANT_KEYS}")
    k = int(variant.get("superstep", 1) or 1)
    if variant.get("batched"):
        if trace_spec is not None:
            return scan_chunk_batched_trace(protocol, ms, trace_spec,
                                            superstep=max(k, 2))
        return scan_chunk_batched(protocol, ms, superstep=max(k, 2))
    if variant.get("fast_forward"):
        if trace_spec is not None:
            traced = fast_forward_chunk_trace(protocol, ms, trace_spec,
                                              seed_axis=True, superstep=k)

            def run_t(nets, ps):
                nets, ps, _, tc = traced(nets, ps)
                return nets, ps, tc

            return run_t
        base_ff = fast_forward_chunk(protocol, ms, seed_axis=True,
                                     superstep=k)

        def run(nets, ps):
            nets, ps, _ = base_ff(nets, ps)
            return nets, ps

        return run
    if trace_spec is not None:
        return scan_chunk_trace(protocol, ms, trace_spec, superstep=k)
    return scan_chunk(protocol, ms, superstep=k)


class FaultInjector:
    """Protocol proxy that perturbs ONE element of the post-step state at
    exactly one simulated ms (wittgenstein_tpu/obs/diff.py:129-170): at
    ``t == at_ms``, ``delta`` is added to ``leaf`` (a field of the
    protocol state, or ``"nodes.<field>"`` for engine node state) at
    index ``node`` of its first axis.  Everything else delegates to the
    wrapped protocol, so the two sides of a bisection run the SAME
    engine with a planted one-node divergence."""

    def __init__(self, inner, at_ms: int, leaf: str, node: int, delta=1):
        self._inner = inner
        self.at_ms = int(at_ms)
        self.leaf = leaf
        self.node = int(node)
        self.delta = delta

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _perturb(self, tree, path: str):
        head, _, rest = path.partition(".")
        val = getattr(tree, head)
        if rest:
            return tree.replace(**{head: self._perturb(val, rest)})
        rows = torch.arange(val.shape[0], device=val.device)
        hit = (rows == self.node).reshape((-1,) + (1,) * (val.dim() - 1))
        return tree.replace(**{head: torch.where(hit, val + self.delta,
                                                 val)})

    def step(self, pstate, nodes, inbox, t, **kw):
        pstate, nodes, out = self._inner.step(pstate, nodes, inbox, t,
                                              **kw)
        if t == self.at_ms:
            if self.leaf.startswith("nodes."):
                nodes = self._perturb(nodes, self.leaf[len("nodes."):])
            else:
                pstate = self._perturb(pstate, self.leaf)
        return pstate, nodes, out


@dataclasses.dataclass
class Divergence:
    """Where two engine-variant runs first disagree."""

    ms: int                 # divergent window start (states at `ms` agree)
    granularity: int        # window width g = lcm(K_a, K_b)
    leaf: str               # first differing leaf (pytree key path)
    index: tuple            # first differing element (leading axis = run)
    value_a: object
    value_b: object
    n_diff_leaves: int      # leaves differing at the divergent boundary
    trace_a: TraceFrame | None = None
    trace_b: TraceFrame | None = None
    trace_window: tuple | None = None   # (lo, hi) of the decoded window

    def format(self, trace_limit: int = 40) -> str:
        g = self.granularity
        win = (f"ms {self.ms}" if g == 1
               else f"window [{self.ms}, {self.ms + g}) (granularity "
                    f"{g} — the variants' finest common step)")
        lines = [
            f"first divergence: {win}",
            f"  leaf : {self.leaf}",
            f"  index: {self.index}  (leading axis = run/seed)",
            f"  a={self.value_a}  b={self.value_b}",
            f"  {self.n_diff_leaves} leaf(s) differ at the divergent "
            "boundary",
        ]
        if self.trace_a is not None:
            lo, hi = self.trace_window
            lines += [f"--- trace A, ms [{lo}, {hi}) "
                      f"({self.trace_a.n_events} events):",
                      self.trace_a.format(limit=trace_limit) or "  (none)"]
        if self.trace_b is not None:
            lo, hi = self.trace_window
            lines += [f"--- trace B, ms [{lo}, {hi}) "
                      f"({self.trace_b.n_events} events):",
                      self.trace_b.format(limit=trace_limit) or "  (none)"]
        return "\n".join(lines)


def _copy(state):
    """A copy of a state the engine may update in place (its ring)."""
    return pytree.tree_map(torch.clone, state)


def _states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _first_leaf_diff(state_a, state_b):
    """(leaf path, element index, value_a, value_b, n_diff_leaves) of
    the first differing leaf in tree order."""
    la, _ = pytree.tree_flatten_with_path(state_a)
    lb, _ = pytree.tree_flatten_with_path(state_b)
    first, n_diff = None, 0
    for (path, xa), (_, xb) in zip(la, lb):
        da, db = xa.cpu().numpy(), xb.cpu().numpy()
        mask = da != db
        if mask.any():
            n_diff += 1
            if first is None:
                idx = np.unravel_index(int(np.argmax(mask)), mask.shape) \
                    if mask.ndim else ()
                first = (pytree.keystr(path), tuple(int(i) for i in idx),
                         da[idx] if mask.ndim else da,
                         db[idx] if mask.ndim else db)
    if first is None:
        return None
    path, idx, va, vb = first
    return path, idx, va, vb, n_diff


def first_divergence(protocol, variant_a, variant_b, total_ms,
                     chunk_ms=None, seeds=1, protocol_b=None,
                     trace_spec=None, trace_pad_ms=4, first_seed=0):
    """Bisect the first state divergence between two engine-variant
    configurations of `protocol` over `total_ms` simulated ms
    (wittgenstein_tpu/obs/diff.py:244-342).

    `variant_a` / `variant_b` are dicts over VARIANT_KEYS.  `protocol_b`
    substitutes another protocol object for side B (same state shapes:
    the `FaultInjector` hook).  `trace_spec` (default: a 4096-row
    `TraceSpec`; ``False`` skips the traced replay) decodes the event
    window ``[t* - trace_pad_ms, t* + g + trace_pad_ms)`` around the
    divergence from both sides' traced twins.

    Returns a `Divergence`, or None when the runs are bit-identical
    over the whole span.
    """
    from ..core.state import init_batched

    pa, pb = protocol, protocol_b or protocol
    ga = variant_granularity(variant_a)
    gb = variant_granularity(variant_b)
    g = ga * gb // math.gcd(ga, gb)
    if chunk_ms is None:
        chunk_ms = max(32, 4 * g)
    chunk_ms = -(-chunk_ms // g) * g
    total_ms = -(-int(total_ms) // chunk_ms) * chunk_ms

    sd = torch.arange(first_seed, first_seed + seeds)
    state_a = init_batched(pa, sd)
    state_b = init_batched(pb, sd)
    t0 = int(state_a[0].time.reshape(-1)[0])

    step_a = build_variant(pa, chunk_ms, variant_a)
    step_b = build_variant(pb, chunk_ms, variant_b)

    # 1. coarse: first divergent chunk, keeping a copy of the last
    # agreeing boundary
    saved, saved_t = (_copy(state_a), _copy(state_b)), t0
    t = t0
    diverged = False
    for _ in range(total_ms // chunk_ms):
        state_a = step_a(*state_a)
        state_b = step_b(*state_b)
        t += chunk_ms
        if not _states_equal(state_a, state_b):
            diverged = True
            break
        saved, saved_t = (_copy(state_a), _copy(state_b)), t
    if not diverged:
        return None

    # 2. fine: replay the divergent chunk from the saved boundary at
    # the finest common granularity g.
    fine_a = build_variant(pa, g, variant_a)
    fine_b = build_variant(pb, g, variant_b)
    state_a, state_b = _copy(saved[0]), _copy(saved[1])
    t_star = saved_t
    for _ in range(chunk_ms // g):
        state_a = fine_a(*state_a)
        state_b = fine_b(*state_b)
        if not _states_equal(state_a, state_b):
            break
        t_star += g

    # 3. localize: first differing leaf/element at the boundary.
    located = _first_leaf_diff(state_a, state_b)
    if located is None:         # can only mean a nondeterministic build
        raise RuntimeError(
            "the fine pass lost the divergence the coarse pass found: "
            "the build is not replay-deterministic (this bisector's one "
            "precondition). Check the variant for host-dependent state")
    leaf, idx, va, vb, n_diff = located

    div = Divergence(ms=t_star, granularity=g, leaf=leaf, index=idx,
                     value_a=va, value_b=vb, n_diff_leaves=n_diff)
    if trace_spec is False:
        return div

    # 4. traced replay of both sides from the saved chunk boundary
    # through the divergent window (+ pad).
    spec = trace_spec or TraceSpec()
    span = (t_star - saved_t) + g + int(trace_pad_ms)
    span = -(-span // g) * g
    tr_a = build_variant(pa, span, variant_a, trace_spec=spec)
    tr_b = build_variant(pb, span, variant_b, trace_spec=spec)
    *_, tc_a = tr_a(*saved[0])
    *_, tc_b = tr_b(*saved[1])
    lo = max(saved_t, t_star - int(trace_pad_ms))
    hi = saved_t + span
    div.trace_a = TraceFrame.from_carry(spec, tc_a).window(lo, hi)
    div.trace_b = TraceFrame.from_carry(spec, tc_b).window(lo, hi)
    div.trace_window = (lo, hi)
    return div
