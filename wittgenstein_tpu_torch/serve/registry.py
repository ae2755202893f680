"""`CompileRegistry` — compile key -> chunk program, and the port's
chunk programs themselves; the port of
`wittgenstein_tpu/serve/registry.py`.

The JAX registry memoizes one jitted chunk callable per (compile key,
obs plane), so a repeated spec reuses the compiled executable.  The
port has no trace or compile step to save (its chunk is Python over
tensors; its kernels are built once a process by `ops/_build.py`,
whose on-disk extension cache is the analogue of the JAX persistent
compile cache), but the registry keeps the same table and the same
accounting: `chunk_fn` is one lookup, a repeat of a (compile key, plane)
pair returns the SAME `ChunkProgram` object and counts a hit, a new one
builds and counts a miss.  The scheduler looks up every plane of a
group once, as the JAX scheduler does, so `hits`, `misses`, `entries`
and the `registry_block()` equal the JAX package's for the same submits
(the ``persistent_cache`` field names the port's extension cache
directory instead of the JAX compile cache).  ``persistent=`` and
``enable_persistent_cache`` select nothing; ``route_kernel`` (a
program field of the spec) selects nothing either: the port has one
binning kernel, K1 (`ops/route.py`).

With a `ProgramCatalog` attached (``catalog=``, default None: nothing
imported, one is-None branch), every cold build stages its build facts
(`record_build`) and the registry hands out `obs.programs.CatalogProgram`
wrappers, for the per-plane programs and for a group's fused one: a
program's first launch is measured (its wall, its working set on the
card, each kernel's launches) and recorded, one row per (compile key,
plane), and every later launch passes straight through.

One pass a chunk for every plane.  The JAX scheduler advances the state
with one plane's program and runs the other planes as shadow passes
from the same entry state: a jitted chunk is a pure function of its
entry.  The port's engine writes the mailbox ring (and a protocol's
`IN_PLACE` leaves) in place, so a second pass from the entry would read
a ring the first one already advanced.  A `ChunkProgram` therefore
carries any set of planes through ONE engine pass: each window is one
`step_kms` with the audit and trace taps (each writes its own cell),
then the audit fold and the metrics recording; each fast-forward jump
is recorded by every plane.  Each plane's carry equals its own
builder's (`obs.scan_chunk_metrics`, `obs.scan_chunk_trace`,
`obs.scan_chunk_audit` and their batched and fast-forward twins; the
JAX planes are held to those in tests/test_torch_obs.py and its
siblings), and the state equals the plain engine's.  `fused` hands the
scheduler the group's program over all of its planes; the per-plane
entries `chunk_fn` returns carry one plane each.

A program is called as ``prog(net, pstate, times, abandon=None)`` on a
seed batch (every leaf with a leading seed axis) whose runs are at the
host clocks `times` (one int a run; the scheduler keeps them, so a
chunk never reads the clock from the device).  It returns ``(net,
pstate, times + chunk_ms, stats, {plane: carry})``, `stats` the
fast-forward skip counts (None on the dense engines).  The lockstep
engines (``batched``, ``fast_forward``) need one clock across the
batch; on ``vmapped`` a batch with mixed clocks (a late joiner beside a
running group) runs one engine pass per clock and is put back in row
order, which equals running each run alone.  `abandon` (a
`threading.Event`) is checked at every window's entry: once it is set,
the program raises `LaunchAbandoned` before touching the state again
(the scheduler's watchdog sets it).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .spec import ScenarioSpec

PLANES = ("metrics", "trace", "audit")


class LaunchAbandoned(RuntimeError):
    """A chunk program stopped at a window's entry because its launch was
    abandoned (the scheduler's watchdog)."""


def _rows(state, idx):
    """Rows `idx` of every leaf of a seed-batched pytree (a copy)."""
    ix = None

    def take(x):
        nonlocal ix
        if ix is None or ix.device != x.device:
            ix = torch.as_tensor(idx, dtype=torch.long, device=x.device)
        return x.index_select(0, ix)

    return pytree.tree_map(take, state)


def _cat(trees):
    """Leaf-wise concatenation of seed-batched pytrees on the seed axis."""
    if len(trees) == 1:
        return trees[0]
    return pytree.tree_map(lambda *xs: torch.cat(xs, 0), *trees)


class _Planes:
    """Every plane of a program as one `fast_forward_chunk` observer (and
    the dense loop's window): `step_kms` with the audit and trace taps,
    then the audit fold, the trace cell and the metrics recording."""

    def __init__(self, proto, specs: dict, net, t0: int, ms: int,
                 abandon):
        from ..obs.audit import init_audit
        from ..obs.plane import init_metrics
        from ..obs.trace import init_trace
        self.proto, self.specs, self.t0 = proto, specs, t0
        self.abandon = abandon
        self.carries = {}
        if "metrics" in specs:
            self.carries["metrics"] = init_metrics(specs["metrics"], ms,
                                                   net.time)
        if "audit" in specs:
            self.carries["audit"] = init_audit(specs["audit"], net)
        if "trace" in specs:
            self.carries["trace"] = init_trace(specs["trace"],
                                               net.nodes.down)

    def window(self, net, pstate, k: int, t: int):
        from ..core.network import step_kms
        if self.abandon is not None and self.abandon.is_set():
            raise LaunchAbandoned(f"launch abandoned at t={t}")
        specs, carries = self.specs, self.carries
        taps, acell, tcell = [], None, None
        if "audit" in specs:
            from ..obs.audit import audit_tap
            acell = [None]
            taps.append(audit_tap(self.proto, specs["audit"], acell))
        if "trace" in specs:
            from ..obs.trace import trace_tap
            tcell = [carries["trace"], None]
            taps.append(trace_tap(self.proto, specs["trace"], tcell))
        tap = None
        if len(taps) == 1:
            tap = taps[0]
        elif taps:
            def tap(ti, n, out):
                for f in taps:
                    f(ti, n, out)
        net, pstate = step_kms(self.proto, net, pstate, k, t=t, tap=tap)
        if acell is not None:
            from ..obs.audit import fold_window
            carries["audit"] = fold_window(specs["audit"], self.proto.cfg,
                                           carries["audit"], acell[0], net,
                                           k, t)
        if tcell is not None:
            carries["trace"] = tcell[0]
        if "metrics" in specs:
            from ..obs.plane import record_step
            carries["metrics"] = record_step(specs["metrics"],
                                             carries["metrics"], net,
                                             self.t0, t + k, n_steps=k)
        return net, pstate

    def jump(self, t: int, dt: int):
        specs, carries = self.specs, self.carries
        if "metrics" in specs:
            from ..obs.plane import record_jump
            carries["metrics"] = record_jump(specs["metrics"],
                                             carries["metrics"], self.t0,
                                             t, dt)
        if "trace" in specs:
            from ..obs.trace import trace_jump
            carries["trace"] = trace_jump(specs["trace"], carries["trace"],
                                          t, dt)
        if "audit" in specs:
            from ..obs.audit import audit_jump
            carries["audit"] = audit_jump(specs["audit"], carries["audit"],
                                          t, dt)


def plane_specs(spec: ScenarioSpec, planes) -> dict:
    """``{plane: its obs spec}`` for a resolved spec's planes."""
    out = {}
    for plane in planes:
        if plane == "metrics":
            from ..obs.spec import MetricsSpec
            out[plane] = MetricsSpec(stat_each_ms=spec.stat_each_ms)
        elif plane == "trace":
            from ..obs.trace import TraceSpec
            out[plane] = TraceSpec(capacity=spec.trace_capacity)
        elif plane == "audit":
            from ..obs.audit import AuditSpec
            out[plane] = AuditSpec()
        else:
            raise ValueError(f"unknown obs plane {plane!r}; known: "
                             "metrics trace audit (or None)")
    return out


def _check_builders(proto, spec: ScenarioSpec, specs: dict):
    """Run the engine builders' own refusals for this program (the JAX
    registry's `_build` choice of builder, engine by plane): the
    builders raise with remedy text on a chunk they cannot run."""
    ms, k, eng = spec.chunk_ms, spec.superstep, spec.engine
    from ..core.network import fast_forward_chunk, scan_chunk
    if eng == "batched":
        from ..core.batched import scan_chunk_batched
        scan_chunk_batched(proto, ms, superstep=k)
    elif eng == "fast_forward":
        fast_forward_chunk(proto, ms, seed_axis=True, superstep=k)
    else:
        scan_chunk(proto, ms, superstep=k)
    from .. import obs
    build = {"metrics": (obs.scan_chunk_batched_metrics,
                         obs.fast_forward_chunk_metrics,
                         obs.scan_chunk_metrics),
             "trace": (obs.scan_chunk_batched_trace,
                       obs.fast_forward_chunk_trace, obs.scan_chunk_trace),
             "audit": (obs.scan_chunk_batched_audit,
                       obs.fast_forward_chunk_audit,
                       obs.scan_chunk_audit)}
    for plane, pspec in specs.items():
        batched, ff, dense = build[plane]
        if eng == "batched":
            batched(proto, ms, pspec, superstep=k)
        elif eng == "fast_forward":
            ff(proto, ms, pspec, seed_axis=True, superstep=k)
        else:
            dense(proto, ms, pspec, superstep=k)


class ChunkProgram:
    """One chunk program of a resolved spec over a set of obs planes
    (module docstring): ``prog(net, pstate, times, abandon=None) ->
    (net, pstate, times', stats, {plane: carry})``."""

    def __init__(self, spec: ScenarioSpec, planes, proto):
        self.proto = proto
        self.engine = spec.engine
        self.ms, self.k = spec.chunk_ms, spec.superstep
        self.planes = tuple(p for p in PLANES if p in planes)
        self.specs = plane_specs(spec, self.planes)
        _check_builders(proto, spec, self.specs)

    def _run(self, net, pstate, t: int, abandon):
        """One engine pass of the whole batch at clock `t`."""
        from ..core.network import fast_forward_chunk
        obs = _Planes(self.proto, self.specs, net, t, self.ms, abandon)
        if self.engine == "fast_forward":
            net, pstate, stats = fast_forward_chunk(
                self.proto, self.ms, seed_axis=True, superstep=self.k,
                observer=obs)(net, pstate, t)
        else:
            stats = None
            for _ in range(self.ms // self.k):
                net, pstate = obs.window(net, pstate, self.k, t)
                t += self.k
        return net, pstate, stats, obs.carries

    def __call__(self, net, pstate, times, abandon=None):
        times = tuple(int(t) for t in times)
        clocks = sorted(set(times))
        out_times = tuple(t + self.ms for t in times)
        if len(clocks) == 1:
            net, pstate, stats, carries = self._run(net, pstate,
                                                    clocks[0], abandon)
            return net, pstate, out_times, stats, carries
        if self.engine != "vmapped":
            raise ValueError(
                f"the {self.engine} engine runs its batch in lockstep; "
                f"got runs at times {clocks}")
        # one pass per clock, then the rows back in their order
        order = [i for c in clocks for i, t in enumerate(times) if t == c]
        parts = []
        for c in clocks:
            idx = [i for i, t in enumerate(times) if t == c]
            n, p, _, carries = self._run(*_rows((net, pstate), idx), c,
                                         abandon)
            parts.append(((n, p), carries))
        back = [0] * len(order)
        for pos, i in enumerate(order):
            back[i] = pos
        state = _rows(_cat([s for s, _ in parts]), back)
        carries = {plane: _rows(_cat([c[plane] for _, c in parts]), back)
                   for plane in self.planes}
        return state[0], state[1], out_times, None, carries


class CompileRegistry:
    """See module docstring.  Thread-compat: `chunk_fn` and `fused` are
    called under the scheduler's lock."""

    def __init__(self, persistent: bool = True, catalog=None,
                 device=None):
        from ..ops._build import BUILD
        #: the port's analogue of the persistent compile cache: the
        #: directory `ops/_build.py` keeps the built kernels in
        #: (``persistent`` selects nothing: the cache is always on)
        self.cache_dir = BUILD
        #: program observatory (obs/programs.ProgramCatalog; None = OFF,
        #: the default: never imported, one is-None branch)
        self.catalog = catalog
        #: where a program whose caller hands no protocol builds one
        #: (``cuda`` unless given; the scheduler always hands its own)
        self.device = device
        self._programs: dict = {}
        self._fused: dict = {}
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------- lookup

    def chunk_fn(self, spec: ScenarioSpec, plane: str | None = None,
                 proto=None) -> ChunkProgram:
        """The chunk program of a RESOLVED spec (superstep an int, the
        `ScenarioSpec.validate` output) over one obs plane (None = the
        plain engine): one lookup, a hit or a miss
        (wittgenstein_tpu/serve/registry.py:56-84).  `proto` shares a
        protocol the caller already built (the scheduler builds one a
        group)."""
        if not isinstance(spec.superstep, int):
            raise ValueError("chunk_fn needs a resolved spec "
                             "(ScenarioSpec.validate() output): "
                             f"superstep={spec.superstep!r}")
        key = (spec.compile_key(), plane)
        fn = self._programs.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        self.misses += 1
        if plane is not None and plane not in PLANES:
            raise ValueError(f"unknown obs plane {plane!r}; known: "
                             "metrics trace audit (or None)")
        cat = self.catalog
        t_build = 0.0 if cat is None else cat.now()
        if proto is None:
            from ..core.state import resolve_device
            proto = spec.build_protocol(device=resolve_device(self.device))
        fn = ChunkProgram(spec, () if plane is None else (plane,), proto)
        if cat is not None:
            from ..obs.programs import CatalogProgram
            cat.record_build(spec, plane, build_wall_s=cat.now() - t_build)
            fn = CatalogProgram(fn, cat, spec.compile_key())
        self._programs[key] = fn
        return fn

    def fused(self, spec: ScenarioSpec, programs: list) -> ChunkProgram:
        """The group's one-pass program over the planes of `programs`
        (the per-plane entries `chunk_fn` returned for this spec), on
        their protocol.  Built once per compile key and plane set; not a
        registry lookup (the accounting stays the JAX package's)."""
        planes = tuple(p for prog in programs for p in prog.planes)
        if len(programs) == 1:
            return programs[0]
        key = (spec.compile_key(), planes)
        fn = self._fused.get(key)
        if fn is None:
            fn = ChunkProgram(spec, planes, programs[0].proto)
            if self.catalog is not None:
                from ..obs.programs import CatalogProgram
                fn = CatalogProgram(fn, self.catalog, spec.compile_key())
            self._fused[key] = fn
        return fn

    def has_key(self, compile_key: str) -> bool:
        """True when ANY plane's program for this compile key is warm
        (wittgenstein_tpu/serve/registry.py:86-92)."""
        return any(k[0] == compile_key for k in self._programs)

    # ------------------------------------------------------------- export

    def stats(self) -> dict:
        return {"entries": len(self._programs), "hits": self.hits,
                "misses": self.misses,
                "persistent_cache": self.cache_dir or "off"}

    def registry_block(self, extra: dict | None = None) -> dict:
        """The ``registry`` block for bench JSON / service status, one
        flat dict (wittgenstein_tpu/serve/registry.py:175-187)."""
        out = self.stats()
        if extra:
            out.update(extra)
        return out
