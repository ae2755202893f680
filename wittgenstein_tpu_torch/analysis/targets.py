"""Analysis targets: one pinned small chunk per registered protocol — the
port's copy of `wittgenstein_tpu/analysis/targets.py`, with the same
target names and pinned configs.

A target wraps everything a rule can look at — the protocol instance,
the example seed batch, and the recording (`analysis/trace.py`) of one
chunk on it — computed lazily so source-only rules never run a chunk.
Configs are PINNED (node counts, seeds, chunk, ring sizing): the
budgets in budgets.json are measured at exactly these shapes, so a
config change here is a budget change and must be reviewed as one.

Engine selection mirrors the drivers: protocols eligible for the
seed-folded engine (spill-free, broadcast-free, superstep-ok —
core/batched.py) run `scan_chunk_batched`, everything else
`network.scan_chunk` on the seed batch.  The chunk is called as the
drivers call it, without its entry time, so it reads the batch's time
from the device once.  Each target runs its chunk once unrecorded on a
copy of the batch (the first call builds the kernel library and the
device-resident tables a model caches), then records it on another
copy.

On the ``+pallas_route`` targets the JAX package turns its Pallas
routing megakernel on; the port has one binning kernel (K1, under every
engine), so ``route_kernel`` selects nothing and those targets are the
``+ss`` engines with Handel's ``pallas_merge`` (accepted, selects
nothing) — the names are kept so the two packages' reports line up.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import _pytree as pytree

SEEDS = 2       # batched seed axis of every target
CHUNK = 8       # even, small: one chunk of the engine


def _clone(state):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def leaf_shape_names(args) -> dict[str, set]:
    """Shape string (``int32[2,64,64,12]``) -> candidate state leaf
    names, for attributing copies back to NetState / protocol-state
    fields."""
    import collections

    names = collections.defaultdict(set)

    def walk(prefix, obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                walk(f"{prefix}.{f.name}" if prefix else f.name,
                     getattr(obj, f.name))
        elif isinstance(obj, (tuple, list)):
            for i, x in enumerate(obj):
                walk(f"{prefix}[{i}]", x)
        elif isinstance(obj, dict):
            for k, x in obj.items():
                walk(f"{prefix}.{k}", x)
        elif isinstance(obj, torch.Tensor):
            names[shape_key(obj.dtype, obj.shape)].add(prefix)

    walk("", args)
    return dict(names)


def shape_key(dtype, shape) -> str:
    dt = str(dtype).replace("torch.", "")
    return f"{dt}[{','.join(str(d) for d in shape)}]"


class AnalysisTarget:
    """Lazy recording of one protocol's chunk (or one bare function).

    Attributes the rules use:
      name          — registry name
      protocol      — the instance (None for `from_fn` targets)
      args          — example (net, pstate) batch, the chunk's input
      recorder      — the `OpRecorder` of one call of the chunk
      out           — what that call returned
      leaf_names    — shape string -> state field names
      engine        — "batched" | "scan" | "fn" (and variants)
      ms            — simulated ms the chunk advances (None for fn)
    """

    def __init__(self, name, build_fn, protocol=None, engine="fn",
                 device="cpu", ms=None):
        self.name = name
        self.protocol = protocol
        self.engine = engine
        self.device = torch.device(device)
        self.ms = ms
        self._build_fn = build_fn       # (device) -> (fn, args, proto, eng)
        self._built = None
        self._recorded = None

    @classmethod
    def from_protocol(cls, name, proto_fn, seeds=SEEDS, chunk=CHUNK,
                      device="cpu"):
        """Build from a protocol factory ``proto_fn(device)``; engine
        dispatch as the drivers do (batched when eligible, else
        `network.scan_chunk` on the batch)."""

        def build(dev):
            from ..core.batched import scan_chunk_batched
            from ..core.network import scan_chunk

            proto = proto_fn(dev)
            try:
                base = scan_chunk_batched(proto, chunk, t0_mod=None)
                engine = "batched"
            except ValueError:
                base = scan_chunk(proto, chunk, superstep=1)
                engine = "scan"
            return base, _batch(proto, seeds), proto, engine

        return cls(name, build, device=device, ms=chunk)

    @classmethod
    def from_fn(cls, name, fn, args, device="cpu", ms=None):
        """Wrap an arbitrary ``fn(*args)`` (test fixtures, one-off
        audits, a full-size chunk on the card).  `args` is the example
        input; each call gets its own copy."""
        return cls(name, lambda dev: (fn, args, None, "fn"),
                   device=device, ms=ms)

    def _ensure_built(self):
        if self._built is None:
            fn, args, proto, engine = self._build_fn(self.device)
            self.protocol = proto if proto is not None else self.protocol
            self.engine = engine
            self._built = (fn, args)
        return self._built

    @property
    def args(self):
        return self._ensure_built()[1]

    def _ensure_recorded(self):
        if self._recorded is None:
            from .trace import record

            fn, args = self._ensure_built()
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            fn(*_clone(args))                       # warm-up
            rec, out = record(fn, *_clone(args), device=self.device)
            self._recorded = (rec, out)
        return self._recorded

    @property
    def recorder(self):
        return self._ensure_recorded()[0]

    @property
    def out(self):
        return self._ensure_recorded()[1]

    @functools.cached_property
    def leaf_names(self):
        return leaf_shape_names(self.args)

    def release(self):
        """Drop the batch and the recording (the CLI runs many targets
        in one process)."""
        if self._recorded is not None:
            rec, _ = self._recorded
            self._recorded = (rec, None)
        self._built = None if self._built is None else (self._built[0],
                                                        None)


def _batch(proto, seeds):
    from ..core.state import init_batched
    return init_batched(proto, torch.arange(seeds))


def _handel(dev, n=64, **kw):
    from ..models.handel import Handel

    down = n // 10
    params = dict(node_count=n, threshold=int(0.99 * (n - down)),
                  nodes_down=down, pairing_time=4, level_wait_time=50,
                  dissemination_period_ms=20, fast_path=10,
                  horizon=64, inbox_cap=12)
    params.update(kw)
    return Handel(**params, device=dev)


def _registry() -> dict:
    """name -> protocol factory ``(device) -> protocol`` at the pinned
    analysis config (the JAX package's, _registry :197-240)."""
    from ..models.avalanche import Slush, Snowflake
    from ..models.casper import CasperIMD
    from ..models.dfinity import Dfinity
    from ..models.enr import ENRGossiping
    from ..models.gsf import GSFSignature
    from ..models.handel_cardinal import HandelCardinal
    from ..models.handeleth2 import HandelEth2
    from ..models.optimistic import OptimisticP2PSignature
    from ..models.p2pflood import P2PFlood
    from ..models.paxos import Paxos
    from ..models.pingpong import PingPong
    from ..models.sanfermin import SanFermin

    return {
        "Handel": _handel,
        "HandelCardinal": lambda dev: HandelCardinal(
            node_count=64, nodes_down=6, threshold=57, pairing_time=4,
            dissemination_period_ms=20, fast_path=10, device=dev),
        "GSFSignature": lambda dev: GSFSignature(node_count=64, device=dev),
        "HandelEth2": lambda dev: HandelEth2(node_count=64, device=dev),
        "PingPong": lambda dev: PingPong(node_count=64, device=dev),
        "P2PFlood": lambda dev: P2PFlood(
            node_count=64, dead_node_count=6, peers_count=8,
            delay_before_resent=1, delay_between_sends=1, device=dev),
        "Slush": lambda dev: Slush(node_count=64, rounds=4, k=5,
                                   device=dev),
        "Snowflake": lambda dev: Snowflake(node_count=64, k=5, beta=3,
                                           device=dev),
        "Paxos": lambda dev: Paxos(acceptor_count=3, proposer_count=3,
                                   timeout=1000, device=dev),
        "OptimisticP2PSignature": lambda dev: OptimisticP2PSignature(
            node_count=64, threshold=33, connection_count=13,
            pairing_time=3, device=dev),
        "SanFermin": lambda dev: SanFermin(node_count=64, device=dev),
        "Dfinity": lambda dev: Dfinity(block_producers_count=10,
                                       attesters_count=10,
                                       attesters_per_round=10, device=dev),
        "CasperIMD": lambda dev: CasperIMD(
            cycle_length=4, block_producers_count=2,
            attesters_per_round=10, tick_ms=40, device=dev),
        "ENRGossiping": lambda dev: ENRGossiping(
            nodes=40, total_peers=5, max_peers=12,
            number_of_different_capabilities=5, cap_per_node=2,
            cap_gossip_time=500, time_to_change=5_000,
            time_to_leave=20_000, changing_nodes=0.4, device=dev),
    }


#: the JAX package's target families, names and pinned instrumentation
FF_PROTOCOLS = ("Handel", "PingPong", "P2PFlood", "Dfinity")
FF_SUFFIX = "+ff"
METRICS_PROTOCOLS = ("Handel", "PingPong", "Dfinity")
METRICS_SUFFIX = "+metrics"
FFM_PROTOCOLS = ("PingPong",)
FFM_SUFFIX = "+ffmetrics"
_METRICS_EACH_MS = 2
TRACE_PROTOCOLS = ("PingPong", "Handel")
TRACE_SUFFIX = "+trace"
_TRACE_CAP = 256
AUDIT_PROTOCOLS = ("PingPong", "Handel")
AUDIT_SUFFIX = "+audit"
CHAOS_PROTOCOLS = ("PingPong",)
CHAOS_SUFFIX = "+chaos"
MATRIX_PROTOCOLS = ("PingPong",)
MATRIX_SUFFIX = "+matrix"
_MATRIX_LATENCY = "NetworkHeterogeneousLatency(4,3,2,1)"
TENANCY_PROTOCOLS = ("PingPong",)
TENANCY_SUFFIX = "+tenancy"
JOURNAL_PROTOCOLS = ("PingPong",)
JOURNAL_SUFFIX = "+journal"
MEMO_PROTOCOLS = ("PingPong",)
MEMO_SUFFIX = "+memo"
#: superstep-K targets on a floor-rich latency model: name -> (base, K)
SS_PROTOCOLS = {
    "Handel+ss4": ("Handel", 4),
    "P2PFlood+ss4": ("P2PFlood", 4),
    "Dfinity+ss2": ("Dfinity", 2),
}
_SS_LATENCY = "NetworkFixedLatency(8)"
#: name -> (base, K, all_pallas); see the module docstring
ROUTE_PROTOCOLS = {
    "Handel+pallas_route": ("Handel", 4, True),
    "HandelCardinal+pallas_route": ("HandelCardinal", 4, False),
    "P2PFlood+pallas_route": ("P2PFlood", 4, False),
}
ROUTE_SUFFIX = "+pallas_route"


def _family(name, suffix, engine, make_run, seeds=SEEDS, chunk=CHUNK,
            device="cpu", proto_fn=None):
    """A target of one family: the base protocol from the registry (or
    `proto_fn`), its chunk from ``make_run(proto) -> fn``."""
    base_name = name[:-len(suffix)] if suffix else name

    def build(dev):
        proto = (proto_fn or _registry()[base_name])(dev)
        return make_run(proto), _batch(proto, seeds), proto, engine

    return AnalysisTarget(name, build, device=device, ms=chunk)


def _spec_target(name, spec_fn, engine, device, chunk=CHUNK):
    """A target whose protocol comes from a `ScenarioSpec`
    (``spec_fn() -> validated spec``, which also holds the family's
    static contract), run as the serve registry runs a spec's chunk."""

    def build(dev):
        from ..core.network import scan_chunk

        spec = spec_fn()
        proto = spec.build_protocol(device=dev)
        return (scan_chunk(proto, chunk, superstep=spec.superstep),
                _batch(proto, SEEDS), proto, engine)

    return AnalysisTarget(name, build, device=device, ms=chunk)


def _matrix_spec(base_name, chunk=CHUNK):
    from ..matrix import SweepGrid

    grid = SweepGrid(
        name="analysis",
        base={"protocol": base_name, "params": {"node_count": 64},
              "seeds": [0], "sim_ms": chunk, "chunk_ms": chunk, "obs": []},
        axes=({"name": "lat", "field": "latency_model",
               "values": [_MATRIX_LATENCY, None]},))
    return grid.expand()[0].spec.validate()


def _tenancy_spec(base_name, chunk=CHUNK):
    from ..serve.spec import ScenarioSpec

    spec = ScenarioSpec(
        protocol=base_name, params={"node_count": 64}, seeds=(0,),
        sim_ms=chunk, chunk_ms=chunk, obs=(), tenant="analysis",
        priority=3, deadline_ms=60_000).validate()
    bare = ScenarioSpec(protocol=base_name, params={"node_count": 64},
                        seeds=(0,), sim_ms=chunk, chunk_ms=chunk,
                        obs=()).validate()
    assert spec.compile_key() == bare.compile_key(), \
        "tenancy fields leaked into the compile key"
    return spec


def _journal_spec(base_name, chunk=CHUNK):
    """The journaled spec round-trips to the submitted digest and
    compile key (a replay re-runs exactly the accepted config)."""
    import tempfile

    from ..serve import Scheduler
    from ..serve.spec import ScenarioSpec

    spec = ScenarioSpec(protocol=base_name, params={"node_count": 64},
                        seeds=(0,), sim_ms=chunk, chunk_ms=chunk,
                        obs=()).validate()
    with tempfile.TemporaryDirectory() as jd:
        sch = Scheduler(journal_dir=jd, device="cpu",
                        ledger_path=f"{jd}/ledger.jsonl")
        sch.submit(spec)
        entries = sch.journal.replay()
        assert len(entries) == 1, entries
        stored = ScenarioSpec.from_json(entries[0]["spec"])
        assert stored.digest() == spec.digest(), \
            "journaled spec does not round-trip to the submitted digest"
        assert stored.validate().compile_key() == spec.compile_key(), \
            "journaled spec resolves to a different compile key"
    return spec


def _memo_spec(base_name, chunk=CHUNK):
    """Stripping post-fork adversity lands on the clean sibling's
    compile key, and the fork is at the schedule's first window."""
    from ..memo import first_adversity_ms, strip_adversity
    from ..serve.spec import ScenarioSpec

    adverse = ScenarioSpec(
        protocol=base_name, params={"node_count": 64}, seeds=(0,),
        sim_ms=2 * chunk, chunk_ms=chunk, obs=(),
        fault_schedule={"loss": [[chunk, 2 * chunk, 500, 0, 64, 0, 64]]}
    ).validate()
    clean = ScenarioSpec(protocol=base_name, params={"node_count": 64},
                         seeds=(0,), sim_ms=2 * chunk, chunk_ms=chunk,
                         obs=()).validate()
    prefix = strip_adversity(adverse)
    assert prefix.compile_key() == clean.compile_key(), \
        "stripping post-fork adversity must land on the clean sibling's " \
        "compile key"
    assert first_adversity_ms(adverse) == chunk
    return prefix


def _chaos_proto(dev, chunk=CHUNK):
    from ..chaos import ChaosProtocol, FaultSchedule

    inner = _registry()["PingPong"](dev)
    n = inner.cfg.n
    return ChaosProtocol(inner, FaultSchedule(
        churn=((1, 2, 6),),
        partitions=((2, 6, 1, 0, max(1, n // 2)),),
        loss=((0, chunk, 250, 0, n, 0, n),),
        delay=((2, 6, 1, 0, n, 0, n),)))


def _ss_proto(base_name, dev, all_pallas=False):
    if base_name == "Handel":
        kw = dict(network_latency_name=_SS_LATENCY)
        if all_pallas:
            kw["pallas_merge"] = True
        return _handel(dev, **kw)
    if base_name == "HandelCardinal":
        from ..models.handel_cardinal import HandelCardinal
        return HandelCardinal(
            node_count=64, nodes_down=6, threshold=57, pairing_time=4,
            dissemination_period_ms=20, fast_path=10,
            network_latency_name=_SS_LATENCY, device=dev)
    if base_name == "P2PFlood":
        from ..models.p2pflood import P2PFlood
        return P2PFlood(node_count=64, dead_node_count=6, peers_count=8,
                        delay_before_resent=1, delay_between_sends=1,
                        network_latency_name=_SS_LATENCY, device=dev)
    return _registry()[base_name](dev)


def _ss_target(name, base_name, k, device, all_pallas=False,
               chunk=CHUNK) -> AnalysisTarget:
    def build(dev):
        from ..core.batched import scan_chunk_batched
        from ..core.network import scan_chunk

        proto = _ss_proto(base_name, dev, all_pallas)
        try:
            base = scan_chunk_batched(proto, chunk, superstep=k)
            engine = f"batched+ss{k}"
        except ValueError:
            base = scan_chunk(proto, chunk, superstep=k)
            engine = f"scan+ss{k}"
        return base, _batch(proto, SEEDS), proto, engine

    t = AnalysisTarget(name, build, device=device, ms=chunk)
    t.ms_per_iter = k
    return t


def _plane_run(kind):
    """``make_run(proto)`` of an obs-plane family."""
    from .. import obs

    def run(proto):
        if kind == "metrics":
            spec = obs.MetricsSpec(stat_each_ms=_METRICS_EACH_MS)
            try:
                return obs.scan_chunk_batched_metrics(proto, CHUNK, spec)
            except ValueError:
                return obs.scan_chunk_metrics(proto, CHUNK, spec)
        if kind == "ffmetrics":
            from ..core.network import fast_forward_ok
            assert fast_forward_ok(proto)
            return obs.fast_forward_chunk_metrics(
                proto, CHUNK, obs.MetricsSpec(stat_each_ms=_METRICS_EACH_MS),
                seed_axis=True)
        if kind == "trace":
            return obs.scan_chunk_trace(proto, CHUNK,
                                        obs.TraceSpec(capacity=_TRACE_CAP))
        if kind == "audit":
            return obs.scan_chunk_audit(proto, CHUNK, obs.AuditSpec())
        from ..core.network import fast_forward_chunk, fast_forward_ok
        assert fast_forward_ok(proto)
        return fast_forward_chunk(proto, CHUNK, seed_axis=True)
    return run


@functools.lru_cache(maxsize=1)
def target_names() -> tuple:
    return tuple(sorted(_registry()) +
                 sorted(f"{n}{FF_SUFFIX}" for n in FF_PROTOCOLS) +
                 sorted(f"{n}{METRICS_SUFFIX}" for n in METRICS_PROTOCOLS) +
                 sorted(f"{n}{FFM_SUFFIX}" for n in FFM_PROTOCOLS) +
                 sorted(f"{n}{TRACE_SUFFIX}" for n in TRACE_PROTOCOLS) +
                 sorted(f"{n}{AUDIT_SUFFIX}" for n in AUDIT_PROTOCOLS) +
                 sorted(f"{n}{CHAOS_SUFFIX}" for n in CHAOS_PROTOCOLS) +
                 sorted(f"{n}{MATRIX_SUFFIX}" for n in MATRIX_PROTOCOLS) +
                 sorted(f"{n}{TENANCY_SUFFIX}"
                        for n in TENANCY_PROTOCOLS) +
                 sorted(f"{n}{MEMO_SUFFIX}" for n in MEMO_PROTOCOLS) +
                 sorted(f"{n}{JOURNAL_SUFFIX}"
                        for n in JOURNAL_PROTOCOLS) +
                 sorted(SS_PROTOCOLS) + sorted(ROUTE_PROTOCOLS))


#: suffix -> (family protocols, engine label, plane kind or spec maker)
_PLANES = {
    FFM_SUFFIX: (FFM_PROTOCOLS, "fast_forward+metrics", "ffmetrics"),
    METRICS_SUFFIX: (METRICS_PROTOCOLS, "metrics", "metrics"),
    TRACE_SUFFIX: (TRACE_PROTOCOLS, "scan+trace", "trace"),
    AUDIT_SUFFIX: (AUDIT_PROTOCOLS, "scan+audit", "audit"),
    FF_SUFFIX: (FF_PROTOCOLS, "fast_forward", "ff"),
}
_SPECS = {
    MATRIX_SUFFIX: (MATRIX_PROTOCOLS, "scan+matrix", _matrix_spec),
    TENANCY_SUFFIX: (TENANCY_PROTOCOLS, "scan+tenancy", _tenancy_spec),
    MEMO_SUFFIX: (MEMO_PROTOCOLS, "scan+memo", _memo_spec),
    JOURNAL_SUFFIX: (JOURNAL_PROTOCOLS, "scan+journal", _journal_spec),
}


def _known(name, suffix, protos):
    """The base protocol of a family target, or KeyError."""
    base = name[:-len(suffix)]
    if base not in protos:
        raise KeyError(f"unknown {suffix[1:]} target {name!r}; known: "
                       f"{sorted(p + suffix for p in protos)}")
    return base


def get_target(name: str, device="cpu") -> AnalysisTarget:
    if name in SS_PROTOCOLS:
        return _ss_target(name, *SS_PROTOCOLS[name], device=device)
    if name in ROUTE_PROTOCOLS:
        base, k, all_pallas = ROUTE_PROTOCOLS[name]
        return _ss_target(name, base, k, device, all_pallas=all_pallas)
    if name.endswith(ROUTE_SUFFIX):
        raise KeyError(f"unknown pallas-route target {name!r}; known: "
                       f"{sorted(ROUTE_PROTOCOLS)}")
    for suffix, (protos, engine, make) in _SPECS.items():
        if name.endswith(suffix):
            base = _known(name, suffix, protos)
            return _spec_target(name, lambda: make(base), engine, device)
    if name.endswith(CHAOS_SUFFIX):
        _known(name, CHAOS_SUFFIX, CHAOS_PROTOCOLS)
        from ..core.network import scan_chunk
        return _family(name, CHAOS_SUFFIX, "scan+chaos",
                       lambda proto: scan_chunk(proto, CHUNK),
                       device=device, proto_fn=_chaos_proto)
    for suffix, (protos, engine, kind) in _PLANES.items():
        if name.endswith(suffix):
            _known(name, suffix, protos)
            return _family(name, suffix, engine, _plane_run(kind),
                           device=device)
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown analysis target {name!r}; "
                       f"known: {sorted(target_names())}")
    return AnalysisTarget.from_protocol(name, reg[name], device=device)
