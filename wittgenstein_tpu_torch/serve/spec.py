"""`ScenarioSpec` — the serializable unit of work of the request
plane: the port of `wittgenstein_tpu/serve/spec.py` (schema 4, every
field), so that a spec, its canonical JSON, its digest and its compile
key are the same in both packages.

One spec describes one scenario run end to end: protocol + constructor
parameters (validated against the server's `protocol_parameters`
template), engine variant, superstep K, the simulated span and its
chunking, the obs planes to capture, an optional attack (a planted
`FaultInjector` perturbation), partition (nodes down at entry) and
fault schedule, and the seed list.

  `canonical_json()` — the wire/storage form: sorted keys, compact
      separators (`from_json` round-trips it);
  `digest()`         — short content digest of the FULL canonical form
      (`obs/ledger.digest`);
  `compile_key()`    — digest over exactly the program-affecting subset.

Validation (`validate()`) refuses a bad spec with remedy text, through
the port's own gates: the parameter template (`server/core.py`),
`check_chunk_config` and `pick_superstep`.  The device is not part of a
spec: `build_protocol(device=...)` takes it beside the spec, so digests
do not depend on where a run goes, and `validate` builds the protocol
on the CPU (it reads only its configuration).  `route_kernel` stays in
the digest and the compile key, but selects nothing in the port: a
CUDA tensor always runs the binning kernel (`ops/route.py`), a CPU
tensor its plain version.
"""

from __future__ import annotations

import dataclasses
import json

#: spec schema version (bump on field changes; readers key on it).
#: 2: + `latency_model` (registry-validated, program-affecting)
#: and `route_kernel` ("xla" | "pallas" — the WTPU_PALLAS_ROUTE knob
#: as a per-spec program field); digests of schema-1 specs change.
#: 3: + `fault_schedule` (a `chaos.FaultSchedule` JSON object —
#: churn/partition/loss/delay adversity as data; program-affecting:
#: the `ChaosProtocol` wrap is part of the compiled program, so it
#: folds into BOTH digest and compile_key).  The entry-only
#: `partition` field (nodes down at entry) keeps its data-only role;
#: mid-run partition/heal windows live in the schedule.
#: 4: + the tenancy trio `tenant` / `priority` / `deadline_ms`
#: — pure SCHEDULING metadata (admission control, weighted-fair
#: queueing, checkpoint-preemption in serve/scheduler.py).  They are
#: in the digest (two requests with different urgency are different
#: requests, and the ledger must say so) but NEVER in the compile key:
#: tenancy must not split the coalesced program — a campaign cell and
#: an interactive request over the same program share one compiled
#: chunk (the `PingPong+tenancy` analysis target pins zero compiled
#: residue).
SCHEMA = 4

#: the JAX package's routing-kernel selection (its Pallas binning
#: megakernel or its XLA path); carried for digest equality, selects
#: nothing in the port
ROUTE_KERNELS = ("xla", "pallas")

#: engine variants the registry can build a chunk program for
ENGINES = ("vmapped", "batched", "fast_forward")

#: observability planes a request may capture (one pass each — the
#: planes are separate carries; the scheduler advances state with the
#: metrics pass and runs the others as bit-identical shadow passes)
OBS_PLANES = ("metrics", "trace", "audit")

#: attack config keys (an `obs.diff.FaultInjector` perturbation)
ATTACK_KEYS = ("at_ms", "leaf", "node", "delta")


def _err(msg: str) -> ValueError:
    return ValueError(f"ScenarioSpec: {msg}")


def int_env(name: str, default: int, env=None,
            prefix: str = "config") -> int:
    """THE tolerant scalar-int env read (one definition — bench.py's
    `_int_env` delegates here, so the knob parsing the one-config-path
    contract depends on cannot silently fork): a malformed or
    non-positive override warns and falls back to `default` instead of
    crashing the caller before it emits its metric line.  Every WTPU
    scalar knob is a count (nodes, seeds, ms, caps, reps)."""
    import os
    import sys

    raw = (os.environ if env is None else env).get(name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError as e:
        print(f"{prefix}: ignoring malformed {name}={raw!r} ({e}); "
              f"using {default}", file=sys.stderr)
        return default
    if val <= 0:
        print(f"{prefix}: ignoring malformed {name}={raw!r}; using "
              f"{default}", file=sys.stderr)
        return default
    return val


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One scenario request (frozen; see the module docstring)."""

    protocol: str                                   # registry class name
    params: dict = dataclasses.field(default_factory=dict)
    seeds: tuple = (0,)
    sim_ms: int = 1000
    chunk_ms: int = 200          # per-program scan length = join boundary
    engine: str = "vmapped"
    superstep: object = 1        # int, or "auto" (resolved by validate())
    obs: tuple = ("metrics",)
    stat_each_ms: int = 10
    trace_capacity: int = 1 << 16
    attack: dict | None = None   # {"at_ms", "leaf", "node", "delta"}
    partition: tuple = ()        # node ids down at entry (data, not program)
    latency_model: str | None = None   # registry name; None = protocol default
    route_kernel: str = "xla"    # "xla" | "pallas" (selects nothing here)
    #: chaos.FaultSchedule JSON: churn [[node, down, up]], partitions
    #: [[start, end, pid, lo, hi]], loss/delay windows — mid-run
    #: adversity as data (program-affecting; schema 3)
    fault_schedule: dict | None = None
    #: --- tenancy trio (schema 4): scheduling metadata, digest-only —
    #: NEVER in the compile key (tenancy must not split the coalesced
    #: program; see the SCHEMA note above)
    tenant: str = "default"      # admission/fairness bucket
    priority: int = 0            # higher preempts lower at chunk bounds
    deadline_ms: int | None = None   # wall-clock budget from submit; a
    #: request past its deadline stops holding the device against
    #: waiting tenants (soft — never killed, only demoted)
    schema: int = SCHEMA

    def __post_init__(self):
        # normalize collection fields so equality/serialization are a
        # pure function of the VALUES (canonical obs order, int seeds)
        object.__setattr__(self, "params", dict(self.params or {}))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        unknown_obs = set(self.obs) - set(OBS_PLANES)
        if unknown_obs:
            # same rationale as from_json's unknown-field refusal: a
            # typo'd plane silently dropped would run unobserved and
            # digest as a config the requester never meant
            raise _err(f"unknown obs plane(s) {sorted(unknown_obs)}; "
                       f"known: {OBS_PLANES}")
        object.__setattr__(
            self, "obs",
            tuple(p for p in OBS_PLANES if p in set(self.obs)))
        object.__setattr__(self, "partition",
                           tuple(sorted(int(n) for n in self.partition)))
        if self.attack is not None:
            object.__setattr__(self, "attack", dict(self.attack))
        if self.route_kernel not in ROUTE_KERNELS:
            # same rationale as the unknown-obs refusal: a typo'd
            # kernel silently coerced would compile a program the
            # requester never meant (and mislabel the A/B)
            raise _err(f"unknown route_kernel {self.route_kernel!r}; "
                       f"known: {ROUTE_KERNELS}")
        # tenancy trio: refused at CONSTRUCTION like route_kernel/obs —
        # a malformed tenancy field silently coerced would admit a
        # request under the wrong budget (or digest a config the
        # requester never meant)
        if not isinstance(self.tenant, str) or not self.tenant:
            raise _err(f"tenant must be a non-empty string, got "
                       f"{self.tenant!r}")
        if isinstance(self.priority, bool) or \
                not isinstance(self.priority, int):
            raise _err(f"priority must be an int (higher preempts "
                       f"lower), got {self.priority!r}")
        if self.deadline_ms is not None:
            if isinstance(self.deadline_ms, bool) or \
                    not isinstance(self.deadline_ms, int) or \
                    self.deadline_ms < 1:
                raise _err(f"deadline_ms must be a positive int of "
                           f"wall-clock ms from submit (or None), got "
                           f"{self.deadline_ms!r}")
        if self.fault_schedule is not None:
            # normalize through the schedule's own canonical form so
            # equal adversity always digests equal (key order, empty
            # fault classes, int coercion); a malformed schedule is
            # refused at construction with the schedule's remedy text
            # (unknown fault classes, wrong arity — the 400 path)
            from ..chaos import FaultSchedule
            try:
                canon = FaultSchedule.from_json(self.fault_schedule)
            except ValueError as e:
                raise _err(str(e)) from None
            object.__setattr__(self, "fault_schedule",
                               canon.to_json() if not canon.empty
                               else None)

    # ------------------------------------------------------- serialization

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["seeds"] = list(self.seeds)
        out["obs"] = list(self.obs)
        out["partition"] = list(self.partition)
        return out

    def canonical_json(self) -> str:
        """Stable wire form: sorted keys, compact separators."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, data) -> "ScenarioSpec":
        """Inverse of `to_json`/`canonical_json` (dict or JSON string).
        Unknown keys are refused with the known field list — a typo'd
        field silently dropped would digest as a DIFFERENT config than
        the requester meant."""
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        if not isinstance(data, dict):
            raise _err(f"expected a JSON object, got {type(data).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise _err(f"unknown field(s) {sorted(unknown)}; known fields: "
                       f"{sorted(known)}")
        if "protocol" not in data:
            raise _err("missing required field 'protocol' (a registered "
                       "protocol class name; GET /w/protocols lists them)")
        kw = dict(data)
        for key in ("seeds", "obs", "partition"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    # ------------------------------------------------------------- digests

    def digest(self) -> str:
        """Content digest of the FULL spec — the ledger's config digest
        (one source of truth: bench, suite and serve all record it)."""
        from ..obs.ledger import digest
        return digest(self.to_json())

    def compile_key(self) -> str:
        """Digest of the program-affecting subset (module docstring).
        Resolves ``superstep="auto"`` first — two specs must never
        share a key while compiling different window sizes."""
        spec = self if isinstance(self.superstep, int) else self.validate()
        from ..obs.ledger import digest
        return digest({
            "schema": spec.schema,
            "protocol": spec.protocol,
            "params": spec.params,
            "chunk_ms": spec.chunk_ms,
            "engine": spec.engine,
            "superstep": spec.superstep,
            "obs": list(spec.obs),
            "stat_each_ms": spec.stat_each_ms
            if "metrics" in spec.obs else None,
            "trace_capacity": spec.trace_capacity
            if "trace" in spec.obs else None,
            "attack": spec.attack,
            "latency_model": spec.latency_model,
            "route_kernel": spec.route_kernel,
            # the ChaosProtocol wrap is compiled into the chunk program
            # (window-entry fault application + outbox adversaries), so
            # two specs differing only in adversity must never coalesce
            "fault_schedule": spec.fault_schedule,
            # tenant/priority/deadline_ms are DELIBERATELY absent:
            # tenancy is scheduling metadata, and splitting the compile
            # key on it would un-coalesce programs that are identical
            # on device (schema-4 note at the top of this module)
        })

    # ---------------------------------------------------------- validation

    def validate(self, device="cpu") -> "ScenarioSpec":
        """Full refusal-with-remedy validation; returns the RESOLVED
        spec (``superstep`` always an int) on success.

        Reuses the single sources of truth instead of restating them:
        parameter names go through `server.core.validate_parameters`
        (the `protocol_parameters` template), engine eligibility
        through `check_chunk_config` (raising, remedy text) and
        `pick_superstep` ("auto" resolution).  The protocol it judges
        is built on `device` (the CPU: only its configuration is
        read)."""
        from ..core.network import (check_chunk_config, fast_forward_ok,
                                    pick_superstep)
        from ..server.core import validate_parameters

        if self.latency_model is not None:
            # validated against the registered models (core/latency.py
            # get_by_name — the reference's RegistryNetworkLatencies)
            # BEFORE the protocol builds: an unknown name must 400
            # with the registry hint, not surface as a deep KeyError
            from ..core.latency import get_by_name
            if "network_latency_name" in self.params:
                raise _err(
                    "latency_model and params['network_latency_name'] "
                    "both set: one latency selection per spec (the "
                    "field is the canonical spelling; drop the param)")
            try:
                get_by_name(self.latency_model)
            except (KeyError, ValueError) as e:
                raise _err(
                    f"unknown latency_model {self.latency_model!r}: {e} "
                    "(registered: NetworkFixedLatency(ms), "
                    "NetworkUniformLatency(max), "
                    "NetworkHeterogeneousLatency(base,spread,skew[,seed])"
                    ", NetworkCSVLatency(path.csv), class names from "
                    "core/latency.py, e.g. "
                    "NetworkLatencyByDistanceWJitter)") from None
        validate_parameters(self.protocol, self._effective_params())
        if self.engine not in ENGINES:
            raise _err(f"unknown engine {self.engine!r}; known: {ENGINES}")
        if not self.seeds:
            raise _err("seeds must be a non-empty list of ints (each seed "
                       "is one simulated run; they batch into one vmapped "
                       "program)")
        if len(set(self.seeds)) != len(self.seeds):
            raise _err(f"duplicate seeds {list(self.seeds)}: each seed is "
                       "one run; submit a second request for repeats")
        if self.sim_ms < 1 or self.chunk_ms < 1:
            raise _err(f"sim_ms ({self.sim_ms}) and chunk_ms "
                       f"({self.chunk_ms}) must be >= 1")
        if self.sim_ms % self.chunk_ms:
            raise _err(
                f"sim_ms={self.sim_ms} is not a multiple of chunk_ms="
                f"{self.chunk_ms}: the scheduler admits/retires requests "
                "only on chunk boundaries. Fix: pick sim_ms a multiple "
                "of chunk_ms (or shrink chunk_ms)")
        if self.attack is not None:
            bad = set(self.attack) - set(ATTACK_KEYS)
            missing = {"at_ms", "leaf", "node"} - set(self.attack)
            if bad or missing:
                raise _err(f"attack config takes keys {ATTACK_KEYS} "
                           f"(at_ms/leaf/node required); got "
                           f"{sorted(self.attack)}")
        proto = self.build_protocol(wrap_attack=False, device=device)
        n = proto.cfg.n
        if self.fault_schedule is not None:
            # full refusal-with-remedy pass over the adversity windows
            # (overlapping partition claims, out-of-range nodes/links,
            # windows outside the simulated span) — the 400 path for
            # mid-run partition/endPartition as data
            from ..chaos import FaultSchedule
            try:
                fs = FaultSchedule.from_json(self.fault_schedule)
                fs.validate(n=n, sim_ms=self.sim_ms)
            except ValueError as e:
                raise _err(str(e)) from None
            clash = sorted({node for node, _, _ in fs.churn}
                           & set(self.partition))
            if clash:
                # churn OWNS its named nodes' down flag (a stateless
                # function of t — outside an outage window the node is
                # UP, entry included), so a node both down-at-entry and
                # churn-managed would be silently revived at ms 0
                raise _err(
                    f"node(s) {clash} appear in both `partition` (down "
                    "at entry) and the fault_schedule's churn: churn "
                    "owns its nodes' liveness for the whole run, which "
                    "would override the entry outage. Fix: express the "
                    "entry outage as a churn window starting at ms 0 "
                    "(e.g. [node, 0, up_ms]), or drop the node from "
                    "`partition`")
        bad_nodes = [i for i in self.partition if not 0 <= i < n]
        if bad_nodes:
            raise _err(f"partition node id(s) {bad_nodes} out of range "
                       f"for a {n}-node network")
        if self.attack is not None:
            # an out-of-range plant would be silently dropped by jax's
            # out-of-bounds scatter semantics — the requester would read
            # "audit clean" as "the protocol survived the fault" when
            # nothing was ever injected
            anode, ams = int(self.attack["node"]), int(self.attack["at_ms"])
            if not 0 <= anode < n:
                raise _err(f"attack node {anode} out of range for a "
                           f"{n}-node network")
            if not 0 <= ams < self.sim_ms:
                raise _err(f"attack at_ms={ams} outside the simulated "
                           f"span [0, {self.sim_ms}): the fault would "
                           "never fire")
        # --- engine eligibility: the engine's OWN gates do the judging
        if self.superstep == "auto":
            k = pick_superstep(
                proto, self.chunk_ms, t0=0,
                also_divides=self.stat_each_ms
                if "metrics" in self.obs else None)
            if self.engine == "batched":
                k = max(k, 2)       # the batched engine's floor is K=2
        else:
            try:
                k = int(self.superstep)
            except (TypeError, ValueError):
                raise _err(f"superstep must be an int or 'auto', got "
                           f"{self.superstep!r}") from None
        if self.engine == "batched" and k < 2:
            raise _err("the batched engine is hard-wired to fused K-ms "
                       "windows: pass superstep >= 2 (or 'auto') with "
                       "engine='batched', or use engine='vmapped'")
        if self.engine == "fast_forward" and not fast_forward_ok(proto):
            raise _err(
                f"engine='fast_forward' needs a spill-free protocol that "
                f"implements the next_action_time oracle; "
                f"{self.protocol} does not qualify (spill_cap="
                f"{proto.cfg.spill_cap}, oracle="
                f"{getattr(proto, 'next_action_time', None) is not None})."
                " Fix: engine='vmapped' (dense scan) for this protocol")
        # raises with the engine's remedy text on any violation
        check_chunk_config(proto, self.chunk_ms, superstep=k,
                           fast_forward=self.engine == "fast_forward")
        if "metrics" in self.obs:
            if self.stat_each_ms < 1:
                raise _err(f"stat_each_ms must be >= 1, got "
                           f"{self.stat_each_ms}")
            if self.chunk_ms % self.stat_each_ms:
                raise _err(
                    f"chunk_ms={self.chunk_ms} is not a multiple of "
                    f"stat_each_ms={self.stat_each_ms}: per-chunk metrics "
                    "carries stitch only on interval boundaries "
                    "(obs/export.MetricsFrame.from_carries). Fix: pick "
                    "stat_each_ms dividing chunk_ms")
            if k > 1 and self.stat_each_ms % k:
                raise _err(
                    f"superstep={k} windows must never straddle a "
                    f"stat_each_ms={self.stat_each_ms} row. Fix: pick "
                    f"stat_each_ms a multiple of {k}, or a smaller "
                    "superstep")
        if "trace" in self.obs and self.trace_capacity < self.sim_ms:
            # the bench's WTPU_TRACE_CAP refusal, spec edition: a ring
            # under one row per simulated ms truncates from the first
            # busy stretch and the artifact would read as "quiet run"
            raise _err(
                f"trace_capacity={self.trace_capacity} over sim_ms="
                f"{self.sim_ms} cannot hold one event row per simulated "
                f"ms: the ring would truncate silently. Fix: raise "
                f"trace_capacity to >= {self.sim_ms}, lower sim_ms, or "
                "drop the 'trace' plane")
        return dataclasses.replace(self, superstep=k)

    # ------------------------------------------------------------ builders

    def _effective_params(self) -> dict:
        """Constructor params with the `latency_model` field folded in
        as the protocols' `network_latency_name` kwarg (one latency
        selection path; protocols that do not take the kwarg refuse
        through the parameter template, naming it)."""
        if self.latency_model is None:
            return self.params
        return {**self.params, "network_latency_name": self.latency_model}

    def build_protocol(self, wrap_attack: bool = True, device=None):
        """Instantiate the protocol (plus the `FaultInjector` wrap when
        an attack is configured, plus the `ChaosProtocol` wrap when a
        fault schedule is — both wraps are part of the compiled
        program, which is why `attack` AND `fault_schedule` are in the
        compile key).  The chaos wrap is outermost and always applied
        (it carries the engine-gating `chaos_schedule` attribute the
        superstep/fast-forward eligibility checks consult), so the
        `wrap_attack=False` validation build judges the same program
        shape the scheduler runs.  The protocol is built on `device`
        (``cuda`` unless given, as everywhere in the port)."""
        from ..core.protocol import get_protocol
        from ..server.core import load_models

        load_models()
        proto = get_protocol(self.protocol)(**self._effective_params(),
                                            device=device)
        if wrap_attack and self.attack is not None:
            from ..obs.diff import FaultInjector
            proto = FaultInjector(proto, at_ms=int(self.attack["at_ms"]),
                                  leaf=str(self.attack["leaf"]),
                                  node=int(self.attack["node"]),
                                  delta=self.attack.get("delta", 1))
        if self.fault_schedule is not None:
            from ..chaos import ChaosProtocol, FaultSchedule
            proto = ChaosProtocol(
                proto, FaultSchedule.from_json(self.fault_schedule))
        return proto

    # ------------------------------------------------------- env capture

    @classmethod
    def from_env(cls, env=None) -> "ScenarioSpec":
        """The bench's env-flag soup as ONE spec (`bench.py` constructs
        this internally and reads its config back out of it, so bench,
        bench_suite and serve share one config path and the ledger's
        config digest is the spec digest).  Pure capture — tolerant of
        malformed values exactly like `bench._int_env` (a bad override
        must not kill the metric line) and never validated here (the
        bench's own setup raises where refusal is the right behavior).
        One exception: an unknown WTPU_LATENCY name refuses loudly —
        see the capture below — because tolerance there would DIGEST a
        model the run never used.
        The capture records the REQUESTED config (e.g. an "auto"
        superstep before resolution, the default batched-engine
        preference): equal digests imply equal programs because the
        bench's demotions are deterministic functions of the request;
        the resolved dispatch the run actually took lands in the
        manifest's own `engine`/`superstep` fields, which bench fills
        from the setup's honest labels."""
        import os

        env = os.environ if env is None else env

        def _int(name, default):
            return int_env(name, default, env=env, prefix="bench")

        proto_sel = env.get("WTPU_BENCH_PROTO", "handel")
        n = _int("WTPU_BENCH_NODES", 2048)
        mode = env.get("WTPU_BENCH_MODE", "exact")
        if proto_sel == "pingpong":
            protocol, params = "PingPong", {"node_count": n}
        elif proto_sel == "dfinity":
            protocol, params = "Dfinity", {}
        elif proto_sel == "p2pflood":
            # mirrors bench_quiet's construction (the routing-kernel
            # A/B workload)
            protocol = "P2PFlood"
            params = {"node_count": n, "dead_node_count": n // 10,
                      "peers_count": 8, "delay_before_resent": 1,
                      "delay_between_sends": 1}
        else:
            # Unknown proto_sel values also land here; bench.py routes
            # them to bench_quiet, whose refusal fires BEFORE any
            # ledger append — no mislabeled row.
            protocol = "Handel"
            params = {"node_count": n, "mode": mode,
                      "horizon": _int("WTPU_BENCH_HORIZON", 256),
                      "inbox_cap": _int("WTPU_BENCH_INBOX", 12)}
            # Every additional program-affecting WTPU knob bench.py's
            # _handel_setup consumes folds into the digest WHEN SET (an
            # unset knob stays absent, so bench and serve specs for the
            # same plain config still digest equal) — two runs of
            # genuinely different programs must never collide on
            # config_digest.  Values fold with the TYPE the setup
            # parses them to (ints/bools, matching the ctor kwargs a
            # serve spec would carry), never as raw env strings —
            # '16' vs 16 must not split the digest of one config.
            str_knobs = (("WTPU_BENCH_LATENCY", "network_latency_name"),
                         ("WTPU_BENCH_EMISSION", "emission_mode"),
                         ("WTPU_BENCH_DONATE", "donate"))
            int_knobs = (("WTPU_BENCH_QUEUE", "queue_cap", 16),
                         ("WTPU_BENCH_STATE_SPLIT", "state_split", 1),
                         ("WTPU_BENCH_BOX_SPLIT", "box_split", 1),
                         ("WTPU_BENCH_SEED_BATCH", "seed_batch", 16))
            bool_knobs = (("WTPU_BENCH_POOL", "snapshot_pool", "1"),
                          ("WTPU_BENCH_PALLAS", "pallas_merge", "1"),
                          ("WTPU_BENCH_SPEC", "phase_spec", "not0"),
                          ("WTPU_PLANE_BARRIER", "plane_barrier",
                           "not0"))
            for var, key in str_knobs:
                if env.get(var) is not None:
                    params[key] = env[var]
            for var, key, dflt in int_knobs:
                if env.get(var) is not None:
                    params[key] = _int(var, dflt)
            for var, key, truth in bool_knobs:
                if env.get(var) is not None:
                    params[key] = (env[var] != "0" if truth == "not0"
                                   else env[var] == "1")
        if protocol != "Handel" and env.get("WTPU_BENCH_LATENCY"):
            # the quiet/flood protocols honor the legacy latency
            # spelling too (bench_quiet builds with it), so it is
            # program-affecting for EVERY branch and must fold into
            # the digest exactly like the Handel str_knobs above
            params["network_latency_name"] = env["WTPU_BENCH_LATENCY"]
        raw_ss = env.get("WTPU_SUPERSTEP")
        if raw_ss == "auto":
            superstep = "auto"
        elif raw_ss is not None:
            superstep = _int("WTPU_SUPERSTEP", 2)
        else:
            superstep = _int("WTPU_BENCH_SUPERSTEP", 2)
        fast_forward = env.get("WTPU_FAST_FORWARD") == "1"
        batched = (env.get("WTPU_BENCH_BATCHED") or "1") == "1"
        # bench_quiet (pingpong/dfinity) only ever dispatches the dense
        # vmapped or fast-forward engines — recording "batched" for
        # those would digest a run that never happens.
        if protocol == "Handel":
            engine = ("fast_forward" if fast_forward else
                      "batched" if batched and superstep != 1
                      else "vmapped")
        else:
            engine = "fast_forward" if fast_forward else "vmapped"
        obs = []
        if env.get("WTPU_METRICS", "1") != "0":
            obs.append("metrics")
        if env.get("WTPU_TRACE") == "1":
            obs.append("trace")
        if env.get("WTPU_AUDIT", "1") != "0":
            obs.append("audit")
        sim_ms = _int("WTPU_BENCH_MS", 1000)
        chunk = _int("WTPU_BENCH_CHUNK", 200)
        # WTPU_CHAOS carries a FaultSchedule as inline JSON — program-
        # affecting (the ChaosProtocol wrap), so it must fold into the
        # digest when set.  Tolerant like every capture here: a
        # malformed value warns and is dropped (bench's own chaos
        # block refuses loudly before any ledger append).
        fault_schedule = None
        chaos_raw = env.get("WTPU_CHAOS")
        if chaos_raw and chaos_raw != "0":
            import sys
            try:
                from ..chaos import FaultSchedule
                canon = FaultSchedule.from_json(chaos_raw)
                fault_schedule = canon.to_json() if not canon.empty \
                    else None
            except (ValueError, TypeError) as e:
                print(f"bench: ignoring malformed WTPU_CHAOS: {e}",
                      file=sys.stderr)
        # WTPU_LATENCY selects the run's latency model by registry name
        # and is captured into the spec FIELD (the canonical spelling,
        # like the WTPU_CHAOS capture above), so the ledger row records
        # the model the run actually used.  Unlike the other captures
        # this one refuses LOUDLY on an unknown name: get_by_name's
        # fallback-to-default would otherwise run the distance model
        # while the digest claimed the requested one — a silently
        # mislabeled ledger row, worse than no metric line.
        latency_model = None
        lat_raw = env.get("WTPU_LATENCY")
        if lat_raw and lat_raw != "0":
            if env.get("WTPU_BENCH_LATENCY") is not None:
                raise _err(
                    "WTPU_LATENCY and WTPU_BENCH_LATENCY both set: one "
                    "latency selection per run (WTPU_LATENCY is the "
                    "canonical spelling; the legacy WTPU_BENCH_LATENCY "
                    "feeds params directly)")
            from ..core.latency import get_by_name
            try:
                get_by_name(lat_raw)
            except (KeyError, ValueError) as e:
                raise _err(
                    f"unknown WTPU_LATENCY {lat_raw!r}: {e} — refusing "
                    "to digest a latency model the run would not use "
                    "(registered: NetworkFixedLatency(ms), "
                    "NetworkUniformLatency(max), "
                    "NetworkHeterogeneousLatency(base,spread,skew[,seed])"
                    ", class names from core/latency.py)") from None
            latency_model = lat_raw
        return cls(
            latency_model=latency_model,
            fault_schedule=fault_schedule,
            protocol=protocol, params=params,
            seeds=tuple(range(_int("WTPU_BENCH_SEEDS", 16))),
            sim_ms=max(1, -(-sim_ms // chunk)) * chunk,   # chunk-rounded,
            chunk_ms=chunk,               # like the bench's own accounting
            engine=engine, superstep=superstep, obs=tuple(obs),
            stat_each_ms=_int("WTPU_METRICS_EACH_MS", 10),
            trace_capacity=_int("WTPU_TRACE_CAP", 1 << 16),
            # the JAX package's routing-kernel knob, recorded so the
            # digest equals its digest of the same env (selects nothing
            # in the port)
            route_kernel="pallas"
            if env.get("WTPU_PALLAS_ROUTE", "0") != "0" else "xla")
