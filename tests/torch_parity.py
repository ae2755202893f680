"""Shared helpers of the `tests/test_torch_*.py` parity tests: the JAX
package's state as nested numpy dicts, a leaf-by-leaf comparison that
names the first difference, and the generators of the artifacts the
port ships (the distance-latency table, the 2048-node Handel golden
digest, the 4096-node GSF golden digest, the per-seed digests of the
benchmark headline's 16-seed batch, the 1000-node PingPong's digest
and per-seed harness digests, the per-seed digests of a 4-seed batch of
the 4096-node GSF, and the JAX fast-forward engine's skip counts on two
PingPong runs).

Regenerate the first three with ``JAX_PLATFORMS=cpu python
tests/torch_parity.py`` (``... tests/torch_parity.py gsf-golden`` for the
GSF digest alone, ``... headline-golden`` for the headline's, about 5
minutes and 4.5 GB of JAX on the CPU, ``... pingpong-golden`` for the
1000-node PingPong's two, about a minute, ``... gsf-batch-golden`` for
the GSF batch's, ``... ff-stats`` for the skip counts, a few minutes
each); ``... tests/torch_parity.py check N MS`` runs the N-node
reference-default Handel in both packages
on the CPU for MS ms and compares the full state every 100 ms, ``...
check N MS gsf`` (or ``pingpong``) does the same for
``GSFSignature(node_count=N)`` (``PingPong(node_count=N)``) with its
defaults, and a sixth argument K runs the port in K-ms windows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from wittgenstein_tpu_torch import convert  # noqa: E402

PORT_DATA = os.path.join(ROOT, "wittgenstein_tpu_torch", "data")
TABLE_FILE = os.path.join(PORT_DATA, "latency_by_distance_w_jitter.npy")
GOLDEN_FILE = os.path.join(PORT_DATA, "golden_handel2048_200ms.json")
GOLDEN_MS = 200
GSF_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_gsf4096_600ms.json")
GSF_GOLDEN_N = 4096
GSF_GOLDEN_MS = 600
HEADLINE_GOLDEN_FILE = os.path.join(PORT_DATA,
                                    "golden_handel2048_r16_k2_200ms.json")
HEADLINE_N, HEADLINE_SEEDS, HEADLINE_MS = 2048, 16, 200
PINGPONG_GOLDEN_FILE = os.path.join(PORT_DATA,
                                    "golden_pingpong1000_800ms.json")
PINGPONG_HARNESS_FILE = os.path.join(PORT_DATA,
                                     "golden_pingpong1000_r16_k2_200ms.json")
PINGPONG_N, PINGPONG_MS = 1000, 800
PINGPONG_SEEDS, PINGPONG_HARNESS_MS = 16, 200
GSF_BATCH_FILE = os.path.join(PORT_DATA, "golden_gsf4096_r4_600ms.json")
GSF_BATCH_SEEDS = 4
FF_STATS_FILE = os.path.join(PORT_DATA, "golden_pingpong1000_ff_stats.json")


def jax_nested(obj):
    """A JAX state dataclass (flax struct) as nested dicts of numpy
    arrays under its field names; tuples become lists."""
    import jax

    if dataclasses.is_dataclass(obj):
        return {f.name: jax_nested(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    if isinstance(obj, dict):
        return {k: jax_nested(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [jax_nested(v) for v in obj]
    return np.asarray(jax.device_get(obj))


def jax_state(net, pstate):
    return jax_nested(net), jax_nested(pstate)


def assert_states_equal(ref, got, what=""):
    """ref/got are (net_np, pstate_np) pairs; fails naming the first
    differing leaf and index."""
    a = convert.flatten({"net": ref[0], "pstate": ref[1]})
    b = convert.flatten({"net": got[0], "pstate": got[1]})
    diff = convert.first_difference(a, b)
    assert diff is None, (f"{what}: first difference at leaf {diff[0]} "
                          f"index {diff[1]}: reference {diff[2]!r}, port "
                          f"{diff[3]!r}")


def jax_latency_table():
    """[MAX_DIST + 1, 100] int32: `NetworkLatencyByDistanceWJitter
    .extended` of the JAX package for every (torus distance, delta),
    compiled with `jax.jit` as the engine's step runs it.  (Op-by-op
    eager evaluation rounds one entry differently, (552, 99): 147
    instead of the compiled 146.)  Distance d is realised by a node
    pair (1, 1) -> (1 + dx, 1 + dy) whose integer torus distance is
    exactly d."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.latency import (
        NetworkLatencyByDistanceWJitter, torus_dist)
    from wittgenstein_tpu.core.state import MAX_DIST, default_nodes

    dxs, dys = [], []
    for d in range(MAX_DIST + 1):
        dx = min(d, 1000)
        dy = int(np.ceil(np.sqrt(max(d * d - dx * dx, 0))))
        while int(np.sqrt(dx * dx + dy * dy)) < d:
            dy += 1
        dxs.append(dx)
        dys.append(dy)
    k = MAX_DIST + 1
    nodes = default_nodes(2 * k).replace(
        x=jnp.asarray(np.concatenate([np.ones(k), 1 + np.array(dxs)]),
                      jnp.int32),
        y=jnp.asarray(np.concatenate([np.ones(k), 1 + np.array(dys)]),
                      jnp.int32))
    src = jnp.arange(k, dtype=jnp.int32)
    dst = src + k
    dist = np.asarray(torus_dist(nodes, src, dst))
    assert (dist == np.arange(k)).all(), "distance realisation failed"
    model = NetworkLatencyByDistanceWJitter()
    extended = jax.jit(model.extended)
    delta = jnp.tile(jnp.arange(100, dtype=jnp.int32), k)
    return np.asarray(extended(nodes, jnp.repeat(src, 100),
                               jnp.repeat(dst, 100), delta)).reshape(k, 100)


def jax_golden_digest():
    """Leaf sha256s of the JAX package's (net, pstate) after GOLDEN_MS
    ms of the 2048-node reference-default Handel, seed 0, through
    `Runner.run_ms` on its default path."""
    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu_torch.models.handel import reference_default_params

    proto = Handel(**reference_default_params(2048))
    net, ps = proto.init(0)
    net, ps = Runner(proto).run_ms(net, ps, GOLDEN_MS)
    return convert.state_digest(*jax_state(net, ps))


def jax_gsf_golden():
    """Leaf sha256s of the JAX package's (net, pstate) after
    GSF_GOLDEN_MS ms of `GSFSignature(node_count=GSF_GOLDEN_N)` with its
    defaults, seed 0, through `Runner.run_ms` in 100-ms calls on its
    default path; with the run's counters beside them."""
    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.gsf import GSFSignature

    proto = GSFSignature(node_count=GSF_GOLDEN_N)
    net, ps = proto.init(0)
    runner = Runner(proto)
    for _ in range(GSF_GOLDEN_MS // 100):
        net, ps = runner.run_ms(net, ps, 100)
    live = ~np.asarray(net.nodes.down)
    counts = {"evicted": int(ps.evicted), "dropped": int(net.dropped),
              "clamped": int(net.clamped),
              "msg_sent": int(np.asarray(net.nodes.msg_sent).sum()),
              "frac_done": float((np.asarray(net.nodes.done_at)[live]
                                  > 0).mean())}
    return convert.state_digest(*jax_state(net, ps)), counts


def write_gsf_golden():
    digest, counts = jax_gsf_golden()
    with open(GSF_GOLDEN_FILE, "w") as f:
        json.dump({"config": f"GSFSignature(node_count={GSF_GOLDEN_N}), "
                   "seed 0", "ms": GSF_GOLDEN_MS, "counts": counts,
                   "leaves": digest}, f, indent=1, sort_keys=True)
        f.write("\n")


def jax_headline_digests(n=HEADLINE_N, seeds=HEADLINE_SEEDS,
                         ms=HEADLINE_MS):
    """Per-seed leaf sha256s of the JAX package's benchmark headline:
    ``scan_chunk_batched(proto, ms, t0_mod=0, superstep=2)`` over
    ``jax.vmap(proto.init)(arange(seeds))`` for the n-node
    reference-default Handel (bench.py `_handel_setup`)."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import scan_chunk_batched
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu_torch.models.handel import reference_default_params

    proto = Handel(**reference_default_params(n))
    nets, ps = jax.vmap(proto.init)(jnp.arange(seeds, dtype=jnp.int32))
    run = jax.jit(scan_chunk_batched(proto, ms, t0_mod=0, superstep=2))
    return convert.seed_digests(*jax_state(*run(nets, ps)))


def write_headline_golden():
    digests = jax_headline_digests()
    with open(HEADLINE_GOLDEN_FILE, "w") as f:
        json.dump({"config": f"reference_default_params({HEADLINE_N}), "
                   f"seeds 0-{HEADLINE_SEEDS - 1}",
                   "call": f"jax.jit(wittgenstein_tpu.core.batched."
                   f"scan_chunk_batched(proto, {HEADLINE_MS}, t0_mod=0, "
                   f"superstep=2))(*jax.vmap(proto.init)(jnp.arange("
                   f"{HEADLINE_SEEDS})))",
                   "ms": HEADLINE_MS, "seeds": digests}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


def jax_pingpong_golden():
    """Leaf sha256s of the JAX package's (net, pstate) after PINGPONG_MS
    ms of `PingPong(node_count=PINGPONG_N)`, seed 0, through
    `Runner.run_ms` in 100-ms calls; with the pong curve (pongs after
    each call) and the drop counters."""
    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.pingpong import PingPong

    proto = PingPong(node_count=PINGPONG_N)
    net, ps = proto.init(0)
    runner = Runner(proto)
    curve = []
    for _ in range(PINGPONG_MS // 100):
        net, ps = runner.run_ms(net, ps, 100)
        curve.append(int(ps.pongs))
    counts = {k: int(getattr(net, k)) for k in
              ("dropped", "bc_dropped", "clamped", "sp_dropped")}
    return convert.state_digest(*jax_state(net, ps)), {"pongs": curve,
                                                       **counts}


def jax_pingpong_harness_digests(seeds=PINGPONG_SEEDS,
                                 ms=PINGPONG_HARNESS_MS, batch=4):
    """Per-seed leaf sha256s of ``jax.vmap(scan_chunk(PingPong(
    node_count=PINGPONG_N), ms, superstep=2))`` over
    ``jax.vmap(proto.init)`` of seeds 0..seeds-1 (the JAX harness's
    chunk), `batch` seeds a call: the runs never meet, so a seed's state
    does not depend on its batch, and four rings of 393 MB stay within
    a CPU's memory."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.pingpong import PingPong

    proto = PingPong(node_count=PINGPONG_N)
    run = jax.jit(jax.vmap(scan_chunk(proto, ms, superstep=2)))
    out = []
    for s0 in range(0, seeds, batch):
        nets, ps = jax.vmap(proto.init)(
            jnp.arange(s0, min(s0 + batch, seeds), dtype=jnp.int32))
        out += convert.seed_digests(*jax_state(*run(nets, ps)))
    return out


def write_pingpong_goldens():
    digest, counts = jax_pingpong_golden()
    with open(PINGPONG_GOLDEN_FILE, "w") as f:
        json.dump({"config": f"PingPong(node_count={PINGPONG_N}), seed 0",
                   "call": "Runner(proto).run_ms in 100-ms calls",
                   "ms": PINGPONG_MS, "counts": counts, "leaves": digest},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    digests = jax_pingpong_harness_digests()
    with open(PINGPONG_HARNESS_FILE, "w") as f:
        json.dump({"config": f"PingPong(node_count={PINGPONG_N}), seeds "
                   f"0-{PINGPONG_SEEDS - 1}",
                   "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                   f"scan_chunk(proto, {PINGPONG_HARNESS_MS}, superstep=2)))"
                   f"(*jax.vmap(proto.init)(jnp.arange({PINGPONG_SEEDS})))",
                   "ms": PINGPONG_HARNESS_MS, "seeds": digests}, f,
                  indent=1, sort_keys=True)
        f.write("\n")


def jax_gsf_batch_digests(n=GSF_GOLDEN_N, seeds=GSF_BATCH_SEEDS,
                          ms=GSF_GOLDEN_MS, batch=2):
    """Per-seed leaf sha256s of ``jax.jit(jax.vmap(scan_chunk(
    GSFSignature(node_count=n), ms)))`` over ``jax.vmap(proto.init)`` of
    seeds 0..seeds-1 (the JAX harness's chunk at K=1, as
    `tools/bench_suite.py`'s GSF line runs it), `batch` seeds a call: the
    runs never meet, so a seed's state does not depend on its batch."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.gsf import GSFSignature

    proto = GSFSignature(node_count=n)
    run = jax.jit(jax.vmap(scan_chunk(proto, ms)))
    out = []
    for s0 in range(0, seeds, batch):
        nets, ps = jax.vmap(proto.init)(
            jnp.arange(s0, min(s0 + batch, seeds), dtype=jnp.int32))
        out += convert.seed_digests(*jax_state(*run(nets, ps)))
    return out


def write_gsf_batch_golden():
    digests = jax_gsf_batch_digests()
    with open(GSF_GOLDEN_FILE) as f:
        one = json.load(f)["leaves"]
    if digests[0] != one:
        raise AssertionError("seed 0 of the batch differs from the one-seed "
                             "GSF golden")
    with open(GSF_BATCH_FILE, "w") as f:
        json.dump({"config": f"GSFSignature(node_count={GSF_GOLDEN_N}), "
                   f"seeds 0-{GSF_BATCH_SEEDS - 1}",
                   "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                   f"scan_chunk(proto, {GSF_GOLDEN_MS})))(*jax.vmap("
                   f"proto.init)(jnp.arange({GSF_BATCH_SEEDS})))",
                   "ms": GSF_GOLDEN_MS, "seeds": digests}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


def jax_pingpong_ff_stats():
    """The JAX fast-forward engine's skip counts on two PingPong(1000)
    runs whose states the PingPong goldens hold: ``Runner(proto,
    fast_forward=True)`` on seed 0 in 100-ms calls to PINGPONG_MS, and
    ``fast_forward_chunk(proto, PINGPONG_HARNESS_MS, seed_axis=True,
    superstep=2)`` on seeds 0..PINGPONG_SEEDS-1 in one batch (its jumps
    are the batch's minimum, so the batch is not split).  Each run's
    state is checked against its golden first."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import Runner, fast_forward_chunk
    from wittgenstein_tpu.models.pingpong import PingPong

    proto = PingPong(node_count=PINGPONG_N)
    runner = Runner(proto, fast_forward=True)
    state = proto.init(0)
    for _ in range(PINGPONG_MS // 100):
        state = runner.run_ms(*state, 100)
    with open(PINGPONG_GOLDEN_FILE) as f:
        if convert.state_digest(*jax_state(*state)) != json.load(f)["leaves"]:
            raise AssertionError("fast-forwarded PingPong differs from its "
                                 "golden")
    del state
    runner_stats = runner.ff_stats()
    run = jax.jit(fast_forward_chunk(proto, PINGPONG_HARNESS_MS,
                                     seed_axis=True, superstep=2),
                  donate_argnums=(0, 1))
    nets, ps, stats = run(*jax.vmap(proto.init)(
        jnp.arange(PINGPONG_SEEDS, dtype=jnp.int32)))
    with open(PINGPONG_HARNESS_FILE) as f:
        if convert.seed_digests(*jax_state(nets, ps)) != \
                json.load(f)["seeds"]:
            raise AssertionError("fast-forwarded PingPong batch differs "
                                 "from its golden")
    batch_stats = {k: int(v) for k, v in stats.items()}
    return runner_stats, batch_stats


def write_ff_stats():
    runner_stats, batch_stats = jax_pingpong_ff_stats()
    with open(FF_STATS_FILE, "w") as f:
        json.dump({"config": f"PingPong(node_count={PINGPONG_N})",
                   "runner": {"call": "Runner(proto, fast_forward=True)"
                              f".run_ms in 100-ms calls to {PINGPONG_MS} ms,"
                              " seed 0", "state": os.path.basename(
                                  PINGPONG_GOLDEN_FILE), **runner_stats},
                   "seed_axis": {"call": "fast_forward_chunk(proto, "
                                 f"{PINGPONG_HARNESS_MS}, seed_axis=True, "
                                 "superstep=2) on seeds 0-"
                                 f"{PINGPONG_SEEDS - 1}",
                                 "state": os.path.basename(
                                     PINGPONG_HARNESS_FILE), **batch_stats}},
                  f, indent=1, sort_keys=True)
        f.write("\n")


def _protocols(n: int, protocol: str):
    """(JAX protocol, port protocol on the CPU) for `check`."""
    if protocol == "pingpong":
        from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
        from wittgenstein_tpu_torch.models.pingpong import PingPong
        return JPingPong(node_count=n), PingPong(node_count=n, device="cpu")
    if protocol == "gsf":
        from wittgenstein_tpu.models.gsf import GSFSignature as JGSF
        from wittgenstein_tpu_torch.models.gsf import GSFSignature
        return JGSF(node_count=n), GSFSignature(node_count=n, device="cpu")
    from wittgenstein_tpu.models.handel import Handel as JHandel
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    params = reference_default_params(n)
    return JHandel(**params), Handel(**params, device="cpu")


def check(n: int, ms: int, protocol: str = "handel", every: int = 100,
          superstep: int = 1):
    """Both packages from their own init, full state compared every
    `every` ms; prints each checkpoint and returns 1 at the first
    difference, else 0.  The JAX package runs its per-ms engine, the
    port its `Runner(superstep=superstep)`."""
    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu_torch.core.network import Runner

    jproto, proto = _protocols(n, protocol)
    jstate, state = jproto.init(0), proto.init(0)
    jrun, run = JRunner(jproto), Runner(proto, superstep=superstep)
    for t in range(every, ms + 1, every):
        jstate = jrun.run_ms(*jstate, every)
        state = run.run_ms(*state, every)
        a = convert.flatten(dict(zip(("net", "pstate"),
                                     jax_state(*jstate))))
        b = convert.flatten(dict(zip(("net", "pstate"),
                                     convert.to_numpy(*state))))
        diff = convert.first_difference(a, b)
        print(f"{protocol} {n} nodes, K {superstep}, {t} ms: "
              f"{'equal' if diff is None else f'DIFFERENT {diff}'}",
              flush=True)
        if diff is not None:
            return 1
    return 0


def main():
    if sys.argv[1:2] == ["check"]:
        sys.exit(check(int(sys.argv[2]), int(sys.argv[3]),
                       *sys.argv[4:5], *map(int, sys.argv[5:7])))
    if sys.argv[1:2] == ["gsf-golden"]:
        write_gsf_golden()
        return
    if sys.argv[1:2] == ["headline-golden"]:
        write_headline_golden()
        return
    if sys.argv[1:2] == ["pingpong-golden"]:
        write_pingpong_goldens()
        return
    if sys.argv[1:2] == ["gsf-batch-golden"]:
        write_gsf_batch_golden()
        return
    if sys.argv[1:2] == ["ff-stats"]:
        write_ff_stats()
        return
    np.save(TABLE_FILE, jax_latency_table().astype(np.int16))
    digest = jax_golden_digest()
    with open(GOLDEN_FILE, "w") as f:
        json.dump({"config": "reference_default_params(2048), seed 0",
                   "ms": GOLDEN_MS, "leaves": digest}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    write_gsf_golden()


if __name__ == "__main__":
    main()
