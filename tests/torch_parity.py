"""Shared helpers of the `tests/test_torch_*.py` parity tests: the JAX
package's state as nested numpy dicts, a leaf-by-leaf comparison that
names the first difference, and the generators of the artifacts the
port ships (the distance-latency table, the 2048-node Handel golden
digest, the 4096-node GSF golden digest, the per-seed digests of the
benchmark headline's 16-seed batch, the 1000-node PingPong's digest
and per-seed harness digests, the per-seed digests of a 4-seed batch of
the 4096-node GSF, the JAX fast-forward engine's skip counts on two
PingPong runs, Handel at scale: the tier-3 cardinal line at 65,536
nodes, the tier-2 exact line at 32,768 nodes and a 1,024-node run under
the byzantineSuicide attack; SanFermin, Cappos, Dfinity and the quiet
lines; Casper IMD's reference configuration and `try_miner`'s ETHPoW
batch, ``... casper-golden`` and ``... ethpow-golden``; the Pareto
jitter bits, IC3's table and the pareto speed's fixes, ``...
latency-tables``; the P2PHandel and Optimistic drivers on the city
latency, ``... city-goldens``; the ENR, Slush, Snowflake and Paxos
batches, ``... committee-goldens``; and the headline under a fault
schedule at 100 and 200 ms and the 16-seed PingPong(1000) under
tests/test_checkpoint.py's schedule at 40 and 120 ms, ``...
chaos-goldens``, about 3 minutes; the JAX `run_grid` report of the
headline's fault-free and faulted twins on 8 seeds and the JAX
`run_search` report of a boundary question on PingPong(1000), ``...
matrix-goldens``, about 10 minutes).

Regenerate the first three with ``JAX_PLATFORMS=cpu python
tests/torch_parity.py`` (``... tests/torch_parity.py gsf-golden`` for the
GSF digest alone, ``... headline-golden`` for the headline's, about 5
minutes and 4.5 GB of JAX on the CPU, ``... pingpong-golden`` for the
1000-node PingPong's two, about a minute, ``... gsf-batch-golden`` for
the GSF batch's, ``... ff-stats`` for the skip counts, a few minutes
each; ``... cardinal-golden``, ``... tier2-golden`` and ``...
attack-golden`` for the scale lines, their costs in their writers'
docstrings); ``... tests/torch_parity.py check N MS`` runs the N-node
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
from wittgenstein_tpu_torch.models.dfinity import \
    tracked_10k_params  # noqa: E402
from wittgenstein_tpu_torch.models.p2pflood import quiet_params  # noqa: E402

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
GSF_BATCH_FILE = os.path.join(PORT_DATA, "golden_gsf4096_r4_100ms.json")
GSF_BATCH_SEEDS, GSF_BATCH_MS = 4, 100
FF_STATS_FILE = os.path.join(PORT_DATA, "golden_pingpong1000_ff_stats.json")
CARDINAL_N, CARDINAL_MS = 65536, (200, 1000)
CARDINAL_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_cardinal65536_k2.json")
TIER2_N, TIER2_MS = 32768, (100, 200)
TIER2_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_tier2_32768.json")
ATTACK_N, ATTACK_MS = 1024, 200
GSF32K_N, GSF32K_MS = 32768, (50, 100)
GSF32K_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_gsf32768_100ms.json")
OBS_N, OBS_METRICS_MS, OBS_STAT_MS, OBS_MS = 64, 24, 4, 40
OBS_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_obs_pingpong64.json")
ATTACK_GOLDEN_FILE = os.path.join(PORT_DATA,
                                  "golden_handel1024_suicide_200ms.json")


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


def assert_heights_ordered(arena_np):
    """Every allocated block of one run's arena lies above its parent:
    the order the port's walks by set rely on."""
    n = int(arena_np["n"])
    par = np.asarray(arena_np["parent"])[1:n]
    height = np.asarray(arena_np["height"])
    has = par >= 0
    assert np.all(height[1:n][has] > height[par[has]]), "height order"


def seed_state(tree, r):
    """Seed r's state out of a batched nested state (every leaf with a
    leading seed axis)."""
    if isinstance(tree, dict):
        return {k: seed_state(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [seed_state(v, r) for v in tree]
    return np.asarray(tree)[r]


def jax_chunk_states(jproto, seeds, ms, chunk):
    """The JAX package's states of `jproto` from ``jproto.init(seed)``
    for each seed, after each of ``jax.jit(scan_chunk(jproto, chunk))``'s
    calls to `ms`: ``{(seed, t): (net_np, pstate_np)}``.  One compiled
    function serves every seed."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk

    run = jax.jit(scan_chunk(jproto, chunk))
    out = {}
    for seed in seeds:
        state = jax.tree.map(jnp.copy, jproto.init(seed))
        for t in range(chunk, ms + 1, chunk):
            state = run(*state)
            out[seed, t] = jax_state(*state)
    return out


def jax_ff_batch(jproto, seeds, ms, chunk, superstep):
    """The JAX fast-forward engine on a seed batch: ``jax.jit(
    fast_forward_chunk(jproto, chunk, seed_axis=True, superstep=K))``
    called from ``jax.vmap(jproto.init)(seeds)`` to `ms`.  Returns the
    final batched state as nested numpy dicts and each call's skip
    counts."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import fast_forward_chunk

    run = jax.jit(fast_forward_chunk(jproto, chunk, seed_axis=True,
                                     superstep=superstep))
    state = jax.vmap(jproto.init)(jnp.asarray(seeds, jnp.int32))
    stats = []
    for _ in range(ms // chunk):
        *state, st = run(*state)
        stats.append({k: int(v) for k, v in st.items()})
    return jax_state(*state), stats


def jax_batch_run(jproto, seeds, ms, chunk, ff_ms=0, ff_chunk=None):
    """The JAX package on a seed batch: ``jax.jit(jax.vmap(scan_chunk(
    jproto, chunk)))`` calls from ``jax.vmap(jproto.init)(seeds)`` to
    `ms`, then ``jax.jit(fast_forward_chunk(jproto, ff_chunk,
    seed_axis=True, superstep=2))`` calls on to ``ms + ff_ms``.  Returns
    ``{t: (net_np, pstate_np)}`` after every call and the fast-forwarded
    calls' skip counts."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import fast_forward_chunk, scan_chunk

    state = jax.vmap(jproto.init)(jnp.asarray(seeds, jnp.int32))
    run = jax.jit(jax.vmap(scan_chunk(jproto, chunk)))
    out, stats = {}, []
    for t in range(chunk, ms + 1, chunk):
        state = run(*state)
        out[t] = jax_state(*state)
    if ff_ms:
        ff = jax.jit(fast_forward_chunk(jproto, ff_chunk, seed_axis=True,
                                        superstep=2))
        for t in range(ms + ff_chunk, ms + ff_ms + 1, ff_chunk):
            *state, st = ff(*state)
            stats.append({k: int(v) for k, v in st.items()})
            out[t] = jax_state(*state)
    return out, stats


def port_batch_run(proto, seeds, ms, chunk, ff_ms=0, ff_chunk=None):
    """The port's counterpart of `jax_batch_run`: `network.scan_chunk` at
    K=2 on `init_batched`, then `fast_forward_chunk(seed_axis=True,
    superstep=2)`, with vmap's per-seed fallback an error."""
    from test_torch_batched import no_vmap_fallback
    from wittgenstein_tpu_torch.core import network
    from wittgenstein_tpu_torch.core.state import init_batched

    state = init_batched(proto, seeds)
    out, stats = {}, []
    with no_vmap_fallback():
        run = network.scan_chunk(proto, chunk, superstep=2)
        for t in range(chunk, ms + 1, chunk):
            state = run(*state, t=t - chunk)
            out[t] = convert.to_numpy(*state)
        if ff_ms:
            ff = network.fast_forward_chunk(proto, ff_chunk, seed_axis=True,
                                            superstep=2)
            for t in range(ms + ff_chunk, ms + ff_ms + 1, ff_chunk):
                *state, st = ff(*state, t=t - ff_chunk)
                stats.append(st)
                out[t] = convert.to_numpy(*state)
    return out, stats


def assert_batches_equal(ref, got, what=""):
    """Every seed of two batched states equal, leaf for leaf."""
    for r in range(len(ref[0]["time"])):
        assert_states_equal([seed_state(x, r) for x in ref],
                            [seed_state(x, r) for x in got],
                            f"{what} seed {r}")


def port_chunks(proto, state, ms, chunk, superstep=1, fast_forward=False):
    """The port's `network.scan_chunk` (or `fast_forward_chunk`, on the
    state's own layout) in `chunk`-ms calls from `state` at time 0 to
    `ms`: the numpy state after each call, and the skip counts of each
    fast-forwarded call."""
    from wittgenstein_tpu_torch.core import network
    seed_axis = state[0].time.dim() > 0
    run = (network.fast_forward_chunk(proto, chunk, seed_axis=seed_axis,
                                      superstep=superstep)
           if fast_forward else
           network.scan_chunk(proto, chunk, superstep=superstep))
    out, stats = {}, []
    for t in range(chunk, ms + 1, chunk):
        state = run(*state, t=t - chunk)
        if fast_forward:
            *state, st = state
            stats.append(st)
        out[t] = convert.to_numpy(*state)
    return out, stats


def jax_latency_table():
    """[MAX_DIST + 1, 100] int32: `NetworkLatencyByDistanceWJitter
    .extended` of the JAX package for every (torus distance, delta),
    compiled with `jax.jit` as the engine's step runs it.  (Op-by-op
    eager evaluation rounds one entry differently, (552, 99): 147
    instead of the compiled 146.)  Distance d is realised by the node
    pair of `distance_pairs`."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.latency import NetworkLatencyByDistanceWJitter

    nodes, src, dst = distance_pairs()
    k = len(src)
    extended = jax.jit(NetworkLatencyByDistanceWJitter().extended)
    delta = jnp.tile(jnp.arange(100, dtype=jnp.int32), k)
    return np.asarray(extended(nodes, jnp.repeat(src, 100),
                               jnp.repeat(dst, 100), delta)).reshape(k, 100)


def jax_jitter_bits():
    """int32 [100]: the bits of the JAX package's ``gpd_inverse(delta /
    100)`` in float32 for every delta, compiled with `jax.jit` as the
    engine's step runs the city-jitter and AWS models."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.latency import gpd_inverse
    fn = jax.jit(lambda d: gpd_inverse(d.astype(jnp.float32) / 100.0))
    return np.asarray(fn(jnp.arange(100, dtype=jnp.int32))).view(np.int32)


def distance_pairs():
    """(nodes, src, dst) of the JAX package: node pair k realises the
    integer torus distance k, for k in [0, MAX_DIST]."""
    import jax.numpy as jnp

    from wittgenstein_tpu.core.latency import torus_dist
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
    return nodes, src, dst


def jax_ic3_table():
    """int32 [MAX_DIST + 1]: `IC3NetworkLatency.extended` of the JAX
    package for every torus distance, under `jax.jit`."""
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.latency import IC3NetworkLatency
    nodes, src, dst = distance_pairs()
    return np.asarray(jax.jit(IC3NetworkLatency().extended)(
        nodes, src, dst, jnp.zeros_like(src)))


def speed_grid():
    """float32 [2^24]: every value of the builder's uniform draw."""
    return np.arange(1 << 24, dtype=np.float32) * np.float32(2.0 ** -24)


def jax_speed_grid(speed, slow=False):
    """float32 [2^24]: the JAX package's `NodeBuilder._speed_ratios`,
    op by op as a protocol's `init` runs it, on every grid value of its
    draw (for the uniform model, of ``u2``, with ``u`` on the fast half
    or, with `slow`, the slow one): its PRNG is replaced by the grid."""
    import types

    import jax.numpy as jnp

    from wittgenstein_tpu.core import builders

    grid = jnp.asarray(speed_grid())
    other = jnp.full_like(grid, 0.75 if slow else 0.25)
    tag = 6 if speed == "uniform" else 4
    stub = types.SimpleNamespace(
        hash2=lambda a, b: b,
        uniform_float=lambda s, ids: grid if s == tag else other)
    orig, builders.prng = builders.prng, stub
    try:
        return np.asarray(builders.NodeBuilder(speed=speed)._speed_ratios(
            0, None))
    finally:
        builders.prng = orig


def jax_pareto_fixes():
    """int32 [K, 2]: (grid index, float32 bits) of every grid value
    where the JAX package's pareto speed differs from its form with a
    correctly rounded reciprocal in place of ``powf(1 - y, -1)``."""
    u = speed_grid()
    y = np.clip(u, np.float32(0), np.float32(0.999999))
    main = (np.float32(1) / (np.float32(1) - y) - np.float32(1))
    base = np.minimum(np.float32(3), np.where(
        y < np.float32(1e-6), np.float32(0), main) + np.float32(1))
    want = jax_speed_grid("pareto")
    idx = np.nonzero(base.view(np.int32) != want.view(np.int32))[0]
    return np.stack([idx.astype(np.int32), want[idx].view(np.int32)], 1)


def write_latency_tables():
    """The jitter bits, IC3's table and the pareto speed's fixes, into
    the port's data/."""
    np.save(os.path.join(PORT_DATA, "gpd_jitter_bits.npy"),
            jax_jitter_bits())
    np.save(os.path.join(PORT_DATA, "ic3_latency_by_distance.npy"),
            jax_ic3_table())
    np.save(os.path.join(PORT_DATA, "pareto_speed_fixes.npy"),
            jax_pareto_fixes())


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
                          ms=GSF_BATCH_MS, batch=2):
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
    with open(GSF_BATCH_FILE, "w") as f:
        json.dump({"config": f"GSFSignature(node_count={GSF_GOLDEN_N}), "
                   f"seeds 0-{GSF_BATCH_SEEDS - 1}",
                   "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                   f"scan_chunk(proto, {GSF_BATCH_MS})))(*jax.vmap("
                   f"proto.init)(jnp.arange({GSF_BATCH_SEEDS})))",
                   "ms": GSF_BATCH_MS, "seeds": digests}, f, indent=1,
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


def _run_counts(net, ps):
    """The drop, clamp and eviction counters and the live done fraction
    of a run (or of seed 0 of a batch)."""
    pick = (lambda x: np.asarray(x)[0]) if np.ndim(net.time) else np.asarray
    live = ~pick(net.nodes.down)
    return {"dropped": int(pick(net.dropped)),
            "clamped": int(pick(net.clamped)),
            "evicted": int(pick(ps.evicted)),
            "frac_done": float((pick(net.nodes.done_at)[live] > 0).mean())}


def _write_golden(path, body, t0):
    """Write a golden with the generator's wall and peak RSS on this
    host beside it."""
    import resource
    import time
    body["generator"] = {
        "wall_s": round(time.monotonic() - t0, 1),
        "peak_rss_gb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2)}
    with open(path, "w") as f:
        json.dump(body, f, indent=1, sort_keys=True)
        f.write("\n")
    print(path, body["generator"], flush=True)


def write_cardinal_golden(n=CARDINAL_N, ms=CARDINAL_MS, chunk=200):
    """Per-seed leaf sha256s of the JAX package's tier-3 line, cardinal
    mode at `n` nodes (`tier3_params`), at each checkpoint of `ms`:
    ``scan_chunk_batched(proto, chunk, t0_mod=0, superstep=2)`` calls
    over ``jax.vmap(proto.init)`` of seed 0, the seed-folded engine with
    phase hints.  On an 8-core CPU host: 657 s and 11.0 GB resident to
    1,000 ms beside other work, 143 s to 200 ms alone (the run's own
    numbers are in the file, under "generator")."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.batched import scan_chunk_batched
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu_torch.models.handel import tier3_params

    t0 = time.monotonic()
    proto = Handel(**tier3_params(n))
    nets, ps = jax.vmap(proto.init)(jnp.arange(1, dtype=jnp.int32))
    run = jax.jit(scan_chunk_batched(proto, chunk, t0_mod=0, superstep=2),
                  donate_argnums=(0, 1))
    at = {}
    for t in range(chunk, ms[-1] + 1, chunk):
        nets, ps = run(nets, ps)
        if t in ms:
            at[str(t)] = {"counts": _run_counts(nets, ps),
                          "seeds": convert.seed_digests(
                              *jax_state(nets, ps))}
        print(f"cardinal golden: {t} ms at {time.monotonic() - t0:.0f} s",
              flush=True)
    _write_golden(CARDINAL_GOLDEN_FILE, {
        "config": f"tier3_params({n}), seed 0",
        "call": f"jax.jit(wittgenstein_tpu.core.batched.scan_chunk_batched("
                f"proto, {chunk}, t0_mod=0, superstep=2)) called from "
                "jax.vmap(proto.init)(jnp.arange(1))",
        "ms": at}, t0)


def write_tier2_golden(n=TIER2_N, ms=TIER2_MS, chunk=20):
    """Leaf sha256s of the JAX package's tier-2 exact line at `n` nodes
    (`tier2_params`: hashed emission, no snapshot pool, two q_sig
    pieces, and ``box_split=TIER2_BOX_SPLIT`` ring sub-planes), seed 0,
    at each checkpoint of `ms`, through ``scan_chunk(proto, chunk,
    t0_mod=0, superstep=2)`` calls (the phase-specialized K=2 scan,
    bit-identical to the per-ms one).  On an 8-core CPU host 437 s and
    13.4 GB resident to 400 ms, before the card's phase 10 was cut to
    200 ms (the run's own numbers are in the file, under
    "generator")."""
    import time

    import jax

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu_torch.models.handel import (TIER2_BOX_SPLIT,
                                                      tier2_params)

    t0 = time.monotonic()
    proto = Handel(**tier2_params(n))
    proto.cfg = dataclasses.replace(proto.cfg, box_split=TIER2_BOX_SPLIT)
    net, ps = proto.init(0)
    run = jax.jit(scan_chunk(proto, chunk, t0_mod=0, superstep=2),
                  donate_argnums=(0, 1))
    at = {}
    for t in range(chunk, ms[-1] + 1, chunk):
        net, ps = run(net, ps)
        if t in ms:
            at[str(t)] = {"counts": _run_counts(net, ps),
                          "leaves": convert.state_digest(
                              *jax_state(net, ps))}
        print(f"tier-2 golden: {t} ms at {time.monotonic() - t0:.0f} s",
              flush=True)
    _write_golden(TIER2_GOLDEN_FILE, {
        "config": f"tier2_params({n}), box_split {TIER2_BOX_SPLIT}, seed 0",
        "call": f"jax.jit(wittgenstein_tpu.core.network.scan_chunk(proto, "
                f"{chunk}, t0_mod=0, superstep=2)) called from "
                "proto.init(0)",
        "ms": at}, t0)


def write_gsf32k_golden(n=GSF32K_N, ms=GSF32K_MS, path=None):
    """Leaf sha256s of the JAX package's `GSFSignature(node_count=n)`
    with its defaults (at 32,768 nodes: L 16, W 1,024, H 512, 53 rounds;
    a pool of 7.1 GB), seed 0, at each checkpoint of `ms`, through
    ``Runner(proto).run_ms`` calls of equal length (one compiled scan,
    donated state), with the drop, clamp and eviction counters beside
    them, into `path` (the shipped file by default).  Its wall and peak
    RSS on the generating host are in the file, under "generator": about
    5 minutes and 32 GB on an 8-core CPU host at 32,768 nodes."""
    import time

    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.gsf import GSFSignature

    t0 = time.monotonic()
    proto = GSFSignature(node_count=n)
    net, ps = proto.init(0)
    runner = Runner(proto)
    at, t = {}, 0
    for stop in ms:
        net, ps = runner.run_ms(net, ps, stop - t)
        t = stop
        at[str(t)] = {"counts": _run_counts(net, ps),
                      "leaves": convert.state_digest(*jax_state(net, ps))}
        print(f"gsf32k golden: {t} ms at {time.monotonic() - t0:.0f} s",
              flush=True)
    body = {"config": f"GSFSignature(node_count={n}), seed 0",
            "call": "wittgenstein_tpu.core.network.Runner(proto).run_ms("
                    f"net, ps, {ms[0]}) from proto.init(0), {len(ms)} "
                    "calls",
            "ms": at}
    _write_golden(path or GSF32K_GOLDEN_FILE, body, t0)
    return body


def jax_obs_carries(n=OBS_N):
    """The JAX package's three obs planes on `PingPong(node_count=n)`,
    seed 0 (the twins of tests/test_pallas_route.py:200 and :211): the
    metrics plane (``stat_each_ms`` OBS_STAT_MS) over OBS_METRICS_MS ms
    of `scan_chunk_metrics`, the flight recorder (`TraceSpec()`) over
    OBS_MS ms of `scan_chunk_trace`, and the audit plane (`AuditSpec()`)
    through ``Runner(audit=...).run_ms`` to OBS_MS ms.  Returns ``{plane:
    (carry as numpy dict, state as numpy dicts)}``."""
    import jax

    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.pingpong import PingPong
    from wittgenstein_tpu.obs import AuditSpec, MetricsSpec, TraceSpec
    from wittgenstein_tpu.obs.engine import scan_chunk_metrics
    from wittgenstein_tpu.obs.trace import scan_chunk_trace

    proto = PingPong(node_count=n)
    out = {}
    net, ps, mc = jax.jit(scan_chunk_metrics(
        proto, OBS_METRICS_MS, MetricsSpec(stat_each_ms=OBS_STAT_MS)))(
        *proto.init(0))
    out["metrics"] = (jax_nested(mc), jax_state(net, ps))
    net, ps, tc = jax.jit(scan_chunk_trace(proto, OBS_MS, TraceSpec()))(
        *proto.init(0))
    out["trace"] = (jax_nested(tc), jax_state(net, ps))
    runner = Runner(proto, donate=False, audit=AuditSpec())
    net, ps = runner.run_ms(*proto.init(0), OBS_MS)
    out["audit"] = (jax_nested(runner.audit_carries[-1]),
                    jax_state(net, ps))
    return out


def obs_carry_record(plane, carry):
    """A plane's carry as the golden keeps it: the metrics series and
    the audit carry whole, the trace ring by its cursor, dropped count
    and the digests of its buffer and down row."""
    if plane == "trace":
        return {"cursor": int(carry["cursor"]),
                "dropped": int(carry["dropped"]),
                "buf": convert.leaf_digest(np.asarray(carry["buf"],
                                                      np.int32)),
                "down": convert.leaf_digest(np.asarray(carry["down"],
                                                       bool))}
    return {k: np.asarray(v).tolist() for k, v in carry.items()}


def write_obs_golden(n=OBS_N):
    """`jax_obs_carries` as the golden `chip_smoke.py` phase O holds the
    port's planes on the card to: each plane's carry record and the
    state's leaf digests.  A few seconds of JAX on the CPU."""
    import time

    t0 = time.monotonic()
    body = {"config": f"PingPong(node_count={n}), seed 0"}
    calls = {"metrics": f"scan_chunk_metrics(proto, {OBS_METRICS_MS}, "
                        f"MetricsSpec(stat_each_ms={OBS_STAT_MS}))",
             "trace": f"scan_chunk_trace(proto, {OBS_MS}, TraceSpec())",
             "audit": "Runner(proto, donate=False, audit=AuditSpec())"
                      f".run_ms(net, ps, {OBS_MS})"}
    for plane, (carry, state) in jax_obs_carries(n).items():
        body[plane] = {"call": calls[plane],
                       "ms": OBS_METRICS_MS if plane == "metrics"
                       else OBS_MS,
                       "carry": obs_carry_record(plane, carry),
                       "leaves": convert.state_digest(*state)}
    _write_golden(OBS_GOLDEN_FILE, body, t0)


def write_attack_golden(n=ATTACK_N, ms=ATTACK_MS):
    """Leaf sha256s of the JAX package's exact Handel at `n` nodes
    under the byzantineSuicide attack (``reference_default_params(n)``,
    whose nodes_down the attacker controls), seed 0, after
    ``Runner(proto).run_ms(net, ps, ms)``.  On an 8-core CPU host: 16 s
    and 1.1 GB resident."""
    import time

    from wittgenstein_tpu.core.network import Runner
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu_torch.models.handel import reference_default_params

    t0 = time.monotonic()
    proto = Handel(**reference_default_params(n), byzantine_suicide=True)
    net, ps = Runner(proto).run_ms(*proto.init(0), ms)
    _write_golden(ATTACK_GOLDEN_FILE, {
        "config": f"reference_default_params({n}), byzantine_suicide=True,"
                  " seed 0",
        "call": f"Runner(proto).run_ms(*proto.init(0), {ms})",
        "ms": ms, "counts": _run_counts(net, ps),
        "leaves": convert.state_digest(*jax_state(net, ps))}, t0)


SANFERMIN_N, SANFERMIN_MS, SANFERMIN_BOX_SPLIT = 32768, (350, 700), 2
SANFERMIN_GOLDEN_FILE = os.path.join(PORT_DATA,
                                     "golden_sanfermin32768_box2.json")
CAPPOS_MS = 100
CAPPOS_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_cappos2048_100ms.json")
DFINITY10K_TICKS, DFINITY10K_FF_TICKS = 400, 12000
DFINITY10K_GOLDEN_FILE = os.path.join(PORT_DATA,
                                      "golden_dfinity10k_400ticks.json")
QUIET_SEEDS, QUIET_MS, QUIET_CHUNK = 4, 300, 100
DFINITY_QUIET_FILE = os.path.join(PORT_DATA,
                                  "golden_dfinity31_r4_300ticks.json")
P2PFLOOD_QUIET_FILE = os.path.join(PORT_DATA,
                                   "golden_p2pflood256_r4_300ms.json")


def _chain_counts(net, ps):
    """A run's engine drop and clamp counters, and (for a Dfinity
    state) its arena's drops and the highest and lowest head height;
    of seed 0 for a batch."""
    pick = (lambda x: np.asarray(x)[0]) if np.ndim(net.time) else np.asarray
    out = {k: int(pick(getattr(net, k)))
           for k in ("dropped", "clamped", "bc_dropped", "sp_dropped")}
    live = ~pick(net.nodes.down)
    out["frac_done"] = float((pick(net.nodes.done_at)[live] > 0).mean())
    if hasattr(ps, "arena"):
        heights = pick(ps.arena.height)[pick(ps.head)]
        out.update(arena_dropped=int(pick(ps.arena.dropped)),
                   arena_n=int(pick(ps.arena.n)),
                   height_max=int(heights.max()),
                   height_min=int(heights.min()))
    return out


def write_sanfermin_golden(n=SANFERMIN_N, ms=SANFERMIN_MS, chunk=350):
    """Leaf sha256s of the JAX package's SanFermin line of
    `tools/bench_suite.py` (``SanFermin(node_count=n, inbox_cap=16)``,
    ``box_split=SANFERMIN_BOX_SPLIT`` ring sub-planes), seed 0, at each
    checkpoint of `ms`, through ``scan_chunk(proto, chunk)`` calls (K=1,
    bench_suite's default).  The run's wall and peak RSS are in the
    file, under "generator"."""
    import time

    import jax

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.sanfermin import SanFermin

    t0 = time.monotonic()
    proto = SanFermin(node_count=n, inbox_cap=16)
    proto.cfg = dataclasses.replace(proto.cfg, box_split=SANFERMIN_BOX_SPLIT)
    net, ps = proto.init(0)
    run = jax.jit(scan_chunk(proto, chunk), donate_argnums=(0, 1))
    at = {}
    for t in range(chunk, ms[-1] + 1, chunk):
        net, ps = run(net, ps)
        if t in ms:
            at[str(t)] = {"counts": _chain_counts(net, ps),
                          "leaves": convert.state_digest(
                              *jax_state(net, ps))}
        print(f"sanfermin golden: {t} ms at {time.monotonic() - t0:.0f} s",
              flush=True)
    _write_golden(SANFERMIN_GOLDEN_FILE, {
        "config": f"SanFermin(node_count={n}, inbox_cap=16), box_split "
                  f"{SANFERMIN_BOX_SPLIT}, seed 0",
        "call": f"jax.jit(wittgenstein_tpu.core.network.scan_chunk(proto, "
                f"{chunk})) called from proto.init(0)",
        "ms": at}, t0)


def write_cappos_golden(ms=CAPPOS_MS):
    """Leaf sha256s of the JAX package's ``SanFerminCappos()`` (its
    default 2,048 nodes), seed 0, after ``scan_chunk(proto, ms)``."""
    import time

    import jax

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.sanfermin import SanFerminCappos

    t0 = time.monotonic()
    proto = SanFerminCappos()
    net, ps = jax.jit(scan_chunk(proto, ms))(*proto.init(0))
    _write_golden(CAPPOS_GOLDEN_FILE, {
        "config": f"SanFerminCappos(), {proto.node_count} nodes, seed 0",
        "call": f"jax.jit(wittgenstein_tpu.core.network.scan_chunk(proto, "
                f"{ms}))(*proto.init(0))",
        "ms": ms, "counts": _chain_counts(net, ps),
        "leaves": convert.state_digest(*jax_state(net, ps))}, t0)


def write_dfinity10k_golden(ticks=DFINITY10K_TICKS, chunk=200,
                            ff_ticks=DFINITY10K_FF_TICKS):
    """Leaf sha256s of the JAX package's Dfinity 10k-validator line
    (`tracked_10k_params`), seed 0, after `ticks` engine ticks of
    ``scan_chunk(proto, chunk)`` calls (K=1); then the same run
    fast-forwarded from tick 0 in ``fast_forward_chunk(proto, ticks,
    superstep=2)`` calls to `ff_ticks` (bench_suite's 120 simulated s):
    equal to the dense state at `ticks`, each call's skip counts, and
    the digests and counters at the end.  On an 8-core CPU host about 6
    minutes dense and 3 fast-forwarded, 3.3 GB resident (the run's own
    numbers are in the file, under "generator")."""
    import time

    import jax

    from wittgenstein_tpu.core.network import fast_forward_chunk, scan_chunk
    from wittgenstein_tpu.models.dfinity import Dfinity

    t0 = time.monotonic()
    proto = Dfinity(**tracked_10k_params())
    run = jax.jit(scan_chunk(proto, chunk), donate_argnums=(0, 1))
    net, ps = proto.init(0)
    for t in range(chunk, ticks + 1, chunk):
        net, ps = run(net, ps)
    leaves = convert.state_digest(*jax_state(net, ps))
    counts = _chain_counts(net, ps)
    dense_s = time.monotonic() - t0
    print(f"dfinity 10k golden: {ticks} ticks dense at {dense_s:.0f} s",
          flush=True)
    del net, ps
    ff = jax.jit(fast_forward_chunk(proto, ticks, superstep=2),
                 donate_argnums=(0, 1))
    net, ps = proto.init(0)
    chunks = []
    for t in range(ticks, ff_ticks + 1, ticks):
        net, ps, stats = ff(net, ps)
        chunks.append({k: int(v) for k, v in stats.items()})
        if t == ticks and convert.state_digest(
                *jax_state(net, ps)) != leaves:
            raise AssertionError("fast-forwarded Dfinity differs from the "
                                 "dense run")
    _write_golden(DFINITY10K_GOLDEN_FILE, {
        "config": f"Dfinity(**tracked_10k_params()) = "
                  f"{tracked_10k_params()}"
                  f", {proto.node_count} nodes, seed 0",
        "call": f"jax.jit(wittgenstein_tpu.core.network.scan_chunk(proto, "
                f"{chunk})) called from proto.init(0)",
        "ticks": ticks, "counts": counts, "leaves": leaves,
        "dense_wall_s": round(dense_s, 1),
        "fast_forward": {
            "call": f"jax.jit(wittgenstein_tpu.core.network."
                    f"fast_forward_chunk(proto, {ticks}, superstep=2)) "
                    f"called from proto.init(0) to {ff_ticks} ticks; at "
                    f"{ticks} equal to the dense state",
            "chunks": chunks, "ticks": ff_ticks,
            **{k: sum(c[k] for c in chunks) for k in chunks[0]},
            "counts": _chain_counts(net, ps),
            "leaves": convert.state_digest(*jax_state(net, ps))}}, t0)


def _quiet_golden(proto, path, config, fast_forward):
    """Per-seed leaf sha256s of `proto` on seeds 0..QUIET_SEEDS-1 after
    QUIET_MS ms as `bench.py` `bench_quiet` drives it: QUIET_CHUNK-ms
    ``jax.vmap(scan_chunk(proto, QUIET_CHUNK))`` calls (K=1) over
    ``jax.vmap(proto.init)``; with `fast_forward`, the same batch again
    through ``fast_forward_chunk(proto, QUIET_CHUNK, seed_axis=True,
    superstep=2)`` calls, checked against the dense states, with the
    skip counts of each call."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import fast_forward_chunk, scan_chunk

    t0 = time.monotonic()
    seeds = jnp.arange(QUIET_SEEDS, dtype=jnp.int32)
    run = jax.jit(jax.vmap(scan_chunk(proto, QUIET_CHUNK)))
    nets, ps = jax.vmap(proto.init)(seeds)
    for _ in range(QUIET_MS // QUIET_CHUNK):
        nets, ps = run(nets, ps)
    digests = convert.seed_digests(*jax_state(nets, ps))
    counts = [_chain_counts(*jax.tree.map(lambda x, r=r: x[r:r + 1],
                                          (nets, ps)))
              for r in range(QUIET_SEEDS)]
    body = {"config": config,
            "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                    f"scan_chunk(proto, {QUIET_CHUNK}))) called "
                    f"{QUIET_MS // QUIET_CHUNK} times from jax.vmap("
                    f"proto.init)(jnp.arange({QUIET_SEEDS}))",
            "ms": QUIET_MS, "counts": counts, "seeds": digests}
    if fast_forward:
        ff = jax.jit(fast_forward_chunk(proto, QUIET_CHUNK, seed_axis=True,
                                        superstep=2))
        nets, ps = jax.vmap(proto.init)(seeds)
        chunks = []
        for _ in range(QUIET_MS // QUIET_CHUNK):
            nets, ps, stats = ff(nets, ps)
            chunks.append({k: int(v) for k, v in stats.items()})
        if convert.seed_digests(*jax_state(nets, ps)) != digests:
            raise AssertionError(f"{config}: fast-forwarded batch differs "
                                 "from the dense run")
        body["fast_forward"] = {
            "call": f"jax.jit(wittgenstein_tpu.core.network."
                    f"fast_forward_chunk(proto, {QUIET_CHUNK}, "
                    "seed_axis=True, superstep=2)) called "
                    f"{QUIET_MS // QUIET_CHUNK} times, equal to the dense "
                    "states", "chunks": chunks,
            **{k: sum(c[k] for c in chunks) for k in chunks[0]}}
    _write_golden(path, body, t0)


def write_quiet_goldens():
    """bench_quiet's Dfinity (the reference default, 31 nodes) and
    P2PFlood (`quiet_params`) lines, a minute or two each."""
    from wittgenstein_tpu.models.dfinity import Dfinity
    from wittgenstein_tpu.models.p2pflood import P2PFlood

    _quiet_golden(Dfinity(), DFINITY_QUIET_FILE,
                  "Dfinity(), 31 nodes, seeds 0-3", True)
    _quiet_golden(P2PFlood(**quiet_params()), P2PFLOOD_QUIET_FILE,
                  f"P2PFlood(**quiet_params()) = "
                  f"{quiet_params()}, seeds 0-3", False)


CASPER_GOLDEN_FILE = os.path.join(PORT_DATA,
                                  "golden_casper83_r8_1200ticks.json")
CASPER_SEEDS, CASPER_TICKS, CASPER_CHUNK = 8, 1200, 600
ETHPOW_GOLDEN_FILE = os.path.join(PORT_DATA,
                                  "golden_ethpow10_r5_1500ticks.json")
ETHPOW_RUNS, ETHPOW_TICKS = 5, 1500


def ethpow_line_params(capacity=8192):
    """`try_miner`'s configuration at one hash-power point: 10 miners,
    the selfish miner at 40%, 1-s fixed latency."""
    return dict(number_of_miners=10, byz_class_name="ETHSelfishMiner",
                byz_mining_ratio=0.40,
                network_latency_name="NetworkFixedLatency(1000)",
                capacity=capacity)


def blockchain_counts(net, ps, r):
    """Run r's engine drops and clamps, its arena's blocks and drops,
    its heads' height range and, for Casper, its attestations."""
    def pick(x):
        return np.asarray(x)[r]
    heights = pick(ps.arena.height)[pick(ps.head)]
    out = {k: int(pick(getattr(net, k)))
           for k in ("dropped", "clamped", "bc_dropped")}
    out.update(blocks=int(pick(ps.arena.n)) - 1,
               arena_dropped=int(pick(ps.arena.dropped)),
               height_max=int(heights.max()), height_min=int(heights.min()))
    if hasattr(ps, "att_n"):
        out["att_n"] = int(pick(ps.att_n))
    return out


def without_thr(state):
    """(net_np, pstate_np) with ETHPoW's float leaf `thr` set apart:
    returns the state without it and thr itself."""
    net_np, ps_np = state
    ps_np = dict(ps_np)
    return (net_np, ps_np), ps_np.pop("thr")


def write_casper_golden(seeds=CASPER_SEEDS, ticks=CASPER_TICKS,
                        chunk=CASPER_CHUNK):
    """Per-seed leaf sha256s of the JAX package's ``CasperIMD()`` at its
    defaults (83 nodes, 20-ms ticks), seeds 0..seeds-1 in one batch,
    after each ``jax.vmap(scan_chunk(proto, chunk))`` call to `ticks`
    (K=1; the harness's `run_multiple_times` runs the same vmapped chunk
    when no run stops).  About 4 minutes on an 8-core host beside other
    jobs, 0.7 GB."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.casper import CasperIMD

    t0 = time.monotonic()
    proto = CasperIMD()
    run = jax.jit(jax.vmap(scan_chunk(proto, chunk)))
    nets, ps = jax.vmap(proto.init)(jnp.arange(seeds, dtype=jnp.int32))
    at = {}
    for t in range(chunk, ticks + 1, chunk):
        nets, ps = run(nets, ps)
        at[str(t)] = {"seeds": convert.seed_digests(*jax_state(nets, ps)),
                      "counts": [blockchain_counts(nets, ps, r)
                                 for r in range(seeds)]}
    _write_golden(CASPER_GOLDEN_FILE, {
        "config": f"CasperIMD() defaults, {proto.node_count} nodes, tick "
                  f"{proto.tick_ms} ms, seeds 0-{seeds - 1}",
        "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                f"scan_chunk(proto, {chunk}))) called from jax.vmap("
                f"proto.init)(jnp.arange({seeds}))",
        "ticks": at}, t0)


def write_ethpow_golden(runs=ETHPOW_RUNS, ticks=ETHPOW_TICKS):
    """Per-seed leaf sha256s (all leaves but `thr`, which is stored raw)
    of the JAX package's `try_miner` batch at one point
    (`ethpow_line_params`), seeds 1..runs as `try_miner` numbers them,
    after ``jax.vmap(scan_chunk(proto, ticks))`` (K=1), with each run's
    counters and the CSV row `try_miner` prints for this state.  About
    30 s on an 8-core host, 0.8 GB."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models import ethpow

    t0 = time.monotonic()
    proto = ethpow.ETHPoW(**ethpow_line_params())
    nets, ps = jax.vmap(proto.init)(jnp.arange(1, runs + 1,
                                               dtype=jnp.int32))
    nets, ps = jax.jit(jax.vmap(scan_chunk(proto, ticks)))(nets, ps)
    net_np, ps_np = jax_state(nets, ps)
    (net_np, ps_np), thr = without_thr((net_np, ps_np))
    rew1 = tot = ur = diff = 0.0
    for r in range(runs):
        one = jax.tree.map(lambda x, r=r: x[r], ps)
        base = int(np.asarray(one.head)[0])
        lim = ethpow.GENESIS_HEIGHT
        rw = ethpow.rewards_by_miner(one, base, until_height=lim)
        rew1 += rw.get(1, 0.0)
        tot += sum(rw.values())
        ur += ethpow.uncle_rate(one, base, until_height=lim)
        diff += ethpow.avg_difficulty(one, base, until_height=lim)
    _write_golden(ETHPOW_GOLDEN_FILE, {
        "config": f"ETHPoW(**ethpow_line_params()) = "
                  f"{ethpow_line_params()}, seeds 1-{runs}",
        "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                f"scan_chunk(proto, {ticks}))) called from jax.vmap("
                f"proto.init)(jnp.arange(1, {runs + 1}))",
        "ticks": ticks,
        "seeds": convert.seed_digests(net_np, ps_np),
        "thr": [[float(x) for x in row] for row in thr],
        "counts": [blockchain_counts(nets, ps, r) for r in range(runs)],
        "row": dict(revenue_ratio=rew1 / max(tot, 1e-9),
                    revenue=rew1 / runs, uncle_rate=ur / runs,
                    total_revenue=tot / runs, avg_difficulty=diff / runs)},
        t0)


BYZ_N, BYZ_SEEDS, BYZ_RATIO = 4096, 4, 0.25
BYZ_GOLDEN_FILE = os.path.join(PORT_DATA,
                               "golden_handel4096_byz_suicide_r4.json")
P_SEEDS = 4
ETH2_DENSE_MS, ETH2_FF_MS, ETH2_CHUNK, ETH2_FF_CHUNK = 600, 1100, 200, 500
ETH2_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_handeleth2_64_r4.json")
P2PHANDEL_CHUNK, P2PHANDEL_MAX_MS = 500, 60_000
P2PHANDEL_GOLDEN_FILE = os.path.join(PORT_DATA,
                                     "golden_p2phandel120_r4.json")
OPTIMISTIC_CHUNK, OPTIMISTIC_MAX_MS = 100, 5_000
OPTIMISTIC_GOLDEN_FILE = os.path.join(PORT_DATA,
                                      "golden_optimistic1000_r4.json")


def byz_counts(net_np, ps_np):
    """Per seed of a batched Handel state: drops, clamps, evictions,
    live done fraction and the honest nodes with a non-empty
    blacklist."""
    out = []
    for r in range(len(net_np["time"])):
        live = ~net_np["nodes"]["down"][r]
        bl = np.asarray(ps_np["blacklist"][r])
        out.append({"dropped": int(net_np["dropped"][r]),
                    "clamped": int(net_np["clamped"][r]),
                    "evicted": int(ps_np["evicted"][r]),
                    "frac_done": float(
                        (net_np["nodes"]["done_at"][r][live] > 0).mean()),
                    "honest_blacklisted": int(
                        (bl[live] != 0).any(-1).sum())})
    return out


def write_byz_golden(n=BYZ_N, seeds=BYZ_SEEDS, ratio=BYZ_RATIO):
    """The JAX package's ``handel_scenarios.byz_suicide_sweep(ratios=
    (ratio,), nodes=n, seeds=seeds)``: its CSV text, and per seed the
    stop time, the leaf sha256s of the run's state there and its
    counters (the sweep's one `run_multiple_times` call, captured).  At
    4,096 nodes on an 8-core CPU host the run's own wall and peak RSS
    are in the file, under "generator"."""
    import tempfile
    import time

    from wittgenstein_tpu.scenarios import handel_scenarios as hs

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        csv, res = _captured_harness(hs, lambda: hs.byz_suicide_sweep(
            ratios=(ratio,), nodes=n, seeds=seeds, out_dir=d))
    state = jax_state(res.nets, res.pstates)
    _write_golden(BYZ_GOLDEN_FILE, {
        "config": f"handel_scenarios.default_params(nodes={n}, "
                  f"dead_ratio={ratio}, byzantine_suicide=True), seeds "
                  f"0-{seeds - 1}",
        "call": f"wittgenstein_tpu.scenarios.handel_scenarios."
                f"byz_suicide_sweep(ratios=({ratio},), nodes={n}, "
                f"seeds={seeds}): run_multiple_times(proto, {seeds}, "
                "max_time=8000, chunk=250, cont_if=cont_if_handel)",
        "csv": str(csv),
        "stopped_at": [int(x) for x in np.asarray(res.stopped_at)],
        "counts": byz_counts(*state),
        "seeds": convert.seed_digests(*state)}, t0)


def _batched(jproto, seeds):
    import jax
    import jax.numpy as jnp
    return jax.vmap(jproto.init)(jnp.arange(seeds, dtype=jnp.int32))


def write_eth2_golden(seeds=P_SEEDS):
    """``HandelEth2()`` (64 nodes, pairing 3, level wait 100, period
    50, 4 hash values) with `NetworkLatencyByDistanceWJitter`, seeds
    0-3 in one batch: dense through ``jax.vmap(scan_chunk(proto,
    ETH2_CHUNK))`` to ETH2_DENSE_MS, then on through ``fast_forward_
    chunk(proto, ETH2_FF_CHUNK, seed_axis=True, superstep=2)`` to
    ETH2_FF_MS (1,100 ms: the card's phase P was cut from 6,100, past
    the second aggregation's start, to 1,600 and then 1,100 for time):
    the per-seed leaf
    sha256s at both times and each fast-forwarded call's skip
    counts."""
    import time

    import jax

    from wittgenstein_tpu.core.network import fast_forward_chunk, scan_chunk
    from wittgenstein_tpu.models.handeleth2 import HandelEth2

    t0 = time.monotonic()
    proto = HandelEth2(network_latency_name="NetworkLatencyByDistanceWJitter")
    nets, ps = _batched(proto, seeds)
    run = jax.jit(jax.vmap(scan_chunk(proto, ETH2_CHUNK)))
    for _ in range(ETH2_DENSE_MS // ETH2_CHUNK):
        nets, ps = run(nets, ps)
    dense = jax_state(nets, ps)
    ff = jax.jit(fast_forward_chunk(proto, ETH2_FF_CHUNK, seed_axis=True,
                                    superstep=2))
    chunks = []
    for _ in range((ETH2_FF_MS - ETH2_DENSE_MS) // ETH2_FF_CHUNK):
        nets, ps, st = ff(nets, ps)
        chunks.append({k: int(v) for k, v in st.items()})
    final = jax_state(nets, ps)

    def counts(state):
        net_np, ps_np = state
        return [{"dropped": int(net_np["dropped"][r]),
                 "clamped": int(net_np["clamped"][r]),
                 "agg_done_min": int(ps_np["agg_done"][r].min()),
                 "heights": sorted({int(x) for x in ps_np["height"][r]})}
                for r in range(seeds)]
    _write_golden(ETH2_GOLDEN_FILE, {
        "config": "HandelEth2(network_latency_name="
                  "'NetworkLatencyByDistanceWJitter'), 64 nodes, seeds "
                  f"0-{seeds - 1}",
        "call": f"jax.jit(jax.vmap(scan_chunk(proto, {ETH2_CHUNK}))) to "
                f"{ETH2_DENSE_MS} ms from jax.vmap(proto.init), then "
                f"jax.jit(fast_forward_chunk(proto, {ETH2_FF_CHUNK}, "
                f"seed_axis=True, superstep=2)) to {ETH2_FF_MS} ms",
        "dense": {"ms": ETH2_DENSE_MS, "counts": counts(dense),
                  "seeds": convert.seed_digests(*dense)},
        "fast_forward": {"ms": ETH2_FF_MS, "chunks": chunks,
                         **{k: sum(c[k] for c in chunks)
                            for k in chunks[0]},
                         "counts": counts(final),
                         "seeds": convert.seed_digests(*final)}}, t0)


def write_p2phandel_golden(seeds=P_SEEDS):
    """``P2PHandel(**scenario_params(100, 20))`` (120 nodes, the
    P2PHandelParameters defaults, the distance latency), seeds 0-3 in
    one batch through ``fast_forward_chunk(proto, P2PHANDEL_CHUNK,
    seed_axis=True, superstep=2)`` calls until `cont_if_p2phandel` is
    false for every seed: the stop time, each call's skip counts and
    the per-seed leaf sha256s there."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import fast_forward_chunk
    from wittgenstein_tpu.models.p2phandel import (P2PHandel,
                                                   cont_if_p2phandel)
    from wittgenstein_tpu_torch.models.p2phandel import scenario_params

    t0 = time.monotonic()
    proto = P2PHandel(**scenario_params())
    nets, ps = _batched(proto, seeds)
    ff = jax.jit(fast_forward_chunk(proto, P2PHANDEL_CHUNK, seed_axis=True,
                                    superstep=2))
    cont = jax.jit(jax.vmap(cont_if_p2phandel))
    chunks, t = [], 0
    while bool(jnp.any(cont(nets, ps))):
        if t >= P2PHANDEL_MAX_MS:
            raise RuntimeError(f"P2PHandel did not finish by {t} ms")
        nets, ps, st = ff(nets, ps)
        chunks.append({k: int(v) for k, v in st.items()})
        t += P2PHANDEL_CHUNK
    final = jax_state(nets, ps)
    _write_golden(P2PHANDEL_GOLDEN_FILE, {
        "config": f"P2PHandel(**scenario_params(100, 20)) = "
                  f"{scenario_params()}, seeds 0-{seeds - 1}",
        "call": f"jax.jit(fast_forward_chunk(proto, {P2PHANDEL_CHUNK}, "
                "seed_axis=True, superstep=2)) from jax.vmap(proto.init) "
                "until no seed's cont_if_p2phandel holds",
        "ms": t, "chunks": chunks,
        **{k: sum(c[k] for c in chunks) for k in chunks[0]},
        "counts": _seed_counts(final, seeds),
        "seeds": convert.seed_digests(*final)}, t0)


def write_optimistic_golden(seeds=P_SEEDS):
    """``OptimisticP2PSignature(**main_params())`` (1,000 nodes,
    threshold 501, 13 peers, pairing 3, the distance latency), seeds 0-3
    in one batch through ``jax.vmap(scan_chunk(proto,
    OPTIMISTIC_CHUNK))`` calls until `cont_if_optimistic` is false for
    every seed: the stop time and the per-seed leaf sha256s there."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.optimistic import (OptimisticP2PSignature,
                                                    cont_if_optimistic)
    from wittgenstein_tpu_torch.models.optimistic import main_params

    t0 = time.monotonic()
    proto = OptimisticP2PSignature(**main_params())
    nets, ps = _batched(proto, seeds)
    run = jax.jit(jax.vmap(scan_chunk(proto, OPTIMISTIC_CHUNK)))
    cont = jax.jit(jax.vmap(cont_if_optimistic))
    t = 0
    while bool(jnp.any(cont(nets, ps))):
        if t >= OPTIMISTIC_MAX_MS:
            raise RuntimeError(f"Optimistic did not finish by {t} ms")
        nets, ps = run(nets, ps)
        t += OPTIMISTIC_CHUNK
    final = jax_state(nets, ps)
    card = [int(np.unpackbits(final[1]["received"][r].view(np.uint8),
                              axis=-1).sum(-1).min()) for r in range(seeds)]
    _write_golden(OPTIMISTIC_GOLDEN_FILE, {
        "config": f"OptimisticP2PSignature(**main_params()) = "
                  f"{main_params()}, seeds 0-{seeds - 1}",
        "call": f"jax.jit(jax.vmap(scan_chunk(proto, {OPTIMISTIC_CHUNK})))"
                " from jax.vmap(proto.init) until no seed's "
                "cont_if_optimistic holds",
        "ms": t,
        "counts": [{"dropped": int(final[0]["dropped"][r]),
                    "clamped": int(final[0]["clamped"][r]),
                    "done_max": int(final[0]["nodes"]["done_at"][r].max()),
                    "min_cardinality": card[r]} for r in range(seeds)],
        "seeds": convert.seed_digests(*final)}, t0)


CITY_P2PHANDEL_FILE = os.path.join(PORT_DATA,
                                   "golden_p2phandel_city120_r4.json")
CITY_OPTIMISTIC_N, CITY_OPTIMISTIC_SEEDS = 64, 2
CITY_OPTIMISTIC_REFUSED_N = 1024
CITY_OPTIMISTIC_FILE = os.path.join(PORT_DATA,
                                    "golden_optimistic_city_r2.json")
A_SEEDS = 4
ENR_MS, ENR_CHUNK = 250, 250
ENR_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_enr58_r4.json")
#: tests/test_enr.py's churn configuration (`make(time_to_leave=4_000)`:
#: a joiner every 500 ms, quick exits); to 750 ms seeds 22-25 see a join
#: at 500, an exit at 507 and a capability change at 464 (the first four
#: seeds from 0 with a change and an exit before 750; seeds 0-3 need
#: 1,250 ms)
ENR_CHURN_PARAMS = dict(
    nodes=40, total_peers=5, max_peers=12,
    number_of_different_capabilities=5, cap_per_node=2,
    cap_gossip_time=500, time_to_change=5_000, time_to_leave=4_000,
    changing_nodes=0.4,
    network_latency_name="NetworkLatencyByDistanceWJitter")
ENR_CHURN_MS, ENR_CHURN_FIRST_SEED = 750, 22
ENR_CHURN_FILE = os.path.join(PORT_DATA, "golden_enr48_churn_r4.json")
AVALANCHE_CHUNK, AVALANCHE_MAX_MS = 250, 20_000
AVALANCHE_GOLDEN_FILES = {
    name: os.path.join(PORT_DATA, f"golden_{name.lower()}100_r4.json")
    for name in ("Slush", "Snowflake")}
PAXOS_CHUNK, PAXOS_MAX_MS = 250, 20_000
PAXOS_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_paxos6_r4.json")


def _captured_harness(module, call):
    """``call()`` with `module`'s `run_multiple_times` captured: its
    return value and the last `run_multiple_times` result."""
    got = {}
    orig = module.run_multiple_times

    def capture(*a, **kw):
        got["res"] = orig(*a, **kw)
        return got["res"]
    module.run_multiple_times = capture
    try:
        out = call()
    finally:
        module.run_multiple_times = orig
    return out, got["res"]


def _seed_counts(final, seeds):
    """Per seed: drops, clamps and the latest doneAt."""
    return [{"dropped": int(final[0]["dropped"][r]),
             "clamped": int(final[0]["clamped"][r]),
             "done_max": int(final[0]["nodes"]["done_at"][r].max())}
            for r in range(seeds)]


def write_city_p2phandel_golden(seeds=P_SEEDS):
    """The JAX package's ``p2phandel_scenarios.basic_stats(P2PHandel(
    **default_params(100, 20)), seeds=4)``: 120 nodes placed by city
    with the city jitter latency, seeds 0-3 in one `run_multiple_times`
    batch (chunk 500) until `cont_if_p2phandel` stops every seed: the
    stats dict, the stop times, per seed the leaf sha256s and counts."""
    import time

    from wittgenstein_tpu.models.p2phandel import P2PHandel
    from wittgenstein_tpu.scenarios import p2phandel_scenarios as ps_mod

    t0 = time.monotonic()
    params = ps_mod.default_params(100, 20)
    stats, res = _captured_harness(ps_mod, lambda: ps_mod.basic_stats(
        P2PHandel(**params), seeds))
    final = jax_state(res.nets, res.pstates)
    _write_golden(CITY_P2PHANDEL_FILE, {
        "config": f"P2PHandel(**p2phandel_scenarios.default_params(100, "
                  f"20)) = {params}, seeds 0-{seeds - 1}",
        "call": f"p2phandel_scenarios.basic_stats(proto, seeds={seeds}): "
                "run_multiple_times(proto, 4, max_time=60000, chunk=500, "
                "cont_if=cont_if_p2phandel)",
        "stats": {k: float(v) for k, v in stats.items()},
        "stopped_at": [int(x) for x in np.asarray(res.stopped_at)],
        "counts": _seed_counts(final, seeds),
        "seeds": convert.seed_digests(*final)}, t0)


def refused_count(err):
    """The message count of a harness refusal ("N messages
    dropped/clamped during ..."), or None for another error."""
    head = str(err).split(" messages dropped/clamped during ", 1)
    return int(head[0]) if len(head) == 2 and head[0].isdigit() else None


def write_city_optimistic_golden(n=CITY_OPTIMISTIC_N,
                                 seeds=CITY_OPTIMISTIC_SEEDS,
                                 refused_n=CITY_OPTIMISTIC_REFUSED_N):
    """The JAX package's ``optimistic_scenarios.node_scaling`` (cities,
    the city jitter, threshold 99%, 4 connections, pairing 3), 2 seeds:
    at `refused_n` (its ladder's largest point) the messages its
    `run_multiple_times` counts as dropped or clamped when it refuses
    (every point of the default ladder, 128-1,024 nodes, overflows the
    192-slot inboxes); at `n` the CSV text, the stop times, per seed
    the leaf sha256s, counts and least cardinality."""
    import tempfile
    import time

    from wittgenstein_tpu.scenarios import optimistic_scenarios as os_mod

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        try:
            os_mod.node_scaling(counts=(refused_n,), seeds=seeds, out_dir=d)
            raise AssertionError(f"node_scaling({refused_n}) ran through")
        except RuntimeError as e:
            refused = refused_count(e)
            assert refused, e
        csv, res = _captured_harness(os_mod, lambda: os_mod.node_scaling(
            counts=(n,), seeds=seeds, out_dir=d))
    final = jax_state(res.nets, res.pstates)
    counts = _seed_counts(final, seeds)
    for r, c in enumerate(counts):
        c["min_cardinality"] = int(np.unpackbits(
            final[1]["received"][r].view(np.uint8), axis=-1).sum(-1).min())
        c["all_done"] = bool(final[1]["done"][r].all())
    _write_golden(CITY_OPTIMISTIC_FILE, {
        "config": f"OptimisticP2PSignature(**optimistic_scenarios."
                  f"default_params({n})) = {os_mod.default_params(n)}, "
                  f"seeds 0-{seeds - 1}",
        "call": f"optimistic_scenarios.node_scaling(counts=({n},), "
                f"seeds={seeds}): run_multiple_times(proto, {seeds}, "
                "max_time=60000, chunk=500, cont_if=cont_if_optimistic)",
        "refused": {"nodes": refused_n, "dropped_or_clamped": refused},
        "csv": str(csv),
        "stopped_at": [int(x) for x in np.asarray(res.stopped_at)],
        "counts": counts,
        "seeds": convert.seed_digests(*final)}, t0)


def _until(run, state, cont, chunk, limit, what):
    """``run`` (a jitted chunk function, fast-forwarded when it returns
    skip counts) from the batch `state` until `cont` holds for no seed:
    the state, the stop time and each call's skip counts."""
    import jax
    import jax.numpy as jnp
    cont = jax.jit(jax.vmap(cont))
    stats, t = [], 0
    while bool(jnp.any(cont(*state))):
        if t >= limit:
            raise RuntimeError(f"{what} did not finish by {t} ms")
        out = run(*state)
        state = out[:2]
        if len(out) == 3:
            stats.append({k: int(v) for k, v in out[2].items()})
        t += chunk
    return state, t, stats


def enr_hint_ms(join_at, change_start, time_to_change, ms):
    """The ms below `ms` at which ENR's step hint reports a joiner
    coming up or a capability change due on some node of a batch (from
    the batch's [R, N] ``join_at`` and ``change_start``), as
    ``{"join_ms": [...], "change_ms": [...]}``."""
    join = sorted({int(t) for t in join_at[join_at > 0] if t < ms})
    starts = change_start[change_start > 0]
    change = sorted({int(t) for t in range(ms)
                     if ((starts <= t) & ((t - starts) % time_to_change
                                          == 0)).any()})
    return {"join_ms": join, "change_ms": change}


def write_enr_golden(path, params, ms, seeds=A_SEEDS, first_seed=0):
    """An ENR batch's golden: ``ENRGossiping(**params)``, `seeds` seeds
    from `first_seed` through ``jax.jit(jax.vmap(scan_chunk(proto,
    ENR_CHUNK)))`` to `ms`; per seed the leaf sha256s and counts, and
    the ms at which the step hint must report a joiner or a capability
    change."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.enr import ENRGossiping

    t0 = time.monotonic()
    proto = ENRGossiping(**params)
    state = jax.vmap(proto.init)(jnp.arange(first_seed, first_seed + seeds,
                                            dtype=jnp.int32))
    hint = enr_hint_ms(np.asarray(state[1].join_at),
                       np.asarray(state[1].change_start),
                       proto.time_to_change, ms)
    run = jax.jit(jax.vmap(scan_chunk(proto, ENR_CHUNK)))
    for _ in range(ms // ENR_CHUNK):
        state = run(*state)
    final = jax_state(*state)
    counts = _seed_counts(final, seeds)
    for r, c in enumerate(counts):
        live = ~final[0]["nodes"]["down"][r]
        c["live"] = int(live.sum())
        c["done"] = int((final[0]["nodes"]["done_at"][r][live] > 0).sum())
        c["records"] = int(final[1]["seq"][r].sum())
    _write_golden(path, {
        "config": f"ENRGossiping(**params) ({proto.n_initial} nodes, "
                  f"{proto.join_slots} joiner slots), seeds "
                  f"{first_seed}-{first_seed + seeds - 1}",
        "params": params, "first_seed": first_seed,
        "call": f"jax.jit(jax.vmap(scan_chunk(proto, {ENR_CHUNK}))) from "
                f"jax.vmap(proto.init) to {ms} ms",
        "ms": ms, "hint": hint, "counts": counts,
        "seeds": convert.seed_digests(*final)}, t0)


def write_committee_goldens(seeds=A_SEEDS):
    """Phase A's goldens, seeds 0-3 in one batch of each: `ENRGossiping()`
    (50 nodes, 8 joiner slots) to ENR_MS and, seeds 22-25,
    ENR_CHURN_PARAMS to ENR_CHURN_MS (`write_enr_golden`); `Slush()` and `Snowflake()` (100
    nodes) through ``jax.jit(fast_forward_chunk(proto, AVALANCHE_CHUNK,
    seed_axis=True))`` until every node of every seed has decided, with
    each call's skip counts; `Paxos()` (3 + 3) through ``jax.jit(
    jax.vmap(scan_chunk(proto, PAXOS_CHUNK)))`` until no seed's
    `cont_if` holds.  Per seed the leaf sha256s and counts."""
    import time

    import jax

    from wittgenstein_tpu.core.network import fast_forward_chunk, scan_chunk
    from wittgenstein_tpu.models.avalanche import Slush, Snowflake
    from wittgenstein_tpu.models.paxos import Paxos

    write_enr_golden(ENR_GOLDEN_FILE, {}, ENR_MS, seeds)
    write_enr_golden(ENR_CHURN_FILE, ENR_CHURN_PARAMS, ENR_CHURN_MS, seeds,
                     ENR_CHURN_FIRST_SEED)

    for cls in (Slush, Snowflake):
        t0 = time.monotonic()
        proto = cls()
        ff = jax.jit(fast_forward_chunk(proto, AVALANCHE_CHUNK,
                                        seed_axis=True))
        state, t, chunks = _until(
            ff, _batched(proto, seeds), lambda net, p: ~p.decided.all(),
            AVALANCHE_CHUNK, AVALANCHE_MAX_MS, cls.__name__)
        final = jax_state(*state)
        counts = _seed_counts(final, seeds)
        for r, c in enumerate(counts):
            c["colors"] = np.bincount(final[1]["color"][r],
                                      minlength=3).tolist()
        _write_golden(AVALANCHE_GOLDEN_FILES[cls.__name__], {
            "config": f"{cls.__name__}() (100 nodes, K 7), seeds "
                      f"0-{seeds - 1}",
            "call": f"jax.jit(fast_forward_chunk(proto, {AVALANCHE_CHUNK}, "
                    "seed_axis=True)) from jax.vmap(proto.init) until every "
                    "node of every seed has decided",
            "ms": t, "chunks": chunks,
            **{k: sum(c[k] for c in chunks) for k in chunks[0]},
            "counts": counts, "seeds": convert.seed_digests(*final)}, t0)

    t0 = time.monotonic()
    proto = Paxos()
    run = jax.jit(jax.vmap(scan_chunk(proto, PAXOS_CHUNK)))
    state, t, _ = _until(run, _batched(proto, seeds), proto.cont_if(),
                         PAXOS_CHUNK, PAXOS_MAX_MS, "Paxos")
    final = jax_state(*state)
    counts = _seed_counts(final, seeds)
    for r, c in enumerate(counts):
        c["value"] = int(final[1]["value_accepted"][r][proto.a:].max())
    _write_golden(PAXOS_GOLDEN_FILE, {
        "config": f"Paxos() (3 acceptors, 3 proposers, timeout 1000), "
                  f"seeds 0-{seeds - 1}",
        "call": f"jax.jit(jax.vmap(scan_chunk(proto, {PAXOS_CHUNK}))) from "
                "jax.vmap(proto.init) until no seed's cont_if holds",
        "ms": t, "counts": counts,
        "seeds": convert.seed_digests(*final)}, t0)


#: tests/test_obs.py's, test_trace.py's and test_audit.py's configurations
OBS_HANDEL = dict(node_count=64, threshold=56, nodes_down=6, pairing_time=4,
                  dissemination_period_ms=20, level_wait_time=50,
                  fast_path=10)
OBS_PARAMS = {
    "PingPong": ("pingpong", "PingPong", dict(node_count=64)),
    "Handel": ("handel", "Handel", OBS_HANDEL),
    "HandelCardinal": ("handel", "Handel",
                       dict(OBS_HANDEL, level_wait_time=None,
                            mode="cardinal")),
    "Dfinity": ("dfinity", "Dfinity",
                dict(block_producers_count=10, attesters_count=10,
                     attesters_per_round=10)),
    # test_superstep.py's floor-rich Handel: fixed 16 ms latency
    # licenses the K in {2, 4} window ladder
    "FloorHandel": ("handel", "Handel",
                    dict(OBS_HANDEL, horizon=64,
                         network_latency_name="NetworkFixedLatency(16)")),
}


def obs_protocols(name: str):
    """(JAX protocol, port protocol on the CPU) of an obs test
    configuration."""
    import importlib
    mod, cls, params = OBS_PARAMS[name]
    params = {k: v for k, v in params.items() if v is not None}
    jax_cls = getattr(importlib.import_module(
        f"wittgenstein_tpu.models.{mod}"), cls)
    port_cls = getattr(importlib.import_module(
        f"wittgenstein_tpu_torch.models.{mod}"), cls)
    return jax_cls(**params), port_cls(**params, device="cpu")


def assert_carries_equal(jax_carry, port_carry, what=""):
    """An obs plane's carry (metrics, trace or audit) of the port equal
    to the JAX plane's, leaf for leaf and bit for bit."""
    for fld in dataclasses.fields(port_carry):
        a = np.asarray(getattr(jax_carry, fld.name))
        b = getattr(port_carry, fld.name).cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (
            f"{what} {fld.name}: JAX {a.dtype}{a.shape}, port "
            f"{b.dtype}{b.shape}")
        if not np.array_equal(a, b):
            idx = tuple(int(i) for i in np.argwhere(a != b)[0])
            raise AssertionError(f"{what} {fld.name} differs at {idx}: "
                                 f"JAX {a[idx]!r}, port {b[idx]!r}")


def jax_batch(jproto, seeds):
    """``jax.vmap(jproto.init)`` of seeds 0..seeds-1."""
    import jax
    import jax.numpy as jnp
    return jax.vmap(jproto.init)(jnp.arange(seeds, dtype=jnp.int32))


def port_batch(proto, seeds):
    """The port's batch of seeds 0..seeds-1 (`init_batched`)."""
    import torch

    from wittgenstein_tpu_torch.core.state import init_batched
    return init_batched(proto, torch.arange(seeds))


def assert_port_jax_states(jax_state_, port_state, what=""):
    """A port state (a run or a batch) equal to a JAX one, leaf for
    leaf."""
    assert_states_equal(jax_state(*jax_state_),
                        convert.to_numpy(*port_state), what)


def pytree_leaves(tree):
    """The tensor leaves of a port state or carry, in tree order."""
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


def clone(state):
    """A copy of a port state (the engine writes its ring in place)."""
    import torch
    from torch.utils import _pytree as pytree
    return pytree.tree_map(torch.clone, state)


def first_divergence_cross(jproto, proto, total_ms, chunk_ms=32, seed=0):
    """The cross-package bisector: run the JAX package's `jproto` and the
    port's `proto` from the same seed, side by side in `chunk_ms`
    chunks of the dense per-ms engine, comparing the whole states at
    every boundary; from the last agreeing one, re-run both a ms at a
    time to the first differing ms.  Returns None when the two agree
    over `total_ms`, else ``{"ms", "leaf", "index", "jax", "port"}``:
    the divergent ms (the states agree at its start and differ after
    it), the first differing leaf under the JAX names, its first
    differing element and both values (the record ROADMAP.md queue C
    keeps of a port fault)."""
    import jax
    from torch.utils import _pytree as pytree

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu_torch.core.network import scan_chunk

    def flat(state_np):
        return convert.flatten({"net": state_np[0], "pstate": state_np[1]})

    def copy(state):
        import torch
        return pytree.tree_map(torch.clone, state)

    jstate, pstate = jproto.init(seed), proto.init(seed)
    jrun, prun = jax.jit(jscan(jproto, chunk_ms)), scan_chunk(proto,
                                                              chunk_ms)
    saved, t = (jstate, copy(pstate)), 0
    diff = None
    while t < total_ms:
        jstate, pstate = jrun(*jstate), prun(*pstate, t=t)
        diff = convert.first_difference(flat(jax_state(*jstate)),
                                        flat(convert.to_numpy(*pstate)))
        if diff is not None:
            break
        t += chunk_ms
        saved = (jstate, copy(pstate))
    if diff is None:
        return None
    jstate, pstate = saved[0], copy(saved[1])
    j1, p1 = jax.jit(jscan(jproto, 1)), scan_chunk(proto, 1)
    for ms in range(t, t + chunk_ms):
        jstate, pstate = j1(*jstate), p1(*pstate, t=ms)
        diff = convert.first_difference(flat(jax_state(*jstate)),
                                        flat(convert.to_numpy(*pstate)))
        if diff is not None:
            name, idx, a, b = diff
            return {"ms": ms, "leaf": name, "index": idx, "jax": a,
                    "port": b}
    raise RuntimeError("the ms-by-ms pass lost the divergence the chunk "
                       "pass found: a run is not deterministic")


def _params(protocol: str, n: int) -> dict:
    """Constructor arguments of `protocol` at size `n` (for Dfinity, n
    attesters, committees of up to 10)."""
    if protocol == "dfinity":
        return dict(attesters_count=n, attesters_per_round=min(n, 10))
    if protocol == "p2pflood":
        return quiet_params(n)
    if protocol == "handel":
        from wittgenstein_tpu_torch.models.handel import \
            reference_default_params
        return reference_default_params(n)
    return dict(node_count=n)


_CLASSES = {"pingpong": ("pingpong", "PingPong"),
            "gsf": ("gsf", "GSFSignature"), "handel": ("handel", "Handel"),
            "sanfermin": ("sanfermin", "SanFermin"),
            "cappos": ("sanfermin", "SanFerminCappos"),
            "dfinity": ("dfinity", "Dfinity"),
            "p2pflood": ("p2pflood", "P2PFlood")}


def jax_protocol(protocol: str, n: int):
    """The JAX package's `protocol` at size `n`."""
    import importlib
    mod, cls = _CLASSES[protocol]
    return getattr(importlib.import_module(f"wittgenstein_tpu.models.{mod}"),
                   cls)(**_params(protocol, n))


def port_protocol(protocol: str, n: int, device="cpu"):
    """The port's `protocol` at size `n`, on `device`."""
    import importlib
    mod, cls = _CLASSES[protocol]
    return getattr(importlib.import_module(
        f"wittgenstein_tpu_torch.models.{mod}"), cls)(
            **_params(protocol, n), device=device)


def _protocols(n: int, protocol: str):
    """(JAX protocol, port protocol on the CPU) for `check`."""
    return jax_protocol(protocol, n), port_protocol(protocol, n)


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


CHAOS_HEADLINE_FILE = os.path.join(PORT_DATA,
                                   "golden_headline_chaos_200ms.json")
CHAOS_SEEDS, CHAOS_CHUNK, CHAOS_MS = 16, 100, (100, 200)
CHAOS_CHURN = 32
CHECKPOINT_CHAOS_FILE = os.path.join(
    PORT_DATA, "golden_pingpong1000_r16_chaos_120ms.json")
CKPT_N, CKPT_SEEDS, CKPT_CHUNK, CKPT_MS = 1000, 16, 40, (40, 120)


def chaos_headline_schedule(down, n=HEADLINE_N, churn=CHAOS_CHURN):
    """The fault schedule of `chip_smoke.py` phase X1 as JSON, from the
    batch's entry down flags ([R, N]): churn of the first `churn` nodes
    that are up at init in every seed (a churned node is up outside its
    window), down 40-120 ms; nodes [0, n/2) in partition 1 from 60 to
    140 ms; 200 per mille loss on every link from 20 to 160 ms; +3 ms
    on the links from the first half to the second from 100 to 180 ms.
    Every churn and partition transition is even (K=2 holds)."""
    live = ~np.asarray(down).any(0)
    h = n // 2
    return {"churn": [[int(v), 40, 120]
                      for v in np.flatnonzero(live)[:churn]],
            "partitions": [[60, 140, 1, 0, h]],
            "loss": [[20, 160, 200, 0, n, 0, n]],
            "delay": [[100, 180, 3, 0, h, h, n]]}


def jax_impact(net):
    """`chaos.impact_summary` of a JAX state."""
    from wittgenstein_tpu.chaos import impact_summary
    return impact_summary(net)


def write_chaos_headline_golden(n=HEADLINE_N, seeds=CHAOS_SEEDS,
                                path=CHAOS_HEADLINE_FILE):
    """The benchmark headline under a fault schedule (`chip_smoke.py`
    phase X1): the n-node reference-default Handel, seeds 0-15, wrapped
    in ``ChaosProtocol`` with `chaos_headline_schedule`, through
    ``scan_chunk_batched(proto, 100, t0_mod=0, superstep=2)`` to 200
    ms: per seed the leaf sha256s at 100 and 200 ms, and the batch's
    `impact_summary` there.  About 10 minutes and 5 GB of JAX on an
    8-core CPU host."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.chaos import ChaosProtocol, FaultSchedule
    from wittgenstein_tpu.core.batched import scan_chunk_batched
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu_torch.models.handel import reference_default_params

    t0 = time.monotonic()
    proto = Handel(**reference_default_params(n))
    nets, ps = jax.vmap(proto.init)(jnp.arange(seeds, dtype=jnp.int32))
    sched = chaos_headline_schedule(nets.nodes.down, n)
    cp = ChaosProtocol(proto, FaultSchedule.from_json(sched))
    run = jax.jit(scan_chunk_batched(cp, CHAOS_CHUNK, t0_mod=0,
                                     superstep=2))
    ms = {}
    for t in range(CHAOS_CHUNK, CHAOS_MS[-1] + 1, CHAOS_CHUNK):
        nets, ps = run(nets, ps)
        if t in CHAOS_MS:
            ms[str(t)] = {"seeds": convert.seed_digests(*jax_state(nets,
                                                                   ps)),
                          "impact": jax_impact(nets)}
    _write_golden(path, {
        "config": f"ChaosProtocol(Handel(**reference_default_params({n}))"
                  f", schedule), seeds 0-{seeds - 1}",
        "call": f"jax.jit(wittgenstein_tpu.core.batched.scan_chunk_batched"
                f"(cp, {CHAOS_CHUNK}, t0_mod=0, superstep=2)) from "
                f"jax.vmap(cp.init)(jnp.arange({seeds})), called to "
                f"{CHAOS_MS[-1]} ms",
        "schedule": sched, "ms": ms}, t0)


def checkpoint_chaos_schedule(n=CKPT_N):
    """tests/test_checkpoint.py:111's schedule with its node ranges
    scaled from 64 nodes to `n` (its node ids and times kept)."""
    return {"churn": [[3, 20, 60], [5, 40, 100]],
            "partitions": [[30, 90, 1, 0, n // 2]],
            "loss": [[0, 120, 250, 0, n, 0, n]]}


def write_checkpoint_chaos_golden(n=CKPT_N, seeds=CKPT_SEEDS,
                                  path=CHECKPOINT_CHAOS_FILE):
    """`chip_smoke.py` phase X2's run without the checkpoint: PingPong(n)
    seeds 0-15 under `checkpoint_chaos_schedule`, through
    ``jax.vmap(scan_chunk(cp, 40))`` to 120 ms: per seed the leaf
    sha256s at 40 and 120 ms.  About a minute of JAX on the CPU."""
    import time

    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.chaos import ChaosProtocol, FaultSchedule
    from wittgenstein_tpu.core.network import scan_chunk
    from wittgenstein_tpu.models.pingpong import PingPong

    t0 = time.monotonic()
    sched = checkpoint_chaos_schedule(n)
    cp = ChaosProtocol(PingPong(node_count=n), FaultSchedule.from_json(sched))
    nets, ps = jax.vmap(cp.init)(jnp.arange(seeds, dtype=jnp.int32))
    run = jax.jit(jax.vmap(scan_chunk(cp, CKPT_CHUNK)))
    ms = {}
    for t in range(CKPT_CHUNK, CKPT_MS[-1] + 1, CKPT_CHUNK):
        nets, ps = run(nets, ps)
        if t in CKPT_MS:
            ms[str(t)] = {"seeds": convert.seed_digests(*jax_state(nets,
                                                                   ps)),
                          "impact": jax_impact(nets)}
    _write_golden(path, {
        "config": f"ChaosProtocol(PingPong(node_count={n}), schedule), "
                  f"seeds 0-{seeds - 1}",
        "call": f"jax.jit(jax.vmap(wittgenstein_tpu.core.network."
                f"scan_chunk(cp, {CKPT_CHUNK}))) from jax.vmap(cp.init)("
                f"jnp.arange({seeds})), called to {CKPT_MS[-1]} ms",
        "schedule": sched, "ms": ms}, t0)


MATRIX_HEADLINE_FILE = os.path.join(PORT_DATA,
                                    "golden_matrix_headline_r8.json")
MATRIX_SEEDS, MATRIX_CHUNK, MATRIX_MS = 8, 100, 200
SEARCH_GOLDEN_FILE = os.path.join(PORT_DATA,
                                  "golden_search_pingpong1000.json")
SEARCH_N = 1000


def matrix_headline_grid(schedule, n=HEADLINE_N, seeds=MATRIX_SEEDS):
    """`chip_smoke.py` phase M1's grid as JSON: phase V1's served
    headline (`engine="batched"`, K=2, 100-ms chunks to 200 ms, the
    metrics plane) on seeds 0 to `seeds` - 1, with one axis on the fault
    schedule: none (the fault-free twin) and phase X1's `schedule`."""
    from wittgenstein_tpu_torch.models.handel import reference_default_params
    return {"name": "headline-x1",
            "base": {"protocol": "Handel",
                     "params": reference_default_params(n),
                     "engine": "batched", "superstep": 2,
                     "seeds": list(range(seeds)), "sim_ms": MATRIX_MS,
                     "chunk_ms": MATRIX_CHUNK, "obs": ["metrics"]},
            "axes": [{"name": "chaos", "field": "fault_schedule",
                      "values": [None, schedule],
                      "labels": ["clean", "x1"]}]}


def search_pingpong_spec(n=SEARCH_N):
    """`chip_smoke.py` phase M3's question: tests/test_search.py's
    `_spec()` on `PingPong(n)` — seed 0, 160 ms in 40-ms chunks at
    K=2 under the metrics and audit planes, a fixed 50-ms latency, and
    a 6-step
    ladder of loss from 0 to 100 per mille from 40 ms on every link
    (the test's node range, 32 of 32 nodes, scaled to all `n`), coarse
    2.  The predicate is on ``summary.msg_sent`` (the sends the loss
    leaves, 2,000 to 1,885 along the ladder at 1,000 nodes), not the
    test's done_frac: at 1,000 nodes the witness's inbox caps its pongs
    (1,033 received) and done_frac is 0.999 at every step."""
    return {"name": "pingpong-loss",
            "grid": {"name": "pingpong-loss-ladder",
                     "base": {"protocol": "PingPong",
                              "params": {"node_count": n}, "seeds": [0],
                              "sim_ms": 160, "chunk_ms": 40,
                              "superstep": 2,
                              "obs": ["metrics", "audit"],
                              "latency_model": "NetworkFixedLatency(50)"},
                     "axes": [{"name": "loss", "field": "fault_schedule",
                               "values": [{"loss": [[40, 160, p, 0, n,
                                                     0, n]]}
                                          for p in range(0, 120, 20)],
                               "labels": ["p%03d" % p
                                          for p in range(0, 120, 20)]}]},
            "axis": "loss",
            "predicate": {"field": "summary.msg_sent", "op": ">=",
                          "value": 1950},
            "coarse": 2}


def _report_json(report) -> dict:
    """A report's JSON without its wall and the JAX compile-cache
    directory (tests/serve_parity.py's left-out fields)."""
    d = dict(report.to_json())
    d.pop("wall_s", None)
    if "registry" in d:
        d["registry"] = {k: v for k, v in d["registry"].items()
                         if k != "persistent_cache"}
    return d


def write_matrix_headline_golden(n=HEADLINE_N, seeds=MATRIX_SEEDS,
                                 path=MATRIX_HEADLINE_FILE):
    """Phase M1's grid through the JAX `run_grid(memo=True)` on the CPU:
    the report (no wall), the memo fork plan (`plan_prefixes`), and
    whether each cell's per-seed state digests at 200 ms equal the
    golden they are checked against on the card (the headline's and
    phase X1's, their seeds 0 to `seeds` - 1); a cell that differs
    carries its own digests.  The schedule is built from all 16 seeds'
    entry flags, as X1's is.  About 10 minutes and 6 GB of JAX on an
    8-core CPU host."""
    import tempfile
    import time

    import jax
    import jax.numpy as jnp

    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.matrix import SweepGrid, plan, run_grid
    from wittgenstein_tpu.memo import plan_prefixes
    from wittgenstein_tpu.models.handel import Handel
    from wittgenstein_tpu.serve import Scheduler
    from wittgenstein_tpu_torch.models.handel import reference_default_params

    t0 = time.monotonic()
    proto = Handel(**reference_default_params(n))
    nets, _ = jax.vmap(proto.init)(jnp.arange(CHAOS_SEEDS, dtype=jnp.int32))
    sched = chaos_headline_schedule(nets.nodes.down, n)
    del nets
    grid = SweepGrid.from_json(matrix_headline_grid(sched, n, seeds))
    mplan = plan(grid)
    fplan = plan_prefixes(mplan, min_cells=2)
    with tempfile.TemporaryDirectory() as tmp:
        run = run_grid(grid, Scheduler(ledger_path=os.path.join(
            tmp, "ledger.jsonl")), plan_=mplan, memo=True)
    checks = {"clean": (HEADLINE_GOLDEN_FILE, HEADLINE_MS),
              "x1": (CHAOS_HEADLINE_FILE, CHAOS_MS[-1])}
    cells = {}
    for cell in mplan.cells:
        label = cell.labels["chaos"]
        got = convert.seed_digests(*jax_state(*run.states[cell.id]))
        gpath, gms = checks[label]
        with open(gpath) as f:
            g = json.load(f)
        want = g["seeds"] if "seeds" in g else g["ms"][str(gms)]["seeds"]
        same = got == want[:seeds]
        cells[cell.id] = {"golden": os.path.basename(gpath),
                          "equal": bool(same)}
        if not same:
            cells[cell.id]["seeds"] = got
    _write_golden(path, {
        "config": f"matrix_headline_grid(chaos_headline_schedule(16 "
                  f"seeds' down flags), n={n}, seeds={seeds})",
        "call": "wittgenstein_tpu.matrix.run_grid(grid, Scheduler(), "
                "memo=True)",
        "grid": grid.to_json(), "grid_digest": grid.grid_digest(),
        "schedule": sched,
        "fork_plan": [{"prefix_digest": fg.prefix_digest,
                       "fork_ms": int(fg.fork_ms), "cells": list(fg.cells)}
                      for fg in fplan.groups],
        "report": _report_json(run.report), "cells": cells}, t0)


def write_search_golden(n=SEARCH_N, path=SEARCH_GOLDEN_FILE):
    """Phase M3's question through the JAX `run_search` on the CPU (a
    cold scheduler, memo on): its report without the wall.  About a
    minute of JAX."""
    import tempfile
    import time

    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.matrix import SearchSpec, run_search
    from wittgenstein_tpu.serve import Scheduler

    t0 = time.monotonic()
    spec = SearchSpec.from_json(search_pingpong_spec(n))
    with tempfile.TemporaryDirectory() as tmp:
        run = run_search(spec, Scheduler(ledger_path=os.path.join(
            tmp, "ledger.jsonl")))
    _write_golden(path, {
        "config": f"search_pingpong_spec(n={n})",
        "call": "wittgenstein_tpu.matrix.run_search(spec, Scheduler())",
        "spec": spec.to_json(), "search_digest": spec.digest(),
        "report": _report_json(run.report)}, t0)


def main():
    if sys.argv[1:2] == ["check"]:
        sys.exit(check(int(sys.argv[2]), int(sys.argv[3]),
                       *sys.argv[4:5], *map(int, sys.argv[5:7])))
    if sys.argv[1:2] == ["city-goldens"]:
        write_city_p2phandel_golden()
        write_city_optimistic_golden()
        return
    if sys.argv[1:2] == ["committee-goldens"]:
        write_committee_goldens()
        return
    if sys.argv[1:2] == ["latency-tables"]:
        write_latency_tables()
        return
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
    if sys.argv[1:2] == ["cardinal-golden"]:
        write_cardinal_golden()
        return
    if sys.argv[1:2] == ["tier2-golden"]:
        write_tier2_golden()
        return
    if sys.argv[1:2] == ["attack-golden"]:
        write_attack_golden()
        return
    if sys.argv[1:2] == ["sanfermin-golden"]:
        write_sanfermin_golden()
        return
    if sys.argv[1:2] == ["cappos-golden"]:
        write_cappos_golden()
        return
    if sys.argv[1:2] == ["dfinity10k-golden"]:
        write_dfinity10k_golden()
        return
    if sys.argv[1:2] == ["quiet-golden"]:
        write_quiet_goldens()
        return
    if sys.argv[1:2] == ["casper-golden"]:
        write_casper_golden()
        return
    if sys.argv[1:2] == ["ethpow-golden"]:
        write_ethpow_golden()
        return
    if sys.argv[1:2] == ["byz-golden"]:
        write_byz_golden()
        return
    if sys.argv[1:2] == ["eth2-golden"]:
        write_eth2_golden()
        return
    if sys.argv[1:2] == ["p2phandel-golden"]:
        write_p2phandel_golden()
        return
    if sys.argv[1:2] == ["optimistic-golden"]:
        write_optimistic_golden()
        return
    if sys.argv[1:2] == ["gsf32k-golden"]:
        write_gsf32k_golden()
        return
    if sys.argv[1:2] == ["obs-golden"]:
        write_obs_golden()
        return
    if sys.argv[1:2] == ["chaos-goldens"]:
        write_checkpoint_chaos_golden()
        write_chaos_headline_golden()
        return
    if sys.argv[1:2] == ["matrix-goldens"]:
        write_search_golden()
        write_matrix_headline_golden()
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
