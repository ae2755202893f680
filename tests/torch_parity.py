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
lines; and Casper IMD's reference configuration and `try_miner`'s
ETHPoW batch, ``... casper-golden`` and ``... ethpow-golden``).

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
GSF_BATCH_FILE = os.path.join(PORT_DATA, "golden_gsf4096_r4_150ms.json")
GSF_BATCH_SEEDS, GSF_BATCH_MS = 4, 150
FF_STATS_FILE = os.path.join(PORT_DATA, "golden_pingpong1000_ff_stats.json")
CARDINAL_N, CARDINAL_MS = 65536, (200, 1000)
CARDINAL_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_cardinal65536_k2.json")
TIER2_N, TIER2_MS = 32768, (100, 400)
TIER2_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_tier2_32768.json")
ATTACK_N, ATTACK_MS = 1024, 200
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
    bit-identical to the per-ms one).  On an 8-core CPU host: 437 s and
    13.4 GB resident to 400 ms (the run's own numbers are in the file,
    under "generator")."""
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


SANFERMIN_N, SANFERMIN_MS, SANFERMIN_BOX_SPLIT = 32768, (500, 1000), 2
SANFERMIN_GOLDEN_FILE = os.path.join(PORT_DATA,
                                     "golden_sanfermin32768_box2.json")
CAPPOS_MS = 100
CAPPOS_GOLDEN_FILE = os.path.join(PORT_DATA, "golden_cappos2048_100ms.json")
DFINITY10K_TICKS, DFINITY10K_FF_TICKS = 400, 12000
DFINITY10K_GOLDEN_FILE = os.path.join(PORT_DATA,
                                      "golden_dfinity10k_400ticks.json")
QUIET_SEEDS, QUIET_MS, QUIET_CHUNK = 4, 400, 200
DFINITY_QUIET_FILE = os.path.join(PORT_DATA,
                                  "golden_dfinity31_r4_400ticks.json")
P2PFLOOD_QUIET_FILE = os.path.join(PORT_DATA,
                                   "golden_p2pflood256_r4_400ms.json")


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


def write_sanfermin_golden(n=SANFERMIN_N, ms=SANFERMIN_MS, chunk=500):
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
                                  "golden_casper83_r8_4000ticks.json")
CASPER_SEEDS, CASPER_TICKS, CASPER_CHUNK = 8, 4000, 2000
ETHPOW_GOLDEN_FILE = os.path.join(PORT_DATA,
                                  "golden_ethpow10_r5_3000ticks.json")
ETHPOW_RUNS, ETHPOW_TICKS = 5, 3000


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
