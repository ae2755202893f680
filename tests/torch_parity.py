"""Shared helpers of the `tests/test_torch_*.py` parity tests: the JAX
package's state as nested numpy dicts, a leaf-by-leaf comparison that
names the first difference, and the generators of the artifacts the
port ships (the distance-latency table, the 2048-node Handel golden
digest and the 4096-node GSF golden digest).

Regenerate all three with ``JAX_PLATFORMS=cpu python
tests/torch_parity.py`` (``... tests/torch_parity.py gsf-golden`` for the
GSF digest alone); ``... tests/torch_parity.py check N MS`` runs the
N-node reference-default Handel in both packages on the CPU for MS ms
and compares the full state every 100 ms, and ``... check N MS gsf``
does the same for ``GSFSignature(node_count=N)`` with its defaults.
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


def jax_nested(obj):
    """A JAX state dataclass (flax struct) as nested dicts of numpy
    arrays under its field names; tuples become lists."""
    import jax

    if dataclasses.is_dataclass(obj):
        return {f.name: jax_nested(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
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


def _protocols(n: int, protocol: str):
    """(JAX protocol, port protocol on the CPU) for `check`."""
    if protocol == "gsf":
        from wittgenstein_tpu.models.gsf import GSFSignature as JGSF
        from wittgenstein_tpu_torch.models.gsf import GSFSignature
        return JGSF(node_count=n), GSFSignature(node_count=n, device="cpu")
    from wittgenstein_tpu.models.handel import Handel as JHandel
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    params = reference_default_params(n)
    return JHandel(**params), Handel(**params, device="cpu")


def check(n: int, ms: int, protocol: str = "handel", every: int = 100):
    """Both packages from their own init, full state compared every
    `every` ms; prints each checkpoint and stops at the first
    difference."""
    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu_torch.core.network import Runner

    jproto, proto = _protocols(n, protocol)
    jstate, state = jproto.init(0), proto.init(0)
    jrun, run = JRunner(jproto), Runner(proto)
    for t in range(every, ms + 1, every):
        jstate = jrun.run_ms(*jstate, every)
        state = run.run_ms(*state, every)
        a = convert.flatten(dict(zip(("net", "pstate"),
                                     jax_state(*jstate))))
        b = convert.flatten(dict(zip(("net", "pstate"),
                                     convert.to_numpy(*state))))
        diff = convert.first_difference(a, b)
        print(f"{protocol} {n} nodes, {t} ms: "
              f"{'equal' if diff is None else f'DIFFERENT {diff}'}",
              flush=True)
        if diff is not None:
            return 1
    return 0


def main():
    if sys.argv[1:2] == ["check"]:
        sys.exit(check(int(sys.argv[2]), int(sys.argv[3]),
                       *sys.argv[4:5]))
    if sys.argv[1:2] == ["gsf-golden"]:
        write_gsf_golden()
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
