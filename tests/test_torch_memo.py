"""The port's memo plane, its planning and freeze halves
(`wittgenstein_tpu_torch/memo`): the counterparts of tests/test_memo.py:
80-131 and :290-337, held to the JAX package.

Planning: `strip_adversity`, `first_adversity_ms` and `plan_prefixes`
give the JAX package's groups, fork points, prefix keys and skip
reasons.  Freezing, driven chunk by chunk on the port's engine (the
scheduler's `_freeze_pass` waits for the port's scheduler): at every
chunk boundary `build_probe` marks the quiet runs, and for each,
`frozen_final` and `frozen_carries` equal the state and the metrics,
audit and trace carries of stepping its remaining chunks, and equal the
JAX package's `frozen_final` and `frozen_carries` on the same state;
the synthesized audit stays clean and cross-checks with the metrics.
`chaos_noop_before_fork` and `MemoTable` (its key and its files, both
ways) follow.
"""

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.utils import _pytree as pytree

from wittgenstein_tpu_torch import obs
from wittgenstein_tpu_torch.core.state import init_batched
from wittgenstein_tpu_torch.matrix import SweepGrid, plan
from wittgenstein_tpu_torch.memo import (MemoConfig, MemoTable,
                                         build_probe,
                                         chaos_noop_before_fork,
                                         first_adversity_ms, frozen_carries,
                                         frozen_final, plan_prefixes,
                                         strip_adversity)
from wittgenstein_tpu_torch.serve import ScenarioSpec

LOSS_240 = {"loss": [[120, 240, 400, 0, 64, 0, 64]]}
BASE = {"protocol": "PingPong", "params": {"node_count": 64},
        "seeds": [0], "sim_ms": 240, "chunk_ms": 40, "obs": []}
FREEZE = dict(protocol="PingPong", params={"node_count": 64},
              latency_model="NetworkFixedLatency(10)", seeds=(0, 1),
              sim_ms=240, chunk_ms=40, obs=("metrics", "audit", "trace"),
              trace_capacity=1024)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jmemo():
    import wittgenstein_tpu.models  # noqa: F401 — fills the registry
    from wittgenstein_tpu import memo
    return memo


def _grid(cls, base, values, labels=("clean", "adverse")):
    return cls(name="memo-t", base=base, axes=(
        {"name": "chaos", "field": "fault_schedule",
         "values": list(values), "labels": list(labels)},))


def test_strip_and_first_adversity():
    from wittgenstein_tpu.serve import ScenarioSpec as JSpec
    kw = dict(protocol="PingPong", params={"node_count": 64}, sim_ms=240,
              chunk_ms=40, fault_schedule=LOSS_240,
              attack={"at_ms": 200, "leaf": "pongs", "node": 0, "delta": 1})
    spec = ScenarioSpec(**kw)
    assert first_adversity_ms(spec.validate()) == 120 == \
        _jmemo().first_adversity_ms(JSpec(**kw).validate())
    stripped = strip_adversity(spec)
    assert stripped.attack is None and stripped.fault_schedule is None
    assert stripped.digest() == _jmemo().strip_adversity(JSpec(**kw)).digest()
    clean = ScenarioSpec(protocol="PingPong", params={"node_count": 64},
                         sim_ms=240, chunk_ms=40)
    assert stripped.digest() == clean.digest()
    assert stripped.validate().compile_key() == \
        clean.validate().compile_key()
    assert first_adversity_ms(clean.validate()) is None


def _groups(fp):
    return ([(g.prefix_spec.canonical_json(), g.prefix_key, g.prefix_builds,
              g.fork_ms, g.fork_chunks, g.cells, g.prefix_digest)
             for g in fp.groups], fp.skipped, fp.predicted_chunks_saved)


@pytest.mark.parametrize("case", ["one", "floored", "first_chunk",
                                  "clean", "single", "single_kept"])
def test_plan_prefixes_equal_jax(case):
    from wittgenstein_tpu.matrix import SweepGrid as JGrid
    from wittgenstein_tpu.matrix import plan as jplan
    values, kw, labels = {
        "one": ([None, LOSS_240], {}, ("clean", "adverse")),
        "floored": ([None, {"loss": [[130, 240, 400, 0, 64, 0, 64]]}], {},
                    ("clean", "adverse")),
        "first_chunk": ([None, {"loss": [[10, 240, 400, 0, 64, 0, 64]]}],
                        {}, ("clean", "adverse")),
        "clean": ([None], {}, ("clean",)),
        "single": ([LOSS_240], {}, ("only",)),
        "single_kept": ([LOSS_240], {"include_singles": True}, ("only",)),
    }[case]
    fp = plan_prefixes(plan(_grid(SweepGrid, BASE, values, labels)), **kw)
    jfp = _jmemo().plan_prefixes(jplan(_grid(JGrid, BASE, values, labels)),
                                 **kw)
    assert _groups(fp) == _groups(jfp)
    if case == "one":
        (fg,) = fp.groups
        assert fg.fork_ms == 120 and fg.fork_chunks == 3
        assert set(fg.cells) == {"chaos=clean", "chaos=adverse"}
        assert fp.predicted_chunks_saved == 3
    if case == "floored":
        assert fp.groups[0].fork_ms == 120
    if case == "first_chunk":
        assert not fp.groups and "first chunk" in \
            next(iter(fp.skipped.values()))


def _stepped(spec, proto):
    """Every chunk of the spec stepped under each obs plane from the
    same state: ``(states at each boundary, carries per chunk)``."""
    chunk, k = spec.chunk_ms, spec.superstep
    runs = {"metrics": obs.scan_chunk_metrics(
                proto, chunk, obs.MetricsSpec(stat_each_ms=spec.stat_each_ms),
                superstep=k),
            "audit": obs.scan_chunk_audit(proto, chunk, obs.AuditSpec(),
                                          superstep=k),
            "trace": obs.scan_chunk_trace(
                proto, chunk, obs.TraceSpec(capacity=spec.trace_capacity),
                superstep=k)}
    states = [init_batched(proto, torch.tensor(spec.seeds))]
    carries = []
    for c in range(spec.sim_ms // chunk):
        got = {}
        for plane, run in runs.items():
            *state, got[plane] = run(*tp.clone(states[-1]), t=c * chunk)
        states.append(tuple(state))
        carries.append(got)
    return states, carries


def _lane(tree, r):
    return pytree.tree_map(lambda x: x[r:r + 1], tree)


def test_freeze_bit_identity_and_jax():
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu.serve import ScenarioSpec as JSpec
    jmemo = _jmemo()
    spec = ScenarioSpec(**FREEZE).validate()
    proto = spec.build_protocol(device="cpu")
    states, carries = _stepped(spec, proto)
    n_chunks = spec.sim_ms // spec.chunk_ms
    probe = build_probe(proto)
    frozen = 0
    for b in range(n_chunks):
        nw = probe(*states[b]).tolist()
        for r, w in enumerate(nw):
            if w < spec.sim_ms:
                continue
            frozen += 1
            lane = _lane(states[b], r)
            tp.assert_states_equal(
                tp.convert.to_numpy(*_lane(states[-1], r)),
                tp.convert.to_numpy(*frozen_final(proto.cfg, tp.clone(lane),
                                                  spec.sim_ms)),
                f"final frozen at {b * spec.chunk_ms}")
            fc = frozen_carries(spec, proto.cfg, lane, b * spec.chunk_ms,
                                n_chunks - b)
            for c in range(n_chunks - b):
                for plane in spec.obs:
                    tp.assert_carries_equal(
                        _lane(carries[b + c][plane], r), fc[plane][c],
                        f"{plane} chunk {b + c} lane {r}")
    assert frozen >= 2, "no lane froze"
    # the synthesized tail is what the JAX package synthesizes
    jspec = JSpec(**FREEZE).validate()
    jproto = jspec.build_protocol()
    jstate = jax.jit(jax.vmap(jscan(jproto, spec.chunk_ms)))(
        *jax.vmap(jproto.init)(jnp.arange(2, dtype=jnp.int32)))
    assert np.asarray(jmemo.build_probe(jproto)(*jstate)).tolist() == \
        probe(*states[1]).tolist()
    tp.assert_port_jax_states(
        jmemo.frozen_final(jproto.cfg, jstate, spec.sim_ms),
        frozen_final(proto.cfg, tp.clone(states[1]), spec.sim_ms))
    jfc = jmemo.frozen_carries(jspec, jproto.cfg, jstate, spec.chunk_ms, 5)
    fc = frozen_carries(spec, proto.cfg, states[1], spec.chunk_ms, 5)
    for plane in spec.obs:
        for a, b in zip(jfc[plane], fc[plane]):
            tp.assert_carries_equal(a, b, plane)
    aspec = obs.AuditSpec()
    report = obs.AuditReport.from_carries(
        aspec, [carries[0]["audit"]] + fc["audit"],
        monitored=obs.audit.monitored_invariants(aspec, proto.cfg))
    frame = obs.MetricsFrame.from_carries(
        obs.MetricsSpec(stat_each_ms=spec.stat_each_ms),
        [carries[0]["metrics"]] + fc["metrics"])
    assert report.clean and obs.cross_check_metrics(report, frame) == []


def test_probe_respects_pending_transition():
    """A lane with a churn transition still ahead is never frozen: the
    chaos wrapper clamps the oracle at it."""
    from wittgenstein_tpu_torch.core.network import scan_chunk
    spec = ScenarioSpec(**dict(FREEZE, fault_schedule={
        "churn": [[3, 160, 200]]})).validate()
    proto = spec.build_protocol(device="cpu")
    state = init_batched(proto, torch.tensor(spec.seeds))
    state = scan_chunk(proto, 80)(*state, t=0)
    assert max(build_probe(proto)(*state).tolist()) <= 160


def test_chaos_noop_before_fork():
    base = dict(FREEZE, obs=())
    loss = ScenarioSpec(**dict(base, fault_schedule=LOSS_240)).validate()
    churn = ScenarioSpec(**dict(base, fault_schedule={
        "churn": [[3, 160, 200]]})).validate()
    clean = ScenarioSpec(**base).validate()
    proto = clean.build_protocol(device="cpu")
    state = init_batched(proto, torch.tensor(clean.seeds))
    assert chaos_noop_before_fork(clean, state, 120)
    assert chaos_noop_before_fork(loss, state, 120)
    assert chaos_noop_before_fork(churn, state, 120)
    net = state[0]
    down = net.nodes.down.clone()
    down[:, 3] = True
    downed = (net.replace(nodes=net.nodes.replace(down=down)), state[1])
    assert not chaos_noop_before_fork(churn, downed, 120)
    assert chaos_noop_before_fork(loss, downed, 120)


def test_memo_table_roundtrip_and_cross_packages(tmp_path, capsys):
    import jax
    import jax.numpy as jnp

    from wittgenstein_tpu.core.network import scan_chunk as jscan
    from wittgenstein_tpu.serve import ScenarioSpec as JSpec
    jmemo = _jmemo()
    kw = dict(FREEZE, sim_ms=40)
    spec = ScenarioSpec(**kw)
    table = MemoTable(tmp_path / "port")
    assert table.key(spec) == jmemo.MemoTable(tmp_path).key(JSpec(**kw))
    assert table.get(spec, device="cpu") is None
    resolved = spec.validate()
    proto = resolved.build_protocol(device="cpu")
    states, carries = _stepped(resolved, proto)
    state = states[1]
    assert table.put(spec, state, {p: [carries[0][p]] for p in spec.obs})
    got_state, got = table.get(spec, device="cpu")
    tp.assert_states_equal(tp.convert.to_numpy(*state),
                           tp.convert.to_numpy(*got_state), "table state")
    for plane in spec.obs:
        tp.assert_carries_equal(carries[0][plane], got[plane][0], plane)
    assert table.stats()["hits"] == 1 and table.stats()["puts"] == 1
    # a JAX entry is a hit in the port, equal to the JAX state
    jproto = JSpec(**kw).validate().build_protocol()
    jstate = jax.jit(jax.vmap(jscan(jproto, 40)))(
        *jax.vmap(jproto.init)(jnp.arange(2, dtype=jnp.int32)))
    jtable = jmemo.MemoTable(tmp_path / "jax")
    assert jtable.put(JSpec(**kw), jstate, {})
    back = MemoTable(tmp_path / "jax").get(spec, device="cpu")
    tp.assert_port_jax_states(jstate, back[0], "JAX entry")
    assert back[1] == {}
    # a stale entry is a miss with a note, never a wrong state
    import json
    path = table.path(spec)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["spec"]["sim_ms"] = 80
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    assert table.get(spec, device="cpu") is None
    assert "ignoring" in capsys.readouterr().err


def test_memo_config_coerce():
    assert MemoConfig.coerce(True) == MemoConfig()
    assert MemoConfig.coerce({"min_cells": 3}).min_cells == 3
    with pytest.raises(ValueError, match="memo must be"):
        MemoConfig.coerce(7)
    assert MemoConfig().open_table() is None
    assert isinstance(MemoConfig(table="x").open_table(), MemoTable)
