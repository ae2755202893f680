"""ETHPoW in the port (`wittgenstein_tpu_torch/models/ethpow.py`) against
the JAX package's, every leaf exact (tolerance 0, the float32 mining
threshold `thr` included): 5 miners, `NetworkFixedLatency(100)`, 256
blocks, 3,000 ticks, honest, selfish and selfish-2 (every arena keeping
its heights above its parents'); two selfish seeds in one batch at the
proved K (2,000 ticks); `try_miner`'s rows at ``hours=0.01, runs=2,
capacity=256``; `difficulty_s` on EthPoWTest's published chain; two
decisions of `MinerAgentEnv`; XLA's float32 ``exp`` and the threshold on
millions of inputs; the ops of a step not growing with the arena;
`convert.py`'s round trip; and the schema of `chip_smoke.py` phase E's
golden."""

import json

import numpy as np
import pytest
import torch
import torch_parity as tp
from torch.autograd import DeviceType

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.core import network
from wittgenstein_tpu_torch.core.state import Inbox, init_batched
from wittgenstein_tpu_torch.models import ethpow

TICKS, CHUNK = 3000, 1000
MINERS = {"honest": None, "selfish": "ETHSelfishMiner",
          "selfish2": "ETHSelfishMiner2"}


def eth_kw(miner=None, **kw):
    args = dict(number_of_miners=5, byz_class_name=miner,
                byz_mining_ratio=0.4 if miner else 0.0,
                network_latency_name="NetworkFixedLatency(100)",
                capacity=256)
    args.update(kw)
    return args


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def selfish_states():
    from wittgenstein_tpu.models.ethpow import ETHPoW as JETHPoW
    return tp.jax_chunk_states(JETHPoW(**eth_kw("ETHSelfishMiner")), (0, 1),
                               TICKS, CHUNK)


@pytest.mark.parametrize("strategy", sorted(MINERS))
def test_single_run_matches_jax(strategy, selfish_states):
    from wittgenstein_tpu.models.ethpow import ETHPoW as JETHPoW
    miner = MINERS[strategy]
    ref = selfish_states if strategy == "selfish" else \
        tp.jax_chunk_states(JETHPoW(**eth_kw(miner)), (0,), TICKS, CHUNK)
    proto = ethpow.ETHPoW(**eth_kw(miner), device="cpu")
    got, _ = tp.port_chunks(proto, proto.init(0), TICKS, CHUNK, 1)
    for t in range(CHUNK, TICKS + 1, CHUNK):
        tp.assert_states_equal(ref[0, t], got[t], f"{strategy} at {t}")
        tp.assert_heights_ordered(got[t][1]["arena"])
    assert got[TICKS][1]["arena"]["n"] > 3


def test_seed_batch_matches_jax(selfish_states):
    """Two selfish seeds in one batch at the K the gate proves (2) to
    2,000 ticks, each equal to its JAX run, with no per-seed fallback of
    vmap."""
    from test_torch_batched import no_vmap_fallback
    proto = ethpow.ETHPoW(**eth_kw("ETHSelfishMiner"), device="cpu")
    k = network.pick_superstep(proto, CHUNK, t0=0)
    assert k == 2
    with no_vmap_fallback():
        got, _ = tp.port_chunks(proto, init_batched(proto, [0, 1]),
                                2 * CHUNK, CHUNK, k)
    for r in (0, 1):
        for t in (CHUNK, 2 * CHUNK):
            tp.assert_states_equal(selfish_states[r, t],
                                   [tp.seed_state(x, r) for x in got[t]],
                                   f"seed {r} at {t}")


def test_try_miner_rows_match_jax(capsys):
    """`try_miner` (seeds 1-2 in one batch through the harness) prints
    and returns the JAX package's rows."""
    from wittgenstein_tpu.models import ethpow as jethpow
    kw = dict(pows=[0.4], hours=0.01, runs=2, capacity=256, chunk=1200)
    args = (None, "NetworkFixedLatency(1000)", "ETHSelfishMiner")
    want = jethpow.try_miner(*args, **kw)
    want_lines = capsys.readouterr().out.strip().splitlines()
    lines = []
    got = ethpow.try_miner(*args, **kw, device="cpu", out=lines.append)
    assert got == want
    assert lines == want_lines and len(lines) == 2


def test_difficulty_matches_jax():
    """`difficulty_s` along EthPoWTest's published chain (test_ethpow.py's
    gaps and uncle flags), step by step, and around the bomb's period
    boundaries."""
    import jax.numpy as jnp
    from wittgenstein_tpu.models import ethpow as jethpow
    chain = [(13000, False), (7000, False), (4000, False), (39000, False),
             (3000, False), (15000, False), (11000, False), (3000, True)]
    fd, height = ethpow.GENESIS_DIFF_S, ethpow.GENESIS_HEIGHT
    for gap_ms, uncles in chain:
        args = (fd, height, gap_ms // 9000)
        want = int(jethpow.difficulty_s(*map(jnp.int32, args),
                                        jnp.asarray(uncles)))
        got = int(ethpow.difficulty_s(*(torch.tensor(a, dtype=torch.int32)
                                        for a in args), torch.tensor(uncles)))
        assert got == want
        fd, height = got, height + 1
    heights = np.arange(4_999_990, 9_000_010, 99_999, dtype=np.int32)
    gaps = np.arange(len(heights), dtype=np.int32) % 40 - 5
    fds = np.full(len(heights), ethpow.GENESIS_DIFF_S, np.int32)
    flags = np.arange(len(heights)) % 2 == 0
    want = jethpow.difficulty_s(jnp.asarray(fds), jnp.asarray(heights),
                                jnp.asarray(gaps), jnp.asarray(flags))
    got = ethpow.difficulty_s(torch.tensor(fds), torch.tensor(heights),
                              torch.tensor(gaps), torch.tensor(flags))
    assert np.asarray(want).tolist() == got.tolist()


def test_exp_and_threshold_match_xla():
    """`exp_f32` equals the jitted ``jnp.exp`` on 4M float32 inputs over
    [-100, 100] (ETHPoW's own x lies in [-1.2, 0)), subnormal results
    flushed as XLA flushes them; `solve_threshold` equals the jitted JAX
    expression on 1M (hash power, difficulty) pairs."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.uniform(5e-9, 1.3, 3_000_000),
                        rng.uniform(-100, 100, 1_000_000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    assert np.array_equal(want, ethpow.exp_f32(torch.tensor(x)).numpy())
    hp = rng.integers(1, 204_801, 1_000_000).astype(np.int32)
    d = rng.integers(800_000, 1_000_000_001, 1_000_000).astype(np.int32)

    @jax.jit
    def jthr(hp, d):
        return 1.0 - jnp.exp(-(hp.astype(jnp.float32) * (1 << 9)) /
                             (100.0 * d.astype(jnp.float32)))
    want = np.asarray(jthr(jnp.asarray(hp), jnp.asarray(d)))
    got = ethpow.solve_threshold(torch.tensor(hp), torch.tensor(d))
    assert np.array_equal(want, got.numpy())


def test_miner_agent_env_matches_jax():
    """Two decisions of the agent env (cities builder, 1-s latency, 256
    blocks; seed 10 decides at ticks 131 and 1,302), then a publish of
    both private blocks: the same codes, tick, state and observables as
    the JAX env's."""
    from wittgenstein_tpu.models import ethpow as jethpow
    jenv = jethpow.MinerAgentEnv(0.4, seed=10, capacity=256)
    env = ethpow.MinerAgentEnv(0.4, seed=10, capacity=256, device="cpu")
    for i in range(2):
        want = jenv.go_next_step(max_ticks=5_000)
        got = env.go_next_step(max_ticks=5_000)
        assert got == want == env.ON_MINED_BLOCK
        assert int(env.net.time) == int(jenv.net.time)
        tp.assert_states_equal(tp.jax_state(jenv.net, jenv.p),
                               convert.to_numpy(env.net, env.p),
                               f"decision {i}")
    assert env.get_secret_advance() == jenv.get_secret_advance() > 0
    jenv.send_mined_blocks(2)
    env.send_mined_blocks(2)
    tp.assert_states_equal(tp.jax_state(jenv.net, jenv.p),
                           convert.to_numpy(env.net, env.p), "published")
    for name in ("get_secret_advance", "count_my_blocks", "get_advance",
                 "get_lag", "get_reward", "get_reward_ratio", "i_am_ahead",
                 "get_time_in_seconds"):
        assert getattr(env, name)() == getattr(jenv, name)(), name


def _step_ops(capacity):
    proto = ethpow.ETHPoW(**eth_kw("ETHSelfishMiner", capacity=capacity),
                          device="cpu")
    net, ps = proto.init(0)
    n, s = proto.node_count, proto.cfg.inbox_cap + proto.cfg.bcast_slots
    inbox = Inbox(data=torch.zeros(n, s, 1, dtype=torch.int32),
                  src=torch.zeros(n, s, dtype=torch.int32),
                  valid=torch.arange(s)[None, :].expand(n, s) % 5 == 0)
    with torch.profiler.profile() as prof:
        proto.step(ps, net.nodes, inbox, 7, step_hint=(2, True, True))
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.cpu_parent is None and e.name.startswith("aten::"))


def test_step_ops_do_not_grow_with_the_arena():
    """The top-level aten ops of one step walking two inbox slots are the
    same at 256 and 1,024 blocks: every walk is by set."""
    ops = [_step_ops(c) for c in (256, 1024)]
    assert ops[0] == ops[1] and ops[0] > 200, ops


def test_convert_round_trip(selfish_states):
    net, ps = convert.from_reference(*selfish_states[1, TICKS], "cpu")
    tp.assert_states_equal(selfish_states[1, TICKS],
                           convert.to_numpy(net, ps), "round trip")
    assert int(ps.arena.n) > 1 and bool((ps.arena.anc != 0).any())


def test_try_miner_golden_schema():
    """`chip_smoke.py` phase E's golden: `try_miner`'s 5 seeds at 1,500
    ticks, every leaf but `thr` digested under the port's leaf names,
    `thr` raw, zero drops, and the CSV row's numbers."""
    with open(tp.ETHPOW_GOLDEN_FILE) as f:
        golden = json.load(f)
    assert golden["call"].startswith("jax.jit(jax.vmap(")
    assert "scan_chunk(proto, 1500)" in golden["call"]
    assert {"wall_s", "peak_rss_gb"} <= set(golden["generator"])
    proto = ethpow.ETHPoW(**tp.ethpow_line_params(), device="cpu")
    (net_np, ps_np), _ = tp.without_thr(convert.to_numpy(*proto.init(1)))
    names = sorted(convert.state_digest(net_np, ps_np))
    assert len(golden["seeds"]) == len(golden["thr"]) == tp.ETHPOW_RUNS
    for leaves, thr, counts in zip(golden["seeds"], golden["thr"],
                                   golden["counts"]):
        assert sorted(leaves) == names and len(thr) == 10
        assert counts["dropped"] == counts["bc_dropped"] == 0
        assert counts["blocks"] >= 1
    assert set(golden["row"]) == {"revenue_ratio", "revenue", "uncle_rate",
                                  "total_revenue", "avg_difficulty"}
