"""The port's host utilities, held to the JAX package's: `utils/jsonl.py`
(the crash-safe append and the torn-tail-tolerant reader; the same rows
write the same bytes), `utils/platform.py` (the platform facts a ledger
row and `/w/batch/health` report), `utils/profiling.py` (the timers and
the one-line run report: the JAX report's text for the same state) and
`utils/kademlia.py` (the XOR distance and bucket index against the
reference's scalar loop and the JAX function)."""

import numpy as np
import pytest
import torch

from wittgenstein_tpu_torch.utils import jsonl, kademlia, platform
from wittgenstein_tpu_torch.utils.profiling import run_report, timed, trace


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ jsonl


def test_jsonl_append_read_rewrite_equal_jax(tmp_path, capsys):
    """The same rows append to the same bytes; a torn tail and a
    malformed interior row are skipped loudly; `rewrite` replaces the
    file with exactly its rows."""
    from wittgenstein_tpu.utils import jsonl as jjsonl
    rows = [{"b": 1, "a": [1, 2]}, {"kind": "x", "v": 0.5}]
    paths = [tmp_path / "port.jsonl", tmp_path / "jax.jsonl"]
    for mod, p in zip((jsonl, jjsonl), paths):
        for r in rows:
            mod.append_line(p, r)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with open(paths[0], "a") as f:
        f.write("{not json}\n")
        f.write(str({"x": 1}).replace("'", '"') + "\n")
        f.write('{"torn": ')
    got = [r for _, r in jsonl.iter_lines(paths[0], label="t")]
    assert got == rows + [{"x": 1}]
    err = capsys.readouterr().err
    assert "torn final line" in err
    assert jsonl.read_lines(paths[0]) == got
    jsonl.rewrite(paths[0], rows[:1])
    assert jsonl.read_lines(paths[0]) == rows[:1]
    assert jsonl.read_lines(tmp_path / "missing.jsonl") == []


def test_jsonl_tail_reader_follows_appends(tmp_path):
    p = tmp_path / "tail.jsonl"
    reader = jsonl.TailReader(p)
    assert reader.poll() == []
    jsonl.append_line(p, {"i": 0})
    jsonl.append_line(p, {"i": 1})
    assert [r["i"] for r in reader.poll()] == [0, 1]
    with open(p, "a") as f:
        f.write('{"i": 2')               # half a line: not yet a row
    assert reader.poll() == []
    with open(p, "a") as f:
        f.write("}\n")
    assert [r["i"] for r in reader.poll()] == [2]


# --------------------------------------------------------------- platform


def test_platform_facts_of_the_cpu():
    facts = platform.device_facts("cpu")
    assert facts == {"backend": "cpu", "device_name": "cpu",
                     "device_count": 1, "power_limit": None}
    assert platform.backend("cpu") == "cpu"
    assert platform.backend() == ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    line = platform.smi_line()
    assert line is None or "," in line


@pytest.mark.cuda
def test_platform_facts_of_the_card():
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    facts = platform.device_facts("cuda")
    assert facts["backend"] == "cuda"
    assert facts["device_name"] == torch.cuda.get_device_name(0)
    assert facts["device_count"] == torch.cuda.device_count()
    assert facts["power_limit"] is not None


# -------------------------------------------------------------- profiling


def test_run_report_and_timers_equal_jax():
    """The report of a 300-ms PingPong(64) run is the JAX report's text
    for the same state (the wall part aside), and `trace(None)` is a
    no-op."""
    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.core.network import Runner as JRunner
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    from wittgenstein_tpu.utils.profiling import run_report as jreport

    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=64, device="cpu")
    with timed() as t:
        with trace(None):
            runner = Runner(proto)
            net, _ = runner.run_ms(*proto.init(0), 300)
    wall = t()
    rep = run_report(net, wall)
    assert rep.startswith("Simulation execution time:")
    assert "sim=300ms" in rep and "live=64" in rep and "sim-ms/s" in rep
    jproto = JPingPong(node_count=64)
    jnet, _ = JRunner(jproto, donate=False).run_ms(*jproto.init(0), 300)
    assert run_report(net) == jreport(jnet)
    assert runner.run_report(net) == run_report(net)


def test_run_report_parts_and_frozen_timer():
    """All nodes down: no crash, no NaN; the ff, trace and audit parts
    render as the JAX report renders them; the timer freezes at exit."""
    import time as _time

    from wittgenstein_tpu.utils.profiling import run_report as jreport

    from wittgenstein_tpu_torch.models.pingpong import PingPong
    proto = PingPong(node_count=8, device="cpu")
    net, _ = proto.init(0)
    net = net.replace(nodes=net.nodes.replace(
        down=torch.ones(8, dtype=torch.bool)))
    rep = run_report(net)
    assert "live=0" in rep and "nan" not in rep
    ff = {"skipped_ms": 10, "jump_count": 2}
    tr = {"events": 5, "high_water": 5, "capacity": 4, "dropped": 1}
    au = {"total": 2, "invariants": ["a", "b"],
          "violations": {"a": 2, "b": 0},
          "first": {"ms": 3, "invariant": "a", "index": 1}}
    import jax.numpy as jnp
    from wittgenstein_tpu.models.pingpong import PingPong as JPingPong
    jnet, _ = JPingPong(node_count=8).init(0)
    jnet = jnet.replace(nodes=jnet.nodes.replace(
        down=jnp.ones(8, bool)))
    assert run_report(net, ff=ff, trace=tr, audit=au) == \
        jreport(jnet, ff=ff, trace=tr, audit=au)
    with timed() as t:
        _time.sleep(0.05)
    frozen = t()
    _time.sleep(0.05)
    assert abs(t() - frozen) < 1e-9


# --------------------------------------------------------------- kademlia


def _ref_distance(v1, v2):
    """The reference algorithm (Kademlia.java:8-29), for oracle use."""
    if list(v1) == list(v2):
        return 0
    d = len(v1) * 8
    for i in range(len(v1)):
        xor = v1[i] ^ v2[i]
        if xor == 0:
            d -= 8
        else:
            p = 7
            while (xor >> p) & 1 == 0:
                d -= 1
                p -= 1
            break
    return d


def test_kademlia_distance_matches_reference_and_jax():
    import jax.numpy as jnp
    from wittgenstein_tpu.utils.kademlia import distance as jdistance
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (200, 8), dtype=np.uint8)
    b = rng.integers(0, 256, (200, 8), dtype=np.uint8)
    b[:50] = a[:50]
    b[50:100, :4] = a[50:100, :4]
    got = kademlia.distance(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    want = np.array([_ref_distance(a[i], b[i]) for i in range(200)])
    assert (got.numpy() == want).all()
    assert (got.numpy() == np.asarray(jdistance(jnp.asarray(a),
                                                jnp.asarray(b)))).all()


def test_kademlia_bucket_index():
    a = torch.zeros(8, dtype=torch.uint8)
    far = torch.full((8,), 255, dtype=torch.uint8)
    assert int(kademlia.bucket_index(a, a)) == 0
    assert int(kademlia.bucket_index(a, far)) == 63
    assert int(kademlia.bucket_index(a, far, n_buckets=32)) == 31
