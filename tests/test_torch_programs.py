"""The port's program observatory (`wittgenstein_tpu_torch/obs/
programs.py`) and its seats in the request plane: the twins of
tests/test_programs.py under the port's semantics (a first launch
measured, not compiled: its wall, its memory block, each kernel's
launches, the working-set ratio in place of the cost-model drift),
the readers over a directory that mixes a JAX worker's catalog with the
port's, and a ``cuda`` test of the working set and the launch counts on
the card.

The module imports no JAX at the top: the ``cuda`` test runs on the
card's machine, which has none.  The one JAX catalog (a JAX scheduler's
real row) is made once, in a module fixture.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from wittgenstein_tpu_torch.obs.metrics import parse_exposition
from wittgenstein_tpu_torch.obs.programs import (CatalogProgram,
                                                 ProgramCatalog,
                                                 read_catalog,
                                                 summarize_programs)
from wittgenstein_tpu_torch.serve import (FleetService, ScenarioSpec,
                                          Scheduler, Service)
from wittgenstein_tpu_torch.serve.instrument import (Instrumentation,
                                                     scheduler_exposition)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FixedProbe:
    """An injected memory probe: every capture's working set is
    `temp` bytes (the CPU has no peak counter)."""

    def __init__(self, temp):
        self.temp = temp

    def begin(self, device):
        return 0

    def end(self, device, token):
        return self.temp


def _spec(**kw):
    """catalog_smoke's spec, 80 ms of it unless given."""
    base = dict(protocol="PingPong", params={"node_count": 64},
                seeds=(0,), sim_ms=80, chunk_ms=40, obs=("metrics",))
    base.update(kw)
    return ScenarioSpec(**base)


def _run(sch, spec=None):
    rid = sch.submit(spec or _spec())
    sch.run_pending()
    req = sch.request(rid)
    assert req.status == "done", req.error
    return req


# ------------------------------------------------------- catalog is OFF

def test_catalog_off_imports_nothing():
    """A plain scheduler run never imports the observatory module."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from wittgenstein_tpu_torch.serve import ScenarioSpec, Scheduler\n"
        "sch = Scheduler(device='cpu', ledger_path='/dev/null')\n"
        "rid = sch.submit(ScenarioSpec(protocol='PingPong',"
        " params={'node_count': 64}, seeds=(0,), sim_ms=80,"
        " chunk_ms=40, obs=('metrics',)))\n"
        "sch.run_pending()\n"
        "assert sch.request(rid).status == 'done'\n"
        "assert 'wittgenstein_tpu_torch.obs.programs' not in sys.modules, "
        "'catalog=None imported the observatory'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_catalog_off_write_paths_never_touched(monkeypatch, tmp_path):
    """Every catalog write path rigged to explode; a whole lifecycle
    with catalog=None touches none of them."""
    def boom(*a, **k):
        raise AssertionError("catalog touched with catalog OFF")
    monkeypatch.setattr(CatalogProgram, "__init__", boom)
    monkeypatch.setattr(ProgramCatalog, "record_build", boom)
    monkeypatch.setattr(ProgramCatalog, "record_program", boom)
    monkeypatch.setattr(ProgramCatalog, "observe_chunk", boom)
    sch = Scheduler(device="cpu", ledger_path=tmp_path / "l.jsonl")
    assert sch.catalog is None and sch.registry.catalog is None
    _run(sch)


# ------------------------------------------------------ row round trip

def test_cold_build_round_trips_one_row(tmp_path):
    """One cold program, one durable row with the port's fields; a warm
    request on the same compile key adds none; the chunk walls
    aggregate per key.  On the CPU the memory block has no temp_bytes,
    so the drift pass has no temp_ratio."""
    p = tmp_path / "programs.jsonl"
    cat = ProgramCatalog(path=p)
    sch = Scheduler(catalog=cat, device="cpu",
                    ledger_path=tmp_path / "l.jsonl")
    _run(sch)
    _run(sch, _spec(seeds=(1,)))
    rows = read_catalog(p)
    assert len(rows) == 1, [r.get("key") for r in rows]
    row = rows[0]
    for field in ("schema", "kind", "key", "plane", "backend", "protocol",
                  "engine", "chunk_ms", "superstep", "build_wall_s",
                  "lower_wall_s", "compile_wall_s", "memory", "cost",
                  "arg_leaves", "batch"):
        assert field in row, (field, sorted(row))
    assert "predicted" not in row
    assert row["key"] == _spec().validate().compile_key()
    assert (row["plane"], row["backend"], row["batch"]) == \
        ("metrics", "cpu", 1)
    assert row["lower_wall_s"] == 0.0 and row["compile_wall_s"] > 0
    mem = row["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert "temp_bytes" not in mem
    # the wrappers run their plain versions on the CPU: no launch
    assert row["cost"] == {"launches": {"route": 0, "merge": 0,
                                        "score": 0, "gsf_merge": 0,
                                        "gsf_score": 0}}
    stats = cat.chunk_stats()
    assert stats[row["key"]]["count"] >= 2, stats
    [d] = cat.drift()
    assert "temp_ratio" not in d and d["chunks"] >= 2, d
    rep = cat.report()
    assert rep["count"] == 1 and not rep["drift_outliers"]
    assert rep["top_compile"][0]["key"] == row["key"]
    assert rep["catalog"]["path"] == str(p)


def test_states_equal_catalog_on_off(tmp_path):
    """catalog_smoke's spec (PingPong(64), 120 ms in 40-ms chunks) under
    two planes: with the catalog on, the final state, the carries and
    the artifacts equal the run with it off (outside the wall); the
    fused program records one row a plane."""
    spec = _spec(sim_ms=120, obs=("metrics", "audit"))
    a = _run(Scheduler(device="cpu", ledger_path=tmp_path / "a.jsonl"),
             spec)
    cat = ProgramCatalog(path=tmp_path / "p.jsonl")
    b = _run(Scheduler(device="cpu", catalog=cat,
                       ledger_path=tmp_path / "b.jsonl"), spec)
    from torch.utils import _pytree as pytree
    la, lb = pytree.tree_leaves(a.final_state), \
        pytree.tree_leaves(b.final_state)
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
    norm = lambda d: json.dumps(                       # noqa: E731
        {k: v for k, v in d.items() if k != "wall_s"},
        sort_keys=True, default=str)
    assert norm(a.artifacts) == norm(b.artifacts)
    assert [(r["plane"], r["memory"]) for r in cat.programs()] == \
        [("metrics", cat.programs()[0]["memory"]),
         ("audit", cat.programs()[0]["memory"])]


def test_registry_hands_out_catalog_programs(tmp_path):
    """`CompileRegistry(catalog=)` stages the build and wraps the
    per-plane and the fused programs; a repeat lookup is the same
    wrapper (a hit, no second row)."""
    from wittgenstein_tpu_torch.serve import CompileRegistry
    cat = ProgramCatalog()
    reg = CompileRegistry(catalog=cat, device="cpu")
    spec = _spec(obs=("metrics", "audit")).validate()
    progs = [reg.chunk_fn(spec, "metrics"), reg.chunk_fn(spec, "audit")]
    assert all(isinstance(p, CatalogProgram) for p in progs)
    assert reg.chunk_fn(spec, "metrics") is progs[0]
    fused = reg.fused(spec, progs)
    assert isinstance(fused, CatalogProgram)
    assert fused.planes == ("metrics", "audit")
    assert cat.stats()["pending_builds"] == 2
    assert (reg.hits, reg.misses) == (1, 2)


# ----------------------------------------------------------- durability

def test_torn_tail_reload(tmp_path):
    p = tmp_path / "programs.jsonl"
    cat = ProgramCatalog(path=p)
    cat.record_program("k1", "metrics", lower_wall_s=0.0,
                       compile_wall_s=0.5, memory={"temp_bytes": 10},
                       cost={"launches": {"route": 1}})
    cat.record_program("k2", "metrics", lower_wall_s=0.0,
                       compile_wall_s=0.7, memory={"temp_bytes": 20},
                       cost={})
    with open(p, "ab") as f:        # the SIGKILL mid-append shape
        f.write(b'{"schema": 1, "key": "k3", "compile_wa')
    assert [r["key"] for r in read_catalog(p)] == ["k1", "k2"]


def test_sigkill_mid_append_at_most_one_torn_row(tmp_path):
    """A real SIGKILL against a process appending catalog rows in a
    loop: every complete row parses, and the raw file holds at most ONE
    extra (torn) line."""
    p = tmp_path / "programs.jsonl"
    code = (
        "from wittgenstein_tpu_torch.obs.programs import ProgramCatalog\n"
        f"cat = ProgramCatalog(path={str(p)!r}, fsync=False)\n"
        "for i in range(100000):\n"
        "    cat.record_program(f'k{i}', 'metrics', lower_wall_s=0.0,\n"
        "        compile_wall_s=0.5, memory={'temp_bytes': i},\n"
        "        cost={'launches': {'route': i}})\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if p.exists() and p.stat().st_size > 4096:
                break
            time.sleep(0.05)
        assert p.exists(), "writer never produced a row"
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=30)
    rows = read_catalog(p)
    raw_lines = len([ln for ln in p.read_bytes().split(b"\n") if ln])
    assert rows, "no complete rows survived the kill"
    assert raw_lines - len(rows) <= 1, (raw_lines, len(rows))
    assert all(r["key"] == f"k{i}" for i, r in enumerate(rows))


def test_write_error_degrades_loudly(tmp_path, capsys):
    """An unwritable catalog path does not take the launch down: the
    row is kept in memory, counted, and shouted to stderr."""
    cat = ProgramCatalog(path=tmp_path)    # a DIRECTORY: open() fails
    row = cat.record_program("k", "metrics", lower_wall_s=0.0,
                             compile_wall_s=0.5, memory={}, cost={})
    assert row is not None and cat.programs() == [row]
    assert cat.stats()["write_errors"] == 1
    assert "programs" in capsys.readouterr().err


# -------------------------------------------------------------- metrics

def test_registry_and_temp_ratio_gauges_in_exposition(tmp_path):
    """With an injected probe the CPU run has a working set: the
    exposition carries the registry gauges, the program table, the
    working-set ratio and the chunk-wall histogram fed through the
    shared registry."""
    ins = Instrumentation(worker="t")
    cat = ProgramCatalog(path=tmp_path / "p.jsonl",
                         memory_probe=FixedProbe(4096))
    sch = Scheduler(instrument=ins, catalog=cat, device="cpu",
                    ledger_path=tmp_path / "l.jsonl")
    assert cat.metrics is ins.metrics      # adopted, one registry
    _run(sch)
    m = parse_exposition(scheduler_exposition(sch))
    assert m.get("wtpu_registry_misses", 0) >= 1
    assert "wtpu_registry_hits" in m
    assert m.get("wtpu_programs_cataloged") == 1
    row = read_catalog(tmp_path / "p.jsonl")[0]
    key, arg = row["key"], row["memory"]["argument_bytes"]
    assert row["memory"]["temp_bytes"] == 4096
    series = f'wtpu_program_temp_ratio{{key="{key}",plane="metrics"}}'
    assert m[series] == round(4096 / arg, 4)
    assert m[f'wtpu_program_temp_bytes{{key="{key}",plane="metrics"}}'] \
        == 4096
    assert not any(k.startswith("wtpu_costmodel_drift") for k in m)
    assert any(k.startswith("wtpu_program_compile_seconds{") for k in m)
    assert m.get("wtpu_program_chunk_seconds_count", 0) >= 1
    assert m[f'wtpu_program_chunks_total{{key="{key}"}}'] == 2


def test_programs_endpoint(tmp_path):
    """`Service.programs` and ``/w/batch/programs`` serve the report;
    without a catalog the answer is ``{"catalog": "off"}``."""
    from wittgenstein_tpu_torch.server.http import make_server
    off = Service(scheduler=Scheduler(device="cpu"), auto=False).programs()
    assert off == {"catalog": "off", "programs": [], "count": 0}
    sch = Scheduler(catalog=ProgramCatalog(
        path=tmp_path / "p.jsonl", memory_probe=FixedProbe(1 << 20)),
        device="cpu", ledger_path=tmp_path / "l.jsonl")
    httpd = make_server(port=0, batch_auto=False, scheduler=sch,
                        device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        svc = httpd.batch_service
        svc.submit(_spec().to_json())
        svc.run_pending()
        rep = svc.programs()
        assert rep["count"] == 1 and rep["top_compile"]
        assert rep["drift"][0]["temp_ratio"] > 0
        assert rep["drift_outliers"] == rep["drift"]
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{url}/w/batch/programs",
                                    timeout=10) as resp:
            assert json.loads(resp.read()) == json.loads(json.dumps(
                svc.programs()))
        with urllib.request.urlopen(f"{url}/w/batch/metrics",
                                    timeout=10) as resp:
            m = parse_exposition(resp.read().decode())
        assert m["wtpu_programs_cataloged"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_summarize_orders_by_compile_wall_and_working_set():
    rows = [{"key": "a", "plane": "m", "compile_wall_s": 0.1,
             "memory": {"temp_bytes": 10, "argument_bytes": 100}},
            {"key": "b", "plane": "m", "compile_wall_s": 0.9,
             "memory": {"temp_bytes": 900, "argument_bytes": 100}},
            {"key": "c", "plane": "m", "compile_wall_s": 0.5,
             "memory": {"argument_bytes": 100}}]
    rep = summarize_programs(rows)
    assert [t["key"] for t in rep["top_compile"]] == ["b", "c", "a"]
    assert rep["compile_wall_total_s"] == pytest.approx(1.5)
    # the largest working set first; a row without temp_bytes has none
    assert [d["key"] for d in rep["drift_outliers"]] == ["b", "a"]
    assert [d["temp_ratio"] for d in rep["drift_outliers"]] == [9.0, 0.1]
    assert "temp_ratio" not in rep["drift"][2]


# ------------------------------------------- a JAX worker's rows beside

@pytest.fixture(scope="module")
def jax_catalog(tmp_path_factory):
    """A JAX scheduler's real catalog row (PingPong(64), 80 ms in 40-ms
    chunks, metrics): ``programs-jw.jsonl`` in a fleet-shaped
    directory."""
    import wittgenstein_tpu.models  # noqa: F401 — fills the registry
    from wittgenstein_tpu.obs.programs import ProgramCatalog as JCatalog
    from wittgenstein_tpu.serve import ScenarioSpec as JSpec
    from wittgenstein_tpu.serve import Scheduler as JScheduler
    d = tmp_path_factory.mktemp("fleet")
    sch = JScheduler(catalog=JCatalog(path=d / "programs-jw.jsonl"),
                     ledger_path=str(d / "jax_ledger.jsonl"))
    rid = sch.submit(JSpec(protocol="PingPong", params={"node_count": 64},
                           seeds=(0,), sim_ms=80, chunk_ms=40,
                           obs=("metrics",)))
    sch.run_pending()
    assert sch.request(rid).status == "done"
    return d


def test_readers_take_a_jax_workers_rows(jax_catalog, tmp_path):
    """`read_catalog` and `summarize_programs` over a directory that
    mixes a JAX worker's catalog (predicted, flops, XLA's byte classes)
    with the port's; `FleetService.programs` summarizes both."""
    import shutil
    d = tmp_path / "fleet"
    shutil.copytree(jax_catalog, d)
    cat = ProgramCatalog(path=d / "programs-pw.jsonl",
                         memory_probe=FixedProbe(2048))
    _run(Scheduler(catalog=cat, device="cpu",
                   ledger_path=tmp_path / "l.jsonl"))
    cat_off = ProgramCatalog(path=d / "programs-px.jsonl")
    cat_off.record_program("nomem", None, lower_wall_s=0.0,
                           compile_wall_s=0.1, memory={}, cost={})
    (jrow,) = read_catalog(d / "programs-jw.jsonl")
    (prow,) = read_catalog(d / "programs-pw.jsonl")
    assert "predicted" in jrow and "flops" in jrow["cost"]
    assert jrow["key"] == prow["key"]      # one compile key, two packages
    rows = [jrow, prow] + read_catalog(d / "programs-px.jsonl")
    rep = summarize_programs(rows)
    assert rep["count"] == 3
    by = {(r["backend"], r["key"]): r for r in rep["drift"]}
    jd = rep["drift"][0]
    assert jd["temp_ratio"] == round(jrow["memory"]["temp_bytes"] /
                                     jrow["memory"]["argument_bytes"], 4)
    assert by[("cpu", "nomem")].get("temp_ratio") is None
    assert rep["drift"][1]["temp_ratio"] == round(
        2048 / prow["memory"]["argument_bytes"], 4)
    front = FleetService(d).programs()
    assert front["count"] == 3 and front["catalog"] == {
        "fleet": True, "files": 3, "durable": True}
    assert sorted(r["key"] for r in front["programs"]) == \
        sorted(r["key"] for r in rows)


def test_fleet_front_without_catalogs_is_off(tmp_path):
    assert FleetService(tmp_path / "fleet").programs() == {
        "catalog": "off", "programs": [], "count": 0, "fleet": True}


# ----------------------------------------------------------------- card

@pytest.mark.cuda
def test_cuda_first_launch_working_set_and_launches(tmp_path):
    """On the card: catalog_smoke's request records ``temp_bytes`` > 0
    and the first chunk's launches (route once a ms at K=1, 40 in a
    40-ms chunk), and the state equals the run without a catalog."""
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")
    from torch.utils import _pytree as pytree
    from wittgenstein_tpu_torch.obs.programs import launch_counts
    spec = _spec(sim_ms=120)
    plain = _run(Scheduler(device="cuda",
                           ledger_path=tmp_path / "a.jsonl"), spec)
    cat = ProgramCatalog(path=tmp_path / "p.jsonl")
    before = launch_counts()
    served = _run(Scheduler(device="cuda", catalog=cat,
                            ledger_path=tmp_path / "b.jsonl"), spec)
    total = {k: v - before[k] for k, v in launch_counts().items()}
    (row,) = read_catalog(tmp_path / "p.jsonl")
    assert row["backend"] == "cuda" and row["memory"]["temp_bytes"] > 0
    assert row["cost"]["launches"]["route"] == 40
    assert 3 * row["cost"]["launches"]["route"] == total["route"]
    assert all(torch.equal(x, y) for x, y in zip(
        pytree.tree_leaves(plain.final_state),
        pytree.tree_leaves(served.final_state)))
    assert cat.drift()[0]["temp_ratio"] > 0
