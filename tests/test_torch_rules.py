"""Rules of the port package: it never imports JAX or the JAX package,
its entry points default to CUDA and refuse to run without a card, and
`chip_smoke.py` fails loudly where there is no card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "wittgenstein_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "wittgenstein_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "kernel_ab.py",
                                          ROOT / "bench_torch.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_refuses_without_card(monkeypatch):
    from wittgenstein_tpu_torch.core.state import resolve_device
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    from wittgenstein_tpu_torch.models.handel import Handel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Handel(node_count=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GSFSignature(node_count=64)
    from wittgenstein_tpu_torch.models.dfinity import Dfinity
    from wittgenstein_tpu_torch.models.p2pflood import P2PFlood
    from wittgenstein_tpu_torch.models.sanfermin import (SanFermin,
                                                         SanFerminCappos)
    from wittgenstein_tpu_torch.models.casper import CasperIMD
    from wittgenstein_tpu_torch.models.ethpow import ETHPoW, MinerAgentEnv
    for proto in (Dfinity, P2PFlood, SanFermin, SanFerminCappos, CasperIMD,
                  ETHPoW, lambda: MinerAgentEnv(0.4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            proto()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_phase_failure_exits_nonzero(monkeypatch, tmp_path):
    """A path that disagrees with its golden ends the smoke with exit
    code 1 and no result: phase Q's P2PFlood batch run on the CPU at 32
    nodes against a golden whose digests are not the run's."""
    import json

    import chip_smoke
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "Q_MS", chip_smoke.Q_CHUNK)
    path = tmp_path / "golden.json"
    path.write_text(json.dumps({"ms": chip_smoke.Q_CHUNK,
                                "seeds": [{"net.time": "0"}] * 4}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(SystemExit) as e:
            chip_smoke.quiet_run("cpu", "p2pflood", n=32,
                                 golden_path=str(path))
    finally:
        torch.set_num_threads(threads)
    assert e.value.code == 1


@pytest.mark.parametrize("path", ["casper", "ethpow"])
def test_chip_smoke_chain_phase_failure_exits_nonzero(monkeypatch, tmp_path,
                                                      path):
    """Phases K and E end the smoke with exit code 1 and no result when
    a seed disagrees with its golden: each run on the CPU for one 2-tick
    chunk of one seed against a golden whose digests are not the
    run's."""
    import json

    import chip_smoke
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    golden = tmp_path / "golden.json"
    bad = [{"net.time": "0"}]
    if path == "casper":
        for name, v in (("K_SEEDS", 1), ("K_TICKS", 2), ("K_CHUNK", 2),
                        ("K_GOLDEN", str(golden))):
            monkeypatch.setattr(chip_smoke, name, v)
        golden.write_text(json.dumps({"ticks": {"2": {
            "seeds": bad, "counts": [{"height_max": 0, "height_min": 0}]}}}))
        run = chip_smoke.casper_run
    else:
        for name, v in (("E_RUNS", 1), ("E_TICKS", 2), ("E_CHUNK", 2),
                        ("E_GOLDEN", str(golden))):
            monkeypatch.setattr(chip_smoke, name, v)
        golden.write_text(json.dumps({"ticks": 2, "seeds": bad,
                                      "thr": [[0.0] * 10], "row": {}}))
        run = chip_smoke.ethpow_run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(SystemExit) as e:
            run("cpu")
    finally:
        torch.set_num_threads(threads)
    assert e.value.code == 1


def test_kernel_ab_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "kernel_ab.py", "merge"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and not out.stdout


def test_bench_torch_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and not out.stdout
