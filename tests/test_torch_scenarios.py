"""The port's scenario drivers (`wittgenstein_tpu_torch/scenarios/`)
against the JAX package's (`wittgenstein_tpu/scenarios/`) at
`tests/test_scenarios.py`'s sizes (32 nodes, 2 seeds): every sweep's CSV
text equal (less the `wall_s` column, a wall clock), the runs behind
the Byzantine sweeps equal leaf for leaf, `emission_drift.run_mode`'s
row equal (less `wall_s`), `sigs_per_time`'s CSV equal, and `gen_anim`'s
and `draw_imgs`' frames pixel-equal as arrays.  The Byzantine sweeps,
`desync_sweep`, one `run_mode`, `sigs_per_time` and one point of
`optimistic_scenarios.node_scaling` run in tier 1; the other sweeps,
`compare`, the animations and the city-latency drivers' ladders are
slow-marked with the same comparison, where the Optimistic ladder's
points refuse in both packages with one count (one point of each
P2PHandel driver runs in tier 1 in `test_torch_p2phandel_*.py`)."""

import contextlib
import importlib

import numpy as np
import pytest
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert

PKGS = ("wittgenstein_tpu", "wittgenstein_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _modules(name):
    return [importlib.import_module(f"{p}.scenarios.{name}") for p in PKGS]


@contextlib.contextmanager
def _captured(module):
    """Every `run_multiple_times` result the module's drivers get."""
    got = []
    orig = module.run_multiple_times

    def capture(*a, **kw):
        got.append(orig(*a, **kw))
        return got[-1]
    module.run_multiple_times = capture
    try:
        yield got
    finally:
        module.run_multiple_times = orig


def _without(text, column):
    """CSV text with one column left out."""
    rows = [line.split(",") for line in text.splitlines()]
    if column not in rows[0]:
        return text
    i = rows[0].index(column)
    return "\n".join(",".join(r[:i] + r[i + 1:]) for r in rows)


def _sweep(tmp_path, module, fn, states=False, **kw):
    """`fn` of both packages' `module` with the same arguments (the port
    on the CPU): the CSV texts (less wall_s) and, with `states`, the
    captured runs' final states."""
    out = []
    for pkg, mod in zip(PKGS, _modules(module)):
        d = tmp_path / pkg
        d.mkdir()
        extra = {"device": "cpu"} if pkg.endswith("_torch") else {}
        with (_captured(mod) if states else contextlib.nullcontext([])) \
                as runs:
            csv = getattr(mod, fn)(out_dir=str(d), **kw, **extra)
        text = _without(str(csv), "wall_s")
        files = sorted(p.name for p in d.iterdir())
        saved = _without((d / files[0]).read_text(), "wall_s")
        assert saved == text
        if pkg.endswith("_torch"):
            runs = [convert.to_numpy(r.nets, r.pstates) for r in runs]
        else:
            runs = [tp.jax_state(r.nets, r.pstates) for r in runs]
        out.append((text, files, runs))
    (want, wfiles, wruns), (got, gfiles, gruns) = out
    assert got == want, f"{fn}: port\n{got}\nJAX\n{want}"
    assert gfiles == wfiles
    for i, (a, b) in enumerate(zip(wruns, gruns)):
        tp.assert_batches_equal(a, b, f"{fn} point {i}")
    return got


@pytest.mark.parametrize("fn", ["byz_suicide_sweep", "hidden_byz_sweep"])
def test_byzantine_sweeps_match_jax(tmp_path, fn):
    """tests/test_scenarios.py:68: a quarter of 32 nodes Byzantine, 2
    seeds: the CSV row and every leaf of both runs at their stop."""
    text = _sweep(tmp_path, "handel_scenarios", fn, states=True,
                  ratios=(0.25,), nodes=32, seeds=2)
    assert text.splitlines()[0] == "byz_ratio,avg_done_ms,max_done_ms," \
        "frac_done" and text.splitlines()[1].startswith("0.25,")


def test_desync_sweep_matches_jax(tmp_path):
    text = _sweep(tmp_path, "handel_scenarios", "desync_sweep", starts=(50,),
                  nodes=32, seeds=2)
    assert text.splitlines()[1].startswith("50,")


def test_run_mode_matches_jax():
    """`emission_drift.run_mode` in hashed mode (32 nodes, 2 seeds): the
    row less its wall, the JAX package's run as two sequential batches
    of one seed and the port's as one batch (results do not depend on
    the split)."""
    rows = [mod.run_mode("hashed", nodes=32, seeds=2, max_time=2000,
                         **({"device": "cpu"} if i else {"seed_batch": 1}))
            for i, mod in enumerate(_modules("emission_drift"))]
    for r in rows:
        assert r.pop("wall_s") >= 0
    assert rows[0] == rows[1]
    assert rows[1]["frac_done"] == 1.0 and rows[1]["evicted"] == 0


def test_sigs_per_time_matches_jax(tmp_path):
    """GSF's sigsPerTime at 32 nodes, 100-ms samples: the CSV text, and
    the PNG written."""
    text = _sweep(tmp_path, "gsf_scenarios", "sigs_per_time", nodes=32,
                  max_time=1500, stat_each_ms=100)
    assert text.splitlines()[0] == "time_ms,min,avg,max"
    assert (tmp_path / PKGS[1] / "gsf_sigs_per_time.png").stat().st_size > 0


def test_compare_default_batch_rule():
    """`compare`'s default microbatch rule at 8,192 nodes and up is the
    JAX package's (768 MB of stored emission lists a batch)."""
    import inspect
    src = [inspect.getsource(mod.compare) for mod in _modules(
        "emission_drift")]
    for s in src:
        assert "(768 << 20) // (4 * nodes * nodes)" in s


def test_optimistic_node_scaling_matches_jax(tmp_path):
    """`optimistic_scenarios.node_scaling` at one point (32 nodes, 2
    seeds; tests/test_scenarios.py:34), cities and the city jitter: the
    CSV text and both seeds' final states equal."""
    _sweep(tmp_path, "optimistic_scenarios", "node_scaling", states=True,
           counts=(32,), seeds=2)


@pytest.mark.slow
@pytest.mark.parametrize("fn,kw", [
    ("node_scaling", dict(counts=(64, 128))),
    ("strategy_sweep", dict(signers=64, relays=8))])
def test_p2phandel_ladders_match_jax(tmp_path, fn, kw):
    """The P2PHandel driver's own smoke ladders (its `__main__`'s points,
    every strategy), each JAX point a program of its own (about 3
    minutes apiece on the CPU)."""
    _sweep(tmp_path, "p2phandel_scenarios", fn, **kw)


@pytest.mark.slow
@pytest.mark.parametrize("n", [128, 256])
def test_optimistic_ladder_refusals_match_jax(tmp_path, n):
    """`optimistic_scenarios.node_scaling`'s `__main__` points refuse in
    the JAX package (their inboxes overflow under the city jitter, and
    `run_multiple_times` raises); the port refuses with the same count
    of dropped and clamped messages."""
    got = []
    for i, mod in enumerate(_modules("optimistic_scenarios")):
        with pytest.raises(RuntimeError) as e:
            mod.node_scaling(counts=(n,), seeds=2, out_dir=str(tmp_path),
                             **({"device": "cpu"} if i else {}))
        got.append(tp.refused_count(e.value))
    assert got[0] and got[0] == got[1]


@pytest.mark.slow
@pytest.mark.parametrize("fn,kw", [
    ("node_scaling", dict(counts=(32,), seeds=2)),
    ("tor_sweep", dict(fractions=(0.33,), nodes=32, seeds=2)),
    ("period_sweep", dict(periods=(20,), nodes=32, seeds=2)),
    ("log_errors", dict(error_rate=0.2, counts=(32,), seeds=2)),
    ("extra_cycle_sweep", dict(cycles=(10,), nodes=32, seeds=2)),
    ("contacted_node_sweep", dict(fast_paths=(0, 10), nodes=32, seeds=2))])
def test_sweep_matches_jax(tmp_path, fn, kw):
    """tests/test_scenarios.py's other sweeps: the CSV text (less
    wall_s) and the files written."""
    _sweep(tmp_path, "handel_scenarios", fn, **kw)


@pytest.mark.slow
def test_compare_matches_jax(tmp_path):
    """`emission_drift.compare` at 32 nodes, 2 seeds (the port's as two
    sequential batches of one seed): both rows less their walls, and the
    CSV less its wall column."""
    rows = []
    for i, mod in enumerate(_modules("emission_drift")):
        d = tmp_path / PKGS[i]
        rows.append((mod.compare(nodes=32, seeds=2, max_time=2000,
                                 out_dir=str(d),
                                 **({"device": "cpu", "seed_batch": 1}
                                    if i else {})),
                     _without((d / "emission_drift_32n.csv").read_text(),
                              "wall_s")))
    for r in (rows[0][0], rows[1][0]):
        for mode in r.values():
            mode.pop("wall_s")
    assert rows[0] == rows[1]


def _frames(module, fn, tmp_path, **kw):
    """The RGB frames each package's `fn` draws, as arrays."""
    out = []
    for i, (pkg, mod) in enumerate(zip(PKGS, _modules(module))):
        drawer = importlib.import_module(f"{pkg}.tools.node_drawer")
        frames = []
        orig = drawer.NodeDrawer.save_gif

        def save_gif(self, path, ms_per_frame=150, orig=orig, frames=frames):
            frames.extend(np.asarray(f) for f in self.frames)
            return orig(self, path, ms_per_frame)
        drawer.NodeDrawer.save_gif = save_gif
        try:
            getattr(mod, fn)(out_path=str(tmp_path / f"{pkg}.gif"), **kw,
                             **({"device": "cpu"} if i else {}))
        finally:
            drawer.NodeDrawer.save_gif = orig
        out.append(frames)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("module,fn,kw", [
    ("handel_scenarios", "gen_anim", dict(nodes=32, frames=4, frame_ms=50)),
    ("gsf_scenarios", "draw_imgs", dict(nodes=32, frames=4, frame_ms=50))])
def test_animation_frames_match_jax(tmp_path, module, fn, kw):
    want, got = _frames(module, fn, tmp_path, **kw)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(a, b), f"{fn} frame {i}"
