"""The port's output tools (`wittgenstein_tpu_torch/tools/`) against the
JAX package's (`wittgenstein_tpu/tools/`): CSV text, `stat_series` and
`clean_series` values equal; `Graph.save` writes a PNG; importing the
port's tools and scenarios loads neither matplotlib nor PIL; and
`NodeDrawer`'s background and frames pixel-equal to the JAX package's
on the same nodes and values (compared as arrays, not file bytes)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from wittgenstein_tpu_torch.tools.csvf import CSVFormatter
from wittgenstein_tpu_torch.tools.graph import (Graph, Series, clean_series,
                                                stat_series)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_csv_formatter_matches_jax():
    """tests/test_tools.py:15's case, and a float, string and unknown
    key, as the same text."""
    from wittgenstein_tpu.tools.csvf import CSVFormatter as JCSV
    texts = []
    for cls in (JCSV, CSVFormatter):
        c = cls(["a", "b", "c"])
        c.add(a=1, b=2)
        c.add(b=4, a=3)
        c.add(a=5)
        c.add(a=0.25, b="x", c=round(327.84, 1), unknown=9)
        texts.append(str(c))
    assert texts[0] == texts[1]
    assert texts[1].startswith("a,b,c\n1,2,\n3,4,\n5,,\n")


def _series(cls, rows):
    r1, r2 = cls("r1"), cls("r2")
    for x, (y1, y2) in enumerate(rows):
        r1.add(x, y1)
        r2.add(x, y2)
    return [r1, r2]


@pytest.mark.parametrize("rows", [
    [(1, 3), (2, 4), (5, 5), (5, 5), (5, 5)],
    [(0.5, 7), (1.5, 2), (3, 3), (4, 4)],
    [(1, 1)]])
def test_stat_and_clean_series_match_jax(rows):
    """tests/test_tools.py:23's case and two more: the min/max/avg
    series and the trimmed runs equal the JAX package's."""
    from wittgenstein_tpu.tools import graph as jgraph
    want, got = _series(jgraph.Series, rows), _series(Series, rows)
    ws, gs = jgraph.stat_series("s", want), stat_series("s", got)
    for k in ("min", "max", "avg"):
        assert (ws[k].name, ws[k].xs, ws[k].ys) == \
            (gs[k].name, gs[k].xs, gs[k].ys)
    jgraph.clean_series(want)
    clean_series(got)
    assert [(s.xs, s.ys) for s in want] == [(s.xs, s.ys) for s in got]
    if rows[0] == (1, 3):
        assert gs["avg"].ys == [2, 3, 5, 5, 5] and len(got[0].ys) == 3


def test_graph_png(tmp_path):
    g = Graph("t", "x", "y")
    s = Series("s")
    for i in range(10):
        s.add(i, i * i)
    g.add_series(s)
    path = tmp_path / "g.png"
    g.save(str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert path.stat().st_size > 1000


def test_imports_load_no_plotting_package():
    """The card's machine has neither matplotlib nor PIL: importing
    every tools and scenarios module loads neither."""
    code = (
        "import sys\n"
        "import wittgenstein_tpu_torch.tools.csvf, "
        "wittgenstein_tpu_torch.tools.graph, "
        "wittgenstein_tpu_torch.tools.node_drawer, "
        "wittgenstein_tpu_torch.scenarios.handel_scenarios, "
        "wittgenstein_tpu_torch.scenarios.emission_drift, "
        "wittgenstein_tpu_torch.scenarios.gsf_scenarios\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'PIL'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_world_map_is_a_byte_copy():
    from wittgenstein_tpu.tools.node_drawer import _MAP_PATH as JMAP
    from wittgenstein_tpu_torch.tools.node_drawer import _MAP_PATH
    assert os.path.dirname(_MAP_PATH) != os.path.dirname(JMAP)
    with open(JMAP, "rb") as a, open(_MAP_PATH, "rb") as b:
        assert a.read() == b.read()


def test_background_pixel_equal():
    from wittgenstein_tpu.tools.node_drawer import _background as jbg
    from wittgenstein_tpu_torch.core.state import MAX_X, MAX_Y
    from wittgenstein_tpu_torch.tools.node_drawer import _background
    a, b = np.asarray(jbg()), np.asarray(_background())
    assert b.shape == (MAX_Y, MAX_X, 3)
    assert np.array_equal(a, b)
    # a real map, not the flat synthesized graticule
    assert len(np.unique(b.reshape(-1, 3), axis=0)) > 8


@pytest.mark.parametrize("location", ["random", "cities"])
def test_node_drawer_frames_pixel_equal(tmp_path, location):
    """tests/test_tools.py:46's drawing on both packages' nodes of the
    same seed, with down and special nodes: every frame pixel-equal, and
    the port's GIF written."""
    import torch

    from wittgenstein_tpu.core import builders as jbuilders
    from wittgenstein_tpu.tools.node_drawer import NodeDrawer as JDrawer
    from wittgenstein_tpu_torch.core import builders
    from wittgenstein_tpu_torch.tools.node_drawer import NodeDrawer
    jnodes = jbuilders.NodeBuilder(location=location).build(3, 50)
    nodes = builders.NodeBuilder(location=location).build(
        torch.tensor(3, dtype=torch.int32), 50, "cpu")
    down = np.arange(50) % 7 == 0
    jnodes = jnodes.replace(down=down)
    nodes = nodes.replace(down=torch.tensor(down))
    assert np.array_equal(np.asarray(jnodes.x), nodes.x.numpy())
    jd, d = JDrawer(vmin=0, vmax=1, dot=3), NodeDrawer(vmin=0, vmax=1, dot=3)
    special = np.arange(50) % 5 == 1
    for f in range(3):
        vals = np.linspace(0, 1, 50) * (f + 1) / 3
        a = jd.draw(jnodes, vals, special=special if f else None)
        b = d.draw(nodes, torch.tensor(vals), special=torch.tensor(special)
                   if f else None)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"frame {f}"
    path = tmp_path / "n.gif"
    d.save_gif(str(path))
    assert path.stat().st_size > 1000
    with pytest.raises(ValueError):
        NodeDrawer(0, 1).save_gif(str(tmp_path / "empty.gif"))
