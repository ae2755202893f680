"""Line-plot output — the port of `wittgenstein_tpu/tools/graph.py`
(tools/Graph.java, with matplotlib for XChart).

`Graph` accumulates named `Series` and saves a PNG; `stat_series` merges
a set of runs into min/max/avg series, `clean_series` trims their common
flat tail.  `Graph.save` imports matplotlib when it is called, so this
module imports without it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Series:
    """wittgenstein_tpu/tools/graph.py:14-22."""

    name: str
    xs: list = dataclasses.field(default_factory=list)
    ys: list = dataclasses.field(default_factory=list)

    def add(self, x, y):
        self.xs.append(float(x))
        self.ys.append(float(y))


def stat_series(name: str, runs: list) -> dict:
    """min/max/avg across same-x series (wittgenstein_tpu/tools/graph.py:
    25-34, Graph.statSeries)."""
    assert runs and all(len(r.xs) == len(runs[0].xs) for r in runs)
    out = {k: Series(f"{name}.{k}") for k in ("min", "max", "avg")}
    for i, x in enumerate(runs[0].xs):
        vals = [r.ys[i] for r in runs]
        out["min"].add(x, min(vals))
        out["max"].add(x, max(vals))
        out["avg"].add(x, sum(vals) / len(vals))
    return out


def clean_series(runs: list) -> None:
    """Trim the tail that stays flat in every run
    (wittgenstein_tpu/tools/graph.py:37-48, Graph.cleanSeries)."""
    if not runs:
        return

    def tail_start(s):
        i = len(s.ys)
        while i > 1 and s.ys[i - 1] == s.ys[i - 2]:
            i -= 1
        return i
    cut = max(tail_start(s) for s in runs)
    for s in runs:
        del s.xs[cut:], s.ys[cut:]


class Graph:
    """wittgenstein_tpu/tools/graph.py:51-73."""

    def __init__(self, title: str, x_label: str, y_label: str):
        self.title, self.x_label, self.y_label = title, x_label, y_label
        self.series: list = []

    def add_series(self, s: Series):
        self.series.append(s)

    def save(self, path: str) -> None:
        """Write the plot as a PNG (needs matplotlib)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(9, 5.5))
        for s in self.series:
            ax.plot(s.xs, s.ys, label=s.name, linewidth=1.4)
        ax.set_title(self.title)
        ax.set_xlabel(self.x_label)
        ax.set_ylabel(self.y_label)
        if self.series:
            ax.legend(loc="best", fontsize=8)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
