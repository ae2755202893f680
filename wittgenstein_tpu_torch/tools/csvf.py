"""Column-ordered CSV accumulator — the port of
`wittgenstein_tpu/tools/csvf.py` (tools/CSVFormatter.java)."""

from __future__ import annotations


class CSVFormatter:
    """wittgenstein_tpu/tools/csvf.py:6-21: rows keep the column order;
    a missing value is an empty cell and an unknown key is ignored."""

    def __init__(self, columns):
        self.columns = list(columns)
        self.rows: list = []

    def add(self, **values):
        self.rows.append([values.get(c, "") for c in self.columns])

    def __str__(self):
        lines = [",".join(self.columns)]
        lines += [",".join(str(v) for v in row) for row in self.rows]
        return "\n".join(lines) + "\n"

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(str(self))
