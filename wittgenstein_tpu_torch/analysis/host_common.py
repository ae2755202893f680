"""Shared AST plumbing for the host-plane source rules — the port's copy
of `wittgenstein_tpu/analysis/host_common.py`.

The four ``rules_host_*`` modules (locks, durability, digest purity,
shout-or-record) lint the port's own host-side Python — the serve
scheduler, the matrix driver, the memo table, the durable logs and the
command lines — not recorded chunks.  This module is the one place
their common mechanics live:

  * `iter_source_files` — the repo-relative (relpath, text) stream for
    a set of scan roots, with a `root=` seam so tests can point a rule
    at a temp copy (the mutation check copies the tree, injects one
    seeded violation, and asserts the rule fires).
  * `Aliases` — per-module import-alias resolution, so `import numpy
    as np; np.savez(...)` canonicalizes to "numpy.savez" and a
    relative `from ..obs.ledger import digest` resolves to
    "obs.ledger.digest".
  * `qualname` helpers for the `relpath::qualname::pattern`
    suppression keys every source rule shares (framework.parse_allow).

Suppression relpaths here are REPO-relative
("wittgenstein_tpu_torch/serve/scheduler.py"); the determinism rule
keys on package-relative paths ("models/x.py") — the syntax is shared,
the key spaces are disjoint.
"""

from __future__ import annotations

import ast
import pathlib

#: repo root (the directory holding wittgenstein_tpu_torch/)
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

#: the host plane: the JAX package's scan (serve, matrix, memo, obs,
#: server, utils and its root tools/) over the port's packages; the
#: port's counterpart of the root tools/ is its cli/ package
HOST_DIRS = (
    "wittgenstein_tpu_torch/serve",
    "wittgenstein_tpu_torch/matrix",
    "wittgenstein_tpu_torch/memo",
    "wittgenstein_tpu_torch/obs",
    "wittgenstein_tpu_torch/server",
    "wittgenstein_tpu_torch/utils",
    "wittgenstein_tpu_torch/cli",
)


def iter_source_files(dirs=HOST_DIRS, root=None):
    """Yield ``(relpath, text)`` for every ``*.py`` under `dirs`
    (non-recursive per dir — the host packages are flat), repo-relative
    and sorted, so every rule sees the same files in the same order.
    `root` defaults to the live repo; tests pass a temp copy."""
    base = pathlib.Path(root) if root is not None else REPO_ROOT
    for sub in dirs:
        d = base / sub
        if not d.is_dir():
            continue
        for path in sorted(d.glob("*.py")):
            yield f"{sub}/{path.name}", path.read_text()


class Aliases:
    """Import-alias map for one module: local name -> canonical dotted
    prefix.  Relative imports are flattened to their trailing module
    path ("from ..obs.ledger import digest" -> "obs.ledger.digest"),
    which is exactly enough to match rule patterns and to resolve
    cross-module call edges within the scanned tree."""

    def __init__(self, tree: ast.AST):
        self.map: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if node.module:
                        self.map[a.asname or a.name] = \
                            f"{node.module}.{a.name}"
                    elif node.level:            # "from . import jsonl"
                        self.map[a.asname or a.name] = a.name

    def canonical(self, node) -> str:
        """Dotted name of an attribute/name expression with the leading
        segment resolved through the import map; "" when the expression
        is not a plain dotted name (calls, subscripts...)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.map.get(node.id, node.id))
        else:
            return ""
        return ".".join(reversed(parts))


def self_attr(node) -> str | None:
    """``self.<attr>`` -> "<attr>"; None otherwise."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def literal_strings(node) -> list:
    """Every string constant in `node`'s subtree (taint seeds: a path
    built as ``os.path.join(d, "ledger.jsonl")`` is durable because of
    the literal, whatever the variables are called)."""
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def subtree_names(node) -> list:
    """Every identifier-ish name in `node`'s subtree: Name ids and
    Attribute attrs (taint matching looks at the last path component,
    so ``self.ledger_path`` contributes "ledger_path")."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
    return out
