"""Rule ``determinism`` — source lint over the port's models/ and core/
for nondeterminism sneaking into the step functions (the port's copy of
`wittgenstein_tpu/analysis/rules_determinism.py`, written for PyTorch).

Determinism is the reference's invariant #1 (same seed -> same run,
HandelTest.java's copy()-reproducibility contract), and the port holds
it bit for bit against the JAX package through counter-based PRNG
(ops/prng.py).  One `time.time()`, `np.random.*` or `torch.rand` call
inside a step function silently breaks it.

Flagged (as errors) anywhere in wittgenstein_tpu_torch/models/ and core/:
  * wall-clock reads: time.time / time.time_ns / datetime.now
    (time.monotonic / perf_counter stay allowed — the harness uses
    them for wall-clock BOUNDS, which never feed simulation state);
  * stateful PRNG: the stdlib ``random`` module, np.random.*, and
    torch's global generator (torch.rand, randn, randint, randperm,
    bernoulli, multinomial, normal, manual_seed, their ``_like``
    forms, torch.random.*, and the in-place ``uniform_`` / ``normal_``
    tensor methods) — all randomness flows from ops/prng.py;
  * environment reads: os.environ / os.getenv (config must be explicit
    constructor arguments, never ambient).

Known-legitimate sites are allowlisted in budgets.json under
``determinism.allow`` as "relpath::qualname::pattern" strings; the
allowlist is part of the reviewed budget file, so an exemption is a
diff, not a silent skip.
"""

from __future__ import annotations

import ast
import pathlib

from .framework import Finding, Rule, register_rule

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
LINT_DIRS = ("models", "core")

_TORCH_PRNG = "stateful torch PRNG (use ops/prng.py counter draws)"

# dotted-name prefixes -> reason.  Names are resolved against each
# module's imports (import aliases followed), so `import numpy as np;
# np.random.rand()` matches "numpy.random".
BANNED = {
    "time.time": "wall-clock read inside simulation code",
    "time.time_ns": "wall-clock read inside simulation code",
    "datetime.datetime.now": "wall-clock read inside simulation code",
    "datetime.datetime.utcnow": "wall-clock read inside simulation code",
    "random": "stateful stdlib PRNG (use ops/prng.py counter draws)",
    "numpy.random": "stateful numpy PRNG (use ops/prng.py counter draws)",
    "os.getenv": "ambient environment read (pass explicit parameters)",
    "os.environ": "ambient environment read (pass explicit parameters)",
    **{f"torch.{name}": _TORCH_PRNG for name in (
        "rand", "rand_like", "randn", "randn_like", "randint",
        "randint_like", "randperm", "bernoulli", "multinomial", "normal",
        "poisson", "manual_seed", "seed", "random", "cuda.manual_seed",
        "cuda.manual_seed_all")},
}

#: tensor methods that draw from the global generator in place; matched
#: by the called attribute, whatever the receiver
BANNED_METHODS = ("uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_")


class _Lint(ast.NodeVisitor):
    def __init__(self, relpath):
        self.relpath = relpath
        self.aliases = {}       # local name -> canonical dotted module
        self.scope = []         # enclosing function/class names
        self.hits = []          # (qualname, lineno, banned_key, reason)

    def visit_Import(self, node):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]

    def visit_ImportFrom(self, node):
        for a in node.names:
            if node.module:
                self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def _canonical(self, node) -> str:
        """Dotted name of an expression, import aliases resolved."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.aliases.get(node.id, node.id))
        else:
            return ""
        return ".".join(reversed(parts))

    def _hit(self, lineno, banned, reason):
        self.hits.append((".".join(self.scope) or "<module>", lineno,
                          banned, reason))

    def _check(self, name, lineno):
        for banned, reason in BANNED.items():
            if name == banned or name.startswith(banned + "."):
                self._hit(lineno, banned, reason)
                return

    def _walk_scoped(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = \
        _walk_scoped

    def visit_Call(self, node):
        name = self._canonical(node.func)
        n_hits = len(self.hits)
        self._check(name, node.lineno)
        if (len(self.hits) == n_hits and isinstance(node.func, ast.Attribute)
                and node.func.attr in BANNED_METHODS):
            self._hit(node.lineno, f".{node.func.attr}", _TORCH_PRNG)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # os.environ["X"] reads (getenv is caught as a Call).
        self._check(self._canonical(node.value), node.lineno)
        self.generic_visit(node)


def lint_source_text(relpath: str, text: str, allow=()):
    """Lint one module's source; returns (rel, qual, lineno, banned,
    reason) hits minus the allowlist.  Split out so tests can feed
    synthetic sources."""
    lint = _Lint(relpath)
    lint.visit(ast.parse(text, filename=relpath))
    return [(relpath, qual, lineno, banned, reason)
            for qual, lineno, banned, reason in lint.hits
            if f"{relpath}::{qual}::{banned}" not in allow]


def lint_sources(allow=(), pkg_dir=None):
    """All hits across the linted trees, minus the allowlist.  An
    allow entry is "relpath::qualname::banned_prefix"."""
    base = pathlib.Path(pkg_dir) if pkg_dir is not None else PKG_DIR
    hits = []
    for sub in LINT_DIRS:
        for path in sorted((base / sub).glob("*.py")):
            hits += lint_source_text(f"{sub}/{path.name}",
                                     path.read_text(), allow)
    return hits


@register_rule
class DeterminismRule(Rule):
    name = "determinism"
    scope = "global"

    def run(self, target, budget):
        allow = tuple(budget.get("allow", ()))
        findings = [
            Finding(rule=self.name, target=f"{rel}:{lineno}",
                    severity="error",
                    message=f"{banned} in {qual}: {reason} (allowlist key: "
                            f'"{rel}::{qual}::{banned}")')
            for rel, qual, lineno, banned, reason in lint_sources(allow)]
        if not findings:
            findings.append(Finding(
                rule=self.name, target="models+core", severity="info",
                message="no wall-clock/stateful-PRNG/env reads in "
                        "simulation sources"))
        return findings

    def describe(self):
        n = sum(len(list((PKG_DIR / sub).glob("*.py")))
                for sub in LINT_DIRS)
        return f"source: {n} files (models/, core/)"
