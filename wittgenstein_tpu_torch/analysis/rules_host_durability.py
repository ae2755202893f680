"""Rule ``host_durability`` — durable artifacts are written durably (the
port's copy of `wittgenstein_tpu/analysis/rules_host_durability.py`).

The serve plane's crash-only story rests on exactly two write idioms,
both living in `utils/jsonl.py` or shaped like it:

  * append-one-line + flush (+fsync when the write is an ack barrier),
  * write-temp + fsync + ``os.replace`` for whole-file rewrites.

A raw ``open(path, "w")`` + ``json.dump`` on a journal, ledger,
checkpoint or campaign-report path silently reintroduces the torn-file
window the kill-anywhere tests exist to close.  This rule makes that a
static error:

  * **strict zone** — the port's serve/, matrix/, memo/ and
    obs/ledger.py + obs/spans.py (the flight recorder's durable JSONL
    writer) + obs/programs.py + obs/regress.py (the program catalog
    and the bench-history ledger, both durable append-only logs) ARE
    the durable core: every raw write sink there (``open`` with a write
    mode, ``json.dump``, ``write_text``/``write_bytes``, ``np.save*``,
    ``gzip.open``-for-write, ``checkpoint.save``) must sit in a
    function that fsyncs or ``os.replace``s before returning.
  * **tainted zone** — everywhere else scanned (obs/, server/, utils/,
    cli/): only sinks whose path expression *flows from a durable
    name* are checked.  Taint seeds are identifiers, attributes and
    string literals matching journal/ledger/checkpoint/ckpt/manifest/
    tombstone/memo, propagated through local (and module-level)
    assignments and ``with open(...) as f`` bindings; a module whose
    own filename matches (utils/checkpoint.py) taints all of its
    sinks.

`utils/jsonl.py` itself is exempt — it is the sanctioned
implementation the rule points everyone else at.

The fleet layer's cross-process writes — journal submits, lease
claims/releases, ledger completion rows — route through
`jsonl.append_line` (fsync'd where the write is an ack or claim
barrier) or whole-file atomic replaces (worker stats snapshots,
checkpoint files); `serve/fleet.py` and the lease table in
`serve/journal.py` are covered by the serve/ prefix.

Suppressions: "relpath::qualname::sink" (the JAX package's two, where
the port has the same construct:
``utils/checkpoint.py::save::numpy.savez_compressed`` — the documented
non-atomic primitive whose callers own the write-temp+replace dance;
``serve/fleet.py::spawn_worker::open`` — a worker's append-mode
STDOUT/STDERR log handed to Popen, operator diagnostics rather than
durable state).
"""

from __future__ import annotations

import ast
import re

from .framework import Finding, Rule, register_rule, parse_allow
from .host_common import (HOST_DIRS, Aliases, iter_source_files,
                          literal_strings, subtree_names)

STRICT_PREFIXES = ("wittgenstein_tpu_torch/serve/",
                   "wittgenstein_tpu_torch/matrix/",
                   "wittgenstein_tpu_torch/memo/")
STRICT_FILES = ("wittgenstein_tpu_torch/obs/ledger.py",
                "wittgenstein_tpu_torch/obs/spans.py",
                "wittgenstein_tpu_torch/obs/programs.py",
                "wittgenstein_tpu_torch/obs/regress.py")
EXEMPT_FILES = ("wittgenstein_tpu_torch/utils/jsonl.py",)

DURABLE_PAT = re.compile(
    r"journal|ledger|checkpoint|ckpt|manifest|tombstone|memo(?!r)", re.I)

_SANCTIONERS = ("os.fsync", "os.replace")
_WRITE_MODE = re.compile(r"[wax+]")


def _mentions_durable(node) -> bool:
    return any(DURABLE_PAT.search(s)
               for s in subtree_names(node) + literal_strings(node))


def _write_mode_arg(call: ast.Call, pos: int):
    """The mode argument of an open()-style call (positional `pos` or
    ``mode=``) when it is a write-intent literal; None otherwise."""
    mode = None
    if len(call.args) > pos and isinstance(call.args[pos], ast.Constant):
        mode = call.args[pos].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and _WRITE_MODE.search(mode):
        return mode
    return None


def _sinks_in(node, aliases: Aliases):
    """Every raw write sink in `node`'s subtree:
    ``(sink_name, path_expr, lineno)``."""
    out = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        canon = aliases.canonical(call.func)
        f = call.func
        if canon == "open" or canon == "gzip.open":
            if _write_mode_arg(call, 1) and call.args:
                out.append((canon, call.args[0], call.lineno))
        elif isinstance(f, ast.Attribute) and f.attr == "open":
            # pathlib's Path.open(mode) — the path is the receiver
            if _write_mode_arg(call, 0):
                out.append(("open", f.value, call.lineno))
        elif canon == "json.dump":
            if len(call.args) > 1:
                out.append(("json.dump", call.args[1], call.lineno))
        elif isinstance(f, ast.Attribute) and f.attr in ("write_text",
                                                         "write_bytes"):
            out.append((f.attr, f.value, call.lineno))
        elif canon in ("numpy.save", "numpy.savez",
                       "numpy.savez_compressed"):
            if call.args:
                out.append((canon, call.args[0], call.lineno))
        elif canon.endswith("checkpoint.save") and call.args:
            out.append(("checkpoint.save", call.args[0], call.lineno))
    return out


def _sanctioned(fn_node, aliases: Aliases) -> bool:
    """True when the enclosing function fsyncs or os.replaces — the
    write-temp idiom, or an explicit durability barrier."""
    return any(isinstance(c, ast.Call)
               and aliases.canonical(c.func) in _SANCTIONERS
               for c in ast.walk(fn_node))


def _tainted_names(fn_node, module_seeds: frozenset) -> frozenset:
    """Local names whose value flows from a durable name (two passes
    over the function's assignments reach the chains in this tree)."""
    tainted = set(module_seeds)

    def expr_tainted(expr) -> bool:
        if _mentions_durable(expr):
            return True
        return any(isinstance(n, ast.Name) and n.id in tainted
                   for n in ast.walk(expr))

    for _ in range(2):
        for node in ast.walk(fn_node):
            pairs = []
            if isinstance(node, ast.Assign):
                pairs = [(t, node.value) for t in node.targets]
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                    and node.value is not None:
                pairs = [(node.target, node.value)]
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                pairs = [(i.optional_vars, i.context_expr)
                         for i in node.items if i.optional_vars]
            for target, value in pairs:
                if isinstance(target, ast.Name) and expr_tainted(value):
                    tainted.add(target.id)
    return frozenset(tainted)


def _functions(tree):
    """``(qualname, node)`` for top-level functions and methods, plus
    ("<module>", tree) for top-level code.  Nested functions stay part
    of their enclosing function's scope — a sink in a closure is
    sanctioned by the function that owns the write sequence."""
    out = [("<module>", tree)]
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node))
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{m.name}", m))
    return out


def scan_source_text(relpath: str, text: str, allow=()):
    """Lint one module; returns ``(relpath, qual, line, sink, why)``
    violations."""
    if relpath in EXEMPT_FILES:
        return []
    strict = relpath.startswith(STRICT_PREFIXES) or relpath in STRICT_FILES
    tree = ast.parse(text, filename=relpath)
    aliases = Aliases(tree)

    stem = relpath.rsplit("/", 1)[-1].removesuffix(".py")
    module_tainted = bool(DURABLE_PAT.search(stem))
    module_seeds = frozenset()
    if not strict:
        seeds = set()
        for node in tree.body:
            if isinstance(node, ast.Assign) and _mentions_durable(node.value):
                seeds |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
            # a module-level `with open(...)` is rare; functions cover it
        module_seeds = frozenset(seeds)

    violations = []
    for qual, fn in _functions(tree):
        sinks = []
        if fn is tree:
            # module-level statements only (function bodies get their
            # own, correctly-scoped pass)
            for stmt in tree.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                    sinks += _sinks_in(stmt, aliases)
        else:
            sinks = _sinks_in(fn, aliases)
        if not sinks:
            continue
        if not strict:
            tainted = _tainted_names(fn, module_seeds)
        for sink, path_expr, line in sinks:
            if not strict and not module_tainted:
                hot = _mentions_durable(path_expr) or any(
                    isinstance(n, ast.Name) and n.id in tainted
                    for n in ast.walk(path_expr))
                if not hot:
                    continue
            if _sanctioned(fn, aliases):
                continue
            if f"{relpath}::{qual}::{sink}" in allow:
                continue
            zone = ("the durable core (serve/matrix/memo/ledger)"
                    if strict else "a durable path")
            violations.append(
                (relpath, qual, line, sink,
                 f"raw {sink} write on {zone} without fsync/os.replace "
                 "in the enclosing function — route it through "
                 "utils/jsonl.py (append_line/rewrite) or the "
                 "write-temp + fsync + os.replace idiom (allowlist "
                 f'key: "{relpath}::{qual}::{sink}")'))
    return violations


def scan_tree(dirs=HOST_DIRS, root=None, allow=()):
    violations, files = [], 0
    for relpath, text in iter_source_files(dirs, root=root):
        files += 1
        violations += scan_source_text(relpath, text, allow)
    return violations, files


@register_rule
class HostDurabilityRule(Rule):
    name = "host_durability"
    scope = "global"
    budgeted_metrics = ("violations",)

    def run(self, target, budget):
        allow = parse_allow(budget)
        violations, files = scan_tree(allow=allow)
        findings = [
            Finding(rule=self.name, target=f"{rel}:{line}",
                    severity="error", path=rel, line=line,
                    message=f"{qual}: {why}")
            for rel, qual, line, sink, why in violations]
        findings.append(Finding(
            rule=self.name, target="global", severity="info",
            metric="violations", value=len(violations),
            message=f"{files} host files: {len(violations)} raw "
                    "durable-path writes"))
        return findings

    def describe(self):
        _, files = scan_tree()
        return f"source: {files} host files (strict zone: serve/, " \
               "matrix/, memo/, obs/ledger.py)"
