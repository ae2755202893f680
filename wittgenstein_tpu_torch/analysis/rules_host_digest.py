"""Rule ``host_digest`` — digest/compile-key purity, statically (the
port's copy of `wittgenstein_tpu/analysis/rules_host_digest.py`).

Every cross-run contract in the campaign stack keys on a digest:
`ScenarioSpec.digest()` names ledger rows, `compile_key()` names
compile-cache groups, `SweepGrid.grid_digest()` names campaigns,
`MemoTable.key()` names persisted prefix states.  The BFT-scale sweep
papers only trust campaign results because every cell is reproducible
— so a digest that reads the clock, the environment, or Python's
per-process `hash()`/`id()` breaks resume, memoization and dedup at
once, silently (the digest still LOOKS fine; it just never matches
again).

This rule taint-walks the call graph from every digest entry point
(any function whose name matches ``digest``/``compile_key``, plus
`MemoTable.key`) across the scanned host modules (serve/, matrix/,
memo/, obs/, utils/) and errors on reachable:

  * wall-clock / PRNG / uniqueness sources: ``time.*``,
    ``datetime.*``, ``random.*``, ``numpy.random*``, ``uuid.*``,
    ``secrets.*``, ``os.urandom``;
  * ambient state: ``os.environ`` / ``os.getenv``;
  * per-process identity: builtin ``id()`` and ``hash()`` (PYTHONHASHSEED
    makes ``hash`` differ across processes — canonical JSON + sha256
    is the sanctioned fingerprint, obs/ledger.digest);
  * order-sensitive iteration over unsorted ``dict``/``set`` views
    (``for k in d.items()``, ``"".join(s)``, ``list(d.keys())`` ...)
    — rebuild comprehensions (``{k: v for ...}``) are exempt, they
    are order-free under the canonical ``sort_keys`` dump.

Calls that leave the scanned set (json, hashlib, the model registry)
are trusted leaves: models/ and core/ are already covered by the
``determinism`` rule.

Suppressions: "relpath::qualname::pattern" (pattern is the banned
dotted name, or "unsorted-iteration").
"""

from __future__ import annotations

import ast
import re

from .framework import Finding, Rule, register_rule, parse_allow
from .host_common import Aliases, iter_source_files, self_attr

SCAN_DIRS = ("wittgenstein_tpu_torch/serve",
             "wittgenstein_tpu_torch/matrix",
             "wittgenstein_tpu_torch/memo", "wittgenstein_tpu_torch/obs",
             "wittgenstein_tpu_torch/utils")

#: entry points: name pattern + explicit extras
ENTRY_NAME = re.compile(r"digest|compile_key")
EXTRA_ENTRIES = (("wittgenstein_tpu_torch/memo/table.py",
                  "MemoTable.key"),
                 ("wittgenstein_tpu_torch/matrix/search.py",
                  "SearchSpec.digest"))

#: method names followed through ``obj.m()`` calls on unresolvable
#: receivers — the serializer/canonicalizer vocabulary of this tree
CURATED_METHODS = frozenset(
    {"to_json", "canonical_json", "digest", "compile_key", "validate",
     "key"})

BANNED_PREFIXES = {
    "time": "wall-clock read inside a digest path",
    "datetime": "wall-clock read inside a digest path",
    "random": "stateful PRNG inside a digest path",
    "numpy.random": "stateful PRNG inside a digest path",
    "uuid": "per-process uniqueness inside a digest path",
    "secrets": "entropy source inside a digest path",
    "os.urandom": "entropy source inside a digest path",
    "os.getenv": "ambient environment read inside a digest path",
    "os.environ": "ambient environment read inside a digest path",
    "id": "per-process object identity inside a digest path",
    "hash": "PYTHONHASHSEED-dependent hash() inside a digest path",
}


def _banned(canon: str):
    for prefix, reason in BANNED_PREFIXES.items():
        if canon == prefix or canon.startswith(prefix + "."):
            return prefix, reason
    return None


class _Module:
    def __init__(self, relpath, tree):
        self.relpath = relpath
        self.tree = tree
        self.aliases = Aliases(tree)
        self.funcs: dict[str, ast.AST] = {}      # qual -> def node
        self.cls_of: dict[str, str] = {}         # qual -> class name
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        q = f"{node.name}.{m.name}"
                        self.funcs[q] = m
                        self.cls_of[q] = node.name


def _load_modules(root=None):
    mods = {}
    for relpath, text in iter_source_files(SCAN_DIRS, root=root):
        mods[relpath] = _Module(relpath, ast.parse(text, filename=relpath))
    return mods


def _edges(mod: _Module, qual: str, mods: dict, stem_index: dict,
           method_index: dict):
    """Call edges out of one function: ``(relpath, qual)`` targets
    within the scanned set (everything else is a trusted leaf)."""
    fn = mod.funcs[qual]
    cls = mod.cls_of.get(qual)
    out = set()
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        attr = self_attr(f)
        if attr is not None and cls is not None:
            q = f"{cls}.{attr}"
            if q in mod.funcs:
                out.add((mod.relpath, q))
            continue
        if isinstance(f, ast.Name):
            if f.id in mod.funcs:
                out.add((mod.relpath, f.id))
                continue
        canon = mod.aliases.canonical(f)
        if canon and "." in canon:
            head, leaf = canon.rsplit(".", 1)
            stem = head.rsplit(".", 1)[-1]
            for rel in stem_index.get(stem, ()):
                if leaf in mods[rel].funcs:
                    out.add((rel, leaf))
        if isinstance(f, ast.Attribute) and f.attr in CURATED_METHODS:
            out.update(method_index.get(f.attr, ()))
    return out


def _iter_violations(fn, aliases: Aliases):
    """Banned constructs inside one reachable function body:
    ``(line, pattern, reason)``."""
    hits = []

    def check_call(node):
        if isinstance(node, ast.Call):
            b = _banned(aliases.canonical(node.func))
            if b:
                hits.append((node.lineno,) + b)

    def unsorted_src(expr):
        if isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in ("keys", "values", "items"):
            return f"dict.{expr.func.attr}()"
        if isinstance(expr, ast.Set):
            return "set literal"
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
                and expr.func.id in ("set", "frozenset"):
            return f"{expr.func.id}()"
        return None

    for node in ast.walk(fn):
        check_call(node)
        if isinstance(node, ast.Subscript):
            b = _banned(aliases.canonical(node.value))
            if b:
                hits.append((node.lineno,) + b)
        iters = []
        if isinstance(node, ast.For):
            iters = [node.iter]
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            iters = [g.iter for g in node.generators]
        elif isinstance(node, ast.Call):
            name = node.func.attr if isinstance(node.func, ast.Attribute) \
                else node.func.id if isinstance(node.func, ast.Name) else ""
            if name in ("join", "list", "tuple", "enumerate") and node.args:
                iters = [node.args[0]]
        for it in iters:
            src = unsorted_src(it)
            if src:
                hits.append((node.lineno, "unsorted-iteration",
                             f"order-sensitive iteration over unsorted "
                             f"{src} feeding a digest (wrap in sorted())"))
    return hits


def scan_tree(root=None, allow=()):
    """All digest-purity violations: ``(relpath, qual, line, pattern,
    reason)``, plus (n_entries, n_reachable, n_files)."""
    mods = _load_modules(root=root)
    stem_index: dict = {}
    method_index: dict = {}
    for rel, mod in mods.items():
        stem_index.setdefault(
            rel.rsplit("/", 1)[-1].removesuffix(".py"), []).append(rel)
        for q in mod.funcs:
            name = q.rsplit(".", 1)[-1]
            if "." in q and name in CURATED_METHODS:
                method_index.setdefault(name, set()).add((rel, q))

    entries = set()
    for rel, mod in mods.items():
        for q in mod.funcs:
            if ENTRY_NAME.search(q.rsplit(".", 1)[-1]):
                entries.add((rel, q))
    entries.update(e for e in EXTRA_ENTRIES if
                   e[0] in mods and e[1] in mods[e[0]].funcs)

    reachable, frontier = set(entries), list(entries)
    while frontier:
        rel, q = frontier.pop()
        for edge in _edges(mods[rel], q, mods, stem_index, method_index):
            if edge not in reachable:
                reachable.add(edge)
                frontier.append(edge)

    violations = []
    for rel, q in sorted(reachable):
        mod = mods[rel]
        for line, pattern, reason in _iter_violations(mod.funcs[q],
                                                      mod.aliases):
            if f"{rel}::{q}::{pattern}" in allow:
                continue
            violations.append((rel, q, line, pattern, reason))
    return violations, (len(entries), len(reachable), len(mods))


@register_rule
class HostDigestRule(Rule):
    name = "host_digest"
    scope = "global"
    budgeted_metrics = ("violations",)

    def run(self, target, budget):
        allow = parse_allow(budget)
        violations, (n_entry, n_reach, n_files) = scan_tree(allow=allow)
        findings = [
            Finding(rule=self.name, target=f"{rel}:{line}",
                    severity="error", path=rel, line=line,
                    message=f"{qual}: {reason} (allowlist key: "
                            f'"{rel}::{qual}::{pattern}")')
            for rel, qual, line, pattern, reason in violations]
        findings.append(Finding(
            rule=self.name, target="global", severity="info",
            metric="violations", value=len(violations),
            message=f"{n_entry} digest entry points, {n_reach} reachable "
                    f"functions over {n_files} host files: "
                    f"{len(violations)} purity violations"))
        return findings

    def describe(self):
        _, (n_entry, n_reach, n_files) = scan_tree()
        return f"source: {n_files} host files, {n_entry} digest " \
               f"entry points ({n_reach} reachable functions)"
