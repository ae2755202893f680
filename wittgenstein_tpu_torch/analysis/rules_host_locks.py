"""Rule ``host_locks`` — static race detector for the host plane (the
port's copy of `wittgenstein_tpu/analysis/rules_host_locks.py`).

The reference's contract is explicit ("nothing is executed in
parallel, so the code does not have to be multithread safe") and the
serve tier broke it on purpose: submits land from any thread, one
drain thread runs groups, watchdog workers outlive their launch, and
the HTTP handlers poll health concurrently.  The scheduler's answer is
one lock (`_mu`) — but nothing checked that every touch of the state
that lock owns actually happens under it.  This rule is that check.

A class opts in by declaring its lock inventory as class-level
literals:

    _LOCK_OWNS = {"_mu": ("_queue", "_requests", "resilience")}
    _LOCK_ALIASES = {"_boundary": "_mu"}    # Condition(self._mu)

The rule then walks every method:

  * a lexical ``with self._mu:`` (or any alias) region protects the
    attributes `_mu` owns; reading OR writing an owned ``self.<attr>``
    outside such a region is a violation — IF the method can run
    without the lock.
  * "can run without the lock" is a fixed point over the intra-class
    call graph: public/dunder methods are thread entry points
    (anything may call them bare); a private method becomes
    unlocked-callable when an unlocked-callable method calls it from
    an unprotected site.  ``__init__`` is exempt (no concurrent self
    yet).
  * bodies of NESTED functions/lambdas are thread context: the
    enclosing method's lock does not travel with a closure handed to a
    worker thread (the watchdog pattern), so owned accesses there must
    re-acquire the lock regardless of the caller's state.

Classes that create a ``threading.Lock/RLock/Condition`` on ``self``
but declare no inventory get a WARNING — the annotation is the
contract; an unannotated lock is a lock this rule cannot check.

Known limits (deliberate): only ``self.<attr>`` accesses are tracked
(cross-object access to another instance's privates is a different
lint); ``Condition.wait`` releasing the lock mid-region is not
modeled; comprehension bodies run inline and keep the lock.

Suppressions: ``<rule>.allow`` entries "relpath::Class.method::attr".
"""

from __future__ import annotations

import ast

from .framework import Finding, Rule, register_rule, parse_allow
from .host_common import HOST_DIRS, iter_source_files, self_attr, Aliases

#: the class-level literals that declare an inventory
OWNS_NAME = "_LOCK_OWNS"
ALIASES_NAME = "_LOCK_ALIASES"

_LOCK_FACTORIES = ("threading.Lock", "threading.RLock",
                   "threading.Condition")


class _MethodScan(ast.NodeVisitor):
    """One method body: owned-attr accesses, intra-class calls, and
    for each whether a declared lock region encloses it lexically and
    whether it sits inside a nested def (thread context)."""

    def __init__(self, owns_of, lock_names):
        self.owns_of = owns_of          # attr -> owning lock name
        self.lock_names = lock_names    # canonical lock attrs + aliases
        self.held: list = []            # stack of held (canonical) locks
        self.depth_nested = 0
        self.accesses: list = []        # (attr, line, protected, thread)
        self.calls: list = []           # (method, protected, thread)

    def _protects(self, attr) -> bool:
        return self.owns_of.get(attr) in self.held

    # ---- lock regions -------------------------------------------------
    def _visit_with(self, node):
        acquired = []
        for item in node.items:
            attr = self_attr(item.context_expr)
            if attr in self.lock_names:
                acquired.append(self.lock_names[attr])
        self.held += acquired
        self.generic_visit(node)
        if acquired:
            del self.held[-len(acquired):]

    visit_With = visit_AsyncWith = _visit_with

    # ---- thread context: nested defs drop the lexical lock ------------
    def _visit_nested(self, node):
        saved, self.held = self.held, []
        self.depth_nested += 1
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.depth_nested -= 1
        self.held = saved

    visit_FunctionDef = visit_AsyncFunctionDef = visit_Lambda = \
        _visit_nested

    # ---- accesses and calls -------------------------------------------
    def visit_Attribute(self, node):
        attr = self_attr(node)
        if attr is not None and attr in self.owns_of:
            self.accesses.append((attr, node.lineno,
                                  self._protects(attr),
                                  self.depth_nested > 0))
        self.generic_visit(node)

    def visit_Call(self, node):
        attr = self_attr(node.func)
        if attr is not None:
            self.calls.append((attr, bool(self.held),
                               self.depth_nested > 0))
        self.generic_visit(node)


def _class_literal(cls: ast.ClassDef, name: str):
    for stmt in cls.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            target = stmt.target
        if isinstance(target, ast.Name) and target.id == name:
            try:
                return ast.literal_eval(stmt.value)
            except ValueError:
                return None
    return None


def _makes_lock(cls: ast.ClassDef, aliases: Aliases) -> bool:
    """True when any method assigns ``self.x = threading.Lock()``-ish."""
    for node in ast.walk(cls):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and self_attr(node.targets[0]) is not None
                and aliases.canonical(node.value.func)
                in _LOCK_FACTORIES):
            return True
    return False


def _entry(name: str) -> bool:
    """Thread entry points: public methods, and dunders (anything may
    invoke __len__/__iter__ bare).  __init__ is skipped entirely."""
    if name == "__init__":
        return False
    return not name.startswith("_") or (
        name.startswith("__") and name.endswith("__"))


def scan_source_text(relpath: str, text: str, allow=()):
    """Lint one module.  Returns ``(violations, warnings, inventories)``
    where a violation is ``(relpath, qual, line, attr, why)``."""
    tree = ast.parse(text, filename=relpath)
    aliases = Aliases(tree)
    violations, warnings, inventories = [], [], 0

    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        owns = _class_literal(cls, OWNS_NAME)
        if owns is None:
            if _makes_lock(cls, aliases):
                warnings.append(
                    (relpath, cls.name, cls.lineno,
                     f"class {cls.name} creates a threading lock but "
                     f"declares no {OWNS_NAME} inventory — its lock "
                     "discipline is unchecked"))
            continue
        inventories += 1
        alias_map = _class_literal(cls, ALIASES_NAME) or {}
        lock_names = {lk: lk for lk in owns}
        lock_names.update({a: t for a, t in alias_map.items()})
        owns_of = {attr: lk for lk, attrs in owns.items()
                   for attr in attrs}

        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        scans = {}
        for name, m in methods.items():
            if name == "__init__":
                continue
            sc = _MethodScan(owns_of, lock_names)
            for child in ast.iter_child_nodes(m):
                sc.visit(child)
            scans[name] = sc

        # fixed point: which methods can execute with no lock held?
        unlocked = {n for n in scans if _entry(n)}
        # a closure calling a private bare is a thread target either way
        for sc in scans.values():
            unlocked |= {callee for callee, prot, thread in sc.calls
                         if thread and not prot and callee in scans}
        changed = True
        while changed:
            changed = False
            for name in list(unlocked):
                for callee, prot, _ in scans[name].calls:
                    if not prot and callee in scans \
                            and callee not in unlocked:
                        unlocked.add(callee)
                        changed = True

        for name, sc in scans.items():
            qual = f"{cls.name}.{name}"
            for attr, line, prot, thread in sc.accesses:
                if prot:
                    continue
                if not thread and name not in unlocked:
                    continue        # only ever called under the lock
                if f"{relpath}::{qual}::{attr}" in allow:
                    continue
                where = ("from a nested function (thread context — the "
                         "caller's lock does not travel with a closure)"
                         if thread else
                         f"and {name} is reachable without the lock")
                lk = owns_of[attr]
                violations.append(
                    (relpath, qual, line, attr,
                     f"self.{attr} is owned by self.{lk} but accessed "
                     f"outside any `with self.{lk}:` region {where}"))
    return violations, warnings, inventories


def scan_tree(dirs=HOST_DIRS, root=None, allow=()):
    violations, warnings, inventories, files = [], [], 0, 0
    for relpath, text in iter_source_files(dirs, root=root):
        files += 1
        v, w, n = scan_source_text(relpath, text, allow)
        violations += v
        warnings += w
        inventories += n
    return violations, warnings, inventories, files


@register_rule
class HostLocksRule(Rule):
    name = "host_locks"
    scope = "global"
    budgeted_metrics = ("violations",)

    def run(self, target, budget):
        allow = parse_allow(budget)
        violations, warnings, inventories, files = scan_tree(allow=allow)
        findings = [
            Finding(rule=self.name, target=f"{rel}:{line}",
                    severity="error", path=rel, line=line,
                    message=f"{qual}: {why} (allowlist key: "
                            f'"{rel}::{qual}::{attr}")')
            for rel, qual, line, attr, why in violations]
        findings += [
            Finding(rule=self.name, target=f"{rel}:{line}",
                    severity="warning", path=rel, line=line, message=msg)
            for rel, _, line, msg in warnings]
        findings.append(Finding(
            rule=self.name, target="global", severity="info",
            metric="violations", value=len(violations),
            message=f"{inventories} lock inventories over {files} host "
                    f"files: {len(violations)} unlocked owned-attribute "
                    "accesses"))
        return findings

    def describe(self):
        _, _, inventories, files = scan_tree()
        return f"source: {files} host files, {inventories} lock " \
               f"inventories"
