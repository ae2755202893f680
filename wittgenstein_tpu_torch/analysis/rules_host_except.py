"""Rule ``host_except`` — exception handlers shout or record, never
swallow (the port's copy of `wittgenstein_tpu/analysis/rules_host_except.py`).

The serve/matrix/memo planes are crash-only: every failure is either
propagated (re-raise), recorded durably (tombstone, journal, ledger,
quarantine, a results row), or at minimum shouted to stderr so an
operator reading a dead campaign's log can see where it went.  A
silent ``except: pass`` (or ``except KeyError: x = fallback``) is the
one shape that defeats all of that — the failure evaporates and the
next symptom is a wrong number three layers up.

A handler in the port's serve/, matrix/ or memo/ passes when it:

  * contains a ``raise`` (re-raise or wrap-and-raise), or
  * binds the exception (``except E as e:``) and actually USES ``e``
    in its body — storing it on a result, formatting it into a
    message, passing it to ``_fail_group`` — the bound-and-used test
    is what separates "handled" from "discarded", or
  * calls a shout: ``print``, ``warnings.warn``,
    ``traceback.print_exc``, ``sys.stderr.write``, ``logging.*`` /
    logger methods, or
  * calls a record: anything matching record/tombstone/quarantine/
    settle/fail/journal/ledger/append_line.

Everything else is an error.  obs/ and cli/ are out of scope on
purpose: provenance code degrading softly ("backend = unknown") is
its documented contract.

Suppressions: "relpath::qualname::ExcType" (the handler's exception
type name; "bare" for ``except:``).
"""

from __future__ import annotations

import ast
import re

from .framework import Finding, Rule, register_rule, parse_allow
from .host_common import Aliases, iter_source_files

SCAN_DIRS = ("wittgenstein_tpu_torch/serve",
             "wittgenstein_tpu_torch/matrix",
             "wittgenstein_tpu_torch/memo")

_SHOUTS = ("print", "warnings.warn", "traceback.print_exc",
           "sys.stderr.write")
_LOGGERISH = frozenset({"warning", "error", "exception", "critical",
                        "info", "debug", "log"})
_RECORD = re.compile(r"record|tombstone|quarantin|settle|fail|journal"
                     r"|ledger|append_line", re.I)


def _exc_label(handler: ast.ExceptHandler) -> str:
    t = handler.type
    if t is None:
        return "bare"
    if isinstance(t, ast.Tuple):
        return ",".join(_name_of(e) for e in t.elts)
    return _name_of(t)


def _name_of(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return "?"


def _handler_ok(handler: ast.ExceptHandler, aliases: Aliases) -> bool:
    body_walk = [n for stmt in handler.body for n in ast.walk(stmt)]
    if any(isinstance(n, ast.Raise) for n in body_walk):
        return True
    if handler.name and any(isinstance(n, ast.Name)
                            and n.id == handler.name
                            for n in body_walk):
        return True
    for n in body_walk:
        if not isinstance(n, ast.Call):
            continue
        canon = aliases.canonical(n.func)
        if canon in _SHOUTS or canon.startswith("logging."):
            return True
        leaf = canon.rsplit(".", 1)[-1] if canon else ""
        if leaf in _LOGGERISH and "." in canon:
            return True
        name = n.func.attr if isinstance(n.func, ast.Attribute) else leaf
        if name and _RECORD.search(name):
            return True
    return False


class _Qual(ast.NodeVisitor):
    def __init__(self, relpath, aliases, allow):
        self.relpath = relpath
        self.aliases = aliases
        self.allow = allow
        self.scope: list = []
        self.violations: list = []

    def _scoped(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    def visit_ExceptHandler(self, node):
        if not _handler_ok(node, self.aliases):
            qual = ".".join(self.scope) or "<module>"
            label = _exc_label(node)
            if f"{self.relpath}::{qual}::{label}" not in self.allow:
                self.violations.append(
                    (self.relpath, qual, node.lineno, label,
                     f"except {label}: swallows the exception — "
                     "re-raise, record (tombstone/journal/ledger/"
                     "results row), or shout to stderr (allowlist "
                     f'key: "{self.relpath}::{qual}::{label}")'))
        self.generic_visit(node)


def scan_source_text(relpath: str, text: str, allow=()):
    tree = ast.parse(text, filename=relpath)
    q = _Qual(relpath, Aliases(tree), allow)
    q.visit(tree)
    return q.violations


def scan_tree(dirs=SCAN_DIRS, root=None, allow=()):
    violations, files = [], 0
    for relpath, text in iter_source_files(dirs, root=root):
        files += 1
        violations += scan_source_text(relpath, text, allow)
    return violations, files


@register_rule
class HostExceptRule(Rule):
    name = "host_except"
    scope = "global"
    budgeted_metrics = ("violations",)

    def run(self, target, budget):
        allow = parse_allow(budget)
        violations, files = scan_tree(allow=allow)
        findings = [
            Finding(rule=self.name, target=f"{rel}:{line}",
                    severity="error", path=rel, line=line,
                    message=f"{qual}: {why}")
            for rel, qual, line, label, why in violations]
        findings.append(Finding(
            rule=self.name, target="global", severity="info",
            metric="violations", value=len(violations),
            message=f"{files} serve/matrix/memo files: "
                    f"{len(violations)} silent exception swallows"))
        return findings

    def describe(self):
        _, files = scan_tree()
        return f"source: {files} files (serve/, matrix/, memo/)"
