"""The port's host-plane source rules and determinism lint
(`wittgenstein_tpu_torch/analysis`): the counterparts of
tests/test_analysis_host.py — lock discipline, durability, digest
purity, shout-or-record — via known-bad fixtures, a seeded-mutation
check through the CLI, the whole-port zero-error gate, and parity with
the JAX package's rules: the same fixture texts give the same (rule,
severity, line) findings in both packages (tolerance 0).  The JAX side
is AST only and compiles nothing.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from wittgenstein_tpu_torch.analysis import (framework, rules_determinism,
                                             rules_host_digest,
                                             rules_host_durability,
                                             rules_host_except,
                                             rules_host_locks)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = "wittgenstein_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _src(s: str) -> str:
    return textwrap.dedent(s).lstrip()


def _cli(*argv, cwd=REPO, env=None):
    return subprocess.run(
        [sys.executable, "-m", "wittgenstein_tpu_torch.analysis", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, **(env or {})})


# ---------------------------------------------------------------- locks

LOCKS_BAD = _src("""
    import threading

    class Box:
        _LOCK_OWNS = {"_mu": ("items", "count")}

        def __init__(self):
            self._mu = threading.Lock()
            self.items = []
            self.count = 0

        def add(self, x):
            with self._mu:
                self.items.append(x)
            self.count += 1          # unlocked mutation -> violation
""")


def test_locks_flags_unlocked_mutation():
    v, w, n = rules_host_locks.scan_source_text("pkg/box.py", LOCKS_BAD)
    assert n == 1
    assert [(q, attr) for _, q, _, attr, _ in v] == [("Box.add", "count")]


def test_locks_clean_when_locked():
    good = LOCKS_BAD.replace(
        "        self.count += 1          "
        "# unlocked mutation -> violation",
        "        with self._mu:\n            self.count += 1")
    assert good != LOCKS_BAD
    v, _, _ = rules_host_locks.scan_source_text("pkg/box.py", good)
    assert v == []


LOCKS_PRIVATE = _src("""
    import threading

    class Box:
        _LOCK_OWNS = {"_mu": ("n",)}

        def __init__(self):
            self._mu = threading.Lock()
            self.n = 0

        def bump(self):
            with self._mu:
                self._bump_locked()

        def _bump_locked(self):
            self.n += 1          # only ever called under the lock
""")

LOCKS_PRIVATE_BARE = LOCKS_PRIVATE + (
    "\n    def poke(self):\n"
    "        self._bump_locked()\n")


def test_locks_private_method_needs_unlocked_path():
    v, _, _ = rules_host_locks.scan_source_text("pkg/box.py",
                                                LOCKS_PRIVATE)
    assert v == []
    # ...until a public method calls it bare:
    v2, _, _ = rules_host_locks.scan_source_text("pkg/box.py",
                                                 LOCKS_PRIVATE_BARE)
    assert [(q, attr) for _, q, _, attr, _ in v2] == \
        [("Box._bump_locked", "n")]


LOCKS_CLOSURE = _src("""
    import threading

    class Box:
        _LOCK_OWNS = {"_mu": ("n",)}

        def __init__(self):
            self._mu = threading.Lock()
            self.n = 0

        def spawn(self):
            with self._mu:
                def work():
                    self.n += 1      # lock does not travel
                return work
""")


def test_locks_closure_is_thread_context():
    v, _, _ = rules_host_locks.scan_source_text("pkg/box.py", LOCKS_CLOSURE)
    assert len(v) == 1 and v[0][1] == "Box.spawn" and v[0][3] == "n"


LOCKS_ALIAS = _src("""
    import threading

    class Box:
        _LOCK_OWNS = {"_mu": ("n",)}
        _LOCK_ALIASES = {"_cond": "_mu"}

        def __init__(self):
            self._mu = threading.RLock()
            self._cond = threading.Condition(self._mu)
            self.n = 0

        def via_alias(self):
            with self._cond:
                self.n += 1          # alias holds _mu -> clean

        def bare(self):
            self.n += 1              # violation (allowlisted below)
""")


def test_locks_alias_and_allowlist():
    v, _, _ = rules_host_locks.scan_source_text("pkg/box.py", LOCKS_ALIAS)
    assert [(q, attr) for _, q, _, attr, _ in v] == [("Box.bare", "n")]
    v2, _, _ = rules_host_locks.scan_source_text(
        "pkg/box.py", LOCKS_ALIAS, allow=("pkg/box.py::Box.bare::n",))
    assert v2 == []


LOCKS_QUIET = _src("""
    import threading

    class Quiet:
        def __init__(self):
            self._mu = threading.Lock()
""")


def test_locks_warns_on_uninventoried_lock():
    v, w, n = rules_host_locks.scan_source_text("pkg/q.py", LOCKS_QUIET)
    assert v == [] and n == 0
    assert len(w) == 1 and "Quiet" in w[0][3]


# ----------------------------------------------------------- durability

DUR_BAD = _src("""
    import json, os

    def save_state(d, rows):
        path = os.path.join(d, "journal.jsonl")
        with open(path, "w") as f:     # raw write on a durable path
            json.dump(rows, f)
""")

DUR_GOOD = _src("""
    import json, os

    def save_state(d, rows):
        path = os.path.join(d, "journal.jsonl")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rows, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
""")

DUR_PLAIN = _src("""
    def emit(path, blob):
        with open(path, "w") as f:   # path name carries no taint
            f.write(blob)
""")

CLI_X = f"{PORT}/cli/x.py"


def test_durability_flags_raw_journal_write():
    v = rules_host_durability.scan_source_text(CLI_X, DUR_BAD)
    assert {sink for _, _, _, sink, _ in v} == {"open", "json.dump"}
    assert all(q == "save_state" for _, q, _, _, _ in v)


def test_durability_sanctioned_by_replace_idiom():
    assert rules_host_durability.scan_source_text(CLI_X, DUR_GOOD) == []


def test_durability_strict_zone_needs_no_taint():
    # benign name in cli/ -> clean; same code in serve/ -> error
    assert rules_host_durability.scan_source_text(CLI_X, DUR_PLAIN) == []
    v = rules_host_durability.scan_source_text(f"{PORT}/serve/x.py",
                                               DUR_PLAIN)
    assert len(v) == 1 and v[0][3] == "open"


def test_durability_jsonl_impl_exempt_and_allowlist():
    assert rules_host_durability.scan_source_text(
        f"{PORT}/utils/jsonl.py", DUR_BAD) == []
    v = rules_host_durability.scan_source_text(
        CLI_X, DUR_BAD, allow=(f"{CLI_X}::save_state::open",
                               f"{CLI_X}::save_state::json.dump"))
    assert v == []


# --------------------------------------------------------------- digest

DIGEST_TAINTED = """
    import time

    def _stamp():
        return time.time()

    def spec_digest(obj):
        return f"{obj}-{_stamp()}"
"""

DIGEST_UNSORTED = """
    def grid_digest(axes):
        parts = []
        for k, v in axes.items():        # unsorted -> flagged
            parts.append(f"{k}={v}")
        return "|".join(parts)
"""

DIGEST_HASH_ID = """
    def key_digest(obj):
        return hash(obj) ^ id(obj)
"""


def _digest_tree(tmp_path, body, pkg=PORT):
    d = tmp_path / pkg / "serve"
    d.mkdir(parents=True)
    (d / "mini.py").write_text(_src(body))
    return tmp_path


def test_digest_flags_tainted_entry(tmp_path):
    root = _digest_tree(tmp_path, DIGEST_TAINTED)
    v, (n_entry, n_reach, _) = rules_host_digest.scan_tree(root=root)
    assert n_entry == 1 and n_reach == 2
    assert [(q, p) for _, q, _, p, _ in v] == [("_stamp", "time")]


def test_digest_unsorted_iteration(tmp_path):
    root = _digest_tree(tmp_path, DIGEST_UNSORTED)
    v, _ = rules_host_digest.scan_tree(root=root)
    assert len(v) == 1 and v[0][3] == "unsorted-iteration"
    root2 = _digest_tree(tmp_path / "b", DIGEST_UNSORTED.replace(
        "in axes.items():        # unsorted -> flagged",
        "in sorted(axes.items()):"))
    v2, _ = rules_host_digest.scan_tree(root=root2)
    assert v2 == []


def test_digest_hash_id_banned(tmp_path):
    root = _digest_tree(tmp_path, DIGEST_HASH_ID)
    v, _ = rules_host_digest.scan_tree(root=root)
    assert {p for _, _, _, p, _ in v} == {"hash", "id"}


def test_digest_real_tree_walk_is_nonvacuous():
    v, (n_entry, n_reach, n_files) = rules_host_digest.scan_tree()
    # the named entry points + the EXTRA_ENTRIES (MemoTable.key,
    # SearchSpec.digest) must all be found
    assert n_entry >= 7
    assert n_reach > n_entry        # the walk actually follows calls
    allow = framework.parse_allow(
        framework.load_budgets().get("host_digest", {}))
    assert [x for x in v if f"{x[0]}::{x[1]}::{x[3]}" not in allow] == []


# --------------------------------------------------------------- except

EXCEPT_BAD = _src("""
    def eat(d):
        try:
            return d["k"]
        except KeyError:
            return 0
""")

EXCEPT_TUPLE = EXCEPT_BAD.replace("except KeyError:",
                                  "except (KeyError, ValueError):")


def test_except_flags_silent_swallow():
    v = rules_host_except.scan_source_text("wtpu/x.py", EXCEPT_BAD)
    assert len(v) == 1 and v[0][1] == "eat" and v[0][3] == "KeyError"


def _except_src(handler):
    bind = " as e" if any("str(e)" in line for line in handler) else ""
    body = "\n".join(f"        {line}" for line in handler)
    return ("import sys\n\n"
            "def eat(self, d, results, rid):\n"
            "    try:\n"
            '        return d["k"]\n'
            f"    except KeyError{bind}:\n"
            f"{body}\n")


EXCEPT_HANDLERS = [
    ["raise"],
    ["raise RuntimeError('wrapped') from None"],
    ["print('bad', file=sys.stderr)", "return 0"],
    ["results['err'] = str(e)", "return 0"],
    ["self.journal.record_settled(rid, 'error')", "return 0"],
]


@pytest.mark.parametrize("handler", EXCEPT_HANDLERS)
def test_except_accepts_shout_record_raise(handler):
    assert rules_host_except.scan_source_text(
        "wtpu/x.py", _except_src(handler)) == []


def test_except_allowlist():
    v = rules_host_except.scan_source_text("wtpu/x.py", EXCEPT_TUPLE)
    assert v[0][3] == "KeyError,ValueError"
    assert rules_host_except.scan_source_text(
        "wtpu/x.py", EXCEPT_TUPLE,
        allow=("wtpu/x.py::eat::KeyError,ValueError",)) == []


# --------------------------------------------------------- determinism

DETERMINISM_BAD = _src("""
    import time
    import random
    import numpy as np
    import os
    import torch

    def step(x):
        t = time.time()
        r = random.random()
        u = np.random.rand()
        e = os.environ['WTPU_X']
        w = time.monotonic()
        return x
""")


def test_determinism_bans_torch_global_generator():
    """The JAX rule's bans plus torch's global generator: the module
    functions, their ``_like`` forms, ``manual_seed`` and the in-place
    tensor draws; the counter PRNG of ops/prng.py stays allowed."""
    src = _src("""
        import torch
        from torch import randn as rn
        from ..ops import prng

        def step(x):
            a = torch.rand(3)
            b = rn(3)
            c = torch.randint(0, 4, (3,))
            d = torch.randperm(4)
            e = torch.bernoulli(x)
            f = torch.multinomial(x, 1)
            torch.manual_seed(0)
            x.uniform_()
            x.normal_()
            g = torch.rand_like(x)
            return prng.uniform_bits(x)
    """)
    hits = rules_determinism.lint_source_text("models/fake.py", src)
    assert sorted(h[3] for h in hits) == sorted(
        ["torch.rand", "torch.randn", "torch.randint", "torch.randperm",
         "torch.bernoulli", "torch.multinomial", "torch.manual_seed",
         ".uniform_", ".normal_", "torch.rand_like"]), hits
    assert all(h[1] == "step" for h in hits)


def test_determinism_rule_clean_on_port_sources():
    """The port's models/ and core/ are clean: a hit is a real
    nondeterminism bug."""
    assert rules_determinism.lint_sources(allow=()) == []


# -------------------------------------------- parity with the JAX rules

def _zone_paths(zone):
    """(port relpath, JAX relpath) of one fixture's zone."""
    return {"strict": (f"{PORT}/serve/x.py", "wittgenstein_tpu/serve/x.py"),
            "tainted": (f"{PORT}/cli/x.py", "tools/x.py"),
            "exempt": (f"{PORT}/utils/jsonl.py",
                       "wittgenstein_tpu/utils/jsonl.py"),
            "any": ("pkg/x.py", "pkg/x.py"),
            "models": ("models/fake.py", "models/fake.py")}[zone]


#: name -> (rule, zone, fixture text): every fixture of this file, run
#: through the same rule of both packages
PARITY = {
    "locks_bad": ("host_locks", "any", LOCKS_BAD),
    "locks_private": ("host_locks", "any", LOCKS_PRIVATE),
    "locks_private_bare": ("host_locks", "any", LOCKS_PRIVATE_BARE),
    "locks_closure": ("host_locks", "any", LOCKS_CLOSURE),
    "locks_alias": ("host_locks", "any", LOCKS_ALIAS),
    "locks_quiet": ("host_locks", "any", LOCKS_QUIET),
    "dur_bad_tainted": ("host_durability", "tainted", DUR_BAD),
    "dur_bad_strict": ("host_durability", "strict", DUR_BAD),
    "dur_bad_exempt": ("host_durability", "exempt", DUR_BAD),
    "dur_good": ("host_durability", "strict", DUR_GOOD),
    "dur_plain_tainted": ("host_durability", "tainted", DUR_PLAIN),
    "dur_plain_strict": ("host_durability", "strict", DUR_PLAIN),
    "except_bad": ("host_except", "any", EXCEPT_BAD),
    "except_tuple": ("host_except", "any", EXCEPT_TUPLE),
    **{f"except_ok_{i}": ("host_except", "any", _except_src(h))
       for i, h in enumerate(EXCEPT_HANDLERS)},
    "determinism": ("determinism", "models", DETERMINISM_BAD),
    "digest_tainted": ("host_digest", "strict", _src(DIGEST_TAINTED)),
    "digest_unsorted": ("host_digest", "strict", _src(DIGEST_UNSORTED)),
    "digest_hash_id": ("host_digest", "strict", _src(DIGEST_HASH_ID)),
}


def _findings(pkg, rule, relpath, text, tmp_path):
    """(rule, severity, line) of one fixture under `pkg`'s rules."""
    import importlib
    mod = importlib.import_module(f"{pkg}.analysis.rules_{rule}")
    if rule == "host_locks":
        v, w, _ = mod.scan_source_text(relpath, text)
        return sorted([(rule, "error", x[2]) for x in v] +
                      [(rule, "warning", x[2]) for x in w])
    if rule == "determinism":
        return sorted((rule, "error", x[2])
                      for x in mod.lint_source_text(relpath, text))
    if rule == "host_digest":
        d = tmp_path / pkg / relpath.rsplit("/", 1)[0]
        d.mkdir(parents=True)
        (d / "mini.py").write_text(text)
        v, _ = mod.scan_tree(root=tmp_path / pkg)
        return sorted((rule, "error", x[2]) for x in v)
    return sorted((rule, "error", x[2])
                  for x in mod.scan_source_text(relpath, text))


@pytest.mark.parametrize("name", sorted(PARITY))
def test_rules_match_jax_package_on_fixtures(name, tmp_path):
    """The port's rule and the JAX package's, on the same fixture text
    in the same zone of their packages: the same findings (rule,
    severity, line), tolerance 0."""
    rule, zone, text = PARITY[name]
    port_path, jax_path = _zone_paths(zone)
    port = _findings("wittgenstein_tpu_torch", rule, port_path, text,
                     tmp_path)
    jax = _findings("wittgenstein_tpu", rule, jax_path, text, tmp_path)
    assert port == jax
    if name.startswith(("locks_bad", "dur_bad_strict", "except_bad",
                        "determinism", "digest_tainted")):
        assert port, "a bad fixture must fire"


def test_report_schema_matches_jax_package():
    """Both packages' source-rule reports carry the same schema-2 keys,
    report and finding alike."""
    from wittgenstein_tpu.analysis import framework as jframework
    rules = ["host_locks", "host_durability", "host_digest",
             "host_except", "determinism"]
    port = framework.run_analysis(source_only=True,
                                  rule_names=rules).to_json()
    jax = jframework.run_analysis(source_only=True,
                                  rule_names=rules).to_json()
    assert port["schema"] == jax["schema"] == 2
    assert set(port) == set(jax)
    assert {k for f in port["findings"] for k in f} == \
        {k for f in jax["findings"] for k in f}
    assert port["rules"] == jax["rules"] and port["ok"]


# ------------------------------------------- whole-port gate + mutation

def test_source_scan_clean_and_fast():
    """The port's host plane passes all four rules at budget 0, and the
    whole source scan (determinism and the shared-memory models too)
    stays inside the 60-s CPU bound."""
    t0 = time.monotonic()
    rep = framework.run_analysis(source_only=True)
    wall = time.monotonic() - t0
    bad = [f for f in rep.findings if f.severity == "error"]
    assert bad == [], "\n".join(f"{f.span() or f.target}: {f.message}"
                                for f in bad)
    assert {"host_locks", "host_durability", "host_digest",
            "host_except", "determinism", "smem_budget"} <= set(rep.rules)
    assert rep.targets == []
    assert wall < 60.0, f"source scan took {wall:.1f}s"


def test_source_cli_subprocess_gate(tmp_path):
    """The analysis CLI as CI runs it: exit 0 and a schema-2 report;
    a budget regression in any source rule flips the exit code."""
    out = tmp_path / "report.json"
    proc = _cli("--source", "--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(out.read_text())
    assert payload["schema"] == framework.REPORT_SCHEMA
    assert payload["ok"] is True
    assert "host_locks" in payload["rules"]


SEEDED = '''
import json
import threading
import time


class SeededBad:
    _LOCK_OWNS = {"_mu": ("n",)}

    def __init__(self):
        self._mu = threading.Lock()
        self.n = 0

    def poke(self):
        self.n += 1                      # host_locks


def seeded_write(path):
    with open(path, "w") as f:           # host_durability (strict zone)
        json.dump({}, f)


def seeded_digest(obj):
    return f"{obj}-{time.time()}"        # host_digest


def seeded_eat(d):
    try:
        return d["k"]
    except KeyError:                     # host_except
        return 0
'''

SEEDED_MODEL = '''
import torch


def seeded_step(x):
    return x + torch.rand(x.shape)       # determinism
'''


def test_mutation_check_each_rule_fires(tmp_path):
    """Inject one seeded violation per source rule into a temp copy of
    the port (a host module, a model, a shared-memory limit no kernel
    fits) and prove every rule fires and the CLI exits nonzero."""
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "data",
                                    "build", "csrc")
    shutil.copytree(REPO / PORT, tmp_path / PORT, ignore=ignore)
    (tmp_path / PORT / "serve" / "_seeded_bad.py").write_text(SEEDED)
    (tmp_path / PORT / "models" / "_seeded_bad.py").write_text(SEEDED_MODEL)
    build = tmp_path / PORT / "ops" / "_build.py"
    text = build.read_text()
    assert "SMEM_OPTIN = 227 * 1024" in text
    build.write_text(text.replace("SMEM_OPTIN = 227 * 1024",
                                  "SMEM_OPTIN = 1024"))
    proc = _cli("--source", cwd=tmp_path, env={"PYTHONPATH": str(tmp_path)})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    errors = [line for line in proc.stdout.splitlines()
              if line.startswith("ERROR")]
    for rule in ("host_locks", "host_durability", "host_digest",
                 "host_except", "determinism"):
        assert any(rule in line and "_seeded_bad" in line
                   for line in errors), \
            f"{rule} did not fire on its seeded violation:\n" + proc.stdout
    assert any("smem_budget" in line and "K1 route" in line
               for line in errors), proc.stdout


def test_list_prints_scope_and_target_count():
    proc = _cli("--list")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = {line.split()[0]: line for line in proc.stdout.splitlines()
             if line.strip() and line.startswith("  ")}
    assert "global" in lines["host_locks"]
    assert "lock inventories" in lines["host_locks"]
    assert "digest entry points" in lines["host_digest"]
    assert "recorded protocol targets" in proc.stdout
    assert "targets (37)" in proc.stdout


def test_bench_suite_analysis_smoke(monkeypatch, capsys):
    """`cli.bench_suite analysis_smoke`: the ``--source`` pass as a
    subprocess, one line with the JAX stage's metric name and keys, no
    stage spec (the JAX table lists none), wall under 60 s."""
    from tools import bench_suite as jsuite
    from wittgenstein_tpu_torch.cli import bench_suite
    monkeypatch.setenv("WTPU_LEDGER", "0")
    assert bench_suite.main(["analysis_smoke", "--no-history",
                             "--device", "cpu"]) == 0
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert "error" not in line, line
    assert line["metric"] == bench_suite.METRIC_NAMES["analysis_smoke"] \
        == jsuite.METRIC_NAMES["analysis_smoke"]
    assert set(line) == {"metric", "value", "unit", "schema", "rules",
                         "n_findings", "platform"}
    assert line["value"] < 60.0 and line["schema"] == 2
    assert line["platform"] == "cpu" and "host_locks" in line["rules"]
    assert bench_suite._stage_spec("analysis_smoke") is None \
        and jsuite._stage_spec("analysis_smoke") is None
