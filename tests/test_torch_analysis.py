"""The port's program rules and op recorder catch what they claim to
catch (`wittgenstein_tpu_torch/analysis`): the counterparts of
tests/test_analysis.py and tests/test_analysis_budgets.py.

Synthetic `AnalysisTarget.from_fn` chunks, not protocols, for the rule
engine: a chunk that clones a ring plane for the carry_copy rule, a
float64 leaf for dtype_leak, an ``.item()`` inside the chunk for
host_sync, an over-limit fake model for smem_budget, and a mutated chunk
for every program rule.  The real gates: Handel's chunk copies no ring
plane, every target runs within the checked-in budgets on the CPU, and
``--update-budgets`` never raises a budget.  The ``cuda``-marked tests
are phase Y of `chip_smoke.py` at test size.
"""

from __future__ import annotations

import copy
import dataclasses
import json

import pytest
import torch

from wittgenstein_tpu_torch.analysis import (framework, rules_carry,
                                             rules_hostsync, rules_smem)
from wittgenstein_tpu_torch.analysis.targets import (AnalysisTarget,
                                                     get_target,
                                                     target_names)
from wittgenstein_tpu_torch.analysis.trace import OpRecorder, record


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fake_net(n=512):
    """Plane-named leaves so the carry rule's box_* attribution sees
    them, plus ballast."""
    return {"box_data": torch.zeros((4, n), dtype=torch.int32),
            "box_src": torch.zeros((4, n), dtype=torch.int32),
            "a": torch.zeros(n, dtype=torch.int32),
            "b": torch.zeros(n, dtype=torch.int32)}


def _copy_inducing_chunk(net):
    """Swapping the two same-shaped planes through copies every ms: the
    eager twin of the round-5 plane-copy regression."""
    for _ in range(4):
        net = dict(net, box_data=net["box_src"].clone() + 1,
                   box_src=net["box_data"].clone(), a=net["a"] + 1)
    return net


def _clean_chunk(net):
    """In place: every plane updated where it lies."""
    for _ in range(4):
        net["box_data"].add_(1)
        net["box_src"].add_(1)
        net = dict(net, a=net["a"] + 1)
    return net


def _run_rule(rule_name, target, budgets=None):
    framework._install_rules()
    rule = framework.RULES[rule_name]
    budget = (budgets or {}).get(rule_name, {}).get(target.name, {})
    findings = rule.run(target, budget)
    return framework.check_budget(findings, budgets or {}, rule,
                                  target.name)


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


def test_carry_rule_flags_copy_inducing_carry():
    bad = AnalysisTarget.from_fn("bad", _copy_inducing_chunk,
                                 (_fake_net(),), ms=4)
    good = AnalysisTarget.from_fn("good", _clean_chunk, (_fake_net(),),
                                  ms=4)
    m_bad, m_good = rules_carry.measure(bad), rules_carry.measure(good)
    assert m_bad["plane_copies"] == 8, m_bad        # both planes, 4 ms
    assert m_bad["copy_bytes"] == 8 * 4 * 512 * 4
    assert m_good["plane_copies"] == 0, m_good      # in place: none
    leaves = {r.leaf for r in rules_carry.audit(bad) if r.op == "copy"}
    assert leaves == {"[0].box_data/[0].box_src"}


def test_carry_rule_budget_gate():
    """A checked-in budget turns the measurement into a gate: the
    copy-inducing chunk errors against a 0-copy budget."""
    budgets = {"carry_copy": {"bad": {"plane_copies": 0},
                              "good": {"plane_copies": 0}}}
    bad = AnalysisTarget.from_fn("bad", _copy_inducing_chunk,
                                 (_fake_net(),))
    good = AnalysisTarget.from_fn("good", _clean_chunk, (_fake_net(),))
    errs_bad = _errors(_run_rule("carry_copy", bad, budgets))
    assert errs_bad and "budget" in errs_bad[0].message
    assert not _errors(_run_rule("carry_copy", good, budgets))


def test_ratchet_goes_down_never_up():
    f_lo = framework.Finding(rule="carry_copy", target="T", severity="info",
                             metric="plane_copies", value=1, message="")
    f_hi = framework.Finding(rule="carry_copy", target="T", severity="info",
                             metric="plane_copies", value=9, message="")
    framework._install_rules()
    budgets = {"carry_copy": {"T": {"plane_copies": 4}}}
    framework.ratchet_budgets([f_hi], budgets, framework.RULES)
    assert budgets["carry_copy"]["T"]["plane_copies"] == 4   # never up
    framework.ratchet_budgets([f_lo], budgets, framework.RULES)
    assert budgets["carry_copy"]["T"]["plane_copies"] == 1   # down ok


def test_smem_rule_rejects_fake_over_limit_model():
    def fat_model(q, w):
        return {"k": q * w * (1 << 20), "branch": "one"}

    findings = rules_smem.check_model("fake_kernel", fat_model,
                                      [(dict(q=16, w=64), "fake-cfg")])
    assert _errors(findings)
    findings = rules_smem.check_model(
        "fake_kernel", lambda q, w: {"k": q * w * 4, "branch": "one"},
        [(dict(q=16, w=64), "fake-cfg")])
    assert not _errors(findings)


def test_launcher_refuses_shape_past_the_limit():
    """The twin of `_pick_block` raising: a shape whose shared memory
    cannot fit a block raises before the launch, and the rule's refusal
    check sees it."""
    from wittgenstein_tpu_torch.ops import _build, gsf_merge
    with pytest.raises(ValueError, match="opt-in limit"):
        _build.check_smem("k", _build.SMEM_OPTIN + 1)
    _build.check_smem("k", _build.SMEM_OPTIN)
    w = _build.SMEM_OPTIN // 4
    assert gsf_merge.smem_bytes(w)["gsf_merge_kernel"] == _build.SMEM_OPTIN
    assert not _errors(rules_smem.check_refusals())


def test_smem_models_at_the_kernel_table_rows():
    """Every model fits at the kernel table's shapes, with the branches
    PERF.md names: K1's rank tables in device scratch at T3 and G32 and
    in shared memory at the headline; K4 unstaged at G32's W 1,024 and
    staged at GSF 4096's W 128; K2 narrow at Q 16 + S 12."""
    from wittgenstein_tpu_torch.ops import merge, route, score
    framework._install_rules()
    findings = framework.RULES["smem_budget"].run(None, {})
    assert not _errors(findings)
    assert len(findings) == sum(len(s) for *_, s in
                                rules_smem.kernel_models()) + 1
    assert route.smem_bytes(1, 256, 2048)["branch"] == "tables_in_smem"
    for h, n in ((256, 65536), (512, 32768)):
        got = route.smem_bytes(1, h, n)
        assert got["branch"] == "tables_in_scratch"
        assert got["route_rank_kernel"] == 0
    assert score.gsf_smem_bytes(16, 1024)["branch"] == "unstaged"
    assert score.gsf_smem_bytes(16, 128) == {"gsf_score_kernel": 40960,
                                             "branch": "staged"}
    assert merge.smem_bytes(16, 12) == {"merge_kernel": 512,
                                        "branch": "narrow"}


def test_dtype_rule_catches_f64_leaf():
    def chunk(x, t):
        return x * 2.0, t + 1

    target = AnalysisTarget.from_fn(
        "f64leak", chunk, (torch.zeros(4, dtype=torch.float64),
                           torch.zeros(4, dtype=torch.int32)))
    errs = _errors(_run_rule("dtype_leak", target))
    assert errs and "float64" in errs[0].message
    clean = AnalysisTarget.from_fn(
        "clean", chunk, (torch.zeros(4), torch.zeros(4, dtype=torch.int32)))
    assert not _errors(_run_rule("dtype_leak", clean))


def test_dtype_allowlist_is_the_float32_emulation():
    """float64 inside the chunk is an error outside ops/fmath.py, whose
    exact float32 emulation (ETHPoW's mining threshold) the budget file
    exempts."""
    from wittgenstein_tpu_torch.ops.fmath import exp_f32
    framework._install_rules()
    rule = framework.RULES["dtype_leak"]
    thr = AnalysisTarget.from_fn("thr", lambda x: 1.0 - exp_f32(x),
                                 (torch.linspace(-3.0, 0.0, 16),))
    assert not _errors(rule.run(thr, {}))
    assert _errors(rule.run(thr, {}, allow=frozenset()))
    f64 = AnalysisTarget.from_fn(
        "f64", lambda x: (x.double() * 3).float(), (torch.ones(4),))
    assert _errors(rule.run(f64, {}))


def test_isqrt_has_no_float64_and_is_exact():
    """The torus distance's integer root computes in float32, exact on
    every value below 2**24 (a distance squared is below 2**21): no
    float64 enters the step of a distance-latency protocol."""
    import numpy as np

    from wittgenstein_tpu_torch.analysis.rules_dtype import float64_sites
    from wittgenstein_tpu_torch.core.latency import isqrt
    v = torch.arange(0, 1 << 22, dtype=torch.int64)
    ref = np.floor(np.sqrt(v.numpy().astype(np.float64))).astype(np.int64)
    assert torch.equal(isqrt(v), torch.from_numpy(ref))
    rec, _ = record(isqrt, v[:64])
    assert float64_sites(rec) == {}


def test_host_sync_rule_catches_item():
    def with_item(x):
        for _ in range(2):
            n = int(x.sum())            # a host read inside the chunk
            x = x + n
        return x

    def without(x):
        for _ in range(2):
            x = x + x.sum()
        return x

    budgets = {"host_sync": {"cb": {"transfer_ops": 0}}}
    bad = AnalysisTarget.from_fn("cb", with_item,
                                 (torch.zeros(4, dtype=torch.int32),), ms=2)
    assert rules_hostsync.measure(bad)["transfer_ops"] == 2
    assert _errors(_run_rule("host_sync", bad, budgets))
    good = AnalysisTarget.from_fn("cb", without,
                                  (torch.zeros(4, dtype=torch.int32),))
    assert not _errors(_run_rule("host_sync", good, budgets))


def test_recorder_counts_reads_once_and_kernels_as_ops():
    """``tolist``/``numpy`` (no dispatch on a CPU tensor) are reads;
    ``.cpu().numpy()`` is one; a kernel's plain version is one
    ``wtpu::`` op, whatever runs inside it."""
    from wittgenstein_tpu_torch.ops.route import bin_into_ring

    x = torch.arange(6, dtype=torch.int32)
    rec, _ = record(lambda: (x.tolist(), x.cpu().numpy(), bool(x.any()),
                             x[x > 2]))
    assert [op.read for op in rec.host_reads] == \
        ["tolist", "numpy", "item", "mask-index"]
    r_, f_, h, n, c, m = 1, 2, 4, 8, 3, 5
    ring = [torch.zeros(r_, f_, h, n, c, dtype=torch.int32),
            torch.zeros(r_, h, n, c, dtype=torch.int32),
            torch.zeros(r_, h, n, c, dtype=torch.int32),
            torch.zeros(r_, h, n, dtype=torch.int32)]
    msgs = [torch.ones(r_, m, dtype=torch.int32),
            torch.arange(m, dtype=torch.int32)[None],
            torch.zeros(r_, m, dtype=torch.int32),
            torch.ones(r_, m, dtype=torch.int32),
            torch.ones(r_, m, f_, dtype=torch.int32),
            torch.ones(r_, m, dtype=torch.bool)]
    rec, _ = record(bin_into_ring, *ring, *msgs)
    assert rec.kernel_launches() == {"wtpu::route": 1}
    assert rec.host_reads == []          # the plain version's are hidden
    assert int(ring[3].sum()) == m


def test_determinism_lint_synthetic_sources():
    from wittgenstein_tpu_torch.analysis.rules_determinism import \
        lint_source_text

    src = (
        "import time\n"
        "import random\n"
        "import numpy as np\n"
        "import os\n"
        "import torch\n"
        "def step(x):\n"
        "    t = time.time()\n"
        "    r = random.random()\n"
        "    u = np.random.rand()\n"
        "    e = os.environ['WTPU_X']\n"
        "    g = torch.randn(3)\n"
        "    w = time.monotonic()\n"       # allowed: wall-clock bound
        "    return x\n")
    hits = lint_source_text("models/fake.py", src)
    assert sorted(h[3] for h in hits) == \
        ["numpy.random", "os.environ", "random", "time.time",
         "torch.randn"], hits
    hits = lint_source_text("models/fake.py", src,
                            allow=("models/fake.py::step::time.time",))
    assert "time.time" not in [h[3] for h in hits]


def test_report_json_shape():
    framework._install_rules()
    rep = framework.Report(findings=[
        framework.Finding(rule="r", target="t", severity="error",
                          message="m")], targets=["t"], rules=["r"])
    js = rep.to_json()
    assert js["schema"] == 2 and js["ok"] is False and js["n_errors"] == 1
    assert js["findings"][0]["rule"] == "r"


# -------------------------------------------- mutated chunk, every rule

def _plane_chunk(extra):
    """A chunk returning its state and `extra` plane leaves."""
    def chunk(net):
        net = _clean_chunk(net)
        return (net,) + tuple(torch.zeros(2) for _ in range(extra))
    return chunk


#: rule -> (clean chunk, mutated chunk, target name); a budget is
#: measured on the clean one and the mutated one must fail it (the
#: dtype and plane rules fail without a budget)
MUTATIONS = {
    "carry_copy": (_clean_chunk, _copy_inducing_chunk, "T"),
    "host_sync": (_clean_chunk,
                  lambda net: _clean_chunk(dict(net, n=int(net["a"][0]))),
                  "T"),
    "superstep_amortization": (
        _clean_chunk,
        lambda net: dict(_clean_chunk(net),
                         a=torch.sort(net["a"], stable=True).values),
        "T"),
    "dtype_leak": (_clean_chunk,
                   lambda net: dict(_clean_chunk(net),
                                    a=net["a"].to(torch.float64)), "T"),
    "metrics_zero_cost": (_plane_chunk(2), _plane_chunk(1), "T+metrics"),
    "trace_zero_cost": (_plane_chunk(4), _plane_chunk(3), "T+trace"),
    "audit_zero_cost": (_plane_chunk(5), _plane_chunk(4), "T+audit"),
}


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_program_rule_fires_on_mutated_chunk(rule):
    clean_fn, bad_fn, name = MUTATIONS[rule]
    framework._install_rules()
    clean = AnalysisTarget.from_fn(name, clean_fn, (_fake_net(),), ms=4)
    budgets = framework.ratchet_budgets(
        _run_rule(rule, clean), {}, framework.RULES)
    assert not _errors(_run_rule(rule, clean, budgets))
    bad = AnalysisTarget.from_fn(name, bad_fn, (_fake_net(),), ms=4)
    assert _errors(_run_rule(rule, bad, budgets)), rule


# ------------------------------------------------------ the real gates

def test_handel_plane_copies_zero():
    """The counterpart of the JAX package's round-5 gate: the pinned
    Handel target's chunk (the seed-folded engine) copies no ring plane
    — the engine writes the ring in place — and the recording is not
    vacuous (K1-K3 ran)."""
    target = get_target("Handel")
    launches = target.recorder.kernel_launches()
    assert launches == {"wtpu::route": 4, "wtpu::merge_queue": 8,
                        "wtpu::score_queue": 8}, launches
    metrics = rules_carry.measure(target)
    assert metrics["plane_copies"] == 0, metrics
    assert metrics["boxcount_copies"] == 0, metrics


def test_checked_in_budget_encodes_the_gate():
    with open(framework.BUDGETS_PATH) as f:
        budgets = json.load(f)
    assert budgets["carry_copy"]["Handel"]["plane_copies"] == 0
    assert budgets["host_durability"]["allow"] == [
        "wittgenstein_tpu_torch/serve/fleet.py::spawn_worker::open"]
    assert budgets["dtype_leak"]["allow"] == ["ops/fmath.py::*::float64"]
    assert set(budgets["host_sync"]) == set(target_names())


@pytest.fixture(scope="module")
def cpu_report():
    return framework.run_analysis(device="cpu")


def test_every_target_within_checked_in_budgets(cpu_report):
    """Every rule over every target on the CPU, against the checked-in
    budgets: no error (the CLI's ``--device cpu`` exits 0)."""
    assert cpu_report.targets == list(target_names())
    errs = _errors(cpu_report.findings)
    assert not errs, "\n".join(f"{f.rule} {f.target}: {f.message}"
                               for f in errs)
    reads = {f.target: f.value for f in cpu_report.findings
             if f.metric == "transfer_ops"}
    # the step hints read once a ms of the 8-ms chunk, beside the entry
    # time; the fast-forward oracle once a window
    assert reads["CasperIMD"] == reads["HandelEth2"] == 9
    assert reads["Handel"] == reads["PingPong"] == 1
    assert reads["PingPong+ff"] > 1


def test_update_budgets_never_raises_a_budget(cpu_report):
    """Ratcheting the checked-in budgets with this run's measurements,
    and with every measurement doubled, changes nothing upward."""
    framework._install_rules()
    checked = framework.load_budgets()
    again = framework.ratchet_budgets(cpu_report.findings,
                                      copy.deepcopy(checked),
                                      framework.RULES)
    assert again == checked
    worse = [dataclasses.replace(f, value=f.value * 2 + 1)
             if isinstance(f.value, (int, float)) else f
             for f in cpu_report.findings]
    assert framework.ratchet_budgets(worse, copy.deepcopy(checked),
                                     framework.RULES) == checked


# ------------------------------------------------ on the card (phase Y)

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("requires CUDA")


@pytest.mark.cuda
def test_cuda_recorder_reads_equal_card_syncs():
    """A Handel seed batch's chunk on the card, entry time read from the
    device: the recorder's host reads equal the synchronising calls
    `torch.cuda.set_sync_debug_mode` counts on the same chunk, and the
    kernels are recorded once a launch."""
    _require_cuda()
    from chip_smoke import sync_count

    from wittgenstein_tpu_torch.analysis.targets import _clone
    target = get_target("Handel", device="cuda")
    rec = target.recorder
    fn, args = target._ensure_built()
    state = _clone(args)
    assert sync_count(lambda: fn(*state)) == rec.syncs, \
        [(op.name, op.read, op.site) for op in rec.ops if op.site]
    assert rec.kernel_launches()["wtpu::route"] == 4


@pytest.mark.cuda
def test_cuda_smem_models_equal_launchers():
    _require_cuda()
    rows = rules_smem.card_check()
    assert rows and all(want == have for *_, want, have in rows), rows[:3]


@pytest.mark.cuda
def test_cuda_targets_within_budgets():
    _require_cuda()
    rep = framework.run_analysis(device="cuda",
                                 target_names=["Handel", "GSFSignature",
                                               "CasperIMD", "PingPong+ff"])
    assert rep.ok, [f.message for f in rep.errors]


def test_recorder_restores_what_it_wraps():
    from wittgenstein_tpu_torch.ops import _build, route
    before = (torch.Tensor.__dict__.get("tolist"), route.bin_into_ring_plain,
              _build.lib)
    with OpRecorder():
        assert route.bin_into_ring_plain is not before[1]
    assert (torch.Tensor.__dict__.get("tolist"), route.bin_into_ring_plain,
            _build.lib) == before
