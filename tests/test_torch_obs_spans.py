"""The port's host plane (`obs/spans.py`, `obs/metrics.py`,
`obs/export.spans_to_perfetto`, `serve/instrument.py`): the twins of
tests/test_obs_spans.py, each held to the JAX package — the same emit
sequence under the same fake clock writes byte-identical JSONL in both,
the same metrics writes give the same exposition text, the same rows
merge into the same Perfetto trace — plus the port scheduler's
spans-OFF zero overhead and its instrumented lifecycle."""

import json
import os

import pytest
import torch

from wittgenstein_tpu_torch.obs.export import (SPAN_PID_BASE,
                                               spans_to_perfetto)
from wittgenstein_tpu_torch.obs.metrics import (MetricsRegistry,
                                                parse_exposition)
from wittgenstein_tpu_torch.obs.spans import SpanRecorder, read_spans
from wittgenstein_tpu_torch.serve import ScenarioSpec, Scheduler
from wittgenstein_tpu_torch.serve.instrument import (HEALTH_PHASES,
                                                     LIFECYCLE,
                                                     Instrumentation)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(**kw):
    base = dict(protocol="PingPong", params={"node_count": 64},
                seeds=(0,), sim_ms=80, chunk_ms=40, obs=("metrics",))
    base.update(kw)
    return ScenarioSpec(**base)


class FakeClock:
    """A deterministic monotonic clock: each call advances 1 ms."""

    def __init__(self, t=100.0, step=0.001):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _emit_sequence(rec):
    t0 = rec.now()
    rec.emit("serve.submit", t0, rid="r1", key="k", tenant="t")
    rec.mark("serve.retry", attempt=1, error="ValueError")
    with rec.span("serve.chunk", key="k", lanes=2):
        rec.now()
    rec.emit("serve.settle", rec.now(), rid="r1", wall_s=0.25)


def _jax_obs():
    from wittgenstein_tpu.obs import export, metrics, spans
    return spans, metrics, export


def test_fake_clock_byte_identical_jsonl(tmp_path):
    """The same emit sequence under the same fake clock writes the same
    bytes twice in the port, and the bytes the JAX recorder writes."""
    jspans = _jax_obs()[0]
    paths = []
    for run, cls in (("a", SpanRecorder), ("b", SpanRecorder),
                     ("jax", jspans.SpanRecorder)):
        p = tmp_path / f"spans-{run}.jsonl"
        _emit_sequence(cls(path=p, clock=FakeClock(), worker="w0"))
        paths.append(p)
    a, b, j = (p.read_bytes() for p in paths)
    assert a == b == j and a.count(b"\n") == 4
    rows = read_spans(paths[0])
    assert [r["name"] for r in rows] == [
        "serve.submit", "serve.retry", "serve.chunk", "serve.settle"]
    assert rows[0]["t0"] == pytest.approx(100.001)
    assert rows == jspans.read_spans(paths[2])


def test_ring_bounded_and_stats():
    rec = SpanRecorder(capacity=4, clock=FakeClock())
    for i in range(10):
        rec.mark("m", i=i)
    st = rec.stats()
    assert st["emitted"] == 10 and st["in_ring"] == 4
    assert [r["i"] for r in rec.snapshot()] == [6, 7, 8, 9]
    q = rec.phase_quantiles()
    assert q["m"]["count"] == 4 and q["m"]["p50_ms"] == 0.0


def test_spans_off_zero_overhead(monkeypatch):
    """The port scheduler's uninstrumented path never touches the
    recorder or the registry."""
    def boom(*a, **k):
        raise AssertionError("instrumentation touched with spans OFF")
    monkeypatch.setattr(SpanRecorder, "emit", boom)
    monkeypatch.setattr(MetricsRegistry, "observe", boom)
    monkeypatch.setattr(MetricsRegistry, "inc", boom)
    sch = Scheduler(device="cpu")
    assert sch._ins is None
    rid = sch.submit(_spec())
    assert sch.peek(rid).enq_mono is None
    sch.run_pending()
    req = sch.request(rid)
    assert req.status == "done", req.error
    assert req.enq_mono is None
    assert "phases" not in sch.health_stats()


def test_torn_tail_log_still_parses(tmp_path):
    p = tmp_path / "spans-dead.jsonl"
    _emit_sequence(SpanRecorder(path=p, clock=FakeClock(), worker="w1"))
    with open(p, "ab") as f:
        f.write(b'{"schema": 1, "name": "serve.chu')
    rows = read_spans(p)
    assert len(rows) == 4 and rows[-1]["name"] == "serve.settle"


def test_non_span_rows_skipped(tmp_path, capsys):
    p = tmp_path / "spans-x.jsonl"
    SpanRecorder(path=p, clock=FakeClock()).mark("ok")
    with open(p, "a") as f:
        f.write(json.dumps({"not": "a span"}) + "\n")
    assert [r["name"] for r in read_spans(p)] == ["ok"]
    assert "not a span" in capsys.readouterr().err


def test_perfetto_merge_round_trip(tmp_path):
    """Host spans of two workers merged with a device trace: the JAX
    package's merge of the same rows, and a JSON round trip."""
    recs = {w: SpanRecorder(clock=FakeClock(), worker=w)
            for w in ("w0", "w1")}
    for w, rec in recs.items():
        t0 = rec.now()
        rec.emit("serve.queue_wait", t0, rid=f"{w}-r0")
        rec.emit("serve.chunk", rec.now(), key="k")
        rec.mark("serve.retry", attempt=1)
    rows = [r for rec in recs.values() for r in rec.snapshot()]
    device = {"traceEvents": [
        {"ph": "M", "pid": 90210, "name": "process_name",
         "args": {"name": "wtpu engine"}},
        {"ph": "X", "pid": 90210, "tid": 0, "ts": 0, "dur": 1000,
         "name": "interval"}]}
    out = tmp_path / "timeline.json"
    trace = spans_to_perfetto(rows, device=device, path=out)
    assert trace == _jax_obs()[2].spans_to_perfetto(rows, device=device)
    loaded = json.loads(out.read_text())
    assert loaded == json.loads(json.dumps(trace))
    ev = loaded["traceEvents"]
    assert {SPAN_PID_BASE, SPAN_PID_BASE + 1, 90210} <= \
        {e["pid"] for e in ev}
    names = {e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert any(n.endswith("worker w0 (wall time)") for n in names)
    assert "request w1-r0" in names
    qw = next(e for e in ev if e["name"] == "serve.queue_wait")
    assert "t0" not in qw["args"] and "worker" not in qw["args"]


def test_metrics_exposition_parses_and_is_monotone():
    """The same writes give the JAX registry's exposition text, which
    parses, and every counter and histogram series is monotone."""
    jm = _jax_obs()[1].MetricsRegistry()
    m = MetricsRegistry()
    for reg in (m, jm):
        reg.inc("wtpu_x_total", 2, help="a counter")
        reg.set_gauge("wtpu_depth", 3)
        reg.observe("wtpu_lat_seconds", 0.05, buckets=(0.01, 0.1, 1.0))
    assert m.exposition() == jm.exposition()
    s0 = parse_exposition(m.exposition())
    assert s0["wtpu_x_total"] == 2.0
    assert s0['wtpu_lat_seconds_bucket{le="0.1"}'] == 1.0
    for reg in (m, jm):
        reg.inc("wtpu_x_total")
        reg.observe("wtpu_lat_seconds", 5.0)
        reg.set_gauge("wtpu_depth", 1)
    assert m.exposition() == jm.exposition()
    s1 = parse_exposition(m.exposition())
    for k in s0:
        if k != "wtpu_depth":
            assert s1[k] >= s0[k], k
    assert s1['wtpu_lat_seconds_bucket{le="+Inf"}'] == 2.0


def test_metrics_counter_discipline():
    m = MetricsRegistry()
    with pytest.raises(ValueError):
        m.inc("wtpu_x_total", -1)
    m.set_counter("wtpu_x_total", 5)
    m.set_counter("wtpu_x_total", 3)
    assert m.snapshot()["counters"]["wtpu_x_total"] == 5
    assert m.exposition() == m.exposition()


def test_instrumented_lifecycle_and_health(tmp_path):
    """An instrumented port scheduler emits the full ordered lifecycle,
    the durable log agrees with the ring, and health carries the phase
    quantiles and the histograms fed at emit time."""
    ins = Instrumentation(
        span_path=os.path.join(tmp_path, "spans-serve.jsonl"),
        worker="serve")
    sch = Scheduler(instrument=ins, device="cpu")
    rid = sch.submit(_spec())
    sch.run_pending()
    assert sch.request(rid).status == "done"
    rows = ins.spans.snapshot()
    first = {}
    for r in rows:
        first.setdefault(r["name"], r["t0"])
    assert not [n for n in LIFECYCLE if n not in first]
    order = [first[n] for n in LIFECYCLE]
    assert order == sorted(order)
    settle = next(r for r in rows if r["name"] == "serve.settle")
    assert settle["rid"] == rid and settle["worker"] == "serve"
    disk = read_spans(os.path.join(tmp_path, "spans-serve.jsonl"))
    assert [r["name"] for r in disk] == [r["name"] for r in rows]
    phases = sch.health_stats()["phases"]
    assert set(phases) <= set(HEALTH_PHASES)
    assert phases["serve.queue_wait"]["count"] >= 1
    hists = ins.metrics.snapshot()["histograms"]
    assert hists["wtpu_serve_queue_wait_seconds"]["count"] >= 1
    assert hists["wtpu_serve_chunk_seconds"]["count"] >= 2


def test_scheduler_exposition_uninstrumented():
    """The exposition of a fresh port scheduler is the JAX package's."""
    import wittgenstein_tpu.models  # noqa: F401
    from wittgenstein_tpu.serve import Scheduler as JScheduler
    from wittgenstein_tpu.serve.instrument import \
        scheduler_exposition as jexp

    from wittgenstein_tpu_torch.serve.instrument import scheduler_exposition
    text = scheduler_exposition(Scheduler(device="cpu"))
    assert text == jexp(JScheduler())
    parsed = parse_exposition(text)
    assert parsed["wtpu_serve_submits_total"] == 0.0
    assert parsed["wtpu_serve_queue_depth"] == 0.0
