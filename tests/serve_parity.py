"""Shared helpers of the request-plane parity tests
(`tests/test_torch_serve*.py`, `test_torch_tenancy.py`,
`test_torch_crash.py`, `test_torch_server.py`): the same specs through
the JAX package's `Scheduler`/`Service` and the port's (on the CPU),
compared with tolerance 0.

What a comparison leaves out is what a run cannot share, each named
here and nowhere else:

  * ``wall_s`` (artifacts), ``wall_total_s`` (the ledger line) and the
    manifest's ``wall_s`` and ``ts_unix``: walls and timestamps;
  * ``registry.persistent_cache``: the JAX compile-cache directory
    against the port's kernel build directory (a platform fact);
  * the manifest's ``backend`` (``"cpu"`` in both here, compared
    anyway where both ran on the CPU) and the exposition's
    ``wtpu_serve_chunk_wall_ema_seconds`` gauge (a wall);
  * ``retry_after_s`` of an admission refusal (it scales the chunk-wall
    EMA), and a result's ``manifest_path`` (the ledger file's path).
"""

from __future__ import annotations

import torch_parity as tp

from wittgenstein_tpu_torch import convert

#: artifact fields that are walls or platform facts
WALL_FIELDS = ("wall_s",)
#: manifest fields that are walls, timestamps or platform facts
MANIFEST_WALLS = ("wall_s", "ts_unix")
#: exposition series that are walls
EXPOSITION_WALLS = ("wtpu_serve_chunk_wall_ema_seconds",)


def jax_serve():
    """The JAX package's `serve` module, its protocol registry filled."""
    import wittgenstein_tpu.models  # noqa: F401 — fills the registry
    from wittgenstein_tpu import serve
    return serve


def port_serve():
    from wittgenstein_tpu_torch import serve
    return serve


def pair(jax_kw: dict | None = None, port_kw: dict | None = None, **kw):
    """``(JAX Scheduler, port Scheduler on the CPU)`` built with the same
    keyword arguments."""
    js, ps = jax_serve(), port_serve()
    return (js.Scheduler(**kw, **(jax_kw or {})),
            ps.Scheduler(**kw, **(port_kw or {}), device="cpu"))


def specs(spec: dict):
    """``(JAX ScenarioSpec, port ScenarioSpec)`` of one spec dict."""
    return jax_serve().ScenarioSpec(**spec), \
        port_serve().ScenarioSpec(**spec)


def clean_artifacts(art: dict | None) -> dict | None:
    """An artifact dict without its wall and platform fields."""
    if art is None:
        return None
    out = {k: v for k, v in art.items() if k not in WALL_FIELDS}
    if "registry" in out:
        out["registry"] = {k: v for k, v in out["registry"].items()
                           if k != "persistent_cache"}
    out.pop("manifest_path", None)
    return out


def clean_registry(block: dict) -> dict:
    return {k: v for k, v in block.items() if k != "persistent_cache"}


def assert_states_equal(jax_state, port_state, what=""):
    """A JAX ``(nets, ps)`` pair and a port one, leaf for leaf."""
    tp.assert_states_equal(tp.jax_state(*jax_state),
                           convert.to_numpy(*port_state), what)


def assert_requests_equal(jreq, preq, what=""):
    """Two settled requests: status, error, final state (when done),
    artifacts outside the wall and platform fields."""
    assert (jreq.status, jreq.error) == (preq.status, preq.error), what
    if jreq.final_state is not None or preq.final_state is not None:
        assert_states_equal(jreq.final_state, preq.final_state, what)
    ja, pa = clean_artifacts(jreq.artifacts), clean_artifacts(
        preq.artifacts)
    if ja != pa:
        diff = sorted(k for k in set(ja or {}) | set(pa or {})
                      if (ja or {}).get(k) != (pa or {}).get(k))
        raise AssertionError(f"{what}: artifacts differ in {diff}")
    assert jreq.progress_ms == preq.progress_ms, what
    assert jreq.resumed_from_ms == preq.resumed_from_ms, what
    assert jreq.preempted == preq.preempted, what


def assert_carries_equal(jreq, preq, what=""):
    """The raw per-chunk obs carries kept on two finished requests
    (``keep_carries=True``), plane by plane, chunk by chunk."""
    assert list(jreq.final_carries) == list(preq.final_carries), what
    for plane, jcs in jreq.final_carries.items():
        pcs = preq.final_carries[plane]
        assert len(jcs) == len(pcs), (what, plane)
        for i, (jc, pc) in enumerate(zip(jcs, pcs)):
            tp.assert_carries_equal(jc, pc, f"{what} {plane} chunk {i}")


def manifest_rows(path) -> list:
    """The ledger rows at `path` as dicts, without walls and
    timestamps."""
    from wittgenstein_tpu_torch.obs import ledger
    rows = []
    for row in ledger.read_all(path):
        d = row.to_json()
        for k in MANIFEST_WALLS:
            d.pop(k, None)
        rows.append(d)
    return rows


def exposition_lines(text: str) -> list:
    """An exposition's lines without the wall series."""
    return [ln for ln in text.splitlines()
            if not any(w in ln for w in EXPOSITION_WALLS)]


def assert_schedulers_equal(jsch, psch, rids_j, rids_p, what=""):
    """Every request of two schedulers that ran the same submits, and
    their scheduler-level blocks (resilience, memo, registry, tenancy
    without the EMA, the exposition without its walls)."""
    for a, b in zip(rids_j, rids_p):
        ra, rb = jsch.peek(a), psch.peek(b)
        assert (ra is None) == (rb is None), (what, a, b)
        if ra is not None:
            assert_requests_equal(ra, rb, f"{what} {a}")
    assert jsch.resilience == psch.resilience, what
    assert jsch.memo_stats() == psch.memo_stats(), what
    assert clean_registry(jsch.registry.stats()) == \
        clean_registry(psch.registry.stats()), what
    jt, pt = jsch.tenancy_stats(), psch.tenancy_stats()
    jt.pop("chunk_wall_ema_s"), pt.pop("chunk_wall_ema_s")
    assert jt == pt, what
    from wittgenstein_tpu.serve.instrument import \
        scheduler_exposition as jexp

    from wittgenstein_tpu_torch.serve.instrument import \
        scheduler_exposition as pexp
    assert exposition_lines(jexp(jsch)) == exposition_lines(pexp(psch)), \
        what
