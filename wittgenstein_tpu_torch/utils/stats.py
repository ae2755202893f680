"""Stats over node state — the port of `wittgenstein_tpu/utils/stats.py`
(the analogue of core/utils/StatsHelper.java).

A *getter* is a named function ``get(nodes: NodeState) -> dict[str,
scalar tensor]`` computed over LIVE nodes only (StatsHelper.java:120-137
filters on ``liveNodes()``).  Getters are plain tensor code, so the
harness evaluates them for every run of a batch at once under
`torch.func.vmap`; `avg_stats` averages a batch of stat dicts across the
run axis (StatsHelper.avg, :31-58).
"""

from __future__ import annotations

import torch


def _masked(vals, live):
    vals = vals.to(torch.float32)
    n = live.sum().clamp_min(1)
    big = 3.4e38
    return {
        "min": torch.where(live, vals, big).min(),
        "max": torch.where(live, vals, -big).max(),
        "avg": torch.where(live, vals, 0.0).sum() / n,
    }


def simple_stats(name, field):
    """StatsHelper.SimpleStatsGetter over one NodeState field by name."""

    def get(nodes):
        return _masked(getattr(nodes, field), ~nodes.down)

    get.stat_name = name
    return get


done_at_stats = simple_stats("doneAt", "done_at")          # GetDoneAt
msg_received_stats = simple_stats("msgReceived", "msg_received")
msg_sent_stats = simple_stats("msgSent", "msg_sent")
bytes_received_stats = simple_stats("bytesReceived", "bytes_received")
bytes_sent_stats = simple_stats("bytesSent", "bytes_sent")


def done_count(nodes):
    """How many live nodes reached done (doneAt > 0)."""
    live = ~nodes.down
    return {"count": (live & (nodes.done_at > 0)).sum().to(torch.float32)}


done_count.stat_name = "doneCount"


def mean(v):
    """The float32 mean as the JAX package's `jnp.mean` rounds it: the
    sum times the float32 reciprocal of the count (a division rounds
    differently in one case of three).  The sum is taken on the CPU,
    whose order of additions the tests hold against the JAX package's:
    a CUDA reduction adds in another order, which rounds differently
    (one of phase L's seven means did, on an H100)."""
    v = v.detach().cpu()
    return float(v.sum() * torch.tensor(1.0 / v.numel(), dtype=v.dtype))


def avg_stats(batch):
    """Average a stat dict whose leaves have a leading run axis
    (StatsHelper.avg semantics: plain mean of each component)."""
    return {k: mean(v) for k, v in batch.items()}
