"""Rule ``host_sync`` — host reads inside a chunk, counted and ratcheted
(the port's counterpart of `wittgenstein_tpu/analysis/rules_hostsync.py`).

The performance model assumes a chunk of simulated milliseconds keeps
the card busy: every read of the device from the host inside the chunk
makes the host wait for the card, and the card then waits for the
host's next launches.  The JAX package pins the count at 0 — its chunk
is one XLA program.  The port's chunk is a Python loop that reads the
card on purpose: the entry time when the caller does not pass it
(`network.scan_chunk`), a protocol's `step_hint` once a ms (Casper,
ENR, ETHPoW, HandelEth2, P2PHandel, Paxos), the fast-forward oracle once
a window.  So each target's count is measured, budgeted at its value
and ratchets down; a new read fails the gate with its op named.

Metrics, per target:
  transfer_ops   — host reads in one chunk (`analysis/trace.py`:
                   items, nonzero, data-dependent shapes, mask
                   indexing, device-to-host copies, tolist/numpy), the
                   budgeted metric, held on the card too;
  reads_per_ms   — the same over the chunk's simulated ms;
  h2d_copies     — blocking host-to-device copies (on a card only).
"""

from __future__ import annotations

import collections

from .framework import Finding, Rule, register_rule


def measure(target) -> dict:
    rec = target.recorder
    n = len(rec.host_reads)
    ms = target.ms or 0
    return {"transfer_ops": n,
            "reads_per_ms": round(n / ms, 4) if ms else None,
            "h2d_copies": len(rec.h2d_copies)}


@register_rule
class HostSyncRule(Rule):
    name = "host_sync"
    scope = "protocol"
    budgeted_metrics = ("transfer_ops",)
    device_metrics = ("transfer_ops",)

    def run(self, target, budget):
        m = measure(target)
        kinds = collections.Counter(f"{op.read}:{op.name}"
                                    for op in target.recorder.host_reads)
        what = ", ".join(f"{k} x{v}" for k, v in sorted(kinds.items()))
        return [Finding(
                    rule=self.name, target=target.name, severity="info",
                    metric="transfer_ops", value=m["transfer_ops"],
                    message=f"transfer_ops={m['transfer_ops']} host reads "
                            f"in the chunk ({what or 'none'})"),
                Finding(
                    rule=self.name, target=target.name, severity="info",
                    metric="reads_per_ms", value=m["reads_per_ms"],
                    message=f"{m['reads_per_ms']} host reads a simulated "
                            "ms"),
                Finding(
                    rule=self.name, target=target.name, severity="info",
                    metric="h2d_copies", value=m["h2d_copies"],
                    message=f"{m['h2d_copies']} blocking host-to-device "
                            "copies in the chunk")]
