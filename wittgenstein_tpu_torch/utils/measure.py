"""The wall-clock measurement protocol of the benchmark — the port of
`wittgenstein_tpu/utils/measure.py`.

1. Every tensor the caller's convergence and health asserts read is
   copied to the host INSIDE the timed window (`check`'s copies are the
   proof the device finished: the bytes cannot exist before it computed
   them).
2. At least `reps` repetitions; the median, min and max are reported.
3. One fully synchronous cross-check repetition (a scalar read back
   after every chunk).  If the asynchronous median implies more than
   `sync_tolerance` times the synchronous rate, the synchronous rate is
   reported instead, flagged ``"crosscheck": "sync_override"``.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def timed_chunks(step, init, steps, batch, chunk_ms, check, reps=3,
                 sync_tolerance=2.0):
    """Measure `steps` x `chunk_ms` of simulation under the protocol above.

    step:  (nets, ps) -> (nets, ps), one chunk
    init:  () -> (nets, ps) fresh initial state
    batch: number of parallel runs inside `step` (for the aggregate rate)
    check: (nets, ps) -> dict of host-side facts; must copy to the host
           every tensor its asserts read, and raise on convergence or
           drop failures.

    Returns a result dict: value (aggregate sim-ms/s), reps, wall
    stats, sync_rate, crosscheck, plus `check`'s facts.
    """
    def one_rep(sync):
        nets, ps = init()
        # Init finished outside the window (a host copy of the clock).
        nets.time.cpu()
        t0 = time.perf_counter()
        for _ in range(steps):
            nets, ps = step(nets, ps)
            if sync:
                # A scalar device->host copy per chunk: the chunk has
                # finished before the next one is issued.
                int(nets.time.sum())
        facts = check(nets, ps)             # device->host inside window
        wall = time.perf_counter() - t0
        return wall, facts

    # Warm up with ONE chunk (the kernels' build and first launches),
    # then start again from a fresh state.
    nets, ps = init()
    nets, ps = step(nets, ps)
    nets.time.cpu()

    walls = [one_rep(sync=False)[0] for _ in range(max(1, reps))]
    sync_wall, facts = one_rep(sync=True)
    med = float(np.median(walls))
    total = batch * steps * chunk_ms
    async_rate, sync_rate = total / med, total / sync_wall
    if async_rate > sync_tolerance * sync_rate:
        # One more synchronous chance before the asynchronous number is
        # distrusted; a slower repetition never makes a rate higher.
        sync_wall2, _ = one_rep(sync=True)
        sync_wall = min(sync_wall, sync_wall2)
        sync_rate = total / sync_wall
    out = {
        "value": round(async_rate, 1),
        "unit": "sim_ms/s",
        "reps": len(walls),
        "wall_median_s": round(med, 4),
        "wall_min_s": round(min(walls), 4),
        "wall_max_s": round(max(walls), 4),
        "sync_rate": round(sync_rate, 1),
        "crosscheck": "ok",
        **facts,
    }
    if async_rate > sync_tolerance * sync_rate:
        print(f"measure: CROSS-CHECK FAILED — async median implies "
              f"{async_rate:.1f} sim-ms/s but the synchronous pass "
              f"measured {sync_rate:.1f} ({async_rate / sync_rate:.1f}x); "
              f"emitting the synchronous rate", file=sys.stderr)
        out["crosscheck"] = "sync_override"
        out["value"] = round(sync_rate, 1)
    return out
