#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`wittgenstein_tpu_torch`) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. device and build: the card's name and power limit, then the CUDA
   kernels built from ``wittgenstein_tpu_torch/csrc`` with nvcc, with
   each kernel's registers and shared memory;
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the path that runs it (route at both paths' shapes):
   bit-equal outputs, and both timed with the profiler and CUDA events.
   A kernel's time (``ms``, ``kernel_us``) is cold: the L2 is flushed
   before each call, as the path leaves it; ``kernel_us_warm`` repeats
   the call on inputs the L2 still holds;
3. the Handel path: the reference-default Handel (2048 nodes, 204 down)
   through `Runner.run_ms` for 1000 ms, launch counters reset just
   before; it must converge (live frac_done > 0.99) with zero drops,
   clamps and evictions, and launch route, merge and score once per
   simulated ms;
3b. the GSF path: `GSFSignature(node_count=4096)` with its defaults,
   seed 0, for 600 ms, counters reset just before; live frac_done >
   0.99 with zero drops and clamps, and route, gsf_merge and gsf_score
   launched once per simulated ms;
4. against the reference: a second Handel run of seed 0 matches the JAX
   package's golden digest at 200 ms and the first run's final state
   at 1000 ms;
4b. a second GSF run of seed 0 matches the JAX golden digest and the
   first run's state at 600 ms.

It prints one JSON line per kernel, the ``{"kernels": [...]}`` summary,
the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  ``--profile MS`` also profiles MS
simulated ms of each path with `torch.profiler` (Handel from t=600, GSF
from t=300, the busiest stretches), reports the device us a simulated
ms of each path's kernels by name, and writes the tables to
``--profile-file`` and ``--profile-gsf-file``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

N_NODES = 2048
MAIN_MS = 1000
GOLDEN_MS = 200
GSF_NODES = 4096
GSF_MS = 600
GSF_GOLDEN = os.path.join("wittgenstein_tpu_torch", "data",
                          "golden_gsf4096_600ms.json")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
WARMUP, ITERS = 3, 20


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing


def call_ms(fn, reset=None):
    """Mean ms of one call of fn() after WARMUP, with CUDA events around
    each call: the device's view of a call, host launch overhead
    included where the device waits for it.  `reset` (untimed) restores
    inputs that fn updates in place."""
    import torch
    for _ in range(WARMUP):
        if reset:
            reset()
        fn()
    total = 0.0
    for _ in range(ITERS):
        if reset:
            reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / ITERS


def kernel_device_us(events, match=None):
    """Summed device time (us) of the CUDA kernels among profiler
    `events` whose name contains `match` (all kernels if None)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and
               (match is None or match in e.key))


def device_ms(fn, match=None, reset=None):
    """Mean device ms per call of fn() from `torch.profiler`: the time of
    the CUDA kernels named like `match` (all of fn's kernels if None),
    over ITERS calls after WARMUP; the time of `reset`'s own kernels is
    measured the same way and taken off."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    def run(with_fn):
        for _ in range(WARMUP):
            if reset:
                reset()
            fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                if reset:
                    reset()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        return kernel_device_us(prof.key_averages(), match)
    # The profiler now and then delivers none of a window's device
    # events: such a window is measured again, twice at most.
    for _ in range(3):
        total = run(True)
        if total > 0:
            break
    if total > 0 and reset and match is None:
        total -= run(False)
    if total <= 0:
        fail(f"the profiler saw no device time for {match or 'the call'}")
    return total / ITERS / 1e3


_FLUSH = []


def l2_flush():
    """Write a 96 MB buffer, twice the H100's 50 MB L2, then read another:
    the next kernel finds its inputs in device memory, as on the path,
    where each simulated ms writes the ring (Handel) or copies the
    111 MB pool (GSF) between two calls.  The read leaves the L2 clean,
    so the kernel is not charged for writing the buffer back."""
    import torch
    if not _FLUSH:
        _FLUSH.extend(torch.empty(96 << 20, dtype=torch.uint8,
                                  device="cuda") for _ in range(2))
    _FLUSH[0].zero_()
    _FLUSH[1].max()


def cold(reset=None):
    """An untimed reset that runs `reset` and then flushes the L2."""
    def fn():
        if reset:
            reset()
        l2_flush()
    return fn


def max_abs_err(plain, kern):
    err = 0
    for a, b in zip(plain, kern):
        d = (a.to("cpu").long() - b.to("cpu").long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---------------------------------------------------------- kernel cases


def route_case(dev, rng, hz=256, n=N_NODES, c=12, out_deg=21):
    """A path's shapes (Handel: R 1, F 3, H 256, N 2048, C 12 and M =
    2048 x 21 messages; GSF: H 512, N 4096, C 16, M = 4096 x 22);
    part-full and full cells, a few hot cells that overflow, invalid
    messages interleaved."""
    import torch
    r, f = 1, 3
    m = n * out_deg
    data = torch.tensor(rng.integers(0, 1 << 20, (r, f, hz, n, c)),
                        dtype=torch.int32, device=dev)
    src = torch.tensor(rng.integers(0, n, (r, hz, n, c)), dtype=torch.int32,
                       device=dev)
    size = torch.tensor(rng.integers(0, 300, (r, hz, n, c)),
                        dtype=torch.int32, device=dev)
    count = rng.integers(0, 4, (r, hz, n))
    count[:, :8] = c                                    # full rows
    count = torch.tensor(count, dtype=torch.int32, device=dev)
    arrival = rng.integers(0, hz, m) + 3 * hz           # rows wrap
    dest = rng.integers(0, n, m)
    hot = rng.random(m) < 0.05                          # overflowing cells
    arrival[hot], dest[hot] = 100, rng.integers(0, 4, hot.sum())
    msg = [torch.tensor(a[None], dtype=torch.int32, device=dev)
           for a in (arrival, dest, rng.integers(0, n, m),
                     rng.integers(1, 300, m))]
    payload = torch.tensor(rng.integers(0, 1 << 20, (r, m, f)),
                           dtype=torch.int32, device=dev)
    valid = torch.tensor((rng.random(m) < 0.7)[None], device=dev)
    return [data, src, size, count], msg + [payload, valid]


def route_bytes(ring, msg, count_after):
    """Least bytes this batch needs: `valid` (bool) of every message,
    the arrival and dest of the valid ones, F + 2 words read and F + 2
    written per accepted message, the touched count cells read and
    written, the drop counter written."""
    import torch
    data = ring[0]
    r, f = data.shape[:2]
    hz, n = data.shape[2], data.shape[3]
    arrival, dest, _, _, _, valid = msg
    v = valid[0]
    cells = torch.unique((arrival[0][v].long() % hz) * n + dest[0][v])
    accepted = int((count_after - ring[3]).sum())
    return (valid.numel() * valid.element_size() + 8 * int(v.sum()) +
            4 * (2 * accepted * (f + 2) + 2 * cells.numel() + r))


def phase_route(dev, rng, **shape):
    import torch
    from wittgenstein_tpu_torch.ops.route import bin_into_ring, \
        bin_into_ring_plain
    ring, msg = route_case(dev, rng, **shape)
    plain = [t.clone() for t in ring]
    kern = [t.clone() for t in ring]
    dp = bin_into_ring_plain(*plain, *msg)
    dk = bin_into_ring(*kern, *msg)
    torch.cuda.synchronize()
    err = max_abs_err(plain + [dp], kern + [dk])
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"route kernel differs from its plain version (max err {err})")
    nbytes = route_bytes(ring, msg, kern[3])
    work = [t.clone() for t in ring]

    def reset():
        work[3].copy_(ring[3])

    def kern_fn():
        bin_into_ring(*work, *msg)

    def plain_fn():
        bin_into_ring_plain(*work, *msg)
    # Each phase alone, cold, by its kernel's name; then the whole call
    # cold: every device op of the wrapper, the reset's own ops measured
    # alone and taken off.  Warm, both phases by the prefix of their
    # names: taking off the count copy's time there left a spread wider
    # than the call.
    phases = {k: device_ms(kern_fn, k, cold(reset)) * 1e3
              for k in ("route_bucket_kernel", "route_rank_kernel")}
    return dict(err=err, ms=device_ms(kern_fn, None, cold(reset)),
                warm_ms=device_ms(kern_fn, "route_", reset), phases_us=phases,
                plain_ms=device_ms(plain_fn, None, reset),
                call_ms=call_ms(kern_fn, reset),
                plain_call_ms=call_ms(plain_fn, reset), nbytes=nbytes,
                drops=int(dk[0]))


def merge_case(dev, rng):
    """Main-path shapes: M 2048, Q 16, S 12, W 64; a queue 70% full,
    60% of inbox slots valid, planted (sender, level) duplicates within
    the inbox and against the queue."""
    import numpy as np
    import torch
    m, q, s, w = N_NODES, 16, 12, N_NODES // 32
    q_from = np.where(rng.random((m, q)) < 0.7,
                      rng.integers(0, m, (m, q)), -1)
    q_lvl = rng.integers(0, 12, (m, q))
    src = rng.integers(0, m, (m, s))
    level = rng.integers(0, 12, (m, s))
    pick = rng.random((m, s))
    prev = rng.integers(0, s, (m, s)) % np.maximum(np.arange(s), 1)
    dup = (pick < 0.3) & (np.arange(s) > 0)
    rows = np.nonzero(dup)
    src[rows] = src[rows[0], prev[rows]]
    level[rows] = level[rows[0], prev[rows]]
    qq = rng.integers(0, q, (m, s))
    hit = (pick >= 0.3) & (pick < 0.6) & (np.take_along_axis(
        q_from, qq, 1) >= 0)
    rows = np.nonzero(hit)
    src[rows] = q_from[rows[0], qq[rows]]
    level[rows] = q_lvl[rows[0], qq[rows]]

    def i32(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def bits(*shape):
        return torch.tensor(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32), device=dev)
    return [i32(q_from), i32(q_lvl), i32(rng.integers(0, 2 * m, (m, q))),
            torch.tensor(rng.random((m, q)) < 0.2, device=dev), bits(m, q, w),
            i32(src), i32(level), i32(rng.integers(0, 2 * m, (m, s))),
            torch.tensor(rng.random((m, s)) < 0.6, device=dev),
            bits(m, s, w)]


def merge_bytes(args):
    """Least bytes: every queue and inbox column read once, the Q sig
    rows kept per node read (of its Q + S candidates' rows), the new
    columns and sig plane written, the eviction count written."""
    q_sig = args[4]
    cols_in = sum(t.numel() * t.element_size()
                  for i, t in enumerate(args) if i not in (4, 9))
    cols_out = sum(t.numel() * t.element_size() for t in args[:4])
    return cols_in + cols_out + 2 * q_sig.numel() * q_sig.element_size() + 4


def phase_merge(dev, rng):
    import torch
    from wittgenstein_tpu_torch.ops.merge import merge_queue, \
        merge_queue_plain
    args = merge_case(dev, rng)
    plain = merge_queue_plain(*args)
    kern = merge_queue(*args)
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"merge kernel differs from its plain version (max err {err})")
    nbytes = merge_bytes(args)
    return dict(err=err, ms=device_ms(lambda: merge_queue(*args),
                                      "merge_kernel", cold()),
                warm_ms=device_ms(lambda: merge_queue(*args),
                                  "merge_kernel"),
                plain_ms=device_ms(lambda: merge_queue_plain(*args)),
                call_ms=call_ms(lambda: merge_queue(*args)),
                plain_call_ms=call_ms(lambda: merge_queue_plain(*args)),
                nbytes=nbytes, evicted=int(kern[5]))


def phase_score(dev, rng):
    import numpy as np
    import torch
    from wittgenstein_tpu_torch.ops.score import score_queue, \
        score_queue_plain
    m, q, w = N_NODES, 16, N_NODES // 32

    def bits(*shape):
        return torch.tensor(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32), device=dev)
    args = [bits(m, q, w),
            torch.tensor(rng.integers(0, 12, (m, q)), dtype=torch.int32,
                         device=dev),
            torch.arange(m, dtype=torch.int32, device=dev),
            bits(m, w), bits(m, w), bits(m, w)]
    plain = score_queue_plain(*args)
    kern = score_queue(*args)
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"score kernel differs from its plain version (max err {err})")
    # Inputs: sig plane, levels, ids, three rows; outputs: three int32
    # and one bool [M, Q].
    nbytes = 4 * (m * q * w + m * q + m + 3 * m * w + 3 * m * q) + m * q
    return dict(err=err, ms=device_ms(lambda: score_queue(*args),
                                      "score_kernel", cold()),
                warm_ms=device_ms(lambda: score_queue(*args),
                                  "score_kernel"),
                plain_ms=device_ms(lambda: score_queue_plain(*args)),
                call_ms=call_ms(lambda: score_queue(*args)),
                plain_call_ms=call_ms(lambda: score_queue_plain(*args)),
                nbytes=nbytes)


def phase_route_gsf(dev, rng):
    return phase_route(dev, rng, hz=512, n=GSF_NODES, c=16, out_deg=22)


def gsf_merge_case(dev, rng):
    """GSF shapes: M 4096, Q 16, S 16, W 128, L 13; a queue 70% full (30%
    individuals), 60% of inbox slots valid, planted same-sender and
    same-(sender, level) duplicates and superseded queue entries, a
    got_indiv row consuming a third of the senders' individuals; the
    masks derived as `models/gsf._receive` derives them."""
    import numpy as np
    import torch
    m, q, s, w, levels = GSF_NODES, 16, 16, GSF_NODES // 32, 13
    q_from = np.where(rng.random((m, q)) < 0.7, rng.integers(0, m, (m, q)),
                      -1)
    q_lvl = rng.integers(0, levels, (m, q))
    q_indiv = rng.random((m, q)) < 0.3
    src = rng.integers(0, m, (m, s))
    level = rng.integers(0, levels, (m, s))
    pick = rng.random((m, s))
    prev = rng.integers(0, s, (m, s)) % np.maximum(np.arange(s), 1)
    rows = np.nonzero((pick < 0.3) & (np.arange(s) > 0))
    src[rows] = src[rows[0], prev[rows]]
    rows = np.nonzero((pick < 0.15) & (np.arange(s) > 0))
    level[rows] = level[rows[0], prev[rows]]
    qq = rng.integers(0, q, (m, s))
    rows = np.nonzero((pick >= 0.3) & (pick < 0.5) &
                      (np.take_along_axis(q_from, qq, 1) >= 0))
    src[rows] = q_from[rows[0], qq[rows]]
    level[rows] = q_lvl[rows[0], qq[rows]]
    valid = rng.random((m, s)) < 0.6
    got = rng.random((m, m)) < 1 / 3
    same = src[:, :, None] == src[:, None, :]
    later = np.triu(np.ones((s, s), bool), 1)[None]
    earlier = np.tril(np.ones((s, s), bool), -1)[None]
    dup = (same & (level[:, :, None] == level[:, None, :]) &
           valid[:, None, :] & later).any(2)
    agg_ok = valid & ~dup
    sup = ((q_from[:, :, None] == src[:, None, :]) &
           (q_lvl[:, :, None] == level[:, None, :]) &
           ~q_indiv[:, :, None] & agg_ok[:, None, :]).any(2)
    ex_keep = (q_from >= 0) & ~sup
    dup_ind = (same & valid[:, None, :] & earlier).any(2)
    ind_ok = valid & ~dup_ind & ~np.take_along_axis(got, src, 1)

    def i32(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def b(a):
        return torch.tensor(a, device=dev)

    def bits(*shape):
        return torch.tensor(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32), device=dev)
    return [i32(q_from), i32(q_lvl), b(q_indiv), b(ex_keep), bits(m, q, w),
            i32(src), i32(level), b(agg_ok), b(ind_ok), bits(m, s, w)], levels


def gsf_merge_bytes(args, kern, levels):
    """Least bytes: every queue and inbox column read once, the sig rows
    kept from the queue or the inbox aggregates read (an individual's
    one-bit row is made from its sender id, already counted), the new
    columns, sig plane, got_add rows and kept counts written."""
    import torch
    q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok, ind_ok, \
        sig_all = args
    m, q, w = q_sig.shape
    s = src.shape[1]
    c = q + 2 * s
    # The kernel's keys (csrc/gsf_merge.cu), to know which rows it keeps.
    u_from = torch.cat([torch.where(ex_keep, q_from, -1),
                        torch.where(agg_ok, src, -1),
                        torch.where(ind_ok, src, -1)], 1)
    u_lvl = torch.cat([q_lvl, level, level], 1)
    pos = torch.arange(c, device=q_from.device)[None, :]
    tier = torch.where(pos >= q + s, 2, torch.where(
        torch.cat([q_indiv, torch.zeros_like(agg_ok),
                   torch.ones_like(ind_ok)], 1), 0, 1))
    key = torch.where(u_from >= 0, (tier * (levels + 1) + torch.where(
        tier == 1, u_lvl, 0)) * c + pos, 0x7FFFFF00 + pos)
    order = torch.sort(key, 1).indices[:, :q]
    rows_read = int((order < q + s).sum())
    cols_in = sum(t.numel() * t.element_size()
                  for i, t in enumerate(args) if i not in (4, 9))
    cols_out = sum(t.numel() * t.element_size()
                   for i, t in enumerate(kern) if i != 3)
    return cols_in + cols_out + 4 * w * (rows_read + m * q)


def phase_gsf_merge(dev, rng):
    import torch
    from wittgenstein_tpu_torch.ops.gsf_merge import gsf_merge, \
        gsf_merge_plain
    args, levels = gsf_merge_case(dev, rng)
    plain = gsf_merge_plain(*args, levels)
    kern = gsf_merge(*args, levels)
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"gsf_merge kernel differs from its plain version (max err "
             f"{err})")
    return dict(err=err, ms=device_ms(lambda: gsf_merge(*args, levels),
                                      "gsf_merge_kernel", cold()),
                warm_ms=device_ms(lambda: gsf_merge(*args, levels),
                                  "gsf_merge_kernel"),
                plain_ms=device_ms(lambda: gsf_merge_plain(*args, levels)),
                call_ms=call_ms(lambda: gsf_merge(*args, levels)),
                plain_call_ms=call_ms(lambda: gsf_merge_plain(*args,
                                                              levels)),
                nbytes=gsf_merge_bytes(args, kern, levels),
                admitted_individuals=int((kern[4] != 0).sum()))


def phase_gsf_score(dev, rng):
    import numpy as np
    import torch
    from wittgenstein_tpu_torch.ops.score import gsf_score, gsf_score_plain
    m, q, w = GSF_NODES, 16, GSF_NODES // 32

    def bits(*shape):
        return torch.tensor(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32), device=dev)
    args = [bits(m, q, w),
            torch.tensor(rng.integers(0, 13, (m, q)), dtype=torch.int32,
                         device=dev),
            torch.arange(m, dtype=torch.int32, device=dev),
            bits(m, w), bits(m, w)]
    plain = gsf_score_plain(*args)
    kern = gsf_score(*args)
    torch.cuda.synchronize()
    err = max_abs_err(plain, kern)
    if err or not all(torch.equal(a, b) for a, b in zip(plain, kern)):
        fail(f"gsf_score kernel differs from its plain version (max err "
             f"{err})")
    # Inputs: sig plane, levels, ids, two rows; outputs: four int32 and
    # two bool [M, Q].
    nbytes = 4 * (m * q * w + m * q + m + 2 * m * w + 4 * m * q) + 2 * m * q
    # The wrapper launches one kernel: timed by its name, as the others,
    # so the flush's own spread is never subtracted.
    return dict(err=err, ms=device_ms(lambda: gsf_score(*args),
                                      "gsf_score_kernel", cold()),
                warm_ms=device_ms(lambda: gsf_score(*args),
                                  "gsf_score_kernel"),
                plain_ms=device_ms(lambda: gsf_score_plain(*args)),
                call_ms=call_ms(lambda: gsf_score(*args)),
                plain_call_ms=call_ms(lambda: gsf_score_plain(*args)),
                nbytes=nbytes)


#: kernel entries of the ``kernels`` line: (name, wrapper key, path,
#: source, TPU kernel it replaces, phase-2 case)
KERNELS = [
    ("route", "route", "handel", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route),
    ("merge", "merge", "handel", "wittgenstein_tpu_torch/csrc/merge.cu",
     "wittgenstein_tpu/ops/pallas_merge.py:55", phase_merge),
    ("score", "score", "handel", "wittgenstein_tpu_torch/csrc/score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:46", phase_score),
    ("route_gsf", "route", "gsf", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route_gsf),
    ("gsf_merge", "gsf_merge", "gsf",
     "wittgenstein_tpu_torch/csrc/gsf_merge.cu",
     "wittgenstein_tpu/ops/pallas_gsf_merge.py:51", phase_gsf_merge),
    ("gsf_score", "gsf_score", "gsf",
     "wittgenstein_tpu_torch/csrc/gsf_score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:94", phase_gsf_score),
]
#: the wrappers each path must launch once per simulated ms
PATH_KERNELS = {"handel": ("route", "merge", "score"),
                "gsf": ("route", "gsf_merge", "gsf_score")}


# ------------------------------------------------------------- main path


def counters():
    from wittgenstein_tpu_torch.ops.gsf_merge import gsf_merge
    from wittgenstein_tpu_torch.ops.merge import merge_queue
    from wittgenstein_tpu_torch.ops.route import bin_into_ring
    from wittgenstein_tpu_torch.ops.score import gsf_score, score_queue
    return {"route": bin_into_ring, "merge": merge_queue,
            "score": score_queue, "gsf_merge": gsf_merge,
            "gsf_score": gsf_score}


def drive(proto, ms):
    """Run `proto` from seed 0 for `ms` ms through `Runner.run_ms`, every
    launch counter set to 0 just before.  Returns the run's numbers,
    the launch counts and the final state as numpy dicts."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    net, ps = proto.init(0)
    runner = Runner(proto)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    net, ps = runner.run_ms(net, ps, ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    down = net.nodes.down
    frac = float((net.nodes.done_at[~down] > 0).float().mean())
    res = dict(wall_s=wall, sim_ms_per_s=ms / wall, frac_done=frac,
               dropped=int(net.dropped), clamped=int(net.clamped),
               bc_dropped=int(net.bc_dropped), evicted=int(ps.evicted),
               time=int(net.time),
               msg_sent=int(net.nodes.msg_sent.sum()),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    return res, launches, convert.to_numpy(net, ps)


def check_launches(path, launches, ms):
    """Each kernel of the path launched once per simulated ms, the
    others not at all."""
    for name, count in launches.items():
        want = ms if name in PATH_KERNELS[path] else 0
        if count != want:
            fail(f"{path} path: kernel {name} launched {count} times in "
                 f"{ms} ms, want {want}")


def main_path(dev):
    """1000 ms of the reference-default Handel, seed 0, through the
    entry points a user calls."""
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    return drive(Handel(**reference_default_params(N_NODES), device=dev),
                 MAIN_MS)


def gsf_path(dev):
    """600 ms of `GSFSignature(node_count=4096)` with its defaults, seed
    0, through the entry points a user calls."""
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    return drive(GSFSignature(node_count=GSF_NODES, device=dev), GSF_MS)


def golden_and_determinism(dev, final_np):
    """Seed 0 again: the state at 200 ms against the JAX golden digest,
    then at 1000 ms against the first run."""
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    path = os.path.join("wittgenstein_tpu_torch", "data",
                        "golden_handel2048_200ms.json")
    with open(path) as f:
        golden = json.load(f)
    if golden["ms"] != GOLDEN_MS:
        fail(f"golden file is for {golden['ms']} ms, not {GOLDEN_MS}")
    proto = Handel(**reference_default_params(N_NODES), device=dev)
    runner = Runner(proto)
    net, ps = runner.run_ms(*proto.init(0), GOLDEN_MS)
    got = convert.state_digest(*convert.to_numpy(net, ps))
    want = golden["leaves"]
    bad = sorted(k for k in set(got) | set(want)
                 if got.get(k) != want.get(k))
    if bad:
        fail(f"state at {GOLDEN_MS} ms differs from the JAX golden in "
             f"{len(bad)} leaves, first {bad[:5]}")
    log(f"golden: all {len(want)} leaves match the JAX reference at "
        f"{GOLDEN_MS} ms")
    net, ps = runner.run_ms(net, ps, MAIN_MS - GOLDEN_MS)
    net_np, ps_np = convert.to_numpy(net, ps)
    again = convert.flatten({"net": net_np, "pstate": ps_np})
    first = convert.flatten({"net": final_np[0], "pstate": final_np[1]})
    diff = convert.first_difference(first, again)
    if diff is not None:
        fail(f"seed 0 run twice differs at {diff[0]} index {diff[1]}")
    log(f"determinism: two runs of seed 0 identical at {MAIN_MS} ms")


def gsf_golden_and_determinism(dev, final_np):
    """Seed 0 again: the GSF state at 600 ms against the JAX golden
    digest and against the first run."""
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.gsf import GSFSignature
    with open(GSF_GOLDEN) as f:
        golden = json.load(f)
    if golden["ms"] != GSF_MS:
        fail(f"GSF golden file is for {golden['ms']} ms, not {GSF_MS}")
    proto = GSFSignature(node_count=GSF_NODES, device=dev)
    net, ps = Runner(proto).run_ms(*proto.init(0), GSF_MS)
    net_np, ps_np = convert.to_numpy(net, ps)
    got = convert.state_digest(net_np, ps_np)
    want = golden["leaves"]
    bad = sorted(k for k in set(got) | set(want)
                 if got.get(k) != want.get(k))
    if bad:
        fail(f"GSF state at {GSF_MS} ms differs from the JAX golden in "
             f"{len(bad)} leaves, first {bad[:5]}")
    log(f"GSF golden: all {len(want)} leaves match the JAX reference at "
        f"{GSF_MS} ms (JAX counts {golden['counts']})")
    again = convert.flatten({"net": net_np, "pstate": ps_np})
    first = convert.flatten({"net": final_np[0], "pstate": final_np[1]})
    diff = convert.first_difference(first, again)
    if diff is not None:
        fail(f"GSF seed 0 run twice differs at {diff[0]} index {diff[1]}")
    log(f"GSF determinism: two runs of seed 0 identical at {GSF_MS} ms")


#: kernel names (substrings of the profiler's keys) whose device time
#: a simulated ms `--profile` reports for each path
PROFILE_KERNELS = {
    "handel": {"route": "route_", "merge": "merge_kernel",
               "score": "score_kernel"},
    "gsf": {"route": "route_", "gsf_merge": "gsf_merge_kernel",
            "gsf_score": "gsf_score_kernel"}}


def profile(proto, start, ms, path, kernels):
    """torch.profiler over `ms` simulated ms of `proto` from t = `start`;
    the table goes to `path`.  Returns the device-busy share, the
    PyTorch ops a simulated ms and the device us a simulated ms of each
    of `kernels` (name -> substring of its kernels' names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from wittgenstein_tpu_torch.core.network import Runner
    runner = Runner(proto)
    net, ps = runner.run_ms(*proto.init(0), start)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_ms(net, ps, ms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = kernel_device_us(ka)
    # PyTorch ops the step issued: top-level aten calls, not the ones
    # they make inside (a cast's copy, a where's broadcast).
    ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
              and e.cpu_parent is None and e.name.startswith("aten::"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{type(proto).__name__} {proto.node_count} nodes: {ms} "
                f"simulated ms from t={start}, wall {wall:.6f} s, device "
                f"time {dev_us / 1e6:.6f} s, aten ops {ops}\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    busy = dev_us / 1e6 / wall
    per_ms = {k: kernel_device_us(ka, match) / ms
              for k, match in kernels.items()}
    log(f"profile {type(proto).__name__}: {ms} ms from t={start}, wall "
        f"{wall:.6f} s, device busy {dev_us / 1e6:.6f} s "
        f"({100 * busy:.1f}%), {ops / ms:.0f} aten ops a simulated ms, "
        f"device {dev_us / ms:.2f} us a simulated ms, of which kernels "
        f"(us) {json.dumps(per_ms)}")
    return dict(wall_s=wall, device_s=dev_us / 1e6, busy=busy,
                aten_ops_per_ms=ops / ms, device_us_per_ms=dev_us / ms,
                kernel_us_per_ms=per_ms)


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="MS")
    ap.add_argument("--profile-file", default="profile.txt")
    ap.add_argument("--profile-gsf-file", default="profile_gsf.txt")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    try:
        from wittgenstein_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port package ({e}); run from the root of "
             "a checkout")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_build.BUILD_INFO.get('seconds', 0.0):.1f} s), "
        f"{_build.BUILD_INFO['lib']}")
    for src, report in sorted(_build.BUILD_INFO.get("ptxas", {}).items()):
        for line in report.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                log(f"ptxas {src}: {line.strip()}")

    # 2. kernels against their plain versions
    rng = np.random.default_rng(0)
    results = {}
    for name, _, _, _, _, phase in KERNELS:
        results[name] = phase(dev, rng)
        r = results[name]
        log(f"kernel {name}: bit-equal to its plain version; device "
            f"{r['ms'] * 1e3:.2f} us cold, {r['warm_ms'] * 1e3:.2f} us warm"
            f" vs plain {r['plain_ms'] * 1e3:.2f} us;"
            f" per call {r['call_ms'] * 1e3:.2f} us vs plain "
            f"{r['plain_call_ms'] * 1e3:.2f} us"
            + (f"; phases {r['phases_us']}" if "phases_us" in r else ""))

    # 3. the Handel path
    res, launches, final_np = main_path(dev)
    log(f"Handel path: {json.dumps(res)} launches {launches}")
    if not res["frac_done"] > 0.99:
        fail(f"Handel did not converge: live frac_done {res['frac_done']}")
    if res["dropped"] or res["clamped"] or res["bc_dropped"] or \
            res["evicted"]:
        fail(f"drops/clamps/evictions must be 0: {res}")
    check_launches("handel", launches, MAIN_MS)

    # 3b. the GSF path
    gres, glaunches, gfinal_np = gsf_path(dev)
    log(f"GSF path: {json.dumps(gres)} launches {glaunches}")
    if not gres["frac_done"] > 0.99:
        fail(f"GSF did not converge: live frac_done {gres['frac_done']}")
    if gres["dropped"] or gres["clamped"] or gres["bc_dropped"]:
        fail(f"GSF drops/clamps must be 0: {gres}")
    check_launches("gsf", glaunches, GSF_MS)

    # 4. against the reference
    golden_and_determinism(dev, final_np)
    gsf_golden_and_determinism(dev, gfinal_np)
    profiles = {}
    if args.profile:
        from wittgenstein_tpu_torch.models.gsf import GSFSignature
        from wittgenstein_tpu_torch.models.handel import (
            Handel, reference_default_params)
        profiles["handel"] = profile(
            Handel(**reference_default_params(N_NODES), device=dev), 600,
            args.profile, args.profile_file, PROFILE_KERNELS["handel"])
        profiles["gsf"] = profile(
            GSFSignature(node_count=GSF_NODES, device=dev), 300,
            args.profile, args.profile_gsf_file, PROFILE_KERNELS["gsf"])

    path_ms = {"handel": MAIN_MS, "gsf": GSF_MS}
    path_launches = {"handel": launches, "gsf": glaunches}
    kernels = []
    for name, key, path, source, replaces, _ in KERNELS:
        r = results[name]
        bound_ms = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        n_launch = path_launches[path][key]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launch,
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
               "bound_by": "bytes", "library_ms": None, "path": path,
               "launches_by_path": {p: path_launches[p][key]
                                    for p in path_launches},
               "launches_per_ms": n_launch / path_ms[path],
               "kernel_us": r["ms"] * 1e3,
               "kernel_us_warm": r["warm_ms"] * 1e3,
               "plain_us": r["plain_ms"] * 1e3,
               "bound_us": bound_ms * 1e3, "library_us": None,
               "bytes": r["nbytes"], "call_ms": r["call_ms"],
               "plain_call_ms": r["plain_call_ms"]}
        if "phases_us" in r:
            rec["phases_us"] = r["phases_us"]
        print(json.dumps(rec), flush=True)
        kernels.append(rec)
    print(json.dumps({"kernels": kernels, "main_path": res,
                      "gsf_path": gres, "profiles": profiles}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
