#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`wittgenstein_tpu_torch`) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. device and build: the card's name and power limit, then the CUDA
   kernels built from ``wittgenstein_tpu_torch/csrc`` with nvcc, with
   each kernel's registers and shared memory;
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (2048-node Handel): bit-equal outputs, and
   both timed with CUDA events;
3. the main path: the reference-default Handel (2048 nodes, 204 down)
   through `Runner.run_ms` for 1000 ms, launch counters reset just
   before; it must converge (live frac_done > 0.99) with zero drops,
   clamps and evictions, and launch every kernel once per simulated ms;
4. against the reference: a second run of seed 0 matches the JAX
   package's golden digest at 200 ms and the first run's final state
   at 1000 ms.

It prints one JSON line per kernel, the ``{"kernels": [...]}`` summary,
the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  ``--profile MS`` also profiles MS
simulated ms with `torch.profiler` and writes the table to
``--profile-file`` (default ``profile.txt``).
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
    total = run(True)
    if reset and match is None:
        total -= run(False)
    if total <= 0:
        fail(f"the profiler saw no device time for {match or 'the call'}")
    return total / ITERS / 1e3


def max_abs_err(plain, kern):
    err = 0
    for a, b in zip(plain, kern):
        d = (a.to("cpu").long() - b.to("cpu").long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---------------------------------------------------------- kernel cases


def route_case(dev, rng):
    """Main-path shapes: R 1, F 3, H 256, N 2048, C 12 and M = 2048 x 21
    messages; part-full and full cells, a few hot cells that overflow,
    invalid messages interleaved."""
    import numpy as np
    import torch
    r, f, hz, n, c = 1, 3, 256, N_NODES, 12
    m = n * 21
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


def phase_route(dev, rng):
    import torch
    from wittgenstein_tpu_torch.ops.route import bin_into_ring, \
        bin_into_ring_plain
    ring, msg = route_case(dev, rng)
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
    return dict(err=err, ms=device_ms(kern_fn, "route_kernel", reset),
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
    nbytes = 4 * (m * q * w + m * q + m + 3 * m * w + 4 * m * q)
    return dict(err=err, ms=device_ms(lambda: score_queue(*args),
                                      "score_kernel"),
                plain_ms=device_ms(lambda: score_queue_plain(*args)),
                call_ms=call_ms(lambda: score_queue(*args)),
                plain_call_ms=call_ms(lambda: score_queue_plain(*args)),
                nbytes=nbytes)


KERNELS = [
    ("route", "wittgenstein_tpu_torch/csrc/route.cu",
     "wittgenstein_tpu/ops/pallas_route.py:154", phase_route),
    ("merge", "wittgenstein_tpu_torch/csrc/merge.cu",
     "wittgenstein_tpu/ops/pallas_merge.py:55", phase_merge),
    ("score", "wittgenstein_tpu_torch/csrc/score.cu",
     "wittgenstein_tpu/ops/pallas_score.py:46", phase_score),
]


# ------------------------------------------------------------- main path


def counters():
    from wittgenstein_tpu_torch.ops.merge import merge_queue
    from wittgenstein_tpu_torch.ops.route import bin_into_ring
    from wittgenstein_tpu_torch.ops.score import score_queue
    return {"route": bin_into_ring, "merge": merge_queue,
            "score": score_queue}


def main_path(dev):
    """1000 ms of the reference-default Handel, seed 0, through the
    entry points a user calls.  Returns the run's numbers and launch
    counts, and its final state as numpy dicts."""
    import torch
    from wittgenstein_tpu_torch import convert
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    proto = Handel(**reference_default_params(N_NODES), device=dev)
    net, ps = proto.init(0)
    runner = Runner(proto)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    net, ps = runner.run_ms(net, ps, MAIN_MS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    down = net.nodes.down
    frac = float((net.nodes.done_at[~down] > 0).float().mean())
    res = dict(wall_s=wall, sim_ms_per_s=MAIN_MS / wall, frac_done=frac,
               dropped=int(net.dropped), clamped=int(net.clamped),
               bc_dropped=int(net.bc_dropped), evicted=int(ps.evicted),
               time=int(net.time), peak_mem_bytes=torch.cuda.
               max_memory_allocated())
    return res, launches, convert.to_numpy(net, ps)


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


def profile(dev, ms, path):
    """torch.profiler over `ms` simulated ms from t = 600 (the busiest
    stretch of the run); the table goes to `path`."""
    import torch
    from torch.profiler import ProfilerActivity
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models.handel import (
        Handel, reference_default_params)
    proto = Handel(**reference_default_params(N_NODES), device=dev)
    runner = Runner(proto)
    net, ps = runner.run_ms(*proto.init(0), 600)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_ms(net, ps, ms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = kernel_device_us(ka)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{ms} simulated ms from t=600, wall {wall:.6f} s, "
                f"device time {dev_us / 1e6:.6f} s\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    log(f"profile: {ms} ms wall {wall:.6f} s, device busy "
        f"{dev_us / 1e6:.6f} s ({100 * dev_us / 1e6 / wall:.1f}%)")


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="MS")
    ap.add_argument("--profile-file", default="profile.txt")
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
    for name, _, _, phase in KERNELS:
        results[name] = phase(dev, rng)
        r = results[name]
        log(f"kernel {name}: bit-equal to its plain version; device "
            f"{r['ms'] * 1e3:.2f} us vs plain {r['plain_ms'] * 1e3:.2f} us;"
            f" per call {r['call_ms'] * 1e3:.2f} us vs plain "
            f"{r['plain_call_ms'] * 1e3:.2f} us")

    # 3. main path
    res, launches, final_np = main_path(dev)
    log(f"main path: {json.dumps(res)} launches {launches}")
    if not res["frac_done"] > 0.99:
        fail(f"Handel did not converge: live frac_done {res['frac_done']}")
    if res["dropped"] or res["clamped"] or res["bc_dropped"] or \
            res["evicted"]:
        fail(f"drops/clamps/evictions must be 0: {res}")
    for name, count in launches.items():
        if count != MAIN_MS:
            fail(f"kernel {name} launched {count} times in {MAIN_MS} ms, "
                 "want one per simulated ms")

    # 4. against the reference
    golden_and_determinism(dev, final_np)
    if args.profile:
        profile(dev, args.profile, args.profile_file)

    kernels = []
    for name, source, replaces, _ in KERNELS:
        r = results[name]
        bound_ms = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
               "bound_by": "bytes", "library_ms": None,
               "launches_per_ms": launches[name] / MAIN_MS,
               "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
               "bound_us": bound_ms * 1e3, "library_us": None,
               "bytes": r["nbytes"], "call_ms": r["call_ms"],
               "plain_call_ms": r["plain_call_ms"]}
        print(json.dumps(rec), flush=True)
        kernels.append(rec)
    print(json.dumps({"kernels": kernels, "main_path": res}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
