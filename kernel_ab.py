#!/usr/bin/env python3
"""Time some of the port's kernels alone on one NVIDIA GPU, as
`chip_smoke.py`'s phase 2 does (bit-equal check against the plain
version first; device time cold, the L2 flushed before each call, and
warm), and print one JSON line.

It reuses `chip_smoke`'s phase functions, imported with
`wittgenstein_tpu_torch` from the current directory, so the same file
times two checkouts on one card in one call.  Unpack the parent into
the git-ignored `_parent/` (``git archive HEAD | tar -x -C _parent``)
and run, in turns::

    python3 kernel_ab.py --tag change merge score
    (cd _parent && python3 ../kernel_ab.py --tag parent merge score)

Kernels are named as in `chip_smoke.KERNELS` (route, merge, score,
route_gsf, gsf_merge, gsf_score).  ``--path MS`` also profiles windows
of MS simulated ms of the 2048-node Handel path, from each time given
with ``--at`` (600 by default, as `chip_smoke.py --profile`), and
reports for each window the merge and score kernels' device us a
simulated ms and where the merge's output rows came from.  ``--dirty`` times "cold" after a flush
that only writes, so the kernel pays for evicting dirty L2 lines.
"""

import argparse
import json
import os
import subprocess
import sys

_DIRTY = []


def dirty_flush():
    """Write a 96 MB buffer, twice the L2, and leave its last lines in
    the L2 unwritten: the next kernel pays for writing them back, as on
    the path, where the step's earlier ops leave the L2 dirty."""
    import torch
    if not _DIRTY:
        _DIRTY.append(torch.empty(96 << 20, dtype=torch.uint8,
                                  device="cuda"))
    _DIRTY[0].fill_(1)


def merge_rows(args, out):
    """Where one merge call's output rows came from: counts of queued
    rows that hold a sender, of output rows taken from them, from queued
    rows without a sender, from the inbox, and left in their own slot.
    Recomputes the merge's order (keys as in csrc/merge.cu) and checks
    it against the call's q_from output."""
    import torch
    q_from, q_lvl, q_rank, _, _, src, level, rank, ok, _ = args
    m, q = q_from.shape
    c = q + src.shape[1]
    same = ((src[:, :, None] == src[:, None, :]) &
            (level[:, :, None] == level[:, None, :]))
    later = torch.ones_like(same[0]).triu(1)
    keep_inc = ok & ~(same & later & ok[:, None, :]).any(2)
    hit = ((q_from[:, :, None] == src[:, None, :]) &
           (q_lvl[:, :, None] == level[:, None, :]) & keep_inc[:, None, :])
    ex_keep = (q_from >= 0) & ~hit.any(2)
    valid = torch.cat([ex_keep, keep_inc], 1)
    pos = torch.arange(c, device=q_from.device, dtype=torch.int64)
    key = torch.where(valid, torch.cat([q_rank, rank], 1).long() * (c + 1)
                      + pos, 0x7FFFFF00 + pos)
    order = key.argsort(1)[:, :q]
    cand = torch.cat([q_from, src], 1)
    want = torch.where(valid.gather(1, order), cand.gather(1, order), -1)
    from_q = order < q
    has = torch.cat([q_from >= 0, torch.zeros_like(ok)], 1).gather(1, order)
    return {"queued_with_sender": int((q_from >= 0).sum()),
            "out_from_queued_with_sender": int((from_q & has).sum()),
            "out_from_queued_empty": int((from_q & ~has).sum()),
            "out_from_inbox": int((~from_q).sum()),
            "out_same_slot": int((order == pos[:q]).sum()),
            "out_rows": m * q, "model_agrees": bool(torch.equal(want,
                                                               out[0]))}


def path_profile(dev, ms, starts):
    """For each window of `ms` simulated ms of Handel 2048 from a time in
    `starts`: the merge and score kernels' device us a simulated ms, and
    the merge's row sources summed over the window's calls."""
    import torch
    import chip_smoke
    from torch.profiler import ProfilerActivity
    from wittgenstein_tpu_torch.core.network import Runner
    from wittgenstein_tpu_torch.models import handel
    proto = handel.Handel(**handel.reference_default_params(
        chip_smoke.N_NODES), device=dev)
    runner = Runner(proto)
    net, ps = proto.init(0)
    merge = handel.merge_queue
    windows = []
    for start in sorted(starts):
        net, ps = runner.run_ms(net, ps, start - int(net.time))
        calls = []

        def keep(*args):                   # holds tensors, issues no op
            out = merge(*args)
            calls.append((args, out))
            return out
        handel.merge_queue = keep
        torch.cuda.synchronize()
        try:
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                net, ps = runner.run_ms(net, ps, ms)
                torch.cuda.synchronize()
        finally:
            handel.merge_queue = merge
        ka = prof.key_averages()
        rows = {}
        for args, out in calls:
            for k, v in merge_rows(args, out).items():
                rows[k] = rows.get(k, 0) + v if k != "model_agrees" else \
                    rows.get(k, True) and v
        windows.append({
            "start": start, "ms": ms, "merge_rows": rows,
            "us_per_ms": {k: chip_smoke.kernel_device_us(ka, match) / ms
                          for k, match in (("merge", "merge_kernel"),
                                           ("score", "score_kernel"))}})
    return windows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*")
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    ap.add_argument("--path", type=int, default=0, metavar="MS")
    ap.add_argument("--at", type=int, nargs="+", default=[600])
    ap.add_argument("--dirty", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    if args.dirty:
        chip_smoke.l2_flush = dirty_flush
    phases = {k[0]: k[-1] for k in chip_smoke.KERNELS}
    dev = torch.device("cuda")
    out = {}
    for name in args.kernels:
        r = phases[name](dev, np.random.default_rng(0))
        out[name] = {"cold_us": r["ms"] * 1e3, "warm_us": r["warm_ms"] * 1e3,
                     "bound_us": r["nbytes"] /
                     chip_smoke.HBM_BYTES_PER_S * 1e6,
                     "max_abs_err": r["err"]}
    path = path_profile(dev, args.path, args.at) if args.path else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "device": smi, "dirty": args.dirty,
                      "kernels": out, "path": path}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
