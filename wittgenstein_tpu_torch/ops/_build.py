"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
(one process per source, all started together), linked into one shared
library with a plain C interface, and loaded with `ctypes`.  The build
happens at the first kernel launch, into ``build/`` inside the package
(listed in `.gitignore`); the library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import: the CPU tests import every
module of the package on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
#: C signature of every kernel entry point: name -> argtypes (each
#: returns the launch's cudaError_t as an int, unless RESTYPES says
#: otherwise)
SIGNATURES = {
    # arrival, dest, valid, msrc, msize, payload, data, src, size, count,
    # dropped, scratch, R, M, F, H, N, C, stream
    "wtpu_route": [P] * 12 + [I] * 6 + [P],
    # R, M, F, H, N -> int32 elements of scratch wtpu_route needs
    "wtpu_route_scratch": [I] * 5,
    # q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank, ok, sig_all,
    # o_from, o_lvl, o_rank, o_bad, o_sig, o_evicted, M, Q, S, W,
    # seed_rows, stream
    "wtpu_merge": [P] * 16 + [I] * 5 + [P],
    # q_sig, q_lvl, ids, total_inc, ver_ind, last_agg, s_inc, pc_sig,
    # pc_sv, inter_agg (bool), M, Q, W, stream
    "wtpu_score": [P] * 10 + [I] * 3 + [P],
    # q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok, ind_ok,
    # sig_all, o_from, o_lvl, o_indiv, o_sig, o_got, o_kept, M, Q, S, W,
    # L, stream
    "wtpu_gsf_merge": [P] * 16 + [I] * 5 + [P],
    # q_sig, q_lvl, ids, verified, ver_indiv, ver_l_card, card_sig, inter,
    # pc_wi, pc_wv, inter_ind, M, Q, W, stream
    "wtpu_gsf_score": [P] * 11 + [I] * 3 + [P],
    # the launchers' dynamic shared memory in bytes (csrc `launch_smem`):
    # M, H, N, part (0 bucket kernel, 1 rank kernel, 2 tables in smem)
    "wtpu_route_smem": [I] * 4,
    "wtpu_merge_smem": [I] * 2,         # Q, S
    "wtpu_score_smem": [I] * 2,         # Q, W
    "wtpu_gsf_merge_smem": [I],         # W
    "wtpu_gsf_score_smem": [I] * 2,     # Q, W (16-byte aligned rows)
}

#: entry points that return something else than an error code
RESTYPES = {name: ctypes.c_longlong for name in SIGNATURES
            if name.endswith(("_scratch", "_smem"))}

#: shared memory a block may opt in to on sm_90 (H100): 227 KB
SMEM_OPTIN = 227 * 1024


def check_smem(kernel: str, nbytes: int) -> None:
    """Refuse, before the launch, a shape whose dynamic shared memory
    (the kernel's Python model, `ops/<kernel>.smem_bytes`) does not fit
    a block's opt-in limit: the launch would fail on the card."""
    if nbytes > SMEM_OPTIN:
        raise ValueError(f"{kernel}: these shapes need {nbytes} bytes of "
                         f"shared memory a block, over the {SMEM_OPTIN}-"
                         "byte opt-in limit of sm_90")

_lock = threading.Lock()
_lib = None
#: what the last build did: seconds, per-source ptxas report, library
#: path (read by chip_smoke.py)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return cand


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile every ``csrc/*.cu`` into one library (if not already
    built from these exact sources) and return its path."""
    sources = _sources()
    lib_path = os.path.join(BUILD, f"libwtpu_kernels_{_digest(sources)}.so")
    if os.path.exists(lib_path):
        BUILD_INFO.setdefault("lib", lib_path)
        return lib_path
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in sources:
        obj = os.path.join(BUILD, os.path.basename(src)[:-3] +
                           f".{os.getpid()}.o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, objs, failed = {}, [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        reports[os.path.basename(src)] = out
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{out}")
        objs.append(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", *objs, "-o", tmp,
                           "-gencode", "arch=compute_90a,code=sm_90a"],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    BUILD_INFO.update(seconds=time.time() - t0, ptxas=reports, lib=lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    """The current CUDA stream of tensor `t`'s device, as an int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
