"""wittgenstein_tpu_torch — the PyTorch/CUDA port of `wittgenstein_tpu`.

A second package beside the JAX one, held bit for bit against it.  It
keeps the JAX package's module layout (`ops/`, `core/`, `models/`,
`obs/`, `chaos/`, `memo/`, `serve/`, `server/`, `matrix/`, `scenarios/`,
`tools/`, `utils/`) so each function's counterpart is found under the
same name,
and runs on one NVIDIA Hopper card: the TPU's Pallas kernels become
hand-written CUDA C++ under `csrc/`, built at first use by
`ops/_build.py`.

Entry points (`models.handel.Handel(..., device=...)`,
`models.gsf.GSFSignature(..., device=...)`,
`models.pingpong.PingPong(..., device=...)`, their `init`,
`core.network.Runner`, the seed-folded `core.batched.scan_chunk_batched`
and `core.harness.run_multiple_times`, the drivers of `scenarios/`) run
on ``cuda`` unless the caller passes ``device="cpu"``; with no card the
default raises instead of falling back to the CPU.  On CPU tensors every kernel wrapper runs its
plain PyTorch version.
"""
