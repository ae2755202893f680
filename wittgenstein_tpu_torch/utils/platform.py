"""The platform facts the port's ledger rows and `/w/batch/health`
report — the port's counterpart of `wittgenstein_tpu/utils/platform.py`,
redefined on the card.

The JAX module probes a TPU backend in a subprocess (`probe_backend`)
and forces a virtual CPU mesh for the tests (`force_virtual_cpu`).
Neither has a twin here: a CUDA device needs no probe (PyTorch answers
`torch.cuda.is_available()` without wedging anything), and the
multi-device mesh belongs to the port's multi-device plane (ROADMAP.md
A15).  What the port keeps is what a ledger row or an operator needs to
tell two runs' hardware apart: the backend of the device a run was
placed on, the device's name and count, and the card's power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints it (a card set below its maximum runs slower under load, so a
time without its limit cannot be compared with another).
"""

from __future__ import annotations

import functools
import subprocess

import torch


def backend(device=None) -> str:
    """``"cuda"`` or ``"cpu"``: the backend of `device` (a
    `torch.device`, a string, or None for the default, which is the
    card when there is one)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


@functools.lru_cache(maxsize=1)
def smi_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (the first card's line), or None where there is no `nvidia-smi` or
    it fails.  Read once a process."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip().splitlines()[0]


def device_facts(device=None) -> dict:
    """``{"backend", "device_name", "device_count", "power_limit"}`` of
    the device a run is placed on: on the CPU the name is ``"cpu"``,
    the count 1 and the power limit None; on a card its
    `torch.cuda.get_device_name`, `torch.cuda.device_count` and the
    power-limit field of `smi_line` (None where it cannot be read)."""
    be = backend(device)
    if be != "cuda":
        return {"backend": be, "device_name": be, "device_count": 1,
                "power_limit": None}
    line = smi_line()
    limit = line.rsplit(",", 1)[-1].strip() if line and "," in line \
        else None
    idx = torch.device(device).index if device is not None else None
    return {"backend": be,
            "device_name": torch.cuda.get_device_name(idx or 0),
            "device_count": torch.cuda.device_count(),
            "power_limit": limit}
