"""The op recorder: the "program" the port's program rules walk — the
port's counterpart of `wittgenstein_tpu/analysis/hlo.py`.

The JAX package's rules read the compiled XLA program of a chunk.  The
port's chunk is an eager Python loop over PyTorch ops, so its program is
the stream of ops it dispatches: `OpRecorder` is a `TorchDispatchMode`
that records every op a chunk dispatches, with its output shapes,
dtypes and bytes, and marks

  * host reads: an item (``aten::_local_scalar_dense``: ``int(t)``,
    ``bool(t)``, indexing with a 0-d tensor), ``aten::nonzero``, the
    ops whose output shape depends on the data (``masked_select``,
    ``unique``, ``repeat_interleave`` without ``output_size``, indexing
    with a bool mask), device-to-host copies, and ``Tensor.tolist`` /
    ``Tensor.numpy`` (which on a CPU tensor dispatch nothing, so the
    recorder wraps them while it is active) — counted only where the
    tensor read lies on the recorder's device, so the same chunk gives
    the same count on the CPU and on a card;
  * host-to-device copies, which on a card synchronise as a read does:
    a blocking copy from host memory, host data made a tensor on the
    recorder's device by ``torch.tensor`` / ``torch.as_tensor``
    (``aten::lift_fresh``: the copy itself dispatches nothing), and,
    on a card, an op given a host tensor of one or more dimensions
    beside device tensors (an index built from a Python list), which
    the op copies to the card inside its own implementation;
  * the kernels as single ops: ``wtpu::route`` (K1), and the custom ops
    ``wtpu::merge_queue``, ``wtpu::score_queue``, ``wtpu::gsf_merge``
    and ``wtpu::gsf_score`` (K2-K5).  Under `torch.func.vmap` a custom
    op's vmap rule calls the wrapper's body directly, and K1's wrapper
    is a plain Python function, so the recorder also wraps each plain
    version (on the CPU) and the kernel library's launch entries (on a
    card) for as long as it is active: either records the kernel once
    and hides what runs inside it.

A recording is made on the CPU as the JAX package compiles its
programs on the CPU: the rules' budgets are measured there.  What
differs on a card is the allocations and argument copies of the kernel
wrappers (op counts, copy bytes) and the host-to-device copies;
``README.md`` lists it.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: kernel-library launch entries -> the op name a kernel is recorded as
KERNEL_ENTRIES = {"wtpu_route": "wtpu::route",
                  "wtpu_merge": "wtpu::merge_queue",
                  "wtpu_score": "wtpu::score_queue",
                  "wtpu_gsf_merge": "wtpu::gsf_merge",
                  "wtpu_gsf_score": "wtpu::gsf_score"}

#: the plain versions run in place of a kernel on the CPU:
#: (module under ops/, function) -> recorded op name
PLAIN_VERSIONS = {("route", "bin_into_ring_plain"): "wtpu::route",
                  ("merge", "merge_queue_plain"): "wtpu::merge_queue",
                  ("score", "score_queue_plain"): "wtpu::score_queue",
                  ("score", "gsf_score_plain"): "wtpu::gsf_score",
                  ("gsf_merge", "gsf_merge_plain"): "wtpu::gsf_merge"}

_DATA_DEPENDENT = ("aten::masked_select", "aten::unique", "aten::_unique",
                   "aten::_unique2", "aten::unique_dim",
                   "aten::unique_consecutive")
_INDEX_OPS = ("aten::index", "aten::index_put_", "aten::index_put",
              "aten::_index_put_impl_")
_COPY_OPS = ("aten::_to_copy", "aten::copy_", "aten::_copy_from",
             "aten::_copy_from_and_resize")

_LIFT_OPS = ("aten::lift_fresh", "aten::lift_fresh_copy")

_CLASSIFIED = frozenset(("aten::_local_scalar_dense", "aten::nonzero",
                         "aten::repeat_interleave") + _DATA_DEPENDENT +
                        _INDEX_OPS + _COPY_OPS + _LIFT_OPS)
_DTYPE_NAMES = {dt: str(dt).replace("torch.", "") for dt in (
    torch.int32, torch.int64, torch.bool, torch.float32, torch.float64,
    torch.int8, torch.uint8, torch.int16)}

_PKG_ROOT = __file__.rsplit("/analysis/", 1)[0] + "/"


@functools.lru_cache(maxsize=None)
def _names(func):
    """(name, name without its overload) of a dispatched op."""
    name = func.name()
    return name, name.split(".")[0]


@dataclasses.dataclass
class OpRecord:
    """One dispatched op: its name (``aten::add.Tensor``, ``wtpu::route``),
    output shapes and dtypes, the bytes its outputs hold, and what it
    costs the host: ``read`` names a host read ("item", "nonzero",
    "data-dependent", "mask-index", "d2h", "tolist", "numpy"),
    ``h2d`` marks a blocking host-to-device copy.  ``site`` is the
    innermost port frame (package-relative path and function) that
    dispatched it, kept for host reads, uploads and 64-bit float
    outputs only."""

    name: str
    shapes: tuple
    dtypes: tuple
    nbytes: int
    read: str | None = None
    h2d: bool = False
    site: str | None = None

    @property
    def base(self) -> str:
        """The op's name without its overload (``aten::add``)."""
        return self.name.split(".")[0]

    @property
    def kernel(self) -> bool:
        return self.name.startswith("wtpu::")


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _port_site() -> str | None:
    """``relpath::function`` of the innermost frame in the port package
    outside this module (package-relative path)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG_ROOT) and "/analysis/" not in path:
            return f"{path[len(_PKG_ROOT):]}::{f.f_code.co_name}"
        f = f.f_back
    return None


class OpRecorder(TorchDispatchMode):
    """Records the ops dispatched while it is active (see the module
    docstring).  ``device`` is the device the recorded chunk runs on:
    host reads count only on tensors that lie there.  While active it
    wraps `Tensor.tolist`/`numpy`, the plain versions and the kernel
    library for the whole process (restored on exit): record one chunk
    at a time, with no other thread launching work."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.ops: list[OpRecord] = []
        self._paused = 0        # inside a kernel's plain version / launch
        self._in_kernel = 0     # inside a dispatched wtpu:: custom op
        self._saved = []

    # ---------------------------------------------------------- queries
    @property
    def host_reads(self) -> list[OpRecord]:
        return [op for op in self.ops if op.read]

    @property
    def h2d_copies(self) -> list[OpRecord]:
        return [op for op in self.ops if op.h2d]

    @property
    def syncs(self) -> int:
        """The ops that make the host wait for the card: host reads and
        blocking host-to-device copies."""
        return len(self.host_reads) + len(self.h2d_copies)

    def kernel_launches(self) -> dict:
        out: dict = {}
        for op in self.ops:
            if op.kernel:
                out[op.name] = out.get(op.name, 0) + 1
        return out

    # ---------------------------------------------------------- records
    def _record(self, name, out, read=None, h2d=False):
        ts = (out,) if isinstance(out, torch.Tensor) else _tensors(out)
        dtypes = tuple(_DTYPE_NAMES.get(t.dtype) or
                       str(t.dtype).replace("torch.", "") for t in ts)
        site = _port_site() if (read or h2d or "float64" in dtypes) \
            else None
        self.ops.append(OpRecord(
            name=name, shapes=tuple(tuple(t.shape) for t in ts),
            dtypes=dtypes,
            nbytes=sum(t.numel() * t.element_size() for t in ts),
            read=read, h2d=h2d, site=site))

    def _on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and \
            t.device.type == self.device_type

    def _classify(self, base, args, kwargs, out):
        """(read, h2d) of one dispatched aten op."""
        first = args[0] if args else None
        if base == "aten::_local_scalar_dense" or base == "aten::nonzero":
            return (("item" if "scalar" in base else "nonzero")
                    if self._on_device(first) else None), False
        if base in _LIFT_OPS:
            return None, self._on_device(out)
        if base in _DATA_DEPENDENT:
            return ("data-dependent" if self._on_device(first) else None,
                    False)
        if base == "aten::repeat_interleave":
            sized = kwargs.get("output_size") is not None or \
                len(args) > 3 and args[3] is not None
            return (None if sized or not self._on_device(first)
                    else "data-dependent"), False
        if base in _INDEX_OPS:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(i, torch.Tensor) and
                   i.dtype in (torch.bool, torch.uint8) for i in idx or ()) \
                    and self._on_device(first):
                return "mask-index", False
            return None, False
        if base in _COPY_OPS:
            if base == "aten::_to_copy":
                src, dst = first, out
            else:
                dst, src = first, args[1] if len(args) > 1 else None
            if not (isinstance(src, torch.Tensor) and
                    isinstance(dst, torch.Tensor)):
                return None, False
            s, d = src.device.type, dst.device.type
            if s == d:
                return None, False
            blocking = not kwargs.get("non_blocking", False)
            if s == self.device_type and d == "cpu":
                return "d2h", False
            if s == "cpu" and d == self.device_type and blocking:
                return None, True
        return None, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        name, base = _names(func)
        if base.startswith("wtpu::"):
            self._in_kernel += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self._in_kernel -= 1
            self._record(name, out)
            return out
        out = func(*args, **kwargs)
        read, h2d = (self._classify(base, args, kwargs, out)
                     if base in _CLASSIFIED else (None, False))
        if not (read or h2d) and self.device_type != "cpu":
            h2d = self._implicit_upload(args, kwargs)
        self._record(name, out, read=read, h2d=h2d)
        return out

    def _implicit_upload(self, args, kwargs) -> bool:
        """Whether a device op was given a host tensor that is not a
        0-d scalar: the op copies it to the card itself."""
        host = dev = False
        for a in (*args, *kwargs.values()):
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor):
                    if t.device.type == "cpu":
                        host = host or t.dim() > 0
                    else:
                        dev = True
        return host and dev

    # ---------------------------------------------- wrapped host reads
    def _wrap_read(self, kind, orig):
        rec = self

        def read(t, *a, **kw):
            if rec._paused or rec._in_kernel or not rec._on_device(t):
                return orig(t, *a, **kw)
            rec._paused += 1
            try:
                out = orig(t, *a, **kw)
            finally:
                rec._paused -= 1
            rec.ops.append(OpRecord(
                name=f"Tensor.{kind}", shapes=(tuple(t.shape),),
                dtypes=(str(t.dtype).replace("torch.", ""),),
                nbytes=t.numel() * t.element_size(), read=kind,
                site=_port_site()))
            return out
        return read

    def _wrap_kernel(self, op_name, orig):
        rec = self

        def kernel(*a, **kw):
            if rec._paused or rec._in_kernel:
                return orig(*a, **kw)
            rec._paused += 1
            try:
                out = orig(*a, **kw)
            finally:
                rec._paused -= 1
            rec._record(op_name, out if not isinstance(out, int) else ())
            return out
        return kernel

    def _patch(self, owner, attr, new):
        had = attr in vars(owner)
        self._saved.append((owner, attr, getattr(owner, attr), had))
        setattr(owner, attr, new)

    def __enter__(self):
        from ..ops import _build, gsf_merge, merge, route, score
        mods = {"route": route, "merge": merge, "score": score,
                "gsf_merge": gsf_merge}
        for kind in ("tolist", "numpy"):
            self._patch(torch.Tensor, kind,
                        self._wrap_read(kind, getattr(torch.Tensor, kind)))
        for (mod, fn), op in PLAIN_VERSIONS.items():
            self._patch(mods[mod], fn,
                        self._wrap_kernel(op, getattr(mods[mod], fn)))
        lib_fn, rec = _build.lib, self

        class _Lib:
            """The kernel library with each launch entry recorded."""

            def __init__(self, lib):
                self._lib = lib

            def __getattr__(self, attr):
                fn = getattr(self._lib, attr)
                if attr in KERNEL_ENTRIES:
                    return rec._wrap_kernel(KERNEL_ENTRIES[attr], fn)
                return fn

        self._patch(_build, "lib", lambda: _Lib(lib_fn()))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            while self._saved:
                owner, attr, orig, had = self._saved.pop()
                if had:
                    setattr(owner, attr, orig)
                else:
                    delattr(owner, attr)


def record(fn, *args, device="cpu"):
    """``fn(*args)`` under an `OpRecorder`; returns (recorder, output)."""
    with OpRecorder(device) as rec:
        out = fn(*args)
    return rec, out


def host_reads(fn, device="cpu") -> int:
    """The host reads ``fn()`` makes."""
    rec, _ = record(fn, device=device)
    return len(rec.host_reads)
