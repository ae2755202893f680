"""Checkpoint / resume of simulation state — the port of
`wittgenstein_tpu/utils/checkpoint.py`, in the same file layout, so a
file either package writes loads in the other.

Format: one ``.npz`` holding ``leaf_{i}`` for every leaf of the state
pair ``(net, pstate)`` in the JAX package's flatten order (the fields
of its state dataclasses in declaration order, dict keys sorted, lists
in order), under the JAX dtypes (uint32 bitsets stay uint32; `convert`
maps the port's int32 bits to them), and ``__meta__``, a JSON object as
bytes.  Leaves that exist only in the port (the Arena's ancestor bitset
``anc``) are not stored: `load` rebuilds them, as `convert.
from_reference` does.  A resumed run is bit-identical to an
uninterrupted one: the fault state of the chaos plane is a function of
the time alone, so nothing beyond the pair is needed.

A seed batch's state is GBs (16 seeds of a 1,000-node PingPong hold a
6.4-GB ring), so the entries are written straight from each array's
memory (`_write_npz`, the `.npy` format `np.savez` writes), and stored
(uncompressed) entries are read in place (`_read_npz`: the archive
mapped or its in-memory buffer viewed, each entry's CRC checked, the
array a view of it) rather than copied through `np.load`.
"""

from __future__ import annotations

import io
import json
import mmap
import struct
import zipfile
import zlib

import numpy as np

from .. import convert


def _leaves(tree, sort: bool = False) -> list:
    """The leaves of a nested numpy state in JAX flatten order: the
    dicts `convert.to_numpy` makes of dataclasses keep their field
    order; a protocol state that is a plain dict has its keys sorted,
    as `jax.tree` flattens a dict (`sort`)."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        return [x for k in keys for x in _leaves(tree[k], sort)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, sort)]
    return [np.asarray(tree)]


def _fill(tree, leaves, sort: bool = False):
    """`tree`'s nested structure with its leaves taken in order from the
    iterator `leaves` (the inverse of `_leaves`)."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        filled = {k: _fill(tree[k], leaves, sort) for k in keys}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_fill(v, leaves, sort) for v in tree]
    return next(leaves)


def state_leaves(net, pstate) -> list:
    """The pair's leaves as numpy arrays in the JAX package's flatten
    order of ``(net, pstate)``."""
    net_np, ps_np = convert.to_numpy(net, pstate)
    return _leaves(net_np) + _leaves(ps_np, isinstance(pstate, dict))


def state_from_leaves(protocol, leaves, seed=0, device=None):
    """``(net, pstate)`` from leaves in the JAX flatten order; only the
    tree structure comes from ``protocol.init(seed)`` (leaf shapes and
    dtypes come from the leaves), so a seed batch restores through the
    single-seed template.  On `device`, else the template's."""
    net0, ps0 = protocol.init(seed)
    if device is None:
        device = net0.time.device
    net_np, ps_np = convert.to_numpy(net0, ps0)
    sort = isinstance(ps0, dict)
    it = iter(leaves)
    net_np = _fill(net_np, it)
    ps_np = _fill(ps_np, it, sort)
    if next(it, None) is not None:
        raise ValueError("the checkpoint holds more leaves than the "
                         "protocol's state: it was written for another "
                         "protocol or configuration")
    return convert.from_reference(net_np, ps_np, device)


def _write_npz(path, arrays: dict, compress: bool) -> None:
    """`np.savez` (``compress``: `np.savez_compressed`) without its
    chunked copies: each entry's `.npy` header, then the array's own
    memory."""
    mode = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
    with zipfile.ZipFile(path, "w", compression=mode,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            a = np.asarray(a)
            if not a.flags.c_contiguous:
                a = np.array(a, order="C")
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast("B"))


def _stored_array(buf, info):
    """A stored `.npy` entry of the archive in `buf` as a view of it
    (CRC checked), or None where it must be read the general way."""
    off = info.header_offset
    name_len, extra_len = struct.unpack("<HH", bytes(buf[off + 26:off + 30]))
    start = off + 30 + name_len + extra_len
    data = buf[start:start + info.file_size]
    if zlib.crc32(data) != info.CRC:
        raise ValueError(f"checkpoint entry {info.filename}: CRC mismatch "
                         "(a torn or corrupted file)")
    head = io.BytesIO(bytes(data[:4096]))
    version = np.lib.format.read_magic(head)
    read = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}.get(version)
    if read is None:
        return None
    shape, fortran, dtype = read(head)
    if fortran or dtype.hasobject:
        return None
    return np.frombuffer(data, dtype=dtype, offset=head.tell()).reshape(
        shape)


def _read_npz(path) -> dict:
    """``{entry: array}`` of a `.npz` (a path or a file object): stored
    entries of a file, or of an in-memory `io.BytesIO`, as views of it;
    compressed ones (the JAX package's files) read as `np.load` reads
    them."""
    if isinstance(path, io.BytesIO):
        buf = path.getbuffer()
    elif isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        with open(path, "rb") as fh:
            buf = memoryview(mmap.mmap(fh.fileno(), 0,
                                       access=mmap.ACCESS_COPY))
    else:
        buf = None
    out = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            a = None
            if buf is not None and info.compress_type == zipfile.ZIP_STORED:
                a = _stored_array(buf, info)
            if a is None:
                with zf.open(info) as f:
                    a = np.lib.format.read_array(f)
            out[info.filename.removesuffix(".npy")] = a
    return out


def save(path, net, pstate, meta: dict | None = None,
         compress: bool = True) -> None:
    """Write the full simulator state to `path` (.npz, a path or a
    writable file object; wittgenstein_tpu/utils/checkpoint.py:24-30).
    ``compress=False`` stores the same entries uncompressed: deflate
    runs at about 0.2 GB/s on one core, and a seed batch's ring is
    GBs."""
    arrays = {f"leaf_{i}": x
              for i, x in enumerate(state_leaves(net, pstate))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    _write_npz(path, arrays, compress)


def peek_meta(path) -> dict:
    """Read ONLY the metadata dict of a checkpoint
    (wittgenstein_tpu/utils/checkpoint.py:33-40)."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode()) \
            if "__meta__" in z else {}


def stale_meta_problems(meta: dict) -> list:
    """Staleness audit of a serve GROUP-checkpoint metadata dict
    (wittgenstein_tpu/utils/checkpoint.py:43-78): the meta schema must
    be 2 and every stored spec must still digest to its recorded
    `spec_digest`.  Returns human-readable problem strings — empty
    means the file is internally consistent and safe to restore."""
    from ..serve.spec import ScenarioSpec

    schema = meta.get("schema")
    if schema != 2:
        return [f"checkpoint meta schema {schema!r} != 2 — written by "
                "a different tree, so its specs cannot be verified"]
    problems = []
    for rm in meta.get("requests", ()):
        want = rm.get("spec_digest")
        try:
            got = ScenarioSpec.from_json(rm["spec"]).digest()
        except (ValueError, KeyError, TypeError) as e:
            problems.append(f"request {rm.get('id')!r}: stored spec "
                            f"no longer parses ({e})")
            continue
        if got != want:
            problems.append(
                f"request {rm.get('id')!r}: stored spec digests to "
                f"{got} but the checkpoint recorded {want} — the spec "
                "was edited after this checkpoint was written")
    return problems


def load(path, protocol, seed=0, device=None):
    """Restore ``(net, pstate, meta)`` (wittgenstein_tpu/utils/
    checkpoint.py:80-99).  `protocol` must be built with the same
    parameters as at save time; its ``init(seed)`` supplies the tree
    structure only, so batched states restore through the single-seed
    template.  On `device`, else the device the protocol lays its
    state out on."""
    z = _read_npz(path)
    meta = json.loads(bytes(z["__meta__"]).decode()) \
        if "__meta__" in z else {}
    leaves = []
    while f"leaf_{len(leaves)}" in z:
        leaves.append(z[f"leaf_{len(leaves)}"])
    net, pstate = state_from_leaves(protocol, leaves, seed, device)
    return net, pstate, meta
