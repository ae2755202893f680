"""State carried between the JAX package and the port.

Both sides meet as nested dicts of numpy arrays under the JAX field
names: ``{"time": ..., "nodes": {"x": ...}, "box_data": [plane, ...],
...}`` for the `NetState` and the same for the protocol state (a
`HandelState` or a `GSFState`, told apart by their leaf names).  The JAX
side builds them from its dataclasses (the tests do so with
`jax.tree_util`); `from_reference` turns them into the port's state and
`to_numpy` back.  uint32 leaves (bitsets) are reinterpreted, never
converted: the port keeps the same bits in int32.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .core.state import NetState, NodeState
from .models.gsf import GSFState
from .models.handel import HandelState

#: per protocol state class: the leaves the JAX package stores as uint32
#: bitsets, and whether its q_sig is a list of `state_split` pieces
#: (Handel) rather than one [N, Q, W] array (GSF)
STATES = {
    HandelState: (("ver_ind", "last_agg", "finished_peers", "blacklist",
                   "demoted", "q_sig", "pool", "pend_sig"), True),
    GSFState: (("verified", "ver_indiv", "got_indiv", "q_sig", "pend_sig",
                "pool"), False),
}


def state_class(pstate_np: dict):
    """The port's state class whose fields are exactly these leaves."""
    for cls in STATES:
        if {f.name for f in dataclasses.fields(cls)} == set(pstate_np):
            return cls
    raise ValueError(f"no protocol state has the leaves {sorted(pstate_np)}")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(np.array(a, order="C"), device=device)


def _numpy(t: torch.Tensor, u32: bool = False):
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if u32 else a


def from_reference(net_np: dict, pstate_np: dict, device):
    """``(NetState, protocol state)`` on `device` from the JAX package's
    state as nested dicts of numpy arrays (one ring sub-plane; for
    Handel one q_sig piece).  Every leaf is copied."""
    dev = torch.device(device)
    nodes = NodeState(**{k: _tensor(v, dev)
                         for k, v in net_np["nodes"].items()})
    f = len(net_np["box_data"])
    hnc = net_np["box_count"].shape + (-1,)
    if len(net_np["box_src"]) != 1:
        raise NotImplementedError("box_split > 1 is not ported yet")
    ring = {
        "box_data": torch.stack([_tensor(p, dev).reshape(hnc)
                                 for p in net_np["box_data"]]),
        "box_src": _tensor(net_np["box_src"][0], dev).reshape(hnc),
        "box_size": _tensor(net_np["box_size"][0], dev).reshape(hnc),
    }
    if ring["box_data"].shape[0] != f:
        raise ValueError("box_data planes do not match payload_words")
    rest = {k: _tensor(v, dev) for k, v in net_np.items()
            if k not in ("nodes", "box_data", "box_src", "box_size")}
    net = NetState(nodes=nodes, **ring, **rest)

    cls = state_class(pstate_np)
    ps = dict(pstate_np)
    if STATES[cls][1]:
        if len(ps["q_sig"]) != 1:
            raise NotImplementedError("state_split > 1 is not ported yet")
        ps["q_sig"] = ps["q_sig"][0]
    pstate = cls(**{k: _tensor(v, dev) for k, v in ps.items()})
    return net, pstate


def to_numpy(net: NetState, pstate):
    """The port's state as ``(net_np, pstate_np)`` nested dicts under
    the JAX names, dtypes and layouts (ring planes flat, uint32
    bitsets)."""
    net_np = {}
    for fld in dataclasses.fields(net):
        v = getattr(net, fld.name)
        if fld.name == "nodes":
            net_np["nodes"] = {g.name: _numpy(getattr(v, g.name))
                               for g in dataclasses.fields(v)}
        elif fld.name == "box_data":
            net_np["box_data"] = [_numpy(v[i]).reshape(-1)
                                  for i in range(v.shape[0])]
        elif fld.name in ("box_src", "box_size"):
            net_np[fld.name] = [_numpy(v).reshape(-1)]
        else:
            net_np[fld.name] = _numpy(v)
    u32, split = STATES[type(pstate)]
    ps_np = {}
    for fld in dataclasses.fields(pstate):
        a = _numpy(getattr(pstate, fld.name), fld.name in u32)
        ps_np[fld.name] = [a] if split and fld.name == "q_sig" else a
    return net_np, ps_np


def flatten(tree, prefix: str = "") -> dict:
    """``{"net.nodes.x": array, "net.box_data.0": array, ...}`` from
    nested dicts and lists, in a fixed (sorted) order."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def leaf_digest(a) -> str:
    """sha256 of a leaf's dtype, shape and bytes."""
    a = np.array(a, order="C")
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def state_digest(net_np: dict, pstate_np: dict) -> dict:
    """``{leaf name: sha256}`` over both states' leaves."""
    flat = flatten({"net": net_np, "pstate": pstate_np})
    return {k: leaf_digest(v) for k, v in flat.items()}


def first_difference(a: dict, b: dict):
    """The first differing leaf of two flattened states, as
    ``(name, index or None, a_value, b_value)``, or None when equal."""
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            return name, None, name in a, name in b
        x, y = np.asarray(a[name]), np.asarray(b[name])
        if x.dtype != y.dtype or x.shape != y.shape:
            return name, None, (x.dtype, x.shape), (y.dtype, y.shape)
        if not np.array_equal(x, y):
            idx = tuple(int(i) for i in np.argwhere(x != y)[0])
            return name, idx, x[idx], y[idx]
    return None
