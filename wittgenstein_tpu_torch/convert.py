"""State carried between the JAX package and the port.

Both sides meet as nested dicts of numpy arrays under the JAX field
names: ``{"time": ..., "nodes": {"x": ...}, "box_data": [plane, ...],
...}`` for the `NetState` and the same for the protocol state (a
`HandelState`, a `HandelCardinalState`, a `GSFState`, a `PingPongState`,
a `SanFerminState`, a `CapposState`, a `DfinityState`, `CasperState` or
`PoWState` with its nested `Arena` as a nested dict (the port's ancestor
leaf rebuilt from ``parent``), a `P2PFloodState`, a `HandelEth2State`, a
`P2PHandelState`, an `OptSigState`, an `AvalancheState`, a
`PaxosState` or an `ENRState`, told apart by their
leaf names; a protocol whose state is a plain dict of tensors, as the
engine tests' probes have, converts leaf for leaf). The JAX side builds
them from its dataclasses (the tests do so with `jax.tree_util`);
`from_reference` turns them into the port's state and `to_numpy` back.
uint32 leaves (bitsets) are reinterpreted, never converted: the port
keeps the same bits in int32. A ring split into ``box_split`` sub-planes
is a tuple of sub-plane tensors per leaf here and F*P (payload) or P
flat planes there, plane ``f*P + j`` holding payload word f of sub-plane
j; Handel's q_sig is a tuple of `state_split` pieces on both sides.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os

import numpy as np
import torch

from .core.blockchain import JAX_LEAVES, Arena, ancestors_of
from .core.state import NetState, NodeState
from .models.avalanche import AvalancheState
from .models.casper import CasperState
from .models.dfinity import DfinityState
from .models.enr import ENRState
from .models.ethpow import PoWState
from .models.gsf import GSFState
from .models.handel import HandelState
from .models.handel_cardinal import HandelCardinalState
from .models.handeleth2 import HandelEth2State
from .models.optimistic import OptSigState
from .models.p2phandel import P2PHandelState
from .models.p2pflood import P2PFloodState
from .models.paxos import PaxosState
from .models.pingpong import PingPongState
from .models.sanfermin import CapposState, SanFerminState

#: per protocol state class: the leaves the JAX package stores as uint32
#: bitsets, and whether its q_sig is a tuple of `state_split` pieces
#: (Handel) rather than one [N, Q, W] array (GSF)
STATES = {
    HandelState: (("ver_ind", "last_agg", "finished_peers", "blacklist",
                   "demoted", "q_sig", "pool", "pend_sig"), True),
    HandelCardinalState: (("blacklist",), False),
    GSFState: (("verified", "ver_indiv", "got_indiv", "q_sig", "pend_sig",
                "pool"), False),
    PingPongState: ((), False),
    SanFerminState: ((), False),
    CapposState: ((), False),
    DfinityState: (("recv_blk", "votes", "buffered", "maj_height",
                    "exchanged", "q_vote", "q_bcast_blk"), False),
    P2PFloodState: ((), False),
    CasperState: (("included", "att_anc", "recv_blk", "recv_att",
                   "reeval"), False),
    PoWState: (("received", "mined_unsent", "release"), False),
    HandelEth2State: (("inc", "ind", "finished", "demoted", "q_sig",
                       "pend_sig"), False),
    P2PHandelState: (("verified", "peer_state", "acc", "q_sig",
                      "pend_sig"), False),
    OptSigState: (("received", "pending"), False),
    AvalancheState: ((), False),
    PaxosState: ((), False),
    ENRState: ((), False),
}
#: protocol state leaves that are structs of their own, and the leaves
#: of each that the JAX package has (the port's Arena adds ``anc``,
#: rebuilt from ``parent``)
NESTED = {"arena": Arena}
NESTED_LEAVES = {Arena: JAX_LEAVES}


def _nested(cls, v: dict, device):
    leaves = {f: _tensor(x, device) for f, x in v.items()}
    if cls is Arena:
        leaves["anc"] = _tensor(ancestors_of(v["parent"]), device)
    return cls(**leaves)


def state_class(pstate_np: dict):
    """The port's state class whose fields are exactly these leaves."""
    for cls in STATES:
        if {f.name for f in dataclasses.fields(cls)} == set(pstate_np):
            return cls
    raise ValueError(f"no protocol state has the leaves {sorted(pstate_np)}")


def _tensor(a, device):
    """A copy of `a` on `device` (uint32 bits as int32): one host-to-
    device copy for a card, one host copy for the CPU."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    t = torch.from_numpy(a)
    return t.clone() if torch.device(device).type == "cpu" else \
        t.to(device)


def _numpy(t: torch.Tensor, u32: bool = False):
    """A copy: a CPU tensor's `.numpy()` shares its memory, and the
    engine updates the ring in place."""
    a = t.detach().cpu().numpy()
    if t.device.type == "cpu":
        a = a.copy()
    return a.view(np.uint32) if u32 else a


def from_reference(net_np: dict, pstate_np: dict, device):
    """``(NetState, protocol state)`` on `device` from the JAX package's
    state as nested dicts of numpy arrays (any number of ring
    sub-planes and q_sig pieces), of one run or of a seed batch (every
    leaf with a leading R axis, as `jax.vmap` lays it out).  Every leaf
    is copied."""
    dev = torch.device(device)
    nodes = NodeState(**{k: _tensor(v, dev)
                         for k, v in net_np["nodes"].items()})
    lead = np.ndim(net_np["time"])              # 0, or 1 for a batch
    p = len(net_np["box_src"])
    f, rem = divmod(len(net_np["box_data"]), p)
    if rem:
        raise ValueError("box_data planes are not F per sub-plane")
    count = net_np["box_count"]                 # [..., H, N]
    ns = count.shape[-1] // p
    hnc = count.shape[:-1] + (ns, -1)

    def sub(j):
        return {"box_data": torch.stack(
                    [_tensor(net_np["box_data"][fi * p + j], dev).reshape(hnc)
                     for fi in range(f)], lead),
                "box_src": _tensor(net_np["box_src"][j], dev).reshape(hnc),
                "box_size": _tensor(net_np["box_size"][j], dev).reshape(hnc),
                "box_count": _tensor(count[..., j * ns:(j + 1) * ns], dev)}

    subs = [sub(j) for j in range(p)]
    ring = {k: subs[0][k] if p == 1 else tuple(x[k] for x in subs)
            for k in subs[0]}
    rest = {k: _tensor(v, dev) for k, v in net_np.items()
            if k not in ("nodes",) + tuple(ring)}
    net = NetState(nodes=nodes, **ring, **rest)

    try:
        cls = state_class(pstate_np)
    except ValueError:
        return net, {k: _tensor(v, dev) for k, v in pstate_np.items()}
    def leaf(k, v):
        if k in NESTED:
            return _nested(NESTED[k], v, dev)
        if STATES[cls][1] and k == "q_sig":
            return tuple(_tensor(x, dev) for x in v)
        return _tensor(v, dev)
    return net, cls(**{k: leaf(k, v) for k, v in pstate_np.items()})


def to_numpy(net: NetState, pstate):
    """The port's state as ``(net_np, pstate_np)`` nested dicts under
    the JAX names, dtypes and layouts (ring planes flat, uint32
    bitsets).  A seed batch (`core/state.init_batched`, ``time`` of shape
    [R]) comes out as the JAX package's ``jax.vmap`` lays it out: every
    leaf with a leading R axis, each ring plane [R, H*Ns*C]."""
    lead = tuple(net.time.shape)                # () or (R,)
    net_np = {}
    for fld in dataclasses.fields(net):
        v = getattr(net, fld.name)
        subs = v if isinstance(v, tuple) else (v,)
        if fld.name == "nodes":
            net_np["nodes"] = {g.name: _numpy(getattr(v, g.name))
                               for g in dataclasses.fields(v)}
        elif fld.name == "box_data":
            net_np["box_data"] = [
                _numpy(x[..., fi, :, :, :]).reshape(*lead, -1)
                for fi in range(subs[0].shape[len(lead)]) for x in subs]
        elif fld.name in ("box_src", "box_size"):
            net_np[fld.name] = [_numpy(x).reshape(*lead, -1) for x in subs]
        elif fld.name == "box_count":
            net_np[fld.name] = np.concatenate([_numpy(x) for x in subs], -1)
        else:
            net_np[fld.name] = _numpy(v)
    if isinstance(pstate, dict):
        return net_np, {k: _numpy(v) for k, v in pstate.items()}
    u32, split = STATES[type(pstate)]
    ps_np = {}
    for fld in dataclasses.fields(pstate):
        v = getattr(pstate, fld.name)
        if fld.name in NESTED:
            ps_np[fld.name] = {g: _numpy(getattr(v, g))
                               for g in NESTED_LEAVES[NESTED[fld.name]]}
        elif split and fld.name == "q_sig":
            ps_np[fld.name] = [_numpy(x, True) for x in v]
        else:
            ps_np[fld.name] = _numpy(v, fld.name in u32)
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
    """sha256 of a leaf's dtype, shape and bytes (hashed in place, no
    copy of a C-contiguous leaf)."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.array(a, order="C")
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def _digests(leaves: dict) -> dict:
    """`leaf_digest` of each leaf, on threads: hashlib releases the GIL,
    and a state at scale is GBs of leaves."""
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(leaves, pool.map(leaf_digest, leaves.values())))


def state_digest(net_np: dict, pstate_np: dict) -> dict:
    """``{leaf name: sha256}`` over both states' leaves."""
    return _digests(flatten({"net": net_np, "pstate": pstate_np}))


def seed_digests(net_np: dict, pstate_np: dict, seeds=None) -> list:
    """Per seed of a batched state (leading R axis on every leaf), the
    `state_digest` that seed's state alone would have; of the batch
    positions `seeds` only, when given."""
    flat = flatten({"net": net_np, "pstate": pstate_np})
    if seeds is None:
        seeds = range(len(flat["net.time"]))
    # every (seed, leaf) on one pool: a seed's bytes sit in a few ring
    # leaves, so a pool per seed waits on its largest leaf
    jobs = [(i, k) for i in seeds for k in flat]
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        hashes = pool.map(lambda job: leaf_digest(flat[job[1]][job[0]]),
                          jobs)
        out = {}
        for (i, k), h in zip(jobs, hashes):
            out.setdefault(i, {})[k] = h
    return [out[i] for i in seeds]


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
