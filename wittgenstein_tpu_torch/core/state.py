"""Engine state: struct-of-tensors node state and the mailbox ring — the
port of `wittgenstein_tpu/core/state.py`.

`flax.struct` dataclasses become frozen dataclasses of tensors with a
``.replace()``, registered as pytrees (`register_struct`) so that
`torch.func.vmap` maps over them as `jax.vmap` does; `init_batched`
stacks a batch of runs on a leading seed axis.  The ring is stored as
``[F, H, N, C]`` payload planes plus ``[H, N, C]`` src and size planes
(the JAX package keeps the same cells as F+2 flat ``[H*N*C]`` buffers;
`convert.py` maps one onto the other); with ``box_split`` P > 1 every
ring leaf is a tuple of P node-range sub-planes.  The engine updates the
ring IN PLACE (see `core/network.py`); every other leaf is replaced,
not mutated.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

# World map (wittgenstein_tpu/core/state.py:27-29).
MAX_X = 2000
MAX_Y = 1112
MAX_DIST = int((((MAX_X / 2.0) ** 2) + ((MAX_Y / 2.0) ** 2)) ** 0.5)

I32 = torch.int32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  Without a card the default raises; it never
    drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wittgenstein_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


class _Struct:
    """Frozen-dataclass mixin standing in for `flax.struct.dataclass`."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def register_struct(cls, static=()):
    """Register a state dataclass as a pytree, so that `torch.func.vmap`
    and `torch.utils._pytree` take and return it as `jax.vmap` does a
    `flax.struct` dataclass: every field is a leaf except the `static`
    ones (Python values such as `Outbox.slot0`), which travel in the
    tree's context."""
    names = tuple(f.name for f in dataclasses.fields(cls)
                  if f.name not in static)

    def flatten(obj):
        return ([getattr(obj, k) for k in names],
                tuple(getattr(obj, k) for k in static))

    def unflatten(leaves, ctx):
        return cls(**dict(zip(names, leaves)), **dict(zip(static, ctx)))

    def flatten_with_keys(obj):
        leaves, ctx = flatten(obj)
        return [(pytree.GetAttrKey(k), v) for k, v in zip(names, leaves)], \
            ctx

    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
        flatten_with_keys_fn=flatten_with_keys)
    return cls


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape (wittgenstein_tpu/core/state.py:33-75)."""

    n: int
    horizon: int = 512
    inbox_cap: int = 8
    payload_words: int = 2
    out_deg: int = 1
    bcast_slots: int = 4
    msg_discard_time: int = 1 << 30
    spill_cap: int = 0
    box_split: int = 1

    @property
    def split_n(self):
        return self.n // self.box_split


@register_struct
@dataclasses.dataclass(frozen=True)
class NodeState(_Struct):
    """Per-node engine state, ``[N]``-shaped
    (wittgenstein_tpu/core/state.py:79-102)."""

    x: torch.Tensor
    y: torch.Tensor
    city: torch.Tensor
    speed_ratio: torch.Tensor
    extra_latency: torch.Tensor
    down: torch.Tensor
    byzantine: torch.Tensor
    done_at: torch.Tensor
    partition: torch.Tensor
    msg_sent: torch.Tensor
    msg_received: torch.Tensor
    bytes_sent: torch.Tensor
    bytes_received: torch.Tensor


def default_nodes(n: int, device) -> NodeState:
    """wittgenstein_tpu/core/state.py:105-125."""
    def zi():
        return torch.zeros(n, dtype=I32, device=device)

    return NodeState(
        x=torch.ones(n, dtype=I32, device=device),
        y=torch.ones(n, dtype=I32, device=device),
        city=torch.full((n,), -1, dtype=I32, device=device),
        speed_ratio=torch.ones(n, dtype=torch.float32, device=device),
        extra_latency=zi(),
        down=torch.zeros(n, dtype=torch.bool, device=device),
        byzantine=torch.zeros(n, dtype=torch.bool, device=device),
        done_at=zi(), partition=zi(), msg_sent=zi(), msg_received=zi(),
        bytes_sent=zi(), bytes_received=zi())


@register_struct
@dataclasses.dataclass(frozen=True)
class NetState(_Struct):
    """Full simulator state (wittgenstein_tpu/core/state.py:129-168).

    box_data [F, H, N, C], box_src/box_size [H, N, C] and box_count
    [H, N] are the unicast ring (with ``box_split`` P > 1 each is a
    tuple of P node-range sub-planes over N/P nodes, which the binning
    kernel fills one launch each, as the JAX package splits its
    planes); bc_* is the broadcast table [B] and sp_* the far-future
    spill buffer [S] (both empty on Handel's path, kept so every JAX
    leaf has its counterpart)."""

    time: torch.Tensor
    seed: torch.Tensor
    nodes: NodeState
    box_data: torch.Tensor
    box_src: torch.Tensor
    box_size: torch.Tensor
    box_count: torch.Tensor
    bc_active: torch.Tensor
    bc_src: torch.Tensor
    bc_time: torch.Tensor
    bc_payload: torch.Tensor
    bc_size: torch.Tensor
    bc_seed: torch.Tensor
    sp_arrival: torch.Tensor
    sp_src: torch.Tensor
    sp_dest: torch.Tensor
    sp_size: torch.Tensor
    sp_payload: torch.Tensor
    dropped: torch.Tensor
    bc_dropped: torch.Tensor
    clamped: torch.Tensor
    sp_dropped: torch.Tensor


def init_net(cfg: EngineConfig, nodes: NodeState, seed) -> NetState:
    """wittgenstein_tpu/core/state.py:171-214."""
    h, n, c, f, b = (cfg.horizon, cfg.n, cfg.inbox_cap, cfg.payload_words,
                     cfg.bcast_slots)
    p = cfg.box_split
    if n % p:
        raise ValueError(f"box_split {p} must divide node count {n}")
    ns = cfg.split_n
    if h * ns * c >= 1 << 31:
        raise ValueError(
            f"mailbox ring sub-plane too large for int32 flat indexing: "
            f"{h}x{ns}x{c} >= 2^31; shrink horizon/inbox_cap or raise "
            f"box_split / shard the node axis across devices")
    dev = nodes.x.device
    s = cfg.spill_cap

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=I32, device=dev)

    def ring(*lead, cells=(c,)):
        """One ring leaf [*lead, N, *cells]: a tensor, or with P > 1 a
        tuple of P sub-planes [*lead, N/P, *cells], sub-plane j holding
        nodes [j*N/P, (j+1)*N/P)."""
        if p == 1:
            return z(*lead, n, *cells)
        return tuple(z(*lead, ns, *cells) for _ in range(p))

    return NetState(
        time=scalar(0), seed=torch.as_tensor(seed, device=dev).to(I32).clone(),
        nodes=nodes,
        box_data=ring(f, h), box_src=ring(h), box_size=ring(h),
        box_count=ring(h, cells=()),
        bc_active=z(b, dtype=torch.bool), bc_src=z(b), bc_time=z(b),
        bc_payload=z(b, f), bc_size=z(b), bc_seed=z(b),
        sp_arrival=torch.full((s,), -1, dtype=I32, device=dev),
        sp_src=z(s), sp_dest=z(s), sp_size=z(s), sp_payload=z(s, f),
        dropped=scalar(0), bc_dropped=scalar(0), clamped=scalar(0),
        sp_dropped=scalar(0))


@register_struct
@dataclasses.dataclass(frozen=True)
class Inbox(_Struct):
    """What a node sees at time t (wittgenstein_tpu/core/state.py:218-228)."""

    data: torch.Tensor      # int32 [N, S, F]
    src: torch.Tensor       # int32 [N, S]
    valid: torch.Tensor     # bool [N, S]


@dataclasses.dataclass(frozen=True)
class Outbox(_Struct):
    """What every node sends after time t
    (wittgenstein_tpu/core/state.py:232-254)."""

    dest: torch.Tensor
    payload: torch.Tensor
    size: torch.Tensor
    delay: torch.Tensor
    bcast: torch.Tensor
    bcast_payload: torch.Tensor
    bcast_size: torch.Tensor
    slot0: int = 0


register_struct(Outbox, static=("slot0",))


def init_batched(protocol, seeds):
    """``(NetState, protocol state)`` of a batch of runs: every leaf
    with a leading seed axis R, the layout of the JAX package's
    ``jax.vmap(protocol.init)(seeds)``.  Each seed's state is built by
    `protocol.init` and copied into the batch, one seed at a time, so
    the batch and one seed's state are all that is held at once."""
    seeds = torch.as_tensor(seeds).tolist()
    state = protocol.init(seeds[0])
    batch = pytree.tree_map(
        lambda x: x.new_empty((len(seeds),) + tuple(x.shape)), state)
    for r, seed in enumerate(seeds):
        if r:
            del state                   # before the next seed's is built
            state = protocol.init(seed)
        pytree.tree_map(lambda b, x, r=r: b[r].copy_(x), batch, state)
    return batch


def empty_outbox(cfg: EngineConfig, device, k: int | None = None,
                 slot0: int = 0) -> Outbox:
    """wittgenstein_tpu/core/state.py:257-270."""
    n, f = cfg.n, cfg.payload_words
    k = cfg.out_deg if k is None else k
    return Outbox(
        dest=torch.full((n, k), -1, dtype=I32, device=device),
        payload=torch.zeros((n, k, f), dtype=I32, device=device),
        size=torch.ones((n, k), dtype=I32, device=device),
        delay=torch.zeros((n, k), dtype=I32, device=device),
        bcast=torch.zeros(n, dtype=torch.bool, device=device),
        bcast_payload=torch.zeros((n, f), dtype=I32, device=device),
        bcast_size=torch.ones(n, dtype=I32, device=device),
        slot0=slot0)
