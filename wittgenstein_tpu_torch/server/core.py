"""The parameter gate of the simulation server — the port of
`list_protocols`, `protocol_parameters` and `validate_parameters` from
`wittgenstein_tpu/server/core.py:37-78` (the `Server` itself waits for
ROADMAP.md A14).

The protocol registry is the `@register` table of `core/protocol.py`,
filled by importing every model module (`load_models`); parameters are
the protocol constructors' keyword arguments.  The port's constructors
also take `device`, which places a run and is not a parameter of the
scenario: the template leaves it out, so the template, its refusal
text and every digest built from parameters are the JAX package's.
"""

from __future__ import annotations

import importlib
import inspect
import json

from ..core.protocol import PROTOCOLS, get_protocol

#: the model modules whose import fills the registry
MODEL_MODULES = ("avalanche", "casper", "dfinity", "enr", "ethpow", "gsf",
                 "handel", "handel_cardinal", "handeleth2", "optimistic",
                 "p2pflood", "p2phandel", "paxos", "pingpong", "sanfermin")

#: constructor keywords that place a run rather than describe it
PLACEMENT = ("device",)


def load_models() -> None:
    """Import every model module, registering its protocols (the JAX
    package's ``import wittgenstein_tpu.models``)."""
    for name in MODEL_MODULES:
        importlib.import_module(f"..models.{name}", __package__)


def list_protocols() -> list:
    """GET /w/protocols (wittgenstein_tpu/server/core.py:37-39)."""
    load_models()
    return sorted(PROTOCOLS)


def protocol_parameters(name: str) -> dict:
    """The parameter template with defaults
    (wittgenstein_tpu/server/core.py:42-54), without `device`."""
    load_models()
    cls = get_protocol(name)
    sig = inspect.signature(cls.__init__)
    out = {}
    for pname, prm in sig.parameters.items():
        if pname == "self" or pname in PLACEMENT:
            continue
        out[pname] = None if prm.default is inspect.Parameter.empty \
            else prm.default
    return out


def validate_parameters(name: str, params: dict | None):
    """THE parameter gate (wittgenstein_tpu/server/core.py:57-78): an
    unknown kwarg is refused with the template echoed.  Returns the
    protocol class on success."""
    load_models()
    try:
        cls = get_protocol(name)
    except KeyError as e:
        raise ValueError(str(e)) from None
    template = protocol_parameters(name)
    unknown = sorted(set(params or {}) - set(template))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for {name}; the template "
            f"(GET /w/protocols/{name}) is: "
            f"{json.dumps(template, sort_keys=True, default=str)}")
    return cls
