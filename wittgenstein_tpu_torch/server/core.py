"""The simulation server — IServer parity (wserver/IServer.java:9-34);
the port of `wittgenstein_tpu/server/core.py`: the parameter gate
(`list_protocols`, `protocol_parameters`, `validate_parameters`) and the
`Server`.

The reference wraps its simulator in a REST facade
(wserver/Server.java, ws/WServer.java): discover protocols, instantiate
one from a WParameters JSON, drive it with runMs, read node state and
pending messages, stop/start nodes, attach "external" nodes whose
deliveries are shipped to a remote system that replies with messages to
inject (core/External.java, Network.java:616-623).  `Server` is the
transport-agnostic core; `server/http.py` is its HTTP face.

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

import numpy as np

from ..core import network as net_mod
from ..core.protocol import PROTOCOLS, get_protocol
from ..core.state import Inbox, empty_outbox, resolve_device

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


class Server:
    """One interactive simulation (wittgenstein_tpu/server/core.py:
    81-334), on `device` (``cuda`` unless given; no card and no
    ``device=`` raises).

    External-node semantics: a node marked external is stopped
    in-engine (it no longer acts); while any external exists, `run_ms`
    advances 1 ms at a time, peeks each external's deliveries
    (EnvelopeInfo), hands them to the handler, and injects the returned
    SendMessages — the reference's per-delivery hop, in-loop
    (Network.java:616-623).

    The engine advances the mailbox ring in place (the port's `Runner`
    takes the state it is handed), where the JAX `Server` runs its
    Runner without donation.  The server owns its state, so that costs
    nothing; what must hold is that a peek does not disturb the next
    step: `peek_messages` and `pending_messages` only read the ring
    (the inbox they rebuild is computed out of place, as the engine
    computes it, and dropped).  `send` routes its one-message outbox
    through the engine's own routing and the binning kernel (K1 on the
    card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.protocol = None
        self.protocol_name = None
        self.net = None
        self.pstate = None
        self.runner = None
        self.externals = {}           # node id -> handler(list[dict])->list

    # ---- lifecycle (IServer.init / runMs) ----

    def init(self, name: str, params: dict | None = None, seed: int = 0):
        cls = validate_parameters(name, params)
        self.protocol = cls(**(params or {}), device=self.device)
        self.protocol_name = name
        self.net, self.pstate = self.protocol.init(seed)
        self.runner = net_mod.Runner(self.protocol)
        self.externals = {}

    def _require(self):
        if self.protocol is None:
            raise RuntimeError("no protocol initialized (POST /network/init)")

    def run_ms(self, ms: int) -> None:
        self._require()
        if not self.externals:
            self.net, self.pstate = self.runner.run_ms(self.net, self.pstate,
                                                       ms)
            return
        # With externals attached: single-ms steps + bridge per ms.
        for _ in range(int(ms)):
            t = self.time()
            for nid, handler in self.externals.items():
                delivered = self.peek_messages(nid, t)
                if delivered:
                    for msg in handler(delivered) or []:
                        self.send(msg["from"], msg["to"],
                                  msg.get("payload"), msg.get("delay", 0))
            self.net, self.pstate = self.runner.run_ms(self.net, self.pstate,
                                                       1)

    def time(self) -> int:
        self._require()
        return int(self.net.time)

    # ---- node state ----

    def node_info(self, nid: int) -> dict:
        self._require()
        nid = int(nid)
        if not (0 <= nid < self.protocol.cfg.n):
            raise ValueError(f"no node {nid}; network has "
                             f"{self.protocol.cfg.n} nodes")
        nd = self.net.nodes
        return {
            "nodeId": int(nid),
            "x": int(nd.x[nid]), "y": int(nd.y[nid]),
            "city": int(nd.city[nid]),
            "down": bool(nd.down[nid]),
            "byzantine": bool(nd.byzantine[nid]),
            "external": int(nid) in self.externals,
            "doneAt": int(nd.done_at[nid]),
            "msgReceived": int(nd.msg_received[nid]),
            "msgSent": int(nd.msg_sent[nid]),
            "bytesReceived": int(nd.bytes_received[nid]),
            "bytesSent": int(nd.bytes_sent[nid]),
        }

    def all_nodes(self) -> list:
        self._require()
        nd = self.net.nodes
        cols = {k: getattr(nd, v).cpu().numpy() for k, v in [
            ("x", "x"), ("y", "y"), ("city", "city"), ("down", "down"),
            ("byzantine", "byzantine"), ("doneAt", "done_at"),
            ("msgReceived", "msg_received"), ("msgSent", "msg_sent"),
            ("bytesReceived", "bytes_received"),
            ("bytesSent", "bytes_sent")]}
        out = []
        for i in range(self.protocol.cfg.n):
            row = {k: v[i].item() for k, v in cols.items()}
            row["nodeId"] = i
            row["external"] = i in self.externals
            out.append(row)
        return out

    def stop_node(self, nid: int) -> None:
        """POST /network/nodes/{id}/stop (Server.java:135-143)."""
        self._set_down(nid, True)

    def start_node(self, nid: int) -> None:
        self._set_down(nid, False)

    def _set_down(self, nid: int, val: bool) -> None:
        self._require()
        if not (0 <= int(nid) < self.protocol.cfg.n):
            raise ValueError(f"no node {nid}")
        nodes = self.net.nodes
        down = nodes.down.clone()
        down[int(nid)] = val
        self.net = self.net.replace(nodes=nodes.replace(down=down))

    def _externals_up(self, nodes):
        """`nodes` with the external nodes' down flags lifted (their
        deliveries are diverted to the bridge, not dropped)."""
        if not self.externals:
            return nodes
        down = nodes.down.clone()
        down[list(self.externals)] = False
        return nodes.replace(down=down)

    # ---- messages ----

    def peek_messages(self, nid: int | None = None,
                      at: int | None = None) -> list:
        """GET /network/messages for one ms: the deliveries at `at`
        (default now) as EnvelopeInfo dicts (EnvelopeInfo.java;
        arrivingAt == the peeked ms only — the mailbox is time-bucketed,
        so this reports the next deliverable slice).  Reads the ring;
        writes nothing."""
        self._require()
        cfg, model = self.protocol.cfg, self.protocol.latency
        t = self.time() if at is None else int(at)
        net = self.net.replace(nodes=self._externals_up(self.net.nodes))
        ring = {k: getattr(net, k) for k in net_mod.RING}
        data, src, size, filled = net_mod._unicast_inbox_window(
            cfg, ring, t, 1)
        _, valid = net_mod._receive_window(net.nodes, src, size, filled)
        inbox = Inbox(data=data[0], src=src[0], valid=valid[0])
        if cfg.bcast_slots:
            _, inbox = net_mod._with_broadcasts(cfg, model, net, inbox, t)
        valid = inbox.valid.cpu().numpy()
        src = inbox.src.cpu().numpy()
        data = inbox.data.cpu().numpy()
        out = []
        rows = range(cfg.n) if nid is None else [int(nid)]
        for i in rows:
            for s in np.nonzero(valid[i])[0]:
                out.append({"from": int(src[i, s]), "to": int(i),
                            "arrivingAt": t,
                            "payload": [int(x) for x in data[i, s]]})
        return out

    def pending_messages(self) -> list:
        """GET /network/messages — the FULL in-flight set (Server.java:
        168-171): every undelivered unicast in the mailbox ring and the
        spill buffer plus every active broadcast's future per-dest
        arrivals, recomputed from the counter PRNG exactly as delivery
        will, as EnvelopeInfo dicts sorted by (arrivingAt, sentAt, from,
        to) (EnvelopeInfo.java:33-47).  sentAt is -1 for unicasts (the
        ring keeps no send times, as the reference's envelope
        compression keeps none, Envelope.java:45-56).  Reads only."""
        self._require()
        cfg = self.protocol.cfg
        net = self.net
        t = self.time()
        H, f = cfg.horizon, cfg.payload_words
        out = []

        def whole(leaf, axis):
            """A ring leaf with its node-range sub-planes put back
            together along the node axis, on the host."""
            if isinstance(leaf, tuple):
                return np.concatenate([x.cpu().numpy() for x in leaf],
                                      axis=axis)
            return leaf.cpu().numpy()

        count = whole(net.box_count, 1)                         # [H, N]
        src = whole(net.box_src, 1)                             # [H, N, C]
        data = whole(net.box_data, 2)                           # [F,H,N,C]
        for h in np.nonzero(count.sum(axis=1))[0]:
            arriving = t + int((int(h) - t) % H)
            for d in np.nonzero(count[h])[0]:
                for s in range(int(count[h, d])):
                    out.append({
                        "from": int(src[h, d, s]), "to": int(d),
                        "sentAt": -1, "arrivingAt": arriving,
                        "payload": [int(data[fi, h, d, s])
                                    for fi in range(f)]})

        sp_arr = net.sp_arrival.cpu().numpy()
        if sp_arr.size:
            sp_src = net.sp_src.cpu().numpy()
            sp_dest = net.sp_dest.cpu().numpy()
            sp_pay = net.sp_payload.cpu().numpy()
            for s in np.nonzero(sp_arr >= 0)[0]:
                out.append({"from": int(sp_src[s]), "to": int(sp_dest[s]),
                            "sentAt": -1, "arrivingAt": int(sp_arr[s]),
                            "payload": [int(x) for x in sp_pay[s]]})

        if bool(net.bc_active.any()):
            # External nodes are stopped in-engine but their deliveries
            # DO reach the bridge: their in-flight traffic is shown.
            nodes = self._externals_up(net.nodes)
            arrival, ok, _ = net_mod.broadcast_arrivals(
                cfg, self.protocol.latency, net, nodes)
            pend = ok & (arrival >= t) & (~nodes.down[None, :])
            pend_np = pend.cpu().numpy()
            arr_np = arrival.cpu().numpy()
            bsrc = net.bc_src.cpu().numpy()
            btime = net.bc_time.cpu().numpy()
            bpay = net.bc_payload.cpu().numpy()
            for r, d in zip(*np.nonzero(pend_np)):
                out.append({
                    "from": int(bsrc[r]), "to": int(d),
                    "sentAt": int(btime[r]),
                    "arrivingAt": int(arr_np[r, d]),
                    "payload": [int(x) for x in bpay[r]]})

        out.sort(key=lambda e: (e["arrivingAt"], e["sentAt"], e["from"],
                                e["to"]))
        return out

    def send(self, src: int, dest: int, payload=None, delay: int = 0):
        """POST /network/send (SendMessage.java): inject a unicast, routed
        as the engine routes a step's sends (latency draw, validity,
        spill or clamp) and binned into the ring by the binning kernel
        (wittgenstein_tpu/server/core.py:296-319)."""
        self._require()
        cfg, model = self.protocol.cfg, self.protocol.latency
        out = empty_outbox(cfg, self.device)
        out.dest[int(src), 0] = int(dest)
        for i, v in enumerate((payload or [])[:cfg.payload_words]):
            out.payload[int(src), 0, i] = int(v)
        out.delay[int(src), 0] = int(delay)
        # A stopped/external sender still injects (the reference's inject
        # path goes through Network.send on the external's behalf).
        nodes = self.net.nodes
        was_down = bool(nodes.down[int(src)])
        net = self.net
        if was_down:
            down = nodes.down.clone()
            down[int(src)] = False
            net = net.replace(nodes=nodes.replace(down=down))
        t = int(net.time)
        net, ring = net_mod._split_ring(net)
        net, msgs = net_mod._route_unicast(cfg, model, net, [out], t)
        n_dropped = net_mod._bin_into_ring(
            ring, *[x.contiguous() for x in msgs])
        net = net.replace(**ring, dropped=net.dropped + n_dropped)
        if was_down:
            down = net.nodes.down.clone()
            down[int(src)] = True
            net = net.replace(nodes=net.nodes.replace(down=down))
        self.net = net

    # ---- external bridge (External.java / ExternalRest.java) ----

    def set_external(self, nid: int, handler) -> None:
        """Mark a node external: stop it in-engine, route its deliveries
        to `handler(list[EnvelopeInfo]) -> list[SendMessage dict]`."""
        self._require()
        self.stop_node(nid)
        self.externals[int(nid)] = handler

    def clear_external(self, nid: int) -> None:
        self._require()
        self.externals.pop(int(nid), None)
        self.start_node(nid)
