"""The port's simulation server (`server/core.Server`, `server/http.py`):
the twins of tests/test_server.py — protocol discovery and templates,
the init -> send -> runMs -> time workflow in process and over HTTP, the
full in-flight message set, and the external-node bridge (in process
and through the server's own `/w/external_sink`) — each driven through
the JAX `Server` and the port's (on the CPU) with the same calls and
compared with tolerance 0: node records, message lists and the state.

The port's own point: its engine advances the ring in place, so
`peek_messages` and `pending_messages` must leave the state the next
`run_ms` reads as it was (held here by peeking before every step of one
run and comparing with a run that never peeks)."""

import json
import threading
import urllib.request

import pytest
import serve_parity as sp
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert
from wittgenstein_tpu_torch.server import core as pcore


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _servers():
    """(JAX Server, the port's Server on the CPU)."""
    sp.jax_serve()
    from wittgenstein_tpu.server import core as jcore
    return jcore.Server(), pcore.Server(device="cpu")


def _assert_same_state(js, ps, what=""):
    tp.assert_states_equal(tp.jax_state(js.net, js.pstate),
                           convert.to_numpy(ps.net, ps.pstate), what)


def test_protocol_discovery_and_templates():
    sp.jax_serve()
    from wittgenstein_tpu.server import core as jcore
    names = pcore.list_protocols()
    assert names == jcore.list_protocols()
    for name in names:
        assert pcore.protocol_parameters(name) == \
            jcore.protocol_parameters(name), name


def test_workflow_in_process():
    js, ps = _servers()
    for s in (js, ps):
        s.init("PingPong", {"node_count": 64}, seed=0)
        assert s.time() == 0
        s.run_ms(300)
        assert s.time() == 300
    _assert_same_state(js, ps, "300 ms")
    assert js.all_nodes() == ps.all_nodes()
    assert sum(n["msgReceived"] for n in ps.all_nodes()) > 0
    for s in (js, ps):
        s.stop_node(5)
        assert s.node_info(5)["down"]
        s.start_node(5)
        assert not s.node_info(5)["down"]
    assert js.node_info(7) == ps.node_info(7)


def test_external_bridge_mock():
    """The "remote" sees the external node's deliveries and replies with
    an injected message: the same deliveries, replies and state as the
    JAX server's."""
    js, ps = _servers()
    seen = ([], [])
    for s, log in zip((js, ps), seen):
        s.init("PingPong", {"node_count": 32}, seed=0)

        def mock(delivered, log=log):
            log.extend(delivered)
            return [{"from": delivered[0]["to"], "to": delivered[0]["from"],
                     "payload": [1]}] if delivered else []

        s.set_external(3, mock)
        assert s.node_info(3)["external"] and s.node_info(3)["down"]
        s.run_ms(300)
    assert seen[1] and seen[0] == seen[1]
    assert all(e["to"] == 3 for e in seen[1])
    _assert_same_state(js, ps, "bridged")


def test_pending_messages_full_in_flight_set():
    """The whole in-flight set — injected unicasts at two delays and a
    live broadcast, an external node's included — sorted, and equal to
    the JAX server's at every step."""
    js, ps = _servers()
    for s in (js, ps):
        s.init("PingPong", {"node_count": 32}, seed=0)
        s.send(1, 2, payload=[7], delay=50)
        s.send(4, 5, payload=[9], delay=150)
    msgs = ps.pending_messages()
    assert msgs == js.pending_messages()
    uni = [m for m in msgs if m["sentAt"] == -1]
    assert {(m["from"], m["to"]) for m in uni} == {(1, 2), (4, 5)}
    for s in (js, ps):
        s.set_external(9, lambda delivered: [])
        s.run_ms(1)
    msgs = ps.pending_messages()
    assert msgs == js.pending_messages()
    bc = [m for m in msgs if m["sentAt"] == 0]
    assert len(bc) > 20 and any(m["to"] == 9 for m in bc)
    assert msgs == sorted(msgs, key=lambda e: (e["arrivingAt"], e["sentAt"],
                                               e["from"], e["to"]))
    assert ps.peek_messages(None, 2) == js.peek_messages(None, 2)
    for s in (js, ps):
        s.clear_external(9)
        s.run_ms(1000)
    assert ps.pending_messages() == js.pending_messages() == []
    _assert_same_state(js, ps, "drained")


def test_peeks_leave_the_next_run_unchanged():
    """`peek_messages` and `pending_messages` before every ms of a run
    (the ring is updated in place by the engine) leave every later state
    equal to a run that never peeks."""
    peeking, plain = pcore.Server(device="cpu"), pcore.Server(device="cpu")
    for s in (peeking, plain):
        s.init("PingPong", {"node_count": 32}, seed=0)
        s.send(1, 2, payload=[7], delay=3)
    for _ in range(60):
        before = tp.clone((peeking.net, peeking.pstate))
        peeking.peek_messages()
        peeking.peek_messages(3, peeking.time() + 1)
        peeking.pending_messages()
        after = (peeking.net, peeking.pstate)
        for a, b in zip(tp.pytree_leaves(before), tp.pytree_leaves(after)):
            assert torch.equal(a, b)
        peeking.run_ms(1)
        plain.run_ms(1)
    tp.assert_states_equal(convert.to_numpy(plain.net, plain.pstate),
                           convert.to_numpy(peeking.net, peeking.pstate),
                           "peeked")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _put(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="PUT")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _serve():
    from wittgenstein_tpu_torch.server.http import make_server
    httpd = make_server(0, batch_auto=False, device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def test_http_round_trip():
    """/w/network/* over HTTP answers what the JAX server answers for
    the same calls."""
    js = _servers()[0]
    httpd, port = _serve()
    try:
        assert "PingPong" in _get(port, "/w/protocols")
        assert "node_count" in _get(port, "/w/protocols/PingPong")
        _post(port, "/w/network/init/PingPong", {"node_count": 32})
        _post(port, "/w/network/runMs/200")
        js.init("PingPong", {"node_count": 32}, seed=0)
        js.run_ms(200)
        assert _get(port, "/w/network/time") == 200
        assert _get(port, "/w/network/nodes") == js.all_nodes()
        assert _get(port, "/w/network/nodes/0") == js.node_info(0)
        _post(port, "/w/network/nodes/4/stop")
        js.stop_node(4)
        assert _get(port, "/w/network/nodes/4")["down"]
        _post(port, "/w/network/send", {"from": 1, "to": 2, "payload": [7]})
        js.send(1, 2, [7], 0)
        msgs = _get(port, "/w/network/messages")
        assert msgs == js.pending_messages()
        assert any(m["from"] == 1 and m["to"] == 2 for m in msgs)
        _assert_same_state(js, httpd.sim_server, "over HTTP")
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_external_sink_endpoint():
    """The demo sink answers [], and a node made external with the
    server's own sink as its endpoint runs (lock-free route, no
    deadlock) to the JAX bridge's state."""
    httpd, port = _serve()
    try:
        assert _put(port, "/w/external_sink", [
            {"from": 0, "to": 3, "arrivingAt": 5, "payload": [1]}]) == []
        _post(port, "/w/network/init/PingPong", {"node_count": 32})
        _post(port, "/w/network/nodes/3/external",
              {"url": f"http://127.0.0.1:{port}/w/external_sink"})
        _post(port, "/w/network/runMs/120")
        assert _get(port, "/w/network/time") == 120
        assert _get(port, "/w/network/nodes/3")["external"]
        js = _servers()[0]
        js.init("PingPong", {"node_count": 32}, seed=0)
        js.set_external(3, lambda delivered: [])
        js.run_ms(120)
        _assert_same_state(js, httpd.sim_server, "external sink")
    finally:
        httpd.shutdown()
        httpd.server_close()
