"""REST facade over server.core.Server — WServer endpoint parity; the
port of `wittgenstein_tpu/server/http.py`, every route and payload kept.
The interactive network and the batch service run on `device` (``cuda``
unless ``--device``/``device=`` says otherwise).

Mirrors ws/WServer.java:20-100 under the same `/w` prefix using only the
standard library (the environment bakes no web framework; Spring-Boot's
role is played by ThreadingHTTPServer):

    GET  /w/protocols                      list registered protocols
    GET  /w/protocols/{name}               parameter template
    POST /w/network/init/{name}            body: parameter JSON
    POST /w/network/runMs/{ms}
    GET  /w/network/time
    GET  /w/network/nodes
    GET  /w/network/nodes/{id}
    GET  /w/network/messages               ALL in-flight deliveries
    POST /w/network/nodes/{id}/stop
    POST /w/network/nodes/{id}/start
    POST /w/network/nodes/{id}/external    body: {"url": ...} — deliveries
                                           PUT there (ExternalRest.java)
    POST /w/network/send                   body: {from, to, payload, delay}
    PUT  /w/external_sink                  demo external node: logs the
                                           EnvelopeInfo list, replies []
                                           (ws/ExternalWS.java:21-40)

Batch request plane (wittgenstein_tpu/serve — README "Simulation as a
service"; spec schema in serve/spec.py):

    POST /w/batch/submit                   body: ScenarioSpec JSON ->
                                           {"id", "status", "compile_key"};
                                           an over-budget tenant gets 429
                                           + Retry-After (+ retry_after_s
                                           in the body) instead of an
                                           unbounded queue
    GET  /w/batch/status/{id}              lifecycle + streaming progress
    GET  /w/batch/result/{id}              artifacts when done
    POST /w/batch/run                      manual queue drain
    GET  /w/batch/registry                 compile-registry hit/miss
    GET  /w/batch/tenancy                  per-tenant queue/fairness stats
    GET  /w/batch/memo                     fork/freeze memo stats
    GET  /w/batch/health                   crash-safety health: uptime,
                                           queue depths, journal lag,
                                           quarantine count, watchdog
                                           trips, chunk-wall EMA (+
                                           span-derived phase p50/p99
                                           when instrumented)
    GET  /w/batch/metrics                  Prometheus text exposition:
                                           submits/429s/retries/
                                           degradations/preemptions/
                                           quarantines/watchdog trips/
                                           lease traffic counters,
                                           queue+lag gauges, phase
                                           histograms, registry hit/
                                           miss + program gauges
    GET  /w/batch/programs                 program observatory: per-
                                           program first-launch walls,
                                           memory blocks, kernel
                                           launches, working-set ratios
                                           (catalog report; "off" when
                                           no ProgramCatalog attached)
    GET  /w/batch/stream/{id}              long-poll: blocks until the
                                           next chunk boundary, returns
                                           per-chunk totals + deltas
                                           (?after=MS&timeout=S)

Matrix plane (`matrix/`; grid schema in matrix/grid.py), as the JAX
package serves it:

    POST /w/matrix/submit                  body: SweepGrid JSON ->
                                           {"id", "grid_digest", "cells",
                                            "planned_compiles"}
    GET  /w/matrix/status/{id}             lifecycle + cells done /
                                           program builds / wall
    GET  /w/matrix/report/{id}             the MatrixReport artifact
    POST /w/matrix/run/{id}                manual synchronous drive

Adaptive boundary search (`matrix/search.py`; spec schema in
SearchSpec):

    POST /w/matrix/search/submit           body: SearchSpec JSON ->
                                           {"id", "search_digest",
                                            "slices", "cells_exhaustive"}
    GET  /w/matrix/search/status/{id}      lifecycle + round / probes /
                                           chunks simulated
    GET  /w/matrix/search/report/{id}      the SearchReport artifact
    POST /w/matrix/search/run/{id}         manual synchronous drive

With ``--fleet-dir DIR`` the batch routes and the searches are served by
`serve.FleetService` over a shared fleet directory (serve/fleet.py's
workers run the requests); the matrix and stream routes need an
in-process scheduler and answer 400 there, as in the JAX package.

Run: python -m wittgenstein_tpu_torch.server.http [port] [--device cpu]
     [--fleet-dir DIR]
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import core


def _external_rest(url: str):
    """ExternalRest parity (wserver/ExternalRest.java:42-59): PUT the
    EnvelopeInfo list as JSON; the response body is a SendMessage list."""

    def handler(delivered):
        req = urllib.request.Request(
            url, data=json.dumps(delivered).encode(),
            headers={"Content-Type": "application/json"}, method="PUT")
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                body = resp.read()
                return json.loads(body) if body else []
        except Exception:
            return []

    return handler


class _Handler(BaseHTTPRequestHandler):
    server_version = "wittgenstein-tpu-torch"

    ROUTES = [
        ("GET", r"^/w/protocols$",
         lambda s, m, b: core.list_protocols()),
        ("GET", r"^/w/protocols/([A-Za-z0-9_]+)$",
         lambda s, m, b: core.protocol_parameters(m.group(1))),
        ("POST", r"^/w/network/init/([A-Za-z0-9_]+)$",
         lambda s, m, b: s.srv.init(m.group(1), b or {},
                                    seed=(b or {}).pop("seed", 0))),
        ("POST", r"^/w/network/runMs/(\d+)$",
         lambda s, m, b: s.srv.run_ms(int(m.group(1)))),
        ("GET", r"^/w/network/time$",
         lambda s, m, b: s.srv.time()),
        ("GET", r"^/w/network/nodes$",
         lambda s, m, b: s.srv.all_nodes()),
        ("GET", r"^/w/network/nodes/(\d+)$",
         lambda s, m, b: s.srv.node_info(int(m.group(1)))),
        ("GET", r"^/w/network/messages$",
         lambda s, m, b: s.srv.pending_messages()),
        # Demo external-node sink (ws/ExternalWS.java:21-40): logs the
        # EnvelopeInfo list it receives, replies with no messages.  Listed
        # in NO_LOCK_PATTERNS (it never touches the simulation) so a
        # simulation on the SAME server may use it as its external
        # endpoint without deadlocking run_ms.
        ("PUT", r"^/w/external_sink$",
         lambda s, m, b: s._external_sink(b)),
        ("POST", r"^/w/network/nodes/(\d+)/stop$",
         lambda s, m, b: s.srv.stop_node(int(m.group(1)))),
        ("POST", r"^/w/network/nodes/(\d+)/start$",
         lambda s, m, b: s.srv.start_node(int(m.group(1)))),
        ("POST", r"^/w/network/nodes/(\d+)/external$",
         lambda s, m, b: s.srv.set_external(
             int(m.group(1)), _external_rest((b or {})["url"]))),
        ("POST", r"^/w/network/send$",
         lambda s, m, b: s.srv.send(b["from"], b["to"], b.get("payload"),
                                    b.get("delay", 0))),
        # ---- batch request plane (wittgenstein_tpu/serve): many
        # scenario requests coalesced into few compiled device programs;
        # spec schema in serve/spec.py (README "Simulation as a
        # service").  These routes NEVER take the interactive sim lock —
        # the Service locks its own scheduler, and a multi-second batch
        # run must not block /w/network/* (nor vice versa).
        ("POST", r"^/w/batch/submit$",
         lambda s, m, b: s.batch.submit(b or {})),
        ("GET", r"^/w/batch/status/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.status(m.group(1))),
        ("GET", r"^/w/batch/result/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.result(m.group(1))),
        ("POST", r"^/w/batch/run$",
         lambda s, m, b: s.batch.run_pending()),
        ("GET", r"^/w/batch/registry$",
         lambda s, m, b: s.batch.registry_stats()),
        ("GET", r"^/w/batch/tenancy$",
         lambda s, m, b: s.batch.tenancy_stats()),
        ("GET", r"^/w/batch/memo$",
         lambda s, m, b: s.batch.memo_stats()),
        # crash-safety observability: uptime, queue depths, journal
        # lag, quarantine count, watchdog trips (Service.health)
        ("GET", r"^/w/batch/health$",
         lambda s, m, b: s.batch.health()),
        # Prometheus text exposition (serve/instrument.py) — the one
        # route that replies text/plain, not JSON (_reply branches on
        # the str return)
        ("GET", r"^/w/batch/metrics$",
         lambda s, m, b: s.batch.metrics()),
        # program observatory (obs/programs.py): per-program first-
        # launch walls, memory blocks and working-set ratios — the
        # report twin of the wtpu_program_* gauges on /w/batch/metrics
        ("GET", r"^/w/batch/programs$",
         lambda s, m, b: s.batch.programs()),
        # long-poll partial-metrics stream (?after=MS&timeout=S) —
        # lock-free like every batch route, and REQUIRED to be: the
        # poll blocks for seconds by design
        ("GET", r"^/w/batch/stream/([A-Za-z0-9_-]+)(?:\?(.*))?$",
         lambda s, m, b: s._stream(m)),
        # ---- matrix plane (wittgenstein_tpu/matrix): a whole sweep
        # grid as one request — planned at submit (400 names the bad
        # cell), driven on the batch scheduler, reported as ONE
        # cross-cell artifact.  Same no-sim-lock rule as /w/batch/*.
        ("POST", r"^/w/matrix/submit$",
         lambda s, m, b: s.batch.matrix_submit(b or {})),
        ("GET", r"^/w/matrix/status/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.matrix_status(m.group(1))),
        ("GET", r"^/w/matrix/report/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.matrix_report(m.group(1))),
        ("POST", r"^/w/matrix/run/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.matrix_run(m.group(1))),
        # ---- adaptive boundary search (matrix/search.py): a
        # SearchSpec compiles to a deterministic probe plan at submit
        # (400 on a malformed spec/grid) and the campaign drives the
        # same batch scheduler / fleet journal the matrix plane uses.
        ("POST", r"^/w/matrix/search/submit$",
         lambda s, m, b: s.batch.search_submit(b or {})),
        ("GET", r"^/w/matrix/search/status/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.search_status(m.group(1))),
        ("GET", r"^/w/matrix/search/report/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.search_report(m.group(1))),
        ("POST", r"^/w/matrix/search/run/([A-Za-z0-9_-]+)$",
         lambda s, m, b: s.batch.search_run(m.group(1))),
    ]

    # Routes that must NOT take the sim lock (keyed by the ROUTES pattern,
    # so a route rename keeps its exemption).
    NO_LOCK_PATTERNS = frozenset({
        r"^/w/external_sink$",
        r"^/w/batch/submit$",
        r"^/w/batch/status/([A-Za-z0-9_-]+)$",
        r"^/w/batch/result/([A-Za-z0-9_-]+)$",
        r"^/w/batch/run$",
        r"^/w/batch/registry$",
        r"^/w/batch/tenancy$",
        r"^/w/batch/memo$",
        r"^/w/batch/health$",
        r"^/w/batch/metrics$",
        r"^/w/batch/programs$",
        r"^/w/batch/stream/([A-Za-z0-9_-]+)(?:\?(.*))?$",
        r"^/w/matrix/submit$",
        r"^/w/matrix/status/([A-Za-z0-9_-]+)$",
        r"^/w/matrix/report/([A-Za-z0-9_-]+)$",
        r"^/w/matrix/run/([A-Za-z0-9_-]+)$",
        r"^/w/matrix/search/submit$",
        r"^/w/matrix/search/status/([A-Za-z0-9_-]+)$",
        r"^/w/matrix/search/report/([A-Za-z0-9_-]+)$",
        r"^/w/matrix/search/run/([A-Za-z0-9_-]+)$",
    })

    @property
    def srv(self) -> core.Server:
        return self.server.sim_server

    @property
    def batch(self):
        return self.server.batch_service

    def _external_sink(self, body):
        """Dummy external node (ExternalWS.java:21-40): print, reply []."""
        print(f"Received message: {body}")
        return []

    def _stream(self, m):
        """The long-poll stream route: parse the optional query string
        (?after=MS&timeout=S) and delegate to the batch service."""
        from urllib.parse import parse_qs
        qs = parse_qs(m.group(2) or "")
        after = qs.get("after", [None])[0]
        timeout = qs.get("timeout", [None])[0]
        return self.batch.stream(
            m.group(1),
            after_ms=int(after) if after is not None else None,
            timeout_s=float(timeout) if timeout is not None else 25.0)

    def _dispatch(self, method):
        body = None
        ln = int(self.headers.get("Content-Length") or 0)
        if ln:
            raw = self.rfile.read(ln) or b"{}"
            try:
                body = json.loads(raw)
            except json.JSONDecodeError as e:
                # surface as a 400, not a closed socket: the batch
                # plane's clients hand-author nontrivial JSON bodies
                self._reply(400, {"error": f"malformed JSON body: {e}"})
                return
        for meth, pattern, fn in self.ROUTES:
            if meth != method:
                continue
            m = re.match(pattern, self.path)
            if m:
                # One simulation, one lock: the engine itself is
                # single-threaded by contract (Network.java:7-11).  The
                # external_sink demo is lock-free (see NO_LOCK_PATTERNS).
                lock = (contextlib.nullcontext()
                        if pattern in self.NO_LOCK_PATTERNS
                        else self.server.sim_lock)
                with lock:
                    try:
                        result = fn(self, m, body)
                    except Exception as e:  # surface as a 400, like
                        # Spring — except admission refusals, which
                        # carry their own status (429) + retry-after so
                        # a well-behaved client backs off instead of
                        # hammering a full queue (serve AdmissionError)
                        status = getattr(e, "http_status", 400)
                        payload = {"error": str(e)}
                        headers = None
                        retry = getattr(e, "retry_after_s", None)
                        if retry is not None:
                            payload["retry_after_s"] = retry
                            headers = {"Retry-After":
                                       str(max(1, round(retry)))}
                        self._reply(status, payload, headers)
                        return
                self._reply(200, result if result is not None else {"ok": 1})
                return
        self._reply(404, {"error": f"no route {method} {self.path}"})

    def _reply(self, status, payload, headers=None):
        if isinstance(payload, str):
            # the metrics route returns pre-rendered Prometheus text;
            # every other endpoint returns a JSON-serializable object
            data = payload.encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def log_message(self, *a):  # quiet
        pass


def make_server(port: int = 0, batch_auto: bool = True,
                scheduler=None, batch_service=None,
                device=None) -> ThreadingHTTPServer:
    """`batch_auto=False` gives a manual-drain batch service (POST
    /w/batch/run runs the queue) — deterministic for tests; the default
    drains on a background worker so submits return immediately.
    `scheduler` lets an operator serve a pre-configured
    `serve.Scheduler` (tenancy policies, checkpoint_dir, ledger path)
    behind the same routes; `batch_service` replaces the whole batch
    backend.  The interactive network and a default batch service run
    on `device` (``cuda`` unless given)."""
    from ..serve import Service

    core.load_models()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    httpd.sim_server = core.Server(device=device)
    httpd.sim_lock = threading.Lock()
    httpd.batch_service = batch_service if batch_service is not None \
        else Service(scheduler=scheduler, auto=batch_auto, device=device)
    return httpd


def main(port: int = 8078, device=None, fleet_dir: str | None = None):
    svc = None
    if fleet_dir is not None:
        from ..serve.service import FleetService
        svc = FleetService(fleet_dir)
    httpd = make_server(port, batch_service=svc, device=device)
    backend = f"fleet dir {fleet_dir}" if fleet_dir else "in-process"
    print(f"wittgenstein-tpu-torch server on http://127.0.0.1:"
          f"{httpd.server_address[1]}/w ({backend}, device "
          f"{httpd.sim_server.device})")
    httpd.serve_forever()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="wittgenstein-tpu-torch HTTP server")
    ap.add_argument("port", nargs="?", type=int, default=8078)
    ap.add_argument("--device", default=None,
                    help="the device the simulations run on (default: "
                         "cuda; 'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--fleet-dir", default=None,
                    help="serve the batch routes from a shared fleet "
                         "directory (serve.FleetService) instead of an "
                         "in-process scheduler")
    a = ap.parse_args()
    main(a.port, device=a.device, fleet_dir=a.fleet_dir)
