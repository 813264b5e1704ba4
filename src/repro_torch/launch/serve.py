"""HTTP front door over the live fleet (``python -m repro_torch serve``).

A thin stdlib serving loop — ``ThreadingHTTPServer``, no framework —
fanning requests out over the same ``LiveFleet`` a ``simulate`` run of
the spec would build: real ``DynamicSpaceTimeScheduler`` replicas behind
the sim routers, so capacity planning done in sim transfers to the
deployed shape unchanged.

Endpoints:

    GET  /healthz     liveness + fleet shape (replicas, engine, router)
    POST /v1/predict  {"tenant_id": 0, "prompt": [1,2,3]} — routed,
                      admission-controlled, blocks until the cohort the
                      request merged into completes; 429 with the
                      scheduler's reason code when admission rejects
    GET  /v1/report   the schema-versioned RunReport for traffic so far

Concurrency model: handler threads submit under one fleet lock; a single
pump thread wakes at ``min(next ripeness instant, poll_interval_s)`` and
drives dispatch. Completion is signalled per-request through the pump's
``on_complete`` hook (a ``threading.Event`` on each workload), so a
blocked handler costs one waiting thread, never a spin.

On SIGTERM/SIGINT (or server shutdown) the fleet drains and, when
``report_path`` is set, the final ``RunReport`` JSON lands there — the
serve-smoke CI contract.

    PYTHONPATH=src python -m repro_torch serve --spec examples/specs/serve_smoke.json
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.api.build import LiveRun, _augment_metrics, build_mix, build_recorder
from repro_torch.api.report import RunReport
from repro_torch.api.spec import ServeSpec

#: scheduler admission codes -> wire names (core.scheduler.admit_reason)
ADMIT_REASONS = {0: "admitted", 1: "oversubscribed", 2: "cap",
                 3: "infeasible"}


class _HttpServer(ThreadingHTTPServer):
    # socketserver's default listen backlog (5) resets connections under
    # concurrent load; predict calls block for a whole cohort, so bursts
    # of pending connects are the normal case here
    request_queue_size = 128
    daemon_threads = True


class FleetServer:
    """One live fleet + pump thread + HTTP server, owned together."""

    def __init__(self, spec: ServeSpec, device=None):
        self.spec = spec
        self.run = LiveRun(spec.system, device=device)
        self.recorder = build_recorder(spec.system)
        self.fleet, self.vocab = self.run.build_fleet(recorder=self.recorder)
        self.mix = build_mix(spec.system.workload)
        self.lock = threading.Lock()
        self.started_s = time.perf_counter()
        self.requests = 0
        self.rejected = 0
        self._stop = threading.Event()
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name="fleet-pump", daemon=True)
        self.httpd = _HttpServer(
            (spec.host, spec.port), _make_handler(self))
        self.port = self.httpd.server_address[1]

    # ------------------------------------------------------------ serving
    def predict(self, tenant_id: int, prompt, max_new_tokens=None) -> dict:
        """Route one request through the fleet and wait for its cohort."""
        spec = self.mix[tenant_id % len(self.mix)]
        done = threading.Event()
        t0 = time.perf_counter()
        with self.lock:
            self.requests += 1
            w, replica_id, admitted, reason = self.fleet.submit_one(
                spec, cost=spec.cost, payload=list(prompt or ()), done=done)
        if not admitted:
            with self.lock:
                self.rejected += 1
            return {"status": 429,
                    "error": f"admission rejected: "
                             f"{ADMIT_REASONS.get(reason, reason)}",
                    "reason": ADMIT_REASONS.get(reason, str(reason)),
                    "replica": replica_id}
        if not done.wait(self.spec.request_timeout_s):
            return {"status": 504,
                    "error": f"request did not complete within "
                             f"{self.spec.request_timeout_s:g}s",
                    "replica": replica_id}
        return {"status": 200,
                "tenant_id": spec.tenant_id,
                "tokens": w.result,
                "replica": replica_id,
                "latency_s": time.perf_counter() - t0}

    def report(self) -> RunReport:
        """Freeze the traffic served so far into a RunReport."""
        with self.lock:
            horizon = self.fleet.now() - self.fleet.start_s
            m = self.fleet.freeze(horizon)
        doc = _augment_metrics(self.spec.system, m.to_dict(), m,
                               self.recorder)
        doc["arch"] = self.spec.system.workload.arch
        doc["engine"] = self.run.engine_name
        doc["wall_s"] = time.perf_counter() - self.started_s
        doc["http"] = {"requests": self.requests, "rejected": self.rejected}
        return RunReport(executor="serve", mode="live",
                         spec=self.spec.system.to_dict(), metrics=doc)

    # ---------------------------------------------------------- lifecycle
    def _pump_loop(self) -> None:
        interval = self.spec.poll_interval_s
        while not self._stop.is_set():
            with self.lock:
                self.fleet.poll()
                t_next = self.fleet.next_ripe_time()
            now = self.fleet.now()
            delay = interval if t_next is None else max(0.0, t_next - now)
            self._stop.wait(min(delay, interval))

    def start(self) -> None:
        self._pump_thread.start()

    def serve_forever(self) -> None:
        self.start()
        try:
            self.httpd.serve_forever(poll_interval=0.2)
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        """Stop pumping, drain the fleet, persist the final report."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._pump_thread.is_alive():
            self._pump_thread.join(timeout=5.0)
        with self.lock:
            self.fleet._drain_wall_tail(
                timeout_s=self.spec.request_timeout_s)
            self.run.save_calibration(self.fleet)
        if self.spec.report_path:
            self.report().save(self.spec.report_path)
        self.httpd.server_close()


def _make_handler(server: FleetServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # stay quiet; CI parses stdout
            pass

        def _send(self, code: int, doc: dict) -> None:
            body = (json.dumps(doc, sort_keys=True) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "replicas": len(server.fleet.active),
                    "engine": server.run.engine_name,
                    "router": server.fleet.router.name,
                    "requests": server.requests,
                })
                return
            if self.path == "/v1/report":
                self._send(200, server.report().to_dict())
                return
            self._send(404, {"error": f"no route {self.path!r} (have "
                                      "/healthz, /v1/predict, /v1/report)"})

        def do_POST(self) -> None:
            if self.path != "/v1/predict":
                self._send(404, {"error": f"no route {self.path!r}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n) or b"{}")
                tenant_id = int(doc.get("tenant_id", 0))
                prompt = doc.get("prompt", [])
                if not isinstance(prompt, list):
                    raise ValueError("prompt must be a list of token ids")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            out = server.predict(tenant_id, prompt)
            self._send(out.pop("status"), out)

    return Handler


def run_server(spec: ServeSpec, ready: Optional[threading.Event] = None,
               device=None, started: Optional[list] = None) -> FleetServer:
    """Build the fleet, install signal handlers, serve until stopped.

    A real architecture's engines run on ``device``, the card unless the
    caller asks for another. ``started``, when given, receives the
    ``FleetServer`` before ``ready`` is set, so a caller that serves from
    a thread can read its port and stop it (``server.httpd.shutdown()``).
    """
    server = FleetServer(spec, device=device)
    if started is not None:
        started.append(server)
    if threading.current_thread() is threading.main_thread():
        # httpd.shutdown() blocks until serve_forever exits, and the
        # handler runs ON the serve_forever thread — hand it off or the
        # process deadlocks on its own signal
        def stop(signum, frame):
            threading.Thread(target=server.httpd.shutdown,
                             daemon=True).start()

        signal.signal(signal.SIGTERM, stop)
        signal.signal(signal.SIGINT, stop)
    w = spec.system.workload
    print(f"serving {spec.system.fleet.replicas} replica(s) of "
          f"arch={w.arch} behind router={spec.system.router.policy} "
          f"on http://{spec.host}:{server.port}", flush=True)
    if ready is not None:
        ready.set()
    server.serve_forever()
    if spec.report_path:
        print(f"wrote {spec.report_path}", flush=True)
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="HTTP serving loop over a live fleet (ServeSpec JSON)")
    ap.add_argument("--spec", required=True, help="ServeSpec JSON file")
    ap.add_argument("--port", type=int, default=None,
                    help="override serve.port")
    args = ap.parse_args(argv)
    spec = ServeSpec.load(args.spec)
    if args.port is not None:
        spec = ServeSpec.from_dict({**spec.to_dict(), "port": args.port})
    run_server(spec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
