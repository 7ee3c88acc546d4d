"""Threaded JSON-over-HTTP front-end of the serving engine (port of
``dgen_tpu/serve/server.py``).

Standard library only (``http.server``). One process (a single server,
or one replica of the fleet, :mod:`dgen_tpu_torch.serve.fleet`) serves:

  * ``POST /query``   {"agent_ids": [...], "year": 2026,
                       "overrides": {"scale": {"itc_fraction": 0.5}},
                       "cash_flow": false}
                      -> {"year": ..., "results": [{...} per agent]}
  * ``GET  /healthz`` liveness, with the provenance stamp
                      (``io.export.provenance_stamp``: git sha, config
                      hash, backend, device count), warm buckets and the
                      boot report (warmup wall, the kernel-library builds
                      and loads during warmup), and who answers (pid,
                      ``replica_index``)
  * ``GET  /readyz``  readiness: 200 only once warmup completed and some
                      bucket is warm, and while not draining
  * ``GET  /metricz`` p50/p99 request latency, queue depth, batch
                      occupancy, surface and cache counters, and
                      ``steady_state_compiles``: the kernel-library builds
                      and loads (``ops._build.EVENTS``) since warmup, which
                      stay 0 (the JAX package counts XLA compiles there),
                      and this process's kernel launches

Status codes: 400 for an unknown or non-integral id, an off-grid year or
a bad override; 422 with the reasons for a quarantined agent; 503 (with
Retry-After) for a full queue and while draining; 504 past the request
deadline; 500 when the batch failed (a kernel that does not build or
launch among it: the answer is never a plain-version one).

Every way a request can hold a handler thread is bounded: the
per-connection socket timeout (``ServeConfig.socket_timeout_s``) and the
per-request deadline (``ServeConfig.request_timeout_s``, 504, the queued
future cancelled). :func:`drain` stops admitting queries, waits for those
in flight, flushes the batcher and stops the accept loop;
:func:`install_sigterm_drain` wires it to SIGTERM.
"""

from __future__ import annotations

import json
import logging
import math
import os
import signal
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from dgen_tpu_torch.config import ServeConfig
from dgen_tpu_torch.io.export import provenance_stamp
from dgen_tpu_torch.ops import _build, billkernels, dispatch
from dgen_tpu_torch.resilience import faults as faults_mod
from dgen_tpu_torch.resilience.quarantine import QuarantinedAgentError
from dgen_tpu_torch.serve.batcher import BATCH_WALL, Microbatcher, QueueFullError
from dgen_tpu_torch.serve.engine import QUERY_FIELDS, OverrideError, ServeEngine
from dgen_tpu_torch.utils import timing

logger = logging.getLogger(__name__)

#: request-body cap: a /query of max_batch agents with overrides is a few KB
_MAX_BODY_BYTES = 1 << 20

#: Retry-After of the 503s (queue full, draining); the fleet front has its
#: own (FleetConfig.retry_after_s)
_RETRY_AFTER_S = 1

#: the replica index of a fleet-spawned process (set by serve.fleet;
#: stamped into /healthz and /metricz)
REPLICA_ENV = "DGEN_TPU_SERVE_REPLICA"


class DrainingError(RuntimeError):
    """The process is draining: no new query is admitted (HTTP 503)."""


class InflightTracker:
    """Drain bookkeeping shared by a serving process and the fleet front:
    count requests in flight, flip a draining flag, and wait (bounded) for
    the count to reach zero."""

    def __init__(self) -> None:
        self.draining = False
        self._inflight = 0
        self._cv = threading.Condition()

    def begin_drain(self) -> None:
        self.draining = True

    def enter(self) -> None:
        with self._cv:
            self._inflight += 1

    def exit(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """True once nothing is in flight; False when the timeout lapses."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True


def _num(v) -> "float | None":
    """JSON-safe float: a non-finite value becomes null."""
    f = float(v)
    return f if math.isfinite(f) else None


def rows_to_json(out: Dict[str, np.ndarray], cash_flow: bool) -> list:
    """Columnar engine results -> per-agent JSON rows (the JAX package's
    ``_rows_to_json``)."""
    rows = []
    for i in range(out["agent_id"].shape[0]):
        row = {}
        for f in QUERY_FIELDS:
            if f == "cash_flow":
                if cash_flow:
                    row[f] = [_num(x) for x in out[f][i]]
                continue
            v = out[f][i]
            row[f] = int(v) if f == "agent_id" else _num(v)
        rows.append(row)
    return rows


def _library_events() -> dict:
    return dict(_build.EVENTS)


def _env_replica_index() -> Optional[int]:
    raw = os.environ.get(REPLICA_ENV, "").strip()
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


class ServeApp:
    """The server's state: engine, batcher and provenance, shared by every
    handler thread.

    ``defer_warmup=True`` skips warmup at construction, so the socket can
    bind (and /healthz answer) first; the caller then runs
    :meth:`warmup_now`, and /readyz stays 503 until it has.
    ``replica_index``: the fleet replica this process is (default: the
    ``DGEN_TPU_SERVE_REPLICA`` variable; None for a single process)."""

    def __init__(self, engine: ServeEngine, config: Optional[ServeConfig] = None,
                 replica_index: Optional[int] = None,
                 defer_warmup: bool = False) -> None:
        self.engine = engine
        self.config = config or ServeConfig()
        self.batcher = Microbatcher(engine, self.config)
        self.t_start = time.time()
        self.replica_index = (replica_index if replica_index is not None
                              else _env_replica_index())
        self._drain = InflightTracker()
        self.boot_report: dict = {}
        self._warmup_done = not self.config.warmup
        # kernel-library events counted from here (warmup moves it); with
        # warmup off, counted from the start
        self._events_base = _library_events()
        self._closed = False
        # one stamp at construction: /healthz stays free of subprocesses
        self.provenance = provenance_stamp(engine.sim.run_config, engine.sim.scenario,
                                           self.config, device=engine.device)
        if self.config.warmup and not defer_warmup:
            self.warmup_now()

    # -- boot ----------------------------------------------------------

    def warmup_now(self) -> None:
        """Run every bucket once, recording the boot report (warmup wall,
        the kernel-library builds and loads it made). Idempotent."""
        if self._warmup_done:
            return
        t0 = time.time()
        before = _library_events()
        self.engine.warmup(self.config.buckets)
        wall = time.time() - t0
        after = _library_events()
        self.boot_report = {
            "warmup_s": round(wall, 3),
            "buckets": list(self.config.buckets),
            "kernel_library": {k: after[k] - before[k] for k in after},
        }
        self._events_base = after
        self._warmup_done = True
        logger.info("serve warmup: %d buckets in %.1fs (kernel library builds %d, "
                    "loads %d)", len(self.config.buckets), wall,
                    after["builds"] - before["builds"], after["loads"] - before["loads"])

    @property
    def steady_state_compiles(self) -> int:
        """Kernel-library builds and loads since warmup (0 in a steady
        state: every kernel was built and loaded by the warmup)."""
        now = _library_events()
        return sum(now[k] - self._events_base[k] for k in now)

    @property
    def ready(self) -> bool:
        """Routable: warmup complete, a bucket warm, and not draining."""
        return self._warmup_done and bool(self.engine.warm_buckets) and not self.draining

    # -- endpoint bodies (transport-independent) -----------------------

    def identity(self) -> dict:
        """Who answers: stamped into /healthz and /metricz, so a fleet
        operator can tell replicas apart."""
        return {
            "pid": os.getpid(),
            "replica_index": self.replica_index,
            "boot_time_unix": round(self.t_start, 3),
            "uptime_s": round(time.time() - self.t_start, 1),
        }

    def healthz(self) -> dict:
        return {
            "status": "ok",
            "live": True,
            "ready": self.ready,
            "draining": self.draining,
            "n_agents": self.engine.n_agents,
            "years": self.engine.years,
            "buckets": list(self.config.buckets),
            "warm_buckets": sorted(self.engine.warm_buckets),
            "boot": self.boot_report,
            **self.identity(),
            **self.provenance,
        }

    def readyz(self) -> tuple:
        """(status code, payload): 200 only when routable."""
        ok = self.ready
        return (200 if ok else 503), {
            "ready": ok,
            "draining": self.draining,
            "warmup_done": self._warmup_done,
            "warm_buckets": sorted(self.engine.warm_buckets),
        }

    def metricz(self) -> dict:
        rec = self.batcher.stats()
        batch = timing.histogram(BATCH_WALL)
        if batch is not None:
            snap = batch.snapshot()
            rec["batch_wall_ms"] = {"p50": round(snap["p50"] * 1e3, 3),
                                    "p99": round(snap["p99"] * 1e3, 3),
                                    "count": snap["count"]}
        rec.update(self.identity())
        rec["draining"] = self.draining
        if self._warmup_done:
            rec["steady_state_compiles"] = self.steady_state_compiles
        rec["kernel_launches"] = {k: v for k, v in {**billkernels.LAUNCHES,
                                                    **dispatch.LAUNCHES}.items() if v}
        reg = faults_mod.active()
        if reg is not None:
            rec["faults_fired"] = {s: reg.fired(s) for s in faults_mod.SITES
                                   if reg.fired(s)}
        return rec

    @property
    def draining(self) -> bool:
        return self._drain.draining

    def run_query(self, body: dict) -> dict:
        if self.draining:
            raise DrainingError("the server is draining; retry elsewhere")
        self._drain.enter()
        try:
            agent_ids = body.get("agent_ids")
            if not isinstance(agent_ids, list) or not agent_ids:
                raise ValueError("'agent_ids' must be a non-empty list")
            year = body.get("year")
            fut = self.batcher.submit(agent_ids, year, body.get("overrides"))
            try:
                out = fut.result(self.config.request_timeout_s)
            except FutureTimeout:
                # a request still queued is dropped, not run after the stall
                fut.cancel()
                raise
            return {
                "year": self.engine.years[self.engine.year_index(year)],
                "results": rows_to_json(out, bool(body.get("cash_flow"))),
            }
        finally:
            self._drain.exit()

    # -- drain / shutdown ----------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting queries (503, /readyz red); requests in flight
        run on."""
        self._drain.begin_drain()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        return self._drain.wait_idle(timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.batcher.close()


class JsonHandler(BaseHTTPRequestHandler):
    """The JSON plumbing of a serving process's handler and the fleet
    front's: the per-connection socket timeout, JSON answers with extra
    headers, body reads that never desync a keep-alive stream, quiet
    logging."""

    protocol_version = "HTTP/1.1"
    #: Nagle and delayed ACKs cost ~40 ms a keep-alive POST on loopback (the
    #: fleet's client side sets TCP_NODELAY too)
    disable_nagle_algorithm = True

    def _socket_timeout_s(self) -> float:
        raise NotImplementedError

    def setup(self) -> None:
        # a client that stops sending (or never reads) releases the thread
        self.timeout = self._socket_timeout_s()
        super().setup()

    def _send(self, code: int, payload: dict, close: bool = False,
              headers: Optional[Dict[str, str]] = None) -> None:
        blob = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if close:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(blob)

    def _read_body(self) -> Optional[bytes]:
        """The POST body, or None when a refusal was sent. A refusal that
        leaves body bytes unread closes the connection, so the stream
        never desyncs."""
        if self.headers.get("Transfer-Encoding"):
            self._send(411, {"error": "Content-Length required"}, close=True)
            return None
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._send(400, {"error": "bad Content-Length"}, close=True)
            return None
        if length > _MAX_BODY_BYTES:
            self._send(413, {"error": "request body too large"}, close=True)
            return None
        return self.rfile.read(length)

    def log_message(self, fmt: str, *args) -> None:
        logger.debug("serve http: " + fmt, *args)


class _Handler(JsonHandler):
    """Routes to the :class:`ServeApp` attached to the server."""

    @property
    def app(self) -> ServeApp:
        return self.server.app  # type: ignore[attr-defined]

    def _socket_timeout_s(self) -> float:
        return self.app.config.socket_timeout_s

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        if self.path == "/healthz":
            self._send(200, self.app.healthz())
        elif self.path == "/readyz":
            code, payload = self.app.readyz()
            self._send(code, payload)
        elif self.path == "/metricz":
            self._send(200, self.app.metricz())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 - http.server contract
        raw = self._read_body()
        if raw is None:
            return
        if self.path != "/query":
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            body = json.loads(raw or b"{}")
            self._send(200, self.app.run_query(body))
        except QueueFullError as e:
            self._send(503, {"error": str(e), "retry": True},
                       headers={"Retry-After": str(_RETRY_AFTER_S)})
        except DrainingError as e:
            self._send(503, {"error": str(e), "retry": True, "draining": True},
                       headers={"Retry-After": str(_RETRY_AFTER_S)})
        except QuarantinedAgentError as e:
            # the agent exists but its data was contained at load
            self._send(422, {"error": str(e),
                             "quarantine": {"agent_id": e.agent_id,
                                            "reasons": e.reasons}})
        except (KeyError, ValueError, OverrideError) as e:
            # KeyError's str() quotes its message again; unwrap it
            msg = e.args[0] if isinstance(e, KeyError) and e.args else str(e)
            self._send(400, {"error": str(msg)})
        except FutureTimeout:
            self._send(504, {"error": "query timed out"})
        except Exception as e:  # noqa: BLE001 - a handler always answers
            logger.exception("serve /query failed")
            self._send(500, {"error": str(e)})


def make_server(app: ServeApp) -> ThreadingHTTPServer:
    """Bind a threaded HTTP server (port 0: an ephemeral port)."""
    srv = ThreadingHTTPServer((app.config.host, app.config.port), _Handler)
    srv.daemon_threads = True
    srv.app = app  # type: ignore[attr-defined]
    return srv


def drain(app: ServeApp, srv: ThreadingHTTPServer, timeout: float = 30.0) -> bool:
    """Graceful drain: stop admitting queries, wait for those in flight
    (bounded by ``timeout``), flush the batcher, stop the accept loop.
    True when everything in flight finished inside the bound."""
    app.begin_drain()
    idle = app.wait_idle(timeout)
    app.close()
    srv.shutdown()
    return idle


def install_sigterm_drain(app: ServeApp, srv: ThreadingHTTPServer,
                          timeout: float = 30.0) -> None:
    """SIGTERM drains (on a helper thread, so the handler returns at
    once). Call from the main thread."""

    def _on_term(signum, frame) -> None:
        logger.info("serve: SIGTERM, draining (timeout %.1fs)", timeout)
        threading.Thread(target=drain, args=(app, srv, timeout),
                         name="dgen-serve-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)


def serve_forever(app: ServeApp, srv: Optional[ThreadingHTTPServer] = None,
                  drain_timeout_s: float = 30.0) -> None:
    """Serve until SIGINT (at once) or SIGTERM (drained); closes the
    batcher on the way out."""
    if srv is None:
        srv = make_server(app)
    host, port = srv.server_address[:2]
    install_sigterm_drain(app, srv, timeout=drain_timeout_s)
    logger.info("dgen-tpu serve: %d agents, years %s-%s, buckets %s on http://%s:%d "
                "(/query /healthz /readyz /metricz)", app.engine.n_agents,
                app.engine.years[0], app.engine.years[-1], list(app.config.buckets),
                host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("serve: shutting down")
    finally:
        srv.server_close()
        app.close()


def start_in_thread(app: ServeApp) -> ThreadingHTTPServer:
    """Serve on a daemon thread; returns the bound server
    (``server_address`` carries the port)."""
    srv = make_server(app)
    threading.Thread(target=srv.serve_forever, name="dgen-serve-http",
                     daemon=True).start()
    return srv
