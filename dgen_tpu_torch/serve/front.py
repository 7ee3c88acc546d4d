"""The fleet's routing front (port of ``dgen_tpu/serve/front.py``):
round-robin over READY replicas, with per-replica circuit breakers, one
failover retry, load shedding and a bounded drain.

One small HTTP process sits in front of the
:class:`~dgen_tpu_torch.serve.fleet.ReplicaSupervisor`'s replicas and owns
the client's contract:

* **Routing**: ``POST /query`` goes round-robin to a replica that is READY
  and whose breaker admits traffic. A failed forward (connection refused
  or reset, forward timeout, a replica 5xx) is retried once on another
  replica (a query is idempotent: a pure function of the banks, the
  inputs, the agent and the year), then answered 503 with Retry-After.
  The front never answers 502 or 504: every failure it generates is a
  retryable 503, so a client's only failure mode is a bounded retry loop.
  A replica's own answers (200 and 4xx) pass through byte for byte.
* **Circuit breakers**: ``FleetConfig.breaker_failures`` consecutive
  failures OPEN a replica's breaker; after ``breaker_cooldown_s`` one
  HALF_OPEN probe request is let through; its success closes the breaker,
  its failure opens it again. A hung replica leaves the rotation after a
  few timeouts.
* **Load shedding**: a scrape thread reads every replica's ``/metricz``
  each ``metricz_interval_s``; when the summed queue depth reaches
  ``shed_queue_frac`` of the summed queue capacity, new queries are
  answered 503 with Retry-After before they cost a forward.
* **Drain**: SIGTERM (or :func:`drain_front`) stops admitting queries
  (503, ``/readyz`` red), waits for the forwards in flight, then SIGTERMs
  the replicas (each drains its own batches).

The ``front_route`` fault site fires on every forward attempt, so the
fleet drill can inject routing-layer failures.
"""

from __future__ import annotations

import itertools
import json
import logging
import signal
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Dict, Optional

from dgen_tpu_torch.config import FleetConfig
from dgen_tpu_torch.resilience.faults import FaultError, fault_point
from dgen_tpu_torch.serve.fleet import HTTP_ERRORS, HTTPPool, ReplicaSupervisor, http_json
from dgen_tpu_torch.serve.server import InflightTracker, JsonHandler
from dgen_tpu_torch.utils import timing

logger = logging.getLogger(__name__)

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-replica admission state machine (thread safe).

    CLOSED: traffic flows; ``failures_to_open`` consecutive failures trip
    it OPEN. OPEN: no traffic until ``cooldown_s`` has passed, then exactly
    one probe request is admitted (HALF_OPEN). The probe's success closes
    it (counter reset); its failure opens it again with a fresh cooldown.
    ``clock`` is injectable so tests drive time."""

    def __init__(self, failures_to_open: int = 3, cooldown_s: float = 1.0,
                 clock=time.monotonic) -> None:
        self.failures_to_open = failures_to_open
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self.n_opened = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request go here now? An OPEN breaker past its cooldown turns
        HALF_OPEN and admits one probe, so call it only on the replica
        actually picked."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self._clock() - self._opened_at >= self.cooldown_s:
                self._state = HALF_OPEN
                return True   # the one probe
            return False      # OPEN in its cooldown, or HALF_OPEN with a probe out

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._consecutive = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN or self._consecutive >= self.failures_to_open:
                if self._state != OPEN:
                    self.n_opened += 1
                self._state = OPEN
                self._opened_at = self._clock()

    def to_json(self) -> dict:
        with self._lock:
            return {"state": self._state, "consecutive_failures": self._consecutive,
                    "times_opened": self.n_opened}


def _sum(payloads, key: str) -> int:
    return sum(int(p.get(key, 0) or 0) for p in payloads)


class FleetFront:
    """Routing, shedding and drain over a supervisor's replicas (module
    docstring). :meth:`route_query` takes and returns bytes, so it runs
    without sockets in tests; the HTTP handler is a thin shell."""

    def __init__(self, supervisor: ReplicaSupervisor,
                 config: Optional[FleetConfig] = None) -> None:
        self.sup = supervisor
        self.config = config or supervisor.config
        self.t_start = time.time()
        self._drain = InflightTracker()
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._scrape_thread: Optional[threading.Thread] = None
        #: keep-alive connections of the forwards and scrapes
        self._pool = HTTPPool()
        #: replica index -> (monotonic scrape time, /metricz payload)
        self._metricz: Dict[int, tuple] = {}
        #: replica index -> (scrape time, batches, occupancy sum) at the
        #: previous pressure() call: the windowed occupancy's baseline
        self._occ_prev: Dict[int, tuple] = {}
        self._held_occupancy = 0.0
        self._lat = timing.LogHistogram()
        # counters (under _lock)
        self.n_requests = 0
        self.n_shed = 0
        self.n_drained = 0
        self.n_retries = 0
        self.n_forward_failures = 0
        self.n_unrouted = 0

    # -- breakers ------------------------------------------------------

    def breaker(self, index: int) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(index)
            if br is None:
                br = self._breakers[index] = CircuitBreaker(
                    failures_to_open=self.config.breaker_failures,
                    cooldown_s=self.config.breaker_cooldown_s)
            return br

    # -- scrape and shed -----------------------------------------------

    def start(self) -> "FleetFront":
        """Start the /metricz scrape thread (the shed and autoscale signal)."""
        self._scrape_thread = threading.Thread(target=self._scrape_loop,
                                               name="dgen-front-scrape", daemon=True)
        self._scrape_thread.start()
        return self

    def _scrape_loop(self) -> None:
        while not self._closed.is_set():
            ready = self.sup.ready_handles()
            for h in ready:
                payload = self._scrape_one(h.port)
                if payload is not None:
                    self._metricz[h.index] = (time.monotonic(), payload)
            self._prune_replica_state()
            self._closed.wait(self.config.metricz_interval_s)

    def _scrape_one(self, port: int) -> Optional[dict]:
        try:
            status, blob, _ = http_json(port, "/metricz", timeout=2.0, pool=self._pool)
            return json.loads(blob) if status == 200 else None
        except HTTP_ERRORS:
            return None

    def _prune_replica_state(self) -> None:
        """Drop the scrapes, breakers and pooled sockets of slots that were
        retired, so a long-lived autoscaled fleet accumulates none."""
        live = self.sup.live_indices()
        for i in [i for i in list(self._metricz) if i not in live]:
            self._metricz.pop(i, None)
        with self._lock:
            for d in (self._occ_prev, self._breakers):
                for i in [i for i in d if i not in live]:
                    del d[i]
        for port in self.sup.stopped_ports():
            self._pool.drop(port)

    def _fresh(self) -> Dict[int, tuple]:
        """(scrape time, payload) of scrapes younger than three intervals,
        of replicas READY now."""
        now = time.monotonic()
        horizon = 3.0 * self.config.metricz_interval_s
        ready = {h.index for h in self.sup.ready_handles()}
        # one atomic copy: the scrape thread inserts concurrently
        snap = dict(self._metricz)
        return {i: tp for i, tp in snap.items() if i in ready and now - tp[0] <= horizon}

    def _fresh_metricz(self) -> Dict[int, dict]:
        return {i: p for i, (_t, p) in self._fresh().items()}

    def shed_now(self) -> bool:
        """Shed when the READY replicas' summed queue depth reaches
        ``shed_queue_frac`` of their summed capacity; never without a fresh
        signal."""
        fresh = self._fresh_metricz().values()
        cap = _sum(fresh, "max_queue")
        return cap > 0 and _sum(fresh, "queue_depth") >= self.config.shed_queue_frac * cap

    def pressure(self) -> Optional[dict]:
        """The autoscaler's signal: the queue fraction now and the batch
        occupancy over the batches dispatched since the previous call's
        scrapes (the replicas report lifetime means, which never decay; no
        new batch in the window is zero occupancy; a call between scrapes
        holds the last value). None without a fresh signal."""
        fresh = self._fresh()
        if not fresh:
            return None
        payloads = [p for _t, p in fresh.values()]
        depth, cap = _sum(payloads, "queue_depth"), _sum(payloads, "max_queue")
        d_batches, d_occ_sum, saw_new = 0, 0.0, False
        with self._lock:   # against the scrape thread's pruning
            for i, (t, p) in fresh.items():
                prev_t, pb, po = self._occ_prev.get(i, (None, 0, 0.0))
                if prev_t is not None and t == prev_t:
                    continue   # the same scrape as the previous call
                saw_new = True
                batches = int(p.get("batches", 0) or 0)
                occ_sum = float(p.get("batch_occupancy") or 0.0) * batches
                if batches >= pb:   # a restarted replica resets its counters
                    d_batches += batches - pb
                    d_occ_sum += occ_sum - po
                self._occ_prev[i] = (t, batches, occ_sum)
            if saw_new:
                occ = d_occ_sum / d_batches if d_batches > 0 else 0.0
                self._held_occupancy = max(occ, 0.0)
            held = self._held_occupancy
        return {"queue_frac": depth / cap if cap else 0.0, "occupancy": held,
                "window_batches": d_batches, "ready_replicas": len(fresh)}

    # -- routing -------------------------------------------------------

    def _pick(self, exclude: set):
        """The next routable replica in round-robin order whose breaker
        admits (``allow()`` only on the one picked: a HALF_OPEN probe is
        not spent by looking)."""
        handles = sorted((h for h in self.sup.ready_handles() if h.index not in exclude),
                         key=lambda h: h.index)
        if not handles:
            return None
        start = next(self._rr)
        for k in range(len(handles)):
            h = handles[(start + k) % len(handles)]
            if self.breaker(h.index).allow():
                return h
        return None

    def _forward(self, h, raw: bytes) -> tuple:
        status, blob, _ = http_json(h.port, "/query", method="POST", body=raw,
                                    timeout=self.config.request_timeout_s, pool=self._pool)
        return status, blob

    @staticmethod
    def _blob(payload: dict) -> bytes:
        return json.dumps(payload).encode("utf-8")

    def _retry_after(self) -> Dict[str, str]:
        s = float(self.config.retry_after_s)
        return {"Retry-After": str(int(s) if s.is_integer() else s)}

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def route_query(self, raw: bytes) -> tuple:
        """(status, body bytes, extra headers) of one client /query."""
        t0 = time.monotonic()
        self._count("n_requests")
        if self.draining:
            self._count("n_drained")
            return 503, self._blob({"error": "fleet is draining", "retry": True,
                                    "draining": True}), self._retry_after()
        if self.shed_now():
            self._count("n_shed")
            return 503, self._blob({"error": "fleet overloaded; shedding load",
                                    "retry": True, "shed": True}), self._retry_after()
        self._drain.enter()
        try:
            tried: set = set()
            last_err = None
            for attempt in range(2):   # the first try and one on another replica
                h = self._pick(tried)
                if h is None:
                    break
                tried.add(h.index)
                if attempt:
                    self._count("n_retries")
                br = self.breaker(h.index)
                try:
                    # a routing-layer failure before the replica saw anything:
                    # charged to this replica's breaker like a transport error
                    fault_point("front_route")
                    code, blob = self._forward(h, raw)
                except (FaultError, *HTTP_ERRORS) as e:
                    br.record_failure()
                    self._count("n_forward_failures")
                    last_err = f"{type(e).__name__}: {e}"
                    continue
                if code == 503:
                    # alive but shedding or draining: not a breaker failure
                    br.record_success()
                    last_err = "replica 503"
                    continue
                if code >= 500:
                    br.record_failure()
                    self._count("n_forward_failures")
                    last_err = f"replica {code}"
                    continue
                br.record_success()
                self._lat.record(time.monotonic() - t0)
                return code, blob, {}
            self._count("n_unrouted")
            self._lat.record(time.monotonic() - t0)
            return 503, self._blob({"error": "no replica available", "retry": True,
                                    "detail": last_err}), self._retry_after()
        finally:
            self._drain.exit()

    # -- probe endpoints -----------------------------------------------

    def _routable(self) -> bool:
        return bool(self.sup.ready_handles()) and not self.draining

    def healthz(self) -> dict:
        return {
            "status": "ok",
            "live": True,
            "role": "fleet-front",
            "ready": self._routable(),
            "draining": self.draining,
            "uptime_s": round(time.time() - self.t_start, 1),
            "replicas": [{**h.summary(), "breaker": self.breaker(h.index).to_json()}
                         for h in self.sup.replicas],
            "events_tail": list(self.sup.events)[-20:],
        }

    def readyz(self) -> tuple:
        ok = self._routable()
        return (200 if ok else 503), {"ready": ok,
                                      "ready_replicas": len(self.sup.ready_handles()),
                                      "draining": self.draining}

    def metricz(self) -> dict:
        """The fleet's aggregate: summed queue depths, batch-weighted
        occupancy, surface and result-cache hits, the front's counters and
        latency, and each replica's breaker and last scrape."""
        fresh = self._fresh_metricz()
        payloads = list(fresh.values())
        batches = _sum(payloads, "batches")
        w_occ = (sum(float(p.get("batch_occupancy") or 0.0) * int(p.get("batches", 0) or 0)
                     for p in payloads) / batches) if batches else None
        cache = {"hits": 0, "misses": 0, "stores": 0, "evictions": 0}
        for p in payloads:
            rc = p.get("result_cache") or {}
            for k in cache:
                cache[k] += int(rc.get(k, 0) or 0)
        with self._lock:
            counters = {"requests": self.n_requests, "shed": self.n_shed,
                        "drained": self.n_drained, "retries": self.n_retries,
                        "forward_failures": self.n_forward_failures,
                        "unrouted": self.n_unrouted}
        snap = self._lat.snapshot()
        return {
            "role": "fleet-front",
            "ready_replicas": len(self.sup.ready_handles()),
            "n_replicas": self.sup.live_count(),
            "queue_depth": _sum(payloads, "queue_depth"),
            "queue_capacity": _sum(payloads, "max_queue"),
            "surface_hits": _sum(payloads, "surface_hits"),
            "result_cache": cache,
            "http_pool": self._pool.stats(),
            "occupancy_weighted": round(w_occ, 4) if w_occ is not None else None,
            "draining": self.draining,
            "shedding": self.shed_now(),
            **counters,
            "latency_ms": {k: round(snap[k] * 1e3, 3) for k in ("p50", "p90", "p99")}
            | {"count": snap["count"]},
            "replicas": {str(h.index): {"state": h.state,
                                        "breaker": self.breaker(h.index).to_json(),
                                        "metricz": fresh.get(h.index)}
                         for h in self.sup.replicas},
        }

    # -- drain and shutdown --------------------------------------------

    @property
    def draining(self) -> bool:
        return self._drain.draining

    @property
    def inflight(self) -> int:
        return self._drain.inflight

    def begin_drain(self) -> None:
        self._drain.begin_drain()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        return self._drain.wait_idle(timeout)

    def close(self) -> None:
        self._closed.set()
        self._pool.close()


class _FrontHandler(JsonHandler):
    """Thin HTTP shell over :class:`FleetFront`."""

    @property
    def front(self) -> FleetFront:
        return self.server.front  # type: ignore[attr-defined]

    def _socket_timeout_s(self) -> float:
        # a front request spans up to two forward attempts
        return 2.0 * self.front.config.request_timeout_s + 5.0

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        if self.path == "/healthz":
            self._send(200, self.front.healthz())
        elif self.path == "/readyz":
            self._send(*self.front.readyz())
        elif self.path == "/metricz":
            self._send(200, self.front.metricz())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 - http.server contract
        raw = self._read_body()
        if raw is None:
            return
        if self.path != "/query":
            self._send(404, {"error": f"no route {self.path}"})
            return
        code, blob, headers = self.front.route_query(raw)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(blob)


def make_front_server(front: FleetFront) -> ThreadingHTTPServer:
    """Bind the front's HTTP server (port 0: an ephemeral port)."""
    srv = ThreadingHTTPServer((front.config.host, front.config.port), _FrontHandler)
    srv.daemon_threads = True
    srv.front = front  # type: ignore[attr-defined]
    return srv


def start_front_in_thread(front: FleetFront) -> ThreadingHTTPServer:
    """Serve the front on a daemon thread; returns the bound server."""
    srv = make_front_server(front)
    threading.Thread(target=srv.serve_forever, name="dgen-front-http",
                     daemon=True).start()
    return srv


def drain_front(front: FleetFront, srv: ThreadingHTTPServer, stop_fleet: bool = True,
                timeout: Optional[float] = None) -> bool:
    """Fleet-wide drain: stop admitting at the front, wait for the forwards
    in flight, SIGTERM the replicas (each drains its batches), stop the
    accept loop. True when everything in flight finished inside the
    bound."""
    timeout = timeout if timeout is not None else front.config.drain_timeout_s
    front.begin_drain()
    idle = front.wait_idle(timeout)
    if stop_fleet:
        front.sup.stop(drain=True, timeout=timeout)
    front.close()
    srv.shutdown()
    return idle


def install_sigterm_drain_front(front: FleetFront, srv: ThreadingHTTPServer) -> None:
    """SIGTERM drains the whole fleet (on a helper thread). Call from the
    main thread."""

    def _on_term(signum, frame) -> None:
        logger.info("fleet front: SIGTERM, draining the fleet")
        threading.Thread(target=drain_front, args=(front, srv),
                         name="dgen-front-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
