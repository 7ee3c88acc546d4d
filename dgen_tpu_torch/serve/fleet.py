"""ReplicaSupervisor: N serving replicas, kept alive and routable (port of
``dgen_tpu/serve/fleet.py``).

One serving process is one preemption away from zero capacity. The
supervisor turns ``python -m dgen_tpu_torch.serve`` into a fleet: it
spawns N replica processes (each holds its own CUDA context, table and
banks on the one card), gates each on **readiness** (a replica is
routable only once its ``/readyz`` says warmup is complete; replicas
load the kernel library the first one built, ``ops._build``), restarts
dead replicas under the resilience layer's
:class:`~dgen_tpu_torch.resilience.supervisor.RetryPolicy` backoff, and
refuses to feed a crash loop (more than ``FleetConfig.max_restarts``
deaths inside ``restart_window_s`` marks the replica FAILED).

Replica discovery is a **portfile**: each replica binds an ephemeral
port (``--port 0``), then atomically writes
``<fleet_dir>/replica-<i>.json`` (pid, port); the supervisor polls for
the file, then polls ``/readyz`` until green. The file appears only after
the socket is bound.

Lifecycle per replica::

    SPAWNING --portfile--> BOOTING --/readyz 200--> READY
        |                     |                       |
        +----- process death / boot timeout ----------+
                              |
                    BACKOFF (RetryPolicy) --> SPAWNING ...
                              |
                    FAILED (crash-loop breaker tripped)

The routing front (:mod:`dgen_tpu_torch.serve.front`) routes over
:meth:`ReplicaSupervisor.ready_handles`; the fleet drill (``python -m
dgen_tpu_torch.resilience drill --serve-fleet``) shoots at it.
Supervision is process and socket work only: this module runs nothing on
the card.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from dgen_tpu_torch.config import FleetConfig
from dgen_tpu_torch.resilience.supervisor import RetryPolicy
from dgen_tpu_torch.serve.server import REPLICA_ENV

logger = logging.getLogger(__name__)

# replica lifecycle states
SPAWNING = "spawning"   # process launched, portfile not yet written
BOOTING = "booting"     # port known, /readyz not yet green
READY = "ready"         # routable
BACKOFF = "backoff"     # dead, restart scheduled
FAILED = "failed"       # crash-loop breaker tripped; no more restarts
STOPPED = "stopped"     # shut down by the supervisor (retired or stopped)

#: replicas are children of this process: discovery and probes are
#: loopback only, whatever interface the front binds
REPLICA_HOST = "127.0.0.1"

#: every transport failure a local HTTP call can raise, one tuple for the
#: probes, the front's forwards and scrapes and the drill's clients (a
#: replica dying mid-response raises BadStatusLine, an HTTPException, not
#: an OSError)
HTTP_ERRORS = (OSError, http.client.HTTPException, ValueError)

#: the checkout root, put on a replica's PYTHONPATH so that ``python -m
#: dgen_tpu_torch.serve`` imports this package from any working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _NoDelayHTTPConnection(http.client.HTTPConnection):
    """HTTPConnection with Nagle off: http.client sends headers and body
    apart, and Nagle with delayed ACKs stalls a keep-alive POST ~40 ms a
    hop on loopback."""

    def connect(self):
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


def http_json(port: int, path: str, *, method: str = "GET",
              body: Optional[bytes] = None, timeout: float = 5.0,
              host: str = REPLICA_HOST, pool: Optional["HTTPPool"] = None) -> tuple:
    """One HTTP request to a local replica or front: ``(status, raw body,
    headers dict)``. Transport failures raise members of
    :data:`HTTP_ERRORS`. Without ``pool``: a fresh connection, closed
    after the answer; with one, a pooled keep-alive connection."""
    if pool is not None:
        return pool.request(port, path, method=method, body=body, timeout=timeout,
                            host=host)
    conn = _NoDelayHTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body is not None
                     else {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


class HTTPPool:
    """Keep-alive connection pool of the loopback serving mesh (thread
    safe): per-(host, port) stacks of idle connections, at most
    ``max_idle`` each; an answer with ``Connection: close`` or a transport
    error closes its connection; a **reused** connection that fails
    mid-request (the server closed it while idle) is retried once on a
    fresh one, which is not a replica failure. A fresh connection's
    failure, and any timeout, propagates."""

    def __init__(self, max_idle: int = 8) -> None:
        self.max_idle = int(max_idle)
        self._idle: Dict[tuple, List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.n_requests = 0
        self.n_created = 0
        self.n_reused = 0
        self.n_stale_retries = 0

    def _checkout(self, key: tuple, timeout: float):
        with self._lock:
            stack = self._idle.get(key)
            conn = stack.pop() if stack else None
            if conn is not None:
                self.n_reused += 1
            else:
                self.n_created += 1
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        return _NoDelayHTTPConnection(key[0], key[1], timeout=timeout), False

    def _checkin(self, key: tuple, conn) -> None:
        with self._lock:
            if not self._closed:
                stack = self._idle.setdefault(key, [])
                if len(stack) < self.max_idle:
                    stack.append(conn)
                    return
        conn.close()

    @staticmethod
    def _once(conn, method: str, path: str, body: Optional[bytes]) -> tuple:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"} if body is not None
                     else {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders()), r.will_close

    def request(self, port: int, path: str, *, method: str = "GET",
                body: Optional[bytes] = None, timeout: float = 5.0,
                host: str = REPLICA_HOST) -> tuple:
        key = (host, port)
        with self._lock:
            self.n_requests += 1
        conn, reused = self._checkout(key, timeout)
        try:
            status, blob, headers, will_close = self._once(conn, method, path, body)
        except HTTP_ERRORS as e:
            conn.close()
            # retry only a reused connection the server closed while idle; a
            # timeout means the replica got the request and hangs
            if not reused or isinstance(e, TimeoutError):
                raise
            with self._lock:
                self.n_stale_retries += 1
                self.n_created += 1
            conn = _NoDelayHTTPConnection(host, port, timeout=timeout)
            try:
                status, blob, headers, will_close = self._once(conn, method, path, body)
            except HTTP_ERRORS:
                conn.close()
                raise
        if will_close:
            conn.close()
        else:
            self._checkin(key, conn)
        return status, blob, headers

    def drop(self, port: int, host: str = REPLICA_HOST) -> None:
        """Close every idle connection to one endpoint (its replica died or
        was retired)."""
        with self._lock:
            stack = self._idle.pop((host, port), [])
        for c in stack:
            c.close()

    def stats(self) -> dict:
        with self._lock:
            return {"requests": self.n_requests, "created": self.n_created,
                    "reused": self.n_reused, "stale_retries": self.n_stale_retries,
                    "idle": sum(len(s) for s in self._idle.values())}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            stacks = list(self._idle.values())
            self._idle = {}
        for s in stacks:
            for c in s:
                c.close()


@dataclasses.dataclass
class ReplicaHandle:
    """One replica slot's state (the supervisor writes it; readers take
    snapshots under the supervisor's lock)."""

    index: int
    portfile: str
    state: str = SPAWNING
    proc: Optional[subprocess.Popen] = None
    port: Optional[int] = None
    pid: Optional[int] = None
    #: completed spawns (0 on the first; ``env_for`` sees it, so a drill can
    #: arm faults on incarnation 0 only)
    spawn_count: int = 0
    spawned_at: float = 0.0
    #: spawn to READY of the latest incarnation
    boot_wall_s: Optional[float] = None
    restart_at: Optional[float] = None
    deaths: deque = dataclasses.field(default_factory=lambda: deque(maxlen=64))
    exit_codes: List[int] = dataclasses.field(default_factory=list)
    last_death_at: Optional[float] = None
    #: last death to READY again (the failover recovery wall)
    last_recovery_s: Optional[float] = None

    def summary(self) -> dict:
        return {
            "index": self.index,
            "state": self.state,
            "port": self.port,
            "pid": self.pid,
            "spawn_count": self.spawn_count,
            "deaths": len(self.deaths),
            "exit_codes": list(self.exit_codes),
            "boot_wall_s": (round(self.boot_wall_s, 3)
                            if self.boot_wall_s is not None else None),
            "last_recovery_s": (round(self.last_recovery_s, 3)
                                if self.last_recovery_s is not None else None),
        }


def default_replica_cmd(serve_args: Sequence[str]) -> Callable[[int, str], List[str]]:
    """The replica command: ``python -m dgen_tpu_torch.serve --replica-index
    I --port 0 --portfile F <serve_args>``."""

    def cmd_for(index: int, portfile: str) -> List[str]:
        return [sys.executable, "-m", "dgen_tpu_torch.serve",
                "--replica-index", str(index), "--port", "0", "--portfile", portfile,
                *serve_args]

    return cmd_for


class ReplicaSupervisor:
    """Spawn, readiness-gate, monitor and restart (bounded) N replicas.

    ``cmd_for``: ``(index, portfile) -> argv``, the replica command (tests
    pass a stub; :func:`default_replica_cmd` in production). ``policy``:
    only its ``backoff_s`` schedule is used (the exit code classifies, the
    crash-loop window bounds). ``env_for``: ``(index, spawn_count) ->
    dict`` of extra environment for a spawn (the fleet drill arms fault
    specs on incarnation 0 only); ``DGEN_TPU_FAULTS`` is never inherited.
    ``fleet_dir``: portfiles and per-replica logs (default: a new temporary
    directory).
    """

    def __init__(self, cmd_for: Callable[[int, str], List[str]],
                 config: Optional[FleetConfig] = None,
                 policy: Optional[RetryPolicy] = None,
                 env_for: Optional[Callable[[int, int], Optional[dict]]] = None,
                 fleet_dir: Optional[str] = None, seed: int = 0) -> None:
        self.config = config or FleetConfig()
        self.policy = policy or RetryPolicy()
        self._cmd_for = cmd_for
        self._env_for = env_for
        self.fleet_dir = fleet_dir or tempfile.mkdtemp(prefix="dgen-fleet-")
        os.makedirs(self.fleet_dir, exist_ok=True)
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._stopping = False
        self._monitor: Optional[threading.Thread] = None
        self.events: deque = deque(maxlen=1000)
        self.replicas: List[ReplicaHandle] = [self._slot(i)
                                              for i in range(self.config.n_replicas)]

    def _slot(self, i: int) -> ReplicaHandle:
        return ReplicaHandle(index=i,
                             portfile=os.path.join(self.fleet_dir, f"replica-{i}.json"))

    # -- events --------------------------------------------------------

    def _event(self, index: int, event: str, **detail) -> None:
        self.events.append({"t": round(time.time(), 3), "replica": index,
                            "event": event, **detail})
        logger.info("fleet: replica %d %s %s", index, event, detail or "")

    # -- spawning ------------------------------------------------------

    def _spawn(self, h: ReplicaHandle) -> None:
        if os.path.exists(h.portfile):
            os.unlink(h.portfile)
        env = os.environ.copy()
        # a spec armed for this process must not reach every replica
        env.pop("DGEN_TPU_FAULTS", None)
        env[REPLICA_ENV] = str(h.index)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        extra = self._env_for(h.index, h.spawn_count) if self._env_for else None
        if extra:
            env.update({k: str(v) for k, v in extra.items()})
        log_path = os.path.join(self.fleet_dir, f"replica-{h.index}.log")
        with open(log_path, "ab") as logf:   # the child keeps its own descriptor
            h.proc = subprocess.Popen(self._cmd_for(h.index, h.portfile), stdout=logf,
                                      stderr=subprocess.STDOUT, env=env)
        h.spawn_count += 1
        h.spawned_at = time.monotonic()
        h.port = None
        h.pid = h.proc.pid
        h.state = SPAWNING
        self._event(h.index, "spawned", pid=h.proc.pid, incarnation=h.spawn_count - 1)

    def start(self) -> "ReplicaSupervisor":
        with self._lock:
            for h in self.replicas:
                self._spawn(h)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="dgen-fleet-monitor", daemon=True)
        self._monitor.start()
        return self

    # -- monitoring ----------------------------------------------------

    @staticmethod
    def _probe_ready(port: int) -> bool:
        try:
            status, _, _ = http_json(port, "/readyz", timeout=2.0)
            return status == 200
        except HTTP_ERRORS:
            # a replica dying mid-answer: unready now, the liveness poll
            # then sees the death
            return False

    def _on_death(self, h: ReplicaHandle, rc: Optional[int]) -> None:
        now = time.monotonic()
        h.deaths.append(now)
        if rc is not None:
            h.exit_codes.append(rc)
        h.last_death_at = now
        h.port = None
        window = [t for t in h.deaths if now - t <= self.config.restart_window_s]
        if len(window) > self.config.max_restarts:
            h.state = FAILED
            self._event(h.index, "crash_loop", exit_code=rc,
                        deaths_in_window=len(window))
            return
        backoff = self.policy.backoff_s(min(len(window) - 1, 6), self._rng)
        h.restart_at = now + backoff
        h.state = BACKOFF
        self._event(h.index, "died", exit_code=rc, restart_in_s=round(backoff, 3))

    @staticmethod
    def _kill_boot_timeout(h: ReplicaHandle):
        """The blocking half of a boot timeout (kill and reap, up to 10 s),
        run outside the lock."""
        if h.proc is None:
            return None
        if h.proc.poll() is None:
            h.proc.kill()
            try:
                h.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass   # unkillable for now; the next tick polls again
        return h.proc.poll()

    def _tick(self) -> None:
        # readiness probes are round trips (up to 2 s): outside the lock, so
        # the front's per-request snapshot never waits on one. The monitor
        # thread is the only state writer, so a probed handle cannot change
        # state meanwhile
        with self._lock:
            to_probe = [(h, h.port) for h in self.replicas
                        if h.state == BOOTING and h.port is not None]
        probe_ok = {h.index: self._probe_ready(port) for h, port in to_probe}
        now = time.monotonic()
        timed_out = []
        with self._lock:
            for h in self.replicas:
                if h.state == STOPPED:
                    # a retired replica drains on its own; reap its exit
                    if h.proc is not None:
                        h.proc.poll()
                    continue
                if h.state in (SPAWNING, BOOTING, READY):
                    rc = h.proc.poll() if h.proc is not None else 1
                    if rc is not None:
                        self._on_death(h, rc)
                        continue
                if h.state == SPAWNING:
                    if os.path.isfile(h.portfile):
                        try:
                            with open(h.portfile) as f:
                                h.port = int(json.load(f)["port"])
                        except (OSError, ValueError, KeyError):
                            pass   # partly visible; the next tick reads again
                        else:
                            h.state = BOOTING
                            self._event(h.index, "bound", port=h.port)
                    elif now - h.spawned_at > self.config.boot_timeout_s:
                        self._event(h.index, "boot_timeout")
                        timed_out.append(h)
                elif h.state == BOOTING:
                    if probe_ok.get(h.index, False):
                        h.state = READY
                        h.boot_wall_s = now - h.spawned_at
                        if h.last_death_at is not None:
                            h.last_recovery_s = now - h.last_death_at
                        self._event(h.index, "ready", boot_wall_s=round(h.boot_wall_s, 3),
                                    recovery_s=(round(h.last_recovery_s, 3)
                                                if h.last_recovery_s is not None
                                                else None))
                    elif now - h.spawned_at > self.config.boot_timeout_s:
                        self._event(h.index, "boot_timeout")
                        timed_out.append(h)
                elif h.state == BACKOFF:
                    if h.restart_at is not None and now >= h.restart_at:
                        self._spawn(h)
        # kill and reap outside the lock, then take it again for the
        # transition (retire_replica may have STOPPED the handle meanwhile)
        for h in timed_out:
            rc = self._kill_boot_timeout(h)
            with self._lock:
                if h.state in (SPAWNING, BOOTING):
                    self._on_death(h, rc)

    def _monitor_loop(self) -> None:
        while not self._stopping:
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the monitor outlives a bad tick
                logger.exception("fleet monitor: tick failed")
            time.sleep(self.config.poll_interval_s)

    # -- elasticity (the autoscaler's verbs) ---------------------------

    def add_replica(self) -> ReplicaHandle:
        """Grow the fleet by one slot and spawn it; it joins routing through
        the usual SPAWNING -> BOOTING -> READY gate."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("supervisor is stopping")
            h = self._slot(len(self.replicas))
            self.replicas.append(h)
            self._spawn(h)
        self._event(h.index, "scale_up_spawned", n_replicas=h.index + 1)
        return h

    def retire_replica(self, index: int, drain_timeout_s: float = 30.0) -> bool:
        """Shrink the fleet: SIGTERM one replica (it drains its batches) and
        mark it STOPPED, so its exit is neither a death nor restarted. False
        when the slot is already dead or stopped."""
        with self._lock:
            if not 0 <= index < len(self.replicas):
                return False
            h = self.replicas[index]
            if h.state == STOPPED or h.proc is None or h.proc.poll() is not None:
                return False
            # the state first: the next tick must see STOPPED when the exit lands
            h.state = STOPPED
            h.proc.send_signal(signal.SIGTERM)
        self._event(index, "scale_down_retired", drain_timeout_s=drain_timeout_s)
        return True

    def live_count(self) -> int:
        """Slots neither STOPPED nor FAILED (the autoscaler's fleet size)."""
        with self._lock:
            return sum(1 for h in self.replicas if h.state not in (STOPPED, FAILED))

    def live_indices(self) -> set:
        """Indices of the slots not STOPPED."""
        with self._lock:
            return {h.index for h in self.replicas if h.state != STOPPED}

    def stopped_ports(self) -> List[int]:
        """Ports of retired slots (their pooled sockets are garbage)."""
        with self._lock:
            return [h.port for h in self.replicas
                    if h.state == STOPPED and h.port is not None]

    # -- queries -------------------------------------------------------

    def ready_handles(self) -> List[ReplicaHandle]:
        """Snapshot of the routable replicas (READY, port known)."""
        with self._lock:
            return [h for h in self.replicas if h.state == READY and h.port is not None]

    def states(self) -> Dict[int, str]:
        with self._lock:
            return {h.index: h.state for h in self.replicas}

    def summary(self) -> List[dict]:
        with self._lock:
            return [h.summary() for h in self.replicas]

    def wait_ready(self, n: Optional[int] = None, timeout: float = 180.0) -> bool:
        """Block until at least ``n`` replicas are READY (default: all);
        False on timeout."""
        want = self.config.n_replicas if n is None else n
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.ready_handles()) >= want:
                return True
            time.sleep(min(self.config.poll_interval_s, 0.1))
        return len(self.ready_handles()) >= want

    # -- control -------------------------------------------------------

    def terminate_replica(self, index: int, sig: int = signal.SIGKILL) -> bool:
        """Send ``sig`` to a replica; the monitor then sees the death and
        restarts it."""
        with self._lock:
            h = self.replicas[index]
            if h.proc is None or h.proc.poll() is not None:
                return False
            h.proc.send_signal(sig)
        self._event(index, "signalled", sig=int(sig))
        return True

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the fleet: SIGTERM every live replica (each drains), wait
        (bounded), SIGKILL the stragglers; ``drain=False`` kills at once.
        Idempotent."""
        timeout = timeout if timeout is not None else self.config.drain_timeout_s
        with self._lock:
            if self._stopping and all(h.state == STOPPED for h in self.replicas):
                return
            self._stopping = True
        if self._monitor is not None and self._monitor.is_alive():
            self._monitor.join(timeout=10.0)
        live = [h for h in self.replicas if h.proc is not None and h.proc.poll() is None]
        for h in live:
            h.proc.send_signal(signal.SIGTERM if drain else signal.SIGKILL)
        deadline = time.monotonic() + timeout
        for h in live:
            try:
                h.proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                logger.warning("fleet: replica %d did not drain in %.1fs; killing",
                               h.index, timeout)
                h.proc.kill()
                h.proc.wait(timeout=10.0)
        with self._lock:
            for h in self.replicas:
                h.state = STOPPED
        self._event(-1, "fleet_stopped")
