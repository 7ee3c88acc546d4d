"""The serving fleet of the PyTorch port (``dgen_tpu_torch.serve.fleet``,
``.front``, ``.autoscale``, ``config.FleetConfig``) against the JAX
package's (``dgen_tpu.serve``): the circuit breaker, ``FleetConfig`` and
the autoscaler driven through both with the same fake clock and the same
script, step for step; the supervisor and the front on stub replicas (a
pure-Python HTTP process speaking the replica protocol, as
tests/test_fleet.py's); the CLIs; the cross-process build lock; and, under
``slow``, the whole fleet and scale drills on the CPU.

The real replica processes of the port are held to the in-process engine
and to JAX's answers in tests/test_torch_fleet_replicas.py.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from dgen_tpu import config as jcfg
from dgen_tpu.serve import autoscale as jautoscale
from dgen_tpu.serve import front as jfront
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.resilience.supervisor import RetryPolicy
from dgen_tpu_torch.serve import autoscale as tautoscale
from dgen_tpu_torch.serve import front as tfront
from dgen_tpu_torch.serve.fleet import (
    FAILED,
    READY,
    STOPPED,
    HTTPPool,
    ReplicaSupervisor,
    http_json,
)
from dgen_tpu_torch.serve.front import (
    CLOSED,
    FleetFront,
    drain_front,
    start_front_in_thread,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# The circuit breaker against JAX's (tests/test_fleet.py:59-110)
# ---------------------------------------------------------------------------

#: (failures_to_open, cooldown_s, steps); a step is "allow", "fail", "ok" or
#: a clock time
BREAKER_SCRIPTS = [
    (3, 5.0, ["allow", "fail", "fail", "allow", "ok", "fail", "fail", "fail", "allow",
              4.9, "allow", 5.1, "allow", "allow", "ok", "allow"]),
    (2, 1.0, ["fail", "fail", 1.5, "allow", "fail", 2.0, "allow", 2.6, "allow", "ok",
              "allow"]),
    (1, 0.0, ["fail", "allow", "allow", "fail", "allow", "ok", "fail", "fail"]),
]


def _replay_breaker(mod, failures, cooldown, steps):
    clock = [0.0]
    br = mod.CircuitBreaker(failures_to_open=failures, cooldown_s=cooldown,
                            clock=lambda: clock[0])
    trace = []
    for step in steps:
        if isinstance(step, float):
            clock[0] = step
            out = None
        elif step == "allow":
            out = br.allow()
        elif step == "fail":
            out = br.record_failure()
        else:
            out = br.record_success()
        trace.append((step, out, br.state, br.to_json()))
    return trace


@pytest.mark.parametrize("failures,cooldown,steps", BREAKER_SCRIPTS,
                         ids=["open-half-open-close", "probe-failure-reopens",
                              "zero-cooldown"])
def test_breaker_matches_jax_step_for_step(failures, cooldown, steps):
    got = _replay_breaker(tfront, failures, cooldown, steps)
    want = _replay_breaker(jfront, failures, cooldown, steps)
    assert got == want
    assert (tfront.CLOSED, tfront.OPEN, tfront.HALF_OPEN) == (
        jfront.CLOSED, jfront.OPEN, jfront.HALF_OPEN)
    assert any(state == tfront.HALF_OPEN for _s, _o, state, _j in got)


# ---------------------------------------------------------------------------
# FleetConfig against JAX's (tests/test_fleet.py:613, test_serve_surface.py:511)
# ---------------------------------------------------------------------------

FLEET_ENV = {
    "DGEN_TPU_FLEET_REPLICAS": "3", "DGEN_TPU_FLEET_HOST": "0.0.0.0",
    "DGEN_TPU_FLEET_PORT": "9001", "DGEN_TPU_FLEET_BOOT_TIMEOUT_S": "12.5",
    "DGEN_TPU_FLEET_MAX_RESTARTS": "7", "DGEN_TPU_FLEET_BREAKER_FAILURES": "4",
    "DGEN_TPU_FLEET_BREAKER_COOLDOWN_S": "0.75", "DGEN_TPU_FLEET_REQ_TIMEOUT_S": "9",
    "DGEN_TPU_FLEET_SHED_FRAC": "0.5", "DGEN_TPU_FLEET_RETRY_AFTER_S": "2.5",
    "DGEN_TPU_FLEET_DRAIN_TIMEOUT_S": "11", "DGEN_TPU_FLEET_AUTOSCALE": "1",
    "DGEN_TPU_FLEET_MIN_REPLICAS": "2", "DGEN_TPU_FLEET_MAX_REPLICAS": "6",
    "DGEN_TPU_FLEET_SCALE_UP_QUEUE_FRAC": "0.4",
    "DGEN_TPU_FLEET_SCALE_UP_SUSTAIN_S": "1.5",
    "DGEN_TPU_FLEET_SCALE_DOWN_SUSTAIN_S": "4", "DGEN_TPU_FLEET_SCALE_COOLDOWN_S": "3",
}


@pytest.mark.parametrize("env,overrides", [
    ({}, {}),
    (FLEET_ENV, {}),
    (FLEET_ENV, {"n_replicas": 2, "port": 0}),
    ({"DGEN_TPU_FLEET_AUTOSCALE": "off", "DGEN_TPU_FLEET_REPLICAS": "5"}, {}),
], ids=["defaults", "every-switch", "keywords-win", "autoscale-off"])
def test_fleet_config_from_env_matches_jax(monkeypatch, env, overrides):
    for k in list(os.environ):
        if k.startswith("DGEN_TPU_FLEET_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = tcfg.FleetConfig.from_env(**overrides)
    want = jcfg.FleetConfig.from_env(**overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("bad", [
    dict(n_replicas=0), dict(shed_queue_frac=1.5), dict(min_replicas=3, max_replicas=2),
    dict(autoscale=True, n_replicas=5, min_replicas=1, max_replicas=4),
    dict(scale_up_queue_frac=0.2, scale_down_queue_frac=0.3),
    dict(scale_up_occupancy=0.5, scale_down_occupancy=0.5),
    dict(port=70000), dict(boot_timeout_s=0), dict(breaker_failures=0),
    dict(request_timeout_s=0), dict(retry_after_s=-1), dict(metricz_interval_s=0),
    dict(scale_interval_s=0), dict(max_restarts=-1),
])
def test_fleet_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as got:
        tcfg.FleetConfig(**bad)
    with pytest.raises(ValueError) as want:
        jcfg.FleetConfig(**bad)
    assert str(got.value).split(" ")[0] == str(want.value).split(" ")[0]


# ---------------------------------------------------------------------------
# The autoscaler against JAX's (tests/test_serve_surface.py:362-520)
# ---------------------------------------------------------------------------

class _Slot:
    def __init__(self, index, state="ready"):
        self.index = index
        self.state = state
        self.deaths = []


class _FakeSup:
    """The supervisor surface the autoscaler touches, no processes."""

    def __init__(self, n=1):
        self.replicas = [_Slot(i) for i in range(n)]
        self.events = []

    def _event(self, index, event, **detail):
        self.events.append({"replica": index, "event": event, **detail})

    def live_count(self):
        return sum(1 for h in self.replicas if h.state not in ("stopped", "failed"))

    def add_replica(self):
        self.replicas.append(_Slot(len(self.replicas)))

    def retire_replica(self, index, drain_timeout_s=30.0):
        self.replicas[index].state = "stopped"
        return True


def _scaler(mod, cfg_mod, sup, sig, clock, **cfg_kw):
    kw = dict(n_replicas=1, port=0, autoscale=True, min_replicas=1, max_replicas=3,
              scale_up_queue_frac=0.5, scale_up_occupancy=0.8, scale_up_sustain_s=1.0,
              scale_down_queue_frac=0.05, scale_down_occupancy=0.2,
              scale_down_sustain_s=2.0, scale_cooldown_s=5.0, scale_interval_s=0.1)
    kw.update(cfg_kw)
    return mod.Autoscaler(sup, sig, cfg_mod.FleetConfig(**kw), clock=lambda: clock[0])


def _hysteresis_script(mod, cfg_mod):
    """tests/test_serve_surface.py's hysteresis matrix: (time, signal) steps,
    each tick's action, the live count and the ledger."""
    clock = [0.0]
    sig = {"queue_frac": 0.0, "occupancy": 0.0}
    sup = _FakeSup(1)
    sc = _scaler(mod, cfg_mod, sup, lambda: dict(sig), clock)
    steps = ([(t, {}) for t in (0.0, 5.0, 50.0)]
             + [(100.0, {"queue_frac": 0.9}), (100.5, {}),
                (101.0, {"queue_frac": 0.0, "occupancy": 0.0}),
                (101.5, {"queue_frac": 0.9}), (102.6, {}), (104.0, {}), (106.0, {}),
                (107.8, {}), (207.8, {}), (217.8, {}),
                (317.8, {"queue_frac": 0.0, "occupancy": 0.0}), (319.9, {}),
                (419.9, {}), (422.0, {}), (522.0, {}), (524.1, {})])
    out = []
    for t, change in steps:
        clock[0] = t
        sig.update(change)
        out.append((t, sc.tick(), sup.live_count(),
                    [h.state for h in sup.replicas]))
    events = [{k: v for k, v in e.items() if k != "t"} for e in sc.events]
    return out, sup.events, events, (sc.n_scale_up, sc.n_scale_down)


def _occupancy_alone(mod, cfg_mod):
    clock = [0.0]
    sup = _FakeSup(1)
    sc = _scaler(mod, cfg_mod, sup, lambda: {"queue_frac": 0.0, "occupancy": 0.95}, clock)
    out = [sc.tick()]
    clock[0] = 1.1
    out.append(sc.tick())
    return out, sup.live_count()


def _hold_without_signal(mod, cfg_mod):
    clock = [0.0]
    out = [{"queue_frac": 0.9, "occupancy": 0.9}]
    sup = _FakeSup(1)
    sc = _scaler(mod, cfg_mod, sup, lambda: out[0], clock)
    trace = [sc.tick()]
    for t, sig in ((0.5, None), (1.1, {"queue_frac": 0.9, "occupancy": 0.9}),
                   (2.2, {"queue_frac": 0.9, "occupancy": 0.9}),
                   (100.0, {"queue_frac": 0.3, "occupancy": 0.5})):
        clock[0] = t
        out[0] = sig
        trace.append((t, sc.tick(), sc._pressure_since, sc._idle_since))
    return trace, sup.live_count()


@pytest.mark.parametrize("script", [_hysteresis_script, _occupancy_alone,
                                    _hold_without_signal],
                         ids=["hysteresis", "occupancy-alone",
                              "no-signal-and-between-bands"])
def test_autoscaler_actions_match_jax(script):
    got = script(tautoscale, tcfg)
    want = script(jautoscale, jcfg)
    assert got == want


def test_autoscaler_hysteresis_scales_as_tests_of_jax_expect():
    """The replayed matrix reaches what tests/test_serve_surface.py asserts
    of JAX's: two ups, LIFO downs, the bounds held."""
    out, sup_events, events, counts = _hysteresis_script(tautoscale, tcfg)
    actions = [a for _t, a, _n, _s in out if a]
    assert actions == ["up", "up", "down", "down"]
    assert counts == (2, 2)
    assert out[-1][2] == 1 and out[-1][3][1:] == ["stopped", "stopped"]
    assert [e["event"] for e in sup_events] == ["autoscale_up"] * 2 + ["autoscale_down"] * 2
    assert [e.get("retired") for e in events if e["action"] == "down"] == [2, 1]


# ---------------------------------------------------------------------------
# Stub-replica harness (tests/test_fleet.py:115-175): supervisor and front
# semantics in milliseconds per boot
# ---------------------------------------------------------------------------

_STUB = '''
import http.server, json, os, signal, sys, time

portfile = sys.argv[1]
t0 = time.time()
ready_delay = float(os.environ.get("STUB_READY_DELAY", "0"))
ready_flag = os.environ.get("STUB_READY_FLAG", "")
query_sleep = float(os.environ.get("STUB_QUERY_SLEEP", "0"))
queue_depth = int(os.environ.get("STUB_QUEUE_DEPTH", "0"))
max_queue = int(os.environ.get("STUB_MAX_QUEUE", "256"))


class H(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _send(self, code, payload):
        blob = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def log_message(self, *a):
        pass

    def _ready(self):
        if ready_flag:
            return os.path.exists(ready_flag)
        return (time.time() - t0) >= ready_delay

    def do_GET(self):
        if self.path == "/readyz":
            self._send(200 if self._ready() else 503, {"ready": self._ready()})
        elif self.path == "/healthz":
            self._send(200, {"live": True, "pid": os.getpid(),
                             "replica_index": os.environ.get("DGEN_TPU_SERVE_REPLICA")})
        elif self.path == "/metricz":
            self._send(200, {"queue_depth": queue_depth, "max_queue": max_queue,
                             "batches": 2, "batch_occupancy": 0.5, "pid": os.getpid()})
        else:
            self._send(404, {})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n)
        if query_sleep:
            time.sleep(query_sleep)
        # a pure function of the body: a replica-independent answer
        self._send(200, {"results": [{"echo": raw.decode()}]})


srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
signal.signal(signal.SIGTERM, lambda *a: os._exit(0))
tmp = portfile + ".tmp"
with open(tmp, "w") as f:
    json.dump({"pid": os.getpid(), "port": srv.server_address[1]}, f)
os.replace(tmp, portfile)
srv.serve_forever()
'''


@pytest.fixture
def stub_script(tmp_path):
    p = tmp_path / "stub_replica.py"
    p.write_text(_STUB)
    return str(p)


def _stub_cmd(script):
    def cmd_for(index, portfile):
        return [sys.executable, script, portfile]
    return cmd_for


def _fast_cfg(n, **kw):
    kw.setdefault("poll_interval_s", 0.02)
    kw.setdefault("boot_timeout_s", 30.0)
    kw.setdefault("metricz_interval_s", 0.05)
    kw.setdefault("breaker_cooldown_s", 0.2)
    kw.setdefault("retry_after_s", 1.0)
    return tcfg.FleetConfig(n_replicas=n, port=0, **kw)


_FAST_POLICY = RetryPolicy(backoff_base_s=0.01, jitter_frac=0.0)


def _echo(body: bytes) -> dict:
    return {"results": [{"echo": body.decode()}]}


def test_readiness_gates_routing(stub_script, tmp_path):
    """A live but unready replica gets no traffic; it joins the rotation
    once /readyz is green. The replica index reaches its environment."""
    flag = str(tmp_path / "ready.flag")

    def env_for(index, spawn_count):
        return {"STUB_READY_FLAG": flag} if index == 1 else None

    sup = ReplicaSupervisor(_stub_cmd(stub_script), _fast_cfg(2), policy=_FAST_POLICY,
                            env_for=env_for, fleet_dir=str(tmp_path / "fleet")).start()
    try:
        assert sup.wait_ready(n=1, timeout=20.0)
        time.sleep(0.1)   # a few monitor ticks: replica 1 stays unready
        assert sup.states()[0] == READY and sup.states()[1] != READY
        front = FleetFront(sup, sup.config)
        body = json.dumps({"agent_ids": [1]}).encode()
        for _ in range(6):
            code, blob, _hdr = front.route_query(body)
            assert code == 200 and json.loads(blob) == _echo(body)
        with open(flag, "w") as f:
            f.write("go")
        assert sup.wait_ready(n=2, timeout=20.0)
        _s, blob, _h = http_json(sup.replicas[1].port, "/healthz")
        assert json.loads(blob)["replica_index"] == "1"
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_crash_loop_breaker_stops_restart_storm(tmp_path):
    """A replica that dies on every boot is restarted at most max_restarts
    times inside the window, then marked FAILED, and stays so."""
    cfg = _fast_cfg(1, max_restarts=2, restart_window_s=60.0)

    def cmd_for(index, portfile):
        return [sys.executable, "-c", "import sys; sys.exit(3)"]

    sup = ReplicaSupervisor(cmd_for, cfg, policy=_FAST_POLICY,
                            fleet_dir=str(tmp_path / "fleet")).start()
    try:
        deadline = time.monotonic() + 20.0
        while sup.states()[0] != FAILED and time.monotonic() < deadline:
            time.sleep(0.02)
        h = sup.replicas[0]
        assert h.state == FAILED
        spawns = h.spawn_count
        assert spawns <= cfg.max_restarts + 1
        assert all(rc == 3 for rc in h.exit_codes)
        time.sleep(0.3)
        assert h.spawn_count == spawns
        assert any(e["event"] == "crash_loop" for e in sup.events)
        assert sup.live_count() == 0
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_kill_under_load_fails_over_and_restarts(stub_script, tmp_path):
    """A replica SIGKILLed mid-load: every request is still answered with
    the same pure function, and the supervisor restarts the dead replica to
    full READY strength."""
    sup = ReplicaSupervisor(_stub_cmd(stub_script),
                            _fast_cfg(2, breaker_failures=2, request_timeout_s=5.0),
                            policy=_FAST_POLICY, fleet_dir=str(tmp_path / "fleet")).start()
    try:
        assert sup.wait_ready(timeout=20.0)
        front = FleetFront(sup, sup.config)
        for k in range(30):
            if k == 8:
                assert sup.terminate_replica(0, signal.SIGKILL)
            body = json.dumps({"agent_ids": [k]}).encode()
            code, blob, _hdr = front.route_query(body)
            assert code == 200, (k, code, blob)
            assert json.loads(blob) == _echo(body), k
        h0 = sup.replicas[0]
        deadline = time.monotonic() + 20.0
        while not h0.exit_codes and time.monotonic() < deadline:
            time.sleep(0.02)
        assert -9 in h0.exit_codes
        while (h0.state != READY or h0.spawn_count < 2) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert h0.state == READY and h0.spawn_count == 2
        assert h0.last_recovery_s is not None and h0.boot_wall_s is not None
        assert sup.wait_ready(timeout=20.0)
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_front_route_fault_retries_elsewhere_and_counts_on_the_breaker(stub_script,
                                                                      tmp_path):
    """An injected routing-layer failure (the front_route site) on a
    request's first forward is retried on the other replica and charged to
    the replica it was routed to; failing every forward opens both
    breakers, the front answers 503 with Retry-After (never 502 or 504),
    and after the cooldown a HALF_OPEN probe closes them again."""
    # a cooldown that a loaded worker cannot outlast between two requests
    cfg = _fast_cfg(2, breaker_failures=2, breaker_cooldown_s=1.0)
    sup = ReplicaSupervisor(_stub_cmd(stub_script), cfg, policy=_FAST_POLICY,
                            fleet_dir=str(tmp_path / "fleet")).start()
    try:
        assert sup.wait_ready(timeout=20.0)
        front = FleetFront(sup, sup.config)
        body = json.dumps({"q": 1}).encode()
        with faults.injected("front_route@1;front_route@4") as reg:
            for _ in range(3):
                code, blob, _hdr = front.route_query(body)
                assert code == 200 and json.loads(blob) == _echo(body)
        assert reg.fired("front_route") == 2
        assert front.n_retries == 2 and front.n_forward_failures == 2
        assert sum(front.breaker(i).to_json()["consecutive_failures"]
                   for i in (0, 1)) >= 1
        with faults.injected("front_route@1x8"):
            for _ in range(2):
                code, blob, hdr = front.route_query(body)
                assert code == 503 and "Retry-After" in hdr
                assert json.loads(blob)["retry"] is True
        assert {front.breaker(i).state for i in (0, 1)} == {tfront.OPEN}
        code, _b, hdr = front.route_query(body)          # no breaker admits
        assert code == 503 and json.loads(_b)["error"] == "no replica available"
        time.sleep(sup.config.breaker_cooldown_s + 0.05)
        code, blob, _hdr = front.route_query(body)        # the HALF_OPEN probe
        assert code == 200 and json.loads(blob) == _echo(body)
        assert CLOSED in {front.breaker(i).state for i in (0, 1)}
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_load_shed_503_carries_retry_after(stub_script, tmp_path):
    """A summed /metricz queue depth at shed_queue_frac of the capacity
    sheds new queries at the front: 503 with Retry-After; the aggregate
    and the autoscaler's pressure signal read the same scrapes."""
    sup = ReplicaSupervisor(_stub_cmd(stub_script), _fast_cfg(1, shed_queue_frac=0.8),
                            policy=_FAST_POLICY, fleet_dir=str(tmp_path / "fleet"),
                            env_for=lambda i, sc: {"STUB_QUEUE_DEPTH": "90",
                                                   "STUB_MAX_QUEUE": "100"}).start()
    try:
        assert sup.wait_ready(timeout=20.0)
        front = FleetFront(sup, sup.config)
        assert front.pressure() is None and not front.shed_now()   # never blind
        front.start()
        deadline = time.monotonic() + 5.0
        while not front.shed_now() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert front.shed_now()
        code, blob, hdr = front.route_query(b"{}")
        assert code == 503 and hdr == {"Retry-After": "1"}
        payload = json.loads(blob)
        assert payload["retry"] is True and payload["shed"] is True
        assert front.n_shed == 1
        mz = front.metricz()
        assert (mz["queue_depth"], mz["queue_capacity"], mz["shedding"]) == (90, 100, True)
        assert mz["occupancy_weighted"] == 0.5
        assert mz["replicas"]["0"]["breaker"]["state"] == CLOSED
        p = front.pressure()
        assert p["queue_frac"] == 0.9 and p["occupancy"] == 0.5 and p["ready_replicas"] == 1
        front.close()
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_drain_completes_inflight_then_rejects(stub_script, tmp_path):
    """A drain lets the request in flight finish 200, then answers 503 with
    Retry-After, and SIGTERMs the replicas."""
    sup = ReplicaSupervisor(_stub_cmd(stub_script), _fast_cfg(1), policy=_FAST_POLICY,
                            fleet_dir=str(tmp_path / "fleet"),
                            env_for=lambda i, sc: {"STUB_QUERY_SLEEP": "0.4"}).start()
    try:
        assert sup.wait_ready(timeout=20.0)
        front = FleetFront(sup, sup.config)
        srv = start_front_in_thread(front)
        results = {}

        def slow_query():
            results["rc"] = front.route_query(json.dumps({"agent_ids": [9]}).encode())

        t = threading.Thread(target=slow_query, daemon=True)
        t.start()
        deadline = time.monotonic() + 2.0
        while front.inflight == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert front.inflight == 1
        assert drain_front(front, srv, stop_fleet=True, timeout=10.0) is True
        t.join(10.0)
        assert not t.is_alive()
        srv.server_close()
        assert results["rc"][0] == 200
        code, blob, hdr = front.route_query(b"{}")
        assert code == 503 and "Retry-After" in hdr and json.loads(blob)["draining"]
        assert front.readyz()[0] == 503
        assert all(h.proc.poll() is not None for h in sup.replicas)
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_front_http_shell_and_pool_reuse(stub_script, tmp_path):
    """The front over HTTP: /readyz, /healthz, /metricz and /query through
    the JSON handler; the forwards reuse pooled keep-alive connections."""
    sup = ReplicaSupervisor(_stub_cmd(stub_script), _fast_cfg(2), policy=_FAST_POLICY,
                            fleet_dir=str(tmp_path / "fleet")).start()
    try:
        assert sup.wait_ready(timeout=20.0)
        front = FleetFront(sup, sup.config)
        srv = start_front_in_thread(front)
        port = srv.server_address[1]
        pool = HTTPPool()
        assert http_json(port, "/readyz", pool=pool)[0] == 200
        for k in range(6):
            body = json.dumps({"agent_ids": [k]}).encode()
            code, blob, _h = http_json(port, "/query", method="POST", body=body, pool=pool)
            assert code == 200 and json.loads(blob) == _echo(body)
        assert http_json(port, "/nope", pool=pool)[0] == 404
        hz = json.loads(http_json(port, "/healthz")[1])
        assert hz["role"] == "fleet-front" and len(hz["replicas"]) == 2
        mz = json.loads(http_json(port, "/metricz")[1])
        assert mz["requests"] == 6 and mz["latency_ms"]["count"] == 6
        assert mz["http_pool"]["reused"] >= 4 and pool.stats()["reused"] >= 6
        pool.close()
        assert drain_front(front, srv, timeout=5.0)
        srv.server_close()
    finally:
        sup.stop(drain=False, timeout=5.0)


def test_supervisor_add_and_retire_replica(stub_script, tmp_path):
    """The autoscaler's verbs: a new slot goes through the readiness gate;
    a retired one drains on SIGTERM, is STOPPED, never restarted and no
    death."""
    sup = ReplicaSupervisor(_stub_cmd(stub_script), _fast_cfg(1),
                            fleet_dir=str(tmp_path / "fleet")).start()
    try:
        assert sup.wait_ready(n=1, timeout=20.0)
        h = sup.add_replica()
        assert h.index == 1 and sup.wait_ready(n=2, timeout=20.0)
        assert sup.retire_replica(1)
        deadline = time.monotonic() + 10.0
        while sup.replicas[1].proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.replicas[1].proc.poll() == 0
        time.sleep(0.2)
        assert sup.replicas[1].state == STOPPED and not sup.replicas[1].deaths
        assert sup.live_count() == 1 and len(sup.ready_handles()) == 1
        assert not sup.retire_replica(1)
        events = [e["event"] for e in sup.events]
        assert "scale_up_spawned" in events and "scale_down_retired" in events
    finally:
        sup.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_serve_cli_runs_the_fleet_modes(monkeypatch):
    """--fleet (with --autoscale) and --replica-index reach their runners
    (no refusal); --fleet with --replica-index is an error, as in JAX."""
    import dgen_tpu_torch.serve.__main__ as cli

    seen = []
    monkeypatch.setattr(cli, "_run_fleet", lambda a: seen.append(("fleet", a)))
    monkeypatch.setattr(cli, "_run_replica", lambda a: seen.append(("replica", a)))
    monkeypatch.setattr(cli, "_run_single", lambda a: seen.append(("single", a)))
    assert cli.main(["--device", "cpu", "--fleet", "2", "--autoscale",
                     "--max-replicas", "3"]) == 0
    assert cli.main(["--device", "cpu", "--replica-index", "1", "--port", "0"]) == 0
    assert [k for k, _a in seen] == ["fleet", "replica"]
    fleet = seen[0][1]
    assert fleet.fleet == 2 and fleet.autoscale and fleet.max_replicas == 3
    assert cli._fleet_serve_args(fleet)[-2:] == ["--device", "cpu"]
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--fleet", "2", "--replica-index", "0"])
    assert not hasattr(cli, "FLEET_ITEM")


def test_resilience_cli_runs_the_fleet_drills_and_refuses_the_gang(monkeypatch, capsys):
    from dgen_tpu_torch.resilience import fleetdrill
    from dgen_tpu_torch.resilience.__main__ import main

    calls = []

    def fake(name):
        def run(**kw):
            calls.append((name, kw))
            return {"ok": name == "fleet", "supervisor_events": []}
        return run

    monkeypatch.setattr(fleetdrill, "run_fleet_drill", fake("fleet"))
    monkeypatch.setattr(fleetdrill, "run_scale_drill", fake("scale"))
    assert main(["drill", "--serve-fleet", "--layers", "--replicas", "3",
                 "--requests", "12", "--agents", "32", "--device", "cpu"]) == 0
    assert main(["drill", "--serve-scale", "--agents", "16", "--device", "cpu"]) == 1
    assert calls == [
        ("fleet", dict(replicas=3, agents=32, end_year=2016, requests=12, layers=True,
                       device="cpu")),
        ("scale", dict(agents=16, end_year=2016, device="cpu")),
    ]
    assert "supervisor_events" not in capsys.readouterr().out
    # the gang drill is ported now: --gang routes to it with its settings
    from dgen_tpu_torch.resilience import gangdrill

    gang = []
    monkeypatch.setattr(gangdrill, "run_gang_drill",
                        lambda root, **kw: gang.append(kw) or {"ok": True})
    assert main(["drill", "--gang", "--gang-processes", "4", "--device", "cpu"]) == 0
    assert gang == [dict(processes=4, shrink_to=2, total_devices=None, agents=96,
                         end_year=2018, stall=True, device="cpu")]


def test_fleet_entry_points_default_to_the_card():
    """The drills and the fleet's replicas run on the card unless asked."""
    import inspect

    import torch

    from dgen_tpu_torch.resilience import fleetdrill

    for fn in (fleetdrill.run_fleet_drill, fleetdrill.run_scale_drill):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleetdrill.run_fleet_drill(requests=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleetdrill.run_scale_drill()


# ---------------------------------------------------------------------------
# The cross-process build lock
# ---------------------------------------------------------------------------

_RACER = textwrap.dedent('''
    import os, sys, time
    from dgen_tpu_torch.ops import _build
    out, lib, go = sys.argv[1:4]

    def fake_compile(srcs, path):
        with open(out + ".compiles", "a") as f:
            f.write(f"{os.getpid()}\\n")
        time.sleep(0.5)                    # a slow compile widens the race
        with open(path + ".tmp", "wb") as f:
            f.write(b"stub")
        os.replace(path + ".tmp", path)
        return ""

    _build.BUILD_DIR = os.path.dirname(lib)
    _build._compile = fake_compile
    _build.library_path = lambda csrc=None: lib
    while not os.path.exists(go):          # both processes start together
        time.sleep(0.005)
    path, secs, _log = _build.build()
    print(path == lib, _build.EVENTS["builds"])
''')


def test_two_processes_reaching_the_build_compile_once(tmp_path):
    """Two processes (two replicas booting together) reach the build with
    no library: one compiles, the other waits on the file lock and finds
    the library (a stub compiler: no nvcc here)."""
    script = tmp_path / "racer.py"
    script.write_text(_RACER)
    lib = str(tmp_path / "build" / "lib.so")
    go = str(tmp_path / "go")
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, str(script), out, lib, go], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    time.sleep(0.5)
    open(go, "w").close()
    results = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    assert sorted(r[0].split() for r in results) == [["True", "0"], ["True", "1"]]
    with open(out + ".compiles") as f:
        assert len(f.read().split()) == 1
    assert os.path.exists(lib) and os.path.exists(lib + ".lock")


# ---------------------------------------------------------------------------
# The whole drills on the CPU (slow, as tests/test_fleet.py:587)
# ---------------------------------------------------------------------------

#: the CPU's plain dispatch loop answers a bucket in ~0.6 s: the forward
#: timeout and the hang are scaled to it
CPU_DRILL = dict(device="cpu", agents=32, requests=24, bucket=4, kill_at=3, hang_at=8,
                 hang_s=12.0, forward_timeout_s=8.0, p99_bound_s=120.0)


@pytest.mark.slow
def test_fleet_drill_end_to_end_on_the_cpu():
    from dgen_tpu_torch.resilience.fleetdrill import run_fleet_drill

    rec = run_fleet_drill(layers=True, steady_requests=8, **CPU_DRILL)
    assert rec["ok"], {k: rec.get(k) for k in (
        "answered", "mismatches", "client_failures", "recovered_full_strength",
        "steady_state_compiles", "kill", "hang", "latency_s", "layers", "steady")}
    assert rec["kill"]["exit_77_seen"] and rec["kill"]["restart_boot_ok"]
    assert rec["hang"]["fired"] >= 1 and rec["hang"]["breaker_closed_again"]
    assert rec["steady_state_compiles"] == {"0": 0, "1": 0}
    assert rec["layers"]["surface_hits"] > 0 and rec["layers"]["result_cache"]["hits"] > 0
    assert rec["layers"]["engine_batches"] > 0 and rec["layers"]["repeat_mismatches"] == []


@pytest.mark.slow
def test_scale_drill_end_to_end_on_the_cpu():
    from dgen_tpu_torch.resilience.fleetdrill import run_scale_drill

    rec = run_scale_drill(device="cpu", agents=32, bucket=4)
    assert rec["ok"], rec
    assert (rec["scale_ups"], rec["scale_downs"]) == (1, 1)
    assert rec["cache_answer_byte_identical"] and rec["result_cache"]["hits"] >= 1
    assert rec["retired_exit_codes"] == [0]


@pytest.mark.slow
def test_chip_smoke_fleet_phase_rehearses_on_the_cpu():
    """chip_smoke.py [3l] at 32 agents on the CPU: the three drills pass and
    the fleet path's oracle keeps its first dispatch."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    out = cs.serving_fleet("cpu", device="cpu", agents=32, small_agents=32, requests=24,
                           steady=8, drill_kw={k: v for k, v in CPU_DRILL.items()
                                               if k not in ("device", "agents",
                                                            "requests", "bucket")})
    assert out["a"]["ok"] and out["b"]["ok"] and out["c"]["ok"]
    assert "dispatch" in out["capture"]
    assert out["a"]["steady"]["answered"] == 8
