"""The serving-fleet drills (port of ``dgen_tpu/resilience/fleetdrill.py``):
shoot at a live fleet of replica processes and prove it heals itself.

``python -m dgen_tpu_torch.resilience drill --serve-fleet`` boots a fleet
(N replica processes of ``python -m dgen_tpu_torch.serve`` behind the
routing front, each on ``device``), drives closed-loop client load through
the front and, mid-load, **kills** one replica
(``serve_replica_kill@k:kill``: ``os._exit`` with requests and kernels in
flight) and **hangs** another (``serve_replica_hang@m:hang``: the
batcher's worker stalls longer than the front's forward timeout). It
passes only if:

* **every client request is answered**, and the only failures a client
  sees are bounded 503 retries (the front answers no 502 or 504);
* **every answer equals, bit for bit, an in-process oracle's**: a
  :class:`~dgen_tpu_torch.serve.engine.ServeEngine` on ``device`` over the
  same synthetic population at the same bucket (``min_bucket ==
  max_batch`` pins one bucket shape fleet-wide, and every bucket launches
  at least 16 rows, so coalescing with other requests moves no row);
* **the fleet returns to full READY strength**: the killed replica was
  restarted and the hung replica's breaker closed again after its
  HALF_OPEN probe;
* **nothing is built or loaded after warmup on any replica**: each
  replica's ``/metricz`` ``steady_state_compiles`` (kernel-library builds
  and loads since warmup, ``ops._build.EVENTS``) is 0, the restarted one
  included, and the restarted replica's boot report shows 0 builds and,
  on the card, at least 1 load (the library the first boot built, from
  the shared build directory); the JAX package counts XLA compiles and
  compile-cache misses there;
* **p99 stays bounded through the failure**: the client p99 (retries
  included) is under ``p99_bound_s``.

Fault hit counts include warmup: a warmup bucket visits ``query_rows``
once, so ``serve_replica_kill@4:kill`` with one bucket fires on the
replica's third served query.

:func:`run_scale_drill` (``--serve-scale``) drives a one-replica fleet 1
-> 2 -> 1 with the autoscaler on a synthetic signal and proves a
result-cache hit byte-identical to the engine's answer.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dgen_tpu_torch.resilience.faults import HANG_ENV, KILL_EXIT_CODE

logger = logging.getLogger(__name__)

#: what-if variants the drill's load mixes in (distinct coalescing keys,
#: one bucket shape)
OVERRIDE_VARIANTS = (
    None,
    {"scale": {"itc_fraction": 0.5}},
    {"set": {"elec_price_escalator": 0.005}},
)


def _request_plan(k: int, n_agents: int, years: List[int]) -> dict:
    """Request k's body (the oracle computes the same plan)."""
    return {"agent_ids": [k % n_agents], "year": years[k % len(years)],
            "overrides": OVERRIDE_VARIANTS[k % len(OVERRIDE_VARIANTS)]}


def _post(port: int, body: dict, timeout: float) -> tuple:
    from dgen_tpu_torch.serve.fleet import http_json

    status, blob, headers = http_json(port, "/query", method="POST",
                                      body=json.dumps(body).encode(), timeout=timeout)
    return status, blob, headers.get("Retry-After")


def _get(port: int, path: str, timeout: float = 5.0) -> Optional[dict]:
    from dgen_tpu_torch.serve.fleet import HTTP_ERRORS, http_json

    try:
        status, blob, _ = http_json(port, path, timeout=timeout)
        return json.loads(blob) if status == 200 else None
    except HTTP_ERRORS:
        return None


def _serve_argv(agents, end_year, seed, econ_years, sizing_iters, bucket, device) -> list:
    return ["--agents", str(agents), "--end-year", str(end_year), "--seed", str(seed),
            "--econ-years", str(econ_years), "--sizing-iters", str(sizing_iters),
            "--max-batch", str(bucket), "--min-bucket", str(bucket),
            "--max-wait-ms", "2", "--device", device]


def _oracle(agents, end_year, seed, econ_years, sizing_iters, bucket, device):
    """(engine, warmup seconds): the in-process oracle, built through the
    replicas' own population path, so "equal to a single engine" compares
    like with like."""
    from dgen_tpu_torch.serve.__main__ import build_sim
    from dgen_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(build_sim(agents, seed=seed, end_year=end_year,
                                   econ_years=econ_years, sizing_iters=sizing_iters,
                                   device=device))
    t0 = time.perf_counter()
    engine.warmup([bucket])
    return engine, time.perf_counter() - t0


def _thread_env() -> dict:
    """The replicas' intra-op thread count, pinned to this process's: on
    the CPU PyTorch's parallel reductions can move the last bit with it,
    and N replicas at the default would oversubscribe the cores."""
    return {"OMP_NUM_THREADS": str(torch.get_num_threads())}


def _card_free(device: str) -> Optional[int]:
    """Free bytes of the card (every process's use counted), or None off
    one."""
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.mem_get_info()[0])


def _log_tails(sup, n_bytes: int = 2000) -> Dict[str, str]:
    out = {}
    for h in sup.replicas:
        path = os.path.join(sup.fleet_dir, f"replica-{h.index}.log")
        try:
            with open(path, "rb") as f:
                f.seek(max(os.path.getsize(path) - n_bytes, 0))
                out[str(h.index)] = f.read().decode("utf-8", "replace")
        except OSError:
            pass
    return out


def run_fleet_drill(*, replicas: int = 2, agents: int = 64, end_year: int = 2016,
                    econ_years: int = 4, sizing_iters: int = 6, requests: int = 80,
                    clients: int = 4, bucket: int = 8, kill_at: int = 4,
                    hang_at: int = 24, hang_s: float = 6.0,
                    forward_timeout_s: float = 2.5, max_client_retries: int = 200,
                    p99_bound_s: float = 30.0, seed: int = 7, layers: bool = False,
                    surface_bucket: Optional[int] = None,
                    surface_years: Optional[List[int]] = None,
                    steady_requests: int = 0, device="cuda") -> Dict[str, object]:
    """Run the drill (module docstring); returns its record (``ok`` and the
    figures).

    ``layers=True`` also arms the answer surface (built by the oracle at
    ``surface_bucket`` over ``surface_years``, default: the drill's bucket,
    every year) and the shared result cache on every replica; after the
    kill and hang load, plans first asked before the kill are asked twice
    more each through the healed fleet and must equal the oracle's bit
    for bit, and the fleet's surface-hit and cache-hit counters must show
    that all three paths (surface, cache, engine) answered.
    ``steady_requests``: after the fleet is back to full strength, that
    many more requests through the front, timed (queries/s, p50, p99) and
    held to the oracle too. ``device``: the replicas' and the oracle's
    (default the card; raises without one)."""
    from dgen_tpu_torch.config import FleetConfig, resolve_device
    from dgen_tpu_torch.serve.fleet import ReplicaSupervisor, default_replica_cmd
    from dgen_tpu_torch.serve.server import rows_to_json

    device = str(resolve_device(device))
    t_drill0 = time.perf_counter()
    oracle, oracle_warm_s = _oracle(agents, end_year, seed, econ_years, sizing_iters,
                                    bucket, device)
    n_real = oracle.n_agents
    years = list(oracle.years)
    serve_argv = _serve_argv(agents, end_year, seed, econ_years, sizing_iters, bucket,
                             device)
    work_dir = None
    surface_build_s = None
    if layers:
        from dgen_tpu_torch.serve.surface import build_surface

        work_dir = tempfile.mkdtemp(prefix="dgen-fleet-layers-")
        surf_dir = os.path.join(work_dir, "surface")
        header = build_surface(oracle, surf_dir, surface_bucket or bucket,
                               year_indices=surface_years)
        surface_build_s = header["meta"]["build_wall_s"]
        serve_argv += ["--surface", surf_dir,
                       "--cache-dir", os.path.join(work_dir, "resultcache")]
    expected: List[dict] = []
    for k in range(requests):
        plan = _request_plan(k, n_real, years)
        out = oracle.query(plan["agent_ids"], year=plan["year"],
                           overrides=plan["overrides"], bucket=bucket)
        expected.append(rows_to_json(out, cash_flow=False)[0])

    def env_for(index: int, spawn_count: int) -> dict:
        env = _thread_env()
        if spawn_count == 0:   # a restarted replica comes back clean
            if index == 0:
                env["DGEN_TPU_FAULTS"] = f"serve_replica_kill@{kill_at}:kill"
            elif index == 1:
                env["DGEN_TPU_FAULTS"] = f"serve_replica_hang@{hang_at}:hang"
                env[HANG_ENV] = str(hang_s)
        return env

    fleet_cfg = FleetConfig(n_replicas=replicas, port=0, poll_interval_s=0.1,
                            request_timeout_s=forward_timeout_s, breaker_failures=2,
                            breaker_cooldown_s=1.0, retry_after_s=0.0,
                            metricz_interval_s=0.25)
    free_before = _card_free(device)
    sup = ReplicaSupervisor(default_replica_cmd(serve_argv), fleet_cfg,
                            env_for=env_for).start()
    try:
        rec = _drive_fleet(sup, fleet_cfg, expected=expected, n_real=n_real, years=years,
                           requests=requests, clients=clients, kill_at=kill_at,
                           hang_at=hang_at, hang_s=hang_s,
                           forward_timeout_s=forward_timeout_s,
                           max_client_retries=max_client_retries,
                           p99_bound_s=p99_bound_s, layers=layers,
                           steady_requests=steady_requests, device=device)
        if not rec["ok"]:
            rec["replica_logs_tail"] = _log_tails(sup)
    finally:
        # no path may leave replica processes behind; idempotent after the
        # drain of the success path
        sup.stop(drain=False, timeout=10.0)
        if work_dir is not None:
            shutil.rmtree(work_dir, ignore_errors=True)
        shutil.rmtree(sup.fleet_dir, ignore_errors=True)
    rec.update(replicas=replicas, agents=agents, bucket=bucket, device=device,
               oracle_warmup_s=round(oracle_warm_s, 3), surface_build_s=surface_build_s,
               drill_wall_s=round(time.perf_counter() - t_drill0, 3))
    rec["card_free_bytes"]["before_spawn"] = free_before
    logger.info("serve-fleet drill: %s (answered %d/%d, 503 retries %d, mismatches %d, "
                "kill recovery %s s, p99 %.3f s)", "ok" if rec["ok"] else "FAILED",
                rec["answered"], requests, rec["retries_503"], len(rec["mismatches"]),
                rec["kill"]["recovery_s"], rec["latency_s"]["p99"])
    return rec


class _Load:
    """Closed-loop clients through the front: each takes the next request
    (its position and plan number), retries 503s (Retry-After, at most
    ``max_retries``) and records the answer by position, or the failure,
    and the wall."""

    def __init__(self, port: int, n_real: int, years: list, timeout: float,
                 max_retries: int) -> None:
        self.port, self.n_real, self.years = port, n_real, years
        self.timeout, self.max_retries = timeout, max_retries
        self.answers: Dict[int, dict] = {}
        self.failures: List[dict] = []
        self.latencies: List[float] = []
        self.retries_503 = 0
        self._lock = threading.Lock()

    def run(self, plans, clients: int) -> float:
        """Ask plan numbers ``plans`` with ``clients`` threads; the wall."""
        from dgen_tpu_torch.serve.fleet import HTTP_ERRORS

        it = iter(enumerate(plans))
        take = threading.Lock()

        def client() -> None:
            while True:
                with take:
                    item = next(it, None)
                if item is None:
                    return
                k, n = item
                plan = _request_plan(n, self.n_real, self.years)
                t0 = time.monotonic()
                status, blob = None, b""
                for _ in range(self.max_retries + 1):
                    try:
                        status, blob, retry_after = _post(self.port, plan, self.timeout)
                    except HTTP_ERRORS as e:
                        status, blob, retry_after = -1, repr(e).encode(), None
                    # the contract: a 503 is the only failure a client retries
                    if status != 503:
                        break
                    with self._lock:
                        self.retries_503 += 1
                    time.sleep(min(float(retry_after or 0.1) or 0.1, 0.5))
                wall = time.monotonic() - t0
                with self._lock:
                    self.latencies.append(wall)
                    if status == 200:
                        self.answers[k] = json.loads(blob)
                    else:
                        self.failures.append({"k": k, "status": status,
                                              "body": blob[:200].decode("utf-8",
                                                                        "replace")})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, daemon=True, name=f"drill-client-{i}")
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600.0)
        return time.perf_counter() - t0


def _percentiles(lat: List[float]) -> dict:
    a = np.asarray(lat, dtype=np.float64)
    if not a.size:
        return {"p50": 0.0, "p99": 0.0, "max": 0.0}
    return {"p50": round(float(np.percentile(a, 50)), 4),
            "p99": round(float(np.percentile(a, 99)), 4),
            "max": round(float(a.max()), 4)}


def _drive_fleet(sup, fleet_cfg, *, expected, n_real, years, requests, clients, kill_at,
                 hang_at, hang_s, forward_timeout_s, max_client_retries, p99_bound_s,
                 layers, steady_requests, device) -> Dict[str, object]:
    """The fleet-facing half of the drill: load, faults, checks (under
    run_fleet_drill's ``finally``, which tears the fleet down)."""
    from dgen_tpu_torch.serve.fleet import HTTP_ERRORS
    from dgen_tpu_torch.serve.front import FleetFront, drain_front, start_front_in_thread

    booted = sup.wait_ready(timeout=fleet_cfg.boot_timeout_s)
    free_all_up = _card_free(device)
    boot_walls = {str(h.index): h.boot_wall_s for h in sup.replicas}
    boot_reports = {str(h.index): (_get(h.port, "/healthz") or {}).get("boot")
                    for h in sup.ready_handles()}
    front = FleetFront(sup, fleet_cfg).start()
    srv = start_front_in_thread(front)
    front_port = srv.server_address[1]
    client_timeout = 2 * forward_timeout_s + 10.0

    # the card's free memory once the killed replica's exit is seen
    after_kill: dict = {}
    stop_watch = threading.Event()

    def watch_kill() -> None:
        h0 = sup.replicas[0]
        while not stop_watch.is_set():
            if h0.exit_codes:
                after_kill["free"] = _card_free(device)
                return
            stop_watch.wait(0.02)

    watcher = threading.Thread(target=watch_kill, daemon=True, name="drill-kill-watch")
    watcher.start()
    load = _Load(front_port, n_real, years, client_timeout, max_client_retries)
    load_wall_s = load.run(range(requests), clients)
    recovered = sup.wait_ready(timeout=fleet_cfg.boot_timeout_s)
    stop_watch.set()
    watcher.join(timeout=5.0)
    free_recovered = _card_free(device)
    # a breaker the load left OPEN (its last forward failed) closes on its
    # HALF_OPEN probe: ask plan 0 again, a cooldown apart, until every
    # breaker is closed; each answer is held to the oracle's
    probes = []
    for _ in range(20):
        if all(front.breaker(h.index).state == "closed" for h in sup.replicas):
            break
        time.sleep(fleet_cfg.breaker_cooldown_s)
        try:
            status, blob, _ra = _post(front_port, _request_plan(0, n_real, years),
                                      client_timeout)
        except HTTP_ERRORS:
            status, blob = -1, b"{}"
        probes.append(status == 200
                      and (json.loads(blob).get("results") or [None])[0] == expected[0])

    # the layered repeat round: plans first asked before the kill, twice
    # each through the healed fleet (surface, then cache, hits)
    repeat_mismatches: List[int] = []
    repeat_failures = 0
    if layers:
        for k in range(min(12, len(expected))):
            plan = _request_plan(k, n_real, years)
            for _ask in range(2):
                status, blob = None, b""
                for _r in range(60):
                    try:
                        status, blob, _ra = _post(front_port, plan, client_timeout)
                    except HTTP_ERRORS:
                        status = -1
                    if status not in (503, -1):
                        break
                    time.sleep(0.1)
                if status != 200:
                    repeat_failures += 1
                elif (json.loads(blob).get("results") or [None])[0] != expected[k]:
                    repeat_mismatches.append(k)

    steady = None
    if steady_requests:
        st = _Load(front_port, n_real, years, client_timeout, max_client_retries)
        # the load's plans again, in order: each held to the oracle's answer
        wall = st.run([i % requests for i in range(steady_requests)], clients)
        bad = [k for k, got in st.answers.items()
               if (got.get("results") or [None])[0] != expected[k % requests]]
        steady = {"requests": steady_requests, "answered": len(st.answers),
                  "failures": st.failures, "retries_503": st.retries_503,
                  "wall_s": round(wall, 4), "qps": round(len(st.answers) / wall, 1),
                  "latency_s": _percentiles(st.latencies), "unchecked": len(bad)}

    mismatches = [k for k, got in sorted(load.answers.items())
                  if (got.get("results") or [None])[0] != expected[k]]
    kill_seen = KILL_EXIT_CODE in sup.replicas[0].exit_codes
    hang_fired = 0
    steady_compiles: Dict[str, Optional[int]] = {}
    replica_launches: Dict[str, dict] = {}
    surface_hits = 0
    engine_batches = 0
    cache = {"hits": 0, "misses": 0, "stores": 0, "evictions": 0}
    for h in sup.ready_handles():
        mz = _get(h.port, "/metricz") or {}
        steady_compiles[str(h.index)] = mz.get("steady_state_compiles")
        replica_launches[str(h.index)] = mz.get("kernel_launches")
        hang_fired += int((mz.get("faults_fired") or {}).get("serve_replica_hang", 0))
        surface_hits += int(mz.get("surface_hits", 0) or 0)
        engine_batches += int(mz.get("batches", 0) or 0)
        for key in cache:
            cache[key] += int((mz.get("result_cache") or {}).get(key, 0) or 0)
    h0 = sup.replicas[0]
    restart_boot = ((_get(h0.port, "/healthz") or {}).get("boot")
                    if h0.port is not None else None)
    lib = (restart_boot or {}).get("kernel_library") or {}
    on_card = torch.device(device).type == "cuda"
    restart_boot_ok = (lib.get("builds") == 0
                       and (lib.get("loads", 0) >= 1 if on_card else lib.get("loads") == 0))
    lat = _percentiles(load.latencies)
    breakers = {str(h.index): front.breaker(h.index).to_json() for h in sup.replicas}
    front_mz = front.metricz()
    drained = drain_front(front, srv)
    srv.server_close()

    compiles_clean = bool(steady_compiles) and all(c == 0 for c in steady_compiles.values())
    hung_closed = len(sup.replicas) < 2 or (breakers["1"]["state"] == "closed"
                                            and breakers["1"]["times_opened"] >= 1)
    layers_ok = (not layers) or bool(surface_hits > 0 and cache["hits"] > 0
                                     and engine_batches > 0 and not repeat_mismatches
                                     and repeat_failures == 0)
    steady_ok = steady is None or (steady["answered"] == steady_requests
                                   and not steady["failures"] and not steady["unchecked"])
    ok = bool(booted and len(load.answers) == requests and not load.failures
              and not mismatches and all(probes) and recovered and kill_seen
              and (hang_fired >= 1 if len(sup.replicas) > 1 else True)
              and hung_closed and compiles_clean and restart_boot_ok
              and lat["p99"] <= p99_bound_s and layers_ok and steady_ok)
    return {
        "ok": ok,
        "requests": requests,
        "answered": len(load.answers),
        "mismatches": mismatches,
        "client_failures": load.failures,
        "retries_503": load.retries_503,
        "booted": booted,
        "recovered_full_strength": recovered,
        "boot_wall_s": boot_walls,
        "kill": {"spec": f"serve_replica_kill@{kill_at}:kill",
                 "exit_77_seen": kill_seen, "recovery_s": h0.last_recovery_s,
                 "restart_boot_wall_s": h0.boot_wall_s, "restart_boot": restart_boot,
                 "restart_boot_ok": restart_boot_ok},
        "hang": {"spec": f"serve_replica_hang@{hang_at}:hang", "hang_s": hang_s,
                 "fired": hang_fired, "breaker_closed_again": hung_closed,
                 "probes_after_load": len(probes)},
        "breakers": breakers,
        "steady_state_compiles": steady_compiles,
        "replica_kernel_launches": replica_launches,
        "layers": ({"surface_hits": surface_hits, "result_cache": cache,
                    "engine_batches": engine_batches,
                    "repeat_mismatches": repeat_mismatches,
                    "repeat_failures": repeat_failures} if layers else None),
        "latency_s": dict(lat, p99_bound_s=p99_bound_s),
        "load_wall_s": round(load_wall_s, 4),
        "qps_through_faults": round(len(load.answers) / load_wall_s, 1),
        "steady": steady,
        "front": {k: front_mz.get(k) for k in ("requests", "shed", "retries",
                                               "forward_failures", "unrouted")},
        "card_free_bytes": {"all_up": free_all_up, "after_kill": after_kill.get("free"),
                            "recovered": free_recovered},
        "boot": boot_reports,
        "drained": drained,
        "supervisor_events": list(sup.events),
    }


def run_scale_drill(*, agents: int = 64, end_year: int = 2016, econ_years: int = 4,
                    sizing_iters: int = 6, bucket: int = 8, seed: int = 7,
                    ready_timeout_s: float = 180.0, surface_bucket: Optional[int] = None,
                    surface_years: Optional[List[int]] = None,
                    device="cuda") -> Dict[str, object]:
    """The autoscale and result-cache round trip: a one-replica fleet with
    the autoscaler on a synthetic signal, driven 1 -> 2 -> 1. Passes only
    if sustained synthetic pressure brings 2 READY replicas; a what-if
    asked twice comes back byte-identical both times and to the in-process
    oracle, with a result-cache hit counted; sustained idleness drains the
    fleet back to 1 (the retired replica exits on its SIGTERM drain, is not
    restarted and is no death); both scale events are in the fleet's
    ledger. ``device``: the replicas' and the oracle's (default the
    card)."""
    from dgen_tpu_torch.config import FleetConfig, resolve_device
    from dgen_tpu_torch.serve.autoscale import Autoscaler
    from dgen_tpu_torch.serve.fleet import STOPPED, ReplicaSupervisor, default_replica_cmd
    from dgen_tpu_torch.serve.front import FleetFront, drain_front, start_front_in_thread
    from dgen_tpu_torch.serve.server import rows_to_json
    from dgen_tpu_torch.serve.surface import build_surface

    device = str(resolve_device(device))
    t0 = time.perf_counter()
    work_dir = tempfile.mkdtemp(prefix="dgen-scale-drill-")
    surf_dir = os.path.join(work_dir, "surface")
    oracle, _ = _oracle(agents, end_year, seed, econ_years, sizing_iters, bucket, device)
    build_surface(oracle, surf_dir, surface_bucket or bucket, year_indices=surface_years)
    years = list(oracle.years)
    overrides = {"scale": {"itc_fraction": 0.5}}
    want = rows_to_json(oracle.query([1], year=years[0], overrides=overrides,
                                     bucket=bucket), cash_flow=False)[0]
    serve_argv = _serve_argv(agents, end_year, seed, econ_years, sizing_iters, bucket,
                             device) + ["--surface", surf_dir, "--cache-dir",
                                        os.path.join(work_dir, "resultcache")]
    cfg = FleetConfig(n_replicas=1, port=0, poll_interval_s=0.1,
                      boot_timeout_s=ready_timeout_s, request_timeout_s=10.0,
                      retry_after_s=0.0, metricz_interval_s=0.2, autoscale=True,
                      min_replicas=1, max_replicas=2, scale_up_queue_frac=0.5,
                      scale_up_occupancy=0.8, scale_up_sustain_s=0.3,
                      scale_down_queue_frac=0.05, scale_down_occupancy=0.2,
                      scale_down_sustain_s=0.3, scale_cooldown_s=0.5,
                      scale_interval_s=0.05)
    # a synthetic signal makes the round trip deterministic; this drill
    # gates the mechanism
    phase = {"hot": False}

    def signal_fn():
        return ({"queue_frac": 0.9, "occupancy": 0.95} if phase["hot"]
                else {"queue_frac": 0.0, "occupancy": 0.0})

    sup = ReplicaSupervisor(default_replica_cmd(serve_argv), cfg,
                            env_for=lambda i, n: _thread_env()).start()
    scaler = Autoscaler(sup, signal_fn, cfg)
    front = FleetFront(sup, cfg).start()
    srv = None
    try:
        booted = sup.wait_ready(n=1, timeout=ready_timeout_s)
        srv = start_front_in_thread(front)
        front_port = srv.server_address[1]
        scaler.start()
        body = {"agent_ids": [1], "year": years[0], "overrides": overrides}

        def ask():
            s, b, _ = _post(front_port, body, timeout=60.0)
            return s, ((json.loads(b).get("results") or [None])[0] if s == 200 else None)

        # round 1: a miss, the engine answers and stores (replica 0)
        s1, ans1 = ask()
        phase["hot"] = True
        scaled_up = sup.wait_ready(n=2, timeout=ready_timeout_s)
        scale_up_wall_s = (sup.replicas[1].boot_wall_s if len(sup.replicas) > 1
                           else None)
        # round 2 at full strength: from the cache, byte-identical
        s2, ans2 = ask()
        # let the scrapes pick the hit counters up (the freshness bound)
        time.sleep(3 * cfg.metricz_interval_s)
        mz_up = front.metricz()
        phase["hot"] = False
        scaled_down = False
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if sup.live_count() == 1:
                scaled_down = True
                break
            time.sleep(0.1)
        retired = [h for h in sup.replicas if h.state == STOPPED]
        retired_exited = False
        deadline = time.monotonic() + 30.0
        while retired and time.monotonic() < deadline:
            if all(h.proc is not None and h.proc.poll() is not None for h in retired):
                retired_exited = True
                break
            time.sleep(0.1)
        retired_codes = [h.proc.poll() for h in retired if h.proc is not None]
        still_one_ready = sup.wait_ready(n=1, timeout=30.0)
        events = [e["event"] for e in sup.events]
        cache_mz = mz_up.get("result_cache") or {}
        ok = bool(booted and scaled_up and scaled_down and retired_exited
                  and still_one_ready and s1 == 200 and s2 == 200
                  and ans1 is not None and ans1 == want and ans2 == want
                  and cache_mz.get("hits", 0) >= 1
                  and "autoscale_up" in events and "autoscale_down" in events
                  and not any(h.deaths for h in sup.replicas))
        rec = {
            "ok": ok,
            "device": device,
            "agents": agents,
            "booted": booted,
            "scaled_up": scaled_up,
            "scale_up_boot_wall_s": scale_up_wall_s,
            "scaled_down": scaled_down,
            "retired_exited": retired_exited,
            "retired_exit_codes": retired_codes,
            "back_to_one_ready": still_one_ready,
            "cache_answer_byte_identical": ans1 == want and ans2 == want,
            "result_cache": cache_mz,
            "surface_hits": mz_up.get("surface_hits"),
            "autoscale_events": list(scaler.events),
            "scale_ups": scaler.n_scale_up,
            "scale_downs": scaler.n_scale_down,
            "supervisor_events": [e for e in sup.events
                                  if e["event"].startswith(("autoscale", "scale"))],
        }
        if not ok:
            rec["replica_logs_tail"] = _log_tails(sup)
    finally:
        scaler.stop()
        if srv is not None:
            drain_front(front, srv)
            srv.server_close()
        sup.stop(drain=False, timeout=10.0)
        shutil.rmtree(work_dir, ignore_errors=True)
        shutil.rmtree(sup.fleet_dir, ignore_errors=True)
    rec["drill_wall_s"] = round(time.perf_counter() - t0, 3)
    logger.info("serve-scale drill: %s (up=%s down=%s cache_hits=%s)",
                "ok" if rec["ok"] else "FAILED", rec["scaled_up"], rec["scaled_down"],
                rec["result_cache"].get("hits"))
    return rec
