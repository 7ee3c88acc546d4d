"""Real replica processes of the port (``python -m dgen_tpu_torch.serve
--replica-index I --device cpu``) behind its routing front, with one
replica SIGKILLed mid-load (the kill-only round JAX's tier-1 keeps,
tests/test_fleet.py:530-586; the whole drill with the hang is ``slow``, in
tests/test_torch_fleet.py).

Every answer through the fleet equals, bit for bit, the in-process port
engine's ``rows_to_json(engine.query(ids, year=2016, bucket=4))`` over the
same synthetic population (64 agents, seed 7, a 4-year cash-flow horizon,
6 sizing candidates, buckets of 4 rows), and JAX's
``_rows_to_json(jax_engine.query(...))`` within tests/test_torch_serve.py's
bounds. The replicas' intra-op thread count is pinned to the test
process's (``OMP_NUM_THREADS``): on the CPU PyTorch's parallel reductions
can move the last bit with it. The fleet boots once for the module.
"""

import json
import signal

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu.serve import engine as jengine
from dgen_tpu.serve import server as jserver
from dgen_tpu_torch.config import FleetConfig
from dgen_tpu_torch.resilience.supervisor import RetryPolicy
from dgen_tpu_torch.serve.__main__ import build_sim
from dgen_tpu_torch.serve.engine import QUERY_FIELDS, ServeEngine
from dgen_tpu_torch.serve.fleet import READY, ReplicaSupervisor, default_replica_cmd, http_json
from dgen_tpu_torch.serve.front import FleetFront
from dgen_tpu_torch.serve.server import rows_to_json
from test_torch_serve import assert_close_to_jax

#: the world of tests/test_fleet.py's real-replica test
_REAL_SERVE_ARGS = [
    "--agents", "64", "--end-year", "2016", "--seed", "7",
    "--econ-years", "4", "--sizing-iters", "6",
    "--max-batch", "4", "--min-bucket", "4", "--max-wait-ms", "2",
    "--device", "cpu",
]
YEAR = 2016
BUCKET = 4
THREADS = 1
#: requests before the kill, after it, and one more once the fleet healed
BEFORE, AFTER = 4, 8


@pytest.fixture(scope="module")
def _pinned_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine(_pinned_threads):
    sim = build_sim(64, seed=7, end_year=YEAR, econ_years=4, sizing_iters=6, device="cpu")
    return ServeEngine(sim)


@pytest.fixture(scope="module")
def round_trip(engine, tmp_path_factory):
    """Boot 2 replicas, ask BEFORE queries, SIGKILL replica 0, ask AFTER
    more, wait for full strength, ask one more; the answers, the oracle's,
    and the replicas' probes."""
    cfg = FleetConfig(n_replicas=2, port=0, poll_interval_s=0.1, request_timeout_s=30.0,
                      breaker_failures=2, breaker_cooldown_s=0.5, retry_after_s=0.0,
                      metricz_interval_s=0.25)
    sup = ReplicaSupervisor(default_replica_cmd(_REAL_SERVE_ARGS), cfg,
                            policy=RetryPolicy(backoff_base_s=0.01, jitter_frac=0.0),
                            env_for=lambda i, n: {"OMP_NUM_THREADS": str(THREADS)},
                            fleet_dir=str(tmp_path_factory.mktemp("fleet"))).start()
    out = {"got": {}, "want": {}}
    try:
        assert sup.wait_ready(timeout=120.0), sup.summary()
        front = FleetFront(sup, cfg)

        def ask(k):
            ids = [k % engine.n_agents]
            code, blob, _hdr = front.route_query(
                json.dumps({"agent_ids": ids, "year": YEAR}).encode())
            assert code == 200, (k, code, blob)
            out["got"][k] = json.loads(blob)["results"][0]
            out["want"][k] = rows_to_json(engine.query(ids, year=YEAR, bucket=BUCKET),
                                          cash_flow=False)[0]

        for k in range(BEFORE):
            ask(k)
        assert sup.terminate_replica(0, signal.SIGKILL)
        for k in range(BEFORE, BEFORE + AFTER):
            ask(k)   # the failover path
        out["recovered"] = sup.wait_ready(timeout=120.0)
        ask(99)
        out["summary"] = sup.summary()
        out["healthz"] = {h.index: json.loads(http_json(h.port, "/healthz")[1])
                          for h in sup.ready_handles()}
        out["metricz"] = {h.index: json.loads(http_json(h.port, "/metricz")[1])
                          for h in sup.ready_handles()}
        out["states"] = sup.states()
        out["front"] = front.metricz()
    finally:
        sup.stop(drain=True, timeout=15.0)
    out["exited"] = [h.proc.poll() for h in sup.replicas]
    return out


def test_answers_through_a_kill_equal_the_in_process_engine_bit_for_bit(round_trip):
    got, want = round_trip["got"], round_trip["want"]
    assert len(got) == BEFORE + AFTER + 1
    for k in got:
        assert got[k] == want[k], f"request {k} differs from the in-process engine"
    assert sorted(got[0]) == sorted(f for f in QUERY_FIELDS if f != "cash_flow")


def test_answers_through_the_fleet_hold_jax_bounds(round_trip):
    """One JAX query over every agent asked (a bucket of 16): the rows,
    columnwise, within tests/test_torch_serve.py's bounds."""
    got = round_trip["got"]
    pop = jsynth.generate_population(64, seed=7)
    cfg = jcfg.ScenarioConfig(name="serve", start_year=2014, end_year=YEAR,
                              anchor_years=())
    inputs = jscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions)
    sim = JSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      jcfg.RunConfig(sizing_iters=6), econ_years=4)
    ids = sorted({row["agent_id"] for row in got.values()})
    ref_rows = jserver._rows_to_json(jengine.ServeEngine(sim).query(ids, year=YEAR,
                                                                    bucket=16), False)
    by_id = {row["agent_id"]: row for row in ref_rows}
    fields = [f for f in QUERY_FIELDS if f != "cash_flow"]
    keys = sorted(got)
    cols = {f: np.asarray([got[k][f] for k in keys], dtype=np.float64) for f in fields}
    refc = {f: np.asarray([by_id[got[k]["agent_id"]][f] for k in keys], dtype=np.float64)
            for f in fields}
    cols["cash_flow"] = refc["cash_flow"] = np.zeros((len(keys), 1))
    assert_close_to_jax(cols, refc)


def test_the_fleet_returns_to_full_strength_and_the_restart_builds_nothing(round_trip):
    assert round_trip["recovered"]
    assert round_trip["states"] == {0: READY, 1: READY}
    s0 = round_trip["summary"][0]
    assert s0["spawn_count"] == 2 and -signal.SIGKILL in s0["exit_codes"]
    assert s0["last_recovery_s"] is not None
    hz = round_trip["healthz"][0]
    assert hz["replica_index"] == 0 and hz["ready"]
    assert hz["boot"]["kernel_library"] == {"builds": 0, "loads": 0}
    assert round_trip["front"]["requests"] == BEFORE + AFTER + 1
    assert round_trip["exited"] == [0, 0]   # both drained on SIGTERM


def test_replicas_report_identity_and_nothing_built_after_warmup(round_trip):
    for i, mz in round_trip["metricz"].items():
        assert mz["replica_index"] == i
        assert mz["steady_state_compiles"] == 0
        assert mz["kernel_launches"] == {}   # the plain versions on the CPU
        assert mz["buckets"] == [BUCKET]
    assert round_trip["healthz"][0]["pid"] != round_trip["healthz"][1]["pid"]
