"""A real gang of the port's ranks on the CPU: two gloo rank processes of
``python -m dgen_tpu_torch.resilience.gangworker`` under the
``GangSupervisor``, 256 agents over DE and CA (seed 11), model years
2014-2018, a 10-year cash-flow horizon.

``run_gang_drill`` runs a clean gang and a gang whose rank 1 is killed
at its last year's export (``gang_worker_kill@3:kill``): the supervisor
tears both ranks down, relaunches them from the merged manifest frontier
(2016) and they resume from the 2016 checkpoint. Held here:

1. the killed gang's parts equal the clean gang's byte for byte, and its
   merged manifest verifies;
2. both gangs' merged exports equal one process's run of the same world,
   per agent id, bit for bit, every battery unit included;
3. both gangs' merged exports hold against the JAX package's run of the
   world its own gang worker builds from the same env, per agent id,
   within the sharded bound (rtol 5e-4, atol 1e-3), battery units equal;
4. the supervisor's record of the death (the rank, its exit code, the
   detection and teardown walls, the relaunch wall) and that no rank
   imported jax or dgen_tpu.

The ranks and this process run two intra-op threads (a parallel CPU
reduction can move the last bit with the thread count). The ``slow``
test runs the drill's four rounds at P = 4 -> P' = 2 under the contract
of tests/test_gang.py::test_gang_drill_kill_and_elastic, with its merged
exports held against the JAX package's run of the same world.
"""

import os

import numpy as np
import pytest
import torch

from dgen_tpu_torch.io.export import AGENT_OUTPUT_FIELDS
from dgen_tpu_torch.resilience.gangdrill import _read_rows, run_gang_drill

AGENTS, END_YEAR, ECON, THREADS = 256, 2018, 10, 2
WORLD_ENV = {"DGEN_GANG_ECON_YEARS": str(ECON), "DGEN_GANG_STATES": "DE,CA"}
#: the JAX package's bound for a sharded run against an unsharded one
RTOL, ATOL = 5e-4, 1e-3
BATTERY_UNITS = ("new_batt_adopters", "batt_adopters_cum")


def merged(run_dir: str) -> dict:
    """A gang run's agent_outputs parts, year by year, sorted by agent id."""
    d = os.path.join(run_dir, "agent_outputs")
    years = sorted({int(n.split("=")[1].split("-")[0].split(".")[0])
                    for n in os.listdir(d) if n.endswith(".npz")})
    out = {}
    for y in years:
        names = [n for n in os.listdir(d) if n.startswith(f"year={y}")
                 and n.endswith(".npz")]
        out[y] = _read_rows([os.path.join(d, n) for n in sorted(names)])
    return out


WORKER_ENV = {"DGEN_AGENTS": str(AGENTS), "DGEN_END_YEAR": str(END_YEAR),
              "DGEN_GANG_SIZING_ITERS": "6", **WORLD_ENV}


def with_worker_env(build, env=WORKER_ENV):
    """``build()`` under the gang worker's ``env``, the environment
    restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return build()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def by_year(years, agent, host_agent_id, host_mask) -> dict:
    """A run's per-agent outputs, year by year, sorted by agent id."""
    keep = np.asarray(host_mask) > 0
    ids = np.asarray(host_agent_id)[keep].astype(np.int64)
    o = np.argsort(ids, kind="stable")
    return {int(y): {"agent_id": ids[o], **{f: np.asarray(agent[f][yi])[keep][o]
                                            for f in AGENT_OUTPUT_FIELDS}}
            for yi, y in enumerate(years)}


def single_process() -> dict:
    """The gang's world run by one process (through the worker's own
    ``build_world``), per year by agent id."""
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.resilience.gangworker import build_world

    pop, cfg, inputs, with_hourly, rc = with_worker_env(
        lambda: build_world(torch.device("cpu")))
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                     with_hourly=with_hourly, econ_years=ECON, device="cpu")
    res = sim.run()
    return by_year(res.years, res.agent, sim.host_agent_id, sim.host_mask)


def jax_package(agents: int = AGENTS, econ: int = ECON, env=WORKER_ENV) -> dict:
    """The JAX package's unsharded run of the world its gang worker
    (dgen_tpu/resilience/gangworker.py) builds from the same ``env``: the
    DE,CA synthetic population of ``agents``, uniform inputs,
    ``RunConfig.from_env``, ``econ`` cash-flow years; per year by agent
    id."""
    from dgen_tpu.config import RunConfig, ScenarioConfig
    from dgen_tpu.io import synth
    from dgen_tpu.models import scenario as scen
    from dgen_tpu.models.simulation import Simulation

    def build():
        cfg = ScenarioConfig(name="gang", start_year=2014, end_year=END_YEAR,
                             anchor_years=())
        pop = synth.generate_population(agents, states=["DE", "CA"], seed=11,
                                        pad_multiple=64)
        inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                     n_regions=pop.n_regions)
        return pop, cfg, inputs, RunConfig.from_env(sizing_iters=6)

    pop, cfg, inputs, rc = with_worker_env(build, env)
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                     econ_years=econ)
    res = sim.run()
    return by_year(res.years, res.agent, sim.host_agent_id, sim.host_mask)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gang"))
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        rec = run_gang_drill(root, processes=2, shrink_to=0, agents=AGENTS,
                             end_year=END_YEAR, stall=False, device="cpu",
                             threads=THREADS, world_env=WORLD_ENV, kill_hit=3)
        one = single_process()
    finally:
        torch.set_num_threads(n)
    return root, rec, one, jax_package()


def test_killed_gang_equals_the_clean_gang_byte_for_byte(drill):
    root, rec, _, _ = drill
    assert rec["ok"], rec
    assert set(rec["rounds"]) == {"baseline", "kill"}
    base, kill = rec["rounds"]["baseline"], rec["rounds"]["kill"]
    assert base["restarts"] == 0 and base["verify_ok"]
    assert kill["restarts"] == 1 and kill["verify_ok"]
    # every year of both surfaces compared, each part byte for byte
    assert kill["parts"]["compared"] == 6 and not kill["parts"]["mismatched"]
    assert not kill["parts"]["row_compared_years"]
    assert kill["completed_through"] == END_YEAR


def test_the_relaunch_resumed_from_the_frontier(drill):
    _, rec, _, _ = drill
    kill = rec["rounds"]["kill"]
    died, done = kill["attempts"]
    assert (died["outcome"], died["reason"], died["worker"]) == ("died", "worker_exit", 1)
    assert died["exit_code"] == 77           # faults.KILL_EXIT_CODE
    assert died["detect_s"] is not None and died["detect_s"] < 5.0
    assert died["teardown_s"] is not None and died["teardown_s"] < 30.0
    assert done["outcome"] == "complete"
    assert kill["relaunch_wall_s"] is not None and kill["relaunch_wall_s"] > 0
    assert [r["resumed_after"] for r in kill["ranks"]] == [2016, 2016]
    assert all(r["years_run"] == [2018] for r in kill["ranks"])
    for r in rec["rounds"]["baseline"]["ranks"] + kill["ranks"]:
        assert not r["imports_jax"] and not r["imports_dgen_tpu"]


@pytest.mark.parametrize("round_name", ["baseline", "kill"])
def test_merged_export_equals_one_process_bit_for_bit(drill, round_name):
    root, _, one, _ = drill
    got = merged(os.path.join(root, round_name))
    assert sorted(got) == sorted(one) == [2014, 2016, 2018]
    for y, want in one.items():
        assert np.array_equal(got[y]["agent_id"], want["agent_id"]), y
        for f in AGENT_OUTPUT_FIELDS:
            assert got[y][f].tobytes() == want[f].tobytes(), (round_name, y, f)
    assert float(one[END_YEAR]["number_of_adopters"].sum()) > 0


def hold_against_jax(run_dir: str, want_all: dict, tag: str) -> None:
    """A gang run's merged export against the JAX package's run, per
    agent id: within RTOL/ATOL, battery units equal."""
    got = merged(run_dir)
    assert sorted(got) == sorted(want_all) == [2014, 2016, 2018]
    for y, want in want_all.items():
        assert np.array_equal(got[y]["agent_id"], want["agent_id"]), (tag, y)
        for f in AGENT_OUTPUT_FIELDS:
            a, b = got[y][f], want[f]
            assert a.shape == b.shape, (tag, y, f)
            if f in BATTERY_UNITS:
                assert np.array_equal(a, b), (tag, y, f)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{tag} {y} {f}")
    assert float(want_all[END_YEAR]["number_of_adopters"].sum()) > 0


@pytest.mark.parametrize("round_name", ["baseline", "kill"])
def test_merged_export_holds_against_the_jax_package(drill, round_name):
    root, _, _, want_all = drill
    hold_against_jax(os.path.join(root, round_name), want_all, round_name)


@pytest.mark.slow
def test_gang_drill_kill_stall_and_elastic_four_to_two(tmp_path):
    """The drill's four rounds at P = 4 -> P' = 2 over gloo (96 agents,
    2014-2018), under tests/test_gang.py::test_gang_drill_kill_and_elastic's
    contract: the kill recovered with every part byte for byte, the stall
    caught by its heartbeat, the synchronized stop through 2014 and the
    P' = 2 resume row for row (bit for bit in the port), the merged
    verify clean."""
    rec = run_gang_drill(str(tmp_path), processes=4, shrink_to=2, agents=96,
                         end_year=2018, stall=True, device="cpu")
    assert rec["ok"], rec
    assert rec["rounds"]["kill"]["restarts"] >= 1
    assert rec["rounds"]["kill"]["parts"]["mismatched"] == []
    assert any(a["reason"] == "heartbeat_stall" for a in rec["rounds"]["stall"]["attempts"])
    el = rec["rounds"]["elastic"]
    assert el["stopped_through"] == 2014
    assert el["parts"]["row_compared_years"]
    assert el["restore_bitexact"] and el["verify_ok"]
    want = jax_package(agents=96, econ=25, env={
        "DGEN_AGENTS": "96", "DGEN_END_YEAR": "2018", "DGEN_GANG_SIZING_ITERS": "6"})
    for name in ("baseline", "kill", "stall", "elastic"):
        hold_against_jax(str(tmp_path / name), want, name)
