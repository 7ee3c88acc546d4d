"""The sweep and the ensemble on ranks (``SweepSimulation(ranks=)``,
``EnsembleSimulation(ranks=)``) on the CPU: two real rank processes over
gloo, on the world of tests/test_torch_sweep.py and
tests/test_torch_ensemble.py (96 agents over DE and CA, seed 11, 2014-2016,
sizing_iters 6, a 5-year cash-flow horizon, a tripled retail price,
batteries attached at 0.3).

One module fixture starts the two ranks in the background (each builds
the world, runs a sweep of ITC 0.30 and 0.0 and an E = 2 ensemble under
DEFAULT_DRAWS, seed 3, and rank 0 saves the gathered results) and
meanwhile runs the same sweep and ensemble in this process. The tests
hold, by ``agent_id``:

1. every scenario of the ranked sweep against the single-process sweep,
   bit for bit, and its plan (the scenario-major loop, the ranks' grid);
2. every member of the ranked ensemble against the single-process
   ensemble, bit for bit, and its quantile bands within rtol 1e-6 (the
   ranks' partial sums are summed in another order);
3. that no rank imported jax or dgen_tpu.

Every process runs one intra-op thread (a parallel CPU reduction can move
the last bit with the thread count). The ``slow`` tests hold the ranked
sweep against the JAX package's sweep on its 8-device CPU mesh under
tests/test_sweep.py's tolerance (rtol 5e-4, atol 1e-3), and the
clustered run against the unclustered one on eight ranks of a 2 x 4 grid
(tests/test_tariffcluster.py's 2x4 parity, rtol = atol = 1e-5).
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.ensemble import DEFAULT_DRAWS, EnsembleSimulation
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.sweep import MODE_LOOP, SweepSimulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECON = 5
POP_KW = dict(states=["DE", "CA"], seed=11, pad_multiple=32)
CFG = tcfg.ScenarioConfig(name="sweep-t", start_year=2014, end_year=2016, anchor_years=())
RC = tcfg.RunConfig(sizing_iters=6)
ITCS = (0.30, 0.0)
FIELDS = ("system_kw", "npv", "payback_period", "number_of_adopters", "system_kw_cum",
          "batt_kwh_cum", "new_batt_adopters", "market_share", "cash_flow")
TIMEOUT_S = 600

#: what each rank runs (``python -c``): the world, the ranked sweep and
#: ensemble, rank 0's gathered results saved to sys.argv[1]
RANK_SCRIPT = r'''
import json, sys
import numpy as np
import torch
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.ensemble import DEFAULT_DRAWS, EnsembleSimulation
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.parallel.launch import initialize_multihost
from dgen_tpu_torch.parallel.mesh import shutdown
from dgen_tpu_torch.sweep import SweepSimulation

torch.set_num_threads(1)
topo = initialize_multihost(device="cpu")
cfg = tcfg.ScenarioConfig(name="sweep-t", start_year=2014, end_year=2016, anchor_years=())
pop = tsynth.generate_population(96, device="cpu", states=["DE", "CA"], seed=11,
                                 pad_multiple=32)
y = len(cfg.model_years)

def inputs(itc):
    return tscen.uniform_inputs(cfg, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
        device="cpu", overrides={
            "itc_fraction": np.full((y, 3), itc, np.float32),
            "elec_price_multiplier": np.full((y, pop.n_regions, 3), 3.0, np.float32),
            "attachment_rate": np.full(pop.table.n_groups, 0.3, np.float32)})

rc = tcfg.RunConfig(sizing_iters=6)
sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs, [inputs(0.30), inputs(0.0)],
                        cfg, rc, econ_years=5, ranks=topo)
res = sweep.run()
ens = EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, inputs(0.30), cfg, rc,
                         econ_years=5, n_members=2, seed=3, draws=DEFAULT_DRAWS, ranks=topo)
eres = ens.run(collect=True)
if topo.rank == 0:
    out = {"sweep_ids": res.host_agent_id, "sweep_mask": res.host_mask,
           "ens_ids": eres.host_agent_id, "ens_mask": eres.host_mask}
    for s, run in enumerate(res.runs):
        for k, v in run.agent.items():
            out[f"sweep{s}/{k}"] = v
    for m, run in enumerate(eres.runs):
        for k, v in run.agent.items():
            out[f"ens{m}/{k}"] = v
    for k, v in eres.quantiles.national.items():
        out[f"band/{k}"] = v
    np.savez(sys.argv[1], **out)
print(json.dumps({"rank": topo.rank, "world": topo.world_size, "mesh": list(topo.shape),
                  "plan_modes": [g.mode for g in sweep.plan.groups],
                  "plan_mesh": list(sweep.plan.mesh_shape), "ens_mode": ens.mode,
                  "imports_jax": sys.modules.get("jax") is not None,
                  "imports_dgen_tpu": sys.modules.get("dgen_tpu") is not None}))
shutdown()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmd_for, world: int, out: str, env_extra=None, timeout=TIMEOUT_S) -> list:
    """``world`` rank processes (``cmd_for(rank)`` each) on a localhost gloo
    rendezvous; returns each rank's JSON record (its last output line)."""
    os.makedirs(out, exist_ok=True)
    env = {**os.environ, "DGEN_COORDINATOR": f"127.0.0.1:{free_port()}",
           "DGEN_NUM_PROCESSES": str(world), "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           **(env_extra or {})}
    logs = [open(os.path.join(out, f"p{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(cmd_for(r), env=dict(env, DGEN_PROCESS_ID=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True, cwd=ROOT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        assert p.returncode == 0, f"rank {r}: {text[-3000:]}"
        recs.append(json.loads(text.strip().splitlines()[-1]))
    return recs


def t_inputs(pop, itc):
    y = len(CFG.model_years)
    return tscen.uniform_inputs(CFG, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
                                device="cpu", overrides={
                                    "itc_fraction": np.full((y, 3), itc, np.float32),
                                    "elec_price_multiplier": np.full(
                                        (y, pop.n_regions, 3), 3.0, np.float32),
                                    "attachment_rate": np.full(pop.table.n_groups, 0.3,
                                                               np.float32)})


def by_id(agent: dict, ids, mask) -> dict:
    """A run's per-agent ``[Y, N, ...]`` fields over its real agents,
    sorted by agent id."""
    keep = np.asarray(mask) > 0
    kid = np.asarray(ids)[keep].astype(np.int64)
    o = np.argsort(kid, kind="stable")
    return {"agent_id": kid[o], **{k: np.asarray(v)[:, keep][:, o] for k, v in agent.items()}}


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The two ranks' gathered results beside this process's sweep and
    ensemble of the same world."""
    work = str(tmp_path_factory.mktemp("ranks"))
    path = os.path.join(work, "ranked.npz")
    box = {}

    def go():
        try:
            box["recs"] = spawn(lambda r: [sys.executable, "-c", RANK_SCRIPT, path], 2,
                                work)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=go)
    t.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pop = tsynth.generate_population(96, device="cpu", **POP_KW)
        sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs,
                                [t_inputs(pop, v) for v in ITCS], CFG, RC, econ_years=ECON,
                                device="cpu")
        res = sweep.run()
        ens = EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, t_inputs(pop, 0.30),
                                 CFG, RC, econ_years=ECON, n_members=2, seed=3,
                                 draws=DEFAULT_DRAWS, device="cpu")
        eres = ens.run(collect=True)
    finally:
        torch.set_num_threads(n)
        t.join()
    if "err" in box:
        raise box["err"]
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    return dict(recs=box["recs"], got=got, res=res, eres=eres)


def test_ranks_plan_the_loop_and_import_no_jax(ranked):
    recs = ranked["recs"]
    assert [r["rank"] for r in recs] == [0, 1]
    for r in recs:
        assert r["plan_modes"] and all(m == MODE_LOOP for m in r["plan_modes"])
        assert r["plan_mesh"] == [1, 2] and r["ens_mode"] == MODE_LOOP
        assert not r["imports_jax"] and not r["imports_dgen_tpu"]


@pytest.mark.parametrize("s", range(len(ITCS)))
def test_ranked_sweep_equals_the_single_process_sweep(ranked, s):
    got, res = ranked["got"], ranked["res"]
    agent = {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(f"sweep{s}/")}
    a = by_id(agent, got["sweep_ids"], got["sweep_mask"])
    b = by_id(res.runs[s].agent, res.host_agent_id, res.host_mask)
    assert np.array_equal(a["agent_id"], b["agent_id"])
    assert set(agent) == set(res.runs[s].agent)
    for k in b:
        assert a[k].tobytes() == b[k].tobytes(), f"scenario {s}: {k}"
    assert float(b["number_of_adopters"][-1].sum()) > 0
    assert float(b["new_batt_adopters"].sum()) > 0


@pytest.mark.parametrize("m", range(2))
def test_ranked_ensemble_equals_the_single_process_ensemble(ranked, m):
    got, eres = ranked["got"], ranked["eres"]
    agent = {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(f"ens{m}/")}
    a = by_id(agent, got["ens_ids"], got["ens_mask"])
    b = by_id(eres.runs[m].agent, eres.host_agent_id, eres.host_mask)
    assert np.array_equal(a["agent_id"], b["agent_id"])
    for k in FIELDS:
        assert a[k].tobytes() == b[k].tobytes(), f"member {m}: {k}"


def test_ranked_ensemble_bands(ranked):
    got, stats = ranked["got"], ranked["eres"].quantiles
    for k, v in stats.national.items():
        np.testing.assert_allclose(got[f"band/{k}"], v, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.slow
def test_ranked_sweep_against_the_jax_meshed_sweep(ranked):
    """tests/test_sweep.py::test_sweep_on_mesh_matches_unmeshed's
    contract, across the packages: the ranked sweep against the JAX
    package's sweep on its 8-device CPU mesh, per agent id."""
    from dgen_tpu import config as jcfg
    from dgen_tpu.io import synth as jsynth
    from dgen_tpu.models import scenario as jscen
    from dgen_tpu.parallel.mesh import make_mesh
    from dgen_tpu.sweep import MODE_LOOP as J_LOOP
    from dgen_tpu.sweep import SweepSimulation as JSweep

    jpop = jsynth.generate_population(96, **POP_KW)
    jc = jcfg.ScenarioConfig(name="sweep-t", start_year=2014, end_year=2016,
                             anchor_years=())
    y = len(jc.model_years)

    def j_inputs(itc):
        return jscen.uniform_inputs(jc, n_groups=jpop.table.n_groups,
                                    n_regions=jpop.n_regions, overrides={
                                        "itc_fraction": np.full((y, 3), itc, np.float32),
                                        "elec_price_multiplier": np.full(
                                            (y, jpop.n_regions, 3), 3.0, np.float32),
                                        "attachment_rate": np.full(
                                            jpop.table.n_groups, 0.3, np.float32)})

    mesh = make_mesh()
    assert mesh.devices.size == 8
    sweep = JSweep(jpop.table, jpop.profiles, jpop.tariffs, [j_inputs(v) for v in ITCS],
                   jc, jcfg.RunConfig(sizing_iters=6), econ_years=ECON, mesh=mesh)
    assert all(g.mode == J_LOOP for g in sweep.plan.groups)
    res = sweep.run()
    got = ranked["got"]
    ids = np.asarray(sweep.base.table.agent_id)
    mask = np.asarray(sweep.base.table.mask)
    for s in range(len(ITCS)):
        agent = {k.split("/", 1)[1]: v for k, v in got.items()
                 if k.startswith(f"sweep{s}/")}
        a = by_id(agent, got["sweep_ids"], got["sweep_mask"])
        b = by_id({k: np.asarray(res.runs[s].agent[k]) for k in
                   ("system_kw_cum", "number_of_adopters", "npv")}, ids, mask)
        assert np.array_equal(a["agent_id"], b["agent_id"])
        for k in ("system_kw_cum", "number_of_adopters", "npv"):
            np.testing.assert_allclose(a[k], b[k], rtol=5e-4, atol=1e-3,
                                       err_msg=f"scenario {s}: {k}")


@pytest.mark.slow
def test_clustered_matches_unclustered_on_eight_ranks_of_a_2x4_grid(tmp_path):
    """tests/test_tariffcluster.py::test_clustered_matches_unclustered_2x4_mesh
    on eight gloo ranks (``DGEN_TPU_MESH=2x4``): its world (96 agents over
    DE, CA and TX, seed 7, padded to 32, sizing_iters 8, 2014-2016), the
    clustered ranks against the unclustered ranks and against one
    unclustered process, per agent id at rtol = atol = 1e-5."""
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

    def run(tag, env_extra):
        out = str(tmp_path / tag)

        def cmd(r):
            return [sys.executable, "-m", "dgen_tpu_torch.parallel.launch", "--device",
                    "cpu", "--agents", "96", "--seed", "7", "--pad-multiple", "32",
                    "--sizing-iters", "8", "--end-year", "2016", "--no-export",
                    "--no-checkpoint", "--collect", os.path.join(out, f"r{r}.npz")]

        recs = spawn(cmd, 8, out, {"DGEN_TPU_MESH": "2x4", "DGEN_SHARD_STATES": "DE,CA,TX",
                                   "DGEN_TPU_AGENT_CHUNK": "0", **env_extra})
        assert [r["mesh"] for r in recs] == [[2, 4]] * 8
        parts = [np.load(os.path.join(out, f"r{r}.npz")) for r in range(8)]
        ids = np.concatenate([p["agent_id"] for p in parts])
        o = np.argsort(ids, kind="stable")
        return {"agent_id": ids[o], **{f: np.concatenate([p[f] for p in parts], axis=1)[:, o]
                                       for f in COLLECT_FIELDS}}

    clustered = run("clustered", {"DGEN_TPU_CLUSTER": "1"})
    plain = run("plain", {})
    cfg = tcfg.ScenarioConfig(name="shard0", start_year=2014, end_year=2016,
                              anchor_years=())
    pop = tsynth.generate_population(96, states=["DE", "CA", "TX"], seed=7,
                                     pad_multiple=32, device="cpu")
    inputs = tscen.uniform_inputs(cfg, n_groups=len(tsynth.STATES) * 3,
                                  n_regions=pop.n_regions, device="cpu")
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                     tcfg.RunConfig(sizing_iters=8, agent_pad_multiple=32), device="cpu")
    one = by_id(sim.run().agent, sim.host_agent_id, sim.host_mask)
    for ref in (plain, one):
        assert np.array_equal(clustered["agent_id"], ref["agent_id"])
        for f in ("system_kw_cum", "number_of_adopters", "npv", "batt_kwh_cum"):
            np.testing.assert_allclose(clustered[f], ref[f], rtol=1e-5, atol=1e-5,
                                       err_msg=f)
