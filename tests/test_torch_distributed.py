"""The port's multi-rank run on the CPU: real separate ranks over gloo,
started as processes of the port's own entry point
(``python -m dgen_tpu_torch.parallel.launch``), on the two-process world
of tests/test_launch.py:189 (8 states, 96 agents, seed 3, the table
padded to 64 rows) with 2014-2018, storage at an attachment rate of 0.4,
the state-hourly aggregate and 32-row chunks.

One module fixture starts three 2-rank runs one after the other in the
background (state-partitioned with exports and checkpoints; row blocks,
whose groups straddle the ranks; tariff-clustered) and meanwhile runs
the port's single-process run and the JAX package's unsharded run of the
same world. The tests then hold, by ``agent_id``:

1. the state-partitioned ranks' per-agent outputs against the port's
   single-process run, at the JAX package's bound (rtol 5e-4, atol 1e-3,
   tests/test_simulation.py:90), printing how many values are not
   bit-equal (none, on the CPU);
2. battery units equal;
3. the same outputs against the JAX package's unsharded run;
4. the state-hourly aggregate within rtol 5e-4, atol 1e-4;
5. the row-block ranks (``partition_by_state=False``);
6. the clustered ranks against the unclustered single-process run;
7. the union of the ranks' ``year=<Y>-p<rank>`` export parts against the
   single-process export, row for row;
8. the ranks' 2016 checkpoint resumed by one process, whose 2018 equals
   the single-process run's bit for bit, and by two ranks, whose 2018
   equals the uninterrupted ranks' bit for bit;

and that no rank imported jax or dgen_tpu. Every process runs two
threads (a parallel CPU reduction can move the last bit with the thread
count). The ``slow`` test holds four ranks on a 2 x 2 mesh against the
JAX package's 8-device sharded run.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import checkpoint as ckpt
from dgen_tpu_torch.io import export
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models import simulation as sm
from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATES = ["DE", "CA", "TX", "NY", "FL", "WA", "CO", "IL"]
N_AGENTS, SEED, PAD, ITERS, ECON, CHUNK, RATE = 96, 3, 64, 6, 10, 32, 0.4
THREADS = 2
RTOL, ATOL = 5e-4, 1e-3

#: (name, extra launch arguments, extra environment)
RUNS = (
    ("states", [], {}),
    ("rows", ["--rows-partition", "--no-export", "--no-checkpoint"], {}),
    ("cluster", ["--no-export", "--no-checkpoint", "--pad-multiple", "16"],
     {"DGEN_TPU_CLUSTER": "1", "DGEN_TPU_AGENT_CHUNK": "0"}),
)


def spawn_ranks(out: str, world: int, extra=(), env_extra=None, timeout=600):
    """``world`` ranks of the launch entry point on a localhost gloo
    rendezvous; returns each rank's JSON record (the last line of its
    output) and the paths of their collected outputs."""
    os.makedirs(out, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "DGEN_COORDINATOR": f"127.0.0.1:{port}",
           "DGEN_NUM_PROCESSES": str(world), "DGEN_SHARD_STATES": ",".join(STATES),
           "PYTHONPATH": ROOT, "OMP_NUM_THREADS": str(THREADS),
           "DGEN_TPU_AGENT_CHUNK": str(CHUNK), **(env_extra or {})}
    cmd = [sys.executable, "-m", "dgen_tpu_torch.parallel.launch", "--device", "cpu",
           "--agents", str(N_AGENTS), "--end-year", "2018", "--seed", str(SEED),
           "--pad-multiple", str(PAD), "--sizing-iters", str(ITERS),
           "--econ-years", str(ECON), "--attachment-rate", str(RATE), "--with-hourly",
           "--run-dir", os.path.join(out, "run")]
    cmd += list(extra)
    logs = [open(os.path.join(out, f"p{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(cmd + ["--collect", os.path.join(out, f"r{r}.npz")],
                              env=dict(env, DGEN_PROCESS_ID=str(r)), stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT)
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
    return recs, [os.path.join(out, f"r{r}.npz") for r in range(world)]


def _port_world():
    pop = tsynth.generate_population(N_AGENTS, states=STATES, seed=SEED,
                                     pad_multiple=PAD, device="cpu")
    cfg = tcfg.ScenarioConfig(name="shard0", start_year=2014, end_year=2018,
                              anchor_years=())
    n_groups = len(tsynth.STATES) * 3
    inputs = tscen.uniform_inputs(
        cfg, n_groups=n_groups, n_regions=pop.n_regions, device="cpu",
        overrides={"attachment_rate": np.full(n_groups, RATE, np.float32)})
    return pop, cfg, inputs


def port_sim(**rc):
    pop, cfg, inputs = _port_world()
    return sm.Simulation(
        pop.table, pop.profiles, pop.tariffs, inputs, cfg,
        tcfg.RunConfig(sizing_iters=ITERS, agent_chunk=CHUNK, agent_pad_multiple=PAD, **rc),
        with_hourly=True, econ_years=ECON, device="cpu")


def _jax_run(mesh=None):
    pop = jsynth.generate_population(N_AGENTS, states=STATES, seed=SEED, pad_multiple=PAD)
    cfg = jcfg.ScenarioConfig(name="shard0", start_year=2014, end_year=2018,
                              anchor_years=())
    n_groups = len(jsynth.STATES) * 3
    inputs = jscen.uniform_inputs(
        cfg, n_groups=n_groups, n_regions=pop.n_regions,
        overrides={"attachment_rate": np.full(n_groups, RATE, np.float32)})
    sim = JSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      jcfg.RunConfig(sizing_iters=ITERS, agent_chunk=CHUNK,
                                     agent_pad_multiple=PAD),
                      with_hourly=True, econ_years=ECON, mesh=mesh)
    res = sim.run()
    keep = np.asarray(sim.host_mask) > 0
    return by_id(np.asarray(sim.host_agent_id)[keep],
                 {f: res.agent[f][:, keep] for f in COLLECT_FIELDS}), res


def by_id(ids, fields):
    o = np.argsort(ids, kind="stable")
    return {"agent_id": ids[o], **{f: v[:, o] for f, v in fields.items()}}


def ranks_by_id(paths):
    parts = [np.load(p) for p in paths]
    ids = np.concatenate([p["agent_id"] for p in parts])
    fields = {f: np.concatenate([p[f] for p in parts], axis=1) for f in COLLECT_FIELDS}
    return by_id(ids, fields), parts


def compare(got, want, rtol=RTOL, atol=ATOL):
    """Per-agent parity at the bound; returns the count of values that
    are not bit-equal."""
    assert np.array_equal(got["agent_id"], want["agent_id"])
    differ = 0
    for f in COLLECT_FIELDS:
        a, b = got[f], want[f]
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f)
        differ += int((a.view(np.uint32) != b.view(np.uint32)).sum())
    return differ


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("ranks")
    spawned, errors = {}, []

    def background():
        try:
            for name, extra, env in RUNS:
                spawned[name] = spawn_ranks(str(base / name), 2, extra, env)
            # the state-partitioned run's checkpoints without 2018: two
            # ranks resume from 2016 (rank 0's year, broadcast)
            shutil.copytree(base / "states" / "run" / "ckpt", base / "resume" / "run" / "ckpt")
            for r in (0, 1):
                shutil.rmtree(base / "resume" / "run" / "ckpt" / ckpt.part_dir_name(2018, r, 2))
            spawned["resume"] = spawn_ranks(str(base / "resume"), 2, ["--no-export"])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    t = threading.Thread(target=background)
    t.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        ref = port_sim()
        ref_dir = str(base / "single")
        exporter = export.RunExporter(ref_dir, agent_id=ref.host_agent_id,
                                      mask=ref.host_mask, state_names=list(tsynth.STATES),
                                      compact=False)
        ref_res = ref.run(callback=exporter)
        jax_ids, jax_res = _jax_run()
    finally:
        torch.set_num_threads(threads)
        t.join()
    if errors:
        raise errors[0]
    keep = ref.host_mask > 0
    ref_ids = by_id(ref.host_agent_id[keep],
                    {f: ref_res.agent[f][:, keep] for f in COLLECT_FIELDS})
    return dict(base=base, ref=ref, ref_res=ref_res, ref_ids=ref_ids, ref_dir=ref_dir,
                jax_ids=jax_ids, jax_res=jax_res, spawned=spawned)


def test_ranks_hold_state_shards_and_import_no_jax(world):
    recs, _ = world["spawned"]["states"]
    assert [r["rank"] for r in recs] == [0, 1]
    for r in recs:
        assert r["world"] == 2 and r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["years"] == [2014, 2016, 2018] and r["agent_chunk"] == CHUNK
        assert r["rows"] == PAD and r["agents"] > 0
        assert r["imports_jax"] is False and r["imports_dgen_tpu"] is False
    assert sum(r["agents"] for r in recs) == N_AGENTS


def test_state_shards_equal_the_single_process_run(world):
    got, _ = ranks_by_id(world["spawned"]["states"][1])
    differ = compare(got, world["ref_ids"])
    print(f"state-partitioned ranks vs one process: {differ} values not bit-equal")
    assert differ == 0


def test_battery_units_equal(world):
    got, _ = ranks_by_id(world["spawned"]["states"][1])
    want = world["ref_ids"]
    for f in ("new_batt_adopters", "batt_adopters_cum"):
        assert np.array_equal(got[f], want[f]), f
    assert want["new_batt_adopters"].sum(axis=1).min() > 0


def test_state_shards_equal_the_jax_unsharded_run(world):
    got, _ = ranks_by_id(world["spawned"]["states"][1])
    differ = compare(got, world["jax_ids"])
    print(f"state-partitioned ranks vs the JAX package: {differ} values not bit-equal")
    assert np.array_equal(got["new_batt_adopters"], world["jax_ids"]["new_batt_adopters"])


def test_state_hourly_aggregate(world):
    _, parts = ranks_by_id(world["spawned"]["states"][1])
    h0, h1 = (p["state_hourly_net_mw"] for p in parts)
    assert np.array_equal(h0, h1)   # every rank holds the combined aggregate
    np.testing.assert_allclose(h0, world["ref_res"].state_hourly_net_mw,
                               rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(h0, np.asarray(world["jax_res"].state_hourly_net_mw),
                               rtol=5e-4, atol=1e-4)
    assert np.abs(h0).max() > 0


def test_row_blocks_straddling_groups(world):
    recs, paths = world["spawned"]["rows"]
    assert [r["years"] for r in recs] == [[2014, 2016, 2018]] * 2
    got, parts = ranks_by_id(paths)
    differ = compare(got, world["ref_ids"])
    print(f"row-block ranks vs one process: {differ} values not bit-equal")
    assert np.array_equal(got["new_batt_adopters"], world["ref_ids"]["new_batt_adopters"])
    # the row blocks follow the input order: rank 0's ids precede rank 1's
    assert parts[0]["agent_id"].max() < parts[1]["agent_id"].min()
    np.testing.assert_allclose(parts[0]["state_hourly_net_mw"],
                               world["ref_res"].state_hourly_net_mw, rtol=5e-4, atol=1e-4)


def test_clustered_ranks_against_unclustered(world):
    recs, paths = world["spawned"]["cluster"]
    got, _ = ranks_by_id(paths)
    differ = compare(got, world["ref_ids"])
    print(f"clustered ranks vs unclustered one process: {differ} values not bit-equal")
    assert np.array_equal(got["new_batt_adopters"], world["ref_ids"]["new_batt_adopters"])
    assert all(r["agent_chunk"] == 0 for r in recs)


def test_export_parts_union_equals_the_single_process_export(world):
    run_dir = str(world["base"] / "states" / "run")
    for surface in ("agent_outputs", "finance_series"):
        names = sorted(os.listdir(os.path.join(run_dir, surface)))
        assert names == [f"year={y}-p{r}.npz" for y in (2014, 2016, 2018)
                         for r in (0, 1)], names
        got = export.load_surface(run_dir, surface)
        want = export.load_surface(world["ref_dir"], surface)
        ko = np.lexsort((got["agent_id"], got["year"]))
        wo = np.lexsort((want["agent_id"], want["year"]))
        cols = [c for c in got if c != "energy_value"]
        assert set(cols) <= set(want)
        for c in cols:
            assert np.array_equal(got[c][ko], want[c][wo]), (surface, c)
    hourly = sorted(os.listdir(os.path.join(run_dir, "state_hourly")))
    assert hourly == [f"year={y}.npz" for y in (2014, 2016, 2018)]
    got = export.load_surface(run_dir, "state_hourly")
    want = export.load_surface(world["ref_dir"], "state_hourly")
    assert np.array_equal(got["state"], want["state"])
    np.testing.assert_allclose(got["net_load_mw"], want["net_load_mw"],
                               rtol=5e-4, atol=1e-4)
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["n_processes"] == 2 and meta["distributed"] is True
    assert meta["export_quantized"] is False


def test_two_rank_checkpoint_resumed_by_two_ranks(world):
    recs, paths = world["spawned"]["resume"]
    assert [r["years"] for r in recs] == [[2018]] * 2
    got, _ = ranks_by_id(paths)
    want, _ = ranks_by_id(world["spawned"]["states"][1])
    for f in COLLECT_FIELDS:
        assert np.array_equal(got[f][0], want[f][2]), f


def test_two_rank_checkpoint_resumed_by_one_process(world):
    from dgen_tpu_torch.parallel import elastic

    ckpt_dir = str(world["base"] / "states" / "run" / "ckpt")
    assert ckpt.valid_years(ckpt_dir) == [2014, 2016, 2018]
    assert elastic.is_sharded(ckpt_dir, 2016)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        sim = port_sim()
        res = sim.run(checkpoint_dir=ckpt_dir, resume=True, resume_year=2016)
    finally:
        torch.set_num_threads(threads)
    assert res.years == [2018]
    ref = world["ref_res"]
    for f in COLLECT_FIELDS:
        assert np.array_equal(res.agent[f][0], ref.agent[f][2]), f


@pytest.mark.slow
def test_four_ranks_on_a_2x2_mesh_against_the_jax_sharded_run(tmp_path):
    from dgen_tpu.parallel.mesh import make_mesh

    recs, paths = spawn_ranks(str(tmp_path / "mesh"), 4, ["--no-export"],
                              {"DGEN_TPU_MESH": "2x2"})
    assert [r["mesh"] for r in recs] == [[2, 2]] * 4
    assert sum(r["agents"] for r in recs) == N_AGENTS
    got, _ = ranks_by_id(paths)
    jax_mesh = make_mesh()
    assert jax_mesh.devices.size == 8
    want, _ = _jax_run(mesh=jax_mesh)
    differ = compare(got, want)
    print(f"2x2 ranks vs the JAX package's 8-device run: {differ} values not bit-equal")
    assert np.array_equal(got["new_batt_adopters"], want["new_batt_adopters"])
