"""The host side of the port's multi-rank run, held to the JAX package's
``dgen_tpu/parallel/`` bit for bit: the state partition (flat and on a
2 x 2 grid) and ``partition_table``'s ``gather_rows``, the state binning
and launch lines, the mesh-shape parsing, the process-group bring-up's
no-op and its errors, and the resharded restore's topology check (the
contracts of tests/test_launch.py:28-80, tests/test_simulation.py:351,
tests/test_synth_national.py:199-211 and tests/test_gang.py:232-258);
then the per-rank checkpoint parts (a 2-rank year restored by one process
and by four ranks, bit for bit, by agent id), the shard ledgers and
export part names, ``RunConfig.from_env``'s ``DGEN_TPU_DEVICES``, and the
kernel wrappers' entering of their tensors' device. No process group is
started here (tests/test_torch_distributed.py starts ranks)."""

import ast
import os

import numpy as np
import pytest
import torch

from dgen_tpu.io import synth as jsynth
from dgen_tpu.parallel import elastic as jelastic
from dgen_tpu.parallel import launch as jlaunch
from dgen_tpu.parallel import mesh as jmesh
from dgen_tpu.parallel import partition as jpart
from dgen_tpu_torch.io import checkpoint as ckpt
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models.simulation import SimCarry
from dgen_tpu_torch.parallel import elastic, launch, mesh, partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATES = ["DE", "CA", "TX", "NY", "FL", "WA", "CO", "IL"]


def _parts_equal(a, b):
    assert np.array_equal(a.order, b.order)
    assert np.array_equal(a.shard_sizes, b.shard_sizes)
    assert a.shard_len == b.shard_len
    assert np.array_equal(a.device_of_state, b.device_of_state)
    assert a.device_of_state.dtype == b.device_of_state.dtype


@pytest.mark.parametrize("seed, n_states, n_dev, pad, shape", [
    (3, 7, 4, 8, None), (0, 12, 4, 16, (2, 2)), (5, 51, 8, 128, (2, 4)),
    (9, 3, 4, 8, None), (1, 12, 4, 1, (1, 4))])
def test_partition_by_state_equals_jax(seed, n_states, n_dev, pad, shape):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 400, n_states)
    state_idx = rng.permutation(np.repeat(np.arange(n_states), sizes))
    got = partition.partition_by_state(state_idx, n_states, n_dev, pad, mesh_shape=shape)
    want = jpart.partition_by_state(state_idx, n_states, n_dev, pad, mesh_shape=shape)
    _parts_equal(got, want)
    # every state's agents on exactly one rank, the order within a rank stable
    dev = got.device_of_state[state_idx[got.order]]
    starts = np.concatenate([[0], np.cumsum(got.shard_sizes)])
    for d in range(n_dev):
        seg = got.order[starts[d]:starts[d + 1]]
        assert np.all(dev[starts[d]:starts[d + 1]] == d)
        assert np.all(np.diff(seg) > 0)
    g, m = partition.apply_partition_indices(got, len(state_idx))
    jg, jm = jpart.apply_partition_indices(want, len(state_idx))
    assert np.array_equal(g, jg) and np.array_equal(m, jm)
    with pytest.raises(ValueError, match="does not cover"):
        partition.partition_by_state(state_idx, n_states, n_dev + 1, pad,
                                     mesh_shape=(2, 2))


@pytest.mark.parametrize("n_dev, shape", [(2, None), (4, (2, 2))])
def test_partition_table_equals_jax(n_dev, shape):
    kw = dict(states=STATES, seed=3, pad_multiple=64)
    pop = tsynth.generate_population(96, device="cpu", **kw)
    jpop = jsynth.generate_population(96, **kw)
    table, part = partition.partition_table(pop.table, n_dev, 16, mesh_shape=shape)
    jtable, jp = jpart.partition_table(jpop.table, n_dev, 16, mesh_shape=shape)
    _parts_equal(part, jp)
    assert np.array_equal(part.gather_rows, jp.gather_rows)
    for f in ("agent_id", "mask", "state_idx", "group_idx", "tariff_idx",
              "customers_in_bin", "nem_kw_limit"):
        assert np.array_equal(getattr(table, f).numpy(), np.asarray(getattr(jtable, f))), f
    # every state x sector group lives whole on one rank
    real = table.mask.numpy() > 0
    rank = np.arange(table.n_agents) // part.shard_len
    g = table.group_idx.numpy()
    for grp in np.unique(g[real]):
        assert len(np.unique(rank[real & (g == grp)])) == 1


def test_bin_states_and_shard_commands_equal_jax(monkeypatch):
    sizes = {"CA": 5000, "TX": 4000, "NY": 3000, "DE": 100, "VT": 50,
             "RI": 60, "WY": 40, "FL": 2500}
    for n_bins in (1, 2, 4, 5):
        assert launch.bin_states(sizes, n_bins).bins == jlaunch.bin_states(sizes, n_bins).bins
    assert launch.bin_states({}, 3).bins == jlaunch.bin_states({}, 3).bins
    bins = launch.bin_states({"CA": 10, "DE": 1, "TX": 8}, n_bins=2)
    cmds = launch.shard_commands(bins, entry="run")
    assert cmds == jlaunch.shard_commands(jlaunch.bin_states(
        {"CA": 10, "DE": 1, "TX": 8}, n_bins=2), entry="run")
    assert launch.shard_commands(bins)[0].endswith(
        "python -m dgen_tpu_torch.parallel.launch")
    states_str = cmds[1].split("DGEN_SHARD_STATES=")[1].split(" ")[0]
    monkeypatch.setenv("DGEN_SHARD_STATES", states_str)
    assert launch.shard_states_from_env() == jlaunch.shard_states_from_env() == bins.bins[1]
    monkeypatch.delenv("DGEN_SHARD_STATES")
    assert launch.shard_states_from_env() is None


@pytest.mark.parametrize("label", ["1x8", "2x4", "4X1", "2by4", "0x4", "2x", "axb",
                                   "1x2x3"])
def test_mesh_shape_parsing_equals_jax(label):
    try:
        want = jmesh.parse_mesh_shape(label)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_mesh_shape(label)
        assert str(got.value) == str(e)
    else:
        assert mesh.parse_mesh_shape(label) == want


def test_default_mesh_shape(monkeypatch):
    monkeypatch.delenv("DGEN_TPU_MESH", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    # one host: the flat grid, as the JAX package's single process
    assert mesh.default_mesh_shape(8) == jmesh.default_mesh_shape(8) == (1, 8)
    assert mesh.default_mesh_shape(1) == (1, 1)
    assert mesh.default_mesh_shape() == (1, 1)   # no process group
    # processes x local ranks
    assert mesh.default_mesh_shape(8, local_size=4) == (2, 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert mesh.default_mesh_shape(8) == (4, 2)
    monkeypatch.setenv("DGEN_TPU_MESH", "2x4")
    assert mesh.default_mesh_shape(8) == jmesh.default_mesh_shape(8) == (2, 4)
    monkeypatch.setenv("DGEN_TPU_MESH", "nonsense")
    with pytest.raises(ValueError, match="mesh shape"):
        mesh.default_mesh_shape(8)


def test_rank_topology_single_runs_no_collective():
    topo = mesh.RankTopology.single("cpu")
    assert (topo.world_size, topo.rank, topo.shape, topo.backend) == (1, 0, (1, 1), None)
    assert not topo.distributed and mesh.mesh_shape_of(topo) == (1, 1)
    x = torch.arange(4.0)
    # a world of one rank hands its tensors back as they are
    assert topo.all_reduce(x) is x and topo.all_gather(x) is x
    assert topo.broadcast(x) is x and topo.max_int(7) == 7
    assert mesh.choose_backend(torch.device("cpu"), 2) == "gloo"
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")


def test_initialize_multihost_noop_and_errors_equal_jax(monkeypatch):
    monkeypatch.delenv("DGEN_COORDINATOR", raising=False)
    assert launch.initialize_multihost() is False
    assert jlaunch.initialize_multihost() is False
    monkeypatch.setenv("DGEN_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.delenv("DGEN_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("DGEN_PROCESS_ID", raising=False)
    doc = ("docs/userguide.md 'Multi-host runs'", "README.md 'Multi-rank runs'")

    def both(var):
        with pytest.raises(ValueError, match=var) as got:
            launch.initialize_multihost()
        with pytest.raises(ValueError, match=var) as want:
            jlaunch.initialize_multihost()
        # the same message but for where the contract is documented
        assert str(got.value) == str(want.value).replace(*doc)

    both("DGEN_NUM_PROCESSES")
    monkeypatch.setenv("DGEN_NUM_PROCESSES", "2")
    both("DGEN_PROCESS_ID")
    monkeypatch.setenv("DGEN_PROCESS_ID", "zero")
    both("DGEN_PROCESS_ID")
    monkeypatch.setenv("DGEN_PROCESS_ID", "")
    both("DGEN_PROCESS_ID")


def test_validate_topology_messages_equal_jax():
    import jax

    jm = jmesh.make_mesh(n_devices=len(jax.devices()))
    d = int(jm.devices.size)
    topo = mesh.RankTopology(hosts=1, devices=d, rank=0, local_rank=0,
                             device=torch.device("cpu"))
    with pytest.raises(ValueError, match="pad_table") as got:
        elastic.validate_topology(d + 1, topo)
    with pytest.raises(ValueError) as want:
        jelastic.validate_topology(d + 1, jm)
    assert str(got.value) == str(want.value)
    elastic.validate_topology(d * 4, topo)
    elastic.validate_topology(d + 1, None)   # one process: anything divides


def _filled(n: int, ids: np.ndarray, k0: float) -> SimCarry:
    """A carry whose leaf k holds (agent id) * (k + 1) + k0 + k on each
    row (0 on masked rows)."""
    zeros = SimCarry.zeros(n, "cpu")
    k = iter(range(100))

    def fill(t):
        i = next(k)
        v = np.where(ids >= 0, ids * (i + 1) + k0 + i, 0).astype(np.float32)
        return torch.from_numpy(v)

    from dgen_tpu_torch.tree import tree_map

    return tree_map(fill, zeros)


def test_rank_parts_restore_by_agent_id_on_any_world(tmp_path):
    """A year written by two ranks (each its rows' carry and agent ids)
    restores bit for bit onto one process's rows and onto four ranks'
    rows, whatever their order (tests/test_gang.py:408's contract); a
    year one of whose parts is missing is not committed."""
    d = str(tmp_path / "ckpt")
    ids = np.arange(64, dtype=np.int64)
    rng = np.random.default_rng(0)
    perm = rng.permutation(64)
    halves = [perm[:32].copy(), perm[32:].copy()]
    halves[1][-3:] = -1     # masked rows of rank 1
    for r, rows in enumerate(halves):
        w = ckpt.Writer(d, rows=rows, shard=(r, 2))
        w.save(2014, _filled(32, rows, 0.5))
        if r == 0:
            w.save(2016, _filled(32, rows, 1.5))   # rank 1 never wrote 2016
    assert ckpt.valid_years(d) == [2014]
    assert elastic.is_sharded(d, 2014) and ckpt.latest_year(d) == 2014
    with pytest.raises(ValueError, match="restores by agent id only"):
        ckpt.restore_year(d, 64, 2014, device="cpu")
    held = np.concatenate(halves)
    held = held[held >= 0]
    # one process, its own row order
    mine = rng.permutation(ids)
    mine[:5] = -1
    _, carry = elastic.restore_resharded(d, 64, 2014, topo=None, device="cpu", rows=mine)
    want = _filled(64, np.where(np.isin(mine, held), mine, -1), 0.5)
    for a, b in zip(ckpt._leaves(carry).values(), ckpt._leaves(want).values()):
        assert torch.equal(a, b)
    # four ranks, each its quarter of the table
    for r in range(4):
        topo = mesh.RankTopology(hosts=2, devices=2, rank=r, local_rank=r % 2,
                                 device=torch.device("cpu"))
        rows = ids[r * 16:(r + 1) * 16]
        _, carry = elastic.restore_resharded(d, 64, 2014, topo=topo, device="cpu",
                                             rows=rows)
        want = _filled(16, np.where(np.isin(rows, held), rows, -1), 0.5)
        for a, b in zip(ckpt._leaves(carry).values(), ckpt._leaves(want).values()):
            assert torch.equal(a, b)
    # a later commit of the year at another world size is the year's
    w = ckpt.Writer(d, rows=ids, shard=(0, 1))
    w.save(2014, _filled(64, ids, 7.0))
    _, carry = ckpt.restore_year(d, 64, 2014, device="cpu", rows=ids)
    assert torch.equal(carry.batt_adopters_cum,
                       _filled(64, ids, 7.0).batt_adopters_cum)


def test_resume_year_for_walks_past_corrupt_rank_parts(tmp_path):
    """The JAX package's elastic resume planning (tests/test_gang.py:232)
    over rank parts: capped at the frontier, walking back past a year
    whose part is damaged."""
    d = str(tmp_path / "ckpt")
    rows = [np.arange(0, 32), np.arange(32, 64)]
    for y in (2014, 2016):
        for r in (0, 1):
            ckpt.Writer(d, rows=rows[r], shard=(r, 2)).save(y, _filled(32, rows[r], 0.0))
    ids = np.arange(64)
    assert elastic.resume_year_for(d, 64, None, device="cpu", rows=ids) is None
    assert elastic.resume_year_for(d, 64, 2014, device="cpu", rows=ids) == 2014
    assert elastic.resume_year_for(d, 64, 2016, device="cpu", rows=ids) == 2016
    part = os.path.join(d, ckpt.part_dir_name(2016, 1, 2), ckpt.CARRY_FILE)
    with open(part, "r+b") as fh:
        fh.truncate(os.path.getsize(part) // 2)
    assert elastic.resume_year_for(d, 64, 2016, device="cpu", rows=ids) == 2014
    with pytest.raises(ValueError, match="pad_table"):
        elastic.resume_year_for(d, 64, 2016, device="cpu", rows=ids[:21], topo=mesh.RankTopology(
            hosts=1, devices=3, rank=0, local_rank=0, device=torch.device("cpu")))


def test_shard_ledgers_and_export_parts(tmp_path):
    from dgen_tpu.resilience import manifest as jman
    from dgen_tpu_torch.io import export
    from dgen_tpu_torch.resilience import manifest as man

    run_dir = str(tmp_path / "run")
    os.makedirs(os.path.join(run_dir, "agent_outputs"))
    for r in (0, 1):
        assert man.shard_manifest_name(r) == jman.shard_manifest_name(r)
        name = export._part_name(2014, r)
        assert name == f"year=2014-p{r}.npz"
        np.savez(os.path.join(run_dir, "agent_outputs", name), x=np.arange(3))
        m = man.RunManifest(run_dir, shard=r, n_processes=2)
        m.record_artifact(2014, os.path.join("agent_outputs", name))
        m.mark_year_complete(2014)
    assert export._part_name(2014) == "year=2014.npz"
    assert man.discover_shards(run_dir) == jman.discover_shards(run_dir) == [0, 1]
    # one merged report over the shard ledgers, as the JAX package gives
    reps = man.verify_run_dir(run_dir)
    jreps = jman.verify_run_dir(run_dir)
    assert len(reps) == len(jreps) == 1
    assert reps[0].ok and not reps[0].unrecorded and reps[0].years_complete == [2014]
    assert jreps[0].ok and jreps[0].years_complete == [2014]
    m0 = man.RunManifest(run_dir, shard=0)
    assert m0.complete_through([2014, 2016]) == 2014
    assert m0._years[2014]["n_processes"] == 2
    # the rank's rows of a field that arrives with every rank's rows
    topo = mesh.RankTopology(hosts=1, devices=2, rank=1, local_rank=1,
                             device=torch.device("cpu"))
    rows, idx = export._host_rows(torch.arange(8.0), topo, 4)
    assert np.array_equal(rows, [4, 5, 6, 7]) and np.array_equal(idx, [4, 5, 6, 7])
    rows, idx = export._host_rows(torch.arange(4.0), topo, 4)
    assert np.array_equal(rows, [0, 1, 2, 3]) and np.array_equal(idx, [4, 5, 6, 7])
    assert export._host_rows(torch.arange(3.0))[1] is None


def test_from_env_reads_devices_as_jax(monkeypatch):
    from dgen_tpu import config as jcfg
    from dgen_tpu_torch.config import RunConfig

    monkeypatch.delenv("DGEN_TPU_DEVICES", raising=False)
    assert RunConfig.from_env().n_devices is None
    for v in ("1", "4", "8"):
        monkeypatch.setenv("DGEN_TPU_DEVICES", v)
        assert RunConfig.from_env().n_devices == jcfg.RunConfig.from_env().n_devices == int(v)
    assert RunConfig.from_env(n_devices=2).n_devices == 2
    assert RunConfig().partition_by_state is jcfg.RunConfig().partition_by_state is True


def _enters_device(node: ast.AST, parents: dict) -> bool:
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                if (isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute)
                        and e.func.attr == "device"
                        and ast.unparse(e.func.value) == "torch.cuda"):
                    return True
    return False


def test_kernel_wrappers_enter_their_tensors_device():
    """Every call into the kernel library (``_build.library()``) runs
    inside ``with torch.cuda.device(...)`` of its operands, so a rank on
    ``cuda:1`` launches on its own card and not on ``cuda:0``."""
    ops = os.path.join(ROOT, "dgen_tpu_torch", "ops")
    calls = 0
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py") or name == "_build.py":
            continue
        path = os.path.join(ops, name)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "library"):
                calls += 1
                assert _enters_device(node, parents), f"{name}:{node.lineno}"
    assert calls >= 2


def test_cli_smoke_steps_a_mesh_over_spawned_ranks(tmp_path, capsys):
    """``smoke --mesh 1x2`` spawns two gloo ranks, each generating its own
    block of rows (``shard_rows``), gathering the table and stepping its
    state shard two years; every shard ledger verifies, and the ranks'
    export parts hold every agent once (the CPU form of JAX's
    ``smoke --mesh``, tests/test_synth_national.py)."""
    import json

    from dgen_tpu_torch.io import export
    from dgen_tpu_torch.models import synth as tns
    from dgen_tpu_torch.resilience import manifest as man

    out = str(tmp_path / "smoke")
    assert tns.main(["smoke", "--agents", "64", "--device", "cpu", "--mesh", "1x2",
                     "--out", out, "--timeout", "300"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["smoke"] == "ok" and rec["mesh"] == "1x2" and rec["manifest_ok"]
    assert [r["rows"] for r in rec["ranks"]] == [[0, 32], [32, 64]]
    assert man.discover_shards(out) == [0, 1]
    ao = export.load_surface(out, "agent_outputs")
    for y in (2014, 2016):
        assert np.array_equal(np.sort(ao["agent_id"][ao["year"] == y]), np.arange(64))
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        f"{y}.p{r}-of-2" for y in (2014, 2016) for r in (0, 1)]


def test_chip_smoke_3n_parity_checker_catches_a_moved_value_and_unit():
    """chip_smoke.py [3n]'s per-agent check: by agent id whatever the
    ranks' order, the bound of a sharded run, every battery unit equal,
    and the count of values that are not bit-equal."""
    import chip_smoke as cs
    from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

    rng = np.random.default_rng(0)
    ids = rng.permutation(40).astype(np.int64)
    mask = np.ones(40, np.float32)
    mask[:3] = 0
    res = {f: rng.uniform(1, 10, (2, 40)).astype(np.float32) for f in COLLECT_FIELDS}
    res["new_batt_adopters"] = np.round(res["new_batt_adopters"])
    want = cs.sim_by_id(res, ids, mask)
    assert np.array_equal(want["agent_id"], np.sort(ids[3:]))
    # the ranks' parts: the same rows in another order
    order = rng.permutation(37)
    parts = {"agent_id": want["agent_id"][order],
             **{f: want[f][:, order] for f in COLLECT_FIELDS}}
    got = cs.sim_by_id(parts, parts["agent_id"], np.ones(37))
    assert cs.ranks_parity("t", got, want, bit_for_bit=True) == 0
    nudged = {**got, "npv": got["npv"] * np.float32(1 + 1e-6)}
    assert cs.ranks_parity("t", nudged, want) > 0
    with pytest.raises(AssertionError, match="not bit-equal"):
        cs.ranks_parity("t", nudged, want, bit_for_bit=True)
    with pytest.raises(AssertionError, match="outside rtol"):
        cs.ranks_parity("t", {**got, "npv": got["npv"] * 1.01}, want)
    moved = {**got, "new_batt_adopters": got["new_batt_adopters"].copy()}
    moved["new_batt_adopters"][1, 5] += 1
    moved["new_batt_adopters"][1, 6] -= 1
    with pytest.raises(AssertionError, match="battery unit moved"):
        cs.ranks_parity("t", moved, want)


def test_automatic_chunk_budgets_this_ranks_share_of_its_card(monkeypatch):
    """Ranks that share a card each plan their chunk for their share of it:
    ``card_memory_bytes`` over ``ceil(local ranks / cards)``. At the H100
    80GB HBM3's 79.18 GiB (as torch reports it) one process of
    national-all-sector's 1,048,576 agents plans 87,424-row chunks and each
    of two ranks sharing the card 43,648 rows (the chunks the card showed,
    PERF.md); planning for the whole card, each rank would take 87,552
    rows and the two would model more than the card holds."""
    from types import SimpleNamespace

    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.models import simulation as sm

    total = int(79.18 * 2**30)
    monkeypatch.setattr(sm, "card_memory_bytes",
                        lambda dev: total if dev.type == "cuda" else None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda", 0)

    def topo(devices, rank=0, dev=cuda):
        return mesh.RankTopology(hosts=1, devices=devices, rank=rank, local_rank=rank,
                                 device=dev)

    assert topo(1).ranks_per_card == 1 and topo(2).ranks_per_card == 2
    # a one-host gang on a grid of one rank a host: its launcher's
    # LOCAL_WORLD_SIZE says how many share the host's card
    assert mesh.RankTopology(hosts=2, devices=1, rank=1, local_rank=1, device=cuda,
                             local_world=2).ranks_per_card == 2
    assert sm.rank_memory_bytes(cuda) == sm.rank_memory_bytes(cuda, topo(1)) == total
    assert sm.rank_memory_bytes(cuda, topo(2, 1)) == total // 2
    assert sm.rank_memory_bytes(torch.device("cpu"), topo(2, 0, torch.device("cpu"))) is None
    # a rank with a card of its own sees the whole card; four on two cards, half
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sm.rank_memory_bytes(cuda, topo(2)) == total
    assert sm.rank_memory_bytes(cuda, topo(4, 3)) == total // 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    fp = presets.build("national-all-sector", n_agents=64, end_year=2016,
                       device="cpu")[0]._footprint()

    def chunk(ranks):
        fake = SimpleNamespace(run_config=RunConfig(), ranks=ranks, device=cuda,
                               table=SimpleNamespace(n_agents=1_048_576),
                               _footprint=lambda: fp)
        return sm.Simulation._resolve_chunk(fake)

    assert chunk(None) == 87_424
    assert chunk(topo(2)) == chunk(topo(2, 1)) == 43_648
    per = sm.per_agent_step_bytes(**fp)
    budget = sm._MEMORY_BUDGET_FRAC * total
    assert 2 * sm.modeled_step_bytes(per, 43_648, 524_288) <= budget
    whole_card = sm.auto_agent_chunk(524_288, memory_bytes=total, **fp)
    assert whole_card == 87_552
    assert 2 * sm.modeled_step_bytes(per, whole_card, 524_288) > total
    # an explicit chunk is the caller's, shared card or not
    fake = SimpleNamespace(run_config=RunConfig(agent_chunk=32_768), ranks=topo(2))
    assert sm.Simulation._resolve_chunk(fake) == 32_768
