"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU unasked."""

import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dgen_tpu_torch")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "dgen_tpu"


def test_port_sources_import_no_jax_and_no_reference():
    files = _port_sources()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [m for m in mods if _forbidden(m)]
            assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_unavailable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dgen_tpu'] = None\n"
        "import dgen_tpu_torch.models.simulation\n"
        "import dgen_tpu_torch.presets, dgen_tpu_torch.convert\n"
        "import dgen_tpu_torch.ops.billkernels, dgen_tpu_torch.ops._build\n"
        "import dgen_tpu_torch.ops.layout, dgen_tpu_torch.ops.microkernels\n"
        "import dgen_tpu_torch.ops.dispatch\n"
        "import dgen_tpu_torch.models.health, dgen_tpu_torch.utils.invariants\n"
        "import dgen_tpu_torch.tools.kernel_microbench\n"
        "import dgen_tpu_torch.tools.plain_parent_ab\n"
        "import dgen_tpu_torch.grad, dgen_tpu_torch.grad.smooth\n"
        "import dgen_tpu_torch.grad.newton, dgen_tpu_torch.grad.calibrate\n"
        "import dgen_tpu_torch.grad.policy, dgen_tpu_torch.grad.__main__\n"
        "import dgen_tpu_torch.analysis, dgen_tpu_torch.ops.demand\n"
        "import dgen_tpu_torch.serve.fleet, dgen_tpu_torch.serve.front\n"
        "import dgen_tpu_torch.serve.autoscale, dgen_tpu_torch.resilience.fleetdrill\n"
        "assert 'jax' not in [m.split('.')[0] for m, v in sys.modules.items() if v]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_dispatch_kernel_is_built_from_the_sources_and_imports_no_reference():
    """csrc/battery_dispatch.cu is among the sources the build compiles,
    its C launcher is bound, and the module around it imports neither jax
    nor the JAX package (also at run time: see the test above)."""
    from dgen_tpu_torch.ops import _build

    src = os.path.join(PKG, "csrc", "battery_dispatch.cu")
    assert src in _build.sources()
    assert "battery_dispatch" in _build._SIGNATURES
    with open(src) as f:
        assert 'extern "C" int battery_dispatch(' in f.read()
    path = os.path.join(PKG, "ops", "dispatch.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert mods and not [m for m in mods if _forbidden(m)], mods


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from dgen_tpu_torch import config, convert, presets
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.ops import tariff

    with pytest.raises(RuntimeError, match="no CUDA device"):
        presets.build("ercot-all-sector", n_agents=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        presets.run_preset("ercot-all-sector", n_agents=16, export=False)
    from dgen_tpu_torch.io import checkpoint
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore_year(os.path.join(ROOT, "runs", "none"), 16)
    from dgen_tpu_torch.tools import plain_parent_ab
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plain_parent_ab.run(ROOT, n_agents=16, pairs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.generate_population(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tariff.compile_tariffs(synth.make_tariff_specs())
    cfg = config.ScenarioConfig(start_year=2014, end_year=2016)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenario.uniform_inputs(cfg, n_groups=153, n_regions=10)
    pop = synth.generate_population(16, pad_multiple=8, device="cpu")
    inputs = scenario.uniform_inputs(cfg, n_groups=153, n_regions=10, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.agent_table(convert.to_numpy_dict(pop.table))
    from dgen_tpu_torch.grad import calibrate
    from dgen_tpu_torch.ops import demand
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demand.compile_demand_tariff(d_flat_prices=[[5.0] * 12])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.build_world(16)
    # the rank gang's entry points: a rank, the gang drill, the scaling
    # harness (each raises before it spawns or binds anything)
    import signal
    import tempfile

    from dgen_tpu_torch.resilience import __main__ as resilience_cli
    from dgen_tpu_torch.resilience import gangworker
    from dgen_tpu_torch.tools import bench_scale

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resilience_cli.main(["drill", "--gang", "--root", tempfile.mkdtemp()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scale.main([])
    gang_dir = tempfile.mkdtemp()
    env = {"DGEN_COORDINATOR": "127.0.0.1:1", "DGEN_NUM_PROCESSES": "1",
           "DGEN_PROCESS_ID": "0", "DGEN_GANG_DIR": gang_dir, "DGEN_RUN_DIR": gang_dir}
    old = {k: os.environ.get(k) for k in (*env, "DGEN_PLATFORM")}
    handler = signal.getsignal(signal.SIGTERM)
    os.environ.update(env)
    os.environ.pop("DGEN_PLATFORM", None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gangworker.main()
    finally:
        signal.signal(signal.SIGTERM, handler)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_kernel_wrappers_take_plain_path_only_for_cpu_tensors():
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.layout import FULL_OFFSETS

    rng = np.random.default_rng(0)
    n, r = 3, 5
    load = torch.from_numpy(rng.random((n, 8760), dtype=np.float32))
    gen = torch.from_numpy(rng.random((n, 8760), dtype=np.float32))
    sell = torch.from_numpy(rng.random((n, 8760), dtype=np.float32))
    bucket = bk.hourly_bucket_ids(
        torch.from_numpy(rng.integers(0, 2, (n, 8760)).astype(np.int32)), 2)
    scales = torch.from_numpy(rng.random((n, r), dtype=np.float32))
    bk.reset_launches()
    ref = bk.month_sums_plain(load, gen, sell, bucket % 2, scales, FULL_OFFSETS,
                              2, False)
    for impl in ("auto", "stream"):
        got = bk.import_sums(load, gen, sell, bucket, scales, 24, impl=impl)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    got = bk.import_sums(load, gen, sell, bucket, scales, 24, impl="dot")
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    # the plain path is not a launch
    assert set(bk.LAUNCHES) == {"month", "month_signed", "month_pair", "stream",
                                "stream_signed", "dot", "dot_signed", "monthmask",
                                "monthmask_g", "variant", "monthdot",
                                "monthdot_pre", "mnet", "mnet_hi"}
    assert not any(bk.LAUNCHES.values())
    with pytest.raises(ValueError, match="n_periods"):
        bk.import_sums(load, gen, sell, bucket, scales, 12 * 11)


def test_chip_smoke_alone_exits_2(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo
    exits 2 and prints no result: without a card, and with a card but
    without the package beside it."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    runs = [[sys.executable, "-I", "chip_smoke.py"],
            [sys.executable, "-I", "-c",
             "import sys, runpy, torch\n"
             "torch.cuda.is_available = lambda: True\n"
             "sys.argv = ['chip_smoke.py']\n"
             "runpy.run_path('chip_smoke.py', run_name='__main__')\n"]]
    for cmd in runs:
        proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 2, (proc.stdout, proc.stderr)
        assert '"ok"' not in proc.stdout
    assert "not beside this script" in proc.stderr


GOLDEN_PKG = os.path.join(ROOT, "tests", "torch_fixtures", "golden_pkg")


def test_card_path_loads_a_package_without_pandas_or_jax():
    """The package loader and the run settings, the card path's data
    plane, import and load the committed golden package with pandas,
    pyarrow, jax and the JAX package all unavailable."""
    code = (
        "import sys\n"
        "for name in ('pandas', 'pyarrow', 'jax', 'jaxlib', 'dgen_tpu', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "from dgen_tpu_torch.io import package\n"
        "from dgen_tpu_torch.config import RunConfig\n"
        f"pop = package.load_population({GOLDEN_PKG!r}, pad_multiple=32, device='cpu')\n"
        "rc = RunConfig.from_env(sizing_iters=8)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        "assert not loaded & {'pandas', 'pyarrow', 'jax', 'dgen_tpu'}, loaded\n"
        "print(int(pop.table.mask.sum()), pop.table.n_agents, pop.tariffs.n_tariffs,\n"
        "      rc.sizing_iters)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["96", "96", "5", "8"]


INPUT_ROOT = os.path.join(ROOT, "tests", "torch_fixtures", "reference_inputs", "dgen_os")
#: the card path's host-input modules
INPUT_MODULES = ("dgen_tpu_torch.io", "dgen_tpu_torch.io.ingest",
                 "dgen_tpu_torch.io.reference_inputs", "dgen_tpu_torch.io.workbook",
                 "dgen_tpu_torch.io.nem", "dgen_tpu_torch.presets")


def test_input_root_ingest_needs_no_pandas_pyarrow_or_jax():
    """The host-input modules import, the committed input root ingests
    (its NEM-cap drop-ins included) and a preset world builds on it, with
    pandas, pyarrow, jax and the JAX package unavailable."""
    code = (
        "import sys\n"
        "for name in ('pandas', 'pyarrow', 'jax', 'jaxlib', 'dgen_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {INPUT_MODULES!r}:\n"
        "    __import__(m)\n"
        "from dgen_tpu_torch import presets\n"
        "from dgen_tpu_torch.config import ScenarioConfig\n"
        "from dgen_tpu_torch.io import reference_inputs, synth, workbook\n"
        f"cfg, info = workbook.scenario_from_workbook({INPUT_ROOT!r} + '/excel/scenario.xlsm')\n"
        f"root = {INPUT_ROOT!r} + '/input_data'\n"
        "inputs, meta = reference_inputs.scenario_inputs_from_reference(\n"
        "    root, cfg, list(synth.STATES), prefer=info['prefer'], device='cpu')\n"
        "bank = reference_inputs.wholesale_profile_bank(meta, root)\n"
        "pop, _, _, _, wmeta = presets.world('national-all-sector', 32, end_year=2016,\n"
        "                                    device='cpu', input_root=root)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        "assert not loaded & {'pandas', 'pyarrow', 'jax', 'jaxlib', 'dgen_tpu'}, loaded\n"
        "print(meta['data_sources']['nem_caps'], meta['data_sources']['itc'],\n"
        "      meta['market_curves']['mms'], meta['market_curves']['bass'],\n"
        "      bool((inputs.nem_cap_kw < 1e30).any()), bank.shape[0], pop.n_regions,\n"
        "      wmeta['data_sources']['nem_caps'])\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ingested"] * 4 + ["True", "9", "9", "ingested"]


def test_refschema_is_scanned_and_imports_pandas_only_in_functions():
    """io/refschema.py is among the sources the jax-free scan reads, and
    it imports pandas (and sqlalchemy) only inside its functions: CPU
    side, never at import."""
    path = os.path.join(PKG, "io", "refschema.py")
    assert path in _port_sources()
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("pandas", "pyarrow", "sqlalchemy")
                or _forbidden(m)], names
    inner = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert "pandas" in inner


#: each ported switch of dgen_tpu/config.py's RunConfig.from_env and the
#: field it sets
PORTED_FLAGS = {
    "DGEN_TPU_DEBUG": "debug_invariants",
    "DGEN_TPU_DAYLIGHT": "daylight_compact",
    "DGEN_TPU_BF16_BANKS": "bf16_banks",
    "DGEN_TPU_QUANT_BANKS": "quant_banks",
    "DGEN_TPU_PACK_ONCE": "pack_once",
    "DGEN_TPU_STREAM": "stream_segments",
    "DGEN_TPU_CLUSTER": "cluster_tariffs",
    "DGEN_TPU_SOFT": "soft_boundaries",
}
ALL_SWITCHES = (*PORTED_FLAGS, "DGEN_TPU_AGENT_CHUNK", "DGEN_TPU_DEVICES",
                "DGEN_TPU_SOFT", "DGEN_TPU_SOFT_TAU", "DGEN_TPU_CLUSTER",
                "DGEN_TPU_FAULTS", "DGEN_TPU_VALIDATE", "DGEN_TPU_ASYNC_IO",
                "DGEN_TPU_GUARD", "DGEN_TPU_SENTINEL")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ALL_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("name", sorted(PORTED_FLAGS))
def test_from_env_maps_each_ported_switch(clean_env, name):
    from dgen_tpu_torch.config import RunConfig

    field = PORTED_FLAGS[name]
    assert getattr(RunConfig.from_env(), field) is False
    for value, on in (("1", True), ("true", True), ("yes", True), ("0", False),
                      ("false", False), ("", False)):
        clean_env.setenv(name, value)
        assert getattr(RunConfig.from_env(), field) is on, (name, value)
    clean_env.setenv(name, "1")
    assert getattr(RunConfig.from_env(**{field: False}), field) is False


def test_from_env_chunk_devices_and_ignored_switches(clean_env):
    from dgen_tpu_torch.config import RunConfig

    assert RunConfig.from_env().agent_chunk is None
    clean_env.setenv("DGEN_TPU_AGENT_CHUNK", "4096")
    assert RunConfig.from_env().agent_chunk == 4096
    assert RunConfig.from_env(agent_chunk=0).agent_chunk == 0
    assert RunConfig.from_env(sizing_iters=8).sizing_iters == 8
    for name, value in (("DGEN_TPU_DEVICES", "1"), ("DGEN_TPU_VALIDATE", "0"),
                        ("DGEN_TPU_ASYNC_IO", "0"), ("DGEN_TPU_SOFT_TAU", "0.5"),
                        ("DGEN_TPU_SOFT", "0"), ("DGEN_TPU_GUARD", "false"),
                        ("DGEN_TPU_FAULTS", "  ")):
        clean_env.setenv(name, value)
    # DGEN_TPU_DEVICES sets n_devices, as the JAX package reads it
    assert RunConfig.from_env() == RunConfig(agent_chunk=4096, soft_tau=0.5, n_devices=1)
    assert RunConfig.from_env(soft_tau=0.2).soft_tau == 0.2


@pytest.mark.parametrize("name, value", [("DGEN_TPU_GUARD", "true")])
def test_from_env_refuses_unported_switches(clean_env, name, value):
    from dgen_tpu_torch.config import RunConfig

    clean_env.setenv(name, value)
    with pytest.raises(NotImplementedError, match=name):
        RunConfig.from_env()


def test_from_env_leaves_faults_to_the_supervisor_and_validate_to_the_build(clean_env):
    """``DGEN_TPU_FAULTS`` is no field of the config: the run supervisor
    (or ``faults.install_from_env``) installs it, as in the JAX package;
    ``DGEN_TPU_VALIDATE`` is read when a Simulation is built."""
    from dgen_tpu_torch.config import RunConfig

    clean_env.setenv("DGEN_TPU_FAULTS", "ckpt_save@2")
    rc = RunConfig.from_env()
    assert rc == RunConfig() and rc.faults is None
    assert rc.validate_inputs is None and rc.validate_enabled
    for value, enabled in (("0", False), ("false", False), ("off", False), ("1", True)):
        clean_env.setenv("DGEN_TPU_VALIDATE", value)
        assert rc.validate_enabled is enabled, value
    assert RunConfig(validate_inputs=True).validate_enabled


def test_sentinel_switch_is_read_at_run_time(clean_env):
    from dgen_tpu_torch.config import RunConfig

    rc, on, off = RunConfig.from_env(), RunConfig(health_sentinel=True), \
        RunConfig(health_sentinel=False)
    assert rc.health_sentinel is None and rc.sentinel_enabled
    for value, enabled in (("0", False), ("false", False), ("off", False),
                           ("1", True), ("", True)):
        clean_env.setenv("DGEN_TPU_SENTINEL", value)
        assert rc.sentinel_enabled is enabled, value
        assert on.sentinel_enabled and not off.sentinel_enabled


def test_load_population_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from dgen_tpu_torch.io import package

    with pytest.raises(RuntimeError, match="no CUDA device"):
        package.load_population(GOLDEN_PKG, pad_multiple=32)
    pop = package.load_population(GOLDEN_PKG, pad_multiple=32, device="cpu")
    assert pop.table.mask.device.type == "cpu"


#: the run-output modules: every one imports, and a run exports and
#: checkpoints through them, with these unavailable
RUN_OUTPUT_MODULES = ("dgen_tpu_torch.io.export", "dgen_tpu_torch.io.checkpoint",
                      "dgen_tpu_torch.io.hostio", "dgen_tpu_torch.utils.atomic",
                      "dgen_tpu_torch.utils.timing")
BLOCKED = ("pandas", "pyarrow", "orbax", "jax", "jaxlib", "dgen_tpu")


def test_run_outputs_need_no_pandas_pyarrow_orbax_or_jax(tmp_path):
    """The exporter, the checkpoint writer and the host-I/O pipeline import,
    and a run writes its surfaces and checkpoints and resumes from them,
    with pandas, pyarrow, orbax, jax and the JAX package unavailable;
    ``to_parquet``, the CPU-side rewrite into parquet, is the one piece
    that needs pandas."""
    run_dir = str(tmp_path / "run")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {RUN_OUTPUT_MODULES!r}:\n"
        "    __import__(m)\n"
        "from dgen_tpu_torch import presets\n"
        "from dgen_tpu_torch.config import RunConfig\n"
        "from dgen_tpu_torch.io import export, checkpoint\n"
        "sim, pop, _ = presets.build('delaware-res', n_agents=32, end_year=2016,\n"
        "                            device='cpu', run_config=RunConfig(sizing_iters=4))\n"
        f"ex = export.RunExporter({run_dir!r}, sim.host_agent_id, sim.host_mask,\n"
        "    device='cpu', static_frame=export.static_frame_from_table(pop.table))\n"
        f"sim.run(callback=ex, collect=True, checkpoint_dir={run_dir!r} + '/ck')\n"
        f"assert sim.run(checkpoint_dir={run_dir!r} + '/ck', resume=True,\n"
        "               resume_year=2014).years == [2016]\n"
        f"print(len(export.load_surface({run_dir!r}, 'agent_outputs')['npv']),\n"
        f"      checkpoint.valid_years({run_dir!r} + '/ck'))\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        f"assert not loaded & set({BLOCKED!r}), loaded\n"
        "try:\n"
        f"    export.to_parquet({run_dir!r}, {run_dir!r} + '-pq')\n"
        "except ImportError:\n"
        "    print('to_parquet needs pandas')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["64 [2014, 2016]", "to_parquet needs pandas"]


def test_pandas_is_imported_only_inside_to_parquet():
    """In the run-output modules, pandas (or pyarrow, or orbax) is
    imported nowhere but inside ``io.export.to_parquet``."""
    for mod in RUN_OUTPUT_MODULES:
        path = os.path.join(ROOT, *mod.split(".")) + ".py"
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        owners = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    owners.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            heavy = [m for m in mods if m.split(".")[0] in BLOCKED]
            if heavy:
                assert (mod, owners.get(id(node))) == ("dgen_tpu_torch.io.export",
                                                       "to_parquet"), (mod, heavy)


def test_chip_smoke_imports_no_pandas_side_of_the_port():
    """chip_smoke.py loads the golden package through io.package alone:
    the converter and the NEM compiler (pandas) stay on the CPU side."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            names |= {f"{node.module}.{a.name}" for a in node.names}
            names.add(node.module)
        elif isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
    assert "dgen_tpu_torch.io.package" in names
    bad = {n for n in names if n.split(".")[0] in ("pandas", "pyarrow")
           or n.startswith(("dgen_tpu_torch.io.convert", "dgen_tpu_torch.io.nem"))}
    assert not bad, bad


RESILIENCE_MODULES = tuple(
    f"dgen_tpu_torch.resilience.{m}" for m in (
        "faults", "quarantine", "manifest", "supervisor", "drill", "quarantinedrill",
        "fleetdrill", "__main__"))


def test_resilience_needs_no_pandas_pyarrow_orbax_or_jax(tmp_path):
    """The resilience modules and their CLI import, a supervised run
    recovers an injected fault with its manifest, quarantine.json and
    exports, and the CLI verifies the directory, with pandas, pyarrow,
    orbax, jax and the JAX package unavailable."""
    run_dir = str(tmp_path / "run")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {RESILIENCE_MODULES!r}:\n"
        "    __import__(m)\n"
        "import dataclasses, torch\n"
        "torch.set_num_threads(1)\n"
        "from dgen_tpu_torch.config import RunConfig\n"
        "from dgen_tpu_torch.resilience.__main__ import main\n"
        "from dgen_tpu_torch.resilience.drill import synth_world\n"
        "from dgen_tpu_torch.resilience.supervisor import run_supervised\n"
        "w = dataclasses.replace(synth_world(sizing_iters=4, device='cpu'),\n"
        "                        storage_enabled=False, econ_years=5)\n"
        "make_sim = w.runner(w.make_population(4), w.scenario(2014))\n"
        "_, rep = run_supervised(make_sim, RunConfig(faults='ckpt_save@1'),\n"
        f"                       run_dir={run_dir!r}, collect=False)\n"
        "print(rep.retries, main(['verify', '--shallow', " + repr(run_dir) + "]))\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        f"assert not loaded & set({BLOCKED!r}), loaded\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "1 0"
    assert os.path.isfile(os.path.join(run_dir, "quarantine.json"))


#: the modules of the national generator, the URDB tooling and tariff
#: clustering
CLUSTER_MODULES = ("dgen_tpu_torch.models.synth", "dgen_tpu_torch.io.urdb",
                   "dgen_tpu_torch.ops.tariffcluster")


def test_generator_urdb_and_clustering_need_no_pandas_pyarrow_or_jax(tmp_path):
    """The national generator, the URDB tooling and tariff clustering
    import, a mixed world is saved, verified, loaded and laid out cluster
    by cluster, and a URDB record parses, with pandas, pyarrow, orbax, jax
    and the JAX package unavailable."""
    world = str(tmp_path / "world")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {CLUSTER_MODULES!r}:\n"
        "    __import__(m)\n"
        "from dgen_tpu_torch.io import package, urdb\n"
        "from dgen_tpu_torch.models import synth\n"
        "from dgen_tpu_torch.ops import tariffcluster as tc\n"
        "spec = synth.NationalSpec(n_agents=300, tariff_mix='mixed')\n"
        f"synth.save_world(spec, {world!r})\n"
        f"assert synth.verify_world({world!r}) == []\n"
        f"pop = package.load_population({world!r}, device='cpu')\n"
        "plan = tc.analyze_bank(pop.tariffs)\n"
        "lay = tc.plan_layout(plan, pop.table.tariff_idx.numpy(),\n"
        "                     pop.table.mask.numpy(), 1, 16)[0]\n"
        "e, d = urdb.urdb_rate_to_specs({'energyratestructure': [[{'rate': 0.1}]]})\n"
        "print(plan.n_clusters, len(lay.clusters), e['e_prices'], d)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        f"assert not loaded & set({BLOCKED!r}), loaded\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "6 6 [[0.1]] None"


def test_sweep_and_ensemble_need_no_pandas_pyarrow_or_jax(tmp_path):
    """A 2-scenario sweep (exporting and checkpointing as it runs, then
    resumed) and a 2-member ensemble (with a cohort) import and run with
    pandas, pyarrow, orbax, jax and the JAX package unavailable."""
    run_dir = str(tmp_path / "sweep")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from dgen_tpu_torch.config import RunConfig, ScenarioConfig\n"
        "from dgen_tpu_torch.ensemble import DEFAULT_DRAWS, EnsembleSimulation\n"
        "from dgen_tpu_torch.io import synth\n"
        "from dgen_tpu_torch.models import scenario\n"
        "from dgen_tpu_torch.sweep import SweepSimulation\n"
        "cfg = ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())\n"
        "pop = synth.generate_population(8, states=['DE'], pad_multiple=8, device='cpu')\n"
        "def inputs(itc):\n"
        "    return scenario.uniform_inputs(cfg, n_groups=pop.table.n_groups,\n"
        "        n_regions=pop.n_regions, device='cpu',\n"
        "        overrides={'itc_fraction': np.full((2, 3), itc, np.float32)})\n"
        "rc = RunConfig(sizing_iters=4)\n"
        "kw = dict(econ_years=5, device='cpu')\n"
        "sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs,\n"
        "                        [inputs(0.3), inputs(0.0)], cfg, rc, **kw)\n"
        f"res = sweep.run(checkpoint_dir={run_dir!r} + '/ck', run_dir={run_dir!r})\n"
        f"again = sweep.run(checkpoint_dir={run_dir!r} + '/ck', resume=True)\n"
        f"res.export({run_dir!r} + '-post')\n"
        "entry = np.zeros(pop.table.n_agents, np.float32)\n"
        "entry[-2:] = 2016.0\n"
        "ens = EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, inputs(0.3), cfg,\n"
        "                         rc, n_members=2, draws=DEFAULT_DRAWS, entry_year=entry,\n"
        "                         **kw)\n"
        "stats = ens.run().quantiles\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        f"assert not loaded & set({BLOCKED!r}), loaded\n"
        "print(res.plan.groups[0].mode, [r.years for r in res.runs],\n"
        "      [r.years for r in again.runs], ens.mode, stats.national['adopters'].shape)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ("vmap [[2014, 2016], [2014, 2016]] [[], []] vmap (2, 3)")
    assert sorted(os.listdir(run_dir)) == ["ck", "scenario=scn0", "scenario=scn1"]


def test_serving_stack_needs_no_pandas_pyarrow_or_jax(tmp_path):
    """The serving stack (engine, batcher, HTTP server, answer surface on
    the mmap table, result cache, CLI) imports and answers one query over
    HTTP, from the surface and from the cache, with pandas, pyarrow,
    orbax, jax and the JAX package unavailable."""
    surf, cache = str(tmp_path / "surf"), str(tmp_path / "rc")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import http.client, json, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import dgen_tpu_torch.serve.__main__, dgen_tpu_torch.tools.row_count_probe\n"
        "import dgen_tpu_torch.serve.fleet, dgen_tpu_torch.serve.front\n"
        "import dgen_tpu_torch.serve.autoscale\n"
        "from dgen_tpu_torch.config import ServeConfig\n"
        "from dgen_tpu_torch.io import synth\n"
        "from dgen_tpu_torch.serve import ResultCache, ServeEngine, build_surface\n"
        "from dgen_tpu_torch.serve.__main__ import build_sim\n"
        "from dgen_tpu_torch.serve.server import ServeApp, drain, start_in_thread\n"
        "from dgen_tpu_torch.serve.surface import load_and_attach, provenance_key\n"
        "gen = synth.generate_population\n"
        "synth.generate_population = lambda *a, **k: gen(*a, **{**k, 'pad_multiple': 8})\n"
        "sim = build_sim(16, end_year=2014, econ_years=3, sizing_iters=4, device='cpu')\n"
        "eng = ServeEngine(sim)\n"
        f"build_surface(eng, {surf!r}, 16)\n"
        f"assert load_and_attach(eng, {surf!r}) is None\n"
        f"eng.attach_result_cache(ResultCache({cache!r}, provenance_key(eng)))\n"
        "app = ServeApp(eng, ServeConfig(max_batch=16, min_bucket=16, port=0))\n"
        "srv = start_in_thread(app)\n"
        "c = http.client.HTTPConnection('127.0.0.1', srv.server_address[1], timeout=60)\n"
        "codes = []\n"
        "for body in ({'agent_ids': [3]}, {'agent_ids': [3], 'overrides': {'set': {'itc_fraction': 0.1}}},\n"
        "             {'agent_ids': [3], 'overrides': {'set': {'itc_fraction': 0.1}}}):\n"
        "    c.request('POST', '/query', body=json.dumps(body).encode())\n"
        "    r = c.getresponse(); r.read(); codes.append(r.status)\n"
        "m = app.metricz()\n"
        "drain(app, srv); srv.server_close()\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        f"assert not loaded & set({BLOCKED!r}), loaded\n"
        "print(codes, m['surface_hits'], m['result_cache']['hits'], m['batches'],\n"
        "      m['steady_state_compiles'])\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[200, 200, 200] 1 1 2 0"


def test_serve_cli_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from dgen_tpu_torch.serve.__main__ import build_sim, main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sim(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--agents", "16", "--end-year", "2014", "--build-surface", "/nonexistent"])


def test_first_kernel_use_builds_and_loads_the_library_once(monkeypatch, tmp_path):
    """Two threads that reach the kernel library at once (the serving
    batcher's worker and a caller's thread) build it once and load it once;
    later calls build and load nothing (a stub compiler and loader: no
    nvcc here)."""
    import threading

    from dgen_tpu_torch.ops import _build

    compiled, opened = [], []
    gate = threading.Barrier(2)

    def fake_compile(srcs, path):
        compiled.append(path)
        time.sleep(0.2)                    # a slow compile widens the race
        with open(path, "wb") as f:
            f.write(b"stub")
        return ""

    def fake_open(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(_build, "_BUILT", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "EVENTS", {"builds": 0, "loads": 0})
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build, "_open", fake_open)
    monkeypatch.setattr(_build, "library_path", lambda csrc=None: str(tmp_path / "lib.so"))
    libs = []

    def reach():
        gate.wait()
        libs.append(_build.library())

    threads = [threading.Thread(target=reach) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert len(libs) == 2 and libs[0] is libs[1]
    assert len(compiled) == 1 and len(opened) == 1
    assert _build.EVENTS == {"builds": 1, "loads": 1}
    assert _build.library() is libs[0] and _build.build()[0] == str(tmp_path / "lib.so")
    assert _build.EVENTS == {"builds": 1, "loads": 1}


#: the multi-rank modules
PARALLEL_MODULES = ("dgen_tpu_torch.parallel", "dgen_tpu_torch.parallel.partition",
                    "dgen_tpu_torch.parallel.mesh", "dgen_tpu_torch.parallel.launch",
                    "dgen_tpu_torch.parallel.elastic")


def test_parallel_and_the_rank_entry_need_no_pandas_pyarrow_or_jax(tmp_path):
    """The multi-rank modules import, and the rank entry point runs a
    world of one rank over a gloo rendezvous (export, checkpoint and
    collected outputs included), with pandas, pyarrow, orbax, jax and the
    JAX package unavailable; its record says it imported neither."""
    import json
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run_dir = str(tmp_path / "run")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {PARALLEL_MODULES!r}:\n"
        "    __import__(m)\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from dgen_tpu_torch.parallel.launch import main\n"
        "main(['--device', 'cpu', '--agents', '16', '--end-year', '2016',\n"
        "      '--pad-multiple', '16', '--econ-years', '5', '--sizing-iters', '4',\n"
        f"      '--run-dir', {run_dir!r}, '--collect', {run_dir + '.npz'!r}])\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        f"assert not loaded & set({BLOCKED!r}), loaded\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DGEN_TPU_")}
    env.update(DGEN_COORDINATOR=f"127.0.0.1:{port}", DGEN_NUM_PROCESSES="1",
               DGEN_PROCESS_ID="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["world"] == 1 and rec["years"] == [2014, 2016]
    assert rec["imports_jax"] is False and rec["imports_dgen_tpu"] is False
    assert os.path.isfile(os.path.join(run_dir, "agent_outputs", "year=2016.npz"))
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == ["2014", "2016"]
    with np.load(run_dir + ".npz") as z:
        assert z["system_kw"].shape == (2, 16)
