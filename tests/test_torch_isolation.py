"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU unasked."""

import ast
import os
import subprocess
import sys

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
        "import dgen_tpu_torch.tools.kernel_microbench\n"
        "assert 'jax' not in [m.split('.')[0] for m, v in sys.modules.items() if v]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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
                                "monthmask_g", "variant", "monthdot"}
    assert not any(bk.LAUNCHES.values())
    with pytest.raises(ValueError, match="n_periods"):
        bk.import_sums(load, gen, sell, bucket, scales, 12 * 11)
