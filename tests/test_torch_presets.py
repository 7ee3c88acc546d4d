"""The preset runner of the PyTorch port: ``run_preset`` gives the JAX
package's record keys plus ``device``, ``year_s`` and the host-I/O
pipeline's ``host_io_s``, ``host_blocked_s`` and ``overlap_efficiency``;
with ``export`` and ``checkpoint`` it writes the three result surfaces
and the per-year checkpoints into the run directory its record names;
``python -m dgen_tpu_torch.presets`` exports by default, honours
``--run-dir`` and prints the record as its last line."""

import json
import os
import subprocess
import sys

import numpy as np

import pytest

from dgen_tpu_torch import presets

#: the keys of dgen_tpu/presets.py run_preset's record
JAX_KEYS = {"preset", "agents", "years", "agent_chunk", "with_hourly", "storage",
            "total_s", "build_s", "run_s", "compile_s", "steady_year_s",
            "export_overlapped_s", "agent_years_per_sec", "run_dir", "data_sources"}
#: the port's keys beside them
PORT_KEYS = {"device", "year_s", "host_io_s", "host_blocked_s", "overlap_efficiency"}


def test_record_keys_are_the_jax_package_runners():
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dgen_tpu", "presets.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_preset")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    assert {k.value for k in rec.keys} == JAX_KEYS


@pytest.fixture(scope="module")
def record():
    return presets.run_preset("delaware-res", n_agents=64, device="cpu", export=False)


def test_run_preset_record(record):
    assert set(record) == JAX_KEYS | PORT_KEYS
    p = presets.PRESETS["delaware-res"]
    n_years = len(range(p.start_year, p.end_year + 1, 2))
    assert record["preset"] == "delaware-res" and record["agents"] == 64
    assert record["years"] == n_years == len(record["year_s"])
    assert record["device"] == "cpu" and record["agent_chunk"] == 0
    assert record["with_hourly"] is True and record["storage"] is False
    assert record["run_dir"] is None and record["export_overlapped_s"] == 0.0
    assert record["host_io_s"] is None and record["overlap_efficiency"] is None
    assert 0 < record["build_s"] < record["total_s"]
    assert record["run_s"] >= sum(record["year_s"]) * 0.999
    assert record["agent_years_per_sec"] == pytest.approx(
        64 * n_years / record["total_s"], rel=1e-2)


def test_export_and_checkpoint_are_refused(tmp_path):
    """Exports and checkpoints are ported: ``run_preset(export=True,
    checkpoint=True)`` writes the three surfaces of every year and a
    checkpoint a year into the run directory the record names (the
    name of this test predates the port of the run outputs)."""
    from dgen_tpu_torch.io import checkpoint, export

    run_dir = str(tmp_path / "run")
    rec = presets.run_preset("delaware-res", n_agents=64, device="cpu", run_dir=run_dir,
                             export=True, checkpoint=True)
    p = presets.PRESETS["delaware-res"]
    years = list(range(p.start_year, p.end_year + 1, 2))
    assert rec["run_dir"] == run_dir and set(rec) == JAX_KEYS | PORT_KEYS
    for name in export.SURFACES:
        assert sorted(os.listdir(os.path.join(run_dir, name))) == \
            [f"year={y}.npz" for y in years], name
    ao = export.load_surface(run_dir, "agent_outputs")
    assert len(ao["agent_id"]) == 64 * len(years)
    with np.load(os.path.join(run_dir, "agents.npz")) as z:
        assert z["state_abbr"].tolist() == ["DE"] * 64
    meta = json.load(open(os.path.join(run_dir, "meta.json")))
    assert meta["preset"] == "delaware-res" and meta["async_io"] is True
    assert checkpoint.valid_years(os.path.join(run_dir, "ckpt")) == years
    assert rec["export_overlapped_s"] > 0 and rec["host_io_s"] > 0
    assert 0.0 <= rec["overlap_efficiency"] <= 1.0


def test_cli_prints_the_record_last(capsys):
    assert presets.main(["delaware-res", "--agents", "64", "--device", "cpu",
                         "--no-export"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert set(rec) == JAX_KEYS | PORT_KEYS
    assert rec["preset"] == "delaware-res" and rec["agents"] == 64
    assert lines[0].startswith("preset delaware-res:")


def test_cli_without_no_export_exits_2(tmp_path):
    """Without ``--no-export`` the CLI exports (the name of this test
    predates the port of the run outputs): it exits 0, writes the
    surfaces into ``--run-dir`` and names it in its record;
    ``--checkpoint`` adds the checkpoints."""
    run_dir = str(tmp_path / "cli-run")
    proc = subprocess.run(
        [sys.executable, "-m", "dgen_tpu_torch.presets", "delaware-res",
         "--agents", "64", "--device", "cpu", "--run-dir", run_dir, "--checkpoint"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["run_dir"] == run_dir and rec["host_io_s"] is not None
    assert sorted(os.listdir(run_dir)) == ["agent_outputs", "agents.npz", "ckpt",
                                           "finance_series", "meta.json", "state_hourly"]
