"""The preset runner of the PyTorch port: ``run_preset`` gives the JAX
package's record keys plus ``device`` and ``year_s``; ``python -m
dgen_tpu_torch.presets`` prints that record as its last line; without
``--no-export`` (exports are not ported) it exits 2 and runs nothing."""

import json
import subprocess
import sys

import pytest

from dgen_tpu_torch import presets

#: the keys of dgen_tpu/presets.py run_preset's record
JAX_KEYS = {"preset", "agents", "years", "agent_chunk", "with_hourly", "storage",
            "total_s", "build_s", "run_s", "compile_s", "steady_year_s",
            "export_overlapped_s", "agent_years_per_sec", "run_dir", "data_sources"}


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
    assert set(record) == JAX_KEYS | {"device", "year_s"}
    p = presets.PRESETS["delaware-res"]
    n_years = len(range(p.start_year, p.end_year + 1, 2))
    assert record["preset"] == "delaware-res" and record["agents"] == 64
    assert record["years"] == n_years == len(record["year_s"])
    assert record["device"] == "cpu" and record["agent_chunk"] == 0
    assert record["with_hourly"] is True and record["storage"] is False
    assert record["run_dir"] is None and record["export_overlapped_s"] == 0.0
    assert 0 < record["build_s"] < record["total_s"]
    assert record["run_s"] >= sum(record["year_s"]) * 0.999
    assert record["agent_years_per_sec"] == pytest.approx(
        64 * n_years / record["total_s"], rel=1e-2)


def test_export_and_checkpoint_are_refused():
    for kw in (dict(export=True), dict(export=False, checkpoint=True)):
        with pytest.raises(NotImplementedError, match="Run outputs"):
            presets.run_preset("delaware-res", n_agents=64, device="cpu", **kw)


def test_cli_prints_the_record_last(capsys):
    assert presets.main(["delaware-res", "--agents", "64", "--device", "cpu",
                         "--no-export"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert set(rec) == JAX_KEYS | {"device", "year_s"}
    assert rec["preset"] == "delaware-res" and rec["agents"] == 64
    assert lines[0].startswith("preset delaware-res:")


def test_cli_without_no_export_exits_2():
    for extra in ([], ["--no-export", "--checkpoint"]):
        proc = subprocess.run(
            [sys.executable, "-m", "dgen_tpu_torch.presets", "delaware-res",
             "--agents", "64", "--device", "cpu", *extra],
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2, (proc.stdout, proc.stderr)
        assert "not ported" in proc.stderr and proc.stdout == ""
