"""chip_smoke.py's run outputs phase [3f] on the CPU: it passes its four
runs at a small size and fails on a pipeline write off the serialized one
and on a resume that drops the restored carry. (The rest of chip_smoke.py's
CPU tests are in tests/test_torch_chip_smoke.py; these take about half its
time, so the two files balance across the suite's workers.)"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


#: [3f] on the CPU: the four runs at a small size (the whole table: the
#: chunked year is held to the whole table by tests/test_torch_chunk.py)
OUTPUTS_KW = dict(name="ercot-all-sector", n_agents=64, end_year=2016, device="cpu",
                  knobs=dict(agent_chunk=0, sizing_iters=4))


def test_run_outputs_phase_passes_on_the_cpu(tmp_path, capsys):
    """[3f]'s four runs hold together: pipeline and serialized files byte
    for byte, the resumed run bit for bit, the quantization within its
    bound and the CPU's codes; its work directory is removed."""
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig

    out = cs.run_outputs(presets, RunConfig, None, workdir=str(tmp_path), **OUTPUTS_KW)
    assert all(out["same"].values())
    assert set(out["walls"]) == {"a", "b", "c", "d"} and out["ratios"]["a"] == 1.0
    assert set(out["trace"]) == {"no consumer", "pipeline, export + checkpoint"}
    assert set(out["fetch"]) == {"cold", "warm"}
    assert len(out["fetched"]) == 2 and all(b > 0 for b in out["fetched"])
    assert set(out["written"]) == {2014, 2016} and out["ckpt_bytes"] > 0
    assert out["stats"]["d2h_bytes"] > sum(out["fetched"])
    assert os.listdir(tmp_path) == []
    log = capsys.readouterr().out
    for part in ("[3f]", "(d) resumed after 2014", "compact quantization", "walls s",
                 "hostio_stats", "bytes a year", "checkpoint save s", "fetch stage alone",
                 "traced year 2 (no consumer)", "traced year 2 (pipeline"):
        assert part in log, part


@pytest.mark.parametrize("mutant", ["pipeline_write", "resume_carry"])
def test_run_outputs_phase_catches_a_fault(tmp_path, monkeypatch, mutant):
    """A pipeline write that differs from the serialized one in one value,
    and a resume that drops the restored carry, each fail [3f]."""
    import dataclasses as dc

    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.io import export
    from dgen_tpu_torch.models.simulation import Simulation

    if mutant == "pipeline_write":
        write_host = export.RunExporter.write_host

        def mutated(self, year, year_idx, host):
            rest = host["ao"][2]
            rest[0] = rest[0].copy()
            rest[0][0] += 1.0
            return write_host(self, year, year_idx, host)

        monkeypatch.setattr(export.RunExporter, "write_host", mutated)
        match = "differ"
    else:
        monkeypatch.setattr(Simulation, "_sanitize_restored_carry",
                            lambda self, carry: dc.replace(
                                carry, batt_adopters_cum=carry.batt_adopters_cum * 0.0,
                                market=self.init_carry().market))
        match = "resumed differs"
    with pytest.raises(AssertionError, match=match):
        cs.run_outputs(presets, RunConfig, None, workdir=str(tmp_path), **OUTPUTS_KW)
    assert os.listdir(tmp_path) == []
