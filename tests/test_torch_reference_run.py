"""A national-style run of the PyTorch port driven by the committed
reference-format input root (``tests/torch_fixtures/reference_inputs``)
against the JAX package's, and the reference-schema writeback.

``ercot-all-sector`` is built on the root by ``presets.build(...,
input_root=...)`` in both packages (population seed 7, 64 agents, the
preset's depth cut to 3 model years, ``sizing_iters=4``; the JAX
package's preset is cut through its ``PRESETS`` table, which its
``build`` reads): the ingested inputs and the wholesale bank bit for
bit, the national curves within rtol 1e-3 and the integer battery
adopters equal per agent (the slice contract of
``tests/test_torch_slice.py``), with batteries allocated and Texas's NEM
cap closing in the second year. The same port run writes its surfaces
(compact and full precision), and the port's ``write_reference_tables``
on them equals the JAX package's on their ``to_parquet`` copies byte for
byte."""

import csv
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from dgen_tpu import presets as jpresets
from dgen_tpu.config import RunConfig as JRunConfig
from dgen_tpu.io import refschema as jrefschema
from dgen_tpu_torch import presets
from dgen_tpu_torch.config import RunConfig
from dgen_tpu_torch.io import export, refschema, synth
from dgen_tpu_torch.io.nem import NO_CAP
from dgen_tpu_torch.io.reference_inputs import (scenario_inputs_from_reference,
                                                wholesale_profile_bank)
from dgen_tpu_torch.models.simulation import compute_nem_allowed

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures",
                    "reference_inputs", "dgen_os", "input_data")
NAME = "ercot-all-sector"
N_AGENTS = 64
END_YEAR = 2018
STATES = list(synth.STATES)


def _exporter(run_dir, sim, pop, compact):
    return export.RunExporter(
        run_dir, agent_id=sim.host_agent_id, mask=sim.host_mask, state_names=STATES,
        compact=compact, device="cpu",
        static_frame=export.static_frame_from_table(pop.table, states=STATES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("reference_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpresets.PRESETS, NAME,
                   dataclasses.replace(jpresets.PRESETS[NAME], end_year=END_YEAR))
        jsim, _, jmeta = jpresets.build(NAME, n_agents=N_AGENTS, input_root=ROOT,
                                        run_config=JRunConfig(sizing_iters=4))
    jres = jsim.run()
    tsim, tpop, tmeta = presets.build(NAME, n_agents=N_AGENTS, input_root=ROOT,
                                      end_year=END_YEAR, device="cpu",
                                      run_config=RunConfig(sizing_iters=4))
    dirs = {"compact": str(base / "compact"), "full": str(base / "full")}
    exporters = [_exporter(dirs["compact"], tsim, tpop, True),
                 _exporter(dirs["full"], tsim, tpop, False)]

    def both(year, yi, outs):
        for ex in exporters:
            ex(year, yi, outs)

    tres = tsim.run(callback=both)
    return dict(jsim=jsim, jres=jres, jmeta=jmeta, tsim=tsim, tpop=tpop, tres=tres,
                tmeta=tmeta, dirs=dirs, base=base)


def test_the_world_is_the_ingested_one(runs):
    tsim, jsim, tmeta = runs["tsim"], runs["jsim"], runs["tmeta"]
    assert tmeta["data_sources"] == runs["jmeta"]["data_sources"] == \
        {"itc": "ingested", "nem_caps": "ingested"}
    assert tmeta["market_curves"] == runs["jmeta"]["market_curves"] == \
        {"mms": "ingested", "bass": "ingested"}
    assert runs["tpop"].n_regions == 9
    assert int(tsim.table.region_idx.max()) < 9
    assert tsim.years == [2014, 2016, 2018] == list(jsim.years)
    for f in dataclasses.fields(tsim.inputs):
        got = getattr(tsim.inputs, f.name).numpy()
        ref = np.asarray(getattr(jsim.inputs, f.name))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f.name
    wholesale = tsim.profiles.wholesale.numpy()
    assert wholesale.shape == (9, 8760)
    assert np.array_equal(wholesale, np.asarray(jsim.profiles.wholesale))
    _, meta = scenario_inputs_from_reference(ROOT, tsim.scenario, STATES, device="cpu")
    assert np.array_equal(wholesale, wholesale_profile_bank(meta, ROOT))


def test_national_curves_match(runs):
    mask = np.asarray(runs["jsim"].host_mask)
    np.testing.assert_array_equal(mask, runs["tsim"].host_mask)
    js, ts = runs["jres"].summary(mask), runs["tres"].summary(mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum", "new_adopters"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    assert js["adopters"][-1] > 0


def test_battery_adopters_equal_and_allocated(runs):
    got = runs["tres"].agent["new_batt_adopters"]
    np.testing.assert_array_equal(got, runs["jres"].agent["new_batt_adopters"])
    assert (got.sum(axis=1) > 0).all()


def test_nem_cap_closes_in_the_second_year(runs):
    """Texas's cap opens in 2016 below its installed capacity: every Texas
    agent has net metering in 2014 and none in 2016."""
    tsim, tres = runs["tsim"], runs["tres"]
    assert tsim._net_billing
    tx = STATES.index("TX")
    caps = tsim.inputs.nem_cap_kw[:, tx]
    assert caps[0] == NO_CAP and caps[1] < NO_CAP
    mask = torch.from_numpy(tsim.host_mask) > 0
    state_kw = torch.zeros(tsim.table.n_states).index_add_(
        0, tsim.table.state_idx.long(),
        torch.from_numpy(tres.agent["system_kw_cum"][0]))
    open_2016 = compute_nem_allowed(tsim.table, tsim.inputs, 1, state_kw)
    assert float(state_kw[tx]) > float(caps[1])
    assert open_2016[mask].sum() == 0


@pytest.mark.parametrize("kind", ["compact", "full"])
def test_writeback_equals_the_jax_package(runs, kind):
    run_dir = runs["dirs"][kind]
    pq = export.to_parquet(run_dir, run_dir + "-pq")
    got = refschema.write_reference_tables(run_dir, str(runs["base"] / f"ref-{kind}-t"))
    ref = jrefschema.write_reference_tables(pq, str(runs["base"] / f"ref-{kind}-j"))
    assert set(got) == set(ref) == {"agent_outputs", "agent_finance_series",
                                    "state_hourly_agg"}
    for name in ref:
        assert filecmp.cmp(got[name], ref[name], shallow=False), name
    with open(got["agent_finance_series"]) as f:
        rows = list(csv.DictReader(f))
    # compact runs zero-fill cf_energy_value; full precision carries it
    energy = np.asarray([json.loads(r["cf_energy_value"]) for r in rows])
    assert energy.shape == (len(rows), 25)
    assert (np.abs(energy).sum() == 0) == (kind == "compact")


def test_refschema_cli(runs, capsys):
    out = str(runs["base"] / "cli")
    refschema.main([runs["dirs"]["compact"], out])
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in printed] == \
        ["agent_outputs", "agent_finance_series", "state_hourly_agg"]
    assert sorted(os.listdir(out)) == ["agent_finance_series.csv", "agent_outputs.csv",
                                       "state_hourly_agg.csv"]


@pytest.mark.parametrize("knobs,dtype", [
    ({"bf16_banks": True}, torch.bfloat16),
    ({"quant_banks": True, "pack_once": True, "stream_segments": True}, torch.float32)])
def test_bank_knobs_apply_to_the_ingested_wholesale_bank(knobs, dtype):
    sim, pop, _ = presets.build(NAME, n_agents=16, input_root=ROOT, end_year=2016,
                                device="cpu", run_config=RunConfig(**knobs))
    synth_sim, _, _ = presets.build(NAME, n_agents=16, end_year=2016, device="cpu",
                                    run_config=RunConfig(**knobs))
    assert sim.profiles.wholesale.dtype == synth_sim.profiles.wholesale.dtype == dtype
    assert tuple(sim.profiles.wholesale.shape) == (9, 8760)
    assert sim.profiles.load.dtype == synth_sim.profiles.load.dtype


def test_a_missing_root_keeps_the_synthetic_world(tmp_path):
    pop, cfg, inputs, _, meta = presets.world(NAME, 16, end_year=2016, device="cpu",
                                              input_root=str(tmp_path / "absent"))
    assert meta["data_sources"] == {"all": "synthetic_default"}
    assert meta["market_curves"] == {"mms": "synthetic_default", "bass": "synthetic_default"}
    assert pop.n_regions == presets.SYNTH_REGIONS
    pop2, _, inputs2, _, meta2 = presets.world(NAME, 16, end_year=2016, device="cpu",
                                               input_root=ROOT, attachment_rate=0.5)
    assert meta2["data_sources"]["nem_caps"] == "ingested" and pop2.n_regions == 9
    assert torch.all(inputs2.attachment_rate == 0.5)
