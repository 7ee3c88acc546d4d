"""Golden gate of the PyTorch port: the committed port-format copy of the
golden package (tests/torch_fixtures/golden_pkg, which
dgen_tpu_torch/tools/make_golden_package.py makes from the golden
fixture's pickles with the port's converter), loaded through the port's
own loader, run for 19 model years on the port, and held to
tests/fixtures/golden_adoption.json under the contract of
tests/test_golden_e2e.py: curves within rtol 1e-3 and the final
system-size histogram exact. The gated sizing path is held to the
default run as tests/test_golden_e2e.py holds the JAX package's, and the
bf16 and int8 profile banks are held to the port's own float32 run within
the JAX package's 2% envelope (tests/test_golden_e2e.py:265-361). The
port runs its plain versions on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from dgen_tpu_torch.config import RunConfig, ScenarioConfig
from dgen_tpu_torch.io import package
from dgen_tpu_torch.models import scenario
from dgen_tpu_torch.models.simulation import Simulation
from dgen_tpu_torch.ops import bill as bill_ops
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import sizing

pytestmark = pytest.mark.slow

TESTS = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(TESTS, "fixtures", "golden_adoption.json")
GOLDEN_PKG = os.path.join(TESTS, "torch_fixtures", "golden_pkg")
RTOL = 1e-3


@pytest.fixture(scope="module")
def golden_world():
    """The golden population on the port's CPU tensors, with its
    scenario config and inputs."""
    device = "cpu"
    pop = package.load_population(GOLDEN_PKG, pad_multiple=32, device=device)
    table, profiles, tariffs = pop.table, pop.profiles, pop.tariffs
    cfg = ScenarioConfig(name="golden", start_year=2014, end_year=2050,
                         anchor_years=())
    inputs = scenario.uniform_inputs(
        cfg, n_groups=table.n_groups, n_regions=profiles.wholesale.shape[0],
        overrides={"attachment_rate": np.full((table.n_groups,), 0.35, np.float32)},
        n_states=table.n_states, device=device,
    )
    return table, profiles, tariffs, inputs, cfg


def _run(world, run_config: RunConfig):
    table, profiles, tariffs, inputs, cfg = world
    sim = Simulation(table, profiles, tariffs, inputs, cfg, run_config,
                     with_hourly=True, device="cpu")
    return sim, sim.run()


@pytest.fixture(scope="module")
def port_golden_run(golden_world):
    sim, res = _run(golden_world, RunConfig(sizing_iters=8))
    mask = sim.host_mask
    ids = sim.host_agent_id
    s = res.summary(mask)
    kw_final = res.agent["system_kw"][-1] * mask
    return {
        "years": list(map(int, res.years)),
        "adopters": s["adopters"],
        "system_kw_cum": s["system_kw_cum"],
        "batt_kwh_cum": s["batt_kwh_cum"],
        "state_hourly_net_mwh": res.state_hourly_net_mw.sum(axis=2),
        "state_hourly_abs_mwh": np.abs(res.state_hourly_net_mw).sum(axis=2),
        "cash_flow_total": [float((cf * mask[:, None]).sum())
                            for cf in res.agent["cash_flow"]],
        "adoption_checksum": float((res.agent["number_of_adopters"][-1] * mask
                                    * (ids % 97 + 1)).sum()),
        "kw_histogram": np.histogram(
            kw_final[mask > 0],
            bins=[0.0, 1e-6, 2, 4, 6, 8, 12, 20, 50, 200, 1e9])[0].tolist(),
    }


def test_port_reproduces_golden_adoption(port_golden_run):
    curves = port_golden_run
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert curves["years"] == golden["years"]
    for key in ("adopters", "system_kw_cum", "batt_kwh_cum", "cash_flow_total",
                "adoption_checksum"):
        np.testing.assert_allclose(curves[key], golden[key], rtol=RTOL,
                                   err_msg=f"{key} drifted >0.1% from the golden curve")
    for key in ("state_hourly_net_mwh", "state_hourly_abs_mwh"):
        np.testing.assert_allclose(curves[key], golden[key], rtol=RTOL, atol=0.05,
                                   err_msg=key)
    assert curves["kw_histogram"] == golden["kw_histogram"]


def test_gated_golden_run_matches_default(golden_world, port_golden_run):
    """The gated sizing path (daylight-compacted lanes, pack-once, the
    stream engine) on the golden fixture, to the JAX package's bounds
    (tests/test_golden_e2e.py::test_golden_daylight_compact_parity): the
    compaction only re-associates float32 sums, so the import sums of the
    golden streams hold 1e-5 of the full-hour ones, and national curves
    hold rtol 1e-4 of the default run (an agent may flip between two
    near-tied candidate sizes)."""
    sim, res = _run(golden_world, RunConfig(sizing_iters=8, daylight_compact=True,
                                            pack_once=True, stream_segments=True))
    lay = sim._daylight
    assert lay is not None, "the golden solar profiles have compactable night hours"
    assert sim.step_kwargs(True)["sizing_impl"] == "stream"

    table, profiles, tariffs, _, _ = golden_world
    p = tariffs.max_periods
    at = bill_ops.gather_tariff(tariffs, table.tariff_idx)
    load = (profiles.load[table.load_idx.long()]
            * table.load_kwh_per_customer_in_bin[:, None])
    gen = profiles.solar_cf[table.cf_idx.long()] * sizing.INV_EFF
    sell = bk.sell_rate_hourly(at, profiles.wholesale[table.region_idx.long()])
    bucket = bk.hourly_bucket_ids(at.hour_period, p)
    scales = torch.from_numpy(np.abs(np.random.default_rng(0).normal(
        2.0, 1.5, (load.shape[0], 8))).astype(np.float32))
    full = bk.import_sums(load, gen, sell, bucket, scales, 12 * p)
    for impl, layout in (("auto", lay), ("stream", lay.uniform())):
        comp = bk.import_sums(load, gen, sell, bucket, scales, 12 * p, impl=impl,
                              layout=layout)
        for a, c in zip(full, comp):
            scale = max(float(a.abs().max()), 1.0)
            assert float((a - c).abs().max()) / scale < 1e-5, impl

    s = res.summary(sim.host_mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum"):
        np.testing.assert_allclose(s[k], port_golden_run[k], rtol=1e-4, err_msg=k)


def _within_bank_envelope(world, golden, knobs: dict, what: str):
    """The golden run under narrow banks against the port's float32
    golden run: national curves within 2% (the JAX package's envelope:
    inputs round to ~3 significant digits under bf16, to 1/254 of each
    bank row's range under int8), every output finite."""
    sim, res = _run(world, RunConfig(sizing_iters=8, **knobs))
    s = res.summary(sim.host_mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum"):
        ref = np.maximum(np.abs(np.asarray(golden[k], np.float64)), 1e-6)
        rel = np.max(np.abs(s[k] - golden[k]) / ref)
        assert rel < 2e-2, f"{k}: {what} drift {rel:.3e} exceeds the envelope"
    for v in res.agent.values():
        assert np.all(np.isfinite(v))
    return sim


def test_golden_bf16_banks_within_tolerance(golden_world, port_golden_run):
    sim = _within_bank_envelope(golden_world, port_golden_run,
                                dict(bf16_banks=True), "bf16")
    assert sim.profiles.load.dtype == torch.bfloat16


def test_golden_quant_banks_within_tolerance(golden_world, port_golden_run):
    """int8 banks with pack-once and the stream engine, the JAX package's
    configuration for this case."""
    sim = _within_bank_envelope(
        golden_world, port_golden_run,
        dict(quant_banks=True, pack_once=True, stream_segments=True), "int8")
    assert sim.profiles.load.dtype == torch.int8
    assert sim.step_kwargs(True)["sizing_impl"] == "stream"
