"""Data plane of the PyTorch port against the JAX package: the synthetic
generator, the tariff compiler, scenario inputs and their per-year
gather, the preset world, and the numpy carry-across in convert.py.
Everything here is host-side numpy in both packages, so the oracle is
equality (``apply_year`` gathers: rtol 1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu import presets as jpresets
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import SimCarry as JSimCarry
from dgen_tpu.ops import tariff as jtariff
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch import convert
from dgen_tpu_torch import presets as tpresets
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import SimCarry
from dgen_tpu_torch.ops import tariff as ttariff

CPU = "cpu"


def assert_fields_equal(ref, port, path=""):
    """Every field of a JAX container equals the port's, dtype included."""
    for f in dataclasses.fields(port):
        a = getattr(ref, f.name)
        b = getattr(port, f.name)
        name = f"{path}{f.name}"
        if dataclasses.is_dataclass(b):
            assert_fields_equal(a, b, name + ".")
        elif isinstance(b, torch.Tensor):
            a_np = np.asarray(a)
            b_np = b.numpy()
            assert a_np.dtype == b_np.dtype, name
            assert a_np.shape == b_np.shape, name
            np.testing.assert_array_equal(a_np, b_np, err_msg=name)
        else:
            assert a == b, name


def test_config_mirrors_reference():
    assert tcfg.SECTORS == jcfg.SECTORS
    assert tcfg.PAYBACK_GRID_N == jcfg.PAYBACK_GRID_N
    assert tcfg.PAYBACK_NEVER == jcfg.PAYBACK_NEVER
    assert tcfg.BASS_DEFAULTS == jcfg.BASS_DEFAULTS
    a = jcfg.ScenarioConfig(start_year=2014, end_year=2030, anchor_years=())
    b = tcfg.ScenarioConfig(start_year=2014, end_year=2030, anchor_years=())
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert list(a.model_years) == list(b.model_years)
    assert tcfg.RunConfig().sizing_iters == jcfg.RunConfig().sizing_iters
    with pytest.raises(ValueError):
        tcfg.RunConfig(sizing_iters=3)
    with pytest.raises(ValueError):
        tcfg.ScenarioConfig(year_step=3)


@pytest.mark.parametrize("seed,switch", [(3, 0.0), (11, 0.4)])
def test_synth_population_byte_identical(seed, switch):
    ref = jsynth.generate_population(40, seed=seed, pad_multiple=16,
                                     rate_switch_frac=switch)
    port = tsynth.generate_population(40, seed=seed, pad_multiple=16,
                                      rate_switch_frac=switch, device=CPU)
    assert_fields_equal(ref.table, port.table)
    for f in ("load", "solar_cf", "wholesale"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.profiles, f)),
                                      getattr(port.profiles, f).numpy())
    assert_fields_equal(ref.tariffs, port.tariffs)
    assert ref.n_regions == port.n_regions


def test_compile_tariffs_equal():
    wk = np.zeros((12, 24), dtype=int)
    wk[:, 8:12] = 3          # non-contiguous period ids get remapped
    wk[:, 17:20] = 5
    specs = jsynth.make_tariff_specs() + [
        # legacy layout: e_prices [T][P], e_levels [T][P]
        {"e_prices": [[0.1, 0.2, 0.3, 0.4, 0.5, 0.6],
                      [0.15, 0.25, 0.35, 0.45, 0.55, 0.65]],
         "e_levels": [[300, 350, 1e38, 300, 300, 300], [1e38] * 6],
         "e_wkday_12by24": wk, "e_wkend_12by24": np.zeros((12, 24), int),
         "fixed_charge": 5.0, "metering": jtariff.NET_BILLING,
         "sell_frac_of_buy": 0.5},
        jtariff.flat_tariff(0.2, fixed=3.0),
    ]
    ref = jtariff.compile_tariffs(specs)
    port = ttariff.compile_tariffs(specs, device=CPU)
    assert_fields_equal(ref, port)
    ref_p = jtariff.compile_tariffs(specs, max_periods=4, max_tiers=3)
    port_p = ttariff.compile_tariffs(specs, max_periods=4, max_tiers=3, device=CPU)
    assert_fields_equal(ref_p, port_p)
    np.testing.assert_array_equal(jtariff.hour_month_map(), ttariff.hour_month_map())
    np.testing.assert_array_equal(jtariff.MONTH_HOURS, ttariff.MONTH_HOURS)


def _inputs_pair(overrides=None):
    cfg_j = jcfg.ScenarioConfig(start_year=2014, end_year=2024)
    cfg_t = tcfg.ScenarioConfig(start_year=2014, end_year=2024)
    ref = jscen.uniform_inputs(cfg_j, n_groups=153, n_regions=10, overrides=overrides)
    port = tscen.uniform_inputs(cfg_t, n_groups=153, n_regions=10,
                                overrides=overrides, device=CPU)
    return ref, port


def test_uniform_inputs_equal():
    ref, port = _inputs_pair()
    assert_fields_equal(ref, port)
    over = {"attachment_rate": np.full(153, 0.3, np.float32),
            "nem_cap_kw": np.full((6, 51), 5e4, np.float32)}
    ref, port = _inputs_pair(over)
    assert_fields_equal(ref, port)
    np.testing.assert_array_equal(jscen.federal_itc_schedule(range(2014, 2040)),
                                  tscen.federal_itc_schedule(range(2014, 2040)))


def test_apply_year_field_by_field():
    rng = np.random.default_rng(0)
    over = {
        "load_growth": rng.uniform(0.9, 1.3, (6, 10, 3)).astype(np.float32),
        "elec_price_multiplier": rng.uniform(0.8, 1.2, (6, 10, 3)).astype(np.float32),
        "value_of_resiliency": rng.uniform(0, 50, (6, 153)).astype(np.float32),
    }
    ref_in, port_in = _inputs_pair(over)
    ref_pop = jsynth.generate_population(40, seed=2, pad_multiple=16)
    port_pop = tsynth.generate_population(40, seed=2, pad_multiple=16, device=CPU)
    for yi in (0, 3, 5):
        ref = jscen.apply_year(ref_pop.table, ref_in, yi)
        port = tscen.apply_year(port_pop.table, port_in, yi)
        for f in dataclasses.fields(port):
            a, b = getattr(ref, f.name), getattr(port, f.name)
            if dataclasses.is_dataclass(b):
                for g in dataclasses.fields(b):
                    np.testing.assert_allclose(
                        np.asarray(getattr(a, g.name)), getattr(b, g.name).numpy(),
                        rtol=1e-6, err_msg=f"fin.{g.name}")
            else:
                np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                           err_msg=f.name)


def test_preset_world_matches_reference(tmp_path):
    # a missing input root pins the reference to its synthetic branch
    ref_sim, ref_pop, _ = jpresets.build(
        "ercot-all-sector", n_agents=64, input_root=str(tmp_path / "none"))
    sim, pop, meta = tpresets.build("ercot-all-sector", n_agents=64, device=CPU)
    assert_fields_equal(ref_pop.table, pop.table)
    assert_fields_equal(ref_pop.tariffs, pop.tariffs)
    assert_fields_equal(ref_sim.inputs, sim.inputs)
    assert list(ref_sim.years) == list(sim.years)
    assert (ref_sim._rate_switch, ref_sim._net_billing) == \
        (sim._rate_switch, sim._net_billing) == (False, True)
    assert meta["data_sources"] == {"all": "synthetic_default"}


def test_pad_table_matches_reference():
    from dgen_tpu.models.agents import pad_table as jpad
    from dgen_tpu_torch.models.agents import pad_table as tpad

    ref = jsynth.generate_population(20, seed=8, pad_multiple=8, rate_switch_frac=0.5)
    port = tsynth.generate_population(20, seed=8, pad_multiple=8, rate_switch_frac=0.5,
                                      device=CPU)
    assert tpad(port.table, 8) is port.table
    assert_fields_equal(jpad(ref.table, 48), tpad(port.table, 48))


def test_convert_round_trip_loses_nothing():
    pop = tsynth.generate_population(24, seed=4, pad_multiple=8,
                                     rate_switch_frac=0.5, device=CPU)
    _, inputs = _inputs_pair()
    carry = SimCarry.zeros(pop.table.n_agents, CPU)
    carry = dataclasses.replace(carry, batt_adopters_cum=torch.arange(
        pop.table.n_agents, dtype=torch.float32))
    for obj, fn in ((pop.table, convert.agent_table),
                    (pop.profiles, convert.profile_bank),
                    (pop.tariffs, convert.tariff_bank),
                    (inputs, convert.scenario_inputs),
                    (carry, convert.sim_carry)):
        back = fn(convert.to_numpy_dict(obj), device=CPU)
        assert_fields_equal(obj, back)


def test_convert_bridges_reference_containers():
    ref = jsynth.generate_population(24, seed=6, pad_multiple=8,
                                     rate_switch_frac=0.5)
    assert_fields_equal(ref.table, convert.agent_table(
        convert.to_numpy_dict(ref.table), device=CPU))
    assert_fields_equal(ref.tariffs, convert.tariff_bank(
        convert.to_numpy_dict(ref.tariffs), device=CPU))
    prof = convert.profile_bank(convert.to_numpy_dict(ref.profiles), device=CPU)
    np.testing.assert_array_equal(np.asarray(ref.profiles.load), prof.load.numpy())
    jcarry = JSimCarry.zeros(ref.table.n_agents)
    assert_fields_equal(jcarry, convert.sim_carry(
        convert.to_numpy_dict(jcarry), device=CPU))
    # float64 host arrays arrive as float32, as under jax's 32-bit mode
    d = convert.to_numpy_dict(ref.profiles)
    d["load"] = d["load"].astype(np.float64)
    assert convert.profile_bank(d, device=CPU).load.dtype == torch.float32
    # the int8 banks' per-row scales are carried
    d["load_scale"] = np.ones(d["load"].shape[0], np.float32)
    assert convert.profile_bank(d, device=CPU).load_scale.dtype == torch.float32
    # a field the port does not carry is refused, not dropped
    d["load_offset"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="load_offset"):
        convert.profile_bank(d, device=CPU)


def test_quantize_rows_bit_equal_to_the_jax_function():
    """Codes and scales bit for bit, on the synthetic banks and on rows
    with the contract's corners (tests/test_roofline.py::
    test_quantize_rows_contract): an all-zero row (scale 1.0, codes 0),
    an exact zero inside a row, a negative row."""
    from dgen_tpu.models.agents import quantize_rows as jquant
    from dgen_tpu_torch.models.agents import quantize_rows as tquant

    rng = np.random.default_rng(1)
    x = rng.random((6, 8760), np.float32) * 7
    x[2] = 0.0
    x[3, 10] = 0.0
    x[4] *= -1.0
    pop = tsynth.generate_population(16, seed=2, pad_multiple=8, device=CPU)
    for bank in (x, pop.profiles.load.numpy(), pop.profiles.solar_cf.numpy()):
        (q, s), (jq, js) = tquant(bank), jquant(bank)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))
    q, s = tquant(x)
    assert np.all(q[2] == 0) and s[2] == 1.0 and q[3, 10] == 0
    assert np.max(np.abs(q.astype(np.float32) * s[:, None] - x)) <= np.max(s) / 2 + 1e-7


@pytest.mark.parametrize("knobs", [dict(bf16_banks=True), dict(quant_banks=True),
                                   dict(quant_banks=True, bf16_banks=True,
                                        daylight_compact=True)],
                         ids=["bf16", "int8", "int8-bf16-daylight"])
def test_simulation_narrows_the_banks_as_the_jax_package(knobs):
    """Simulation's banks under the knobs equal the JAX Simulation's
    element for element and dtype for dtype: int8 quantization before
    bf16, the scales float32, the daylight layout from the float32 bank."""
    from dgen_tpu.models.simulation import Simulation as JSimulation
    from dgen_tpu_torch.models.simulation import Simulation as TSimulation

    jp = jsynth.generate_population(24, seed=4, pad_multiple=8)
    tp = tsynth.generate_population(24, seed=4, pad_multiple=8, device=CPU)
    cfg_j = jcfg.ScenarioConfig(start_year=2014, end_year=2014)
    cfg_t = tcfg.ScenarioConfig(start_year=2014, end_year=2014)
    g = jp.table.n_groups
    jsim = JSimulation(jp.table, jp.profiles, jp.tariffs,
                       jscen.uniform_inputs(cfg_j, n_groups=g, n_regions=jp.n_regions),
                       cfg_j, jcfg.RunConfig(**knobs))
    tsim = TSimulation(tp.table, tp.profiles, tp.tariffs,
                       tscen.uniform_inputs(cfg_t, n_groups=g, n_regions=tp.n_regions,
                                            device=CPU),
                       cfg_t, tcfg.RunConfig(**knobs), device=CPU)
    for f in ("load", "solar_cf", "wholesale", "load_scale", "solar_cf_scale"):
        ref, got = getattr(jsim.profiles, f), getattr(tsim.profiles, f)
        if ref is None:
            assert got is None, f
            continue
        assert str(got.dtype) == "torch." + jnp.dtype(ref.dtype).name, f
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)), err_msg=f)
    if knobs.get("daylight_compact"):
        assert tsim._daylight.seg_lens == jsim._daylight.seg_lens
    assert tsim.modeled_step_bytes < TSimulation(
        tp.table, tp.profiles, tp.tariffs,
        tscen.uniform_inputs(cfg_t, n_groups=g, n_regions=tp.n_regions, device=CPU),
        cfg_t, tcfg.RunConfig(), device=CPU).modeled_step_bytes
