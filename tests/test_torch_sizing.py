"""Table-level PV sizing of the PyTorch port against the JAX package's
fast path (``size_agents(impl="xla")``) on the same world, without and
with a DG-rate switch.

Bounds: ``system_kw`` rtol 1e-4; NPV within 1e-4 x |npv| + 1e-4 x the
flow scale (25 years of the no-system bill, the float32 cancellation
scale of tests/test_billpallas.py::test_fast_sizing_matches_oracle);
payback within 0.1 year. An agent may land on a different candidate
only where the JAX objective prices the two candidates within 1e-5
relative — a near-tie the argmax may break either way — and such an
agent is then held to that bound instead of the per-agent ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models import simulation as jsim
from dgen_tpu.ops import sizing as jsizing
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models import simulation as tsim
from dgen_tpu_torch.ops import sizing as tsizing

N = 32
ITERS = 4
YEARS = 25


def _worlds(switch: float):
    rng = np.random.default_rng(9)
    over = {
        "elec_price_escalator": np.full((2, 10, 3), 0.01, np.float32),
        "value_of_resiliency": rng.uniform(0, 40, (2, 153)).astype(np.float32),
    }
    cfg_j = jcfg.ScenarioConfig(start_year=2014, end_year=2016)
    cfg_t = tcfg.ScenarioConfig(start_year=2014, end_year=2016)
    jp = jsynth.generate_population(N, seed=5, pad_multiple=8, rate_switch_frac=switch)
    tp = tsynth.generate_population(N, seed=5, pad_multiple=8, rate_switch_frac=switch,
                                    device="cpu")
    jin = jscen.uniform_inputs(cfg_j, n_groups=153, n_regions=10, overrides=over)
    tin = tscen.uniform_inputs(cfg_t, n_groups=153, n_regions=10, overrides=over,
                               device="cpu")
    # a closed NEM gate for a third of the agents forces net billing
    nem = (rng.random(jp.table.n_agents) > 0.33).astype(np.float32)
    jenv = jsim.build_econ_inputs(
        jp.table, jp.profiles, jp.tariffs, jscen.apply_year(jp.table, jin, 1),
        jnp.asarray(nem), jp.table.incentives, rate_switch=switch > 0)
    tenv = tsim.build_econ_inputs(
        tp.table, tp.profiles, tp.tariffs, tscen.apply_year(tp.table, tin, 1),
        torch.from_numpy(nem), tp.table.incentives, rate_switch=switch > 0)
    return jenv, tenv, int(jp.tariffs.max_periods)


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["no_switch", "rate_switch"])
def sized(request):
    jenv, tenv, p = _worlds(request.param)
    ref = jsizing.size_agents(jenv, n_periods=p, n_years=YEARS, n_iters=ITERS,
                              impl="xla")
    got = tsizing.size_agents(tenv, n_periods=p, n_years=YEARS, n_iters=ITERS)
    return jenv, p, ref, got


def test_candidate_grid_is_jax_linspace_bitwise():
    for k in range(4, 65):
        np.testing.assert_array_equal(
            tsizing._unit_grid(k, "cpu").numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, k, dtype=jnp.float32)))


def test_size_agents_matches_reference(sized):
    jenv, p, ref, got = sized
    kw_r = np.asarray(ref.system_kw)
    kw_g = got.system_kw.numpy()
    same = np.abs(kw_g - kw_r) <= 1e-4 * np.abs(kw_r)
    if not same.all():
        # a different candidate only on a near-tie of the JAX objective
        npv_fn, _, _ = jsizing.make_npv_objective(
            jenv, n_periods=p, n_years=YEARS, impl="xla")
        at_ref = np.asarray(npv_fn(jnp.asarray(kw_r)))
        at_got = np.asarray(npv_fn(jnp.asarray(kw_g)))
        tie = np.abs(at_got - at_ref) < 1e-5 * np.abs(at_ref)
        assert np.all(tie[~same]), (
            f"agents {np.nonzero(~same & ~tie)[0]} sized off a near-tie")
    assert same.mean() >= 0.9
    flow = 25.0 * np.abs(np.asarray(ref.first_year_bill_without_system))
    dnpv = np.abs(got.npv.numpy() - np.asarray(ref.npv))[same]
    assert np.all(dnpv <= (1e-4 * np.abs(np.asarray(ref.npv)) + 1e-4 * flow)[same])
    dpp = np.abs(got.payback_period.numpy() - np.asarray(ref.payback_period))[same]
    assert np.all(dpp <= 0.1 + 1e-6)
    for k in ("first_year_bill_with_system", "first_year_bill_without_system",
              "first_year_bill_with_batt", "batt_kw", "batt_kwh", "naep"):
        r = np.asarray(getattr(ref, k))[same]
        g = getattr(got, k).numpy()[same]
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-2, err_msg=k)
    for k in ("baseline_net_hourly", "adopter_net_hourly_pvonly",
              "adopter_net_hourly_with_batt"):
        np.testing.assert_allclose(getattr(got, k).numpy()[same],
                                   np.asarray(getattr(ref, k))[same],
                                   rtol=1e-4, atol=1e-3, err_msg=k)


def test_worlds_cover_both_tariff_paths(sized):
    """The switch world prices some agents on two tariffs (the pair
    engine); every NPV is finite in both worlds."""
    jenv, _, _, got = sized
    if jenv.tariff_w is not None:
        assert (np.asarray(jenv.switch_min_kw) < 1e29).sum() >= 3
    assert np.all(np.isfinite(got.npv.numpy()))
