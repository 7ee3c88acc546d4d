"""Scenario inputs: every year-dependent trajectory and market parameter
as small dense tensors, gathered per agent per year (port of
``dgen_tpu/models/scenario.py``).

A trajectory keyed (year, sector) is a ``[n_years, n_sectors]`` tensor;
applying it to agents is one gather on ``(year_idx, sector_idx)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from dgen_tpu_torch.config import (
    BASS_DEFAULTS,
    PAYBACK_GRID_N,
    SECTORS,
    ScenarioConfig,
    resolve_device,
)
from dgen_tpu_torch.models.agents import AgentTable
from dgen_tpu_torch.ops.cashflow import MACRS_5, FinanceParams
from dgen_tpu_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ScenarioInputs:
    """All year-dependent model inputs. Axes: Y = model years,
    S = sectors, G = state x sector groups, R = regions."""

    pv_capex_per_kw: torch.Tensor            # [Y, S]
    pv_om_per_kw: torch.Tensor               # [Y, S]
    pv_degradation: torch.Tensor             # [Y, S]
    batt_capex_per_kwh: torch.Tensor         # [Y, S]
    batt_capex_per_kw: torch.Tensor          # [Y, S]
    batt_eff: torch.Tensor                   # [Y, S] round-trip efficiency
    batt_lifetime_yrs: torch.Tensor          # [Y, S]
    pv_capex_per_kw_combined: torch.Tensor   # [Y, S]
    batt_capex_per_kwh_combined: torch.Tensor  # [Y, S]
    load_growth: torch.Tensor                # [Y, R, S]
    elec_price_multiplier: torch.Tensor      # [Y, R, S]
    elec_price_escalator: torch.Tensor       # [Y, R, S]
    wholesale_multiplier: torch.Tensor       # [Y, R]
    loan_term_yrs: torch.Tensor              # [Y, S] int32
    loan_interest_rate: torch.Tensor         # [Y, S]
    down_payment_fraction: torch.Tensor      # [Y, S]
    real_discount_rate: torch.Tensor         # [Y, S]
    tax_rate: torch.Tensor                   # [Y, S]
    itc_fraction: torch.Tensor               # [Y, S]
    deprec_sch: torch.Tensor                 # [Y, S, D]
    bass_p: torch.Tensor                     # [G]
    bass_q: torch.Tensor                     # [G]
    teq_yr1: torch.Tensor                    # [G]
    mms_table: torch.Tensor                  # [S, PAYBACK_GRID_N]
    attachment_rate: torch.Tensor            # [G]
    starting_kw: torch.Tensor                # [G]
    starting_batt_kw: torch.Tensor           # [G]
    starting_batt_kwh: torch.Tensor          # [G]
    anchor_years_mask: torch.Tensor          # [Y]
    observed_kw: torch.Tensor                # [Y, G]
    #: [Y, n_states] state PV-kW cap under which NEM stays available
    nem_cap_kw: torch.Tensor
    years: torch.Tensor                      # [Y] calendar years (f32)
    value_of_resiliency: torch.Tensor        # [Y, G]
    cap_cost_multiplier: torch.Tensor        # [Y, S]
    carbon_intensity_t_per_kwh: torch.Tensor  # [Y, n_states]
    inflation: torch.Tensor                  # scalar

    @property
    def n_years(self) -> int:
        return self.pv_capex_per_kw.shape[0]


class ScenarioStackError(ValueError):
    """Scenarios cannot share one year step: a static field (a leaf's
    shape or dtype) differs between members. The message names the
    offending field."""


@dataclasses.dataclass(frozen=True)
class ScenarioStack:
    """S :class:`ScenarioInputs` stacked along a leading scenario axis:
    every leaf of ``inputs`` is ``[S, ...]``, on the members' device.
    Scenarios differ only in these small trajectory tensors, never in the
    profile banks, so a sweep adds O(S x Y x G) bytes to a run. Built by
    :func:`stack_scenarios`, which validates the static configuration."""

    inputs: ScenarioInputs   # every leaf [S, ...]

    @property
    def n_scenarios(self) -> int:
        return self.inputs.pv_capex_per_kw.shape[0]

    @property
    def n_years(self) -> int:
        return self.inputs.pv_capex_per_kw.shape[1]

    def scenario(self, i: int) -> ScenarioInputs:
        """Member ``i`` (views of the stacked leaves)."""
        return tree_map(lambda leaf: leaf[i], self.inputs)


def validate_scenario_statics(members: Sequence[ScenarioInputs]) -> None:
    """Check that S scenarios share one static configuration: every leaf
    must agree in shape and dtype across members (the year grid and the
    group/region/state axis sizes). Raises :class:`ScenarioStackError`
    naming the offending field, with the JAX package's message."""
    members = list(members)
    if not members:
        raise ScenarioStackError("cannot stack zero scenarios")
    ref = members[0]
    for f in dataclasses.fields(ScenarioInputs):
        ref_leaf = getattr(ref, f.name)
        for i, m in enumerate(members[1:], start=1):
            leaf = getattr(m, f.name)
            if tuple(leaf.shape) != tuple(ref_leaf.shape):
                raise ScenarioStackError(
                    f"scenario {i} field '{f.name}' has shape "
                    f"{tuple(leaf.shape)} but scenario 0 has "
                    f"{tuple(ref_leaf.shape)}; scenarios in one stack must "
                    "share the static grid (years / groups / regions / states)"
                )
            if leaf.dtype != ref_leaf.dtype:
                raise ScenarioStackError(
                    f"scenario {i} field '{f.name}' has dtype "
                    f"{leaf.dtype} but scenario 0 has {ref_leaf.dtype}"
                )


def stack_scenarios(members: Sequence[ScenarioInputs]) -> ScenarioStack:
    """Stack S scenarios into one :class:`ScenarioStack` (static
    configuration validated by :func:`validate_scenario_statics`)."""
    members = list(members)
    validate_scenario_statics(members)
    return ScenarioStack(inputs=tree_map(lambda *leaves: torch.stack(leaves), *members))


@dataclasses.dataclass(frozen=True)
class YearAgentInputs:
    """Per-agent values for ONE model year, leaves ``[N]``."""

    load_kwh_per_customer: torch.Tensor
    customers_in_bin: torch.Tensor
    developable_agent_weight: torch.Tensor
    elec_price_multiplier: torch.Tensor
    elec_price_escalator: torch.Tensor
    pv_degradation: torch.Tensor
    batt_rt_eff: torch.Tensor
    wholesale_multiplier: torch.Tensor
    system_capex_per_kw: torch.Tensor
    system_capex_per_kw_combined: torch.Tensor
    batt_capex_per_kwh_combined: torch.Tensor
    cap_cost_multiplier: torch.Tensor
    value_of_resiliency: torch.Tensor
    fin: FinanceParams


def apply_year(table: AgentTable, inputs: ScenarioInputs, year_idx: int) -> YearAgentInputs:
    """Gather all year-y trajectory values onto the agent axis.
    Residential load growth scales kWh per customer; commercial and
    industrial growth scales the customer count."""
    s = table.sector_idx.long()
    r = table.region_idx.long()
    g = table.group_idx.long()
    y = int(year_idx)

    growth = inputs.load_growth[y, r, s]
    is_res = s == 0
    one = torch.ones_like(growth)
    load_kwh = table.load_kwh_per_customer_in_bin * torch.where(is_res, growth, one)
    customers = table.customers_in_bin * torch.where(is_res, one, growth)

    fin = FinanceParams(
        down_payment_fraction=inputs.down_payment_fraction[y, s],
        loan_interest_rate=inputs.loan_interest_rate[y, s],
        loan_term_yrs=inputs.loan_term_yrs[y, s],
        real_discount_rate=inputs.real_discount_rate[y, s],
        inflation_rate=inputs.inflation.expand(s.shape).clone(),
        tax_rate=inputs.tax_rate[y, s],
        itc_fraction=inputs.itc_fraction[y, s],
        is_commercial=(s != 0).to(torch.float32),
        om_per_year=torch.zeros_like(load_kwh),  # O&M is zero in the hot loop
        deprec_sch=inputs.deprec_sch[y, s],
    )

    return YearAgentInputs(
        load_kwh_per_customer=load_kwh,
        customers_in_bin=customers,
        developable_agent_weight=table.developable_agent_weight(customers),
        elec_price_multiplier=inputs.elec_price_multiplier[y, r, s],
        elec_price_escalator=inputs.elec_price_escalator[y, r, s],
        pv_degradation=inputs.pv_degradation[y, s],
        batt_rt_eff=inputs.batt_eff[y, s],
        wholesale_multiplier=inputs.wholesale_multiplier[y, r],
        system_capex_per_kw=inputs.pv_capex_per_kw[y, s],
        system_capex_per_kw_combined=inputs.pv_capex_per_kw_combined[y, s],
        batt_capex_per_kwh_combined=inputs.batt_capex_per_kwh_combined[y, s],
        cap_cost_multiplier=inputs.cap_cost_multiplier[y, s],
        value_of_resiliency=inputs.value_of_resiliency[y, g],
        fin=fin,
    )


def federal_itc_schedule(years: Sequence[int]) -> np.ndarray:
    """[Y, 3] statutory federal ITC fractions for host-owned systems:
    30% through 2019, 26% 2020-21, 30% 2022-2032, 26% 2033, 22% 2034,
    then 0% res / 10% com+ind."""
    out = np.zeros((len(years), len(SECTORS)), dtype=np.float32)
    for i, y in enumerate(years):
        if y <= 2019:
            frac = (0.30, 0.30, 0.30)
        elif y <= 2021:
            frac = (0.26, 0.26, 0.26)
        elif y <= 2032:
            frac = (0.30, 0.30, 0.30)
        elif y == 2033:
            frac = (0.26, 0.26, 0.26)
        elif y == 2034:
            frac = (0.22, 0.22, 0.22)
        else:
            frac = (0.0, 0.10, 0.10)
        out[i] = frac
    return out


def escalator_from_multipliers(mult: np.ndarray, years: np.ndarray,
                               year_cap: int = 2040,
                               clip: float = 0.01) -> np.ndarray:
    """Price escalator per model year, reference semantics
    (agent_mutation/elec.py:63-79): the escalator for model year ``y`` is
    the CAGR of the multiplier from ``min(y, 2040)`` to the trajectory's
    final year, clipped to +-1%/yr. Host numpy. ``mult``: [Y, ...]
    multiplier trajectory on the model-year grid."""
    years = np.asarray(years)
    out = np.zeros_like(mult)
    final_idx = len(years) - 1
    for i, y in enumerate(years):
        yc = min(int(y), year_cap)
        j = max(0, int(np.searchsorted(years, yc, side="right")) - 1)
        span = max(float(years[final_idx] - years[j]), 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            cagr = (mult[final_idx] / np.maximum(mult[j], 1e-9)) ** (1.0 / span) - 1.0
        out[i] = np.clip(np.nan_to_num(cagr), -clip, clip)
    return out


def uniform_inputs(
    config: ScenarioConfig,
    n_groups: int,
    n_regions: int,
    overrides: Dict[str, object] | None = None,
    n_states: int | None = None,
    device="cuda",
) -> ScenarioInputs:
    """Flat/constant scenario inputs (testing + synthetic runs) on
    ``device``; every field can be overridden with a host array.
    ``n_states`` defaults to ``n_groups // len(SECTORS)``."""
    dev = resolve_device(device)
    years = np.asarray(config.model_years)
    Y, S, G, R = len(years), len(config.sectors), n_groups, n_regions
    n_st = n_states if n_states is not None else max(G // len(SECTORS), 1)
    f = np.float32

    def yz(v):
        return np.full((Y, S), v, dtype=f)

    # simple declining capex trajectory (ATB-like shape)
    decline = np.linspace(1.0, 0.45, Y, dtype=f)[:, None]
    pv_capex = 3000.0 * decline * np.ones((1, S), f)
    batt_capex_kwh = 900.0 * decline * np.ones((1, S), f)

    # max-market-share curve: smooth decay in payback (res faster than
    # com/ind) on the 0.1-year grid; the 30.1 never-payback sentinel is
    # exactly 0 so agents that never pay back cannot adopt
    pb = np.arange(PAYBACK_GRID_N, dtype=f) * 0.1
    curves = []
    for s_i in range(S):
        halflife = 4.0 if s_i == 0 else 6.0
        curves.append(np.exp(-pb / halflife))
    mms = np.stack(curves)
    mms[:, -1] = 0.0

    anchor_mask = np.isin(years, np.asarray(config.anchor_years)).astype(f)

    vals = dict(
        pv_capex_per_kw=pv_capex,
        pv_om_per_kw=yz(15.0),
        pv_degradation=yz(0.005),
        batt_capex_per_kwh=batt_capex_kwh,
        batt_capex_per_kw=yz(1000.0),
        batt_eff=yz(0.9216),
        batt_lifetime_yrs=yz(10.0),
        pv_capex_per_kw_combined=pv_capex * f(1.05),
        batt_capex_per_kwh_combined=batt_capex_kwh * f(0.95),
        load_growth=np.ones((Y, R, S), dtype=f),
        elec_price_multiplier=np.ones((Y, R, S), dtype=f),
        elec_price_escalator=np.zeros((Y, R, S), dtype=f),
        wholesale_multiplier=np.ones((Y, R), dtype=f),
        loan_term_yrs=np.full((Y, S), 20, dtype=np.int32),
        loan_interest_rate=yz(0.05),
        down_payment_fraction=yz(1.0),
        real_discount_rate=yz(0.027),
        tax_rate=yz(0.257),
        itc_fraction=yz(0.30),
        deprec_sch=np.broadcast_to(MACRS_5, (Y, S, MACRS_5.shape[0])),
        bass_p=np.full(G, BASS_DEFAULTS[0], dtype=f),
        bass_q=np.full(G, BASS_DEFAULTS[1], dtype=f),
        teq_yr1=np.full(G, BASS_DEFAULTS[2], dtype=f),
        mms_table=mms,
        attachment_rate=np.zeros(G, dtype=f),
        starting_kw=np.zeros(G, dtype=f),
        starting_batt_kw=np.zeros(G, dtype=f),
        starting_batt_kwh=np.zeros(G, dtype=f),
        anchor_years_mask=anchor_mask,
        observed_kw=np.zeros((Y, G), dtype=f),
        nem_cap_kw=np.full((Y, n_st), 1e30, dtype=f),
        years=years.astype(f),
        value_of_resiliency=np.zeros((Y, G), dtype=f),
        cap_cost_multiplier=yz(1.0),
        carbon_intensity_t_per_kwh=np.zeros((Y, n_st), dtype=f),
        inflation=np.asarray(config.annual_inflation, dtype=f),
    )
    if overrides:
        vals.update(overrides)
    # host arrays keep their dtype except float64, which becomes float32
    # as under the JAX package's default 32-bit mode
    return ScenarioInputs(**{k: _as_f32_tensor(v, dev) for k, v in vals.items()})


def _as_f32_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        t = v
    else:
        t = torch.from_numpy(np.array(v))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t.to(device)
