"""The simulation runner: one model year as a sequence of tensor ops on
one device, and the synchronous year loop (port of the unchunked,
single-device path of ``dgen_tpu/models/simulation.py``).

Per year: trajectories are applied, the NEM gate is evaluated against
last year's state capacity, every agent is sized through the bill /
cashflow / dispatch hot loop, the max-market-share -> Bass-diffusion
market step runs with historical anchoring, integer battery adopters
are allocated, and the state-hourly net load is aggregated.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from dgen_tpu_torch.config import RunConfig, ScenarioConfig, resolve_device
from dgen_tpu_torch.models.agents import AgentTable, ProfileBank
from dgen_tpu_torch.models.market import (
    MarketState,
    allocate_battery_adopters,
    anchor_to_observed,
    diffusion_step,
    initial_market_shares,
    max_market_share,
    segment_sum,
)
from dgen_tpu_torch.models.scenario import ScenarioInputs, YearAgentInputs, apply_year
from dgen_tpu_torch.ops import bill as bill_ops
from dgen_tpu_torch.ops import layout as layout_ops
from dgen_tpu_torch.ops import sizing as sizing_ops
from dgen_tpu_torch.ops.tariff import HOURS, NET_BILLING, TariffBank
from dgen_tpu_torch.tree import to_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SimCarry:
    """Cross-year state: the market carry plus cumulative battery adopters."""

    market: MarketState
    batt_adopters_cum: torch.Tensor  # [N]

    @staticmethod
    def zeros(n: int, device) -> "SimCarry":
        return SimCarry(
            market=MarketState.zeros(n, device),
            batt_adopters_cum=torch.zeros(n, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class YearOutputs:
    """Per-agent results for one model year."""

    system_kw: torch.Tensor
    npv: torch.Tensor
    payback_period: torch.Tensor
    cash_flow: torch.Tensor                  # [N, Y+1]
    energy_value_pv_only: torch.Tensor       # [N, Y]
    first_year_bill_with_system: torch.Tensor
    first_year_bill_without_system: torch.Tensor
    batt_kw: torch.Tensor
    batt_kwh: torch.Tensor
    max_market_share: torch.Tensor
    market_share: torch.Tensor
    new_adopters: torch.Tensor
    number_of_adopters: torch.Tensor
    new_system_kw: torch.Tensor
    system_kw_cum: torch.Tensor
    market_value: torch.Tensor
    new_batt_adopters: torch.Tensor
    batt_adopters_cum: torch.Tensor
    batt_kw_cum: torch.Tensor
    batt_kwh_cum: torch.Tensor
    carbon_intensity_t_per_kwh: torch.Tensor
    avoided_co2_t: torch.Tensor
    #: [n_states, 8760] MW, or [0, 0] when hourly aggregation is off
    state_hourly_net_mw: torch.Tensor


# ---------------------------------------------------------------------------
# The year step
# ---------------------------------------------------------------------------

def build_econ_inputs(
    table: AgentTable,
    profiles: ProfileBank,
    tariffs: TariffBank,
    ya: YearAgentInputs,
    nem_allowed: torch.Tensor,
    incentives,
    rate_switch: bool = False,
) -> sizing_ops.AgentEconInputs:
    """The per-agent economics environment for one year: gathered
    8760-hour banks, tariffs scaled by the retail price multiplier, and
    net billing forced where the NEM policy gate has closed."""
    mult = ya.elec_price_multiplier

    def gather(idx, gate_metering=True):
        at = bill_ops.gather_tariff(tariffs, idx)
        metering = at.metering
        if gate_metering:
            metering = torch.where(nem_allowed > 0, at.metering,
                                   torch.full_like(at.metering, NET_BILLING))
        return at._replace(
            price=at.price * mult[:, None, None],
            sell_price=at.sell_price * mult[:, None],
            metering=metering,
        )

    at = gather(table.tariff_idx)
    # the switched DG rate keeps its own bank metering ungated (a taken
    # switch forces NEM on); out-of-window candidates fall back to the
    # gated original tariff
    at_w = gather(table.tariff_switch_idx, gate_metering=False) if rate_switch else None

    load = profiles.load[table.load_idx.long()] * ya.load_kwh_per_customer[:, None]
    gen_per_kw = profiles.solar_cf[table.cf_idx.long()]
    # net-billing sell rate = this year's wholesale price x retail multiplier
    ts_sell = (profiles.wholesale[table.region_idx.long()]
               * (mult * ya.wholesale_multiplier)[:, None])

    # the NEM size limit caps the bracket while NEM is active; agents
    # with a DG-rate switch are exempt
    has_switch = table.switch_min_kw < 1e29
    nem_kw_cap = torch.where((nem_allowed > 0) & ~has_switch, table.nem_kw_limit, 1e30)

    return sizing_ops.AgentEconInputs(
        load=load,
        gen_per_kw=gen_per_kw,
        ts_sell=ts_sell,
        tariff=at,
        tariff_w=at_w,
        fin=ya.fin,
        inc=incentives,
        load_kwh_per_customer=ya.load_kwh_per_customer,
        elec_price_escalator=ya.elec_price_escalator,
        pv_degradation=ya.pv_degradation,
        system_capex_per_kw=ya.system_capex_per_kw,
        system_capex_per_kw_combined=ya.system_capex_per_kw_combined,
        batt_capex_per_kwh_combined=ya.batt_capex_per_kwh_combined,
        cap_cost_multiplier=ya.cap_cost_multiplier,
        value_of_resiliency_usd=ya.value_of_resiliency,
        one_time_charge=table.one_time_charge,
        nem_kw_cap=nem_kw_cap,
        switch_min_kw=table.switch_min_kw,
        switch_max_kw=table.switch_max_kw,
        batt_rt_eff=ya.batt_rt_eff,
    )


#: upper bound on any state's cumulative installed kW a run can reach;
#: the static all-NEM proof evaluates the NEM gate at this bound
STATE_KW_BOUND = np.float32(1e28)


def _nem_allowed_arrays(state_idx, nem_first_year, nem_sunset_year, nem_kw_limit,
                        cap_row, year, state_kw_last):
    """The NEM availability predicate: the state capacity cap (vs last
    step's installed kW), the per-agent availability window, and a
    positive per-agent system-kW limit. Operators and indexing only, so
    the year step (tensors) and the host-side static proof (numpy)
    evaluate the same gates."""
    cap_gate = (state_kw_last < cap_row)[state_idx]
    window = (nem_first_year <= year) & (year <= nem_sunset_year)
    return cap_gate & window & (nem_kw_limit > 0)


def starting_state_kw(table: AgentTable, inputs: ScenarioInputs) -> torch.Tensor:
    """[n_states] installed PV kW before the first model year."""
    group_state = torch.arange(table.n_groups, device=inputs.starting_kw.device) \
        // table.n_sectors
    return segment_sum(inputs.starting_kw, group_state, table.n_states)


def compute_nem_allowed(table: AgentTable, inputs: ScenarioInputs, year_idx: int,
                        state_kw_last: torch.Tensor) -> torch.Tensor:
    """[N] float32: 1 where net metering remains available."""
    return _nem_allowed_arrays(
        table.state_idx.long(), table.nem_first_year, table.nem_sunset_year,
        table.nem_kw_limit, inputs.nem_cap_kw[year_idx], inputs.years[year_idx],
        state_kw_last,
    ).to(torch.float32)


def nem_gate_never_closes(state_idx, nem_cap_kw, nem_first_year, nem_sunset_year,
                          nem_kw_limit, years: List[int]) -> bool:
    """Host-side proof that :func:`compute_nem_allowed` is 1 for every
    given agent in every model year, with every state pinned at
    :data:`STATE_KW_BOUND` installed kW."""
    caps = np.asarray(nem_cap_kw)
    worst = np.full(caps.shape[1], STATE_KW_BOUND, np.float32)
    return all(
        bool(np.all(_nem_allowed_arrays(
            np.asarray(state_idx), np.asarray(nem_first_year),
            np.asarray(nem_sunset_year), np.asarray(nem_kw_limit),
            caps[yi], np.float32(yr), worst,
        )))
        for yi, yr in enumerate(years)
    )


def year_step(
    table: AgentTable,
    profiles: ProfileBank,
    tariffs: TariffBank,
    inputs: ScenarioInputs,
    carry: SimCarry,
    year_idx: int,
    *,
    n_periods: int,
    econ_years: int,
    sizing_iters: int,
    first_year: bool,
    with_hourly: bool,
    storage_enabled: bool,
    year_step_len: float,
    rate_switch: bool = False,
    net_billing: bool = True,
    sizing_impl: str = "auto",
    daylight: Optional[layout_ops.DaylightLayout] = None,
    pack_once: bool = False,
) -> tuple[SimCarry, YearOutputs]:
    """One model year: trajectory application -> NEM gate -> sizing ->
    max market share -> (initial shares | diffusion) -> anchoring ->
    battery allocation -> state-hourly aggregate -> carry.

    ``sizing_impl`` (``"auto"``, ``"stream"`` or ``"dot"``), ``daylight``
    and ``pack_once`` go to :func:`sizing_ops.size_agents`."""
    n_states = table.n_states
    n_groups = table.n_groups
    g = table.group_idx.long()

    ya = apply_year(table, inputs, year_idx)

    # NEM gate on last year's state capacity; in the first year that is
    # the starting installed capacity, not the zeroed carry
    if first_year:
        state_kw_last = starting_state_kw(table, inputs)
    else:
        state_kw_last = segment_sum(carry.market.system_kw_cum, table.state_idx, n_states)
    nem_allowed = compute_nem_allowed(table, inputs, year_idx, state_kw_last)

    envs = build_econ_inputs(table, profiles, tariffs, ya, nem_allowed,
                             table.incentives, rate_switch=rate_switch)
    res = sizing_ops.size_agents(
        envs, n_periods=n_periods, n_years=econ_years, n_iters=sizing_iters,
        keep_hourly=with_hourly, net_billing=net_billing, impl=sizing_impl,
        daylight=daylight, pack_once=pack_once,
    )

    # --- market step ---
    mms = max_market_share(res.payback_period, table.sector_idx,
                           inputs.mms_table) * table.mask
    if first_year:
        mstate = initial_market_shares(
            inputs.starting_kw, inputs.starting_batt_kw, inputs.starting_batt_kwh,
            g, ya.developable_agent_weight, res.system_kw, n_groups,
        )
        # starting batt capacity -> adopter count at this year's batt_kw
        batt_adopters_prev = torch.where(
            res.batt_kw > 1e-6,
            mstate.batt_kw_cum / torch.clamp_min(res.batt_kw, 1e-6), 0.0)
    else:
        mstate = carry.market
        batt_adopters_prev = carry.batt_adopters_cum

    out = diffusion_step(
        mstate, mms, res.system_kw, ya.system_capex_per_kw,
        ya.developable_agent_weight, inputs.bass_p[g], inputs.bass_q[g],
        inputs.teq_yr1[g], is_first_year=first_year, year_step=year_step_len,
    )

    # --- historical anchoring (blend; anchor_years_mask selects) ---
    am = inputs.anchor_years_mask[year_idx]
    kw_anch, adopt_anch, share_anch = anchor_to_observed(
        out.system_kw_cum, g, inputs.observed_kw[year_idx],
        table.sector_idx == 0, ya.developable_agent_weight, n_groups,
    )
    kw_cum = am * kw_anch + (1.0 - am) * out.system_kw_cum
    adopters = am * adopt_anch + (1.0 - am) * out.number_of_adopters
    share = am * share_anch + (1.0 - am) * out.market_share
    new_adopters = torch.clamp_min(adopters - mstate.adopters_cum, 0.0)
    new_kw = torch.clamp_min(kw_cum - mstate.system_kw_cum, 0.0)

    # --- integer battery-adopter allocation ---
    if storage_enabled:
        new_batt = allocate_battery_adopters(
            new_adopters, g, inputs.attachment_rate, table.agent_id, n_groups,
        ) * table.mask
    else:
        new_batt = torch.zeros_like(new_adopters)
    batt_adopters_cum = batt_adopters_prev + new_batt
    batt_kw_cum = mstate.batt_kw_cum + new_batt * res.batt_kw
    batt_kwh_cum = mstate.batt_kwh_cum + new_batt * res.batt_kwh

    # --- state-hourly aggregate: baseline / PV-only / PV+batt profiles
    # mixed by adopter counts ---
    if with_hourly:
        # cap the battery-profile weight at the agent's adopter count so
        # households are not counted twice
        batt_mix = torch.minimum(batt_adopters_cum, adopters)
        pv_only = torch.clamp_min(adopters - batt_mix, 0.0)
        base_cnt = torch.clamp_min(ya.customers_in_bin - adopters, 0.0)
        net = (
            base_cnt[:, None] * res.baseline_net_hourly
            + pv_only[:, None] * res.adopter_net_hourly_pvonly
            + batt_mix[:, None] * res.adopter_net_hourly_with_batt
        ) * table.mask[:, None]
        state_hourly = segment_sum(net, table.state_idx, n_states) / 1000.0  # kW -> MW
    else:
        state_hourly = torch.zeros((0, 0), dtype=torch.float32, device=kw_cum.device)

    new_market = MarketState(
        market_share=share,
        max_market_share=mms,
        adopters_cum=adopters,
        market_value=out.market_value,
        system_kw_cum=kw_cum,
        batt_kw_cum=batt_kw_cum,
        batt_kwh_cum=batt_kwh_cum,
        initial_adopters=mstate.initial_adopters,
        initial_market_share=mstate.initial_market_share,
    )
    carbon_t = inputs.carbon_intensity_t_per_kwh[year_idx][table.state_idx.long()]

    outputs = YearOutputs(
        system_kw=res.system_kw,
        npv=res.npv,
        payback_period=res.payback_period,
        cash_flow=res.cash_flow,
        energy_value_pv_only=res.energy_value_pv_only,
        first_year_bill_with_system=res.first_year_bill_with_system,
        first_year_bill_without_system=res.first_year_bill_without_system,
        batt_kw=res.batt_kw,
        batt_kwh=res.batt_kwh,
        max_market_share=mms,
        market_share=share,
        new_adopters=new_adopters,
        number_of_adopters=adopters,
        new_system_kw=new_kw,
        system_kw_cum=kw_cum,
        market_value=out.market_value,
        new_batt_adopters=new_batt,
        batt_adopters_cum=batt_adopters_cum,
        batt_kw_cum=batt_kw_cum,
        batt_kwh_cum=batt_kwh_cum,
        carbon_intensity_t_per_kwh=carbon_t,
        avoided_co2_t=kw_cum * res.naep * carbon_t,
        state_hourly_net_mw=state_hourly,
    )
    return SimCarry(market=new_market, batt_adopters_cum=batt_adopters_cum), outputs


def table_static_cache(table: AgentTable, tariffs: TariffBank) -> dict:
    """The scenario-invariant host predicates of :func:`run_static_flags`."""
    h = lambda t: t.cpu().numpy()
    keep0 = h(table.mask) > 0
    rate_switch = bool(np.any(h(table.tariff_switch_idx) != h(table.tariff_idx)))
    metering = h(tariffs.metering)
    used = np.unique(np.concatenate([
        h(table.tariff_idx)[keep0], h(table.tariff_switch_idx)[keep0],
    ]))
    return {
        "rate_switch": rate_switch,
        "any_nb_tariff": bool(np.any(metering[used] == NET_BILLING)),
        "state_idx": h(table.state_idx)[keep0],
        "nem_first_year": h(table.nem_first_year)[keep0],
        "nem_sunset_year": h(table.nem_sunset_year)[keep0],
        "nem_kw_limit": h(table.nem_kw_limit)[keep0],
    }


def run_static_flags(table: AgentTable, tariffs: TariffBank, inputs: ScenarioInputs,
                     years: List[int]) -> tuple[bool, bool]:
    """(rate_switch, net_billing): whether any agent's DG rate differs
    from its base tariff, and whether net-billing bills can ever price
    (a referenced net-billing tariff, or a NEM gate that can close)."""
    tc = table_static_cache(table, tariffs)
    net_billing = tc["any_nb_tariff"] or not nem_gate_never_closes(
        tc["state_idx"], inputs.nem_cap_kw.cpu().numpy(), tc["nem_first_year"],
        tc["nem_sunset_year"], tc["nem_kw_limit"], years,
    )
    return tc["rate_switch"], net_billing


# ---------------------------------------------------------------------------
# Device memory model
# ---------------------------------------------------------------------------

#: [8760]-hour float32 tensors live per agent at the sizing peak: the
#: gathered streams (load, gen, sell, bucket ids, TOU map, wholesale),
#: the scaled gen shape and the dispatch traces
_LIVE_HOUR_ARRAYS = 14
#: the kept hourly net profiles and the state mix
_LIVE_HOUR_ARRAYS_HOURLY = 4
#: the original tariff's sell/bucket streams and the kW* selections
_LIVE_HOUR_ARRAYS_RATE_SWITCH = 5
#: [R, 12 * P] float32 tensors per agent: kernel output + bill temporaries
_LIVE_BUCKET_ARRAYS = 5
_LIVE_BUCKET_ARRAYS_RATE_SWITCH = 2
#: persistent per-agent bytes: table, carry, outputs
_PERSISTENT_ROW_BYTES = 60 * 4
#: share of the card's memory the model may plan for
_MEMORY_BUDGET_FRAC = 0.8


def per_agent_step_bytes(*, sizing_iters: int, econ_years: int, n_periods: int,
                         with_hourly: bool, rate_switch: bool) -> int:
    """Modeled peak device bytes per agent of one year step."""
    r = max(sizing_iters, 4) * econ_years
    hours = _LIVE_HOUR_ARRAYS
    buckets = _LIVE_BUCKET_ARRAYS
    if with_hourly:
        hours += _LIVE_HOUR_ARRAYS_HOURLY
    if rate_switch:
        hours += _LIVE_HOUR_ARRAYS_RATE_SWITCH
        buckets += _LIVE_BUCKET_ARRAYS_RATE_SWITCH
    return 4 * (hours * HOURS + buckets * r * 12 * n_periods) + _PERSISTENT_ROW_BYTES


# ---------------------------------------------------------------------------
# Host-side year loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResults:
    """Host-side stacked run outputs: numpy [n_years, ...] arrays keyed by
    YearOutputs field, plus the year list."""

    years: List[int]
    agent: Dict[str, np.ndarray]               # per-agent fields [Y, N, ...]
    state_hourly_net_mw: Optional[np.ndarray]  # [Y, n_states, 8760]

    def summary(self, mask: np.ndarray) -> Dict[str, np.ndarray]:
        """National per-year aggregates (the headline adoption curves)."""
        m = mask[None, :]
        return {
            "adopters": (self.agent["number_of_adopters"] * m).sum(axis=1),
            "system_kw_cum": (self.agent["system_kw_cum"] * m).sum(axis=1),
            "batt_kwh_cum": (self.agent["batt_kwh_cum"] * m).sum(axis=1),
            "new_adopters": (self.agent["new_adopters"] * m).sum(axis=1),
        }


class Simulation:
    """Scenario runner on one device.

    ``device`` (default ``"cuda"``) is where every container is placed
    and every year runs; with no card the constructor raises unless the
    caller asks for ``"cpu"``. On a card the modeled year-step memory
    must fit, or the constructor raises: this slice does not stream the
    agent axis in chunks.
    """

    def __init__(
        self,
        table: AgentTable,
        profiles: ProfileBank,
        tariffs: TariffBank,
        inputs: ScenarioInputs,
        scenario: ScenarioConfig,
        run_config: Optional[RunConfig] = None,
        with_hourly: bool = False,
        econ_years: int = 25,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.scenario = scenario
        self.run_config = run_config or RunConfig()
        self.with_hourly = with_hourly
        self.econ_years = econ_years
        self.years = list(scenario.model_years)
        if len(self.years) != inputs.n_years:
            raise ValueError(
                f"inputs cover {inputs.n_years} years but scenario has "
                f"{len(self.years)}"
            )
        self.table = to_device(table, self.device)
        self.profiles = to_device(profiles, self.device)
        self.tariffs = to_device(tariffs, self.device)
        self.inputs = to_device(inputs, self.device)
        self._rate_switch, self._net_billing = run_static_flags(
            self.table, self.tariffs, self.inputs, self.years)
        self._daylight = self._build_daylight(profiles)
        self.modeled_step_bytes = self._check_memory()
        self.host_agent_id = self.table.agent_id.cpu().numpy()
        self.host_mask = self.table.mask.cpu().numpy()

    def _build_daylight(self, profiles: ProfileBank):
        """The daylight layout of the generation bank when the run asks
        for compacted kernels, else None."""
        if not self.run_config.daylight_compact:
            return None
        lay = layout_ops.daylight_layout(profiles.solar_cf.cpu().numpy())
        if lay is None:
            logger.info("daylight_compact requested but the generation bank "
                        "has no compactable night hours; full-hour kernels")
        else:
            logger.info("daylight-compacted kernels: %d of %d hour lanes "
                        "(%.2fx fewer candidate lane-ops)", lay.n_lanes, HOURS,
                        HOURS / lay.n_lanes)
        return lay

    def _check_memory(self) -> int:
        """Modeled year-step bytes; raises when they exceed the card's
        budget."""
        per_agent = per_agent_step_bytes(
            sizing_iters=self.run_config.sizing_iters, econ_years=self.econ_years,
            n_periods=self.tariffs.max_periods, with_hourly=self.with_hourly,
            rate_switch=self._rate_switch,
        )
        modeled = per_agent * self.table.n_agents
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            if modeled > _MEMORY_BUDGET_FRAC * total:
                raise MemoryError(
                    f"{self.table.n_agents} agents model {modeled / 2**30:.1f} GiB "
                    f"per year step, over {_MEMORY_BUDGET_FRAC:.0%} of the "
                    f"card's {total / 2**30:.1f} GiB; the streaming agent-chunk "
                    "step is not ported yet"
                )
        return modeled

    def step_kwargs(self, first_year: bool) -> dict:
        """The :func:`year_step` arguments this run uses."""
        return dict(
            n_periods=self.tariffs.max_periods,
            econ_years=self.econ_years,
            sizing_iters=self.run_config.sizing_iters,
            first_year=first_year,
            with_hourly=self.with_hourly,
            storage_enabled=self.scenario.storage_enabled,
            year_step_len=float(self.scenario.year_step),
            rate_switch=self._rate_switch,
            net_billing=self._net_billing,
            sizing_impl="stream" if self.run_config.stream_segments else "auto",
            daylight=self._daylight,
            pack_once=self.run_config.pack_once,
        )

    def init_carry(self) -> SimCarry:
        return SimCarry.zeros(self.table.n_agents, self.device)

    def step(self, carry: SimCarry, year_idx: int,
             first_year: bool) -> tuple[SimCarry, YearOutputs]:
        return year_step(
            self.table, self.profiles, self.tariffs, self.inputs, carry,
            year_idx, **self.step_kwargs(first_year),
        )

    def _check_state_kw_bound(self, carry: SimCarry) -> None:
        """The static all-NEM proof holds only while every state's
        capacity stays under STATE_KW_BOUND; raise if it does not."""
        state_kw = np.zeros(self.table.n_states, np.float64)
        np.add.at(state_kw, self.table.state_idx.cpu().numpy(),
                  carry.market.system_kw_cum.cpu().numpy())
        if not np.all(state_kw < STATE_KW_BOUND):
            raise AssertionError(
                "state capacity exceeds STATE_KW_BOUND; the static all-NEM "
                "skip of the net-billing path is unsound for this run"
            )

    def run(self) -> SimResults:
        """Run every model year, collecting each year's outputs on the host."""
        agent_fields = [f.name for f in dataclasses.fields(YearOutputs)
                        if f.name != "state_hourly_net_mw"]
        collected: Dict[str, list] = {k: [] for k in agent_fields}
        hourly: List[np.ndarray] = []
        carry = self.init_carry()
        for yi in range(len(self.years)):
            carry, outs = self.step(carry, yi, first_year=(yi == 0))
            for k in agent_fields:
                collected[k].append(getattr(outs, k).cpu().numpy())
            if self.with_hourly:
                hourly.append(outs.state_hourly_net_mw.cpu().numpy())
        if not self._net_billing:
            self._check_state_kw_bound(carry)
        return SimResults(
            years=list(self.years),
            agent={k: np.stack(v) for k, v in collected.items()},
            state_hourly_net_mw=np.stack(hourly) if hourly else None,
        )
