"""The simulation runner: one model year as a sequence of tensor ops on
one device, and the year loop with its host consumers (exports,
checkpoints and resume, collection; port of
``dgen_tpu/models/simulation.py``).

Per year: trajectories are applied, the NEM gate is evaluated against
last year's state capacity, every agent is sized through the bill /
cashflow / dispatch hot loop, the max-market-share -> Bass-diffusion
market step runs with historical anchoring, integer battery adopters
are allocated, and the state-hourly net load is aggregated.

A population whose year step does not fit the card streams: the sizing
search runs over chunks of agent rows (``RunConfig.agent_chunk``, by
default derived from the card's memory by :func:`auto_agent_chunk`), so
no whole-table ``[N, 8760]`` tensor is formed; the market step runs once
over the whole table, and the state-hourly aggregate is rebuilt chunk by
chunk by the hourly remat pass.

A multi-rank run (``Simulation(ranks=)``, ``parallel``) is one process
per rank, each given the same whole table: the agents are partitioned
so that every state lives whole on one rank (``parallel.partition``, or
contiguous row blocks without ``RunConfig.partition_by_state``), padded
per rank to ``lcm(agent_pad_multiple, chunk)``, laid out cluster-major
within each rank's shard when clustered, and each rank keeps only its
shard's rows; its chunks stream within the shard. The year step's
reductions across rows take the run's ``reduce`` (``models.market``), so
every rank computes the group and state values one process computes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dgen_tpu_torch.config import RunConfig, ScenarioConfig, resolve_device
from dgen_tpu_torch.models import health as health_mod
from dgen_tpu_torch.models.agents import AgentTable, ProfileBank, pad_table, quantize_rows
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
from dgen_tpu_torch.ops import dispatch as dispatch_ops
from dgen_tpu_torch.ops import layout as layout_ops
from dgen_tpu_torch.ops import sizing as sizing_ops
from dgen_tpu_torch.ops.tariff import HOURS, NET_BILLING, TariffBank
from dgen_tpu_torch.resilience.faults import corrupt_point, corrupt_rows, fault_point
from dgen_tpu_torch.resilience.quarantine import (
    QuarantineReport,
    apply_quarantine,
    validate_population,
)
from dgen_tpu_torch.tree import leaf_paths, to_device, tree_map
from dgen_tpu_torch.utils import invariants, timing

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

def gather_hour_streams(profiles: ProfileBank, load_idx: torch.Tensor,
                        cf_idx: torch.Tensor, load_kwh_per_customer: torch.Tensor):
    """(load, gen_per_kw, load_scale, gen_scale): the agents' load in kWh
    and generation per kW gathered from the banks, at the bank's dtype;
    under int8 banks the codes, with the load multiplier folded into the
    gathered load scale so the hour streams stay one byte per hour (the
    scales are None otherwise)."""
    load_idx, cf_idx = load_idx.long(), cf_idx.long()
    gen_per_kw = profiles.solar_cf[cf_idx]
    if profiles.load_scale is not None:
        return (profiles.load[load_idx],
                gen_per_kw,
                profiles.load_scale[load_idx] * load_kwh_per_customer,
                profiles.solar_cf_scale[cf_idx])
    # the multiplier is cast to the bank dtype before the product, so
    # bf16 banks stay bf16 through the gathered streams
    load = profiles.load[load_idx] \
        * load_kwh_per_customer[:, None].to(profiles.load.dtype)
    return load, gen_per_kw, None, None


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

    load, gen_per_kw, load_scale, gen_scale = gather_hour_streams(
        profiles, table.load_idx, table.cf_idx, ya.load_kwh_per_customer)
    # net-billing sell rate = this year's wholesale price x retail multiplier
    ts_sell = (profiles.wholesale[table.region_idx.long()]
               * (mult * ya.wholesale_multiplier)[:, None].to(profiles.wholesale.dtype))

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
        load_scale=load_scale,
        gen_scale=gen_scale,
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
    **static,
) -> tuple[SimCarry, YearOutputs]:
    """One model year: trajectory application -> NEM gate -> sizing ->
    max market share -> (initial shares | diffusion) -> anchoring ->
    battery allocation -> state-hourly aggregate -> carry.

    The keywords are :func:`scenario_years`'. ``sizing_impl``
    (``"auto"``, ``"stream"`` or ``"dot"``), ``daylight`` and
    ``pack_once`` go to :func:`sizing_ops.size_agents`. ``agent_chunk`` >
    0 with a table of more rows streams: sizing runs chunk by chunk of
    that many rows (the table must divide into them, :func:`_n_chunks`)
    with every static choice of the run passed to each chunk alike, and
    the state-hourly aggregate is rebuilt by the hourly remat pass
    (:func:`_state_hourly_remat`), so no whole-table ``[N, 8760]`` tensor
    is formed; the market step runs once over the whole table either way.

    ``cluster``: an ``ops.tariffcluster.ClusterLayout`` of the table (laid
    out cluster-major): sizing runs once per tariff cluster, at the
    cluster's period count and net-billing flag, against its compact bank
    in ``cluster_banks``, indexed by ``cluster_tidx`` ([N] local rows)
    (:func:`_size_clustered`); a rate-switch call is refused.

    ``soft_tau``: the differentiable twin (``RunConfig.soft_boundaries``,
    :mod:`dgen_tpu_torch.grad`): soft import/export splits and tier clips
    in sizing, an unrounded payback, and linear interpolation through the
    max-market-share table, so the year is differentiable in the scenario
    inputs; None is the hard path. ``anchor=False`` drops the historical
    anchoring blend (the calibration rollout fits the unanchored model)."""
    (carry,), (outputs,) = scenario_years(table, profiles, tariffs, [inputs], [carry],
                                          year_idx, **static)
    return carry, outputs


def scenario_years(
    table: AgentTable,
    profiles: ProfileBank,
    tariffs: TariffBank,
    inputs_list: List[ScenarioInputs],
    carries: List[SimCarry],
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
    agent_chunk: int = 0,
    cluster=None,
    cluster_banks=None,
    cluster_tidx: Optional[torch.Tensor] = None,
    soft_tau: Optional[float] = None,
    anchor: bool = True,
    reduce=None,
) -> tuple[List[SimCarry], List[YearOutputs]]:
    """One model year of S scenarios over one table (:func:`year_step`
    is S = 1): each scenario's carry and outputs.

    Every step that reduces across rows runs per scenario on its own
    ``[N]`` rows (the NEM gate's state sums, the market step, the
    battery allocation, the state-hourly aggregate), so no reduction
    mixes scenarios. The per-row work runs once for all S: each chunk's
    sizing, and each chunk's hourly remat pass, sees the S scenarios'
    rows of that chunk side by side (S x chunk rows a kernel launch).
    A row's result does not depend on how many rows share its launch, so
    each scenario's outputs equal its own S = 1 year step's.

    ``reduce``: a multi-rank run's ``parallel.mesh.CrossRank``; ``table``
    is then this rank's shard, and every reduction across rows (the NEM
    gate's state sums, the market step's group sums, the state-hourly
    aggregate) covers every rank's rows (``models.market.segment_sum``).
    The per-row work, chunks included, stays within the shard. None (one
    rank) runs no collective."""
    if cluster is not None and rate_switch:
        raise ValueError(
            "cluster layouts cannot price rate-switch runs: a "
            "base/switch tariff pair can straddle two clusters"
        )
    n_states = table.n_states
    yas, nems = [], []
    for inputs, carry in zip(inputs_list, carries, strict=True):
        yas.append(apply_year(table, inputs, year_idx))
        # NEM gate on last year's state capacity; in the first year that
        # is the starting installed capacity, not the zeroed carry
        if first_year:
            state_kw_last = starting_state_kw(table, inputs)
        else:
            state_kw_last = segment_sum(carry.market.system_kw_cum, table.state_idx,
                                        n_states, reduce)
        nems.append(compute_nem_allowed(table, inputs, year_idx, state_kw_last))

    n_chunks = _n_chunks(table.n_agents, agent_chunk)
    sizing = dict(n_periods=n_periods, n_years=econ_years, n_iters=sizing_iters,
                  net_billing=net_billing, impl=sizing_impl, daylight=daylight,
                  pack_once=pack_once, soft_tau=soft_tau)
    if cluster is not None:
        # hourly profiles are kept only when the whole table is one
        # chunk; otherwise the remat pass below rebuilds the aggregate
        ress = _size_clustered(table, profiles, yas, nems, cluster, cluster_banks,
                               cluster_tidx, agent_chunk, sizing,
                               keep_hourly=with_hourly and n_chunks == 1)
    elif n_chunks > 1:
        ress = _size_chunked(table, profiles, tariffs, yas, nems, n_chunks,
                             rate_switch, sizing)
    else:
        ress = _size_rows(table, profiles, tariffs, yas, nems, rate_switch,
                          dict(sizing, keep_hourly=with_hourly))

    markets = [
        _market_year(table, inputs, carry, ya, res, year_idx, first_year=first_year,
                     storage_enabled=storage_enabled, year_step_len=year_step_len,
                     interp=soft_tau is not None, anchor=anchor, reduce=reduce)
        for inputs, carry, ya, res in zip(inputs_list, carries, yas, ress)
    ]

    # --- state-hourly aggregate: baseline / PV-only / PV+batt profiles
    # mixed by adopter counts ---
    if with_hourly:
        counts = [m["counts"] for m in markets]
        if n_chunks > 1:
            hourly = _state_hourly_remat(table, profiles, yas, ress, counts, n_chunks)
        else:
            hourly = [
                segment_sum(_mix_hourly(
                    (res.baseline_net_hourly, res.adopter_net_hourly_pvonly,
                     res.adopter_net_hourly_with_batt), cnt, table.mask),
                    table.state_idx, n_states)
                for res, cnt in zip(ress, counts)
            ]
        if reduce is not None:
            # each rank's states' partial sums; the other ranks add zeros
            # where states are whole on one rank
            hourly = [reduce.combine(h) for h in hourly]
        hourly = [h / 1000.0 for h in hourly]  # kW -> MW
    else:
        hourly = [torch.zeros((0, 0), dtype=torch.float32, device=table.mask.device)
                  for _ in inputs_list]

    out_carries, outputs = [], []
    for inputs, res, m, sh in zip(inputs_list, ress, markets, hourly):
        carbon_t = inputs.carbon_intensity_t_per_kwh[year_idx][table.state_idx.long()]
        new_market, batt_adopters_cum = m["market"], m["batt_adopters_cum"]
        out_carries.append(SimCarry(market=new_market, batt_adopters_cum=batt_adopters_cum))
        outputs.append(YearOutputs(
            system_kw=res.system_kw,
            npv=res.npv,
            payback_period=res.payback_period,
            cash_flow=res.cash_flow,
            energy_value_pv_only=res.energy_value_pv_only,
            first_year_bill_with_system=res.first_year_bill_with_system,
            first_year_bill_without_system=res.first_year_bill_without_system,
            batt_kw=res.batt_kw,
            batt_kwh=res.batt_kwh,
            max_market_share=new_market.max_market_share,
            market_share=new_market.market_share,
            new_adopters=m["new_adopters"],
            number_of_adopters=new_market.adopters_cum,
            new_system_kw=m["new_kw"],
            system_kw_cum=new_market.system_kw_cum,
            market_value=new_market.market_value,
            new_batt_adopters=m["new_batt"],
            batt_adopters_cum=batt_adopters_cum,
            batt_kw_cum=new_market.batt_kw_cum,
            batt_kwh_cum=new_market.batt_kwh_cum,
            carbon_intensity_t_per_kwh=carbon_t,
            avoided_co2_t=new_market.system_kw_cum * res.naep * carbon_t,
            state_hourly_net_mw=sh,
        ))
    return out_carries, outputs


def _market_year(table, inputs, carry, ya, res, year_idx: int, *, first_year: bool,
                 storage_enabled: bool, year_step_len: float, interp: bool = False,
                 anchor: bool = True, reduce=None) -> dict:
    """One scenario's market step on its own rows: max market share
    (interpolated under ``interp``) -> (initial shares | diffusion) ->
    anchoring (unless ``anchor`` is False) -> battery allocation; the new
    market state, the year's flows, and the adopter counts the
    state-hourly mix weighs the profiles by. ``reduce``: the group sums
    over every rank's rows."""
    n_groups = table.n_groups
    g = table.group_idx.long()
    mms = max_market_share(res.payback_period, table.sector_idx,
                           inputs.mms_table, interp=interp) * table.mask
    if first_year:
        mstate = initial_market_shares(
            inputs.starting_kw, inputs.starting_batt_kw, inputs.starting_batt_kwh,
            g, ya.developable_agent_weight, res.system_kw, n_groups, reduce,
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
    if anchor:
        am = inputs.anchor_years_mask[year_idx]
        kw_anch, adopt_anch, share_anch = anchor_to_observed(
            out.system_kw_cum, g, inputs.observed_kw[year_idx],
            table.sector_idx == 0, ya.developable_agent_weight, n_groups, reduce,
        )
        kw_cum = am * kw_anch + (1.0 - am) * out.system_kw_cum
        adopters = am * adopt_anch + (1.0 - am) * out.number_of_adopters
        share = am * share_anch + (1.0 - am) * out.market_share
    else:
        kw_cum = out.system_kw_cum
        adopters = out.number_of_adopters
        share = out.market_share
    new_adopters = torch.clamp_min(adopters - mstate.adopters_cum, 0.0)
    new_kw = torch.clamp_min(kw_cum - mstate.system_kw_cum, 0.0)

    # --- integer battery-adopter allocation ---
    if storage_enabled:
        new_batt = allocate_battery_adopters(
            new_adopters, g, inputs.attachment_rate, table.agent_id, n_groups, reduce,
        ) * table.mask
    else:
        new_batt = torch.zeros_like(new_adopters)
    batt_adopters_cum = batt_adopters_prev + new_batt
    batt_kw_cum = mstate.batt_kw_cum + new_batt * res.batt_kw
    batt_kwh_cum = mstate.batt_kwh_cum + new_batt * res.batt_kwh

    # cap the battery-profile weight at the agent's adopter count so
    # households are not counted twice
    batt_mix = torch.minimum(batt_adopters_cum, adopters)
    pv_only = torch.clamp_min(adopters - batt_mix, 0.0)
    base_cnt = torch.clamp_min(ya.customers_in_bin - adopters, 0.0)

    market = MarketState(
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
    return dict(market=market, batt_adopters_cum=batt_adopters_cum,
                new_adopters=new_adopters, new_kw=new_kw, new_batt=new_batt,
                counts=(base_cnt, pv_only, batt_mix))


def _n_chunks(n: int, chunk: int) -> int:
    """Chunks of the streaming year step (1 = the whole-table path)."""
    if not chunk or n <= chunk:
        return 1
    if n % chunk:
        raise ValueError(
            f"agent count {n} is not a multiple of agent_chunk {chunk}; pad the "
            "table (models.agents.pad_table)"
        )
    return n // chunk


def _chunk_slices(n: int, n_chunks: int):
    c = n // n_chunks
    return [slice(k * c, (k + 1) * c) for k in range(n_chunks)]


def _rows(tree, rows: slice):
    """Every tensor leaf of ``tree`` cut to the agent rows ``rows`` (views)."""
    return tree_map(lambda t: t[rows], tree)


def _side_by_side(trees: list):
    """The S row sets of ``trees`` (same structure, ``[C, ...]`` leaves)
    as one tree of ``[S * C, ...]`` leaves, scenario-major; one tree is
    returned as it is."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *ts: torch.cat(ts), *trees)


def _split_rows(tree, s: int) -> list:
    """The inverse of :func:`_side_by_side`: S trees of row views."""
    if s == 1:
        return [tree]
    n = None
    for t in leaf_paths(tree).values():
        n = t.shape[0] // s
        break
    return [_rows(tree, slice(k * n, (k + 1) * n)) for k in range(s)]


def _size_rows(table, profiles, tariffs, yas, nems, rate_switch: bool,
               sizing: dict) -> list:
    """:func:`sizing_ops.size_agents` of the rows of ``table`` for each
    scenario's year inputs ``yas`` and NEM gates ``nems``, all scenarios'
    rows in one call; the gathered economics environment lives only
    inside this call."""
    s = len(yas)
    tbl = _side_by_side([table] * s)
    envs = build_econ_inputs(tbl, profiles, tariffs, _side_by_side(yas),
                             _side_by_side(nems), tbl.incentives,
                             rate_switch=rate_switch)
    return _split_rows(sizing_ops.size_agents(envs, **sizing), s)


def _size_chunked(table, profiles, tariffs, yas, nems, n_chunks: int,
                  rate_switch: bool, sizing: dict) -> list:
    """Sizing of the whole table, chunk by chunk of rows (each chunk for
    every scenario at once): each chunk's per-agent results are written
    into whole-table tensors, one set a scenario; its hourly profiles are
    not kept (the remat pass rebuilds what the aggregate needs)."""
    outs = [None] * len(yas)
    for rows in _chunk_slices(table.n_agents, n_chunks):
        ress = _size_rows(_rows(table, rows), profiles, tariffs,
                          [_rows(ya, rows) for ya in yas], [n[rows] for n in nems],
                          rate_switch, dict(sizing, keep_hourly=False))
        outs = [_write_rows(o, r, rows, table.n_agents) for o, r in zip(outs, ress)]
    return outs


def _write_rows(out, res, rows: slice, n: int):
    """``res`` written into the whole-table results ``out`` at ``rows``
    (``out`` allocated at ``n`` rows from ``res``'s leaves when None)."""
    if out is None:
        out = tree_map(lambda t: t.new_empty((n,) + t.shape[1:]), res)
    tree_map(lambda o, t: o[rows].copy_(t), out, res)
    return out


def _size_clustered(table, profiles, yas, nems, cluster, cluster_banks,
                    cluster_tidx, agent_chunk: int, sizing: dict,
                    keep_hourly: bool) -> list:
    """Sizing one tariff cluster at a time (port of the JAX package's
    ``_size_clustered`` on one device): each cluster's segment of the
    cluster-major table is sized against its compact bank at the
    cluster's ``n_periods``, with the run's ``net_billing`` and the
    cluster's flag both required for the bucket-sums path, whole or in
    chunks of ``agent_chunk`` rows (:func:`_n_chunks` of the segment;
    a chunked segment keeps no hourly profiles), every scenario's rows at
    once. The results land in table order, one set a scenario."""
    outs = [None] * len(yas)
    for spec, bank in zip(cluster.clusters, cluster_banks):
        rows = slice(spec.offset, spec.offset + spec.seg_len)
        tidx = cluster_tidx[rows]
        tbl = dataclasses.replace(_rows(table, rows), tariff_idx=tidx,
                                  tariff_switch_idx=tidx)
        sz = dict(sizing, n_periods=spec.n_periods,
                  net_billing=sizing["net_billing"] and spec.net_billing)
        seg_yas = [_rows(ya, rows) for ya in yas]
        seg_nems = [n[rows] for n in nems]
        n_c = _n_chunks(spec.seg_len, agent_chunk)
        if n_c > 1:
            ress = _size_chunked(tbl, profiles, bank, seg_yas, seg_nems, n_c, False, sz)
        else:
            ress = _size_rows(tbl, profiles, bank, seg_yas, seg_nems, False,
                              dict(sz, keep_hourly=keep_hourly))
        outs = [_write_rows(o, r, rows, table.n_agents) for o, r in zip(outs, ress)]
    return outs


def _mix_hourly(profiles_nh: tuple, counts: tuple, mask: torch.Tensor) -> torch.Tensor:
    """[N, H] net load of the rows: the baseline, PV-only and PV+battery
    profiles mixed by the agents' customer, PV-only and battery counts."""
    (base_p, pv_p, batt_p), (base_cnt, pv_only, batt_mix) = profiles_nh, counts
    return (base_cnt[:, None] * base_p + pv_only[:, None] * pv_p
            + batt_mix[:, None] * batt_p) * mask[:, None]


def _state_hourly_remat(table, profiles, yas, ress, counts, n_chunks: int) -> list:
    """[n_states, H] kW a scenario: the state-hourly aggregate rebuilt
    chunk by chunk (sizing kept no hourly profiles), each chunk's rows of
    every scenario formed at once, each scenario summed into its own
    float32 accumulator."""
    s = len(yas)
    accs = [torch.zeros((table.n_states, profiles.hours), dtype=torch.float32,
                        device=table.mask.device) for _ in range(s)]
    for rows in _chunk_slices(table.n_agents, n_chunks):
        tbl = _rows(table, rows)
        net = _hourly_rows(
            _side_by_side([tbl] * s), profiles, _side_by_side([_rows(ya, rows) for ya in yas]),
            _side_by_side([_rows(r, rows) for r in ress]),
            tuple(_side_by_side([c[rows] for c in cs]) for cs in zip(*counts)))
        idx = tbl.state_idx.long()
        for acc, part in zip(accs, _split_rows(net, s)):
            acc.index_add_(0, idx, part)
    return accs


def _hourly_rows(table, profiles, ya, res, counts: tuple) -> torch.Tensor:
    """[C, H] net load of a chunk's rows, as the whole-table path forms
    it: the streams gathered from the banks (int8 codes dequantized
    through their row scales), priced at float32 as sizing prices them,
    the battery dispatched again at the sized battery (one more dispatch
    launch a chunk), and the net profiles mixed by the counts."""
    load, gen_per_kw, load_scale, gen_scale = gather_hour_streams(
        profiles, table.load_idx, table.cf_idx, ya.load_kwh_per_customer)
    _, gen_f32, load_f32 = sizing_ops.float32_streams(
        load, gen_per_kw, load_scale, gen_scale)
    gen = gen_f32 * res.system_kw[:, None]
    dr = dispatch_ops.dispatch_battery(load_f32, gen, res.batt_kw, res.batt_kwh,
                                       ya.batt_rt_eff)
    return _mix_hourly(sizing_ops.net_hourly_profiles(load_f32, gen, dr.system_out),
                       counts, table.mask)


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
                     years: List[int], table_cache: Optional[dict] = None
                     ) -> tuple[bool, bool]:
    """(rate_switch, net_billing): whether any agent's DG rate differs
    from its base tariff, and whether net-billing bills can ever price
    (a referenced net-billing tariff, or a NEM gate that can close).
    ``table_cache``: :func:`table_static_cache` of the table, computed
    once for many scenarios (a sweep's planner)."""
    tc = table_cache if table_cache is not None else table_static_cache(table, tariffs)
    net_billing = tc["any_nb_tariff"] or not nem_gate_never_closes(
        tc["state_idx"], inputs.nem_cap_kw.cpu().numpy(), tc["nem_first_year"],
        tc["nem_sunset_year"], tc["nem_kw_limit"], years,
    )
    return tc["rate_switch"], net_billing


# ---------------------------------------------------------------------------
# Device memory model
# ---------------------------------------------------------------------------

#: [8760]-hour tensors live per agent at the sizing peak: the gathered
#: streams (load, gen, sell, bucket ids, TOU map, wholesale), the scaled
#: gen shape and the dispatch traces
_LIVE_HOUR_ARRAYS = 14
#: ... of which are bank streams, stored at the bank's width: load, gen
#: per kW, wholesale, sell and the gen shape (the rest are int32 ids and
#: float32 dispatch traces)
_LIVE_BANK_ARRAYS = 5
#: under bf16 or int8 banks, the float32 load and gen copies that the
#: dispatch loop, the linear sums and the hourly profiles read
_LIVE_FLOOR_COPIES = 2
#: the kept hourly net profiles and the state mix
_LIVE_HOUR_ARRAYS_HOURLY = 4
#: the original tariff's sell/bucket streams and the kW* selections
_LIVE_HOUR_ARRAYS_RATE_SWITCH = 5
#: ... of which are sell streams, at the bank's float width
_LIVE_BANK_ARRAYS_RATE_SWITCH = 2
#: [R, 12 * P] tensors per agent: kernel output + bill temporaries
_LIVE_BUCKET_ARRAYS = 5
_LIVE_BUCKET_ARRAYS_RATE_SWITCH = 2
#: persistent per-agent bytes: table, carry, outputs
_PERSISTENT_ROW_BYTES = 60 * 4
#: share of the card's memory the model may plan for
_MEMORY_BUDGET_FRAC = 0.8
#: the smallest streaming chunk the year step runs at
_CHUNK_FLOOR_ROWS = 128
#: a measured peak past this multiple of the modeled step is logged as a
#: miss of the footprint model
_PEAK_OVER_MODEL_WARN = 3.0


def per_agent_step_bytes(*, sizing_iters: int, econ_years: int, n_periods: int,
                         with_hourly: bool, rate_switch: bool,
                         bank_bf16: bool = False, bank_quant: bool = False) -> int:
    """Modeled peak device bytes per agent row of one year step (one
    chunk's row on the streaming path), beside the whole table's
    persistent :data:`_PERSISTENT_ROW_BYTES` a row
    (:func:`modeled_step_bytes`).

    ``bank_bf16``: the bank streams at 2 bytes, two float32 floor copies
    (load and gen for the dispatch loop, linear sums, hourly profiles),
    and the kernel's candidate sums stored at 2 bytes beside the float32
    copy the bills upcast them to. ``bank_quant``: load and gen codes at
    1 byte (the gen shape is the codes themselves), the sell streams at
    the bank's float width, the two dequantized float32 copies, and
    float32 sums unless the sell stream is bf16 too."""
    r = max(sizing_iters, 4) * econ_years
    float_b = 2 if bank_bf16 else 4
    bank = _LIVE_BANK_ARRAYS
    floor = _LIVE_HOUR_ARRAYS - bank
    if bank_quant:
        # load and gen codes; wholesale and sell; no separate gen shape
        bank_bytes = 1 * 2 + float_b * 2
    else:
        bank_bytes = float_b * bank
    if bank_quant or bank_bf16:
        floor += _LIVE_FLOOR_COPIES
    hour_bytes = 4 * floor + bank_bytes
    buckets = _LIVE_BUCKET_ARRAYS
    if with_hourly:
        hour_bytes += 4 * _LIVE_HOUR_ARRAYS_HOURLY
    if rate_switch:
        hour_bytes += (4 * (_LIVE_HOUR_ARRAYS_RATE_SWITCH
                            - _LIVE_BANK_ARRAYS_RATE_SWITCH)
                       + float_b * _LIVE_BANK_ARRAYS_RATE_SWITCH)
        buckets += _LIVE_BUCKET_ARRAYS_RATE_SWITCH
    # the kernel's output stored at 2 bytes, plus the float32 copy the
    # bills take of it, where the sums are bf16 (billkernels._sums_out_dtype)
    bucket_bytes = 4 * buckets + (2 if bank_bf16 else 0)
    return hour_bytes * HOURS + bucket_bytes * r * 12 * n_periods


def modeled_step_bytes(per_agent: int, rows: int, n_agents: int) -> int:
    """Modeled peak device bytes of a year step that sizes ``rows`` agent
    rows at a time over a table of ``n_agents`` rows."""
    return per_agent * rows + _PERSISTENT_ROW_BYTES * n_agents


def card_memory_bytes(device: torch.device) -> Optional[int]:
    """The card's memory in bytes, or None off a card (no budget: the
    CPU never streams by default)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def rank_memory_bytes(device: torch.device, ranks=None) -> Optional[int]:
    """This rank's share of its card's memory: :func:`card_memory_bytes`
    divided by the ranks that share the card (``RankTopology.
    ranks_per_card``; the whole card for one process or a rank with a
    card of its own), None off a card."""
    total = card_memory_bytes(device)
    if total is None or ranks is None:
        return total
    return total // ranks.ranks_per_card


def auto_agent_chunk(n_agents: int, *, memory_bytes: Optional[int],
                     **footprint) -> int:
    """The streaming chunk from the memory budget: 0 (whole table) when
    the table fits :data:`_MEMORY_BUDGET_FRAC` of ``memory_bytes``, else
    the largest multiple of :data:`_CHUNK_FLOOR_ROWS` rows that fits
    beside the whole table's persistent rows, and never fewer than that
    floor. ``footprint``: the keywords of :func:`per_agent_step_bytes`.
    No budget (``memory_bytes`` None, as off a card) gives 0."""
    if not memory_bytes or n_agents <= 0:
        return 0
    per_agent = per_agent_step_bytes(**footprint)
    budget = int(memory_bytes * _MEMORY_BUDGET_FRAC) - n_agents * _PERSISTENT_ROW_BYTES
    fit = budget // per_agent
    if n_agents <= fit:
        return 0
    return max(_CHUNK_FLOOR_ROWS, int(fit // _CHUNK_FLOOR_ROWS) * _CHUNK_FLOOR_ROWS)


# ---------------------------------------------------------------------------
# Host-side year loop
# ---------------------------------------------------------------------------

def _corrupt_bank_rows(profiles: ProfileBank) -> ProfileBank:
    """The ``bank_corrupt_row`` fault payload (kind ``corrupt``): one
    deterministic load-bank row set to NaN, or under int8 banks that
    row's float32 scale (a code cannot hold a NaN), on the bank's device.
    Models a bad bank file at load (hit #1, Simulation construction: the
    validator's case) and silent corruption mid-run (later hits, before a
    year step: the health sentinel's case)."""
    row = int(corrupt_rows()[0]) % int(profiles.load.shape[0])
    if profiles.load_scale is not None:
        sc = profiles.load_scale.clone()
        sc[row] = float("nan")
        return dataclasses.replace(profiles, load_scale=sc)
    load = profiles.load.clone()
    load[row] = float("nan")
    return dataclasses.replace(profiles, load=load)


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
    """Scenario runner on one device, or on one rank's shard of a
    multi-rank run (``ranks``, a ``parallel.mesh.RankTopology`` of more
    than one rank: the device is the rank's, the table passed in is the
    whole one, and ``host_agent_id``, ``host_mask``, ``host_row_origin``
    and the results cover this rank's rows; a checkpoint is one part a
    rank, restorable onto another world size by agent id).

    ``device`` (default ``"cuda"``) is where every container is placed
    and every year runs; with no card the constructor raises unless the
    caller asks for ``"cpu"``. ``RunConfig.agent_chunk`` picks the
    streaming chunk (``None``: from the card's memory, whole table on the
    CPU); a chunked table is padded with mask-0 rows to a multiple of
    ``lcm(agent_pad_multiple, chunk)``, and results cover the padded
    rows. The constructor raises ``MemoryError`` when not even a
    128-row chunk fits the card.

    The inputs are validated on their device first
    (``RunConfig.validate_enabled``, on by default:
    ``resilience.quarantine``), and the malformed rows, the ids of
    ``RunConfig.quarantine_ids`` and those of an explicit ``quarantine``
    report are contained as inert padding; the merged report is
    ``self.quarantine_report``. Clean inputs pass through untouched.
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
        quarantine=None,
        ranks=None,
    ) -> None:
        #: the run's ``parallel.mesh.RankTopology`` when it has more than
        #: one rank (each holds one shard of the table), else None
        self.ranks = ranks if ranks is not None and ranks.distributed else None
        self.device = resolve_device(self.ranks.device if self.ranks else device)
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
        # fault site (kind ``corrupt``): a profile-bank row going bad at
        # load; hit #1 lands here, before validation, which must catch
        # it; later hits fire in step (mid-run corruption, the sentinel's)
        if corrupt_point("bank_corrupt_row"):
            self.profiles = _corrupt_bank_rows(self.profiles)
        # bad-data quarantine before anything reads the inputs: the static
        # flags index metering[tariff_idx], and the daylight layout and
        # the int8 quantization assume finite banks
        self.quarantine_report = None
        #: seconds of the validation and containment (its count fetch
        #: waits for the card)
        self.validation_s = 0.0
        rc = self.run_config
        if rc.validate_enabled or rc.quarantine_ids or quarantine is not None:
            t0 = time.perf_counter()
            rep = (validate_population(self.table, self.profiles, self.tariffs)
                   if rc.validate_enabled else
                   QuarantineReport(n_agents=int((self.table.mask > 0).sum())))
            if quarantine is not None:
                rep.merge(quarantine)
            if rc.quarantine_ids:
                rep.add_ids(rc.quarantine_ids, "config:quarantine_ids")
            if not rep.is_clean:
                self.table, self.profiles = apply_quarantine(
                    self.table, self.profiles, rep)
            self.quarantine_report = rep
            self.validation_s = time.perf_counter() - t0
        self._rate_switch, self._net_billing = run_static_flags(
            self.table, self.tariffs, self.inputs, self.years)
        # the daylight layout comes from the float32 bank, before the banks
        # are narrowed
        self._daylight = self._build_daylight(self.profiles)
        self.profiles = self._narrow_banks(self.profiles)
        self._per_agent_bytes = per_agent_step_bytes(**self._footprint())
        chunk = self._resolve_chunk()
        #: [n_agents] row -> row of the input table (-1: a padding row this
        #: constructor added), composed through the state partition, the
        #: chunk padding and the cluster layout; side vectors in input-table
        #: order (an ensemble's cohort entry years) are aligned through it.
        #: On a multi-rank run, the rows of this rank's shard.
        self.host_row_origin = np.arange(self.table.n_agents, dtype=np.int64)
        #: the state partition of a multi-rank run (``parallel.partition``)
        self.partition = None
        world = self.ranks.world_size if self.ranks else 1
        if rc.n_devices is not None and rc.n_devices != world:
            raise ValueError(f"RunConfig.n_devices={rc.n_devices} (DGEN_TPU_DEVICES), but "
                             f"the run has {world} rank(s) (parallel.launch)")
        if self.ranks and rc.partition_by_state:
            from dgen_tpu_torch.parallel.mesh import mesh_shape_of
            from dgen_tpu_torch.parallel.partition import partition_table

            # every state whole on one rank; the shard length divides into
            # chunks
            self.table, self.partition = partition_table(
                self.table, world, math.lcm(rc.agent_pad_multiple, chunk or 1),
                mesh_shape=mesh_shape_of(self.ranks))
            self.host_row_origin = np.asarray(self.partition.gather_rows)
            logger.info("partitioned %d agents into %d state-local shards of %d "
                        "(mesh %dx%d)", int(self.partition.shard_sizes.sum()), world,
                        self.partition.shard_len, *self.ranks.shape)
        elif chunk or self.ranks:
            # lane alignment and chunk divisibility together, in every shard
            self.table = pad_table(
                self.table, math.lcm(rc.agent_pad_multiple, chunk or 1) * world)
            self.host_row_origin = np.concatenate([
                self.host_row_origin,
                np.full(self.table.n_agents - len(self.host_row_origin), -1, np.int64)])
        # the tariff-clustered layout, after the partition or the chunk
        # padding and before the host copies of the row order are taken
        self._cluster_layout = None
        self._cluster_banks = None
        self._cluster_tidx = None
        self._cluster_host = None
        #: masked filler rows the cluster layout added to pad its segments
        self.cluster_filler_rows = 0
        if rc.cluster_tariffs and self._rate_switch:
            logger.info(
                "cluster_tariffs requested but rate switching is live "
                "(base/switch pairs can straddle clusters); running the "
                "unclustered program")
        elif rc.cluster_tariffs:
            self._lay_out_clusters(chunk, world)
        if self.ranks:
            self._keep_shard()
        # stream only when the (shard's) table is larger than one chunk
        self._agent_chunk = chunk if chunk and self.table.n_agents > chunk else 0
        self.host_agent_id = self.table.agent_id.cpu().numpy()
        self.host_mask = self.table.mask.cpu().numpy()
        #: how the year step's reductions reach the other ranks' rows
        self._reduce = None
        if self.ranks:
            from dgen_tpu_torch.parallel.mesh import CrossRank

            self._reduce = CrossRank(self.ranks, whole_groups=rc.partition_by_state)
        self.modeled_step_bytes = self._check_memory()
        self.memory_check: Optional[dict] = None
        self.health_report: Optional[dict] = None
        #: label of this run's phase timers (``utils.timing``; a sweep's
        #: scenario siblings set theirs, :meth:`with_inputs`)
        self.timing_ctx: Optional[str] = None
        #: an ``io.hostio.HostIOPool`` the run's pipeline shares (a sweep
        #: lends one to every scenario); None: the pipeline owns its own
        self._hostio_pool = None

    def _lay_out_clusters(self, chunk: int, n_dev: int = 1) -> None:
        """Reorder the table cluster-major (``ops.tariffcluster``): the
        corpus split into structural clusters, each cluster's real rows
        of each of the ``n_dev`` rank shards in one segment padded to a
        rank-uniform multiple of ``lcm(agent_pad_multiple, chunk)`` with
        masked filler rows. Every ``[n_agents, ...]`` table leaf is
        gathered on the device and the mask multiplied by the layout's
        valid rows; the compact banks, the rows' compact tariff indices
        and the host columns of the per-cluster NEM proof (every rank's
        rows, so every rank proves the same flags) are kept."""
        from dgen_tpu_torch.ops import tariffcluster

        pad_mult = math.lcm(self.run_config.agent_pad_multiple, chunk or 1)
        plan = tariffcluster.analyze_bank(self.tariffs)
        layout, gather, valid, ctidx = tariffcluster.plan_layout(
            plan, self.table.tariff_idx.cpu().numpy(),
            self.table.mask.cpu().numpy(), n_dev, pad_mult)
        n_old = self.table.n_agents
        idx = torch.from_numpy(gather).to(self.device)

        def _gather(x):
            return x[idx] if x.ndim >= 1 and x.shape[0] == n_old else x

        table = tree_map(_gather, self.table)
        self.table = dataclasses.replace(
            table, mask=table.mask * torch.from_numpy(valid).to(self.device))
        self.host_row_origin = np.where(valid > 0, self.host_row_origin[gather], -1)
        h = lambda t: t.cpu().numpy()
        self._cluster_host = dict(
            cid=layout.cluster_of_rows(),
            real=h(self.table.mask) > 0,
            state_idx=h(self.table.state_idx),
            nem_first_year=h(self.table.nem_first_year),
            nem_sunset_year=h(self.table.nem_sunset_year),
            nem_kw_limit=h(self.table.nem_kw_limit),
        )
        self._cluster_banks = tariffcluster.banks_for_layout(plan, layout)
        self._cluster_tidx = torch.from_numpy(ctidx).to(self.device)
        self._cluster_layout = layout
        self._cluster_layout = layout.with_flags(self._cluster_flags(self.inputs))
        self.cluster_filler_rows = int(len(valid) - int(valid.sum()))
        logger.info(
            "tariff clusters: %d signatures over %d tariffs, segments %s "
            "rows/device (was %d rows/device global-pad), %d filler rows",
            layout.n_clusters, self.tariffs.n_tariffs,
            [c.seg_len for c in self._cluster_layout.clusters], n_old // n_dev,
            self.cluster_filler_rows)

    def _keep_shard(self) -> None:
        """Keep this rank's block of the laid-out table (rank-major: the
        partition, the padding and the cluster layout all keep each
        rank's rows contiguous): every ``[n_agents, ...]`` table leaf, the
        row origins, and a cluster layout's compact tariff indices, the
        layout itself becoming the shard's (its segments are the same on
        every rank)."""
        world, rank = self.ranks.world_size, self.ranks.rank
        n = self.table.n_agents
        if n % world:
            raise ValueError(f"{n} rows do not shard over {world} ranks")
        rows = slice(rank * (n // world), (rank + 1) * (n // world))

        def local(x):
            return x[rows].clone() if x.ndim >= 1 and x.shape[0] == n else x

        self.table = tree_map(local, self.table)
        self.host_row_origin = self.host_row_origin[rows]
        if self._cluster_layout is not None:
            self._cluster_tidx = self._cluster_tidx[rows].clone()
            self._cluster_layout = self._cluster_layout._replace(n_dev=1)

    def _cluster_flags(self, inputs: ScenarioInputs) -> tuple:
        """Per-cluster net-billing flags for ``inputs``: a net-metered
        cluster prices by the linear identity only when its own members'
        NEM gate provably never closes (:func:`nem_gate_never_closes` on
        the cluster's real rows)."""
        h = self._cluster_host
        caps = inputs.nem_cap_kw.cpu().numpy()
        flags = []
        for ci, spec in enumerate(self._cluster_layout.clusters):
            if spec.metering == NET_BILLING:
                flags.append(True)
                continue
            sel = (h["cid"] == ci) & h["real"]
            flags.append(not nem_gate_never_closes(
                h["state_idx"][sel], caps, h["nem_first_year"][sel],
                h["nem_sunset_year"][sel], h["nem_kw_limit"][sel], self.years))
        return tuple(flags)

    def _footprint(self) -> dict:
        """The :func:`per_agent_step_bytes` keywords of this run."""
        rc = self.run_config
        return dict(sizing_iters=rc.sizing_iters, econ_years=self.econ_years,
                    n_periods=self.tariffs.max_periods, with_hourly=self.with_hourly,
                    rate_switch=self._rate_switch, bank_bf16=rc.bf16_banks,
                    bank_quant=rc.quant_banks)

    def _resolve_chunk(self) -> int:
        """The run's streaming chunk: the configured one, or with none
        configured the one this rank's share of its card's memory gives
        (:func:`rank_memory_bytes`; 0 on the CPU), sized against this
        rank's share of the table."""
        chunk = self.run_config.agent_chunk
        if chunk is not None:
            return chunk
        world = self.ranks.world_size if self.ranks else 1
        chunk = auto_agent_chunk(-(-self.table.n_agents // world),
                                 memory_bytes=rank_memory_bytes(self.device, self.ranks),
                                 **self._footprint())
        if chunk:
            logger.info("auto agent_chunk: %d rows (%d agents exceed the "
                        "whole-table memory budget)", chunk, self.table.n_agents)
        return chunk

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

    def _narrow_banks(self, profiles: ProfileBank) -> ProfileBank:
        """The banks as the run asks for them: int8 codes of load and
        generation with float32 per-row scales (``quant_banks``), then
        every float stream in bfloat16 (``bf16_banks``; the codes and the
        scales stay as they are)."""
        rc = self.run_config
        if rc.quant_banks:
            lq, ls = quantize_rows(profiles.load.cpu().numpy())
            cq, cs = quantize_rows(profiles.solar_cf.cpu().numpy())
            dev = lambda a: torch.from_numpy(a).to(self.device)
            profiles = dataclasses.replace(
                profiles, load=dev(lq), solar_cf=dev(cq), load_scale=dev(ls),
                solar_cf_scale=dev(cs))
            logger.info("int8 profile banks: load/gen streams at 1 byte/hour "
                        "(+%d per-row float32 scales)", ls.size + cs.size)
        if rc.bf16_banks:
            def bf16(x):
                return x.to(torch.bfloat16) if x.is_floating_point() else x

            profiles = dataclasses.replace(
                profiles, load=bf16(profiles.load),
                solar_cf=bf16(profiles.solar_cf),
                wholesale=bf16(profiles.wholesale))
        return profiles

    def _check_memory(self) -> int:
        """Modeled bytes of the run's year step (one chunk's rows beside
        the whole table's persistent rows). On a card, raises
        ``MemoryError`` when not even a :data:`_CHUNK_FLOOR_ROWS`-row
        chunk fits the budget, and warns when the configured chunk (or
        the whole table) models over it."""
        n = self.table.n_agents
        modeled = modeled_step_bytes(self._per_agent_bytes,
                                     self._agent_chunk or n, n)
        total = rank_memory_bytes(self.device, self.ranks)
        if total is None:
            return modeled
        budget = _MEMORY_BUDGET_FRAC * total
        floor = modeled_step_bytes(self._per_agent_bytes, min(_CHUNK_FLOOR_ROWS, n), n)
        if floor > budget:
            raise MemoryError(
                f"{n} agents model {floor / 2**30:.1f} GiB per year step at a "
                f"{_CHUNK_FLOOR_ROWS}-row chunk, over {_MEMORY_BUDGET_FRAC:.0%} "
                f"of this rank's {total / 2**30:.1f} GiB of the card"
            )
        if modeled > budget:
            logger.warning(
                "agent_chunk=%s models %.1f GiB per year step, over %.0f%% of this "
                "rank's %.1f GiB of the card; agent_chunk=None derives a chunk that fits",
                self.run_config.agent_chunk, modeled / 2**30,
                100 * _MEMORY_BUDGET_FRAC, total / 2**30)
        return modeled

    def _memory_check(self) -> dict:
        """The modeled year-step bytes beside the card's measured peaks
        since the last ``torch.cuda.reset_peak_memory_stats`` (None off a
        card); kept as ``self.memory_check``. Logs a warning when the
        measured peak passes :data:`_PEAK_OVER_MODEL_WARN` times the
        model on a streaming run."""
        rec = {"modeled_step_bytes": int(self.modeled_step_bytes),
               "agent_chunk": self._agent_chunk,
               "device_peak_allocated": None, "device_peak_reserved": None,
               "device_total": None, "peak_over_model": None}
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            rec.update(device_peak_allocated=int(peak),
                       device_peak_reserved=int(torch.cuda.max_memory_reserved(self.device)),
                       device_total=int(card_memory_bytes(self.device)),
                       peak_over_model=peak / self.modeled_step_bytes)
            logger.info("memory model: modeled step %.2f GiB vs device peak "
                        "%.2f GiB allocated (peak/model %.2f)",
                        self.modeled_step_bytes / 2**30, peak / 2**30,
                        rec["peak_over_model"])
            if peak > _PEAK_OVER_MODEL_WARN * self.modeled_step_bytes and self._agent_chunk:
                logger.warning(
                    "device peak is %.1fx the chunk model: the footprint model "
                    "under-counts this configuration (rate_switch=%s "
                    "with_hourly=%s); a larger population may run out of memory "
                    "at the chosen chunk", rec["peak_over_model"],
                    self._rate_switch, self.with_hourly)
        self.memory_check = rec
        return rec

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
            agent_chunk=self._agent_chunk,
            cluster=self._cluster_layout,
            soft_tau=self.run_config.soft_tau_static,
            # only on a multi-rank run: a one-rank step takes no such key
            **({"reduce": self._reduce} if self._reduce is not None else {}),
        )

    def step_operands(self) -> dict:
        """The tensors that go with a cluster layout into :func:`year_step`
        (the compact banks and the rows' compact tariff indices); empty
        when the run is unclustered."""
        if self._cluster_layout is None:
            return {}
        return dict(cluster_banks=self._cluster_banks,
                    cluster_tidx=self._cluster_tidx)

    def with_inputs(self, inputs: ScenarioInputs, net_billing: Optional[bool] = None,
                    timing_ctx: Optional[str] = None) -> "Simulation":
        """A sibling runner driving other ScenarioInputs over this
        simulation's placed table, profile banks, tariffs, daylight
        layout, chunk and cluster layout, none of them copied (a sweep's
        scenario-major loop: the banks are on the card once for S
        scenarios). ``inputs`` must cover the same year grid; they are
        moved to this run's device.

        ``net_billing`` overrides the recomputed flag (a sweep pins it per
        scenario group); True for an all-NEM scenario is exact, False only
        skips the bucket-sums kernel. A pinned flag pins every cluster's
        flag the same way; an unpinned sibling re-proves each cluster's
        NEM gate for its inputs. ``timing_ctx`` labels the sibling's phase
        timers (``utils.timing``)."""
        import copy

        if len(self.years) != inputs.n_years:
            raise ValueError(
                f"inputs cover {inputs.n_years} years but this simulation has "
                f"{len(self.years)}")
        inputs = to_device(inputs, self.device)
        pinned = net_billing is not None
        if not pinned:
            _, net_billing = run_static_flags(self.table, self.tariffs, inputs, self.years)
        cluster = self._cluster_layout
        if cluster is not None:
            cluster = (cluster.pin_net_billing(net_billing) if pinned
                       else cluster.with_flags(self._cluster_flags(inputs)))
        sib = copy.copy(self)
        sib.inputs = inputs
        sib._net_billing = net_billing
        sib._cluster_layout = cluster
        sib.timing_ctx = timing_ctx
        return sib

    def init_carry(self) -> SimCarry:
        return SimCarry.zeros(self.table.n_agents, self.device)

    def step(self, carry: SimCarry, year_idx: int,
             first_year: bool) -> tuple[SimCarry, YearOutputs]:
        # fault site: the year step's dispatch; an ``oom`` here raises what
        # an allocator OOM raises, so the supervisor's chunk halving runs
        fault_point("year_step")
        # fault site (kind ``corrupt``): a bank row turning NaN between
        # year steps (same shapes and dtypes); only the health sentinel's
        # breach -> attribute -> quarantine escalation catches it
        if corrupt_point("bank_corrupt_row"):
            self.profiles = _corrupt_bank_rows(self.profiles)
        return year_step(
            self.table, self.profiles, self.tariffs, self.inputs, carry,
            year_idx, **self.step_kwargs(first_year), **self.step_operands(),
        )

    def _check_state_kw_bound(self, carry: SimCarry, context: str) -> None:
        """The static all-NEM proof holds only while every state's
        capacity stays under STATE_KW_BOUND (summed over every rank's
        rows); raise if it does not."""
        state_kw = np.zeros(self.table.n_states, np.float64)
        np.add.at(state_kw, self.table.state_idx.cpu().numpy(),
                  carry.market.system_kw_cum.cpu().numpy())
        if self.ranks:
            state_kw = self.ranks.all_reduce(torch.from_numpy(state_kw)).numpy()
        if not np.all(state_kw < STATE_KW_BOUND):
            raise AssertionError(
                f"{context}: state capacity exceeds STATE_KW_BOUND; the static "
                "all-NEM skip of the net-billing path is unsound for this run"
            )

    def _health_verdict(self, year: int, yi: int, summary, outs,
                        escalate: bool) -> None:
        """The sentinel's verdict on one year's summary: breaches are
        recorded and attributed to agents from the year's outputs, then
        raised as ``HealthBreachError`` under ``escalate`` or logged as a
        warning."""
        breaches = health_mod.check_host(summary)
        if not breaches:
            return
        self._health_breaches[int(year)] = breaches
        err = health_mod.breach_error(year, yi, breaches, outs,
                                      self.host_agent_id, self.host_mask)
        if escalate:
            raise err
        logger.warning("health sentinel: %s", err)

    def _sanitize_restored_carry(self, carry: SimCarry) -> SimCarry:
        """A restored carry with the quarantined agents' rows zeroed on
        its device: a checkpoint written before a mid-run quarantine still
        holds their market state, and the state-capacity segment sums read
        the carry without the mask, so a contained agent would go on
        contributing. The carry itself (object identity) when nothing is
        quarantined."""
        rep = self.quarantine_report
        if rep is None or not rep.n_quarantined:
            return carry
        ids = torch.as_tensor(np.asarray(rep.ids, dtype=np.int64), device=self.device)
        q = torch.isin(self.table.agent_id.long(), ids)
        if not bool(q.any()):
            return carry
        keep = (~q).to(torch.float32)
        n = self.table.n_agents

        def zero(x):
            if x.ndim >= 1 and x.shape[0] == n:
                return x * keep.reshape((n,) + (1,) * (x.ndim - 1)).to(x.dtype)
            return x

        return tree_map(zero, carry)

    @property
    def agent_rows(self) -> np.ndarray:
        """[n_agents] int64 agent ids of this run's rows, -1 on a masked
        row."""
        return np.where(self.host_mask > 0, self.host_agent_id.astype(np.int64), -1)

    @property
    def checkpoint_rows(self) -> Optional[np.ndarray]:
        """The row order saved with each checkpointed year so that a
        resume under another layout restores by agent id
        (``io.checkpoint``): :attr:`agent_rows` for a clustered run and
        for a rank of a multi-rank run, None for an unclustered run of one
        rank."""
        if self._cluster_layout is None and self.ranks is None:
            return None
        return self.agent_rows

    def checkpoint_writer(self, checkpoint_dir: str):
        """The run's ``io.checkpoint.Writer``: one rank's part a year on a
        multi-rank run."""
        from dgen_tpu_torch.io import checkpoint as ckpt

        shard = (self.ranks.rank, self.ranks.world_size) if self.ranks else None
        return ckpt.Writer(checkpoint_dir, rows=self.checkpoint_rows, shard=shard)

    def restore_rows(self, checkpoint_dir: str, year: int) -> Optional[np.ndarray]:
        """The agent ids ``year``'s checkpoint restores onto in this run:
        :attr:`checkpoint_rows`, or :attr:`agent_rows` where those are None
        and the ranks of a multi-rank run wrote the year (one unclustered
        process resuming it by agent id)."""
        from dgen_tpu_torch.parallel import elastic

        rows = self.checkpoint_rows
        if rows is None and elastic.is_sharded(checkpoint_dir, year):
            rows = self.agent_rows
        return rows

    def _restore_carry(self, checkpoint_dir: str, year: int) -> SimCarry:
        """The carry checkpointed for ``year`` in this run's row order: a
        year the ranks of a multi-rank run wrote is moved onto these rows
        by agent id, whatever the world size that wrote it
        (``parallel.elastic``)."""
        from dgen_tpu_torch.parallel import elastic

        return elastic.restore_resharded(checkpoint_dir, self.table.n_agents * (
            self.ranks.world_size if self.ranks else 1), year, topo=self.ranks,
            device=self.device, rows=self.restore_rows(checkpoint_dir, year))[1]

    def _sync(self) -> None:
        """Wait for the work queued on the run's card (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(
        self,
        callback: Optional[Callable[[int, int, YearOutputs], None]] = None,
        collect: bool = True,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
        resume_year: Optional[int] = None,
        should_stop: Optional[Callable[[int, int], bool]] = None,
    ) -> SimResults:
        """Run every model year; returns the host results.

        ``callback(year, year_idx, outputs)`` fires after each year with
        the year's device outputs (an ``io.export.RunExporter``, say).
        ``collect=False`` keeps no per-agent arrays on the host (the
        results then hold the years only). ``checkpoint_dir`` saves the
        cross-year carry after every year (``io.checkpoint``); with
        ``resume=True`` the run restarts after the latest checkpointed
        year, or after ``resume_year`` when given. A checkpointed year off
        this scenario's year grid is refused. ``should_stop(year,
        year_idx)``, evaluated after each year's exports and checkpoint
        are issued, ends the run early when it returns True; the results
        then cover the years run.

        Host consumers (collection, the callback, checkpoint saves) run
        on the host-I/O pipeline (``io.hostio``) by default: the run loop
        dispatches year after year while worker threads fetch each
        finished year on a side CUDA stream and write it out, with the
        same results bit for bit. ``RunConfig.async_host_io=False``
        (``DGEN_TPU_ASYNC_IO=0``) keeps the serialized per-year path, which
        ``debug_invariants`` always takes. A worker's error fails the run.
        The health sentinel (``RunConfig.sentinel_enabled``) checks every
        year's outputs; ``debug_invariants`` checks the carry and the
        outputs after every year.
        """
        rc = self.run_config
        start_idx = 0
        carry = self.init_carry()
        if resume:
            if not checkpoint_dir:
                raise ValueError("resume=True requires checkpoint_dir")
            from dgen_tpu_torch.io import checkpoint as ckpt

            last = resume_year if resume_year is not None else ckpt.latest_year(
                checkpoint_dir)
            if self.ranks:
                # every rank resumes at rank 0's year, whatever its own
                # listing of the shared directory saw
                last = int(self.ranks.broadcast(torch.tensor(
                    [-1 if last is None else last], dtype=torch.int64))[0])
                last = None if last < 0 else last
            if last is not None and last not in self.years:
                # restarting from scratch would also overwrite the
                # existing (incompatible) checkpoints
                raise ValueError(
                    f"checkpointed year {last} is not on this scenario's year grid "
                    f"{self.years}; refusing to resume")
            if last is not None:
                carry = self._sanitize_restored_carry(
                    self._restore_carry(checkpoint_dir, last))
                start_idx = self.years.index(last) + 1
                logger.info("resuming after year %d (index %d)", last, start_idx)

        agent_fields = [f.name for f in dataclasses.fields(YearOutputs)
                        if f.name != "state_hourly_net_mw"]
        ckpt_writer = None
        if checkpoint_dir is not None:
            ckpt_writer = self.checkpoint_writer(checkpoint_dir)
        debug = rc.debug_invariants
        async_io = (rc.async_io_enabled and not debug
                    and (collect or callback is not None or ckpt_writer is not None))
        self.hostio_stats = None
        self._stop_idx: Optional[int] = None
        self.health_report = None
        self._health_breaches: Dict[int, list] = {}
        try:
            if async_io:
                carry, collected, hourly = self._run_years_async(
                    carry, start_idx, callback, collect, ckpt_writer, agent_fields,
                    should_stop)
            else:
                carry, collected, hourly = self._run_years_sync(
                    carry, start_idx, callback, collect, ckpt_writer, agent_fields,
                    debug, should_stop)
        finally:
            if ckpt_writer is not None:
                ckpt_writer.close()
        if not self._net_billing and not debug:
            self._check_state_kw_bound(carry, "end of run")
        self._memory_check()
        end_idx = self._stop_idx if self._stop_idx is not None else len(self.years)
        if rc.sentinel_enabled:
            self.health_report = {
                "breaches": {int(y): b for y, b in self._health_breaches.items()},
                "clean": not self._health_breaches,
            }
        return SimResults(
            years=self.years[start_idx:end_idx],
            agent=({k: np.stack(v) for k, v in collected.items()}
                   if collect and collected[agent_fields[0]] else {}),
            state_hourly_net_mw=np.stack(hourly) if hourly else None,
        )

    def _run_years_async(self, carry: SimCarry, start_idx: int, callback,
                         collect: bool, ckpt_writer, agent_fields: List[str],
                         should_stop=None):
        """The year loop on the host-I/O pipeline: years are dispatched
        back to back and every host consumer runs on the pipeline's
        worker threads against one fetch a year. The carry is snapshotted
        (a device copy queued right behind its step) before the next step
        when checkpointing. The ``finally`` drain flushes every completed
        year exactly once and never masks the loop's own error."""
        from dgen_tpu_torch.io import hostio

        rc = self.run_config
        consumers: list = []
        # the sentinel first: a breached year is caught before its export
        # and checkpoint consumers run
        if rc.sentinel_enabled:
            consumers.append(hostio.HealthConsumer(
                mask=self.table.mask, agent_ids_host=self.host_agent_id,
                mask_host=self.host_mask, escalate=bool(rc.sentinel_escalate),
                breaches_out=self._health_breaches, reduce=self._reduce))
        collector = None
        if collect:
            collector = hostio.CollectConsumer(agent_fields, self.with_hourly)
            consumers.append(collector)
        if callback is not None:
            consumers.append(hostio.consumer_for_callback(callback))
        if ckpt_writer is not None:
            consumers.append(hostio.CheckpointConsumer(ckpt_writer))

        pipeline = None
        loop_failed = False
        try:
            for yi, year in enumerate(self.years):
                if yi < start_idx:
                    continue
                t0 = time.perf_counter()
                with timing.timer("year_step", ctx=self.timing_ctx):
                    carry, outs = self.step(carry, yi, first_year=(yi == 0))
                if pipeline is None:
                    pipeline = hostio.pipeline_for(
                        consumers, outs,
                        carry=carry if ckpt_writer is not None else None,
                        timing_ctx=self.timing_ctx, pool=self._hostio_pool)
                snap = hostio.snapshot_carry(carry) if ckpt_writer is not None else None
                pipeline.submit(year, yi, outs, carry=snap)
                del outs, snap
                logger.info("year %d (%d/%d) %.2fs (queued)", year, yi + 1,
                            len(self.years), time.perf_counter() - t0)
                if should_stop is not None and should_stop(year, yi):
                    logger.info("cooperative stop after year %d (%d/%d)", year,
                                yi + 1, len(self.years))
                    self._stop_idx = yi + 1
                    break
        except BaseException:
            loop_failed = True
            raise
        finally:
            if pipeline is not None:
                self.hostio_stats = pipeline.drain(failed=loop_failed)
        with timing.timer("device_drain", ctx=self.timing_ctx):
            self._sync()
        if collector is not None:
            return carry, collector.collected, collector.hourly
        return carry, {k: [] for k in agent_fields}, []

    def _run_years_sync(self, carry: SimCarry, start_idx: int, callback,
                        collect: bool, ckpt_writer, agent_fields: List[str],
                        debug: bool, should_stop=None):
        """The serialized year loop, the parity oracle of the pipeline.

        The card is waited on each year only when something reads the
        year on the host (checkpoints, collection, invariants). A callback
        alone is deferred one year: it runs after the next year's step is
        dispatched, its ``prepare`` hook right behind its own step, and
        the deferred year's health verdict gates it. With no consumer the
        years run back to back and the health summaries are fetched once
        at the end. A ``finally`` flushes the last completed year's
        deferred callback exactly once."""
        from dgen_tpu_torch.io.hostio import to_host

        rc = self.run_config
        collected: Dict[str, list] = {k: [] for k in agent_fields}
        hourly: List[np.ndarray] = []
        sentinel = rc.sentinel_enabled
        escalate = bool(rc.sentinel_escalate)
        queued_health: List[tuple] = []
        pending_health = None          # (year, yi, summary, outs)
        sync_per_year = bool(ckpt_writer is not None or collect or debug)
        defer_callback = callback is not None and not sync_per_year
        pending_cb = None              # (year, yi, outs)
        loop_failed = False
        try:
            for yi, year in enumerate(self.years):
                if yi < start_idx:
                    continue
                t0 = time.perf_counter()
                with timing.timer("year_step", ctx=self.timing_ctx):
                    prev_carry = carry
                    carry, outs = self.step(carry, yi, first_year=(yi == 0))
                    if sync_per_year:
                        self._sync()
                if debug:
                    invariants.check_transform(prev_carry, carry,
                                               context=f"year {year} carry")
                    invariants.check_finite(carry, context=f"year {year} carry")
                    invariants.check_finite(outs, context=f"year {year} outputs")
                    if not self._net_billing:
                        self._check_state_kw_bound(carry, f"year {year}")
                summary = None
                if sentinel:
                    summary = health_mod.health_summary(outs, self.table.mask,
                                                        self._reduce)
                    if sync_per_year:
                        self._health_verdict(year, yi, to_host(summary), outs, escalate)
                    elif not defer_callback:
                        queued_health.append((year, yi, summary))
                logger.info("year %d (%d/%d) %.2fs%s", year, yi + 1, len(self.years),
                            time.perf_counter() - t0,
                            "" if sync_per_year else " (queued)")
                if callback is not None:
                    if defer_callback:
                        if pending_cb is not None:
                            # handed off before the call: if it raises
                            # partway, the finally flush must not write
                            # the same year again
                            prev, pending_cb = pending_cb, None
                            prev_h, pending_health = pending_health, None
                            if prev_h is not None and prev_h[2] is not None:
                                self._health_verdict(prev_h[0], prev_h[1],
                                                     to_host(prev_h[2]), prev_h[3],
                                                     escalate)
                            callback(*prev)
                        pending_cb = (year, yi, outs)
                        pending_health = (year, yi, summary, outs)
                        # the callback's device-side preparation (the
                        # compact quantization) right behind this step
                        prep = getattr(callback, "prepare", None)
                        if prep is not None:
                            prep(year, yi, outs)
                    else:
                        callback(year, yi, outs)
                if ckpt_writer is not None:
                    with timing.timer("ckpt_save", ctx=self.timing_ctx):
                        ckpt_writer.save(year, carry)
                if collect:
                    to_fetch = {k: getattr(outs, k) for k in agent_fields}
                    if self.with_hourly:
                        to_fetch["_hourly"] = outs.state_hourly_net_mw
                    # kept as copies, so the pinned fetch buffers go back
                    # to the pool (as hostio.CollectConsumer keeps them)
                    host = to_host(to_fetch)
                    for k in agent_fields:
                        collected[k].append(np.array(host[k]))
                    if self.with_hourly:
                        hourly.append(np.array(host["_hourly"]))
                if should_stop is not None and should_stop(year, yi):
                    logger.info("cooperative stop after year %d (%d/%d)", year,
                                yi + 1, len(self.years))
                    self._stop_idx = yi + 1
                    break
        except BaseException:
            loop_failed = True
            raise
        finally:
            if pending_cb is not None:
                # the deferred trailing callback: the final year on
                # success, the last completed year on failure
                try:
                    if pending_health is not None and pending_health[2] is not None:
                        self._health_verdict(pending_health[0], pending_health[1],
                                             to_host(pending_health[2]),
                                             pending_health[3], escalate)
                    callback(*pending_cb)
                except Exception:  # noqa: BLE001
                    if not loop_failed:
                        # success path: a failed final-year export surfaces
                        raise
                    # failure path: the loop's own error wins
                    logger.exception("deferred year export failed")
                pending_cb = None
        if not sync_per_year:
            with timing.timer("device_drain", ctx=self.timing_ctx):
                self._sync()
        if queued_health:
            # no consumer: one fetch of every year's verdict at the end
            # (detected; the device outputs are gone, so unattributed)
            hosts = to_host([s for _, _, s in queued_health])
            for (qy, qyi, _), h in zip(queued_health, hosts):
                self._health_verdict(qy, qyi, h, None, escalate)
        return carry, collected, hourly
