"""NPV-optimal PV sizing over the whole agent table (port of the fast
path of ``dgen_tpu/ops/sizing.py``).

Two refining candidate-grid rounds: each evaluates ``n_iters`` candidate
sizes for every agent in ONE bucket-sums engine call, packing
(candidate, year) pairs into the scale axis; round 2 re-grids around
round 1's winner. NEM bills use the linear identity; net-billing bills
the import-sums kernel (the pair kernel when a DG-rate switch is live).
One forward run with a battery at the fixed PV ratio follows, priced
by the full bucket-sums kernel, then the 25-year cashflow.

``impl`` picks the bucket-sums engine (``billkernels.IMPLS``);
``daylight`` runs the refine rounds on daylight-compacted lanes;
``pack_once`` builds the candidate lanes once per call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import dispatch as dispatch_ops
from dgen_tpu_torch.ops.bill import AgentTariff
from dgen_tpu_torch.ops.layout import DaylightLayout
from dgen_tpu_torch.ops.cashflow import (
    FinanceParams,
    IncentiveParams,
    cashflow,
    payback_period,
)
from dgen_tpu_torch.tree import tree_map

INV_EFF = 0.96  # inverter efficiency

# sizing bracket relative to the load-implied max system size
SIZE_LO_FRAC = 0.8
SIZE_HI_FRAC = 1.25


@dataclasses.dataclass(frozen=True)
class AgentEconInputs:
    """Everything the economics evaluation needs, leaves ``[N, ...]``."""

    load: torch.Tensor            # [N, 8760] hourly consumption (kWh/h)
    gen_per_kw: torch.Tensor      # [N, 8760] PV DC output per kW_dc
    ts_sell: torch.Tensor         # [N, 8760] $/kWh time-series sell rate
    tariff: AgentTariff
    #: post-adoption (DG-rate-switched) tariff for WITH-system bills;
    #: None = no switch
    tariff_w: Optional[AgentTariff]
    fin: FinanceParams
    inc: IncentiveParams
    load_kwh_per_customer: torch.Tensor
    elec_price_escalator: torch.Tensor
    pv_degradation: torch.Tensor
    system_capex_per_kw: torch.Tensor
    system_capex_per_kw_combined: torch.Tensor
    batt_capex_per_kwh_combined: torch.Tensor
    cap_cost_multiplier: torch.Tensor
    value_of_resiliency_usd: torch.Tensor
    #: one-time interconnection charge, paid only where the switch applies
    one_time_charge: torch.Tensor
    #: upper bound on the sizing bracket while NEM is active; None = 1e30
    nem_kw_cap: Optional[torch.Tensor] = None
    #: DG-rate switch window on kW; None = always-switch when tariff_w
    #: is given, never otherwise
    switch_min_kw: Optional[torch.Tensor] = None
    switch_max_kw: Optional[torch.Tensor] = None
    #: battery round-trip efficiency; None = the dispatch default
    batt_rt_eff: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SizingResult:
    """Per-agent sized economics, leaves ``[N, ...]``."""

    system_kw: torch.Tensor
    npv: torch.Tensor
    payback_period: torch.Tensor
    cash_flow: torch.Tensor                  # [N, Y+1]
    naep: torch.Tensor
    annual_energy_production_kwh: torch.Tensor
    capacity_factor: torch.Tensor
    first_year_bill_with_system: torch.Tensor
    first_year_bill_without_system: torch.Tensor
    batt_kw: torch.Tensor
    batt_kwh: torch.Tensor
    first_year_bill_with_batt: torch.Tensor
    energy_value_pv_only: torch.Tensor       # [N, Y]
    energy_value_pv_batt: torch.Tensor       # [N, Y]
    baseline_net_hourly: torch.Tensor        # [N, 8760] or [N, 0]
    adopter_net_hourly_pvonly: torch.Tensor
    adopter_net_hourly_with_batt: torch.Tensor


def net_hourly_profiles(load, gen, system_out):
    """(baseline, pv_only, with_batt) net grid-consumption profiles."""
    return (
        load,
        torch.clamp_min(load - gen, 0.0),
        torch.clamp_min(load - system_out, 0.0),
    )


def _switch_active(env: AgentEconInputs, kw: torch.Tensor) -> torch.Tensor:
    """Whether the DG-rate switch applies at system size ``kw``,
    broadcasting the per-agent window over a trailing candidate axis."""
    mn, mx = env.switch_min_kw, env.switch_max_kw
    if kw.ndim == mn.ndim + 1:
        mn, mx = mn[..., None], mx[..., None]
    return (kw >= mn) & (kw < mx)


def _unit_grid(k: int, device) -> torch.Tensor:
    """[k] candidate positions on [0, 1], bit for bit those of
    ``jnp.linspace(0, 1, k, dtype=float32)``: XLA folds its
    ``iota / (k - 1)`` into a product with the float32 reciprocal, and
    the endpoint is appended (``torch.linspace`` rounds differently)."""
    t = np.arange(k - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(k - 1))
    return torch.from_numpy(np.append(t, np.float32(1.0))).to(device)


def _fill_env_defaults(envs: AgentEconInputs) -> AgentEconInputs:
    """Dense encodings of the ``None`` sentinels: unlimited NEM bracket,
    an always-on switch window when ``tariff_w`` is given."""
    if (envs.nem_kw_cap is not None and envs.switch_min_kw is not None
            and envs.switch_max_kw is not None):
        return envs
    n = envs.load.shape[0]
    big = torch.full((n,), 1e30, dtype=torch.float32, device=envs.load.device)
    zero = torch.zeros_like(big)
    return dataclasses.replace(
        envs,
        nem_kw_cap=big if envs.nem_kw_cap is None else envs.nem_kw_cap,
        switch_min_kw=(
            (zero if envs.tariff_w is not None else big)
            if envs.switch_min_kw is None else envs.switch_min_kw
        ),
        switch_max_kw=big if envs.switch_max_kw is None else envs.switch_max_kw,
    )


def size_agents(
    envs: AgentEconInputs,
    n_periods: int,
    n_years: int,
    n_iters: int = 14,
    keep_hourly: bool = True,
    net_billing: bool = True,
    impl: str = "auto",
    daylight: Optional[DaylightLayout] = None,
    pack_once: bool = False,
) -> SizingResult:
    """Size every agent of the table (leading axis).

    ``net_billing=False`` asserts that no agent prices on a net-billing
    tariff, so search-round bills reduce to the linear NEM identity and
    no bucket-sums kernel runs in the rounds. ``daylight``: the refine
    rounds' import sums run on the layout's compacted lanes (padded to
    uniform segments under the stream engine, as the JAX package pads
    them). ``pack_once``: one :func:`billkernels.pack_streams` feeds both
    rounds, and the battery run too when its lanes match (full-hour, one
    tariff structure)."""
    envs = _fill_env_defaults(envs)
    if impl == "stream" and daylight is not None:
        daylight = daylight.uniform()
    n = envs.load.shape[0]
    dev = envs.load.device
    f32 = dict(dtype=torch.float32, device=dev)
    k = max(int(n_iters), 4)

    gen_shape = envs.gen_per_kw * INV_EFF                          # [N, H]
    naep = envs.gen_per_kw.sum(dim=1)                              # [N]

    max_system = envs.load_kwh_per_customer / torch.clamp_min(naep, 1e-9)
    lo = max_system * SIZE_LO_FRAC
    hi = max_system * SIZE_HI_FRAC
    # the NEM system-size limit caps the bracket while NEM is active
    hi = torch.minimum(hi, envs.nem_kw_cap)
    lo = torch.minimum(lo, hi)

    n_buckets = 12 * n_periods
    # with-system bills price on the switched tariff only for candidates
    # inside the switch window; the counterfactual stays on the original
    has_switch = envs.tariff_w is not None
    tw = envs.tariff if not has_switch else envs.tariff_w
    bucket = bk.hourly_bucket_ids(tw.hour_period, n_periods)
    sell = bk.sell_rate_hourly(tw, envs.ts_sell)

    yr = torch.arange(n_years, **f32)[None, :]
    pf = ((1.0 + envs.fin.inflation_rate[:, None])
          * (1.0 + envs.elec_price_escalator[:, None])) ** yr      # [N, Y]
    df = (1.0 - envs.pv_degradation[:, None]) ** yr                # [N, Y]

    lin = bk.linear_sums(envs.load, gen_shape, sell, tw.hour_period, n_periods)

    # no-system bills: scale 0 through the linear path on the ORIGINAL
    # tariff, no kernel call
    zeros1 = torch.zeros((n, 1), **f32)
    if not has_switch:
        lin_wo, sell_wo, bucket_wo = lin, sell, bucket
    else:
        sell_wo = bk.sell_rate_hourly(envs.tariff, envs.ts_sell)
        lin_wo = bk.linear_sums(envs.load, gen_shape, sell_wo,
                                envs.tariff.hour_period, n_periods)
        bucket_wo = bk.hourly_bucket_ids(envs.tariff.hour_period, n_periods)
    imp0 = lin_wo[0][:, None, :]
    bills_wo = bk.bills_linear_nb(
        lin_wo, imp0, lin_wo[2][:, None], zeros1, envs.tariff, n_periods,
    )[:, 0:1] * pf                                                 # [N, Y]

    def econ(bills_w, kw, installed_cost, vor, annual_kwh):
        energy_value = (bills_wo - bills_w) + vor[:, None]
        out = cashflow(
            energy_value, installed_cost, envs.fin, n_years, system_kw=kw,
            annual_kwh=annual_kwh, degradation=envs.pv_degradation,
            inc=envs.inc,
        )
        out["energy_value"] = energy_value
        out["bills_w"] = bills_w
        return out

    def pv_cost(kw):
        # kw: [N] or [N, K]; the one-time charge applies only where the
        # DG-rate switch takes effect
        unsq = (lambda x: x[:, None]) if kw.ndim == 2 else (lambda x: x)
        otc = torch.where(_switch_active(envs, kw), unsq(envs.one_time_charge), 0.0)
        return unsq(envs.system_capex_per_kw) * kw * unsq(envs.cap_cost_multiplier) + otc

    # one pack of the candidate lanes feeds both refine rounds (skipped
    # when no candidate kernel runs)
    packed = None
    if pack_once and net_billing:
        packed = bk.pack_streams(
            envs.load, gen_shape, sell, bucket, n_buckets, layout=daylight,
            sell_b=sell_wo if has_switch else None,
            bucket_b=bucket_wo if has_switch else None,
        )
    engine = dict(impl=impl, layout=daylight, packed=packed)

    def raw(a):
        """A raw stream argument, None when the pack carries it."""
        return None if packed is not None else a

    def candidate_bills(scales):
        """[N, R] packed (candidate, year) scales -> with-system annual
        bills on the switched tariff and, with a switch, the original."""
        if not net_billing:
            bills_sw = bk.bills_linear_nem(lin, scales, tw, n_periods)
            if not has_switch:
                return bills_sw, None
            return bills_sw, bk.bills_linear_nem(lin_wo, scales, envs.tariff, n_periods)
        if not has_switch:
            imports, imp_sell = bk.import_sums(
                raw(envs.load), raw(gen_shape), raw(sell), raw(bucket), scales,
                n_buckets, **engine)
            return bk.bills_linear_nb(lin, imports, imp_sell, scales, tw,
                                      n_periods), None
        imports, imp_sell, imports_o, imp_sell_o = bk.import_sums_pair(
            raw(envs.load), raw(gen_shape), raw(sell), raw(bucket), raw(sell_wo),
            raw(bucket_wo), scales, n_buckets, **engine)
        bills_sw = bk.bills_linear_nb(lin, imports, imp_sell, scales, tw, n_periods)
        bills_o = bk.bills_linear_nb(lin_wo, imports_o, imp_sell_o, scales,
                                     envs.tariff, n_periods)
        return bills_sw, bills_o

    rep = lambda x: x.repeat_interleave(k, dim=0)
    fin_k = tree_map(rep, envs.fin)
    inc_k = tree_map(rep, envs.inc)

    def eval_grid(kw_grid):
        """kw_grid [N, K] -> (npv [N, K], bills [N, K, Y])."""
        scales = (kw_grid[:, :, None] * df[:, None, :]).reshape(n, k * n_years)
        bills_sw, bills_o = candidate_bills(scales)
        if has_switch:
            sel = _switch_active(envs, kw_grid).repeat_interleave(n_years, dim=1)
            bills = torch.where(sel, bills_sw, bills_o)
        else:
            bills = bills_sw
        bills = bills.reshape(n, k, n_years) * pf[:, None, :]

        ev = (bills_wo[:, None, :] - bills).reshape(n * k, n_years)
        kw_f = kw_grid.reshape(n * k)
        out = cashflow(
            ev, pv_cost(kw_grid).reshape(n * k), fin_k, n_years,
            system_kw=kw_f, annual_kwh=kw_f * INV_EFF * rep(naep),
            degradation=rep(envs.pv_degradation), inc=inc_k,
        )
        return out["npv"].reshape(n, k), bills

    t = _unit_grid(k, dev)[None, :]

    def grid(lo_, hi_):
        return lo_[:, None] + (hi_ - lo_)[:, None] * t            # [N, K]

    def take(a, i):
        return a.gather(1, i[:, None])[:, 0]

    # round 1: coarse grid over the bracket
    g1 = grid(lo, hi)
    npv1, _ = eval_grid(g1)
    i1 = torch.argmax(npv1, dim=1)            # first maximum, as jnp.argmax
    lo2 = take(g1, torch.clamp_min(i1 - 1, 0))
    hi2 = take(g1, torch.clamp_max(i1 + 1, k - 1))

    # round 2: refined grid around the round-1 winner
    g2 = grid(lo2, hi2)
    npv2, bills2 = eval_grid(g2)
    i2 = torch.argmax(npv2, dim=1)
    kw_star = take(g2, i2)

    # --- PV-only outputs at kW* (the winning candidate) ---
    gen_n = gen_shape * kw_star[:, None]
    bills_w_n = bills2.gather(1, i2[:, None, None].expand(n, 1, n_years))[:, 0, :]
    out_n = econ(bills_w_n, kw_star, pv_cost(kw_star), torch.zeros(n, **f32),
                 kw_star * INV_EFF * naep)
    payback = payback_period(out_n["cf"])

    # --- forward run with a battery at the fixed ratio ---
    batt_kw, batt_kwh = dispatch_ops.batt_size_from_pv(kw_star)
    rt_eff = (torch.full((n,), dispatch_ops.DEFAULT_RT_EFF, **f32)
              if envs.batt_rt_eff is None else envs.batt_rt_eff)
    dr = dispatch_ops.dispatch_battery(envs.load, gen_n, batt_kw, batt_kwh, rt_eff)
    batt_cost = envs.batt_capex_per_kwh_combined * batt_kwh * 0.7
    sw_star = _switch_active(envs, kw_star)
    otc_star = torch.where(sw_star, envs.one_time_charge, 0.0)
    cost_w = (envs.system_capex_per_kw_combined * kw_star + batt_cost) \
        * envs.cap_cost_multiplier + otc_star
    # the with-battery tariff follows the switch decision at kW*
    if has_switch:
        tariff_star = tree_map(
            lambda a, b: torch.where(sw_star.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
            tw, envs.tariff,
        )
        bucket_star = torch.where(sw_star[:, None], bucket, bucket_wo)
        sell_star = torch.where(sw_star[:, None], sell, sell_wo)
    else:
        tariff_star, bucket_star, sell_star = tw, bucket, sell
    # the battery-modified output is not a scale of the gen shape: the
    # full bucket-sums kernel with per-year degradation scales, on the
    # pack's lanes only where they are this call's (full-hour, one tariff
    # structure: a discharging battery breaks the night-zero premise)
    batt_packed = packed if daylight is None and not has_switch else None
    s_b, i_b, c_b = bk.bucket_sums(
        None if batt_packed is not None else envs.load, dr.system_out,
        None if batt_packed is not None else sell_star,
        None if batt_packed is not None else bucket_star,
        df, n_buckets, impl=impl, packed=batt_packed)
    bills_w_b = bk.bills_from_sums(s_b, i_b, c_b, tariff_star, n_periods) * pf
    out_w = econ(bills_w_b, kw_star, cost_w, envs.value_of_resiliency_usd,
                 dr.system_out.sum(dim=1))

    annual_kwh = gen_n.sum(dim=1)
    naep_final = annual_kwh / torch.clamp_min(kw_star, 1e-9)

    if keep_hourly:
        baseline_net, net_pvonly, net_with_batt = net_hourly_profiles(
            envs.load, gen_n, dr.system_out)
    else:
        baseline_net = net_pvonly = net_with_batt = torch.zeros((n, 0), **f32)

    return SizingResult(
        system_kw=kw_star,
        npv=out_n["npv"],
        payback_period=payback,
        cash_flow=out_n["cf"],
        naep=naep_final,
        annual_energy_production_kwh=annual_kwh,
        capacity_factor=naep_final / 8760.0,
        first_year_bill_with_system=out_n["bills_w"][:, 0],
        first_year_bill_without_system=bills_wo[:, 0],
        batt_kw=batt_kw,
        batt_kwh=batt_kwh,
        first_year_bill_with_batt=out_w["bills_w"][:, 0],
        energy_value_pv_only=out_n["energy_value"],
        energy_value_pv_batt=out_w["energy_value"],
        baseline_net_hourly=baseline_net,
        adopter_net_hourly_pvonly=net_pvonly,
        adopter_net_hourly_with_batt=net_with_batt,
    )
