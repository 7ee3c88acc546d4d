"""NPV-optimal PV sizing over the whole agent table (port of
``dgen_tpu/ops/sizing.py``).

The fast path (:func:`size_agents`, ``fast=True``) runs two refining
candidate-grid rounds: each evaluates ``n_iters`` candidate
sizes for every agent in ONE bucket-sums engine call, packing
(candidate, year) pairs into the scale axis; round 2 re-grids around
round 1's winner. NEM bills use the linear identity; net-billing bills
the import-sums kernel (the pair kernel when a DG-rate switch is live).
One forward run with a battery at the fixed PV ratio follows, priced
by the full bucket-sums kernel, then the 25-year cashflow.

``impl`` picks the bucket-sums engine (``billkernels.IMPLS``);
``daylight`` runs the refine rounds on daylight-compacted lanes;
``pack_once`` builds the candidate lanes once per call. Under bf16 or
int8 profile banks the candidate kernels read the narrow streams (int8
codes with their scales folded in); the dispatch loop, the linear sums,
naep and the hourly profiles price float32 (dequantized) copies.

The per-agent oracle (``fast=False``, :func:`size_one_agent`) is the
direct hourly path: a golden-section search over each agent's bracket,
every candidate priced by the hourly bill engine over the whole analysis
period (:func:`~dgen_tpu_torch.ops.bill.bill_series`), then a battery
forward run through :func:`dispatch_ops.dispatch_battery`. The JAX
package vmaps it over agents; here it runs batched over agent chunks of
:func:`oracle_chunk_rows`, every operation row-wise, so a row's result
does not depend on the rows that share its chunk.

``soft_tau`` is the differentiable twin (:mod:`dgen_tpu_torch.grad`):
soft import/export splits, tier clips and straight-through switch gates
in the fast path's objective, an unrounded payback; fast path only.
:func:`make_npv_objective` builds the batched differentiable objective
that Newton sizing climbs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgen_tpu_torch.grad.smooth import ste_gate
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import dispatch as dispatch_ops
from dgen_tpu_torch.ops.bill import AgentTariff, bill_series
from dgen_tpu_torch.ops.tariff import HOURS
from dgen_tpu_torch.ops.layout import DaylightLayout
from dgen_tpu_torch.ops.cashflow import (
    FinanceParams,
    IncentiveParams,
    cashflow,
    payback_period,
)
from dgen_tpu_torch.tree import tree_map

INV_EFF = 0.96  # inverter efficiency
GOLDEN = 0.6180339887498949  # 1/phi

# sizing bracket relative to the load-implied max system size
SIZE_LO_FRAC = 0.8
SIZE_HI_FRAC = 1.25

#: bytes of the per-agent oracle's ``[rows, Y, 8760]`` float32
#: temporaries (about ORACLE_TEMPS of them live at once) a chunk may take
ORACLE_BYTES = 1 << 32
ORACLE_TEMPS = 6


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
    #: int8 banks: [N] float32 dequantization factors of the ``load`` and
    #: ``gen_per_kw`` codes (the load multiplier folded in); None = float
    load_scale: Optional[torch.Tensor] = None
    gen_scale: Optional[torch.Tensor] = None


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


def float32_streams(load, gen_per_kw, load_scale=None, gen_scale=None):
    """(gen_shape, gen_f32, load_f32) of gathered hour streams: the
    generation shape after the inverter that the candidate kernels read
    (at the bank's dtype; the int8 codes themselves under int8 banks,
    whose scales the kernels fold in), and the float32 generation per kW
    and load that the dispatch, the linear sums and the hourly profiles
    price (the state-of-charge recursion compounds rounding over 8760
    steps). The year step's hourly remat pass prices the same copies."""
    if load_scale is not None:
        gen_shape = gen_per_kw                                     # codes
        gen_f32 = gen_per_kw.float() * (gen_scale * INV_EFF)[:, None]
        load_f32 = load.float() * load_scale[:, None]
    else:
        # the factor at the bank's dtype, as the JAX package multiplies a
        # bf16 bank by its bf16-rounded constant
        gen_shape = gen_per_kw * torch.tensor(INV_EFF, dtype=gen_per_kw.dtype)
        gen_f32 = gen_shape.float()
        load_f32 = load.float()
    return gen_shape, gen_f32, load_f32


def _switch_active(env: AgentEconInputs, kw: torch.Tensor) -> torch.Tensor:
    """Whether the DG-rate switch applies at system size ``kw``,
    broadcasting the per-agent window over a trailing candidate axis; a
    ``None`` window is always on."""
    mn, mx = env.switch_min_kw, env.switch_max_kw
    if mn is None:
        return torch.ones_like(kw, dtype=torch.bool)
    if kw.ndim == mn.ndim + 1:
        mn, mx = mn[..., None], mx[..., None]
    return (kw >= mn) & (kw < mx)


def _switch_weight(env: AgentEconInputs, kw: torch.Tensor,
                   soft_tau: Optional[float]) -> torch.Tensor:
    """Float [0, 1] DG-rate-switch indicator at system size ``kw``: the
    hard window as float32, or under ``soft_tau`` a pair of
    straight-through gates (:func:`~dgen_tpu_torch.grad.smooth.ste_gate`):
    the same forward value (closed at the upper edge, a measure-zero
    difference) and a sigmoid bump of width ``soft_tau`` kW backward."""
    mn, mx = env.switch_min_kw, env.switch_max_kw
    if mn is None:
        return torch.ones_like(kw)
    if kw.ndim == mn.ndim + 1:
        mn, mx = mn[..., None], mx[..., None]
    if soft_tau is None:
        return ((kw >= mn) & (kw < mx)).to(kw.dtype)
    return ste_gate(kw - mn, soft_tau) * ste_gate(mx - kw, soft_tau)


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


def _size_agents_fast(
    envs: AgentEconInputs,
    n_periods: int,
    n_years: int,
    n_iters: int,
    keep_hourly: bool,
    net_billing: bool,
    impl: str,
    daylight: Optional[DaylightLayout],
    pack_once: bool,
    soft_tau: Optional[float],
) -> SizingResult:
    """The fast path of :func:`size_agents` on filled-in ``envs``."""
    # the smooth twin prices plain float32 full-hour streams: int8 codes
    # fold through hard thresholds, and the compacted and packed layouts'
    # night sums assume the hard relu's exact zeros
    if soft_tau is not None and (envs.load_scale is not None or daylight is not None
                                 or pack_once):
        raise ValueError("soft_tau requires plain f32 full-hour banks (no "
                         "quant_banks / daylight_compact / pack_once)")
    if impl == "stream" and daylight is not None:
        daylight = daylight.uniform()
    n = envs.load.shape[0]
    dev = envs.load.device
    f32 = dict(dtype=torch.float32, device=dev)
    k = max(int(n_iters), 4)

    # int8 banks: the candidate kernels read the codes, their scales folded
    # into the candidate scales (billkernels._quant_fold); the float32
    # floors below price dequantized copies, as under bf16 banks
    quant = envs.load_scale is not None
    gen_shape, gen_f32, load_f32 = float32_streams(
        envs.load, envs.gen_per_kw, envs.load_scale, envs.gen_scale)
    if quant:
        gen_scale_eff = envs.gen_scale * INV_EFF
        naep = envs.gen_per_kw.float().sum(dim=1) * envs.gen_scale
    else:
        gen_scale_eff = None
        naep = envs.gen_per_kw.float().sum(dim=1)                  # [N]

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

    # the linear bill structure, on dequantized float32 under int8 banks
    lin_load, lin_gen = (load_f32, gen_f32) if quant else (envs.load, gen_shape)
    lin = bk.linear_sums(lin_load, lin_gen, sell, tw.hour_period, n_periods)

    # no-system bills: scale 0 through the linear path on the ORIGINAL
    # tariff, no kernel call
    zeros1 = torch.zeros((n, 1), **f32)
    if not has_switch:
        lin_wo, sell_wo, bucket_wo = lin, sell, bucket
    else:
        sell_wo = bk.sell_rate_hourly(envs.tariff, envs.ts_sell)
        lin_wo = bk.linear_sums(lin_load, lin_gen, sell_wo,
                                envs.tariff.hour_period, n_periods)
        bucket_wo = bk.hourly_bucket_ids(envs.tariff.hour_period, n_periods)
    imp0 = lin_wo[0][:, None, :]
    bills_wo = bk.bills_linear_nb(
        lin_wo, imp0, lin_wo[2][:, None], zeros1, envs.tariff, n_periods, soft_tau,
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
        if soft_tau is None:
            otc = torch.where(_switch_active(envs, kw), unsq(envs.one_time_charge), 0.0)
        else:
            # straight-through gate: the same forward, the boundary seen
            # by a gradient
            otc = _switch_weight(envs, kw, soft_tau) * unsq(envs.one_time_charge)
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
    engine = dict(impl=impl, layout=daylight, packed=packed, soft_tau=soft_tau)
    if quant:
        engine.update(load_scale=envs.load_scale, gen_scale=gen_scale_eff)

    def raw(a):
        """A raw stream argument, None when the pack carries it."""
        return None if packed is not None else a

    def candidate_bills(scales):
        """[N, R] packed (candidate, year) scales -> with-system annual
        bills on the switched tariff and, with a switch, the original."""
        if not net_billing:
            bills_sw = bk.bills_linear_nem(lin, scales, tw, n_periods, soft_tau)
            if not has_switch:
                return bills_sw, None
            return bills_sw, bk.bills_linear_nem(lin_wo, scales, envs.tariff,
                                                 n_periods, soft_tau)
        if not has_switch:
            imports, imp_sell = bk.import_sums(
                raw(envs.load), raw(gen_shape), raw(sell), raw(bucket), scales,
                n_buckets, **engine)
            return bk.bills_linear_nb(lin, imports, imp_sell, scales, tw,
                                      n_periods, soft_tau), None
        imports, imp_sell, imports_o, imp_sell_o = bk.import_sums_pair(
            raw(envs.load), raw(gen_shape), raw(sell), raw(bucket), raw(sell_wo),
            raw(bucket_wo), scales, n_buckets, **engine)
        bills_sw = bk.bills_linear_nb(lin, imports, imp_sell, scales, tw, n_periods,
                                      soft_tau)
        bills_o = bk.bills_linear_nb(lin_wo, imports_o, imp_sell_o, scales,
                                     envs.tariff, n_periods, soft_tau)
        return bills_sw, bills_o

    rep = lambda x: x.repeat_interleave(k, dim=0)
    fin_k = tree_map(rep, envs.fin)
    inc_k = tree_map(rep, envs.inc)

    def eval_grid(kw_grid):
        """kw_grid [N, K] -> (npv [N, K], bills [N, K, Y])."""
        scales = (kw_grid[:, :, None] * df[:, None, :]).reshape(n, k * n_years)
        bills_sw, bills_o = candidate_bills(scales)
        if has_switch and soft_tau is None:
            sel = _switch_active(envs, kw_grid).repeat_interleave(n_years, dim=1)
            bills = torch.where(sel, bills_sw, bills_o)
        elif has_switch:
            # the straight-through blend: the hard select forward, the
            # window's boundary backward
            w = _switch_weight(envs, kw_grid, soft_tau).repeat_interleave(n_years, dim=1)
            bills = w * bills_sw + (1.0 - w) * bills_o
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
    gen_n = gen_f32 * kw_star[:, None]
    bills_w_n = bills2.gather(1, i2[:, None, None].expand(n, 1, n_years))[:, 0, :]
    out_n = econ(bills_w_n, kw_star, pv_cost(kw_star), torch.zeros(n, **f32),
                 kw_star * INV_EFF * naep)
    payback = payback_period(out_n["cf"], soft=soft_tau is not None)

    # --- forward run with a battery at the fixed ratio ---
    batt_kw, batt_kwh = dispatch_ops.batt_size_from_pv(kw_star)
    rt_eff = (torch.full((n,), dispatch_ops.DEFAULT_RT_EFF, **f32)
              if envs.batt_rt_eff is None else envs.batt_rt_eff)
    dr = dispatch_ops.dispatch_battery(load_f32, gen_n, batt_kw, batt_kwh, rt_eff)
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
    # structure: a discharging battery breaks the night-zero premise; no
    # int8 codes: the battery prices the dequantized float32 load)
    batt_load = load_f32 if quant else envs.load
    batt_packed = (packed if daylight is None and not has_switch and not quant
                   else None)
    s_b, i_b, c_b = bk.bucket_sums(
        None if batt_packed is not None else batt_load, dr.system_out,
        None if batt_packed is not None else sell_star,
        None if batt_packed is not None else bucket_star,
        df, n_buckets, impl=impl, packed=batt_packed, soft_tau=soft_tau)
    bills_w_b = bk.bills_from_sums(s_b, i_b, c_b, tariff_star, n_periods, soft_tau) * pf
    out_w = econ(bills_w_b, kw_star, cost_w, envs.value_of_resiliency_usd,
                 dr.system_out.sum(dim=1))

    annual_kwh = gen_n.sum(dim=1)
    naep_final = annual_kwh / torch.clamp_min(kw_star, 1e-9)

    if keep_hourly:
        baseline_net, net_pvonly, net_with_batt = net_hourly_profiles(
            load_f32, gen_n, dr.system_out)
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


# ---------------------------------------------------------------------------
# The per-agent oracle (the direct hourly path)
# ---------------------------------------------------------------------------

def _npv_given_system_out(env: AgentEconInputs, system_kw, system_out, installed_cost,
                          vor, n_periods: int, n_years: int) -> dict:
    """Shared tail of the oracle's objective for ``[N]`` agents: bills
    over the analysis period -> energy value -> cashflow. The
    with-system tariff is ``tariff_w`` only where the DG-rate switch
    window holds ``system_kw``; ``vor`` ``[N]`` (or a 0-d zero) is added
    to every year's energy value."""
    if env.tariff_w is None:
        tw = env.tariff
    else:
        sw = _switch_active(env, system_kw)
        tw = tree_map(
            lambda a, b: torch.where(sw.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
            env.tariff_w, env.tariff)
    bills_w, bills_wo = bill_series(
        env.load, system_out, tw, env.ts_sell, env.fin.inflation_rate,
        env.elec_price_escalator, env.pv_degradation, n_periods, n_years,
        tariff_wo=None if env.tariff_w is None else env.tariff,
    )
    energy_value = (bills_wo - bills_w) + vor[..., None]
    out = cashflow(
        energy_value, installed_cost, env.fin, n_years, system_kw=system_kw,
        annual_kwh=system_out.sum(dim=1), degradation=env.pv_degradation,
        inc=env.inc,
    )
    out["energy_value"] = energy_value
    out["bills_w"] = bills_w
    out["bills_wo"] = bills_wo
    return out


def pv_only_npv(kw: torch.Tensor, env: AgentEconInputs, n_periods: int,
                n_years: int) -> torch.Tensor:
    """The oracle's search objective: NPV ``[N]`` of PV-only systems of
    ``kw`` ``[N]``."""
    gen = env.gen_per_kw * kw[:, None] * INV_EFF
    otc = torch.where(_switch_active(env, kw), env.one_time_charge, 0.0)
    cost = env.system_capex_per_kw * kw * env.cap_cost_multiplier + otc
    zero = torch.zeros((), dtype=torch.float32, device=kw.device)
    return _npv_given_system_out(env, kw, gen, cost, zero, n_periods, n_years)["npv"]


def golden_section_max(f, lo: torch.Tensor, hi: torch.Tensor,
                       n_iters: int) -> torch.Tensor:
    """Maximize a unimodal function elementwise on ``[lo, hi]``: ``f`` maps
    points of ``lo``'s shape to values of the same shape. A fixed trip
    count; returns the bracket midpoint after ``n_iters`` reductions, one
    fresh evaluation each (the surviving interior point is one of the
    new ones)."""
    a, b = lo, hi
    c = b - (b - a) * GOLDEN
    d = a + (b - a) * GOLDEN
    fc = f(c)
    fd = f(d)
    for _ in range(n_iters):
        # keep the half containing the larger value
        take_left = fc > fd
        a, b = torch.where(take_left, a, c), torch.where(take_left, d, b)
        c2 = b - (b - a) * GOLDEN
        d2 = a + (b - a) * GOLDEN
        fx = f(torch.where(take_left, c2, d2))
        fc, fd = torch.where(take_left, fx, fd), torch.where(take_left, fc, fx)
        c, d = c2, d2
    return 0.5 * (a + b)


def size_one_agent(env: AgentEconInputs, n_periods: int, n_years: int,
                   n_iters: int = 14, keep_hourly: bool = True) -> SizingResult:
    """The full sizing pipeline, direct hourly path, for a batch of
    agents each priced alone (the JAX package's ``size_one_agent``,
    vmapped): the cross-check oracle of the fast path.

    1. Golden-section search for the NPV-optimal PV kW, no battery.
    2. PV-only outputs at kW*.
    3. One forward run with a battery at the fixed PV ratio, through the
       dispatch kernel on a card."""
    naep = env.gen_per_kw.float().sum(dim=1)
    max_system = env.load_kwh_per_customer / torch.clamp_min(naep, 1e-9)
    lo = max_system * SIZE_LO_FRAC
    hi = max_system * SIZE_HI_FRAC
    # the NEM system-size limit caps the bracket while NEM is active
    if env.nem_kw_cap is not None:
        hi = torch.minimum(hi, env.nem_kw_cap)
        lo = torch.minimum(lo, hi)

    kw_star = golden_section_max(
        lambda kw: pv_only_npv(kw, env, n_periods, n_years), lo, hi, n_iters)
    return oracle_outputs(env, kw_star, n_periods, n_years, keep_hourly)


def oracle_outputs(env: AgentEconInputs, kw_star: torch.Tensor, n_periods: int,
                   n_years: int, keep_hourly: bool = True) -> SizingResult:
    """The oracle's outputs at given sizes ``kw_star`` ``[N]`` (steps 2
    and 3 of :func:`size_one_agent`): PV-only economics, and the battery
    forward run through :func:`dispatch_ops.dispatch_battery`. It also
    prices another path's sizes with the oracle's hourly engine."""
    n = kw_star.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=kw_star.device)

    # --- PV-only outputs at kW* ---
    gen_n = env.gen_per_kw * kw_star[:, None] * INV_EFF
    otc_star = torch.where(_switch_active(env, kw_star), env.one_time_charge, 0.0)
    cost_n = env.system_capex_per_kw * kw_star * env.cap_cost_multiplier + otc_star
    out_n = _npv_given_system_out(env, kw_star, gen_n, cost_n, zeros, n_periods,
                                  n_years)
    payback = payback_period(out_n["cf"])

    # --- forward run with a battery at the fixed ratio ---
    batt_kw, batt_kwh = dispatch_ops.batt_size_from_pv(kw_star)
    rt_eff = (torch.full((n,), dispatch_ops.DEFAULT_RT_EFF, dtype=torch.float32,
                         device=kw_star.device)
              if env.batt_rt_eff is None else env.batt_rt_eff)
    # float32 dispatch whatever the banks (the state-of-charge recursion
    # compounds rounding over 8760 steps)
    load_f32 = env.load.float()
    dr = dispatch_ops.dispatch_battery(load_f32, gen_n.float(), batt_kw, batt_kwh,
                                       rt_eff)
    # battery capex enters the cost basis at 0.7x for the ITC treatment
    batt_cost = env.batt_capex_per_kwh_combined * batt_kwh * 0.7
    cost_w = (env.system_capex_per_kw_combined * kw_star + batt_cost) \
        * env.cap_cost_multiplier + otc_star
    out_w = _npv_given_system_out(env, kw_star, dr.system_out, cost_w,
                                  env.value_of_resiliency_usd, n_periods, n_years)

    annual_kwh = gen_n.sum(dim=1)
    naep_final = annual_kwh / torch.clamp_min(kw_star, 1e-9)
    if keep_hourly:
        baseline_net, net_pvonly, net_with_batt = net_hourly_profiles(
            load_f32, gen_n, dr.system_out)
    else:
        baseline_net = net_pvonly = net_with_batt = torch.zeros(
            (n, 0), dtype=torch.float32, device=kw_star.device)

    return SizingResult(
        system_kw=kw_star,
        npv=out_n["npv"],
        payback_period=payback,
        cash_flow=out_n["cf"],
        naep=naep_final,
        annual_energy_production_kwh=annual_kwh,
        capacity_factor=naep_final / 8760.0,
        first_year_bill_with_system=out_n["bills_w"][:, 0],
        first_year_bill_without_system=out_n["bills_wo"][:, 0],
        batt_kw=batt_kw,
        batt_kwh=batt_kwh,
        first_year_bill_with_batt=out_w["bills_w"][:, 0],
        energy_value_pv_only=out_n["energy_value"],
        energy_value_pv_batt=out_w["energy_value"],
        baseline_net_hourly=baseline_net,
        adopter_net_hourly_pvonly=net_pvonly,
        adopter_net_hourly_with_batt=net_with_batt,
    )


def oracle_chunk_rows(n_years: int) -> int:
    """Agent rows of one chunk of the per-agent oracle: as many as keep
    its ``[rows, n_years, 8760]`` float32 temporaries (ORACLE_TEMPS live
    at once) within ORACLE_BYTES."""
    return max(1, ORACLE_BYTES // (ORACLE_TEMPS * n_years * HOURS * 4))


def _size_oracle(envs: AgentEconInputs, n_periods: int, n_years: int, n_iters: int,
                 keep_hourly: bool) -> SizingResult:
    """:func:`size_one_agent` over the table, chunk by chunk of
    :func:`oracle_chunk_rows` rows, the results written in table order."""
    n = envs.load.shape[0]
    chunk = oracle_chunk_rows(n_years)
    if n <= chunk:
        return size_one_agent(envs, n_periods, n_years, n_iters, keep_hourly)
    out = None
    for r0 in range(0, n, chunk):
        rows = slice(r0, min(n, r0 + chunk))
        res = size_one_agent(tree_map(lambda t: t[rows], envs), n_periods, n_years,
                             n_iters, keep_hourly)
        if out is None:
            out = tree_map(lambda t: t.new_empty((n,) + t.shape[1:]), res)
        tree_map(lambda o, t: o[rows].copy_(t), out, res)
    return out


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
    fast: bool = True,
    soft_tau: Optional[float] = None,
) -> SizingResult:
    """Size every agent of the table (leading axis).

    ``fast=True`` (default) runs the table-level bucket-sums path: the
    kernels on a card, their plain versions on the CPU (``impl`` picks
    the engine, ``billkernels.IMPLS`` or ``"plain"``). ``fast=False`` runs
    the per-agent oracle (:func:`size_one_agent`, chunked; ~100x the
    memory traffic), which takes neither int8 banks nor ``soft_tau``.

    ``net_billing=False`` asserts that no agent prices on a net-billing
    tariff, so search-round bills reduce to the linear NEM identity and
    no bucket-sums kernel runs in the rounds. ``daylight``: the refine
    rounds' import sums run on the layout's compacted lanes (padded to
    uniform segments under the stream engine, as the JAX package pads
    them). ``pack_once``: one :func:`billkernels.pack_streams` feeds both
    rounds, and the battery run too when its lanes match (full-hour, one
    tariff structure). ``soft_tau``: the differentiable twin (soft
    import/export splits, tier clips and straight-through switch gates
    in the search objective, an unrounded payback), on plain float32
    full-hour streams."""
    if envs.load_scale is not None and not fast:
        raise ValueError(
            "int8 quantized banks (AgentEconInputs.load_scale) are a fast-path "
            "representation; the per-agent oracle prices full-precision streams "
            "- dequantize or use fast=True")
    if soft_tau is not None and not fast:
        raise ValueError(
            "soft_tau is a fast-path knob; the per-agent oracle stays the exact "
            "hard reference (use fast=True, or make_npv_objective for a "
            "differentiable per-size objective)")
    envs = _fill_env_defaults(envs)
    if not fast:
        return _size_oracle(envs, n_periods, n_years, n_iters, keep_hourly)
    return _size_agents_fast(envs, n_periods, n_years, n_iters, keep_hourly,
                             net_billing, impl, daylight, pack_once, soft_tau)


# ---------------------------------------------------------------------------
# The differentiable objective
# ---------------------------------------------------------------------------

def make_npv_objective(envs: AgentEconInputs, n_periods: int, n_years: int, *,
                       net_billing: bool = True, soft_tau: Optional[float] = None,
                       impl: str = bk.PLAIN):
    """The batched sizing objective that :mod:`dgen_tpu_torch.grad.newton`
    climbs: ``(npv_fn, lo, hi)``, where ``npv_fn(kw)`` maps per-agent
    sizes ``[N]`` (or a candidate grid ``[N, K]``) to NPV of the same
    shape and ``[lo, hi]`` is each agent's sizing bracket.

    The per-agent prologue (the linear bill structure, the no-system
    bills, the price and degradation factors) is computed once here, so
    an evaluation costs one bucket-sums call of R = K x Y scales (none
    for an all-NEM population). With ``soft_tau`` every boundary in the
    objective is a smooth surrogate or a straight-through gate, so
    autograd sees a usable derivative everywhere; with ``None`` it is the
    grid search's piecewise-smooth objective.

    ``impl`` keeps the JAX package's meaning: ``"plain"`` (default, JAX's
    ``"xla"``) sums with :func:`billkernels.plain_sums`, differentiable on
    any device; a kernel engine (``billkernels.IMPLS``) runs the kernels,
    forward only (an input that requires grad makes them raise). int8
    banks are refused: dequantize first."""
    if envs.load_scale is not None:
        raise ValueError(
            "make_npv_objective prices full-precision streams; dequantize the "
            "banks first (quant_banks is incompatible with the differentiable "
            "objective)")
    envs = _fill_env_defaults(envs)
    n = envs.load.shape[0]
    dev = envs.load.device

    naep = envs.gen_per_kw.float().sum(dim=1)                      # [N]
    max_system = envs.load_kwh_per_customer / torch.clamp_min(naep, 1e-9)
    lo = max_system * SIZE_LO_FRAC
    hi = torch.minimum(max_system * SIZE_HI_FRAC, envs.nem_kw_cap)
    lo = torch.minimum(lo, hi)

    n_buckets = 12 * n_periods
    has_switch = envs.tariff_w is not None
    tw = envs.tariff if not has_switch else envs.tariff_w
    bucket = bk.hourly_bucket_ids(tw.hour_period, n_periods)
    sell = bk.sell_rate_hourly(tw, envs.ts_sell)
    gen_shape = float32_streams(envs.load, envs.gen_per_kw)[0]

    yr = torch.arange(n_years, dtype=torch.float32, device=dev)[None, :]
    pf = ((1.0 + envs.fin.inflation_rate[:, None])
          * (1.0 + envs.elec_price_escalator[:, None])) ** yr      # [N, Y]
    df = (1.0 - envs.pv_degradation[:, None]) ** yr                # [N, Y]

    lin = bk.linear_sums(envs.load, gen_shape, sell, tw.hour_period, n_periods)
    zeros1 = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    if not has_switch:
        lin_wo, sell_wo, bucket_wo = lin, sell, bucket
    else:
        sell_wo = bk.sell_rate_hourly(envs.tariff, envs.ts_sell)
        lin_wo = bk.linear_sums(envs.load, gen_shape, sell_wo,
                                envs.tariff.hour_period, n_periods)
        bucket_wo = bk.hourly_bucket_ids(envs.tariff.hour_period, n_periods)
    imp0 = lin_wo[0][:, None, :]
    bills_wo = bk.bills_linear_nb(
        lin_wo, imp0, lin_wo[2][:, None], zeros1, envs.tariff, n_periods, soft_tau,
    )[:, 0:1] * pf                                                 # [N, Y]

    def npv_fn(kw: torch.Tensor) -> torch.Tensor:
        squeeze = kw.ndim == 1
        kw2 = kw[:, None] if squeeze else kw                       # [N, K]
        kk = kw2.shape[1]
        scales = (kw2[:, :, None] * df[:, None, :]).reshape(n, kk * n_years)
        if not net_billing:
            bills_sw = bk.bills_linear_nem(lin, scales, tw, n_periods, soft_tau)
            bills_o = (bk.bills_linear_nem(lin_wo, scales, envs.tariff, n_periods,
                                           soft_tau) if has_switch else None)
        elif not has_switch:
            imports, imp_sell = bk.import_sums(envs.load, gen_shape, sell, bucket,
                                               scales, n_buckets, impl,
                                               soft_tau=soft_tau)
            bills_sw = bk.bills_linear_nb(lin, imports, imp_sell, scales, tw,
                                          n_periods, soft_tau)
            bills_o = None
        else:
            imports, imp_sell, imports_o, imp_sell_o = bk.import_sums_pair(
                envs.load, gen_shape, sell, bucket, sell_wo, bucket_wo, scales,
                n_buckets, impl, soft_tau=soft_tau)
            bills_sw = bk.bills_linear_nb(lin, imports, imp_sell, scales, tw,
                                          n_periods, soft_tau)
            bills_o = bk.bills_linear_nb(lin_wo, imports_o, imp_sell_o, scales,
                                         envs.tariff, n_periods, soft_tau)
        if has_switch:
            w = _switch_weight(envs, kw2, soft_tau).repeat_interleave(n_years, dim=1)
            bills = w * bills_sw + (1.0 - w) * bills_o
        else:
            bills = bills_sw
        bills = bills.reshape(n, kk, n_years) * pf[:, None, :]     # [N, K, Y]

        ev = (bills_wo[:, None, :] - bills).reshape(n * kk, n_years)
        kw_f = kw2.reshape(n * kk)

        def rep(x):
            return x.repeat_interleave(kk, dim=0)

        otc = _switch_weight(envs, kw2, soft_tau).reshape(n * kk) * rep(
            envs.one_time_charge)
        cost = rep(envs.system_capex_per_kw) * kw_f * rep(envs.cap_cost_multiplier) + otc
        out = cashflow(
            ev, cost, tree_map(rep, envs.fin), n_years, system_kw=kw_f,
            annual_kwh=kw_f * INV_EFF * rep(naep),
            degradation=rep(envs.pv_degradation), inc=tree_map(rep, envs.inc),
        )
        npv = out["npv"].reshape(n, kk)
        return npv[:, 0] if squeeze else npv

    return npv_fn, lo, hi
