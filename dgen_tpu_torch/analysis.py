"""Post-run analysis passes that the sizing hot loop skips (port of
``dgen_tpu/analysis.py``).

The reference leaves demand charges out of its adoption loop but can
price them; :func:`demand_charge_audit` prices them per agent over the
baseline, PV-only and PV+battery net loads of a run's sized outputs, for
tariffs whose specs carry ``"demand"`` structures.
:func:`dispatch_diagnostics` is the table-level form of the reference's
per-agent dispatch printout (``dispatch_export_diags``): midday surplus
capture, energy routing totals, power- against energy-bound hours and
sell-rate revenue, and :func:`summarize_dispatch` its population roll-up.

Inputs and outputs lie on whatever device the table does; the battery
dispatch runs through :func:`dispatch_ops.dispatch_battery` (the kernel
on a card).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dgen_tpu_torch.models.agents import AgentTable, ProfileBank
from dgen_tpu_torch.ops import demand as demand_ops
from dgen_tpu_torch.ops import dispatch as dispatch_ops
from dgen_tpu_torch.ops.sizing import INV_EFF, net_hourly_profiles
from dgen_tpu_torch.tree import tree_map


def demand_charge_audit(
    table: AgentTable,
    profiles: ProfileBank,
    tariff_specs: Sequence[dict],
    load_kwh_per_customer: torch.Tensor,
    system_kw: Optional[torch.Tensor] = None,
    batt_kw: Optional[torch.Tensor] = None,
    batt_kwh: Optional[torch.Tensor] = None,
    batt_rt_eff: Optional[torch.Tensor] = None,
) -> Optional[Dict[str, torch.Tensor]]:
    """Annual demand charges ($/customer-year) per agent:
    ``{"baseline": [N], "pv_only": [N], "with_batt": [N]}`` (the last two
    only when sizes are given; a tariff without demand charges prices 0;
    padding rows 0), or None when no tariff of the corpus carries demand
    charges. The net loads are rebuilt as the sizing's hourly outputs
    (:func:`net_hourly_profiles`), so the audit prices the profiles the
    model aggregated."""
    dev = table.mask.device
    bank = demand_ops.compile_demand_bank([s.get("demand") for s in tariff_specs],
                                          device=dev)
    if bank is None:
        return None
    at = tree_map(lambda x: x[table.tariff_idx.long()], bank)
    load = profiles.load[table.load_idx.long()] * load_kwh_per_customer[:, None]
    charge = demand_ops.annual_demand_charge

    out: Dict[str, torch.Tensor] = {"baseline": charge(load, at) * table.mask}
    if system_kw is None:
        return out
    gen = profiles.solar_cf[table.cf_idx.long()] * (system_kw * INV_EFF)[:, None]
    _, pv_net, _ = net_hourly_profiles(load, gen, gen)
    out["pv_only"] = charge(pv_net, at) * table.mask
    if batt_kw is not None and batt_kwh is not None:
        rt = (torch.full((table.n_agents,), dispatch_ops.DEFAULT_RT_EFF,
                         dtype=torch.float32, device=dev)
              if batt_rt_eff is None else batt_rt_eff)
        dr = dispatch_ops.dispatch_battery(load, gen, batt_kw, batt_kwh, rt)
        _, _, batt_net = net_hourly_profiles(load, gen, dr.system_out)
        out["with_batt"] = charge(batt_net, at) * table.mask
    return out


def dispatch_diagnostics(
    load: torch.Tensor,            # [N, 8760] kWh/h
    gen: torch.Tensor,             # [N, 8760] PV output kWh/h
    dr,                            # DispatchResult (leaves [N, 8760])
    sell: torch.Tensor,            # [N, 8760] $/kWh sell rate
    buy: Optional[torch.Tensor] = None,   # [N, 8760] $/kWh buy rate
    batt_kw: Optional[torch.Tensor] = None,
    midday_hours: tuple = (11, 15),
    night_eps: float = 1e-6,
) -> Dict[str, torch.Tensor]:
    """Per-agent dispatch and export diagnostics, every value ``[N]``:
    midday PV-surplus capture, energy routing totals (PV -> battery, PV
    -> grid, PV -> load, battery -> load), hours the battery left surplus
    unabsorbed because it hit its power cap or ran out of headroom,
    day/night sell-rate means, export revenue and, with ``buy``, avoided
    retail spend. The greedy self-consumption dispatch never routes
    battery -> grid or grid -> battery, so those columns are omitted.
    ``batt_kw`` defaults to the observed maximum of the charge trace and
    only sets the power-bound threshold."""
    hod = torch.arange(load.shape[1], device=load.device) % 24
    midday = (hod >= midday_hours[0]) & (hod <= midday_hours[1])
    night = gen < night_eps                                   # [N, H]

    surplus = torch.clamp_min(gen - load, 0.0)
    s2b = dr.charge                                           # PV -> batt
    b2l = dr.discharge                                        # batt -> load
    # meter-level exports of the battery-modified system output
    s2g = torch.clamp_min(dr.system_out - load, 0.0)
    s2l = torch.clamp_min(torch.minimum(gen - s2b, load), 0.0)  # PV direct

    def msum(x, m):
        return (x * (m[None, :] if m.ndim == 1 else m)).sum(dim=1)

    def count(x, m=None):
        return (x if m is None else x & m[None, :]).sum(dim=1).to(torch.int32)

    def tot(x):
        return x.sum(dim=1)

    surplus_mid = msum(surplus, midday)
    s2b_mid = msum(s2b, midday)
    capture_mid = torch.where(surplus_mid > 1e-9, s2b_mid / surplus_mid, 0.0)

    # bottlenecks: hours whose surplus the battery did not fully absorb,
    # split by cause: the charge trace at the power cap, or otherwise the
    # energy headroom spent
    if batt_kw is None:
        batt_kw = s2b.amax(dim=1)                             # observed cap
    unabsorbed = (surplus - s2b) > 1e-6
    power_bound = unabsorbed & (s2b >= batt_kw[:, None] * (1 - 1e-5))
    soc_bound = unabsorbed & ~power_bound
    day = ~night
    n_day = torch.clamp_min(day.sum(dim=1), 1)
    n_night = torch.clamp_min(night.sum(dim=1), 1)

    out: Dict[str, torch.Tensor] = {
        "surplus_total_kwh": tot(surplus),
        "surplus_mid_kwh": surplus_mid,
        "pv_to_batt_total_kwh": tot(s2b),
        "pv_to_batt_mid_kwh": s2b_mid,
        "pv_to_grid_total_kwh": tot(s2g),
        "pv_to_grid_mid_kwh": msum(s2g, midday),
        "pv_direct_to_load_total_kwh": tot(s2l),
        "batt_to_load_kwh": tot(b2l),
        "capture_mid_frac": capture_mid,
        "power_bound_hours": count(power_bound),
        "soc_bound_hours": count(soc_bound),
        "power_bound_mid_hours": count(power_bound, midday),
        "soc_bound_mid_hours": count(soc_bound, midday),
        "sell_mean_day": msum(sell, day) / n_day,
        "sell_mean_night": msum(sell, night) / n_night,
        "pv_export_revenue_usd": tot(s2g * sell),
        "pv_export_revenue_mid_usd": msum(s2g * sell, midday),
    }
    if buy is not None:
        out["avoided_pv_self_usd"] = tot(s2l * buy)
        out["avoided_batt_self_usd"] = tot(b2l * buy)
    return out


def summarize_dispatch(diags: Dict[str, torch.Tensor], mask) -> Dict[str, float]:
    """Population roll-up of :func:`dispatch_diagnostics` on the host:
    kWh, $ and hour fields sum over real agents (``mask > 0``); the
    capture fraction is surplus-weighted, the rates agent means."""
    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    m = host(mask) > 0
    d = {k: host(v)[m] for k, v in diags.items()}
    w = d["surplus_mid_kwh"]
    out = {}
    for k, v in d.items():
        if k.endswith("_kwh") or k.endswith("_usd") or "hours" in k:
            out[k] = float(v.sum())
        elif k == "capture_mid_frac":
            out[k] = float((v * w).sum() / max(w.sum(), 1e-9))
        else:
            out[k] = float(v.mean())
    return out
