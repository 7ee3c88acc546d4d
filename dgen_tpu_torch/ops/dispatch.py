"""Behind-the-meter battery dispatch (port of ``dgen_tpu/ops/dispatch.py``,
its sequential ``impl="scan"``).

Greedy self-consumption: per hour, charge from PV surplus only (up to
power and headroom limits), discharge to unmet load only (up to power
and available energy). The JAX ``lax.scan`` over hours becomes a Python
loop over ``[N]`` tensors; the parts of each step that do not depend on
the state of charge are computed for all hours before the loop.
"""

from __future__ import annotations

import dataclasses

import torch

# battery energy = PV kW / 0.8 (kWh), power = energy / 2 (kW)
PV_TO_BATT_RATIO = 0.8
BATT_CAPACITY_TO_POWER_RATIO = 2.0
SOC_MIN_FRAC = 0.10
SOC_INIT_FRAC = 0.30
#: round-trip efficiency when no trajectory is supplied
DEFAULT_RT_EFF = 0.9216


def batt_size_from_pv(system_kw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(batt_kw, batt_kwh) at the fixed PV ratio."""
    batt_kwh = system_kw / PV_TO_BATT_RATIO
    batt_kw = batt_kwh / BATT_CAPACITY_TO_POWER_RATIO
    return batt_kw, batt_kwh


@dataclasses.dataclass(frozen=True)
class DispatchResult:
    system_out: torch.Tensor   # [N, 8760] net system output at the meter
    soc: torch.Tensor          # [N, 8760] state of charge after each hour
    charge: torch.Tensor       # [N, 8760] PV -> battery
    discharge: torch.Tensor    # [N, 8760] battery -> load


def dispatch_battery(load: torch.Tensor, gen: torch.Tensor, batt_kw: torch.Tensor,
                     batt_kwh: torch.Tensor, rt_eff: torch.Tensor) -> DispatchResult:
    """Dispatch ``[N, 8760]`` load/generation through batteries of
    ``batt_kw`` / ``batt_kwh`` ``[N]`` with round-trip efficiency
    ``rt_eff`` ``[N]`` (split evenly into one-way efficiencies).
    ``system_out = gen - charge + discharge`` is what the bill engine
    prices as the system's meter contribution."""
    soc_min = batt_kwh * SOC_MIN_FRAC
    soc = batt_kwh * SOC_INIT_FRAC
    eta = torch.sqrt(rt_eff.to(torch.float32))

    # hour-major so each step reads and writes one contiguous row
    surplus = torch.minimum(torch.clamp_min(gen - load, 0.0), batt_kw[:, None]).T.contiguous()
    deficit = torch.minimum(torch.clamp_min(load - gen, 0.0), batt_kw[:, None]).T.contiguous()
    hours = load.shape[1]
    soc_h = torch.empty_like(surplus)
    charge_h = torch.empty_like(surplus)
    discharge_h = torch.empty_like(surplus)
    for t in range(hours):
        charge = torch.minimum(surplus[t], torch.clamp_min(batt_kwh - soc, 0.0) / eta,
                               out=charge_h[t])
        discharge = torch.minimum(deficit[t], torch.clamp_min(soc - soc_min, 0.0) * eta,
                                  out=discharge_h[t])
        soc = torch.sub(soc + charge * eta, discharge / eta, out=soc_h[t])
    charge = charge_h.T
    discharge = discharge_h.T
    system_out = (gen - charge + discharge).contiguous()
    return DispatchResult(system_out=system_out, soc=soc_h.T, charge=charge,
                          discharge=discharge)
