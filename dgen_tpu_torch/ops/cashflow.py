"""Multi-year levered cashflow -> NPV / payback (port of
``dgen_tpu/ops/cashflow.py``).

The JAX functions take one agent and are vmapped over the table; here
every function takes a batch: each leaf of :class:`FinanceParams` is
``[B]`` (``deprec_sch`` ``[B, D]``), each leaf of
:class:`IncentiveParams` is ``[B, 2]``, and year axes are trailing.
Host-owned systems, loan or cash purchase, federal ITC, fed + state
income tax with MACRS-5 depreciation for non-residential agents,
CBI/IBI/PBI incentives, and the bill-savings energy value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgen_tpu_torch.config import PAYBACK_NEVER

#: MACRS 5-year half-year-convention schedule
MACRS_5 = np.array([0.20, 0.32, 0.192, 0.1152, 0.1152, 0.0576], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class FinanceParams:
    """Per-agent financing terms, leaves ``[B]``. ``tax_rate`` splits
    70/30 federal/state."""

    down_payment_fraction: torch.Tensor
    loan_interest_rate: torch.Tensor
    loan_term_yrs: torch.Tensor        # int32
    real_discount_rate: torch.Tensor
    inflation_rate: torch.Tensor
    tax_rate: torch.Tensor
    itc_fraction: torch.Tensor
    #: 1.0 for non-res agents (depreciation + deductible interest)
    is_commercial: torch.Tensor
    #: annual O&M $ (year-1 dollars, inflates)
    om_per_year: torch.Tensor
    #: [B, D] depreciation schedule fractions; None = MACRS-5
    deprec_sch: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class IncentiveParams:
    """Compiled state incentives, leaves ``[B, 2]`` (the top two rows)."""

    cbi_usd_p_w: torch.Tensor      # $/W capacity-based
    cbi_max_usd: torch.Tensor
    ibi_frac: torch.Tensor         # fraction of installed cost
    ibi_max_usd: torch.Tensor
    pbi_usd_p_kwh: torch.Tensor    # $/kWh production-based
    pbi_years: torch.Tensor        # int32 duration
    #: 1.0 = the PBI rate decays linearly to zero over its duration
    pbi_decay: torch.Tensor

    @staticmethod
    def zeros(n: int, device) -> "IncentiveParams":
        z2 = torch.zeros((n, 2), dtype=torch.float32, device=device)
        return IncentiveParams(
            cbi_usd_p_w=z2, cbi_max_usd=z2, ibi_frac=z2, ibi_max_usd=z2,
            pbi_usd_p_kwh=z2,
            pbi_years=torch.zeros((n, 2), dtype=torch.int32, device=device),
            pbi_decay=z2,
        )


def nominal_discount_rate(real: torch.Tensor, inflation: torch.Tensor) -> torch.Tensor:
    return (1.0 + real) * (1.0 + inflation) - 1.0


def _years(n_years: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n_years, dtype=torch.float32, device=like.device)


def loan_schedule(principal: torch.Tensor, rate: torch.Tensor, term: torch.Tensor,
                  n_years: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(payment [B, Y], interest [B, Y]) of a level-payment amortizing
    loan over ``term`` years, in closed form: the start-of-year balance
    is ``P*(1+r)^t - pmt*((1+r)^t - 1)/r``."""
    term_f = term.to(torch.float32)[:, None]
    r = rate[:, None]
    p = principal[:, None]
    y = _years(n_years, principal)[None, :]
    active = (y < term_f).to(torch.float32)

    small_r = r <= 1e-9
    r_safe = torch.where(small_r, torch.ones_like(r), r)
    annuity = torch.where(
        small_r,
        1.0 / torch.clamp_min(term_f, 1.0),
        r_safe / (1.0 - (1.0 + r_safe) ** (-term_f)),
    )
    pmt = p * annuity

    growth = (1.0 + r) ** y
    balance_start = torch.where(
        small_r,
        p - pmt * y,
        p * growth - pmt * (growth - 1.0) / r_safe,
    )
    interests = balance_start * r * active
    payments = pmt * active
    return payments, interests


def incentive_cashflows(
    inc: IncentiveParams,
    system_kw: torch.Tensor,
    installed_cost: torch.Tensor,
    annual_kwh: torch.Tensor,
    degradation: torch.Tensor,
    n_years: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(upfront $ [B], pbi stream [B, Y]): CBI and IBI clamped to their
    maxima; PBI pays $/kWh of degraded production for its duration,
    flat or decaying linearly to zero."""
    cbi = torch.minimum(inc.cbi_usd_p_w * system_kw[:, None] * 1000.0,
                        inc.cbi_max_usd).sum(dim=1)
    ibi = torch.minimum(inc.ibi_frac * installed_cost[:, None],
                        inc.ibi_max_usd).sum(dim=1)

    y = _years(n_years, system_kw)
    prod = annual_kwh[:, None] * (1.0 - degradation[:, None]) ** y[None, :]  # [B, Y]
    dur = inc.pbi_years.to(torch.float32)[:, :, None]                        # [B, 2, 1]
    active = (y[None, None, :] < dur).to(torch.float32)                      # [B, 2, Y]
    rate = inc.pbi_usd_p_kwh[:, :, None]
    ts = y[None, None, :] + 1.0
    decay_f = torch.clamp(1.0 - ts / torch.clamp_min(dur, 1.0), 0.0, 1.0)
    rate = rate * torch.where(inc.pbi_decay[:, :, None] > 0, decay_f,
                              torch.ones_like(decay_f))
    pbi = (rate * prod[:, None, :] * active).sum(dim=1)
    return cbi + ibi, pbi


def cashflow(
    energy_value: torch.Tensor,
    installed_cost: torch.Tensor,
    fin: FinanceParams,
    n_years: int,
    system_kw: Optional[torch.Tensor] = None,
    annual_kwh: Optional[torch.Tensor] = None,
    degradation: Optional[torch.Tensor] = None,
    inc: Optional[IncentiveParams] = None,
) -> dict:
    """After-tax levered cashflow for a batch of agents.

    ``energy_value`` [B, Y] nominal bill savings, ``installed_cost``
    [B] total upfront $. Returns ``cf`` [B, Y+1] (year 0 = -equity),
    ``npv`` [B] (nominal discounting) and the loan/tax components.
    """
    b = installed_cost.shape[0]
    zero = torch.zeros(b, dtype=torch.float32, device=installed_cost.device)
    system_kw = zero if system_kw is None else system_kw
    annual_kwh = zero if annual_kwh is None else annual_kwh
    degradation = zero if degradation is None else degradation
    inc = IncentiveParams.zeros(b, installed_cost.device) if inc is None else inc

    down = installed_cost * fin.down_payment_fraction
    principal = installed_cost - down
    payments, interests = loan_schedule(
        principal, fin.loan_interest_rate, fin.loan_term_yrs, n_years
    )

    fed_rate = fin.tax_rate * 0.7
    sta_rate = fin.tax_rate * 0.3
    # combined marginal rate, state tax deductible from federal
    tax_eff = fed_rate + sta_rate - fed_rate * sta_rate

    itc = fin.itc_fraction * installed_cost
    year1 = (torch.arange(n_years, device=installed_cost.device) == 0).to(torch.float32)

    # depreciation for commercial agents, basis reduced by half the ITC
    if fin.deprec_sch is None:
        sch = torch.as_tensor(MACRS_5, device=installed_cost.device)[None, :].expand(b, -1)
    else:
        sch = fin.deprec_sch
    basis = installed_cost * (1.0 - 0.5 * fin.itc_fraction)
    d = min(sch.shape[-1], n_years)
    depr = torch.zeros((b, n_years), dtype=torch.float32, device=installed_cost.device)
    depr[:, :d] = sch[:, :d] * basis[:, None]
    depr_savings = depr * tax_eff[:, None] * fin.is_commercial[:, None]
    interest_savings = interests * tax_eff[:, None] * fin.is_commercial[:, None]

    upfront_inc, pbi = incentive_cashflows(
        inc, system_kw, installed_cost, annual_kwh, degradation, n_years
    )

    y = _years(n_years, installed_cost)
    om = fin.om_per_year[:, None] * (1.0 + fin.inflation_rate[:, None]) ** y[None, :]

    cf_years = (
        energy_value
        - payments
        - om
        + interest_savings
        + depr_savings
        + itc[:, None] * year1
        + upfront_inc[:, None] * year1
        + pbi
    )
    cf0 = -down
    cf = torch.cat([cf0[:, None], cf_years], dim=1)

    dnom = nominal_discount_rate(fin.real_discount_rate, fin.inflation_rate)
    ex = -torch.arange(n_years + 1, dtype=torch.float32, device=installed_cost.device)
    disc = (1.0 + dnom[:, None]) ** ex[None, :]
    npv = (cf * disc).sum(dim=1)

    return {
        "cf": cf,
        "npv": npv,
        "payments": payments,
        "interest": interests,
        "itc": itc,
        "depreciation": depr * fin.is_commercial[:, None],
    }


def payback_period(cf: torch.Tensor, soft: bool = False) -> torch.Tensor:
    """[B] fractional payback year from [B, Y+1] cashflows: the LAST
    negative-to-positive crossing of the cumulative cashflow, linearly
    interpolated within that year; ``PAYBACK_NEVER`` if it never turns
    positive, 0 if positive from year 0; rounded to 0.1.

    ``soft=True`` (the differentiable twin) skips the rounding: the
    crossing year is a piecewise-constant selection (no gradient, on
    purpose) and the within-year interpolation is smooth in the
    cashflow, which is all a gradient needs."""
    cum = torch.cumsum(cf, dim=1)
    n = cf.shape[1] - 1

    no_payback = (cum[:, -1] <= 0.0) | torch.all(cum <= 0.0, dim=1)
    instant = torch.all(cum > 0.0, dim=1)

    crossed = torch.diff(torch.sign(cum), dim=1) > 0              # [B, n]
    # argmax returns the FIRST maximum on every device
    last = torch.argmax(crossed.flip(1).to(torch.int32), dim=1)
    bi = (n - 1) - last
    bi = torch.where(crossed.any(dim=1), bi, torch.full_like(bi, n - 1))
    base_year = bi.to(torch.float32)
    base_val = cum.gather(1, bi[:, None])[:, 0]
    next_val = cum.gather(1, (bi + 1)[:, None])[:, 0]
    frac = base_val / (base_val - next_val + 1e-9)
    pp = base_year + frac
    pp = torch.where(
        no_payback, torch.full_like(pp, PAYBACK_NEVER),
        torch.where(instant, torch.zeros_like(pp), pp),
    )
    if soft:
        return pp
    return torch.round(pp * 10.0) / 10.0
