"""Utility-bill engine (port of ``dgen_tpu/ops/bill.py``).

The JAX functions take one agent and are vmapped; here they take the
batch: streams are ``[N, 8760]`` and an :class:`AgentTariff` holds the
gathered per-agent tariff leaves. TOU energy charges with monthly tier
accumulation, monthly fixed charges, net metering (signed monthly
netting, negative sums credited at the period's tier-1 price) and net
billing (imports billed, exports credited hourly at a sell rate), and
the analysis period's bill series. Demand charges are absent, as in the
reference's hot loop (:mod:`dgen_tpu_torch.ops.demand` prices them for
analysis runs). Every reduction is a row-wise sum, so a row's bill does
not depend on how many rows share the call.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dgen_tpu_torch.grad.smooth import clip0_t, min0_t, relu_t
from dgen_tpu_torch.ops.tariff import (
    MONTH_HOURS, MONTHS, NET_BILLING, TariffBank, hour_month_map,
)


@functools.lru_cache(maxsize=None)
def hour_month(device: torch.device) -> torch.Tensor:
    """[8760] int32 hour -> month map on ``device`` (one copy per device)."""
    return torch.from_numpy(hour_month_map()).to(device)


class AgentTariff(NamedTuple):
    """Per-agent tariff leaves gathered from a :class:`TariffBank`."""

    price: torch.Tensor        # [N, P, T]
    tier_cap: torch.Tensor     # [N, T]
    sell_price: torch.Tensor   # [N, P]
    hour_period: torch.Tensor  # [N, 8760] int32
    fixed_monthly: torch.Tensor  # [N]
    metering: torch.Tensor     # [N] int32


def gather_tariff(bank: TariffBank, tariff_idx: torch.Tensor) -> AgentTariff:
    """Index the bank for every agent of ``tariff_idx``."""
    idx = tariff_idx.long()
    return AgentTariff(
        price=bank.price[idx],
        tier_cap=bank.tier_cap[idx],
        sell_price=bank.sell_price[idx],
        hour_period=bank.hour_period[idx],
        fixed_monthly=bank.fixed_monthly[idx],
        metering=bank.metering[idx],
    )


def select_by_period(hour_period: torch.Tensor, per_period: torch.Tensor,
                     default: torch.Tensor) -> torch.Tensor:
    """Expand per-TOU-period values ``[N, P]`` onto the hour axis by a
    compare/select loop over the (small) period axis."""
    out = torch.zeros_like(default)
    for p in range(per_period.shape[-1]):
        out = torch.where(hour_period == p, per_period[..., p:p + 1], out)
    return out


def monthly_period_sums(x: torch.Tensor, hour_period: torch.Tensor,
                        n_periods: int) -> torch.Tensor:
    """Sum ``[..., 8760]`` series into ``[..., 12, P]`` month x TOU-period
    buckets: per period, the masked series summed over each month's
    hours. ``hour_period`` broadcasts against ``x``.

    Row-wise sums, not a product with a month one-hot: on a card the
    library picks a matrix product's algorithm by the row count, so a
    row's sums would depend on how many rows share the call (the
    streaming year step sizes a chunk of the rows the whole-table step
    sizes at once)."""
    months = list(zip(MONTH_HOURS[:-1].tolist(), MONTH_HOURS[1:].tolist()))
    per_period = []
    for p in range(n_periods):
        xp = x * (hour_period == p).to(x.dtype)
        per_period.append(torch.stack([xp[..., a:b].sum(dim=-1) for a, b in months],
                                      dim=-1))
    return torch.stack(per_period, dim=-1)




def _per_row(t: torch.Tensor, extra: int) -> torch.Tensor:
    """A per-agent leaf ``[N, ...]`` viewed as ``[N, 1 x extra, ...]``, so
    it broadcasts against a batch ``[N, *B, ...]`` of ``extra`` axes."""
    return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])


def tiered_charge(sums: torch.Tensor, price: torch.Tensor, tier_cap: torch.Tensor,
                  soft_tau: float | None = None) -> torch.Tensor:
    """Cumulative tiered energy charge ``[N, *B, 12]`` of monthly sums
    ``[N, *B, 12, P]`` (kWh, negative under net metering) on per-agent
    ``price`` ``[N, P, T]`` and ``tier_cap`` ``[N, T]``: positive energy is
    charged tier by tier against the monthly caps, negative energy is
    credited at the period's tier-1 price.

    A loop over the tiers with row-wise sums over the period axis, never a
    library product (whose algorithm, picked by the row count, would make
    a row's charge depend on how many rows share the call). ``soft_tau``
    (kWh) smooths the tier-edge clips (:mod:`dgen_tpu_torch.grad.smooth`);
    ``None`` is the exact hard clip."""
    extra = sums.dim() - 3
    lower = torch.cat([torch.zeros_like(tier_cap[:, :1]), tier_cap[:, :-1]], dim=1)
    width = tier_cap - lower                                   # [N, T]
    if soft_tau is None:
        def seg_fn(x, w):
            return torch.minimum(torch.clamp_min(x, 0.0), w)

        neg = torch.clamp_max(sums, 0.0)
    else:
        def seg_fn(x, w):
            return clip0_t(x, w, soft_tau)

        neg = min0_t(sums, soft_tau)

    def per_month(t):            # [N] -> [N, 1 x B, 1, 1]
        return _per_row(t, extra)[..., None, None]

    def per_period(t):           # [N, P] -> [N, 1 x B, 1, P]
        return _per_row(t, extra)[..., None, :]

    total = torch.zeros(sums.shape[:-1], dtype=sums.dtype, device=sums.device)
    for t in range(price.shape[-1]):
        seg = seg_fn(sums - per_month(lower[:, t]), per_month(width[:, t]))
        total = total + (seg * per_period(price[:, :, t])).sum(dim=-1)
    return total + (neg * per_period(price[:, :, 0])).sum(dim=-1)


def annual_bill(net_load: torch.Tensor, tariff: AgentTariff,
                ts_sell: torch.Tensor, n_periods: int,
                soft_tau: float | None = None) -> torch.Tensor:
    """Annual bills ``[N, *B]`` from signed hourly net grid loads
    ``[N, *B, 8760]`` (positive = import; ``B`` extra batch axes, such as
    the analysis years of :func:`bill_series`) on the per-agent tariff
    leaves ``[N, ...]``. Both metering styles are evaluated and selected
    per agent; ``ts_sell`` ``[N, 8760]`` is the time-series sell rate used
    under net billing when the tariff has no TOU sell price.

    ``soft_tau`` selects the differentiable twin: soft import/export
    splits (kW) and soft tier clips (the same tau in kWh); ``None`` is the
    hard path."""
    extra = net_load.dim() - 2
    hp = _per_row(tariff.hour_period, extra)

    sums_signed = monthly_period_sums(net_load, hp, n_periods)
    bill_nem = tiered_charge(sums_signed, tariff.price, tariff.tier_cap,
                             soft_tau).sum(dim=-1)

    if soft_tau is None:
        imports = torch.clamp_min(net_load, 0.0)
        exports = torch.clamp_min(-net_load, 0.0)
    else:
        imports = relu_t(net_load, soft_tau)
        exports = relu_t(-net_load, soft_tau)
    sums_imp = monthly_period_sums(imports, hp, n_periods)
    import_charges = tiered_charge(sums_imp, tariff.price, tariff.tier_cap,
                                   soft_tau).sum(dim=-1)
    tou_sell_hourly = select_by_period(tariff.hour_period, tariff.sell_price, ts_sell)
    has_tou_sell = (tariff.sell_price > 0.0).any(dim=1, keepdim=True)
    sell_hourly = torch.where(has_tou_sell, tou_sell_hourly, ts_sell)
    export_credit = (exports * _per_row(sell_hourly, extra)).sum(dim=-1)
    bill_nb = import_charges - export_credit

    energy_bill = torch.where(_per_row(tariff.metering == NET_BILLING, extra),
                              bill_nb, bill_nem)
    return energy_bill + MONTHS * _per_row(tariff.fixed_monthly, extra)


def escalation_factors(n_years: int, inflation: torch.Tensor,
                       escalation: torch.Tensor) -> torch.Tensor:
    """``[N, Y]`` nominal price factor per analysis year (year 1 = 1.0):
    inflation and the real rate escalation compounded."""
    y = torch.arange(n_years, dtype=torch.float32, device=inflation.device)
    return ((1.0 + inflation[:, None]) * (1.0 + escalation[:, None])) ** y


def degradation_factors(n_years: int, degradation: torch.Tensor) -> torch.Tensor:
    """``[N, Y]`` PV output factor per analysis year (year 1 = 1.0)."""
    y = torch.arange(n_years, dtype=torch.float32, device=degradation.device)
    return (1.0 - degradation[:, None]) ** y


def bill_series(
    load: torch.Tensor,
    system_out: torch.Tensor,
    tariff: AgentTariff,
    ts_sell: torch.Tensor,
    inflation: torch.Tensor,
    escalation: torch.Tensor,
    degradation: torch.Tensor,
    n_periods: int,
    n_years: int,
    tariff_wo: AgentTariff | None = None,
    soft_tau: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(bills_with_sys ``[N, Y]``, bills_without_sys ``[N, Y]``) in nominal
    dollars over the analysis period: PV output degrades compounding
    annually, retail prices escalate, load is held constant.

    The no-system bill is priced once and scaled by the price factor; the
    with-system bill prices every year's net load ``[N, Y, 8760]`` at
    once, since degradation moves its import/export split. ``tariff_wo``
    prices the no-system bill where the adopter switches to a DG rate."""
    pf = escalation_factors(n_years, inflation, escalation)        # [N, Y]
    df = degradation_factors(n_years, degradation)                 # [N, Y]

    bill_wo_y1 = annual_bill(load, tariff if tariff_wo is None else tariff_wo,
                             ts_sell, n_periods, soft_tau)
    bills_wo = bill_wo_y1[:, None] * pf

    net = load[:, None, :] - system_out[:, None, :] * df[:, :, None]
    bills_w = annual_bill(net, tariff, ts_sell, n_periods, soft_tau) * pf
    return bills_w, bills_wo
