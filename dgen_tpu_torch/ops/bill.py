"""Utility-bill engine (port of ``dgen_tpu/ops/bill.py``).

The JAX functions take one agent and are vmapped; here they take the
batch: streams are ``[N, 8760]`` and an :class:`AgentTariff` holds the
gathered per-agent tariff leaves. TOU energy charges with monthly tier
accumulation, monthly fixed charges, net metering (signed monthly
netting, negative sums credited at the period's tier-1 price) and net
billing (imports billed, exports credited hourly at a sell rate).
Demand charges are absent, as in the reference's hot loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

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


def tiered_charge(sums: torch.Tensor, price: torch.Tensor,
                  tier_cap: torch.Tensor) -> torch.Tensor:
    """Cumulative tiered energy charge ``[N, 12]`` of monthly sums
    ``[N, 12, P]`` (kWh, negative under net metering): positive energy
    is charged tier by tier against the monthly caps, negative energy
    is credited at the period's tier-1 price."""
    lower = torch.cat([torch.zeros_like(tier_cap[:, :1]), tier_cap[:, :-1]], dim=1)
    width = tier_cap - lower                                   # [N, T]
    seg = torch.minimum(
        torch.clamp_min(sums[..., None] - lower[:, None, None, :], 0.0),
        width[:, None, None, :],
    )                                                          # [N, 12, P, T]
    neg_sums = torch.clamp_max(sums, 0.0)
    pos = torch.einsum("nmpt,npt->nm", seg, price)
    neg = torch.einsum("nmp,np->nm", neg_sums, price[:, :, 0])
    return pos + neg


def annual_bill(net_load: torch.Tensor, tariff: AgentTariff,
                ts_sell: torch.Tensor, n_periods: int) -> torch.Tensor:
    """Annual bills ``[N]`` from signed hourly net grid loads
    ``[N, 8760]`` (positive = import). Both metering styles are
    evaluated and selected per agent; ``ts_sell`` is the time-series
    sell rate used under net billing when the tariff has no TOU sell
    price."""
    hp = tariff.hour_period

    sums_signed = monthly_period_sums(net_load, hp, n_periods)
    bill_nem = tiered_charge(sums_signed, tariff.price, tariff.tier_cap).sum(dim=1)

    imports = torch.clamp_min(net_load, 0.0)
    exports = torch.clamp_min(-net_load, 0.0)
    sums_imp = monthly_period_sums(imports, hp, n_periods)
    import_charges = tiered_charge(sums_imp, tariff.price, tariff.tier_cap).sum(dim=1)
    tou_sell_hourly = select_by_period(hp, tariff.sell_price, ts_sell)
    has_tou_sell = (tariff.sell_price > 0.0).any(dim=1, keepdim=True)
    sell_hourly = torch.where(has_tou_sell, tou_sell_hourly, ts_sell)
    export_credit = (exports * sell_hourly).sum(dim=1)
    bill_nb = import_charges - export_credit

    energy_bill = torch.where(tariff.metering == NET_BILLING, bill_nb, bill_nem)
    return energy_bill + MONTHS * tariff.fixed_monthly
