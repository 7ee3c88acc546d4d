"""Dense tariff representation and the tariff compiler (port of
``dgen_tpu/ops/tariff.py``).

Tariffs are compiled once, on the host with numpy, into a bank of
dense padded tensors (:class:`TariffBank`) that every bill function
indexes by ``tariff_idx``: buy prices ``[K, P, T]``, tier caps
``[K, T]``, TOU sell prices ``[K, P]``, the hour-of-year -> TOU period
map ``[K, 8760]``, fixed monthly charges, metering codes and the true
period / tier counts. The normalization (contiguous period ids, equal
tier counts, one harmonized cap per tier) is the reference compiler's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device

#: unbounded-tier sentinel, finite and inside float32 range
BIG_CAP = 1e38

HOURS = 8760
MONTHS = 12

NET_METERING = 0
NET_BILLING = 2

#: cumulative hours at each month boundary of a non-leap year; months
#: are contiguous in the plain 8760-hour order
MONTH_HOURS = np.array(
    [0, 744, 1416, 2160, 2880, 3624, 4344, 5088, 5832, 6552, 7296, 8016, 8760],
    dtype=np.int64,
)


def hour_month_map() -> np.ndarray:
    """[8760] int32: hour-of-year -> month index 0..11."""
    out = np.zeros(HOURS, dtype=np.int32)
    for m in range(MONTHS):
        out[MONTH_HOURS[m]:MONTH_HOURS[m + 1]] = m
    return out


def hour_weekend_map(jan1_dow: int = 0) -> np.ndarray:
    """[8760] bool: True where the hour falls on a weekend day (Jan 1 is
    a Monday for ``jan1_dow=0``)."""
    day = np.arange(HOURS) // 24
    dow = (day + jan1_dow) % 7
    return dow >= 5


_HOUR_MONTH = hour_month_map()
_HOUR_WEEKEND = hour_weekend_map()
_HOUR_OF_DAY = (np.arange(HOURS) % 24).astype(np.int32)


def expand_schedule_8760(wkday_12x24: np.ndarray, wkend_12x24: np.ndarray) -> np.ndarray:
    """Flatten 12x24 weekday/weekend period schedules (0-based period
    ids) to an [8760] int32 map."""
    wkday = np.asarray(wkday_12x24, dtype=np.int32)
    wkend = np.asarray(wkend_12x24, dtype=np.int32)
    by_day = np.where(_HOUR_WEEKEND, wkend[_HOUR_MONTH, _HOUR_OF_DAY],
                      wkday[_HOUR_MONTH, _HOUR_OF_DAY])
    return by_day.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TariffBank:
    """Bank of K compiled tariffs as dense padded tensors."""

    price: torch.Tensor         # [K, P, T] float32 buy $/kWh
    tier_cap: torch.Tensor      # [K, T] float32 monthly kWh cap per tier
    sell_price: torch.Tensor    # [K, P] float32 TOU sell $/kWh (0 if unused)
    hour_period: torch.Tensor   # [K, 8760] int32 TOU period per hour
    fixed_monthly: torch.Tensor  # [K] float32 $/month
    metering: torch.Tensor      # [K] int32 (NET_METERING | NET_BILLING)
    n_periods: torch.Tensor     # [K] int32
    n_tiers: torch.Tensor       # [K] int32

    @property
    def n_tariffs(self) -> int:
        return self.price.shape[0]

    @property
    def max_periods(self) -> int:
        return self.price.shape[1]

    @property
    def max_tiers(self) -> int:
        return self.price.shape[2]


def _coerce_12x24(mat: Optional[Sequence[Sequence[int]]]) -> np.ndarray:
    """Pad/trim a schedule to a strict 12x24 int array, 0 where missing."""
    out = np.zeros((12, 24), dtype=np.int32)
    if mat is None:
        return out
    a = np.asarray(mat)
    if a.ndim != 2:
        return out
    r = min(12, a.shape[0])
    c = min(24, a.shape[1])
    out[:r, :c] = a[:r, :c].astype(np.int32)
    return out


def normalize_tariff_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a raw tariff spec dict into contiguous-period,
    equal-tier, harmonized-cap dense numpy form.

    Accepted keys: ``price`` [P][T] or legacy ``e_prices`` [T][P];
    ``tier_cap`` [T] or legacy ``e_levels`` [T][P];
    ``e_wkday_12by24`` / ``e_wkend_12by24`` 0-based period schedules;
    ``fixed_charge`` $/month; ``metering`` (0 net metering, 2 net
    billing); ``sell_frac_of_buy`` (TOU sell = this fraction of the
    tier-1 buy price). Returns price [P,T], tier_cap [T], sell_price
    [P], wkday/wkend 12x24, fixed_monthly, metering.
    """
    if "price" in spec:
        price = np.asarray(spec["price"], dtype=np.float64)  # [P, T]
    else:
        e_prices = np.asarray(spec.get("e_prices", [[0.1]]), dtype=np.float64)
        price = e_prices.T
    n_periods, n_tiers = price.shape

    if "tier_cap" in spec:
        caps = np.asarray(spec["tier_cap"], dtype=np.float64)
    else:
        e_levels = spec.get("e_levels")
        if e_levels is None:
            caps = np.full(n_tiers, BIG_CAP)
        else:
            lv = np.asarray(e_levels, dtype=np.float64)  # [T, P]
            # one cap per tier: the min finite cap across periods, else
            # unbounded
            caps = np.empty(n_tiers)
            for t in range(n_tiers):
                row = lv[t]
                finite = row[(row > 0) & (row < 1e37)]
                caps[t] = finite.min() if finite.size else BIG_CAP
    caps = np.maximum.accumulate(caps)
    caps[-1] = BIG_CAP

    wkday = _coerce_12x24(spec.get("e_wkday_12by24"))
    wkend = _coerce_12x24(spec.get("e_wkend_12by24"))

    # remap the period ids the schedules use to contiguous 0..P-1
    used = np.unique(np.concatenate([wkday.ravel(), wkend.ravel()]))
    used = used[(used >= 0) & (used < n_periods)]
    if used.size == 0:
        used = np.array([0])
    remap = np.zeros(max(n_periods, int(used.max()) + 1), dtype=np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    wkday = remap[np.clip(wkday, 0, remap.size - 1)]
    wkend = remap[np.clip(wkend, 0, remap.size - 1)]
    price = price[used, :]
    n_periods = used.size

    sell_frac = float(spec.get("sell_frac_of_buy", 0.0))
    sell_price = price[:, 0] * sell_frac if sell_frac > 0 else np.zeros(n_periods)

    return {
        "price": price,
        "tier_cap": caps,
        "sell_price": sell_price,
        "wkday": wkday,
        "wkend": wkend,
        "fixed_monthly": float(spec.get("fixed_charge", 0.0)),
        "metering": int(spec.get("metering", NET_METERING)),
    }


def flat_tariff(price: float, fixed: float = 0.0, metering: int = NET_METERING,
                sell_frac_of_buy: float = 0.0) -> Dict[str, Any]:
    """A single-period, single-tier flat-rate tariff spec."""
    return {
        "price": [[price]],
        "fixed_charge": fixed,
        "metering": metering,
        "sell_frac_of_buy": sell_frac_of_buy,
    }


def compile_tariffs(
    specs: List[Dict[str, Any]],
    max_periods: Optional[int] = None,
    max_tiers: Optional[int] = None,
    device="cuda",
) -> TariffBank:
    """Compile raw tariff specs into a padded :class:`TariffBank` on
    ``device``. Padding beyond a tariff's true extents never alters a
    bill: extra tiers repeat the top tier's price under unbounded caps,
    extra periods repeat period 0 and no schedule selects them."""
    dev = resolve_device(device)
    normed = [normalize_tariff_spec(s) for s in specs]
    P = max_periods or max(n["price"].shape[0] for n in normed)
    T = max_tiers or max(n["price"].shape[1] for n in normed)
    K = len(normed)

    price = np.zeros((K, P, T), dtype=np.float32)
    tier_cap = np.full((K, T), BIG_CAP, dtype=np.float32)
    sell_price = np.zeros((K, P), dtype=np.float32)
    hour_period = np.zeros((K, HOURS), dtype=np.int32)
    fixed_monthly = np.zeros(K, dtype=np.float32)
    metering = np.zeros(K, dtype=np.int32)
    n_periods = np.zeros(K, dtype=np.int32)
    n_tiers = np.zeros(K, dtype=np.int32)

    for k, n in enumerate(normed):
        p, t = n["price"].shape
        if p > P or t > T:
            raise ValueError(f"tariff {k} exceeds bank shape ({p}x{t} > {P}x{T})")
        price[k, :p, :t] = n["price"]
        if t < T:
            price[k, :p, t:] = n["price"][:, -1:]
        if p < P:
            price[k, p:, :] = price[k, 0:1, :]
        tier_cap[k, :t] = n["tier_cap"]
        sell_price[k, :p] = n["sell_price"]
        hour_period[k] = expand_schedule_8760(n["wkday"], n["wkend"])
        fixed_monthly[k] = n["fixed_monthly"]
        metering[k] = n["metering"]
        n_periods[k] = p
        n_tiers[k] = t

    arrays = dict(
        price=price, tier_cap=tier_cap, sell_price=sell_price,
        hour_period=hour_period, fixed_monthly=fixed_monthly,
        metering=metering, n_periods=n_periods, n_tiers=n_tiers,
    )
    return TariffBank(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})

