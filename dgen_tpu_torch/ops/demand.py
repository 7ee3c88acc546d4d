"""Demand charges: TOU-window and flat monthly peak-demand billing (port
of ``dgen_tpu/ops/demand.py``).

The reference skips demand charges in its adoption loop, so nothing in
the model year depends on this module; its tariff oracle prices them,
and :mod:`dgen_tpu_torch.analysis` runs them over a run's sized outputs.

Semantics (the oracle's):
  * flat: each month's charge is the tiered price of that month's peak
    net load (kW);
  * TOU: within each month, the peak over each demand-TOU window is
    priced through that window's tier structure, and the windows summed;
  * tier pricing is the oracle's bracket formula: the bracket holding
    the peak pays ``(v - L[t-1]) * p[t] + L[t-1] * p[t-1]``.

The JAX functions take one agent and are vmapped; here they take the
batch: net loads ``[N, 8760]`` and per-agent :class:`DemandTariff`
leaves. Monthly and window peaks are maxima over each month's hour
range, row by row (a maximum is exact in any order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.ops.tariff import (
    BIG_CAP, HOURS, MONTH_HOURS, MONTHS, expand_schedule_8760,
)

NEG = -1e30


class DemandTariff(NamedTuple):
    """Dense demand-charge structure; leaves as below for one tariff, with
    a leading axis for a bank or per agent."""

    flat_price: torch.Tensor    # [12, T] $/kW for the monthly peak
    flat_cap: torch.Tensor      # [12, T] kW tier caps (BIG_CAP = unbounded)
    tou_price: torch.Tensor     # [P, T] $/kW per demand-TOU window
    tou_cap: torch.Tensor       # [P, T] kW tier caps
    hour_window: torch.Tensor   # [8760] int32 demand-TOU window per hour

    @staticmethod
    def zeros(n_windows: int = 1, n_tiers: int = 1, device="cuda") -> "DemandTariff":
        return _to_tensors(_zeros_np(n_windows, n_tiers), resolve_device(device))


def _zeros_np(n_windows: int, n_tiers: int) -> tuple:
    return (np.zeros((MONTHS, n_tiers), np.float32),
            np.full((MONTHS, n_tiers), BIG_CAP, np.float32),
            np.zeros((n_windows, n_tiers), np.float32),
            np.full((n_windows, n_tiers), BIG_CAP, np.float32),
            np.zeros(HOURS, np.int32))


def _to_tensors(arrays, device: torch.device) -> DemandTariff:
    return DemandTariff(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in arrays))


def _bracket_charge(v: torch.Tensor, caps: torch.Tensor,
                    price: torch.Tensor) -> torch.Tensor:
    """The oracle's tier formula for a demand value ``v`` ``[...]``: the
    price of the bracket holding ``v``; ``caps`` and ``price`` ``[..., T]``
    broadcast against ``v[..., None]``."""
    t_count = price.shape[-1]
    lower = torch.cat([torch.zeros_like(caps[..., :1]), caps[..., :-1]], dim=-1)
    vx = v[..., None]
    in_bracket = (vx >= lower) & (vx < caps)
    # bracket t pays (v - L[t-1]) * p[t] + L[t-1] * p[t-1]
    prev_price = torch.cat([price[..., :1], price[..., :-1]], dim=-1)
    first = torch.arange(t_count, device=price.device) == 0
    per_tier = (vx - lower) * price + lower * torch.where(first, 0.0, prev_price)
    return torch.where(in_bracket, per_tier, 0.0).sum(dim=-1)


def _month_max(x: torch.Tensor) -> torch.Tensor:
    """``[N, 12]`` maxima of ``[N, 8760]`` over each month's hours."""
    bounds = MONTH_HOURS.tolist()
    return torch.stack([x[:, a:b].amax(dim=1) for a, b in zip(bounds[:-1], bounds[1:])],
                       dim=1)


def monthly_peaks(net_load: torch.Tensor, window: torch.Tensor,
                  n_windows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat ``[N, 12]``, tou ``[N, 12, P]``) monthly peak net loads (kW) of
    ``[N, 8760]`` net loads with demand windows ``window`` ``[N, 8760]``;
    net exports floor at 0, as in the oracle (a window with no hour in a
    month peaks at 0)."""
    x = torch.clamp_min(net_load, 0.0)
    flat = _month_max(x)
    tou = torch.stack([_month_max(torch.where(window == p, x, NEG))
                       for p in range(n_windows)], dim=-1)
    return torch.clamp_min(flat, 0.0), torch.clamp_min(tou, 0.0)


def annual_demand_charge(net_load: torch.Tensor, tariff: DemandTariff) -> torch.Tensor:
    """Annual $ ``[N]`` of flat + TOU demand charges for ``[N, 8760]`` net
    loads on per-agent tariff leaves ``[N, ...]``; the window count is the
    tariff's own TOU price shape."""
    n_windows = tariff.tou_price.shape[-2]
    flat, tou = monthly_peaks(net_load, tariff.hour_window, n_windows)
    flat_charge = _bracket_charge(flat, tariff.flat_cap, tariff.flat_price)
    tou_charge = _bracket_charge(tou, tariff.tou_cap[:, None], tariff.tou_price[:, None])
    return flat_charge.sum(dim=-1) + tou_charge.sum(dim=(-2, -1))


def _compile_np(d_flat_prices=None, d_flat_levels=None, d_tou_prices=None,
                d_tou_levels=None, d_tou_8760=None) -> tuple:
    """Host numpy leaves of :func:`compile_demand_tariff`."""
    def as_pt(prices, levels, p_fallback):
        if prices is None:
            return (np.zeros((p_fallback, 1), np.float32),
                    np.full((p_fallback, 1), BIG_CAP, np.float32))
        p = np.asarray(prices, np.float32).T        # [P, T]
        if levels is None:
            c = np.full(p.shape, BIG_CAP, np.float32)
        else:
            c = np.asarray(levels, np.float32).T.copy()
            c[c <= 0] = BIG_CAP
        return p, np.minimum(c, BIG_CAP)

    tou_p, tou_c = as_pt(d_tou_prices, d_tou_levels, 1)
    flat_p, flat_c = as_pt(d_flat_prices, d_flat_levels, MONTHS)
    if flat_p.shape[0] == 1:  # single season -> every month
        flat_p = np.broadcast_to(flat_p, (MONTHS, flat_p.shape[1])).copy()
        flat_c = np.broadcast_to(flat_c, (MONTHS, flat_c.shape[1])).copy()
    if flat_p.shape[0] != MONTHS:
        raise ValueError(f"d_flat prices cover {flat_p.shape[0]} months, expected 12")
    hw = (np.zeros(HOURS, np.int32) if d_tou_8760 is None
          else np.asarray(d_tou_8760, np.int32))
    if hw.min(initial=0) < 0 or hw.max(initial=0) >= tou_p.shape[0]:
        raise ValueError(
            f"d_tou_8760 window ids span [{int(hw.min())}, {int(hw.max())}] but the "
            f"price table covers [0, {tou_p.shape[0]}) windows")
    return flat_p, flat_c, tou_p, tou_c, hw


def compile_demand_tariff(d_flat_prices=None, d_flat_levels=None, d_tou_prices=None,
                          d_tou_levels=None, d_tou_8760=None,
                          device="cuda") -> DemandTariff:
    """One demand tariff from oracle-shaped inputs (``d_flat_*`` are
    [T][12] tier x month, ``d_tou_*`` [T][P] tier x window, ``d_tou_8760``
    the window map), on ``device``."""
    return _to_tensors(_compile_np(d_flat_prices, d_flat_levels, d_tou_prices,
                                   d_tou_levels, d_tou_8760), resolve_device(device))


def compile_demand_bank(demand_specs, device="cuda") -> "DemandTariff | None":
    """Per-tariff demand specs -> one bank (leaves ``[K, ...]``) on
    ``device``, or None when no tariff carries demand charges.

    ``demand_specs``: one entry per tariff-bank row, the ``"demand"``
    sub-spec of a converted tariff, or None. Tariffs are padded to the
    bank's window and tier counts by edge replication: a pad tier repeats
    the real top tier's cap, so its bracket ``[cap, cap)`` is empty and
    never prices; a pad window's peak is 0."""
    if not demand_specs or not any(demand_specs):
        return None
    ts = []
    for spec in demand_specs:
        if not spec:
            ts.append(_zeros_np(1, 1))
            continue
        kwargs = {k: spec[k] for k in ("d_flat_prices", "d_flat_levels",
                                       "d_tou_prices", "d_tou_levels") if k in spec}
        if "d_wkday_12by24" in spec:
            kwargs["d_tou_8760"] = expand_schedule_8760(
                spec["d_wkday_12by24"], spec.get("d_wkend_12by24", spec["d_wkday_12by24"]))
        ts.append(_compile_np(**kwargs))

    n_p = max(t[2].shape[0] for t in ts)
    n_t = max(max(t[2].shape[1], t[0].shape[1]) for t in ts)

    def pad2(a, r, c):
        return np.pad(a, ((0, r - a.shape[0]), (0, c - a.shape[1])), mode="edge")

    return _to_tensors((
        np.stack([pad2(t[0], MONTHS, n_t) for t in ts]),
        np.stack([pad2(t[1], MONTHS, n_t) for t in ts]),
        np.stack([pad2(t[2], n_p, n_t) for t in ts]),
        np.stack([pad2(t[3], n_p, n_t) for t in ts]),
        np.stack([t[4] for t in ts]),
    ), resolve_device(device))
