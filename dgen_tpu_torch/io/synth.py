"""Deterministic synthetic population and profile generation (port of
``dgen_tpu/io/synth.py``).

The numpy draws are the JAX package's, in the same order, so a seed
gives the same table, banks and tariffs byte for byte: state x sector
bins of customer clusters, archetypal hourly load shapes,
latitude-graded solar capacity factors and a TOU/flat tariff mix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dgen_tpu_torch.config import SECTORS, resolve_device
from dgen_tpu_torch.models.agents import AgentTable, ProfileBank, build_agent_table
from dgen_tpu_torch.ops.tariff import (
    HOURS,
    NET_BILLING,
    NET_METERING,
    TariffBank,
    compile_tariffs,
)

#: contiguous-US state abbreviations + DC
STATES = (
    "AL AR AZ CA CO CT DC DE FL GA IA ID IL IN KS KY LA MA MD ME MI MN MO MS "
    "MT NC ND NE NH NJ NM NV NY OH OK OR PA RI SC SD TN TX UT VA VT WA WI WV WY"
).split()
STATE_IDX = {s: i for i, s in enumerate(STATES)}
N_STATES = len(STATES)


def _daily_shape(kind: str) -> np.ndarray:
    h = np.arange(24)
    if kind == "res":
        # morning + evening peaks
        shape = (
            0.6
            + 0.5 * np.exp(-0.5 * ((h - 7.5) / 1.8) ** 2)
            + 1.0 * np.exp(-0.5 * ((h - 19.0) / 2.5) ** 2)
        )
    elif kind == "com":
        # business-hours plateau
        shape = 0.5 + 1.0 / (1.0 + np.exp(-(h - 8.0))) / (1.0 + np.exp(h - 18.0))
    else:
        shape = np.ones(24)
    return shape / shape.sum()


def make_load_profiles(n_per_sector: int = 4, seed: int = 0) -> np.ndarray:
    """[3 * n_per_sector, 8760] normalized (sum 1) load shapes,
    sector-major (res block, com block, ind block)."""
    rng = np.random.default_rng(seed)
    day = np.arange(HOURS) // 24
    seasonal_summer = 1.0 + 0.35 * np.cos(2 * np.pi * (day - 200) / 365.0)
    seasonal_winter = 1.0 + 0.35 * np.cos(2 * np.pi * (day - 20) / 365.0)

    profiles = []
    for s, kind in enumerate(SECTORS):
        base_day = _daily_shape(kind)
        for k in range(n_per_sector):
            jitter = 1.0 + 0.1 * rng.standard_normal(24)
            d = np.clip(base_day * jitter, 1e-4, None)
            d = d / d.sum()
            season = seasonal_summer if k % 2 == 0 else seasonal_winter
            prof = np.tile(d, 365) * season
            prof = np.clip(prof, 1e-9, None)
            profiles.append(prof / prof.sum())
    return np.asarray(profiles, dtype=np.float32)


def make_solar_cf_profiles(n_profiles: int = 8, seed: int = 1) -> np.ndarray:
    """[n_profiles, 8760] PV kWh per kW_dc per hour; annual production
    graded from ~1100 (northern) to ~1900 (southwest)."""
    rng = np.random.default_rng(seed)
    h = np.arange(HOURS)
    hod = h % 24
    day = h // 24
    day_len = 12.0 + 2.5 * np.sin(2 * np.pi * (day - 80) / 365.0)
    sunrise = 12.0 - day_len / 2
    sunset = 12.0 + day_len / 2
    daylight = (hod >= sunrise) & (hod <= sunset)
    bell = np.sin(np.pi * np.clip((hod - sunrise) / np.maximum(day_len, 1e-3), 0, 1))
    seasonal = 0.75 + 0.25 * np.sin(2 * np.pi * (day - 80) / 365.0)

    out = []
    for k in range(n_profiles):
        target_naep = 1100.0 + 800.0 * k / max(n_profiles - 1, 1)
        cloud = np.clip(1.0 - 0.3 * rng.random(365), 0.2, 1.0)[day]
        prof = np.where(daylight, bell, 0.0) * seasonal * cloud
        prof = prof * (target_naep / prof.sum())
        out.append(prof)
    return np.asarray(out, dtype=np.float32)


def make_wholesale_prices(n_regions: int, seed: int = 2) -> np.ndarray:
    """[R, 8760] $/kWh wholesale price shapes."""
    rng = np.random.default_rng(seed)
    hod = np.arange(HOURS) % 24
    base = 0.03 + 0.02 * np.exp(-0.5 * ((hod - 19) / 2.5) ** 2) - 0.012 * np.exp(
        -0.5 * ((hod - 13) / 2.5) ** 2
    )
    out = []
    for r in range(n_regions):
        scale = 0.8 + 0.4 * rng.random()
        out.append(np.clip(base * scale, 0.001, None))
    return np.asarray(out, dtype=np.float32)


def make_tariff_specs() -> list:
    """The synthetic tariff corpus as raw spec dicts: flat, tiered and
    TOU under both metering styles, a TOU-sell tariff, and a DG rate."""
    specs = []
    # 0: flat NEM
    specs.append({"price": [[0.12]], "fixed_charge": 10.0, "metering": NET_METERING})
    # 1: flat net billing
    specs.append({"price": [[0.13]], "fixed_charge": 8.0, "metering": NET_BILLING})
    # 2: 2-tier NEM (tier cap 500 kWh/month)
    specs.append({
        "price": [[0.10, 0.16]], "tier_cap": [500.0, 1e38],
        "fixed_charge": 12.0, "metering": NET_METERING,
    })
    # 3: TOU 2-period net billing (peak 16-21)
    wkday = np.zeros((12, 24), dtype=int)
    wkday[:, 16:21] = 1
    specs.append({
        "price": [[0.10], [0.24]], "e_wkday_12by24": wkday,
        "e_wkend_12by24": np.zeros((12, 24), dtype=int),
        "fixed_charge": 11.0, "metering": NET_BILLING,
    })
    # 4: TOU buy with sell = 0.25 x buy
    specs.append({
        "price": [[0.13], [0.32]], "e_wkday_12by24": wkday,
        "e_wkend_12by24": wkday, "fixed_charge": 9.0,
        "metering": NET_BILLING, "sell_frac_of_buy": 0.25,
    })
    # 5: commercial TOU NEM
    specs.append({
        "price": [[0.09], [0.18]], "e_wkday_12by24": wkday,
        "e_wkend_12by24": np.zeros((12, 24), dtype=int),
        "fixed_charge": 40.0, "metering": NET_METERING,
    })
    # 6: DG rate for post-adoption switching: NEM with a higher fixed
    # charge and a slightly lower volumetric price
    specs.append({
        "price": [[0.115]], "fixed_charge": 18.0, "metering": NET_METERING,
    })
    return specs


def make_tariff_bank(seed: int = 3, device="cuda") -> TariffBank:
    """The synthetic tariff corpus (:func:`make_tariff_specs`) compiled on
    ``device``; ``seed`` is unused, as in the JAX package."""
    return compile_tariffs(make_tariff_specs(), device=device)


@dataclasses.dataclass(frozen=True)
class SynthPopulation:
    table: AgentTable
    profiles: ProfileBank
    tariffs: TariffBank
    n_regions: int


def generate_population(
    n_agents: int,
    states: Optional[Sequence[str]] = None,
    seed: int = 0,
    pad_multiple: int = 128,
    sector_weights: Tuple[float, float, float] = (0.7, 0.2, 0.1),
    n_regions: int = 10,
    rate_switch_frac: float = 0.0,
    device="cuda",
) -> SynthPopulation:
    """Deterministic synthetic population over the given states, on
    ``device``: residential ~4-15 MWh/yr per customer, commercial
    ~30-400 MWh, industrial up to ~4 GWh; log-uniform bin customer
    counts; developable fraction in [0.2, 0.95]."""
    dev = resolve_device(device)
    states = list(states or STATES)
    rng = np.random.default_rng(seed)

    state_idx = rng.integers(0, len(states), n_agents)
    global_state_idx = np.asarray(
        [STATE_IDX[s] for s in states], dtype=np.int64
    )[state_idx]
    sector_idx = rng.choice(3, size=n_agents, p=np.asarray(sector_weights))

    load_profiles = make_load_profiles()
    cf_profiles = make_solar_cf_profiles()
    n_per_sector = load_profiles.shape[0] // 3
    load_idx = sector_idx * n_per_sector + rng.integers(0, n_per_sector, n_agents)
    # solar resource graded by state position (proxy for latitude)
    cf_idx = np.clip(
        ((global_state_idx * cf_profiles.shape[0]) // N_STATES
         + rng.integers(-1, 2, n_agents)),
        0, cf_profiles.shape[0] - 1,
    )
    region_idx = global_state_idx % n_regions

    load_kwh = np.where(
        sector_idx == 0,
        np.exp(rng.uniform(np.log(4e3), np.log(1.5e4), n_agents)),
        np.where(
            sector_idx == 1,
            np.exp(rng.uniform(np.log(3e4), np.log(4e5), n_agents)),
            np.exp(rng.uniform(np.log(4e5), np.log(4e6), n_agents)),
        ),
    )
    customers = np.exp(rng.uniform(np.log(50.0), np.log(5000.0), n_agents))
    developable = rng.uniform(0.2, 0.95, n_agents)

    tariffs = compile_tariffs(make_tariff_specs(), device=dev)
    # residential agents prefer tariffs 0-4; commercial 1/3/5; industrial 5
    tariff_idx = np.where(
        sector_idx == 0,
        rng.integers(0, 5, n_agents),
        np.where(sector_idx == 1, rng.choice([1, 3, 5], n_agents), 5),
    )

    # a fraction of residential agents switch to the DG rate (tariff 6)
    # on adoption, paying a one-time interconnection charge
    switch = (rng.random(n_agents) < rate_switch_frac) & (sector_idx == 0)
    tariff_switch_idx = np.where(switch, 6, tariff_idx)
    one_time_charge = np.where(
        switch, rng.uniform(100.0, 800.0, n_agents), 0.0
    ).astype(np.float32)

    table = build_agent_table(
        state_idx=global_state_idx,
        sector_idx=sector_idx,
        region_idx=region_idx,
        tariff_idx=tariff_idx,
        load_idx=load_idx,
        cf_idx=cf_idx,
        customers_in_bin=customers,
        load_kwh_per_customer_in_bin=load_kwh,
        developable_frac=developable,
        n_states=N_STATES,
        tariff_switch_idx=tariff_switch_idx,
        one_time_charge=one_time_charge,
        pad_multiple=pad_multiple,
        device=dev,
    )
    profiles = ProfileBank(
        load=torch.from_numpy(load_profiles).to(dev),
        solar_cf=torch.from_numpy(cf_profiles).to(dev),
        wholesale=torch.from_numpy(make_wholesale_prices(n_regions)).to(dev),
    )
    return SynthPopulation(table=table, profiles=profiles, tariffs=tariffs,
                           n_regions=n_regions)
