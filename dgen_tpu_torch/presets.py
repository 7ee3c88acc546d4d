"""The five BASELINE.json benchmark configurations as presets (port of
``dgen_tpu/presets.py``, synthetic-input branch).

Populations are synthetic at the config's scale and sector mix and the
scenario trajectories are the uniform synthetic defaults; the reference
CSV trajectories are not read by the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from dgen_tpu_torch.config import RunConfig, ScenarioConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class Preset:
    """One BASELINE.json config as a buildable simulation."""

    name: str
    baseline_config: str       # the BASELINE.json "configs" line
    states: Optional[list]     # None = all states
    sector_weights: tuple
    start_year: int
    end_year: int
    storage_enabled: bool
    with_hourly: bool
    default_agents: int
    load_growth_scenario: Optional[str] = None


PRESETS: Dict[str, Preset] = {p.name: p for p in (
    Preset(
        name="delaware-res",
        baseline_config="Delaware residential solar-only, 2014–2024 default scenario (small_states single-state)",
        states=["DE"], sector_weights=(1.0, 0.0, 0.0),
        start_year=2014, end_year=2024,
        storage_enabled=False, with_hourly=True, default_agents=1024,
    ),
    Preset(
        name="california-res-com",
        baseline_config="California residential + commercial solar, default ATB cost trajectory",
        states=["CA"], sector_weights=(0.7, 0.3, 0.0),
        start_year=2014, end_year=2040,
        storage_enabled=False, with_hourly=True, default_agents=8192,
    ),
    Preset(
        name="ercot-all-sector",
        baseline_config="ERCOT ISO all-sector solar+storage (battery dispatch on, NEM tariffs)",
        states=["TX"], sector_weights=(0.6, 0.3, 0.1),
        start_year=2014, end_year=2040,
        storage_enabled=True, with_hourly=True, default_agents=8192,
    ),
    Preset(
        name="national-res",
        baseline_config="National residential solar, 2014–2050 biennial, all states sharded over pod",
        states=None, sector_weights=(1.0, 0.0, 0.0),
        start_year=2014, end_year=2050,
        storage_enabled=False, with_hourly=False, default_agents=65536,
    ),
    Preset(
        name="national-all-sector",
        baseline_config="National all-sector solar+storage, high-electrification load-growth scenario",
        states=None, sector_weights=(0.7, 0.2, 0.1),
        start_year=2014, end_year=2050,
        storage_enabled=True, with_hourly=True, default_agents=1048576,
        load_growth_scenario="Experimental",
    ),
)}


def build(
    name: str,
    n_agents: Optional[int] = None,
    run_config: Optional[RunConfig] = None,
    end_year: Optional[int] = None,
    rate_switch_frac: float = 0.0,
    device="cuda",
):
    """(Simulation, population, meta) for a named preset on ``device``.

    ``end_year`` cuts the run's depth (the preset's own by default);
    ``rate_switch_frac`` gives that share of residential agents a DG
    rate switch on adoption."""
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models.scenario import uniform_inputs
    from dgen_tpu_torch.models.simulation import Simulation

    dev = resolve_device(device)
    p = PRESETS[name]
    cfg = ScenarioConfig(
        name=p.name, start_year=p.start_year,
        end_year=p.end_year if end_year is None else end_year,
        storage_enabled=p.storage_enabled, anchor_years=(),
    )
    n = int(n_agents or p.default_agents)
    n_regions = 10
    meta: Dict[str, object] = {
        "preset": p.name, "baseline_config": p.baseline_config,
        "n_agents": n,
        "data_sources": {"all": "synthetic_default"},
        "market_curves": {"mms": "synthetic_default", "bass": "synthetic_default"},
    }
    pop = synth.generate_population(
        n, states=p.states, seed=7, sector_weights=p.sector_weights,
        n_regions=n_regions, rate_switch_frac=rate_switch_frac, device=dev,
    )
    inputs = uniform_inputs(cfg, n_groups=pop.table.n_groups, n_regions=n_regions,
                            device=dev)
    sim = Simulation(
        pop.table, pop.profiles, pop.tariffs, inputs, cfg,
        run_config or RunConfig(), with_hourly=p.with_hourly, device=dev,
    )
    return sim, pop, meta
