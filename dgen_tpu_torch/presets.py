"""The five BASELINE.json benchmark configurations as presets, and the
preset runner (port of ``dgen_tpu/presets.py``, synthetic-input branch).

Populations are synthetic at the config's scale and sector mix and the
scenario trajectories are the uniform synthetic defaults; the reference
CSV trajectories are not read by the port yet.

    python -m dgen_tpu_torch.presets NAME --no-export [--agents N] [--device cpu]

builds the preset, runs every model year on the card (``--device cpu``:
the plain versions on the CPU) and prints the run's one-line JSON record
last. Exports and checkpoints are not ported: without ``--no-export``, or
with ``--checkpoint``, the command exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

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
    attachment_rate: Optional[float] = None,
):
    """(Simulation, population, meta) for a named preset on ``device``.

    ``end_year`` cuts the run's depth (the preset's own by default);
    ``rate_switch_frac`` gives that share of residential agents a DG
    rate switch on adoption; ``attachment_rate`` sets every group's
    battery attachment rate (the synthetic default's is 0, so no
    battery adopters are allocated)."""
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
    overrides = None
    if attachment_rate is not None:
        overrides = {"attachment_rate": np.full(pop.table.n_groups, attachment_rate,
                                                np.float32)}
    inputs = uniform_inputs(cfg, n_groups=pop.table.n_groups, n_regions=n_regions,
                            overrides=overrides, device=dev)
    sim = Simulation(
        pop.table, pop.profiles, pop.tariffs, inputs, cfg,
        run_config or RunConfig(), with_hourly=p.with_hourly, device=dev,
    )
    meta["agent_chunk"] = sim._agent_chunk
    return sim, pop, meta


#: what the runner cannot do yet, and where the work is queued
NOT_PORTED = ("exports and checkpoints are not ported yet (ROADMAP.md §1, "
              "modules to port: Run outputs)")


def device_label(device: torch.device) -> str:
    """``"cpu"``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    name alone, and why, where nvidia-smi cannot be read)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


@contextlib.contextmanager
def year_timer(sim, year_s: list):
    """Inside the block, each model year ``sim`` steps appends its wall
    to ``year_s``, ending in ``torch.cuda.synchronize()`` on a card; the
    step is restored after."""
    cuda = sim.device.type == "cuda"
    orig_step = sim.step

    def timed_step(carry, yi, first_year):
        t0 = time.perf_counter()
        out = orig_step(carry, yi, first_year)
        if cuda:
            torch.cuda.synchronize(sim.device)
        year_s.append(time.perf_counter() - t0)
        return out

    sim.step = timed_step
    try:
        yield year_s
    finally:
        sim.step = orig_step


def timed_run(sim, meta: dict, t_start: float, build_s: float,
              callback: Optional[Callable] = None) -> Dict[str, object]:
    """Run every model year of a built preset with ``collect=False``
    and return its record (the keys of the JAX package's
    ``run_preset``, plus ``device`` and ``year_s``). ``year_s``: each
    year's wall, ending in ``torch.cuda.synchronize()`` on a card;
    ``compile_s``: the first year less the median of the others (the
    first year's one-time costs); ``steady_year_s``: the run's wall net of
    ``compile_s``, a year; ``agent_years_per_sec``: real agents x years
    over the total wall, set-up included, as the JAX package counts it."""
    year_s: list = []
    t0 = time.perf_counter()
    with year_timer(sim, year_s):
        res = sim.run(callback=callback, collect=False)
    run_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_start
    n_real = int(np.asarray(sim.host_mask).sum())
    n_years = len(res.years)
    compile_s = (max(year_s[0] - float(np.median(year_s[1:])), 0.0)
                 if len(year_s) > 1 else 0.0)
    name = meta["preset"]
    return {
        "preset": name,
        "agents": n_real,
        "years": n_years,
        "agent_chunk": meta["agent_chunk"],
        "with_hourly": PRESETS[name].with_hourly,
        "storage": PRESETS[name].storage_enabled,
        "total_s": round(total_s, 3),
        "build_s": round(build_s, 3),
        "run_s": round(run_s, 3),
        "compile_s": round(compile_s, 3),
        "steady_year_s": round(max(run_s - compile_s, 0.0) / max(n_years, 1), 4),
        "export_overlapped_s": 0.0,
        "agent_years_per_sec": round(n_real * n_years / total_s, 1),
        "run_dir": None,
        "data_sources": meta["data_sources"],
        "device": device_label(sim.device),
        "year_s": [round(t, 4) for t in year_s],
    }


def run_preset(
    name: str,
    n_agents: Optional[int] = None,
    export: bool = True,
    checkpoint: bool = False,
    device="cuda",
) -> Dict[str, object]:
    """Build and run a preset end to end on ``device`` (the card by
    default) at its full depth; returns the run's record
    (:func:`timed_run`). ``export`` and ``checkpoint`` are not ported
    and raise ``NotImplementedError``."""
    if export or checkpoint:
        raise NotImplementedError(NOT_PORTED)
    t_start = time.perf_counter()
    sim, _, meta = build(name, n_agents=n_agents, device=device)
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    return timed_run(sim, meta, t_start, time.perf_counter() - t_start)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run a BASELINE.json preset end to end")
    ap.add_argument("name", choices=sorted(PRESETS))
    ap.add_argument("--agents", type=int, default=None)
    ap.add_argument("--no-export", action="store_true")
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if not args.no_export or args.checkpoint:
        print(f"{NOT_PORTED}; pass --no-export (and no --checkpoint) to run "
              "without them", file=sys.stderr)
        return 2

    p = PRESETS[args.name]
    print(f"preset {p.name}: {p.baseline_config}")
    rec = run_preset(args.name, n_agents=args.agents, export=False,
                     device=args.device)
    print(f"build {rec['build_s']}s | compile ~{rec['compile_s']}s | "
          f"steady year {rec['steady_year_s']}s | total {rec['total_s']}s "
          f"({rec['agent_years_per_sec']} agent-years/sec) | chunk "
          f"{rec['agent_chunk']} | {rec['device']}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
