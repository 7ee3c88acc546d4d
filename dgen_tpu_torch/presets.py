"""The five BASELINE.json benchmark configurations as presets, and the
preset runner (port of ``dgen_tpu/presets.py``).

Populations are synthetic at the config's scale and sector mix. The
scenario trajectories come from a reference-format ``input_data/``
directory when ``input_root`` names one (``io.reference_inputs``: 9
census-division regions, the wholesale sell-rate bank from
``wholesale_profile_bank``), else they are the uniform synthetic
defaults; ``meta["data_sources"]`` and ``meta["market_curves"]`` say
which, and every run's ``meta.json`` carries them.

    python -m dgen_tpu_torch.presets NAME [--agents N] [--run-dir DIR]
        [--no-export] [--checkpoint] [--device cpu] [--input-root DIR]

builds the preset, runs every model year on the card (``--device cpu``:
the plain versions on the CPU), writes the three result surfaces of every
year into the run directory (``io.export``; ``--no-export`` writes none),
checkpoints the carry every year under ``<run dir>/ckpt`` with
``--checkpoint``, and prints the run's one-line JSON record last. The run
directory defaults to ``runs/preset-<name>-<unix time>``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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


#: regions of a synthetic world (an ingested one has the input root's:
#: the 9 census divisions)
SYNTH_REGIONS = 10


def population(name: str, n_agents: int, rate_switch_frac: float = 0.0,
               device="cuda", n_regions: int = SYNTH_REGIONS):
    """The synthetic population of a named preset (``io.synth``, seed 7,
    ``n_regions`` regions) on ``device``: what :func:`build` runs, without
    the Simulation."""
    from dgen_tpu_torch.io import synth

    p = PRESETS[name]
    return synth.generate_population(
        int(n_agents), states=p.states, seed=7, sector_weights=p.sector_weights,
        n_regions=n_regions, rate_switch_frac=rate_switch_frac, device=device,
    )


def world(
    name: str,
    n_agents: Optional[int] = None,
    end_year: Optional[int] = None,
    rate_switch_frac: float = 0.0,
    device="cuda",
    attachment_rate: Optional[float] = None,
    input_root: Optional[str] = None,
):
    """(population, ScenarioConfig, ScenarioInputs, with_hourly, meta) of a
    named preset on ``device``, without a Simulation: what :func:`build`
    runs, and what a sweep or an ensemble places once for many scenarios.
    The keywords are :func:`build`'s."""
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models.scenario import uniform_inputs

    dev = resolve_device(device)
    p = PRESETS[name]
    cfg = ScenarioConfig(
        name=p.name, start_year=p.start_year,
        end_year=p.end_year if end_year is None else end_year,
        storage_enabled=p.storage_enabled, anchor_years=(),
    )
    n = int(n_agents or p.default_agents)
    meta: Dict[str, object] = {
        "preset": p.name, "baseline_config": p.baseline_config,
        "n_agents": n,
    }
    # the inputs cover the full state list: populations index global
    # state ids even when only the preset's states are populated
    n_groups = len(synth.STATES) * len(cfg.sectors)
    overrides = None
    if attachment_rate is not None:
        overrides = {"attachment_rate": np.full(n_groups, attachment_rate, np.float32)}
    if input_root is not None and os.path.isdir(input_root):
        from dgen_tpu_torch.io.reference_inputs import (
            scenario_inputs_from_reference, wholesale_profile_bank)

        prefer = ({"load_growth": p.load_growth_scenario}
                  if p.load_growth_scenario else None)
        inputs, ref_meta = scenario_inputs_from_reference(
            input_root, cfg, list(synth.STATES), prefer=prefer, overrides=overrides,
            device=dev)
        meta["data_sources"] = ref_meta["data_sources"]
        meta["market_curves"] = ref_meta["market_curves"]
        pop = population(name, n, rate_switch_frac=rate_switch_frac, device=dev,
                         n_regions=len(ref_meta["regions"]))
        wholesale = torch.from_numpy(wholesale_profile_bank(ref_meta, input_root))
        pop = dataclasses.replace(pop, profiles=dataclasses.replace(
            pop.profiles, wholesale=wholesale.to(dev)))
    else:
        meta["data_sources"] = {"all": "synthetic_default"}
        meta["market_curves"] = {"mms": "synthetic_default", "bass": "synthetic_default"}
        pop = population(name, n, rate_switch_frac=rate_switch_frac, device=dev)
        inputs = uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                n_regions=pop.n_regions, overrides=overrides,
                                device=dev)
    return pop, cfg, inputs, p.with_hourly, meta


def build(
    name: str,
    n_agents: Optional[int] = None,
    run_config: Optional[RunConfig] = None,
    end_year: Optional[int] = None,
    rate_switch_frac: float = 0.0,
    device="cuda",
    attachment_rate: Optional[float] = None,
    input_root: Optional[str] = None,
):
    """(Simulation, population, meta) for a named preset on ``device``.

    ``end_year`` cuts the run's depth (the preset's own by default);
    ``rate_switch_frac`` gives that share of residential agents a DG
    rate switch on adoption; ``attachment_rate`` sets every group's
    battery attachment rate (the synthetic default's is 0, so no
    battery adopters are allocated; it wins over an ingested rate).
    ``input_root``: a reference-format ``input_data/`` directory whose
    trajectories, market data, NEM caps and drop-ins the scenario
    ingests (the preset's ``load_growth_scenario`` preferred); a path
    that is no directory, or None, keeps the synthetic defaults, as the
    JAX package falls back when its reference mount is absent."""
    from dgen_tpu_torch.models.simulation import Simulation

    pop, cfg, inputs, with_hourly, meta = world(
        name, n_agents, end_year=end_year, rate_switch_frac=rate_switch_frac,
        device=device, attachment_rate=attachment_rate, input_root=input_root)
    sim = Simulation(
        pop.table, pop.profiles, pop.tariffs, inputs, cfg,
        run_config or RunConfig(), with_hourly=with_hourly, device=resolve_device(device),
    )
    meta["agent_chunk"] = sim._agent_chunk
    return sim, pop, meta


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


class _TimedExporter:
    """RunExporter wrapper that adds up the exporter's host seconds. It
    forwards the split fetch/write protocol too, so the host-I/O pipeline
    drives the exporter through its fetch stage, and times the writes."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0

    def prepare(self, year, year_idx, outs):
        self.inner.prepare(year, year_idx, outs)

    def __call__(self, year, year_idx, outs):
        t0 = time.perf_counter()
        self.inner(year, year_idx, outs)
        self.seconds += time.perf_counter() - t0

    def device_payload(self, year, year_idx, outs):
        return self.inner.device_payload(year, year_idx, outs)

    def write_host(self, year, year_idx, host):
        t0 = time.perf_counter()
        self.inner.write_host(year, year_idx, host)
        self.seconds += time.perf_counter() - t0

    def stamp_hostio(self, stats):
        self.inner.stamp_hostio(stats)


def timed_run(sim, meta: dict, t_start: float, build_s: float,
              callback: Optional[Callable] = None,
              checkpoint_dir: Optional[str] = None,
              run_dir: Optional[str] = None) -> Dict[str, object]:
    """Run every model year of a built preset with ``collect=False``
    (``callback`` and ``checkpoint_dir`` as ``Simulation.run`` takes them)
    and return its record: the keys of the JAX package's ``run_preset``,
    plus ``device``, ``year_s`` and the host-I/O pipeline's ``host_io_s``,
    ``host_blocked_s`` and ``overlap_efficiency`` (None when the run had
    no pipeline). ``year_s``: each year's step wall, ending in
    ``torch.cuda.synchronize()`` on a card; ``compile_s``: the first year
    less the median of the others (the first year's one-time costs);
    ``steady_year_s``: the run's wall net of ``compile_s``, a year;
    ``export_overlapped_s``: the exporter's host seconds (a callback's
    ``seconds``), overlapped with the device, so not subtracted;
    ``agent_years_per_sec``: real agents x years over the total wall,
    set-up included, as the JAX package counts it (to 3 decimals where it
    rounds to 1: on the CPU the rate can be a few agent-years a second)."""
    year_s: list = []
    t0 = time.perf_counter()
    with year_timer(sim, year_s):
        res = sim.run(callback=callback, collect=False, checkpoint_dir=checkpoint_dir)
    run_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_start
    n_real = int(np.asarray(sim.host_mask).sum())
    n_years = len(res.years)
    compile_s = (max(year_s[0] - float(np.median(year_s[1:])), 0.0)
                 if len(year_s) > 1 else 0.0)
    stats = sim.hostio_stats or {}
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
        "export_overlapped_s": round(getattr(callback, "seconds", 0.0), 3),
        "agent_years_per_sec": round(n_real * n_years / total_s, 3),
        "run_dir": run_dir,
        "data_sources": meta["data_sources"],
        "device": device_label(sim.device),
        "year_s": [round(t, 4) for t in year_s],
        "host_io_s": stats.get("host_io_s"),
        "host_blocked_s": stats.get("host_blocked_s"),
        "overlap_efficiency": stats.get("overlap_efficiency"),
    }


def run_preset(
    name: str,
    n_agents: Optional[int] = None,
    run_dir: Optional[str] = None,
    export: bool = True,
    checkpoint: bool = False,
    device="cuda",
    input_root: Optional[str] = None,
) -> Dict[str, object]:
    """Build and run a preset end to end on ``device`` (the card by
    default) at its full depth; returns the run's record
    (:func:`timed_run`): cold start, every model year, and with
    ``export`` the three surfaces of every year written to ``run_dir``
    (``runs/preset-<name>-<unix time>`` by default); ``checkpoint`` saves
    the carry every year under ``<run_dir>/ckpt``; ``input_root`` as
    :func:`build` takes it."""
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.io.export import RunExporter, static_frame_from_table

    t_start = time.perf_counter()
    sim, pop, meta = build(name, n_agents=n_agents, device=device, input_root=input_root)
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    build_s = time.perf_counter() - t_start
    callback = None
    if export or checkpoint:
        # checkpointing needs a run directory even when exports are off
        run_dir = run_dir or os.path.join("runs", f"preset-{name}-{int(time.time())}")
    if export:
        callback = _TimedExporter(RunExporter(
            run_dir, agent_id=sim.host_agent_id, mask=sim.host_mask,
            state_names=None, meta=meta, device=sim.device,
            static_frame=static_frame_from_table(pop.table, states=list(synth.STATES))))
    return timed_run(sim, meta, t_start, build_s, callback=callback,
                     checkpoint_dir=os.path.join(run_dir, "ckpt") if checkpoint else None,
                     run_dir=run_dir)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run a BASELINE.json preset end to end")
    ap.add_argument("name", choices=sorted(PRESETS))
    ap.add_argument("--agents", type=int, default=None)
    ap.add_argument("--run-dir", default=None,
                    help="where the surfaces and checkpoints go (default "
                         "runs/preset-<name>-<unix time>)")
    ap.add_argument("--no-export", action="store_true",
                    help="write no surfaces")
    ap.add_argument("--checkpoint", action="store_true",
                    help="checkpoint the carry every year under <run dir>/ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--input-root", default=None,
                    help="a reference-format input_data directory to ingest "
                         "(default: the synthetic trajectories)")
    args = ap.parse_args(argv)

    p = PRESETS[args.name]
    print(f"preset {p.name}: {p.baseline_config}")
    rec = run_preset(args.name, n_agents=args.agents, run_dir=args.run_dir,
                     export=not args.no_export, checkpoint=args.checkpoint,
                     device=args.device, input_root=args.input_root)
    print(f"build {rec['build_s']}s | compile ~{rec['compile_s']}s | "
          f"steady year {rec['steady_year_s']}s | total {rec['total_s']}s "
          f"({rec['agent_years_per_sec']} agent-years/sec) | chunk "
          f"{rec['agent_chunk']} | {rec['device']} | run dir {rec['run_dir']}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
