"""The fault drill: every fault site of the run path fires mid-run, the
supervisor retries or resumes, and the recovered run's ``.npz`` files
equal those of an uninterrupted run byte for byte (port of
``dgen_tpu/resilience/drill.py``).

``python -m dgen_tpu_torch.resilience drill`` runs it (on the card by
default, ``--device cpu`` for the plain versions). Per site, a fresh
supervised run writes its own directory, and the drill checks that:

* the fault fired (a drill that injects nothing proves nothing);
* the supervisor retried and the run succeeded;
* every ``.npz`` partition is byte-identical to the clean run's, except
  under the ``oom`` site, whose re-entry runs at half the chunk (an
  equivalent computation in another order): its years are compared
  numerically at the chunked-equivalence tolerance;
* ``verify_run_dir`` passes on the recovered directory.

A drill runs on a :class:`DrillWorld`: the JAX drill's synthetic
population by default (:func:`synth_world`), or a preset's
(:func:`preset_world`, the card's phase runs ercot-all-sector).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from dgen_tpu_torch.resilience import faults as faults_mod
from dgen_tpu_torch.resilience.manifest import SURFACE_DIRS, verify_run_dir
from dgen_tpu_torch.resilience.supervisor import RetryPolicy, run_supervised

logger = logging.getLogger(__name__)

#: the drill matrix: every run-path fault site, hit mid-run
DRILL_SPECS = (
    ("year_step", "year_step@2"),
    ("year_step_oom", "year_step@2:oom"),
    ("ckpt_save", "ckpt_save@2"),
    ("hostio_fetch", "hostio_fetch@1"),
    ("hostio_io", "hostio_io@2"),
    ("export_write", "export_write@2"),
    ("export_torn", "export_torn@2:truncate"),
)

#: tolerance of degraded (chunk-halved) re-entries: the chunked-vs-whole
#: envelope of tests/test_simulation.py
OOM_RTOL = 2e-5
OOM_ATOL = 1e-4

@dataclasses.dataclass(frozen=True)
class DrillWorld:
    """A drill's population and how its Simulations are built.
    ``make_population(n_agents)`` is called inside the fault contexts (the
    ingest site fires while the table is built)."""

    make_population: Callable[[int], object]
    device: str = "cuda"
    storage_enabled: bool = True
    with_hourly: bool = False
    #: RunConfig.sizing_iters of every attempt (None: the config's own)
    sizing_iters: Optional[int] = 8
    name: str = "drill"
    #: the cash-flow horizon of every Simulation (its default: 25 years)
    econ_years: int = 25

    def scenario(self, end_year: int, name: Optional[str] = None):
        from dgen_tpu_torch.config import ScenarioConfig

        return ScenarioConfig(name=name or self.name, start_year=2014,
                              end_year=end_year, anchor_years=(),
                              storage_enabled=self.storage_enabled)

    def runner(self, pop, cfg, prequarantine=None) -> Callable:
        """``make_sim(run_config) -> Simulation`` over ``pop`` (built once;
        each attempt places it under the attempt's config, which is how
        the degradations take effect)."""
        from dgen_tpu_torch.models import scenario as scen
        from dgen_tpu_torch.models.simulation import Simulation

        inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                     n_regions=pop.n_regions, device=self.device)

        def make_sim(rc):
            if self.sizing_iters is not None:
                rc = dataclasses.replace(rc, sizing_iters=self.sizing_iters)
            return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                              with_hourly=self.with_hourly, econ_years=self.econ_years,
                              device=self.device, quarantine=prequarantine)

        return make_sim


def synth_world(states=("DE", "CA"), sizing_iters: int = 8, device="cuda") -> DrillWorld:
    """The JAX drill's world: ``io.synth`` over ``states``, seed 11,
    padded to 64 rows, no hourly aggregate."""
    from dgen_tpu_torch.io import synth

    def make_population(n_agents: int):
        return synth.generate_population(n_agents, states=list(states), seed=11,
                                         pad_multiple=64, device=device)

    return DrillWorld(make_population=make_population, device=device,
                      sizing_iters=sizing_iters)


def preset_world(name: str, device="cuda") -> DrillWorld:
    """A preset's world (``presets.population``; its storage and hourly
    settings, the config's own sizing iterations)."""
    from dgen_tpu_torch import presets

    p = presets.PRESETS[name]
    return DrillWorld(
        make_population=lambda n: presets.population(name, n, device=device),
        device=device, storage_enabled=p.storage_enabled, with_hourly=p.with_hourly,
        sizing_iters=None, name=name)


def make_synth_runner(n_agents: int = 96, states=("DE", "CA"), end_year: int = 2016,
                      sizing_iters: int = 8, device="cuda") -> Callable:
    """``make_sim(run_config) -> Simulation`` over the JAX drill's
    synthetic population (built once)."""
    world = synth_world(states, sizing_iters, device)
    return world.runner(world.make_population(n_agents), world.scenario(end_year))


def _npz_files(run_dir: str) -> List[str]:
    out = []
    for sub in SURFACE_DIRS:
        d = os.path.join(run_dir, sub)
        if os.path.isdir(d):
            out.extend(os.path.join(sub, f) for f in sorted(os.listdir(d))
                       if f.endswith(".npz"))
    return out


#: tolerance of a surface a caller names in ``approx``: a card sums the
#: state-hourly aggregate with atomics (``index_add_``), so two runs of the
#: same year may differ in the last bits there (chip_smoke.py [3c]'s bound)
APPROX_RTOL = 1e-4
APPROX_ATOL = 1e-5


def _columns_close(pa: str, pb: str, rtol: float, quant_step: bool, atol: float) -> bool:
    """Two partitions' columns equal within ``rtol`` and ``atol`` (float
    columns; with ``quant_step`` the atol is at least two int16 steps of
    the column, for compact exports) and exactly (the others)."""
    with np.load(pa, allow_pickle=False) as za, np.load(pb, allow_pickle=False) as zb:
        if sorted(za.files) != sorted(zb.files):
            return False
        for k in za.files:
            va, vb = za[k], zb[k]
            if va.shape != vb.shape:
                return False
            if va.dtype.kind in "fc":
                tol = atol
                if quant_step and va.size:
                    tol = max(float(np.max(np.abs(va))) / 32766.0 * 2.0, atol)
                if not np.allclose(va, vb, rtol=rtol, atol=tol, equal_nan=True):
                    return False
            elif not np.array_equal(va, vb):
                return False
    return True


def compare_run_dirs(clean: str, recovered: str, numeric: bool = False,
                     approx=()) -> Dict[str, object]:
    """Compare every ``.npz`` partition of two run directories:
    ``numeric=False`` demands byte equality; ``numeric=True`` compares the
    columns at the OOM re-entry's tolerance instead (an int16 step of
    compact exports plus the chunked-equivalence envelope). A partition of
    a surface named in ``approx`` that is not byte-equal is held at
    :data:`APPROX_RTOL` / :data:`APPROX_ATOL` and listed under
    ``approx_equal``."""
    a, b = set(_npz_files(clean)), set(_npz_files(recovered))
    rec: Dict[str, object] = {
        "only_in_clean": sorted(a - b),
        "only_in_recovered": sorted(b - a),
        "mismatched": [],
        "approx_equal": [],
        "compared": len(a & b),
    }
    for rel in sorted(a & b):
        pa, pb = os.path.join(clean, rel), os.path.join(recovered, rel)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() == fb.read():
                continue
        if numeric and _columns_close(pa, pb, OOM_RTOL * 5, True, OOM_ATOL):
            continue
        if rel.split(os.sep)[0] in approx and _columns_close(
                pa, pb, APPROX_RTOL, False, APPROX_ATOL):
            rec["approx_equal"].append(rel)
            continue
        rec["mismatched"].append(rel)
    rec["ok"] = not (rec["only_in_clean"] or rec["only_in_recovered"]
                     or rec["mismatched"])
    return rec


def run_drill(
    root: str,
    *,
    n_agents: int = 96,
    end_year: int = 2016,
    specs=DRILL_SPECS,
    policy: Optional[RetryPolicy] = None,
    make_runner: Optional[Callable] = None,
    device="cuda",
    world: Optional[DrillWorld] = None,
    run_config=None,
    approx=(),
) -> Dict[str, object]:
    """Run the fault matrix under ``root`` and return the drill record
    (``ok``, and per site the retries, the degradations and the walls).
    ``make_runner`` (a ``make_sim``) or ``world`` pick the population
    (default: :func:`synth_world` on ``device``); ``run_config`` is every
    run's starting config (default ``RunConfig()``); ``approx`` as in
    :func:`compare_run_dirs`."""
    from dgen_tpu_torch.config import RunConfig

    if make_runner is None:
        world = world or synth_world(device=device)
        make_runner = world.runner(world.make_population(n_agents),
                                   world.scenario(end_year))
    make_sim = make_runner
    rc0 = run_config or RunConfig()
    policy = policy or RetryPolicy(max_retries=3, backoff_base_s=0.01, min_agent_chunk=32)
    clean_dir = os.path.join(root, "clean")
    t0 = time.perf_counter()
    _, rep_clean = run_supervised(make_sim, rc0, run_dir=clean_dir, collect=False,
                                  policy=policy)
    clean_wall = time.perf_counter() - t0
    if rep_clean.retries:
        raise AssertionError("the clean baseline retried")

    sites: Dict[str, dict] = {}
    ok = True
    for name, spec in specs:
        d = os.path.join(root, name)
        t0 = time.perf_counter()
        with faults_mod.injected(spec) as reg:
            _, report = run_supervised(make_sim, rc0, run_dir=d, collect=False,
                                       policy=policy)
        site = faults_mod.parse_spec(spec)[0].site
        fired = reg.fired(site)
        cmp_rec = compare_run_dirs(clean_dir, d, numeric=(":oom" in spec),
                                   approx=approx)
        verify_ok = all(r.ok for r in verify_run_dir(d))
        site_ok = bool(fired and report.succeeded and report.retries >= 1
                       and cmp_rec["ok"] and verify_ok)
        ok = ok and site_ok
        sites[name] = {
            "spec": spec,
            "fired": fired,
            "retries": report.retries,
            "degradations": report.degradations,
            "final_agent_chunk": report.final_agent_chunk,
            "recovery_wall_s": round(report.recovery_wall_s, 3),
            "drill_wall_s": round(time.perf_counter() - t0, 3),
            "npz": {"compared": cmp_rec["compared"],
                    "mismatched": cmp_rec["mismatched"],
                    "approx_equal": cmp_rec["approx_equal"]},
            "verify_ok": verify_ok,
            "ok": site_ok,
        }
        logger.info("fault drill %s: %s (retries=%d, recovery %.2fs)", name,
                    "ok" if site_ok else "FAILED", report.retries,
                    report.recovery_wall_s)
    return {
        "ok": ok,
        "n_agents": n_agents,
        "end_year": end_year,
        "clean_wall_s": round(clean_wall, 3),
        "retries_total": sum(s["retries"] for s in sites.values()),
        "recovery_wall_s_total": round(
            sum(s["recovery_wall_s"] for s in sites.values()), 3),
        "sites": sites,
    }
