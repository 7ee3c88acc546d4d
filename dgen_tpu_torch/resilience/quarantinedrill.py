"""The quarantine drill: corrupt rows injected at ingest, at bank load
and mid-run are detected, attributed to exactly the injected rows and
contained, with the supervised run's ``.npz`` files byte-identical to a
clean baseline's on every row that is not quarantined (port of
``dgen_tpu/resilience/quarantinedrill.py``).

``python -m dgen_tpu_torch.resilience drill --quarantine`` runs it
(``--fast``: the two load-time rounds).

Rounds:

* **ingest**: ``ingest_corrupt_row`` (kind ``corrupt``) damages two
  deterministic agent rows while the table is built (a NaN customer
  count, an out-of-range tariff reference). Validation must quarantine
  exactly those rows, the run must succeed on its first attempt (no
  retry: detection beats failure), and every partition must equal, byte
  for byte, a clean-population run under the same quarantine report.
* **bank**: ``bank_corrupt_row@1`` sets a profile-bank row to NaN at
  load. Validation must quarantine every agent referencing it and zero
  the row, and the files must again equal the pre-quarantined clean
  run's.
* **sentinel** (not under ``fast``): ``bank_corrupt_row@3`` flips the row
  mid-run, after a clean exported year. The health sentinel must breach
  at that year (which is never exported), the supervisor must attribute
  and quarantine exactly the referencing agents and resume from the last
  checkpoint, the years before the breach must equal an uninterrupted
  clean run's byte for byte, and the years run again must be finite with
  the quarantined agents absent.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np

from dgen_tpu_torch.resilience import faults as faults_mod
from dgen_tpu_torch.resilience.drill import DrillWorld, compare_run_dirs, synth_world
from dgen_tpu_torch.resilience.manifest import SURFACE_DIRS, verify_run_dir
from dgen_tpu_torch.resilience.quarantine import QuarantineReport
from dgen_tpu_torch.resilience.supervisor import RetryPolicy, run_supervised

logger = logging.getLogger(__name__)


def _load_report(run_dir: str) -> QuarantineReport:
    return QuarantineReport.load(os.path.join(run_dir, "quarantine.json"))


def _exported_ids(run_dir: str, year: int) -> np.ndarray:
    p = os.path.join(run_dir, "agent_outputs", f"year={year}.npz")
    with np.load(p, allow_pickle=False) as z:
        return z["agent_id"]


def _all_npz_finite(run_dir: str) -> bool:
    for sub in SURFACE_DIRS:
        d = os.path.join(run_dir, sub)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if not f.endswith(".npz"):
                continue
            with np.load(os.path.join(d, f), allow_pickle=False) as z:
                for k in z.files:
                    v = z[k]
                    if v.dtype.kind in "fc" and not np.isfinite(v).all():
                        return False
    return True


def run_quarantine_drill(
    root: str,
    *,
    n_agents: int = 96,
    end_year: int = 2016,
    fast: bool = False,
    policy: Optional[RetryPolicy] = None,
    device="cuda",
    world: Optional[DrillWorld] = None,
    run_config=None,
    approx=(),
) -> Dict[str, object]:
    """Run the drill under ``root``; returns its record (``ok`` and each
    round's detail). ``world`` picks the population (default:
    :func:`~dgen_tpu_torch.resilience.drill.synth_world` on ``device``);
    ``run_config`` is every run's starting config (default
    ``RunConfig()``); ``approx`` as in :func:`~dgen_tpu_torch.resilience.
    drill.compare_run_dirs`."""
    from dgen_tpu_torch.config import RunConfig

    world = world or synth_world(device=device)
    rc0 = run_config or RunConfig()
    policy = policy or RetryPolicy(max_retries=3, backoff_base_s=0.01)
    cfg = world.scenario(end_year, name="qdrill")
    pop = world.make_population(n_agents)
    keep = (pop.table.mask > 0).cpu().numpy()
    n_real = int(keep.sum())
    rounds: Dict[str, dict] = {}
    ok = True

    def supervised(make_sim, run_dir):
        return run_supervised(make_sim, rc0, run_dir=run_dir, collect=False,
                              policy=policy)

    # ---- round 1: corrupt rows at ingest --------------------------------
    t0 = time.perf_counter()
    with faults_mod.injected("ingest_corrupt_row@1:corrupt") as reg:
        pop_c = world.make_population(n_agents)
    expected_ingest = sorted({int(r) % n_real for r in faults_mod.corrupt_rows()})
    d_corrupt = os.path.join(root, "ingest")
    _, rep1 = supervised(world.runner(pop_c, cfg), d_corrupt)
    q1 = _load_report(d_corrupt)
    d_base1 = os.path.join(root, "ingest_baseline")
    supervised(world.runner(pop, cfg, prequarantine=q1), d_base1)
    cmp1 = compare_run_dirs(d_base1, d_corrupt, approx=approx)
    verify1 = all(r.ok for r in verify_run_dir(d_corrupt))
    r1_ok = bool(
        reg.fired("ingest_corrupt_row") == 1
        and rep1.succeeded and rep1.retries == 0
        and list(q1.ids) == expected_ingest
        and cmp1["ok"] and verify1
    )
    rounds["ingest"] = {
        "fired": reg.fired("ingest_corrupt_row"),
        "retries": rep1.retries,
        "quarantined_ids": list(q1.ids),
        "expected_ids": expected_ingest,
        "reasons": {str(a): q1.reasons_for(a) for a in q1.ids},
        "npz_bit_exact": cmp1["ok"],
        "compared": cmp1["compared"],
        "verify_ok": verify1,
        "wall_s": round(time.perf_counter() - t0, 3),
        "ok": r1_ok,
    }
    ok = ok and r1_ok
    logger.info("quarantine drill ingest: %s", "ok" if r1_ok else "FAILED")

    # ---- round 2: corrupt bank row at load ------------------------------
    t0 = time.perf_counter()
    n_bank = int(pop.profiles.load.shape[0])
    bank_row = int(faults_mod.corrupt_rows()[0]) % n_bank
    li = pop.table.load_idx.cpu().numpy()
    ids_all = pop.table.agent_id.cpu().numpy()
    expected_bank = sorted(int(a) for a in ids_all[keep & (li == bank_row)])
    d_bank = os.path.join(root, "bank")
    with faults_mod.injected("bank_corrupt_row@1:corrupt") as reg2:
        _, rep2 = supervised(world.runner(pop, cfg), d_bank)
    q2 = _load_report(d_bank)
    d_base2 = os.path.join(root, "bank_baseline")
    supervised(world.runner(pop, cfg, prequarantine=q2), d_base2)
    cmp2 = compare_run_dirs(d_base2, d_bank, approx=approx)
    verify2 = all(r.ok for r in verify_run_dir(d_bank))
    r2_ok = bool(
        reg2.fired("bank_corrupt_row") == 1
        and rep2.succeeded and rep2.retries == 0
        and list(q2.ids) == expected_bank
        and q2.bank_rows.get("load") == [bank_row]
        and cmp2["ok"] and verify2
    )
    rounds["bank"] = {
        "fired": reg2.fired("bank_corrupt_row"),
        "retries": rep2.retries,
        "n_quarantined": q2.n_quarantined,
        "n_expected": len(expected_bank),
        "bank_rows": dict(q2.bank_rows),
        "npz_bit_exact": cmp2["ok"],
        "compared": cmp2["compared"],
        "verify_ok": verify2,
        "wall_s": round(time.perf_counter() - t0, 3),
        "ok": r2_ok,
    }
    ok = ok and r2_ok
    logger.info("quarantine drill bank: %s", "ok" if r2_ok else "FAILED")

    # ---- round 3: silent mid-run corruption -> sentinel -----------------
    if not fast:
        t0 = time.perf_counter()
        cfg3 = world.scenario(max(end_year, 2018), name="qdrill-sentinel")
        d_clean = os.path.join(root, "sentinel_clean")
        _, rep_clean = supervised(world.runner(pop, cfg3), d_clean)
        d_sent = os.path.join(root, "sentinel")
        # hits of bank_corrupt_row in attempt 1: #1 Simulation construction
        # (clean), #2 before the 2014 step, #3 before the 2016 step: the
        # corruption lands after a clean exported year, so only the
        # sentinel can catch it
        with faults_mod.injected("bank_corrupt_row@3:corrupt") as reg3:
            _, rep3 = supervised(world.runner(pop, cfg3), d_sent)
        q3 = _load_report(d_sent)
        breach_year_ok = any("year-2016" in d for d in rep3.degradations)
        # the years before the breach equal the uninterrupted clean run's;
        # the breached year ran again under quarantine, so finiteness and
        # the exclusion are checked there instead
        pre = compare_run_dirs(d_clean, d_sent, approx=approx)
        pre_ok = not any("year=2014" in rel for rel in pre["mismatched"])
        excluded = [bool(np.isin(q3.ids, _exported_ids(d_sent, y)).any())
                    for y in cfg3.model_years[1:]]
        verify3 = all(r.ok for r in verify_run_dir(d_sent))
        r3_ok = bool(
            reg3.fired("bank_corrupt_row") == 1
            and rep_clean.retries == 0
            and rep3.succeeded and rep3.retries >= 1
            and breach_year_ok
            and list(q3.ids) == expected_bank
            and not any(excluded)
            and pre_ok
            and _all_npz_finite(d_sent)
            and verify3
        )
        rounds["sentinel"] = {
            "fired": reg3.fired("bank_corrupt_row"),
            "retries": rep3.retries,
            "degradations": rep3.degradations,
            "n_quarantined": q3.n_quarantined,
            "n_expected": len(expected_bank),
            "pre_breach_bit_exact": pre_ok,
            "quarantined_absent_post_breach": not any(excluded),
            "verify_ok": verify3,
            "wall_s": round(time.perf_counter() - t0, 3),
            "ok": r3_ok,
        }
        ok = ok and r3_ok
        logger.info("quarantine drill sentinel: %s", "ok" if r3_ok else "FAILED")

    return {"ok": ok, "n_agents": n_agents, "end_year": end_year, "fast": fast,
            "rounds": rounds}


if __name__ == "__main__":  # manual runs: python -m ...quarantinedrill
    import tempfile

    rec = run_quarantine_drill(tempfile.mkdtemp(prefix="dgen-qdrill-"))
    print(json.dumps(rec, indent=1))
    raise SystemExit(0 if rec["ok"] else 1)
