"""Sweep outputs (port of ``dgen_tpu/sweep/results.py``): per-scenario
:class:`~dgen_tpu_torch.models.simulation.SimResults`, the
cross-scenario delta report, and the export of every scenario's
surfaces with the scenario stamped into its ``meta.json``.

The port writes the surfaces as ``.npz`` (``io.export.RunExporter``)
under ``<run_dir>/scenario=<label>/``, ``sweep.json`` at the top, and an
ensemble's long-form quantile table as ``quantiles.npz`` beside it;
``io.export.to_parquet`` rewrites the directory into the JAX package's
parquet layout on the CPU side.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from dgen_tpu_torch.models.simulation import SimResults

logger = logging.getLogger(__name__)

#: an ensemble's long-form quantile table beside sweep.json
QUANTILES_FILE = "quantiles.npz"


class _YearView:
    """One (scenario, year) slice of collected host results with the
    YearOutputs attribute surface RunExporter reads, so the export path
    is the single-run exporter unchanged."""

    def __init__(self, res: SimResults, yi: int) -> None:
        self._res = res
        self._yi = yi

    def __getattr__(self, name: str):
        import torch

        if name == "state_hourly_net_mw":
            h = self._res.state_hourly_net_mw
            if h is None:
                return torch.zeros((0, 0), dtype=torch.float32)
            return torch.from_numpy(np.ascontiguousarray(h[self._yi]))
        try:
            return torch.from_numpy(np.ascontiguousarray(self._res.agent[name][self._yi]))
        except KeyError as e:
            raise AttributeError(name) from e


@dataclasses.dataclass
class SweepResults:
    """Host-side results of an S-scenario sweep."""

    labels: List[str]
    baseline: int                 # index of the delta reference
    runs: List[SimResults]        # one per scenario, label-aligned
    plan: object                  # the SweepPlan that ran
    bank_bytes_shared: int        # profile-bank bytes on the card once
    host_mask: np.ndarray
    host_agent_id: np.ndarray
    #: load-time quarantine summary of the shared population (None =
    #: clean or validation off); stamped into every scenario's meta.json
    #: and into sweep.json by :meth:`export`
    quarantine: Optional[Dict[str, object]] = None
    #: an ensemble's quantile bands (``ensemble.stats.EnsembleStats``);
    #: None for ordinary sweeps
    quantiles: Optional[object] = None

    @property
    def n_scenarios(self) -> int:
        return len(self.runs)

    def __getitem__(self, label_or_idx) -> SimResults:
        if isinstance(label_or_idx, str):
            return self.runs[self.labels.index(label_or_idx)]
        return self.runs[label_or_idx]

    def summaries(self) -> List[Dict[str, np.ndarray]]:
        """Per-scenario national per-year aggregates (SimResults.summary)."""
        return [r.summary(self.host_mask) for r in self.runs]

    def delta_report(self) -> Dict[str, object]:
        """Deltas against the baseline scenario: per-year national
        adoption, capacity, storage and fleet NPV, and final-year scalars.
        Resume-safe as in the JAX package: the deltas cover the years
        every run with collected years covers, a run with none is a
        ``no_new_years`` entry; raises ValueError when the baseline has no
        collected years."""
        m = self.host_mask
        base_run = self.runs[self.baseline]
        if not base_run.agent:
            raise ValueError(
                f"baseline scenario '{self.labels[self.baseline]}' has "
                "no collected years (fully resumed, or collect=False); "
                "no delta report is possible")
        nonempty = [i for i, r in enumerate(self.runs) if r.agent]
        years = [y for y in base_run.years
                 if all(y in self.runs[i].years for i in nonempty)]
        if not years:
            raise ValueError("no common collected years across scenarios; rerun the "
                             "sweep without resume for a full delta report")

        def curves(i):
            r = self.runs[i]
            sel = np.asarray([r.years.index(y) for y in years])
            s = r.summary(m)
            npv = (r.agent["npv"] * m[None, :]).sum(axis=1)
            return {k: np.asarray(v)[sel] for k, v in s.items()}, npv[sel]

        base, base_npv = curves(self.baseline)
        scenarios = []
        for i, label in enumerate(self.labels):
            if i not in nonempty:
                scenarios.append({"scenario": label, "is_baseline": i == self.baseline,
                                  "no_new_years": True})
                continue
            s, npv = curves(i)
            d_adopt = np.asarray(s["adopters"] - base["adopters"])
            d_kw = np.asarray(s["system_kw_cum"] - base["system_kw_cum"])
            d_kwh = np.asarray(s["batt_kwh_cum"] - base["batt_kwh_cum"])
            d_npv = np.asarray(npv - base_npv)
            scenarios.append({
                "scenario": label,
                "is_baseline": i == self.baseline,
                "adopters_delta": [float(v) for v in d_adopt],
                "system_kw_cum_delta": [float(v) for v in d_kw],
                "batt_kwh_cum_delta": [float(v) for v in d_kwh],
                "npv_total_delta": [float(v) for v in d_npv],
                "final": {
                    "adopters": float(s["adopters"][-1]),
                    "adopters_delta": float(d_adopt[-1]),
                    "system_kw_cum": float(s["system_kw_cum"][-1]),
                    "system_kw_cum_delta": float(d_kw[-1]),
                    "batt_kwh_cum_delta": float(d_kwh[-1]),
                    "npv_total_delta": float(d_npv[-1]),
                },
            })
        return {"baseline": self.labels[self.baseline],
                "years": [int(y) for y in years],
                "scenarios": scenarios}

    def export(self, run_dir: str, state_names: Optional[Sequence[str]] = None,
               meta: Optional[Dict[str, object]] = None,
               finance_series: bool = True) -> str:
        """Write every scenario's three surfaces under
        ``<run_dir>/scenario=<label>/`` (the single-run RunExporter, the
        scenario stamped into each meta.json) and the delta report as
        ``sweep.json`` at the top; an ensemble's quantiles also go into
        sweep.json and, long-form, into ``quantiles.npz``. A scenario with
        no collected years (resumed) is skipped. Returns ``run_dir``."""
        from dgen_tpu_torch.io.export import RunExporter
        from dgen_tpu_torch.sweep.driver import scenario_meta
        from dgen_tpu_torch.utils.atomic import atomic_write_json, atomic_write_npz

        if all(not r.agent for r in self.runs):
            raise ValueError("no scenario has collected results (collect=False, or a "
                             "fully resumed sweep); nothing to export")
        for i, (label, res) in enumerate(zip(self.labels, self.runs)):
            if not res.agent:
                logger.warning("sweep export: scenario %s has no collected years "
                               "(resumed); skipping", label)
                continue
            exporter = RunExporter(
                os.path.join(run_dir, f"scenario={label}"),
                agent_id=self.host_agent_id, mask=self.host_mask,
                state_names=list(state_names) if state_names else None,
                finance_series=finance_series,
                meta={**scenario_meta(self.labels, i, self.baseline, self.quarantine),
                      **(meta or {})},
            )
            for yi, year in enumerate(res.years):
                exporter(int(year), yi, _YearView(res, yi))
        try:
            report = self.delta_report()
        except ValueError as e:
            report = {"delta_report_unavailable": str(e),
                      "baseline": self.labels[self.baseline]}
        report["bank_bytes_shared"] = int(self.bank_bytes_shared)
        if self.quarantine:
            report["quarantine"] = self.quarantine
        report["groups"] = [
            {"mode": g.mode, "net_billing": bool(g.net_billing),
             "scenarios": [self.labels[i] for i in g.indices]}
            for g in self.plan.groups
        ]
        if self.quantiles is not None:
            report["quantiles"] = self.quantiles.to_json()
            atomic_write_npz(os.path.join(run_dir, QUANTILES_FILE),
                             self.quantiles.columns())
        atomic_write_json(os.path.join(run_dir, "sweep.json"), report, indent=1)
        return run_dir
