"""Dynamic agent populations on the alive mask (port of
``dgen_tpu/ensemble/cohorts.py``).

A cohort ("new construction enters in 2032") is rows of the table from
year 0, placed, padded, clustered and quantized with everyone else, but
with ``mask = 0`` until their entry year, when the year's alive mask
turns them on. Masked rows contribute exact zeros to every reduction
(the quarantine's containment), so the year step is the same before
and after entry.

Entry is one float32 vector ``entry_year`` aligned with the placed
table (:func:`align_entry` pushes an input-table-order vector through
``Simulation.host_row_origin``): ``0.0`` alive from the start, a
calendar year (``2032.0``) alive from that model year on,
:data:`COHORT_NEVER` never (padding, quarantined rows).

Electrification load growth rides the ``load_growth`` trajectory
(:func:`electrified_load_growth`), which ``apply_year`` gathers per
agent: no bank is copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

#: the entry year of a row that is never alive (the port keeps it with
#: the national generator, whose padding rows carry it)
from dgen_tpu_torch.models.synth import COHORT_NEVER  # noqa: F401


@dataclasses.dataclass(frozen=True)
class CohortSchedule:
    """Host-side cohort entry plan: ``entry_year[i]`` is the calendar year
    input-table row i becomes alive (0.0 = alive at start, COHORT_NEVER =
    never)."""

    entry_year: np.ndarray  # [N_input] f32, input-table row order

    def __post_init__(self) -> None:
        e = np.asarray(self.entry_year, dtype=np.float32)
        object.__setattr__(self, "entry_year", e)
        if e.ndim != 1:
            raise ValueError(f"entry_year must be 1-D, got shape {e.shape}")

    @property
    def n_cohort_rows(self) -> int:
        e = self.entry_year
        return int(np.sum((e > 0.0) & (e < COHORT_NEVER)))

    def counts_by_year(self) -> Dict[int, int]:
        """{calendar year: rows entering}."""
        e = self.entry_year
        sel = (e > 0.0) & (e < COHORT_NEVER)
        ys, cs = np.unique(e[sel].astype(np.int64), return_counts=True)
        return {int(y): int(c) for y, c in zip(ys, cs)}


def cohort_alive_mask(mask_pot: torch.Tensor, entry_year: torch.Tensor,
                      year_f) -> torch.Tensor:
    """[N] alive mask of model year ``year_f`` (a float or 0-d float32
    tensor): the potential mask where ``entry_year <= year``, on the
    mask's device."""
    year = torch.as_tensor(year_f, dtype=torch.float32, device=mask_pot.device)
    return mask_pot * (entry_year <= year).to(mask_pot.dtype)


def alive_mask_np(mask_pot: np.ndarray, entry_year: np.ndarray, year: float) -> np.ndarray:
    """NumPy oracle of :func:`cohort_alive_mask`."""
    return np.asarray(mask_pot, np.float32) * (
        np.asarray(entry_year, np.float32) <= np.float32(year)).astype(np.float32)


def potential_mask(base_mask: np.ndarray, entry_year: np.ndarray) -> np.ndarray:
    """[N] float32 potential-population mask: the base-alive rows and every
    cohort row that will ever enter. The ensemble hands ``Simulation`` a
    table with this mask, so placement (the static flags, clustering,
    padding) is decided once over the whole potential population; the
    rows before entry are masked to zero each year by
    :func:`cohort_alive_mask`."""
    base = np.asarray(base_mask, np.float32)
    e = np.asarray(entry_year, np.float32)
    will_enter = ((e > 0.0) & (e < COHORT_NEVER)).astype(np.float32)
    return np.maximum(base, will_enter)


def align_entry(entry_input: np.ndarray, host_row_origin: np.ndarray) -> np.ndarray:
    """An input-table-order entry vector pushed through the placement's
    row origin (``Simulation.host_row_origin``): placed rows take their
    origin row's entry year, rows of origin -1 (padding) COHORT_NEVER."""
    origin = np.asarray(host_row_origin, np.int64)
    entry = np.asarray(entry_input, np.float32)
    out = np.full(origin.shape, COHORT_NEVER, dtype=np.float32)
    sel = origin >= 0
    out[sel] = entry[origin[sel]]
    return out


def electrified_load_growth(load_growth, years: Sequence[int], annual_rate: float,
                            start_year: Optional[int] = None,
                            sectors: Optional[Sequence[int]] = None) -> np.ndarray:
    """[Y, R, S] load-growth multiplier with electrification growth
    compounded on top: from ``start_year`` (default: the first model
    year) each later year multiplies demand by ``1 + annual_rate``;
    ``sectors`` restricts it (``(0,)``: residential), default all. Host
    float32 numpy; a pure input transform."""
    if isinstance(load_growth, torch.Tensor):
        load_growth = load_growth.cpu().numpy()
    lg = np.array(load_growth, dtype=np.float32, copy=True)
    ys = np.asarray(list(years), dtype=np.int64)
    y0 = int(start_year) if start_year is not None else int(ys[0])
    exponent = np.maximum(ys - y0, 0).astype(np.float32)
    factor = (1.0 + float(annual_rate)) ** exponent      # [Y]
    s_sel = (np.asarray(list(sectors), np.int64) if sectors is not None
             else np.arange(lg.shape[2]))
    lg[:, :, s_sel] *= factor[:, None, None]
    return lg
