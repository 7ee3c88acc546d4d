"""Ensemble reductions on the card (port of ``dgen_tpu/ensemble/stats.py``):
per-member aggregates and per-year quantiles, so a year's host fetch is
O(quantiles), never O(E x N) agent rows.

Each model year the ``[E, N]`` (vmap mode) or ``[N]`` (loop mode)
:class:`~dgen_tpu_torch.models.simulation.YearOutputs` leaves reduce on
the card to per-member national and state sums
(:func:`member_aggregates`, the mask-weighted sums of
``SimResults.summary``); in vmap mode the member axis then collapses to
quantiles on the card (:func:`year_quantiles`, ``torch.quantile``'s
linear interpolation, as ``np.quantile`` and ``jnp.quantile`` default).
Loop mode fetches one scalar block a (member, year) and takes the
quantiles on the host (:func:`quantiles_np`). State sums are segment
sums over ``state_idx`` (``index_add_``), never a one-hot product.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

#: metric name -> the YearOutputs field behind it: the four headline
#: curves of ``SimResults.summary``
METRIC_FIELDS: Dict[str, str] = {
    "adopters": "number_of_adopters",
    "system_kw_cum": "system_kw_cum",
    "batt_kwh_cum": "batt_kwh_cum",
    "new_adopters": "new_adopters",
}

#: metrics also reduced per state
STATE_METRICS: Tuple[str, ...] = ("adopters", "system_kw_cum")

DEFAULT_QUANTILES: Tuple[float, ...] = (0.1, 0.5, 0.9)


def member_aggregates(outs, mask: torch.Tensor, state_idx: torch.Tensor, *,
                      n_states: int):
    """(national, state) aggregate dicts of one model year on the outputs'
    device. ``outs`` leaves are ``[N]`` (one member) or ``[E, N]``;
    ``mask`` and ``state_idx`` are ``[N]``, shared by the members. The
    national sums are ``[]`` or ``[E]``, the state sums ``[n_states]`` or
    ``[E, n_states]``."""
    mask = mask.to(torch.float32)
    idx = state_idx.long()
    national, state = {}, {}
    for name, field in METRIC_FIELDS.items():
        x = getattr(outs, field) * mask
        national[name] = x.sum(dim=-1)
        if name in STATE_METRICS:
            out = torch.zeros(x.shape[:-1] + (n_states,), dtype=x.dtype, device=x.device)
            state[name] = out.index_add_(x.dim() - 1, idx, x)
    return national, state


def year_quantiles(agg: Dict[str, torch.Tensor], qs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The leading member axis of every aggregate collapsed to the
    quantiles ``qs`` on the card: ``[E] -> [Q]``, ``[E, n_states] ->
    [Q, n_states]`` (linear interpolation)."""
    return {k: torch.quantile(a, qs.to(a.dtype), dim=0) for k, a in agg.items()}


def quantiles_np(curves: np.ndarray, qs: Sequence[float]) -> np.ndarray:
    """NumPy reference: ``curves`` [E, ...] -> [Q, ...] float32."""
    return np.quantile(np.asarray(curves, np.float64), np.asarray(qs),
                       axis=0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class EnsembleStats:
    """The ensemble's answer: per-year quantile bands of the headline
    curves, national (``national[metric]`` [Y, Q]) and per state
    (``state[metric]`` [Y, Q, n_states]); ``quantiles`` orders Q."""

    years: np.ndarray                   # [Y] calendar years, int64
    quantiles: Tuple[float, ...]
    n_members: int
    national: Dict[str, np.ndarray]
    state: Dict[str, np.ndarray]

    def band(self, metric: str = "adopters") -> Dict[str, np.ndarray]:
        """{"p10": [Y], ...} of one national metric."""
        arr = self.national[metric]
        return {f"p{round(q * 100):02d}": arr[:, i] for i, q in enumerate(self.quantiles)}

    def to_json(self) -> Dict[str, object]:
        return {
            "years": [int(y) for y in np.asarray(self.years)],
            "quantiles": [float(q) for q in self.quantiles],
            "n_members": int(self.n_members),
            "national": {k: np.asarray(v, np.float64).tolist()
                         for k, v in self.national.items()},
            "state": {k: np.asarray(v, np.float64).tolist()
                      for k, v in self.state.items()},
        }

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "EnsembleStats":
        return cls(
            years=np.asarray(d["years"], np.int64),
            quantiles=tuple(float(q) for q in d["quantiles"]),
            n_members=int(d["n_members"]),
            national={k: np.asarray(v, np.float32) for k, v in d.get("national", {}).items()},
            state={k: np.asarray(v, np.float32) for k, v in d.get("state", {}).items()},
        )

    def columns(self) -> Dict[str, np.ndarray]:
        """The long-form table (one row a year x quantile, one column a
        national metric) as numpy columns: ``quantiles.npz``."""
        years = np.asarray(self.years)
        cols = {"year": np.repeat(years, len(self.quantiles)),
                "quantile": np.tile(np.asarray(self.quantiles), len(years))}
        for k, v in self.national.items():
            cols[k] = np.asarray(v, np.float64).reshape(-1)
        return cols

    def frame(self):
        """The long-form table as a pandas frame (the JAX package's
        ``quantiles.parquet``); imports pandas here, on the CPU side."""
        import pandas as pd

        return pd.DataFrame(self.columns())


def stats_from_year_blocks(years: Sequence[int], quantiles: Sequence[float], n_members: int,
                           blocks: Dict[int, Dict[str, Dict[str, np.ndarray]]]
                           ) -> EnsembleStats:
    """:class:`EnsembleStats` from vmap mode's per-year quantile fetches,
    ``blocks[year_idx] = {"national": {m: [Q]}, "state": {m: [Q,
    n_states]}}``. A missing year raises."""
    years = np.asarray(list(years), np.int64)
    missing = [i for i in range(len(years)) if i not in blocks]
    if missing:
        raise ValueError(f"missing ensemble stats for year indices {missing}")
    national = {m: np.stack([np.asarray(blocks[i]["national"][m]) for i in range(len(years))])
                for m in METRIC_FIELDS}
    state = {m: np.stack([np.asarray(blocks[i]["state"][m]) for i in range(len(years))])
             for m in STATE_METRICS}
    return EnsembleStats(years=years, quantiles=tuple(float(q) for q in quantiles),
                         n_members=int(n_members), national=national, state=state)


def stats_from_member_aggregates(years: Sequence[int], quantiles: Sequence[float],
                                 national_curves: Dict[str, np.ndarray],
                                 state_curves: Dict[str, np.ndarray]) -> EnsembleStats:
    """:class:`EnsembleStats` from loop mode's per-member fetches:
    ``national_curves[m]`` [E, Y], ``state_curves[m]`` [E, Y, n_states];
    quantiles on the host with the device path's interpolation."""
    qs = tuple(float(q) for q in quantiles)
    n_members = int(np.asarray(next(iter(national_curves.values()))).shape[0])
    national = {m: quantiles_np(v, qs).transpose(1, 0) for m, v in national_curves.items()}
    state = {m: quantiles_np(v, qs).transpose(1, 0, 2) for m, v in state_curves.items()}
    return EnsembleStats(years=np.asarray(list(years), np.int64), quantiles=qs,
                         n_members=n_members, national=national, state=state)
