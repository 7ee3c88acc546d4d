"""Per-year checkpoint and resume (port of ``dgen_tpu/io/checkpoint.py``,
single process, without orbax).

The only cross-year state is the :class:`~dgen_tpu_torch.models.
simulation.SimCarry` (ten ``[N]`` float32 leaves), so a checkpoint is one
``.npz`` a model year, the leaves keyed by their ``tree.leaf_paths``
names (``market.market_share``, ..., ``batt_adopters_cum``)::

    <directory>/<year>/carry.npz
    <directory>/<year>/rows.npy      (a tariff-clustered run's only)

A clustered run's rows are in its cluster layout's order, which moves
with the quarantine set and the chunk, so each of its years keeps the
agent id of every row (-1 on a masked row) beside the carry. A restore
into a clustered run moves the year's rows to the run's by agent id; a
checkpoint of the other kind (clustered into unclustered, or the other
way round) is refused.

A save writes into a temporary directory and renames it into place: a
torn save is invisible (:func:`valid_years` lists committed years only),
and a save over an existing year replaces it. A restore checks every
leaf's name and shape against ``SimCarry.zeros`` of the year's rows.

Sweeps and ensembles (``dgen_tpu_torch.sweep``, ``dgen_tpu_torch.
ensemble``) lay their checkpoints out below the run's directory: a
loop-mode scenario in ``scn=<label>/`` (:func:`scenario_dir`), a
loop-mode ensemble member in ``mem=<mmm>/`` (:func:`member_dir`), and a
vmap-mode group in ``scn=<group>/`` as one stacked carry a year, every
leaf ``[S, N]`` (``restore_year(n_scenarios=S)``), committed by the same
rename. ``scenario=`` selects the subdirectory in the functions below.

Not ported yet: a restore onto a sharding (multi-GPU, ``ROADMAP.md``
item 7).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.models.simulation import SimCarry
from dgen_tpu_torch.resilience.faults import fault_point
from dgen_tpu_torch.tree import leaf_paths
from dgen_tpu_torch.utils.atomic import write_npz

logger = logging.getLogger(__name__)

#: the file of a committed year's carry
CARRY_FILE = "carry.npz"
#: a clustered run's row order in a committed year: [rows] int64 agent
#: ids, -1 on a masked row
ROWS_FILE = "rows.npy"


def scenario_dir(directory: str, scenario: Optional[str]) -> str:
    """Per-scenario checkpoint subdirectory of a sweep run: scenario
    ``s`` of a sweep under ``directory`` checkpoints into
    ``directory/scn=<s>/``, so a killed sweep resumes at (scenario,
    year). ``None`` keeps the flat single-run layout."""
    if scenario is None:
        return directory
    return os.path.join(directory, f"scn={scenario}")


def member_dir(directory: str, member: int) -> str:
    """Per-member checkpoint subdirectory of a loop-mode ensemble:
    member ``m`` checkpoints into ``directory/mem=<mmm>/``, so a killed
    ensemble resumes at (member, year)."""
    return os.path.join(directory, f"mem={int(member):03d}")


def _leaves(carry) -> Dict[str, object]:
    """``{name: leaf}`` of a carry of tensors or numpy arrays (a fetched
    carry): its ``tree.leaf_paths`` names without the leading dot."""
    return {k.lstrip("."): v for k, v in leaf_paths(carry).items()}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class Writer:
    """Per-run checkpoint writer. Each save is complete when ``save``
    returns (nothing runs in the background), so ``close`` only marks the
    end of the run. ``rows``: a clustered run's row order (agent ids, -1
    on masked rows), saved with every year. ``scenario``: the sweep
    subdirectory (:func:`scenario_dir`). A stacked carry (``[S, N]``
    leaves) saves as it is."""

    def __init__(self, directory: str, rows: Optional[np.ndarray] = None,
                 scenario: Optional[str] = None) -> None:
        self.directory = os.path.abspath(scenario_dir(directory, scenario))
        self.rows = None if rows is None else np.asarray(rows, np.int64)
        os.makedirs(self.directory, exist_ok=True)

    def save(self, year: int, carry) -> None:
        """Commit ``carry`` (tensors, or the numpy arrays of a fetched
        carry) as ``year``, replacing a year saved before."""
        # fault site: a ``kill`` here models a process dying mid-save;
        # the rename protocol leaves the committed years restorable and
        # the torn one invisible
        fault_point("ckpt_save")
        arrays = {k: _host(v) for k, v in _leaves(carry).items()}
        final = os.path.join(self.directory, str(int(year)))
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(year)}-", dir=self.directory)
        try:
            write_npz(os.path.join(tmp, CARRY_FILE), arrays)
            if self.rows is not None:
                np.save(os.path.join(tmp, ROWS_FILE), self.rows)
            if os.path.isdir(final):
                # a directory cannot be renamed onto a full one: move the
                # old year aside, commit, then drop it
                old = tempfile.mkdtemp(prefix=f".old-{int(year)}-", dir=self.directory)
                os.replace(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def close(self) -> None:
        pass

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_year(directory: str, year: int, carry, scenario: Optional[str] = None) -> None:
    """One-shot save (prefer :class:`Writer` inside run loops)."""
    with Writer(directory, scenario=scenario) as w:
        w.save(year, carry)


def valid_years(directory: str, scenario: Optional[str] = None) -> List[int]:
    """Ascending committed years of a checkpoint directory (a save that
    died before its rename never appears)."""
    directory = scenario_dir(directory, scenario)
    if not os.path.isdir(directory):
        return []
    years = []
    for name in os.listdir(directory):
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, CARRY_FILE)):
            years.append(int(name))
    return sorted(years)


def latest_year(directory: str, scenario: Optional[str] = None) -> Optional[int]:
    years = valid_years(directory, scenario=scenario)
    return years[-1] if years else None


def latest_valid_year(directory: str, n_agents: int, max_year: Optional[int] = None,
                      device="cuda", rows: Optional[np.ndarray] = None,
                      scenario: Optional[str] = None,
                      n_scenarios: Optional[int] = None) -> Optional[int]:
    """The newest committed year that restores (walking back past one
    that does not), optionally capped at ``max_year``; None when nothing
    restores. Each candidate is validated by a full restore onto
    ``device`` (``rows``, ``scenario`` and ``n_scenarios`` as
    :func:`restore_year` takes them)."""
    for y in reversed(valid_years(directory, scenario=scenario)):
        if max_year is not None and y > max_year:
            continue
        try:
            restore_year(directory, n_agents, y, device=device, rows=rows,
                         scenario=scenario, n_scenarios=n_scenarios)
        except Exception as e:  # noqa: BLE001 — any failure: not valid
            logger.warning("checkpoint year %d under %s does not restore (%r); "
                           "walking back", y, directory, e)
            continue
        return y
    return None


def _rows_source(saved: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """[len(rows)] int64: for each of ``rows``' agent ids the row of
    ``saved`` that holds it, -1 on a masked row and on an agent
    ``saved`` does not hold."""
    held = np.nonzero(saved >= 0)[0]
    held = held[np.argsort(saved[held], kind="stable")]
    keys = saved[held]
    src = np.full(len(rows), -1, np.int64)
    real = np.nonzero(rows >= 0)[0]
    if len(keys) and len(real):
        at = np.minimum(np.searchsorted(keys, rows[real]), len(keys) - 1)
        found = keys[at] == rows[real]
        src[real[found]] = held[at[found]]
    return src


def restore_year(directory: str, n_agents: int, year: Optional[int] = None,
                 device="cuda", rows: Optional[np.ndarray] = None,
                 scenario: Optional[str] = None,
                 n_scenarios: Optional[int] = None) -> Tuple[int, SimCarry]:
    """(year, carry) of ``year`` (default: the latest committed year) on
    ``device``. Raises unless the file holds exactly the leaves of
    ``SimCarry.zeros`` of the year's rows, each of its shape.

    ``rows``: a clustered run's row order ([n_agents] agent ids, -1 on
    masked rows). The year's rows are then moved to it by agent id (an
    agent the year does not hold starts from zero). A year saved with
    rows restores only with ``rows`` and one saved without them only
    without. ``scenario`` reads a sweep's subdirectory
    (:func:`scenario_dir`); ``n_scenarios`` restores a stacked carry,
    every leaf ``[n_scenarios, n_agents]``."""
    dev = resolve_device(device)
    directory = scenario_dir(directory, scenario)
    if year is None:
        year = latest_year(directory)
        if year is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, str(int(year)), CARRY_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint of year {year} under {directory}")
    rows = None if rows is None else np.asarray(rows, np.int64)
    rows_path = os.path.join(os.path.dirname(path), ROWS_FILE)
    saved = np.load(rows_path) if os.path.isfile(rows_path) else None
    if (saved is None) != (rows is None):
        kind = ("a clustered", "an unclustered")
        raise ValueError(f"checkpoint {path} was saved by {kind[saved is None]} run; "
                         f"refusing to restore it into {kind[rows is None]} one")
    if rows is not None and len(rows) != n_agents:
        raise ValueError(f"{len(rows)} row ids for {n_agents} agents")
    n_saved = n_agents if saved is None else len(saved)
    lead = () if n_scenarios is None else (int(n_scenarios),)
    want = {k: lead + tuple(v.shape)
            for k, v in _leaves(SimCarry.zeros(n_saved, "cpu")).items()}
    with np.load(path, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    if set(got) != set(want):
        raise ValueError(f"checkpoint {path} holds leaves {sorted(got)}, a SimCarry "
                         f"has {sorted(want)}")
    for k, z0 in want.items():
        if tuple(got[k].shape) != z0:
            raise ValueError(f"checkpoint {path}: leaf {k} has shape {got[k].shape}, "
                             f"{z0} expected for {n_saved} agents")
    if saved is not None and not np.array_equal(saved, rows):
        src = _rows_source(saved, rows)
        take, keep = np.maximum(src, 0), src >= 0
        logger.info("checkpoint %s: rows moved to this run's layout by agent id (%d of "
                    "%d real rows found)", path, int(keep.sum()), int((rows >= 0).sum()))
        got = {k: np.where(keep, v[..., take], np.zeros((), v.dtype))
               for k, v in got.items()}
    zeros = SimCarry.zeros(n_agents, "cpu")

    def build(obj, prefix=""):
        if isinstance(obj, torch.Tensor):
            return torch.from_numpy(got[prefix]).to(device=dev, dtype=obj.dtype)
        return type(obj)(**{
            f.name: build(getattr(obj, f.name),
                          f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(obj)})

    return int(year), build(zeros)
