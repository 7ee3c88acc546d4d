"""Per-year checkpoint and resume (port of ``dgen_tpu/io/checkpoint.py``,
single process, without orbax).

The only cross-year state is the :class:`~dgen_tpu_torch.models.
simulation.SimCarry` (ten ``[N]`` float32 leaves), so a checkpoint is one
``.npz`` a model year, the leaves keyed by their ``tree.leaf_paths``
names (``market.market_share``, ..., ``batt_adopters_cum``)::

    <directory>/<year>/carry.npz

A save writes into a temporary directory and renames it into place: a
torn save is invisible (:func:`valid_years` lists committed years only),
and a save over an existing year replaces it. A restore checks every
leaf's name and shape against ``SimCarry.zeros(n_agents)``.

Not ported yet: ``scenario_dir``/``member_dir`` and the stacked-scenario
restore (sweeps and ensembles), and a restore onto a sharding
(multi-GPU).
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
    end of the run."""

    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)
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


def save_year(directory: str, year: int, carry) -> None:
    """One-shot save (prefer :class:`Writer` inside run loops)."""
    with Writer(directory) as w:
        w.save(year, carry)


def valid_years(directory: str) -> List[int]:
    """Ascending committed years of a checkpoint directory (a save that
    died before its rename never appears)."""
    if not os.path.isdir(directory):
        return []
    years = []
    for name in os.listdir(directory):
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, CARRY_FILE)):
            years.append(int(name))
    return sorted(years)


def latest_year(directory: str) -> Optional[int]:
    years = valid_years(directory)
    return years[-1] if years else None


def latest_valid_year(directory: str, n_agents: int, max_year: Optional[int] = None,
                      device="cuda") -> Optional[int]:
    """The newest committed year that restores (walking back past one
    that does not), optionally capped at ``max_year``; None when nothing
    restores. Each candidate is validated by a full restore onto
    ``device``."""
    for y in reversed(valid_years(directory)):
        if max_year is not None and y > max_year:
            continue
        try:
            restore_year(directory, n_agents, y, device=device)
        except Exception as e:  # noqa: BLE001 — any failure: not valid
            logger.warning("checkpoint year %d under %s does not restore (%r); "
                           "walking back", y, directory, e)
            continue
        return y
    return None


def restore_year(directory: str, n_agents: int, year: Optional[int] = None,
                 device="cuda") -> Tuple[int, SimCarry]:
    """(year, carry) of ``year`` (default: the latest committed year) on
    ``device``. Raises unless the file holds exactly the leaves of
    ``SimCarry.zeros(n_agents)``, each of its shape."""
    dev = resolve_device(device)
    if year is None:
        year = latest_year(directory)
        if year is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, str(int(year)), CARRY_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint of year {year} under {directory}")
    zeros = SimCarry.zeros(n_agents, "cpu")
    want = _leaves(zeros)
    with np.load(path, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    if set(got) != set(want):
        raise ValueError(f"checkpoint {path} holds leaves {sorted(got)}, a SimCarry "
                         f"has {sorted(want)}")
    for k, z0 in want.items():
        if tuple(got[k].shape) != tuple(z0.shape):
            raise ValueError(f"checkpoint {path}: leaf {k} has shape {got[k].shape}, "
                             f"{tuple(z0.shape)} expected for {n_agents} agents")

    def build(obj, prefix=""):
        if isinstance(obj, torch.Tensor):
            return torch.from_numpy(got[prefix]).to(device=dev, dtype=obj.dtype)
        return type(obj)(**{
            f.name: build(getattr(obj, f.name),
                          f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(obj)})

    return int(year), build(zeros)
