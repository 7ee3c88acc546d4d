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

A multi-rank run (``parallel``) writes one part a rank a year, each the
rank's carry and the agent ids of its rows::

    <directory>/<year>.p<rank>-of-<world>/carry.npz
    <directory>/<year>.p<rank>-of-<world>/rows.npy

each committed by its own rename. A year counts as committed when every
part of one world size is (:func:`valid_years`); where a year was
committed more than once (a resume at another world size wrote it again),
the newest commit is the year's. A restore of such a year gathers the
parts and moves their rows onto the restoring run's by agent id, so a
world of P ranks (or one process) resumes a year written by P' ranks
(``parallel.elastic``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
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
#: one rank's part of a year a multi-rank run wrote
_PART_RE = re.compile(r"^(\d+)\.p(\d+)-of-(\d+)$")


def part_dir_name(year: int, rank: int, world: int) -> str:
    """The directory name of rank ``rank``'s part of ``year`` in a world of
    ``world`` ranks."""
    return f"{int(year)}.p{int(rank)}-of-{int(world)}"


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
    leaves) saves as it is. ``shard=(rank, world)``: one rank's part of a
    multi-rank run (``rows`` required)."""

    def __init__(self, directory: str, rows: Optional[np.ndarray] = None,
                 scenario: Optional[str] = None,
                 shard: Optional[Tuple[int, int]] = None) -> None:
        self.directory = os.path.abspath(scenario_dir(directory, scenario))
        self.rows = None if rows is None else np.asarray(rows, np.int64)
        if shard is not None and self.rows is None:
            raise ValueError("a rank's checkpoint part needs its rows' agent ids")
        self.shard = None if shard is None else (int(shard[0]), int(shard[1]))
        os.makedirs(self.directory, exist_ok=True)

    def save(self, year: int, carry) -> None:
        """Commit ``carry`` (tensors, or the numpy arrays of a fetched
        carry) as ``year``, replacing a year saved before."""
        # fault site: a ``kill`` here models a process dying mid-save;
        # the rename protocol leaves the committed years restorable and
        # the torn one invisible
        fault_point("ckpt_save")
        arrays = {k: _host(v) for k, v in _leaves(carry).items()}
        name = str(int(year)) if self.shard is None else part_dir_name(year, *self.shard)
        final = os.path.join(self.directory, name)
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


def _committed(directory: str) -> Dict[int, List[Tuple[float, List[str]]]]:
    """{year: [(commit time, [part directories in rank order]), ...]}: a
    one-process year is one part; a multi-rank year is listed once for
    each world size of which every rank's part is committed."""
    out: Dict[int, List[Tuple[float, List[str]]]] = {}
    if not os.path.isdir(directory):
        return out
    parts: Dict[Tuple[int, int], Dict[int, str]] = {}
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        carry = os.path.join(path, CARRY_FILE)
        if not os.path.isfile(carry):
            continue
        if name.isdigit():
            out.setdefault(int(name), []).append((os.path.getmtime(carry), [path]))
            continue
        m = _PART_RE.match(name)
        if m:
            year, rank, world = (int(g) for g in m.groups())
            parts.setdefault((year, world), {})[rank] = path
    for (year, world), by_rank in parts.items():
        if sorted(by_rank) == list(range(world)):
            paths = [by_rank[r] for r in range(world)]
            t = max(os.path.getmtime(os.path.join(p, CARRY_FILE)) for p in paths)
            out.setdefault(year, []).append((t, paths))
    return out


def year_parts(directory: str, year: int, scenario: Optional[str] = None
               ) -> Optional[List[str]]:
    """The part directories of ``year``'s newest commit in rank order (one
    for a one-process year), or None when the year is not committed."""
    commits = _committed(scenario_dir(directory, scenario)).get(int(year))
    if not commits:
        return None
    return max(commits, key=lambda c: c[0])[1]


def valid_years(directory: str, scenario: Optional[str] = None) -> List[int]:
    """Ascending committed years of a checkpoint directory (a save that
    died before its rename never appears, nor a multi-rank year one of
    whose ranks' parts is missing)."""
    return sorted(_committed(scenario_dir(directory, scenario)))


def latest_year(directory: str, scenario: Optional[str] = None) -> Optional[int]:
    years = valid_years(directory, scenario=scenario)
    return years[-1] if years else None


def latest_valid_year(directory: str, n_agents: int, max_year: Optional[int] = None,
                      device="cuda", rows=None,
                      scenario: Optional[str] = None,
                      n_scenarios: Optional[int] = None) -> Optional[int]:
    """The newest committed year that restores (walking back past one
    that does not), optionally capped at ``max_year``; None when nothing
    restores. Each candidate is validated by a full restore onto
    ``device`` (``rows``, ``scenario`` and ``n_scenarios`` as
    :func:`restore_year` takes them; ``rows`` may also be a callable
    ``year -> rows``, as ``Simulation.restore_rows`` gives them)."""
    for y in reversed(valid_years(directory, scenario=scenario)):
        if max_year is not None and y > max_year:
            continue
        try:
            restore_year(directory, n_agents, y, device=device,
                         rows=rows(y) if callable(rows) else rows,
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
    parts = year_parts(directory, year)
    if parts is None:
        raise FileNotFoundError(f"no checkpoint of year {year} under {directory}")
    rows = None if rows is None else np.asarray(rows, np.int64)
    sharded = not os.path.basename(parts[0]).isdigit()
    path = os.path.join(parts[0], CARRY_FILE)
    rows_path = os.path.join(parts[0], ROWS_FILE)
    saved = np.load(rows_path) if os.path.isfile(rows_path) else None
    if sharded and rows is None:
        raise ValueError(f"checkpoint year {year} under {directory} was saved by "
                         f"{len(parts)} ranks; it restores by agent id only (pass rows)")
    if not sharded and (saved is None) != (rows is None):
        kind = ("a clustered", "an unclustered")
        raise ValueError(f"checkpoint {path} was saved by {kind[saved is None]} run; "
                         f"refusing to restore it into {kind[rows is None]} one")
    if rows is not None and len(rows) != n_agents:
        raise ValueError(f"{len(rows)} row ids for {n_agents} agents")
    lead = () if n_scenarios is None else (int(n_scenarios),)
    got_parts, saved_parts = [], []
    for part in parts:
        path = os.path.join(part, CARRY_FILE)
        part_rows = (np.load(os.path.join(part, ROWS_FILE)) if sharded or saved is not None
                     else None)
        n_saved = n_agents if part_rows is None else len(part_rows)
        want = {k: lead + tuple(v.shape)
                for k, v in _leaves(SimCarry.zeros(n_saved, "cpu")).items()}
        with np.load(path, allow_pickle=False) as z:
            got = {k: z[k] for k in z.files}
        if set(got) != set(want):
            raise ValueError(f"checkpoint {path} holds leaves {sorted(got)}, a SimCarry "
                             f"has {sorted(want)}")
        for k, z0 in want.items():
            if tuple(got[k].shape) != z0:
                raise ValueError(f"checkpoint {path}: leaf {k} has shape "
                                 f"{got[k].shape}, {z0} expected for {n_saved} agents")
        got_parts.append(got)
        saved_parts.append(part_rows)
    got = {k: np.concatenate([g[k] for g in got_parts], axis=-1) for k in got_parts[0]}
    saved = None if saved_parts[0] is None else np.concatenate(saved_parts)
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
