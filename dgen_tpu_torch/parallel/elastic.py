"""Resharded restore: resume a checkpoint written by P ranks with P'
ranks (port of ``dgen_tpu/parallel/elastic.py``).

A multi-rank run is not elastic while it runs: a lost rank stops every
collective, and the recovery is to tear the ranks down and start them
again. The restore can be elastic: each rank of a multi-rank run writes
its carry with the agent ids of its rows (``io.checkpoint``), so a world
of another size, or one process, gathers the year's parts and moves them
onto its own rows by agent id.

Two invariants make this sound: the padded global agent count divides
over the new world (:func:`validate_topology`; every rank holds an equal
share), and the restored carry feeds the same year step, only its rows
placed anew.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _world(topo) -> int:
    return 1 if topo is None else int(topo.world_size)


def validate_topology(n_agents: int, topo) -> None:
    """Fail fast, naming the fix, when the padded global agent count does
    not divide over the topology's ranks: the one way a resharded restore
    can be impossible. ``topo``: a ``parallel.mesh.RankTopology``, or
    None for one process."""
    d = _world(topo)
    if d > 1 and n_agents % d:
        raise ValueError(
            f"elastic restore: padded agent count {n_agents} does not "
            f"divide over {d} devices; pad the population to a multiple "
            "of the largest device count the run may shrink through "
            "(models.agents.pad_table / RunConfig.agent_pad_multiple)"
        )


def is_sharded(checkpoint_dir: str, year: int, scenario: Optional[str] = None) -> bool:
    """Whether ``year``'s newest commit was written by the ranks of a
    multi-rank run (one part a rank)."""
    from dgen_tpu_torch.io import checkpoint as ckpt

    parts = ckpt.year_parts(checkpoint_dir, year, scenario=scenario)
    return bool(parts) and not os.path.basename(parts[0]).isdigit()


def restore_resharded(
    checkpoint_dir: str,
    n_agents: int,
    year: Optional[int] = None,
    topo=None,
    device="cuda",
    rows: Optional[np.ndarray] = None,
    scenario: Optional[str] = None,
) -> Tuple[int, object]:
    """(year, carry): ``year``'s carry on this rank's rows, whatever the
    world size that wrote it. ``n_agents`` is the run's padded global
    agent count (:func:`validate_topology`); ``rows`` the agent ids of
    this rank's rows (-1 on masked rows), the carry's row order."""
    from dgen_tpu_torch.io import checkpoint as ckpt

    validate_topology(n_agents, topo)
    n_local = n_agents // _world(topo)
    return ckpt.restore_year(checkpoint_dir, n_local, year, device=device, rows=rows,
                             scenario=scenario)


def resume_year_for(
    checkpoint_dir: str,
    n_agents: int,
    frontier: Optional[int],
    topo=None,
    device="cuda",
    rows=None,
    scenario: Optional[str] = None,
) -> Optional[int]:
    """The year a restarted run re-enters at: the newest checkpoint that
    restores onto this rank's rows, capped at the manifest ``frontier``
    (never resume past a year whose exports are not on disk), walking
    back past corrupt or torn years. None (no frontier, or nothing
    restorable at or below it) means start from scratch. Every rank
    evaluates this against the same directory in the same order, so the
    ranks agree on the year. ``rows``: the agent ids of this rank's rows,
    or a callable ``year -> rows`` (``Simulation.restore_rows``)."""
    if frontier is None:
        return None
    from dgen_tpu_torch.io import checkpoint as ckpt

    validate_topology(n_agents, topo)
    return ckpt.latest_valid_year(
        checkpoint_dir, n_agents // _world(topo), max_year=frontier, device=device,
        rows=rows, scenario=scenario)
