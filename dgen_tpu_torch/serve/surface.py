"""The precomputed answer surface: the zero-override question served
without the card (port of ``dgen_tpu/serve/surface.py``).

Most users ask the default question: "this agent, this year, no
override". Its answer is a pure function of (population, scenario
inputs, year), a finite table. :func:`build_surface` sweeps it once
through the live engine at full bucket width, so each stored row is the
engine's answer at that bucket bit for bit, and publishes it as a
content-hashed, provenance-stamped, memory-mapped table
(:mod:`dgen_tpu_torch.io.mmaptable`). A serving process then answers a
covered query from the map (no card, no queue) and sends everything else
to the engine.

A surface is exact only for the configuration that built it. The builder
stamps ``git_sha``, a ``config_hash`` over (RunConfig, ScenarioConfig), a
sha256 of the population (agent ids and mask), the year grid and the
sizing statics; :meth:`AnswerSurface.load` refuses, naming the field,
when any of them differs from the engine's. A refused or damaged surface
leaves the engine answering; it never serves stale answers.

    python -m dgen_tpu_torch.serve --build-surface runs/surface --agents 8192
    python -m dgen_tpu_torch.serve --surface runs/surface --agents 8192
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dgen_tpu_torch.io.export import config_hash, git_sha
from dgen_tpu_torch.io.mmaptable import MmapTable, MmapTableError, write_table
from dgen_tpu_torch.resilience.faults import fault_point
from dgen_tpu_torch.serve.engine import QUERY_FIELDS, ServeEngine

logger = logging.getLogger(__name__)

#: header meta tag (bumped if the column contract changes)
SURFACE_VERSION = 1

#: the provenance fields a surface must share with its engine
PROVENANCE_FIELDS = ("config_hash", "git_sha", "population_sha", "years", "n_rows",
                     "econ_years", "sizing_iters")


class SurfaceError(RuntimeError):
    """The surface directory is missing, damaged or unreadable."""


class StaleSurfaceError(SurfaceError):
    """The surface was built under another configuration than the engine
    it is attached to; ``reason`` names the field."""

    def __init__(self, reason: str) -> None:
        super().__init__(f"answer surface refused: {reason}")
        self.reason = reason


def surface_provenance(engine: ServeEngine) -> dict:
    """What a surface's exactness depends on: the code (git sha), the
    configuration (RunConfig and ScenarioConfig hash), the population
    (agent ids and mask bytes), the year grid and the sizing statics.
    ServeConfig is left out: queue and timeout knobs change no answer."""
    sim = engine.sim
    pop = hashlib.sha256()
    pop.update(np.ascontiguousarray(sim.host_agent_id).tobytes())
    pop.update(np.ascontiguousarray(sim.host_mask).tobytes())
    return {
        "git_sha": git_sha(),
        "config_hash": config_hash(sim.run_config, sim.scenario),
        "population_sha": pop.hexdigest()[:16],
        "years": [int(y) for y in engine.years],
        "n_rows": int(np.asarray(sim.host_mask).shape[0]),
        "econ_years": int(sim.econ_years),
        "sizing_iters": int(sim.run_config.sizing_iters),
    }


def provenance_key(engine: ServeEngine) -> str:
    """Compact provenance key (config hash, git sha, population): the
    result cache's partition, so answers of another version never alias."""
    p = surface_provenance(engine)
    return f"{p['config_hash']}|{p['git_sha']}|{p['population_sha']}"


def load_and_attach(engine: ServeEngine, dir_path: str) -> Optional[str]:
    """Load a surface and attach it to ``engine``. On refusal (stale,
    damaged, missing) log the reason, record it on the engine for
    /metricz, and leave the engine answering. Returns the reason, or None
    when attached."""
    try:
        surf = AnswerSurface.load(dir_path, engine)
    except Exception as e:  # noqa: BLE001 - a refusal must not stop the boot
        reason = str(e)
        engine.surface_refused = reason
        logger.error("%s: serving without the answer surface (every query runs "
                     "on the engine)", reason)
        return reason
    engine.attach_surface(surf)
    stats = surf.stats()
    logger.info("answer surface attached: %d years x %d rows (bucket %d, content %s)",
                stats["years"], stats["rows"], surf.bucket, stats["content_hash"])
    return None


def build_surface(engine: ServeEngine, out_dir: str, bucket: int,
                  year_indices: Optional[Sequence[int]] = None) -> dict:
    """Sweep the zero-override answer of every (year, table row) through
    the engine at ``bucket`` rows a launch and publish it as a map at
    ``out_dir``; returns the header written.

    Every row of the padded table is swept (padding rows are inert, as in
    a live bucket), so a lookup indexes by table row. ``year_indices``
    restricts the sweep; a year left out falls through to the engine."""
    n_rows = int(np.asarray(engine.sim.host_mask).shape[0])
    yis = (list(range(len(engine.years))) if year_indices is None
           else [int(y) for y in year_indices])
    t0 = time.time()
    per_field: Dict[str, List[np.ndarray]] = {f: [] for f in QUERY_FIELDS}
    for yi in yis:
        chunks: Dict[str, List[np.ndarray]] = {f: [] for f in QUERY_FIELDS}
        for start in range(0, n_rows, bucket):
            rows = np.arange(start, min(start + bucket, n_rows), dtype=np.int32)
            out = engine.query_rows(rows, yi, bucket=bucket)
            for f in QUERY_FIELDS:
                chunks[f].append(out[f])
        for f in QUERY_FIELDS:
            per_field[f].append(np.concatenate(chunks[f], axis=0))
    columns = {f: np.stack(per_field[f], axis=0) for f in QUERY_FIELDS}
    meta = {
        "surface_version": SURFACE_VERSION,
        "bucket": int(bucket),
        "year_indices": yis,
        "provenance": surface_provenance(engine),
        "build_wall_s": round(time.time() - t0, 3),
    }
    header = write_table(out_dir, columns, meta=meta)
    logger.info("answer surface built: %d years x %d rows at bucket %d in %.1fs -> %s "
                "(content %s)", len(yis), n_rows, bucket, meta["build_wall_s"],
                out_dir, header["content_hash"][:12])
    return header


class AnswerSurface:
    """A loaded, provenance-checked surface bound to one engine.
    :meth:`lookup` is host numpy indexing into the map; the hit count is
    locked (handler threads share one instance)."""

    def __init__(self, table: MmapTable, meta: dict) -> None:
        self._table = table
        self.meta = meta
        self.bucket = int(meta["bucket"])
        self._slot = {int(yi): i for i, yi in enumerate(meta["year_indices"])}
        self._cols = table.columns
        self._lock = threading.Lock()
        self.hits = 0

    @classmethod
    def load(cls, dir_path: str, engine: ServeEngine) -> "AnswerSurface":
        """Open a surface and check it against ``engine``. Raises
        :class:`SurfaceError` (unreadable or damaged) or
        :class:`StaleSurfaceError` (built under another configuration,
        the field named)."""
        # fault site: torn storage or an unreadable map at load
        fault_point("surface_load", path=os.path.join(dir_path, "table.bin"))
        try:
            table = MmapTable(dir_path)
            table.verify()
        except MmapTableError as e:
            raise SurfaceError(f"answer surface unusable: {e}") from e
        meta = table.meta
        if meta.get("surface_version") != SURFACE_VERSION:
            raise StaleSurfaceError(
                f"surface_version {meta.get('surface_version')!r} != {SURFACE_VERSION}")
        want = surface_provenance(engine)
        got = meta.get("provenance") or {}
        for field in PROVENANCE_FIELDS:
            if got.get(field) != want[field]:
                raise StaleSurfaceError(
                    f"{field} mismatch (surface {got.get(field)!r} != engine "
                    f"{want[field]!r})")
        missing = [f for f in QUERY_FIELDS if f not in table.columns]
        if missing:
            raise StaleSurfaceError(f"missing answer column(s) {missing}")
        return cls(table, meta)

    def covers(self, year_idx: int) -> bool:
        return int(year_idx) in self._slot

    def lookup(self, rows: np.ndarray, year_idx: int) -> Dict[str, np.ndarray]:
        """Answers for ``rows`` at ``year_idx``, as
        :meth:`ServeEngine.query_rows` returns them, copied out of the map."""
        slot = self._slot[int(year_idx)]
        rows = np.asarray(rows, dtype=np.int32)
        out = {f: np.array(self._cols[f][slot][rows]) for f in QUERY_FIELDS}
        with self._lock:
            self.hits += 1
        return out

    def stats(self) -> dict:
        with self._lock:
            hits = self.hits
        return {
            "years": len(self._slot),
            "rows": int(self._cols["agent_id"].shape[1]),
            "bucket": self.bucket,
            "hits": hits,
            "content_hash": self._table.content_hash[:12],
        }
