"""Crash-consistent run manifests: the content-hashed, per-year artifact
ledger of a run directory, and the merged view over a multi-rank run's
shard ledgers (port of ``dgen_tpu/resilience/manifest.py``).

A run directory's ``.npz`` partitions say which files exist; they cannot
say whether a file is complete, whether all of a year's surfaces landed,
or what a resumed run must write again. The manifest does:

* every landed artifact gets a per-year entry ``{sha256, bytes}``,
  recorded after the atomic rename published it;
* a year is marked **complete** only once every one of its surfaces is
  recorded: the exporter calls :meth:`RunManifest.mark_year_complete` at
  the end of its year;
* the manifest file itself is written by temp file and rename
  (:mod:`dgen_tpu_torch.utils.atomic`), so a killed run leaves the
  previous consistent ledger or the new one, never a torn one;
* :meth:`RunManifest.verify` re-hashes the ledger against the directory
  and flags missing and corrupt (truncated, damaged) files, the audit
  behind ``python -m dgen_tpu_torch.resilience verify``;
* :meth:`RunManifest.complete_through` gives the supervisor its resume
  frontier: the latest model year through which every year's exports are
  durably and verifiably on disk.

Checkpoint entries are recorded after the run
(:meth:`record_checkpoints`): mid-run the checkpoint directory's
committed years are themselves the truth.

A multi-rank run keeps crash consistency without coordination on the
write path: every rank owns a **shard ledger** (``manifest-p<i>.json``, a
:class:`RunManifest` with ``shard=i``) of the artifacts it wrote, each
completed year stamped with the world size that wrote it
(:func:`discover_shards` lists them), and :class:`GangManifest` merges
them read-side: a year is complete only when every rank of the year's
writing epoch marked it complete and its artifacts verify. The gang
supervisor's resume frontier (:meth:`GangManifest.frontier`) is the
merged ``complete_through``; its checkpoint hashes and notes go to the
coordinator ledger ``manifest-gang.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from dgen_tpu_torch.utils.atomic import atomic_write_json

MANIFEST_NAME = "manifest.json"
#: the coordinator ledger of a multi-rank run (checkpoint hashes and
#: notes; the per-year artifact truth stays in the shard ledgers)
GANG_MANIFEST_NAME = "manifest-gang.json"
_SHARD_RE = re.compile(r"^manifest-p(\d+)\.json$")
_VERSION = 1


def shard_manifest_name(shard: int) -> str:
    """The shard ledger's file name of rank ``shard`` of a multi-rank run."""
    return f"manifest-p{int(shard)}.json"


def discover_shards(run_dir: str) -> List[int]:
    """The ranks with a shard ledger under ``run_dir``."""
    if not os.path.isdir(run_dir):
        return []
    out = []
    for name in os.listdir(run_dir):
        m = _SHARD_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)

#: surface directories the exporter writes ``year=<Y>.npz`` partitions
#: into: the scan set of :meth:`RunManifest.verify`'s unrecorded check
SURFACE_DIRS = ("agent_outputs", "finance_series", "state_hourly")
#: the partition suffix of the port's surfaces
PART_SUFFIX = ".npz"


def _part_year(name: str) -> Optional[int]:
    """Model year of a ``year=<Y>[-p<i>].npz`` (or ``.npz.tmp``) surface
    file; None for anything else."""
    if not name.startswith("year="):
        return None
    digits = ""
    for ch in name[len("year="):]:
        if not ch.isdigit():
            break
        digits += ch
    return int(digits) if digits else None


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _hash_tree(root: str) -> tuple[str, int]:
    """(digest, bytes) over a directory tree: per file the sha256 of
    (relpath, size, content hash), folded in sorted order, so stable
    across filesystems and listing orders."""
    h = hashlib.sha256()
    total = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            size = os.path.getsize(p)
            total += size
            h.update(f"{rel}\0{size}\0".encode())
            h.update(_sha256_file(p).encode())
    return h.hexdigest(), total


@dataclasses.dataclass
class VerifyReport:
    """Result of :meth:`RunManifest.verify`."""

    run_dir: str
    #: recorded artifacts whose file is gone
    missing: List[str] = dataclasses.field(default_factory=list)
    #: recorded artifacts whose bytes or hash no longer match (truncation,
    #: torn writes, bit rot)
    corrupt: List[str] = dataclasses.field(default_factory=list)
    #: partitions present under the known surfaces but absent from the
    #: ledger (a writer died between rename and record; harmless: resume
    #: writes the year again over them)
    unrecorded: List[str] = dataclasses.field(default_factory=list)
    #: leftover ``*.tmp`` siblings of killed writers
    stale_tmp: List[str] = dataclasses.field(default_factory=list)
    #: checkpoint entries that no longer hash-match
    bad_checkpoints: List[int] = dataclasses.field(default_factory=list)
    years_complete: List[int] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.missing or self.corrupt or self.bad_checkpoints)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


class RunManifest:
    """The artifact ledger of one run directory (module docstring).
    Loading an existing ``manifest.json`` resumes its ledger: a re-entered
    run keeps the completed years' entries and overwrites the years it
    writes again.

    ``shard``/``n_processes``: a multi-rank run's per-rank shard ledger
    (``manifest-p<shard>.json``), the same protocol over this rank's
    artifacts only, each completed year stamped with the world size that
    wrote it."""

    def __init__(self, run_dir: str, shard: Optional[int] = None,
                 n_processes: Optional[int] = None) -> None:
        self.run_dir = run_dir
        self.shard = None if shard is None else int(shard)
        self.n_processes = None if n_processes is None else int(n_processes)
        self.path = os.path.join(
            run_dir, MANIFEST_NAME if shard is None else shard_manifest_name(shard))
        self._years: Dict[int, dict] = {}
        self._checkpoints: Dict[int, dict] = {}
        self._run_artifacts: Dict[str, dict] = {}
        self.notes: List[str] = []
        if os.path.isfile(self.path):
            try:
                with open(self.path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                # an atomic write cannot tear it; one damaged from outside
                # counts as absent (the run writes everything again: safe,
                # not minimal)
                doc = {}
            for y, rec in (doc.get("years") or {}).items():
                self._years[int(y)] = rec
            for y, rec in (doc.get("checkpoints") or {}).items():
                self._checkpoints[int(y)] = rec
            self._run_artifacts = dict(doc.get("run_artifacts") or {})
            self.notes = list(doc.get("notes") or [])

    # -- recording ------------------------------------------------------

    def _entry(self, relpath: str) -> dict:
        p = os.path.join(self.run_dir, relpath)
        return {"sha256": _sha256_file(p), "bytes": os.path.getsize(p)}

    def record_artifact(self, year: int, relpath: str) -> None:
        """Hash and record one landed artifact (call after the atomic
        rename published it). Recording a year that was complete reopens
        it until :meth:`mark_year_complete`."""
        rec = self._years.setdefault(int(year), {"complete": False, "artifacts": {}})
        rec["artifacts"][relpath] = self._entry(relpath)
        rec["complete"] = False

    def record_run_artifact(self, relpath: str) -> None:
        """Record a year-independent artifact (``agents.npz``,
        ``quarantine.json``); verified beside the per-year entries."""
        self._run_artifacts[relpath] = self._entry(relpath)

    def mark_year_complete(self, year: int) -> None:
        """Declare every surface of ``year`` recorded, and publish the
        ledger (one atomic write a year)."""
        rec = self._years.setdefault(int(year), {"complete": False, "artifacts": {}})
        rec["complete"] = True
        if self.n_processes is not None:
            rec["n_processes"] = self.n_processes
        self.flush()

    def record_checkpoints(self, ckpt_dir: str, years: Sequence[int]) -> None:
        """After the run: hash each committed checkpoint year's directory
        into the ledger."""
        for y in years:
            step_dir = os.path.join(ckpt_dir, str(int(y)))
            if self.shard is not None:
                # this rank's part of the year (io.checkpoint.part_dir_name)
                prefix = f"{int(y)}.p{self.shard}-of-"
                mine = sorted(n for n in (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir)
                                          else []) if n.startswith(prefix))
                step_dir = os.path.join(ckpt_dir, mine[-1]) if mine else step_dir
            if not os.path.isdir(step_dir):
                continue
            digest, nbytes = _hash_tree(step_dir)
            self._checkpoints[int(y)] = {
                "dir": os.path.relpath(step_dir, self.run_dir)
                if step_dir.startswith(self.run_dir) else step_dir,
                "sha256": digest,
                "bytes": nbytes,
            }
        self.flush()

    def note(self, msg: str) -> None:
        """Append an operational note (degradations are stamped here)
        and publish."""
        self.notes.append(msg)
        self.flush()

    def flush(self) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        atomic_write_json(
            self.path,
            {
                "version": _VERSION,
                **({"shard": self.shard} if self.shard is not None else {}),
                "years": {str(y): self._years[y] for y in sorted(self._years)},
                "checkpoints": {str(y): self._checkpoints[y]
                                for y in sorted(self._checkpoints)},
                "run_artifacts": {k: self._run_artifacts[k]
                                  for k in sorted(self._run_artifacts)},
                "notes": self.notes,
            },
            indent=2,
        )

    # -- queries --------------------------------------------------------

    def complete_years(self) -> List[int]:
        return sorted(y for y, r in self._years.items() if r["complete"])

    def artifacts(self, year: int) -> Dict[str, dict]:
        return dict(self._years.get(int(year), {}).get("artifacts", {}))

    def complete_through(self, years: Sequence[int], deep: bool = True) -> Optional[int]:
        """The resume frontier: the largest ``Y`` in ``years`` such that
        every grid year ``<= Y`` is complete and (``deep``) verifies
        against the directory. None when not even the first year is
        durably exported."""
        frontier: Optional[int] = None
        for y in years:
            rec = self._years.get(int(y))
            if not rec or not rec["complete"]:
                break
            if deep and not self._year_ok(int(y)):
                break
            frontier = int(y)
        return frontier

    def _file_ok(self, rel: str, meta: dict, deep: bool) -> Optional[str]:
        """None when the recorded file verifies, else "missing" or
        "corrupt"."""
        p = os.path.join(self.run_dir, rel)
        if not os.path.isfile(p):
            return "missing"
        if os.path.getsize(p) != meta["bytes"] or (
                deep and _sha256_file(p) != meta["sha256"]):
            return "corrupt"
        return None

    def _year_ok(self, year: int) -> bool:
        return all(self._file_ok(rel, meta, True) is None
                   for rel, meta in self._years[year]["artifacts"].items())

    # -- audit ----------------------------------------------------------

    def verify(self, deep: bool = True) -> VerifyReport:
        """Audit the run directory against the ledger. ``deep`` re-hashes
        every recorded artifact; shallow checks existence and byte counts
        only (cheap triage on large runs)."""
        rep = VerifyReport(run_dir=self.run_dir)
        recorded = set(self._run_artifacts)
        for rel, meta in self._run_artifacts.items():
            bad = self._file_ok(rel, meta, deep)
            if bad is not None:
                getattr(rep, bad).append(rel)
        for y in sorted(self._years):
            rec = self._years[y]
            year_bad = False
            for rel, meta in rec["artifacts"].items():
                recorded.add(rel)
                bad = self._file_ok(rel, meta, deep)
                if bad is not None:
                    getattr(rep, bad).append(rel)
                    year_bad = True
            if rec["complete"] and not year_bad:
                rep.years_complete.append(y)
        for y, meta in self._checkpoints.items():
            step_dir = meta["dir"] if os.path.isabs(meta["dir"]) else \
                os.path.join(self.run_dir, meta["dir"])
            if not os.path.isdir(step_dir):
                rep.bad_checkpoints.append(y)
            elif deep and _hash_tree(step_dir)[0] != meta["sha256"]:
                rep.bad_checkpoints.append(y)
        # files the ledger does not know, and killed writers' leftovers
        for d in SURFACE_DIRS:
            root = os.path.join(self.run_dir, d)
            if not os.path.isdir(root):
                continue
            for name in sorted(os.listdir(root)):
                rel = os.path.join(d, name)
                if not self._owns(name):
                    continue  # another rank's part
                if name.endswith(".tmp"):
                    rep.stale_tmp.append(rel)
                elif name.endswith(PART_SUFFIX) and rel not in recorded:
                    rep.unrecorded.append(rel)
        return rep


    def _owns(self, name: str) -> bool:
        """Whether a surface file is this ledger's to audit: a shard
        ledger's own rank's parts (``-p<shard>``), else the one-run parts."""
        stem = name.split(PART_SUFFIX)[0]
        if self.shard is None:
            return "-p" not in stem
        return stem.endswith(f"-p{self.shard}")


class GangManifest:
    """The merged view over a multi-rank run's shard ledgers (module
    docstring).

    The write path stays per rank (each rank touches only its own
    ``manifest-p<i>.json``); the merge happens read-side, on whatever
    process asks: a year is complete only when the ledgers of all the
    ``n_processes`` ranks stamped on that year (its writing epoch) mark it
    complete and its artifacts verify. Checkpoint hashes and notes live in
    the coordinator ledger (``manifest-gang.json``), written by the gang
    supervisor after the run, never contended with the ranks."""

    def __init__(self, run_dir: str) -> None:
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, GANG_MANIFEST_NAME)
        self.shards: Dict[int, RunManifest] = {
            i: RunManifest(run_dir, shard=i) for i in discover_shards(run_dir)}
        self._checkpoints: Dict[int, dict] = {}
        #: a multi-rank year's checkpoint parts: year -> [{dir, sha256,
        #: bytes}] in rank order (``checkpoints`` keeps one-process years,
        #: as the JAX package's coordinator ledger does)
        self._checkpoint_parts: Dict[int, List[dict]] = {}
        self.notes: List[str] = []
        if os.path.isfile(self.path):
            try:
                with open(self.path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                doc = {}
            for y, rec in (doc.get("checkpoints") or {}).items():
                self._checkpoints[int(y)] = rec
            for y, recs in (doc.get("checkpoint_parts") or {}).items():
                self._checkpoint_parts[int(y)] = list(recs)
            self.notes = list(doc.get("notes") or [])

    # -- merged queries -------------------------------------------------

    def year_epoch(self, year: int) -> Optional[Tuple[int, List[int]]]:
        """(world size, ranks holding the year) of ``year``'s writing
        epoch, or None when no rank recorded it or the ranks' stamps
        disagree (a torn mix of gang sizes is not complete)."""
        holders: List[int] = []
        epochs = set()
        for i, m in self.shards.items():
            rec = m._years.get(int(year))
            if rec is None:
                continue
            holders.append(i)
            epochs.add(int(rec.get("n_processes") or 0))
        if not holders or len(epochs) != 1:
            return None
        n = epochs.pop()
        return (n, holders) if n > 0 else None

    def _year_complete(self, year: int, deep: bool = True) -> bool:
        epoch = self.year_epoch(year)
        if epoch is None:
            return False
        n, holders = epoch
        if sorted(holders) != list(range(n)):
            return False   # a peer's part never landed
        for i in range(n):
            m = self.shards[i]
            if not m._years[int(year)].get("complete"):
                return False
            if deep and not m._year_ok(int(year)):
                return False
        return True

    def frontier(self, years: Sequence[int], deep: bool = True) -> Optional[int]:
        """The gang's resume frontier: the latest model year through which
        every rank's exports are durably and verifiably on disk (the
        merged ``complete_through``). None: restart from scratch."""
        out: Optional[int] = None
        for y in years:
            if not self._year_complete(int(y), deep=deep):
                break
            out = int(y)
        return out

    def complete_years(self, deep: bool = False) -> List[int]:
        ys = sorted({y for m in self.shards.values() for y in m._years})
        return [y for y in ys if self._year_complete(y, deep=deep)]

    # -- coordinator recording ------------------------------------------

    def _entry(self, step_dir: str) -> dict:
        digest, nbytes = _hash_tree(step_dir)
        rel = (os.path.relpath(step_dir, self.run_dir)
               if step_dir.startswith(self.run_dir) else step_dir)
        return {"dir": rel, "sha256": digest, "bytes": nbytes}

    def record_checkpoints(self, ckpt_dir: str, years: Sequence[int]) -> None:
        """After the run: hash each committed checkpoint year (a one-process
        year's directory, or the parts of a multi-rank year's newest
        commit) into the coordinator ledger."""
        from dgen_tpu_torch.io.checkpoint import year_parts

        for y in years:
            parts = year_parts(ckpt_dir, int(y))
            if not parts:
                continue
            if os.path.basename(parts[0]).isdigit():
                self._checkpoints[int(y)] = self._entry(parts[0])
            else:
                self._checkpoint_parts[int(y)] = [self._entry(p) for p in parts]
        self.flush()

    def note(self, msg: str) -> None:
        self.notes.append(msg)
        self.flush()

    def prune_after(self, frontier: Optional[int]) -> List[str]:
        """Delete every artifact of years beyond the resume frontier: part
        files on disk (any epoch's, ledgered or not) and the shard-ledger
        records of them. The supervisor calls this before a relaunch, so
        that a re-export (possibly at another gang size) starts clean: a
        dead P = 4 epoch's ``-p2``/``-p3`` parts would otherwise double
        rows under a P' = 2 re-export and wedge the merged completeness
        check on mixed epoch stamps. ``frontier`` None prunes everything.
        Returns the removed relpaths."""
        removed: List[str] = []

        def _rm(rel: str) -> None:
            try:
                os.remove(os.path.join(self.run_dir, rel))
                removed.append(rel)
            except OSError:
                pass   # already gone: the sweep is best-effort

        for m in self.shards.values():
            drop = [y for y in m._years if frontier is None or y > int(frontier)]
            for y in drop:
                for rel in m._years[y]["artifacts"]:
                    _rm(rel)
                del m._years[y]
            if drop:
                m.flush()
        # leftovers no ledger holds (a writer killed between its rename
        # and its record) and stale tmp siblings of the pruned years
        for d in SURFACE_DIRS:
            root = os.path.join(self.run_dir, d)
            if not os.path.isdir(root):
                continue
            for name in sorted(os.listdir(root)):
                year = _part_year(name)
                if year is not None and (frontier is None or year > int(frontier)):
                    _rm(os.path.join(d, name))
        return removed

    def flush(self) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        atomic_write_json(
            self.path,
            {"version": _VERSION,
             "checkpoints": {str(y): self._checkpoints[y]
                             for y in sorted(self._checkpoints)},
             "checkpoint_parts": {str(y): self._checkpoint_parts[y]
                                  for y in sorted(self._checkpoint_parts)},
             "notes": self.notes},
            indent=2)

    # -- audit ----------------------------------------------------------

    def _checkpoint_bad(self, meta: dict, deep: bool) -> bool:
        step_dir = meta["dir"] if os.path.isabs(meta["dir"]) else \
            os.path.join(self.run_dir, meta["dir"])
        if not os.path.isdir(step_dir):
            return True
        return deep and _hash_tree(step_dir)[0] != meta["sha256"]

    def verify(self, deep: bool = True) -> VerifyReport:
        """One merged audit over every shard ledger and the coordinator's
        checkpoint entries: each rank's missing and corrupt artifacts, the
        merged complete years, and the unrecorded and stale-tmp sweep
        against the union of every rank's recorded artifacts (a peer's
        parts are not unrecorded because this ledger did not write them)."""
        rep = VerifyReport(run_dir=self.run_dir)
        bad_rels = set()
        recorded = set()
        for i in sorted(self.shards):
            m = self.shards[i]
            sub = m.verify(deep=deep)
            rep.missing.extend(sub.missing)
            rep.corrupt.extend(sub.corrupt)
            bad_rels.update(sub.missing)
            bad_rels.update(sub.corrupt)
            recorded.update(m._run_artifacts)
            for y in m._years:
                recorded.update(m._years[y]["artifacts"])
        # the shards' verdicts above already checked every artifact
        rep.years_complete = [
            y for y in self.complete_years(deep=False)
            if not any(rel in bad_rels for m in self.shards.values()
                       for rel in m._years.get(y, {}).get("artifacts", {}))]
        for y, meta in self._checkpoints.items():
            if self._checkpoint_bad(meta, deep):
                rep.bad_checkpoints.append(y)
        for y, metas in self._checkpoint_parts.items():
            if any(self._checkpoint_bad(meta, deep) for meta in metas):
                rep.bad_checkpoints.append(y)
        for d in SURFACE_DIRS:
            root = os.path.join(self.run_dir, d)
            if not os.path.isdir(root):
                continue
            for name in sorted(os.listdir(root)):
                rel = os.path.join(d, name)
                if name.endswith(".tmp"):
                    rep.stale_tmp.append(rel)
                elif name.endswith(PART_SUFFIX) and rel not in recorded:
                    rep.unrecorded.append(rel)
        return rep


def verify_run_dir(run_dir: str, deep: bool = True) -> List[VerifyReport]:
    """Audit a run directory: a one-process run's manifest, a multi-rank
    run's shard ledgers as one merged report (:class:`GangManifest`), or
    each such subdirectory of a sweep's directory. Raises
    FileNotFoundError when no manifest is found."""
    reports: List[VerifyReport] = []

    def audit(d: str) -> bool:
        if os.path.isfile(os.path.join(d, MANIFEST_NAME)):
            reports.append(RunManifest(d).verify(deep=deep))
            return True
        if discover_shards(d):
            reports.append(GangManifest(d).verify(deep=deep))
            return True
        return False

    if not audit(run_dir):
        for name in sorted(os.listdir(run_dir)):
            sub = os.path.join(run_dir, name)
            if os.path.isdir(sub):
                audit(sub)
    if not reports:
        raise FileNotFoundError(
            f"no {MANIFEST_NAME} (nor manifest-p*.json shard ledgers) under "
            f"{run_dir} (not a manifested run directory: run it under the "
            "resilience supervisor, or pass an exporter a RunManifest)"
        )
    return reports
