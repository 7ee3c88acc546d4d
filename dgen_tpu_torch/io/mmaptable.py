"""Memory-mapped columnar tables: one binary blob and a JSON header (port
of ``dgen_tpu/io/mmaptable.py``).

The serving answer surface (:mod:`dgen_tpu_torch.serve.surface`) reads
through this: a lookup indexes page-cache-backed memory with no decoding,
every process on a machine that maps the file shares one physical copy,
and a table is published crash-consistently and content-hashed.

Layout on disk (a directory)::

    <dir>/table.bin    column blobs, back to back, 64-byte aligned
    <dir>/table.json   header: format tag, per-column dtype/shape/
                       offset/nbytes/sha256, content hash, user meta

Both files land by temp file + rename (:mod:`dgen_tpu_torch.utils.atomic`)
and the header lands last: a killed writer leaves a blob without a
header (refused as missing), never a header naming bytes that are not
there. ``content_hash`` is a sha256 over the ordered per-column hashes,
so two tables with the same columns hash the same whatever their meta.
The format is the JAX package's (same tag, same header keys): either
package reads the other's tables.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np

from dgen_tpu_torch.utils.atomic import atomic_write, atomic_write_json

FORMAT = "dgen-mmap-table-v1"

_BIN = "table.bin"
_HEADER = "table.json"

#: column blobs start on 64-byte boundaries
_ALIGN = 64


class MmapTableError(RuntimeError):
    """A table directory is missing, malformed, truncated, or fails its
    content-hash check; the message names the reason."""


def _aligned(offset: int) -> int:
    return (offset + _ALIGN - 1) // _ALIGN * _ALIGN


def write_table(dir_path: str, columns: Mapping[str, np.ndarray],
                meta: Optional[dict] = None) -> dict:
    """Write ``columns`` (name -> array, any shapes and dtypes) as a
    memory-mappable table at ``dir_path``; returns the header written.
    ``meta`` rides in the header as it is (the answer surface keeps its
    provenance there)."""
    if not columns:
        raise ValueError("write_table: no columns")
    os.makedirs(dir_path, exist_ok=True)
    cols = {}
    offset = 0
    order = list(columns)
    blobs = []
    for name in order:
        arr = np.ascontiguousarray(columns[name])
        blob = arr.tobytes()
        offset = _aligned(offset)
        cols[name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(),
        }
        blobs.append((offset, blob))
        offset += len(blob)

    def _write_bin(tmp: str) -> None:
        with open(tmp, "wb") as f:
            for off, blob in blobs:
                f.seek(off)
                f.write(blob)

    atomic_write(os.path.join(dir_path, _BIN), _write_bin)
    content = hashlib.sha256(
        "".join(cols[n]["sha256"] for n in order).encode()).hexdigest()
    header = {
        "format": FORMAT,
        "columns": cols,
        "column_order": order,
        "content_hash": content,
        "total_bytes": offset,
        "meta": dict(meta or {}),
    }
    atomic_write_json(os.path.join(dir_path, _HEADER), header)
    return header


class MmapTable:
    """Read-only view of a written table: ``columns[name]`` is a zero-copy
    array view into one shared ``np.memmap``.

    Opening checks the header and that the blob holds every byte the
    header names (truncation); :meth:`verify` re-hashes the blobs
    (tampering)."""

    def __init__(self, dir_path: str) -> None:
        self.dir = dir_path
        hpath = os.path.join(dir_path, _HEADER)
        bpath = os.path.join(dir_path, _BIN)
        if not os.path.isfile(hpath):
            raise MmapTableError(f"missing header {hpath}")
        if not os.path.isfile(bpath):
            raise MmapTableError(f"missing data file {bpath}")
        try:
            with open(hpath) as f:
                self.header = json.load(f)
        except (OSError, ValueError) as e:
            raise MmapTableError(f"unreadable header {hpath}: {e}") from e
        if self.header.get("format") != FORMAT:
            raise MmapTableError(
                f"unknown table format {self.header.get('format')!r} "
                f"(expected {FORMAT})")
        size = os.path.getsize(bpath)
        need = max((c["offset"] + c["nbytes"] for c in self.header["columns"].values()),
                   default=0)
        if size < need:
            raise MmapTableError(
                f"{bpath} truncated: {size} bytes on disk, header names {need}")
        self._mm = np.memmap(bpath, dtype=np.uint8, mode="r")
        self.columns: Dict[str, np.ndarray] = {}
        for name, c in self.header["columns"].items():
            raw = self._mm[c["offset"]:c["offset"] + c["nbytes"]]
            try:
                self.columns[name] = raw.view(np.dtype(c["dtype"])).reshape(
                    tuple(c["shape"]))
            except (TypeError, ValueError) as e:
                # a damaged header is refused like a damaged blob
                raise MmapTableError(
                    f"column '{name}' header is invalid (dtype={c['dtype']!r}, "
                    f"shape={c['shape']!r}): {e}") from e

    @property
    def meta(self) -> dict:
        return self.header.get("meta", {})

    @property
    def content_hash(self) -> str:
        return self.header["content_hash"]

    def verify(self) -> None:
        """Re-hash every column blob against the header; raises
        :class:`MmapTableError` naming the first column that differs."""
        for name, c in self.header["columns"].items():
            raw = self._mm[c["offset"]:c["offset"] + c["nbytes"]]
            got = hashlib.sha256(raw.tobytes()).hexdigest()
            if got != c["sha256"]:
                raise MmapTableError(
                    f"column '{name}' content hash mismatch (on-disk {got[:12]} "
                    f"!= header {c['sha256'][:12]}): the table bytes were damaged "
                    "after publication")

    def close(self) -> None:
        self.columns = {}
        self._mm = None
