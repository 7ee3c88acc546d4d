"""Crash-consistent artifact writes: temp file + ``os.replace`` (port of
``dgen_tpu/resilience/atomic.py``).

A reader never sees a partly written file at the final path: it sees the
previous complete version or the new complete one. A killed writer
leaves at most a ``*.tmp`` sibling. Fault sites
(:mod:`dgen_tpu_torch.resilience.faults`): ``export_write`` fires before
the rename (the writer died, nothing landed) and ``export_torn`` after
it (torn storage damaged a landed artifact, what the run manifest's
hashes catch). The JAX package's parquet writer
becomes :func:`atomic_write_npz`: the port writes its run surfaces as
numpy ``.npz`` archives, so the card path needs neither pandas nor
pyarrow.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Callable, Mapping

import numpy as np

from dgen_tpu_torch.resilience.faults import fault_point

#: the modification time stamped on every ``.npz`` entry, so that the
#: same arrays always give the same bytes (``np.savez`` stamps the
#: current time)
NPZ_DATE_TIME = (1980, 1, 1, 0, 0, 0)


def atomic_write(path: str, write_fn: Callable[[str], None]) -> None:
    """Write ``path`` crash-consistently: ``write_fn(tmp_path)`` produces
    the bytes at a temp sibling, then one ``os.replace`` publishes them.
    The temp file is removed on failure."""
    tmp = f"{path}.tmp"
    ok = False
    try:
        write_fn(tmp)
        fault_point("export_write", path=path)
        os.replace(tmp, path)
        ok = True
    finally:
        if not ok and os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    fault_point("export_torn", path=path)


def atomic_write_text(path: str, text: str, **open_kw: Any) -> None:
    def _w(tmp: str) -> None:
        with open(tmp, "w", **open_kw) as f:
            f.write(text)

    atomic_write(path, _w)


def atomic_write_json(path: str, obj: Any, **dump_kw: Any) -> None:
    def _w(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, **dump_kw)

    atomic_write(path, _w)


def atomic_write_bytes(path: str, blob: bytes) -> None:
    def _w(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(blob)

    atomic_write(path, _w)


def write_npz(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """An uncompressed ``.npz`` that ``np.load`` reads, every entry
    stamped :data:`NPZ_DATE_TIME`: the same arrays give the same bytes.
    Object arrays are refused (nothing written needs pickle)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", date_time=NPZ_DATE_TIME)
            info.compress_type = zipfile.ZIP_STORED
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


def atomic_write_npz(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """:func:`write_npz` via temp file + rename: a killed exporter never
    leaves a truncated partition at a ``year=*.npz`` path."""
    atomic_write(path, lambda tmp: write_npz(tmp, arrays))
