"""Exact result cache for served what-if answers (port of
``dgen_tpu/serve/resultcache.py``).

An answer is the same bits for the same (year, canonical override key,
bucket, requested rows) under the same configuration, so a cache hit is
the exact answer. The cache keeps answers in a directory that several
processes may share: a hot what-if is computed once and then served from
disk, also by a process that just restarted.

* **key**: sha256 over (provenance key, year index, override key,
  bucket, the row-index bytes). The provenance key (config hash, git
  sha, population) partitions the directory across versions: an entry of
  another version is never addressed.
* **value**: one ``.npz`` of the host result arrays, landed by temp file
  + ``os.replace``.
* **bounded**: at most ``max_entries`` files; a store evicts the least
  recently used (a hit touches the file's mtime).

Concurrent writers race benignly (a double store writes the same bytes);
a read racing an eviction counts as a miss. Counters (hits, misses,
stores, evictions) surface in ``/metricz``.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SUFFIX = ".npz"


class ResultCache:
    """Bounded, file-backed answer cache.

    ``dir_path``: the directory (created if absent); ``provenance_key``:
    partitions keys across code and config versions; ``max_entries``:
    the eviction bound (files), enforced on store.
    """

    def __init__(self, dir_path: str, provenance_key: str = "",
                 max_entries: int = 512) -> None:
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.dir = dir_path
        self.provenance_key = provenance_key
        self.max_entries = int(max_entries)
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0

    def key(self, year_idx: int, override_key: str, bucket: int, rows: np.ndarray) -> str:
        """The entry key: everything the answer bytes depend on within one
        provenance partition."""
        h = hashlib.sha256()
        h.update(self.provenance_key.encode())
        h.update(f"|{int(year_idx)}|{override_key}|{int(bucket)}|".encode())
        h.update(np.ascontiguousarray(rows, dtype=np.int32).tobytes())
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key + _SUFFIX)

    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """The cached answer, or None (a miss). A file that vanished
        (concurrent eviction) or does not parse is a miss, never an
        error."""
        path = self._path(key)
        try:
            with np.load(path, allow_pickle=False) as z:
                out = {f: np.array(z[f]) for f in z.files}
            os.utime(path)   # LRU touch: eviction orders by mtime
        except (OSError, ValueError, KeyError, EOFError):
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return out

    def put(self, key: str, out: Dict[str, np.ndarray]) -> None:
        """Store an answer (temp file + rename), then evict beyond the
        bound. A failure is logged, never raised: the cache is an
        accelerator, not a dependency."""
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            buf = io.BytesIO()
            np.savez(buf, **out)
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("result cache store failed: %s", e)
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass
            return
        with self._lock:
            self.stores += 1
        self._evict()

    def _evict(self) -> None:
        """Drop the least recently used entries beyond ``max_entries``, and
        a killed writer's temp files older than a minute."""
        try:
            entries = []
            for name in os.listdir(self.dir):
                p = os.path.join(self.dir, name)
                try:
                    if name.endswith(".tmp"):
                        if time.time() - os.path.getmtime(p) > 60.0:
                            os.remove(p)
                        continue
                    if name.endswith(_SUFFIX):
                        entries.append((os.path.getmtime(p), p))
                except OSError:
                    continue   # vanished under a concurrent evictor
            excess = len(entries) - self.max_entries
            if excess <= 0:
                return
            entries.sort()
            dropped = 0
            for _mt, p in entries[:excess]:
                try:
                    os.remove(p)
                    dropped += 1
                except OSError:
                    continue
            if dropped:
                with self._lock:
                    self.evictions += dropped
        except OSError as e:
            logger.warning("result cache eviction scan failed: %s", e)

    def stats(self) -> dict:
        with self._lock:
            rec = {"hits": self.hits, "misses": self.misses, "stores": self.stores,
                   "evictions": self.evictions, "max_entries": self.max_entries}
        rec["dir"] = self.dir
        return rec
