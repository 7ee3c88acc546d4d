"""Phase timers of the run loop and the host-I/O pipeline (port of the
part of ``dgen_tpu/utils/timing.py`` they use).

:func:`timer` accumulates wall seconds under a name (``ctx:name`` with a
context label); :func:`timing_report` sums them. The buckets recorded:
``year_step`` and ``device_drain`` (the run loop), ``d2h_fetch`` (the
pipeline's fetch stage), and ``health_check``, ``collect_host``,
``export_write``, ``ckpt_save`` and ``callback_host`` (its consumers).
The pipeline's threads record concurrently, so the store is locked.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_TIMINGS: Dict[str, List[float]] = {}
_LOCK = threading.Lock()


def _key(name: str, ctx: Optional[str]) -> str:
    return f"{ctx}:{name}" if ctx else name


@contextmanager
def timer(name: str, ctx: Optional[str] = None):
    """Add the block's wall seconds to the bucket ``name`` (under
    ``ctx``), whether or not the block raises."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        key = _key(name, ctx)
        with _LOCK:
            _TIMINGS.setdefault(key, []).append(dt)
        logging.getLogger(__name__).debug("%s took: %.3fs", key, dt)


def timing_report(ctx: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Per bucket ``{count, total, mean}``; ``ctx`` keeps one context's
    buckets, named without the ``ctx:`` prefix."""
    with _LOCK:
        items = [(k, list(v)) for k, v in _TIMINGS.items()]
    if ctx is not None:
        prefix = f"{ctx}:"
        items = [(k[len(prefix):], v) for k, v in items if k.startswith(prefix)]
    return {k: {"count": len(v), "total": sum(v), "mean": sum(v) / len(v)}
            for k, v in items if v}


def timing_samples(name: str, ctx: Optional[str] = None) -> List[float]:
    """The wall seconds recorded under ``name`` (and ``ctx``), in order."""
    with _LOCK:
        return list(_TIMINGS.get(_key(name, ctx), []))


def reset_timings() -> None:
    with _LOCK:
        _TIMINGS.clear()
