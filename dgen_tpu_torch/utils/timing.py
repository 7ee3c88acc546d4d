"""Phase timers of the run loop and the host-I/O pipeline (port of the
part of ``dgen_tpu/utils/timing.py`` they use).

:func:`fn_timer` is the decorator form (the host-input layer's
``io.reference_inputs.scenario_inputs_from_reference`` wears it): each
call's wall seconds go into the bucket named by the function's
qualified name. :func:`timer` accumulates wall seconds under a name (``ctx:name`` with a
context label); :func:`timing_report` sums them. The buckets recorded:
``year_step`` and ``device_drain`` (the run loop), ``d2h_fetch`` (the
pipeline's fetch stage), and ``health_check``, ``collect_host``,
``export_write``, ``ckpt_save`` and ``callback_host`` (its consumers).
The pipeline's threads record concurrently, so the store is locked.

:func:`observe` records a duration into a fixed log-spaced
:class:`LogHistogram` instead (O(1) memory: the serving stack's per
request latencies, read back as p50/p90/p99 by ``/metricz`` and by
:func:`timing_report`).
"""

from __future__ import annotations

import functools
import logging
import math
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

_TIMINGS: Dict[str, List[float]] = {}
_LOCK = threading.Lock()


def _key(name: str, ctx: Optional[str]) -> str:
    return f"{ctx}:{name}" if ctx else name


def fn_timer(tab_level: int = 0) -> Callable:
    """Decorator: add each call's wall seconds to the bucket named by the
    function's ``__qualname__`` and log them at debug level, indented by
    ``tab_level`` tabs."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with _LOCK:
                _TIMINGS.setdefault(fn.__qualname__, []).append(dt)
            logging.getLogger(__name__).debug("%s%s took: %.3fs", "\t" * tab_level,
                                              fn.__qualname__, dt)
            return out

        return wrapper

    return deco


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


_HIST_MIN = 1e-4          # seconds: the first bucket's upper bound
_HIST_GROWTH = 2.0 ** 0.5
_HIST_N = 48

#: bucket upper bounds (seconds), shared by every histogram
HIST_BOUNDS: tuple = tuple(_HIST_MIN * _HIST_GROWTH ** i for i in range(_HIST_N))


class LogHistogram:
    """Histogram of nonnegative durations over fixed log-spaced buckets.

    ``counts[i]`` holds the observations in ``(HIST_BOUNDS[i - 1],
    HIST_BOUNDS[i]]``; the last slot is the overflow bucket. Locked: the
    batcher records from its worker thread while ``/metricz`` reads from
    handler threads."""

    __slots__ = ("counts", "n", "total", "vmax", "_lock")

    def __init__(self) -> None:
        self.counts = [0] * (_HIST_N + 1)
        self.n = 0
        self.total = 0.0
        self.vmax = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        v = max(float(seconds), 0.0)
        if v <= _HIST_MIN:
            i = 0
        else:
            i = min(int(math.ceil(math.log(v / _HIST_MIN) / math.log(_HIST_GROWTH))),
                    _HIST_N)
        with self._lock:
            self.counts[i] += 1
            self.n += 1
            self.total += v
            self.vmax = max(self.vmax, v)

    def percentile(self, q: float) -> float:
        """The upper bound of the bucket holding the ``q``-th observation
        (``q`` in [0, 1]), capped at the largest observed value."""
        with self._lock:
            if not self.n:
                return 0.0
            target = q * self.n
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= target:
                    bound = HIST_BOUNDS[i] if i < _HIST_N else self.vmax
                    return min(bound, self.vmax)
            return self.vmax

    def snapshot(self) -> Dict[str, float]:
        """``{count, total, mean, p50, p90, p99, max}``."""
        with self._lock:
            n, total, vmax = self.n, self.total, self.vmax
        if not n:
            return {"count": 0, "total": 0.0, "mean": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0}
        return {"count": n, "total": total, "mean": total / n,
                "p50": self.percentile(0.50), "p90": self.percentile(0.90),
                "p99": self.percentile(0.99), "max": vmax}


_HISTS: Dict[str, LogHistogram] = {}


def observe(name: str, seconds: float, ctx: Optional[str] = None) -> None:
    """Record one duration into the histogram ``name`` (under ``ctx``)."""
    key = _key(name, ctx)
    h = _HISTS.get(key)
    if h is None:
        with _LOCK:
            h = _HISTS.setdefault(key, LogHistogram())
    h.record(seconds)


def histogram(name: str, ctx: Optional[str] = None) -> Optional[LogHistogram]:
    """The histogram ``name`` (under ``ctx``), or None before its first
    observation."""
    return _HISTS.get(_key(name, ctx))


def timing_report(ctx: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Per bucket ``{count, total, mean}``, and per histogram its
    :meth:`LogHistogram.snapshot` (a name recorded both ways reports the
    histogram); ``ctx`` keeps one context's entries, named without the
    ``ctx:`` prefix."""
    with _LOCK:
        items = [(k, list(v)) for k, v in _TIMINGS.items()]
        hists = list(_HISTS.items())

    def select(pairs):
        if ctx is None:
            return pairs
        prefix = f"{ctx}:"
        return [(k[len(prefix):], v) for k, v in pairs if k.startswith(prefix)]

    out = {k: {"count": len(v), "total": sum(v), "mean": sum(v) / len(v)}
           for k, v in select(items) if v}
    for k, h in select(hists):
        snap = h.snapshot()
        if snap["count"]:
            out[k] = snap
    return out


def timing_samples(name: str, ctx: Optional[str] = None) -> List[float]:
    """The wall seconds recorded under ``name`` (and ``ctx``), in order."""
    with _LOCK:
        return list(_TIMINGS.get(_key(name, ctx), []))


def reset_timings() -> None:
    with _LOCK:
        _TIMINGS.clear()
        _HISTS.clear()
