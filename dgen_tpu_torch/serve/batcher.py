"""Bounded-queue microbatcher: coalesce concurrent what-if queries into
padded power-of-two buckets (port of ``dgen_tpu/serve/batcher.py``).

A single-agent query under-fills the card by orders of magnitude, so
requests queue and a worker thread coalesces same-scenario requests in
FIFO order into one bucket, padded up to the next power of two of
``ServeConfig.buckets``; occupancy (real rows / bucket) is the price of
the fixed row counts. A ``max_wait_ms`` deadline bounds how long a lone
request waits for company, and admission control refuses submissions
beyond ``max_queue`` with :class:`QueueFullError`.

Coalescing key: (year_idx, override key): requests batch together only
when they share the scenario inputs a bucket reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional, Sequence

import numpy as np

from dgen_tpu_torch.config import ServeConfig
from dgen_tpu_torch.serve.engine import ServeEngine, override_key
from dgen_tpu_torch.utils import timing

#: latency histogram names (``utils.timing.observe``; /metricz reads them)
REQUEST_LATENCY = "serve_request"
BATCH_WALL = "serve_batch"


class QueueFullError(RuntimeError):
    """Admission control: the queue holds ``max_queue`` requests; the
    client should back off and retry (HTTP 503)."""


class _Request:
    __slots__ = ("rows", "year_idx", "key", "inputs", "future", "t_submit")

    def __init__(self, rows, year_idx, key, inputs):
        self.rows = rows
        self.year_idx = year_idx
        self.key = key
        self.inputs = inputs
        self.future: Future = Future()
        self.t_submit = time.monotonic()


class Microbatcher:
    """The request-coalescing front of a :class:`ServeEngine`.

    ``start=False`` leaves the worker thread unstarted (for tests of the
    queue's state).
    """

    def __init__(self, engine: ServeEngine, config: Optional[ServeConfig] = None,
                 start: bool = True) -> None:
        self.engine = engine
        self.config = config or ServeConfig()
        self._q: "deque[_Request]" = deque()
        self._cv = threading.Condition()
        self._closed = False
        # lifetime counters for /metricz (under _cv)
        self.n_requests = 0
        self.n_rejected = 0
        self.n_batches = 0
        self.n_rows = 0
        #: requests answered from the answer surface (never queued)
        self.n_surface_hits = 0
        self._occupancy_sum = 0.0
        self._thread = threading.Thread(target=self._worker, name="dgen-serve-batcher",
                                        daemon=True)
        if start:
            self._thread.start()

    # -- client side ----------------------------------------------------

    def submit(self, agent_ids: Sequence[int], year: Optional[int] = None,
               overrides: Optional[dict] = None) -> Future:
        """Enqueue one query; the future resolves to the host result dict
        (rows in request order). Raises :class:`QueueFullError` when the
        queue is full, and KeyError, QuarantinedAgentError or
        OverrideError for bad ids, years or overrides, here on the
        caller's thread, so one bad request never fails a batch."""
        if not agent_ids:
            raise ValueError("empty agent_ids")
        if len(agent_ids) > self.config.max_batch:
            raise ValueError(
                f"{len(agent_ids)} agents in one request exceeds max_batch "
                f"{self.config.max_batch}; split the request")
        rows = self.engine.rows_for(agent_ids)
        year_idx = self.engine.year_index(year)
        okey = override_key(overrides)
        # the zero-override question for a year the surface covers is a
        # read of the map: never queued, never padded, not counted against
        # admission (it takes no engine capacity)
        surf = self.engine.surface
        if not okey and surf is not None and surf.covers(year_idx):
            req = _Request(rows, year_idx, (year_idx, okey), None)
            out = surf.lookup(rows, year_idx)
            with self._cv:
                if self._closed:
                    raise RuntimeError("batcher is closed")
                self.n_requests += 1
                self.n_surface_hits += 1
            timing.observe(REQUEST_LATENCY, time.monotonic() - req.t_submit)
            req.future.set_result(out)
            return req.future
        inputs = self.engine.inputs_for(overrides)
        req = _Request(rows, year_idx, (year_idx, okey), inputs)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._q) >= self.config.max_queue:
                self.n_rejected += 1
                raise QueueFullError(
                    f"serve queue full ({self.config.max_queue} requests queued); "
                    "back off and retry")
            self.n_requests += 1
            self._q.append(req)
            self._cv.notify_all()
        return req.future

    def query(self, agent_ids: Sequence[int], year: Optional[int] = None,
              overrides: Optional[dict] = None,
              timeout: Optional[float] = 30.0) -> Dict[str, np.ndarray]:
        """Submit and wait."""
        return self.submit(agent_ids, year, overrides).result(timeout)

    # -- worker side ----------------------------------------------------

    def _take_batch(self) -> Optional[list]:
        """Under _cv: pop the next batch, or None to keep waiting. The FIFO
        head sets the coalescing key; requests of that key join in order
        while the bucket has room; the batch goes when full, past the
        head's deadline, or on close."""
        # a request whose caller gave up (a cancelled future) is dropped
        for r in [r for r in self._q if r.future.cancelled()]:
            self._q.remove(r)
        if not self._q:
            return None
        head = self._q[0]
        batch, rows = [], 0
        for r in self._q:
            if r.key != head.key:
                continue
            if rows + len(r.rows) > self.config.max_batch:
                break
            batch.append(r)
            rows += len(r.rows)
        full = rows >= self.config.max_batch
        expired = time.monotonic() - head.t_submit >= self.config.max_wait_ms / 1e3
        if not (full or expired or self._closed):
            return None
        for r in batch:
            self._q.remove(r)
        return batch

    def _worker(self) -> None:
        while True:
            with self._cv:
                batch = self._take_batch()
                if batch is None:
                    if self._closed and not self._q:
                        return
                    if self._q:
                        deadline = self._q[0].t_submit + self.config.max_wait_ms / 1e3
                        self._cv.wait(timeout=max(deadline - time.monotonic(), 0.0) + 1e-4)
                    else:
                        self._cv.wait()
                    continue
            self._run_batch(batch)

    def _bucket_for(self, rows: int) -> int:
        for b in self.config.buckets:
            if b >= rows:
                return b
        return self.config.max_batch

    def _run_batch(self, batch: list) -> None:
        rows = np.concatenate([r.rows for r in batch])
        bucket = self._bucket_for(rows.shape[0])
        t0 = time.monotonic()
        try:
            out = self.engine.query_rows(rows, batch[0].year_idx, inputs=batch[0].inputs,
                                         bucket=bucket, key=batch[0].key[1])
        except BaseException as e:  # noqa: BLE001 - fail the futures, not the worker
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        timing.observe(BATCH_WALL, time.monotonic() - t0)
        with self._cv:
            self.n_batches += 1
            self.n_rows += int(rows.shape[0])
            self._occupancy_sum += rows.shape[0] / bucket
        lo = 0
        done = time.monotonic()
        for r in batch:
            hi = lo + len(r.rows)
            res = {k: v[lo:hi] for k, v in out.items()}
            lo = hi
            timing.observe(REQUEST_LATENCY, done - r.t_submit)
            if not r.future.cancelled():
                r.future.set_result(res)

    # -- ops ------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Lifetime serving stats (the core of /metricz)."""
        with self._cv:
            rec = {
                "queue_depth": len(self._q),
                "max_queue": self.config.max_queue,
                "requests": self.n_requests,
                "rejected": self.n_rejected,
                "batches": self.n_batches,
                "rows": self.n_rows,
                "surface_hits": self.n_surface_hits,
                "batch_occupancy": (round(self._occupancy_sum / self.n_batches, 4)
                                    if self.n_batches else None),
            }
        rec["buckets"] = list(self.config.buckets)
        rec["warm_buckets"] = sorted(self.engine.warm_buckets)
        rec.update(self.engine.serve_stats())
        lat = timing.histogram(REQUEST_LATENCY)
        if lat is not None:
            snap = lat.snapshot()
            rec["latency_ms"] = {
                "p50": round(snap["p50"] * 1e3, 3),
                "p90": round(snap["p90"] * 1e3, 3),
                "p99": round(snap["p99"] * 1e3, 3),
                "mean": round(snap["mean"] * 1e3, 3),
                "max": round(snap["max"] * 1e3, 3),
                "count": snap["count"],
            }
        return rec

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue and stop the worker. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout)
        # a never-started worker leaves queued futures unresolved
        with self._cv:
            pending = list(self._q)
            self._q.clear()
        for r in pending:
            if not r.future.done():
                r.future.set_exception(RuntimeError("batcher closed"))
