"""Background host-I/O pipeline: exports, checkpoints and result
collection overlapped with device compute (port of
``dgen_tpu/io/hostio.py``, single process).

.. code-block:: text

    main thread   step N ── step N+1 ── step N+2 ── …   (dispatch)
                       │ submit(N): payloads on the compute stream, event
    fetch thread       └─> side stream waits on the event, copies the
                           payloads to pinned host memory, syncs its event
    io thread                 └─> health ─ collect ─ npz writes ─ checkpoint
                                  (strictly in submission order)

* ``submit`` runs each consumer's ``device_payload`` on the run loop
  thread: the device work it needs (the exporter's int16 quantization, a
  health summary) is queued on the compute stream right behind the step
  that produced the year, and a CUDA event is recorded there.
* The **fetch stage** (one worker thread) makes a side CUDA stream wait
  on that event, then copies every payload tensor into a freshly
  allocated **pinned** host buffer with ``non_blocking=True`` on the side
  stream, marks each source with ``record_stream(side)`` (so the caching
  allocator cannot hand its memory to the next year's step before the
  copy ends) and waits on the side stream's own event, never the device.
  The pinned buffers come from PyTorch's caching host allocator, which
  reuses a block only after every array over it is gone and its copy
  event has completed: a buffer is never reused while a writer still
  reads it. On the CPU the stage reduces to a copy.
* The **io stage** (a second worker thread) runs the consumers on the
  host arrays, in submission order.
* **Depth is bounded** (:func:`depth_for_bytes`): ``submit`` blocks while
  ``max_in_flight`` years are queued, before it builds any payload.
* **Errors surface**: the earliest failed year's error wins, gates that
  year and every later one (earlier years still complete), and is raised
  at the next ``submit`` or at :meth:`HostPipeline.drain`;
  ``drain(failed=True)`` never masks the run loop's own error. A worker's
  error fails the run: nothing falls back to the serialized path.

The serialized per-year path stays in ``Simulation.run`` as the bit-exact
oracle (``RunConfig.async_host_io=False``, ``DGEN_TPU_ASYNC_IO=0``), and
``debug_invariants`` runs always take it. A rank of a multi-rank run
runs its own pipeline over its own rows (the health counts are combined
across ranks at submit time, on the run loop's thread); its checkpoint
stage is :class:`CheckpointConsumer` too, since each rank writes its own
host part of the year (``io.checkpoint``). The JAX package's
``DeviceCheckpointConsumer`` exists because its collective save must see
device arrays; the port's save is not collective, so it has none.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import types
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from dgen_tpu_torch.resilience.faults import fault_point
from dgen_tpu_torch.utils import timing

logger = logging.getLogger(__name__)

#: in-flight per-year bytes the pipeline depth is derived from
QUEUE_HBM_BYTES = int(2e9)


def depth_for_bytes(per_year_bytes: int, budget: int = QUEUE_HBM_BYTES) -> int:
    """Most years in flight: each queued year keeps its device payloads
    (until fetched) and its host copy (until consumed) live, so depth x
    per-year bytes stays within ``budget``. Never below 1: the run loop
    dispatches year N + 1 before it submits year N, so depth 1 still
    overlaps one year."""
    return max(1, int(budget // max(per_year_bytes, 1)))


def _map(fn, obj):
    """``fn`` applied to every tensor of a nest of dicts, lists, tuples,
    NamedTuples and dataclasses; anything else passes through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: _map(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def _tensors(obj) -> List[torch.Tensor]:
    found: List[torch.Tensor] = []
    _map(lambda t: found.append(t), obj)
    return found


def tree_bytes(tree) -> int:
    """Total tensor bytes of a nest (the per-year unit of the depth
    budget)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def to_host(tree, ready: Optional[torch.cuda.Event] = None,
            stream: Optional[torch.cuda.Stream] = None):
    """The nest with every tensor copied to a host numpy array.

    Off a card: a copy of each tensor. On a card: each tensor is copied
    into a new pinned host buffer with ``non_blocking=True`` on
    ``stream`` (None: the current stream, behind everything queued on
    it), which first waits on ``ready`` (the event recorded where the
    tensors were produced); each source is marked with
    ``record_stream(stream)`` and the copies end in one wait on the
    stream's own event. The numpy arrays keep their pinned buffers alive."""
    cuda = [t for t in _tensors(tree) if t.is_cuda]
    if not cuda:
        return _map(lambda t: t.detach().clone().numpy(), tree)
    dev = cuda[0].device
    with torch.cuda.device(dev):
        side = stream if stream is not None else torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            if ready is not None:
                side.wait_event(ready)

            def copy(t):
                if not t.is_cuda:
                    return t.detach().clone()
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                return h

            host = _map(copy, tree)
            done = torch.cuda.Event()
            done.record(side)
    done.synchronize()
    return _map(lambda h: h.numpy(), host)


def pipeline_for(consumers, outs, carry=None, *, timing_ctx: Optional[str] = None,
                 pool: Optional["HostIOPool"] = None) -> "HostPipeline":
    """A :class:`HostPipeline` sized from the first year's outputs (every
    year has the same shapes); pass ``carry`` when checkpointing, since
    each queued year then also holds its carry snapshot."""
    per_year = tree_bytes(outs) + (tree_bytes(carry) if carry is not None else 0)
    return HostPipeline(consumers, max_in_flight=depth_for_bytes(per_year),
                        timing_ctx=timing_ctx, pool=pool)


def snapshot_carry(carry):
    """A device copy of the cross-year carry, queued behind the step that
    produced it and taken before the next step: the checkpoint reads
    this copy, whatever the next year does to the live carry."""
    return _map(torch.clone, carry)


class HostIOPool:
    """The pipeline's two single-thread stages (fetch, io), shareable
    across pipelines."""

    def __init__(self) -> None:
        self.fetch = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="dgen-hostio-fetch")
        self.io = ThreadPoolExecutor(max_workers=1, thread_name_prefix="dgen-hostio-io")

    def close(self) -> None:
        self.fetch.shutdown(wait=True)
        self.io.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Consumers
# ---------------------------------------------------------------------------
#
# A consumer implements:
#   name            payload key of the year's fetch
#   timer_name      utils.timing bucket its consume stage records under
#   needs_device    True -> consume() also receives the year's device
#                   ``outs`` (the pipeline holds them until then)
#   device_payload(year, year_idx, outs, carry) -> nest | None
#                   main thread: the tensors to fetch (None: nothing)
#   consume(year, year_idx, host, outs)
#                   io thread, in submission order
#   finalize(stats, failed)
#                   at drain (main thread), on success or failure


class HealthConsumer:
    """The numerical-health sentinel (models.health): the year's [C, 2]
    summary is reduced at submit time and rides the fetch; the verdict
    runs on the io thread before any export or checkpoint consumer (the
    run loop lists it first), so a breached year is never written. Only
    the attribution leaves' device tensors are kept per queued year."""

    name = "health"
    timer_name = "health_check"
    needs_device = False

    def __init__(self, mask, agent_ids_host, mask_host, escalate: bool,
                 breaches_out: Optional[Dict[int, list]] = None, reduce=None) -> None:
        self._mask = mask
        # a multi-rank run's counts are combined at submit time, on the
        # run loop's thread, where every rank makes its collectives in
        # one order
        self._reduce = reduce
        self._agent_ids = agent_ids_host
        self._mask_host = mask_host
        self.escalate = bool(escalate)
        self.breaches = breaches_out if breaches_out is not None else {}
        self.years_checked = 0
        self._leaves: Dict[int, types.SimpleNamespace] = {}

    def device_payload(self, year, year_idx, outs, carry):
        from dgen_tpu_torch.models import health as health_mod

        self._leaves[int(year_idx)] = types.SimpleNamespace(**{
            name: getattr(outs, name) for name in sorted(health_mod.ATTRIBUTION_LEAVES)})
        return health_mod.health_summary(outs, self._mask, self._reduce)

    def consume(self, year, year_idx, host, outs) -> None:
        from dgen_tpu_torch.models import health as health_mod

        self.years_checked += 1
        refs = self._leaves.pop(int(year_idx), None)
        b = health_mod.check_host(host)
        if not b:
            return
        self.breaches[int(year)] = b
        err = health_mod.breach_error(year, year_idx, b, refs, self._agent_ids,
                                      self._mask_host)
        if self.escalate:
            raise err
        logger.warning("health sentinel: %s", err)

    def finalize(self, stats, failed) -> None:
        self._leaves.clear()


class CollectConsumer:
    """Result collection. Each kept array is copied out of the fetch's
    pinned buffers, which then return to the pool."""

    name = "collect"
    timer_name = "collect_host"
    needs_device = False

    def __init__(self, agent_fields: Sequence[str], with_hourly: bool) -> None:
        self.agent_fields = list(agent_fields)
        self.with_hourly = with_hourly
        self.collected: Dict[str, list] = {k: [] for k in self.agent_fields}
        self.hourly: List[np.ndarray] = []

    def device_payload(self, year, year_idx, outs, carry):
        payload = {k: getattr(outs, k) for k in self.agent_fields}
        if self.with_hourly:
            payload["_hourly"] = outs.state_hourly_net_mw
        return payload

    def consume(self, year, year_idx, host, outs) -> None:
        for k in self.agent_fields:
            self.collected[k].append(np.array(host[k]))
        if self.with_hourly:
            self.hourly.append(np.array(host["_hourly"]))

    def finalize(self, stats, failed) -> None:
        pass


class ExportConsumer:
    """A :class:`~dgen_tpu_torch.io.export.RunExporter` stage: the
    quantization is dispatched at submit time, the fetch rides the fetch
    stage, and only the writes run here."""

    name = "export"
    timer_name = "export_write"
    needs_device = False

    def __init__(self, exporter) -> None:
        self.exporter = exporter

    def device_payload(self, year, year_idx, outs, carry):
        return self.exporter.device_payload(year, year_idx, outs)

    def consume(self, year, year_idx, host, outs) -> None:
        self.exporter.write_host(year, year_idx, host)

    def finalize(self, stats, failed) -> None:
        # on the failure path too: a crashed run stamps the years it wrote
        self.exporter.stamp_hostio(stats)


class CheckpointConsumer:
    """A :class:`~dgen_tpu_torch.io.checkpoint.Writer` stage: ``submit``
    gets the run loop's carry snapshot, the fetch brings it to the host and
    the save runs here. ``Writer.close`` stays with the run loop."""

    name = "ckpt"
    timer_name = "ckpt_save"
    needs_device = False

    def __init__(self, writer) -> None:
        self.writer = writer

    def device_payload(self, year, year_idx, outs, carry):
        return carry

    def consume(self, year, year_idx, host, outs) -> None:
        self.writer.save(year, host)

    def finalize(self, stats, failed) -> None:
        pass


class CallbackConsumer:
    """Any other run callback, run unchanged on the io thread with the
    year's device outputs; its ``prepare(year, year_idx, outs)`` hook, if
    it has one, fires at submit time on the main thread."""

    name = "callback"
    timer_name = "callback_host"
    needs_device = True

    def __init__(self, cb) -> None:
        self.cb = cb

    def device_payload(self, year, year_idx, outs, carry):
        prep = getattr(self.cb, "prepare", None)
        if prep is not None:
            prep(year, year_idx, outs)
        return None

    def consume(self, year, year_idx, host, outs) -> None:
        self.cb(year, year_idx, outs)

    def finalize(self, stats, failed) -> None:
        stamp = getattr(self.cb, "stamp_hostio", None)
        if stamp is not None:
            stamp(stats)


def consumer_for_callback(cb):
    """The stage of a run callback: one with the split fetch/write
    protocol (``device_payload`` and ``write_host``) rides the fetch
    stage, anything else runs as it is on the io thread."""
    if hasattr(cb, "device_payload") and hasattr(cb, "write_host"):
        return ExportConsumer(cb)
    return CallbackConsumer(cb)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

class _Item:
    __slots__ = ("year", "year_idx", "payloads", "ready", "outs", "done",
                 "fetch_s", "consume_s", "nbytes")

    def __init__(self, year, year_idx, payloads, ready, outs) -> None:
        self.year = year
        self.year_idx = year_idx
        self.payloads = payloads
        self.ready = ready
        self.outs = outs
        self.done: Future = Future()
        self.fetch_s = 0.0
        self.consume_s = 0.0
        self.nbytes = 0


class HostPipeline:
    """Bounded FIFO pipeline of per-year host-I/O work (the module
    docstring has the contract).

    ``consumers``: the ordered stages; ``max_in_flight``: the queue depth
    bound (:func:`depth_for_bytes`); ``timing_ctx``: the utils.timing
    context of the stage timers; ``pool``: a shared :class:`HostIOPool`
    (None: the pipeline owns one and closes it at drain).
    """

    def __init__(self, consumers: Sequence[Any], *, max_in_flight: int = 1,
                 timing_ctx: Optional[str] = None,
                 pool: Optional[HostIOPool] = None) -> None:
        self.consumers = list(consumers)
        self.timing_ctx = timing_ctx
        self.max_in_flight = max(1, int(max_in_flight))
        self._own_pool = pool is None
        self.pool = pool if pool is not None else HostIOPool()
        self._slots = threading.BoundedSemaphore(self.max_in_flight)
        self._lock = threading.Lock()
        self._items: List[_Item] = []
        self._error: Optional[BaseException] = None
        self._error_year = None
        self._error_year_idx: Optional[int] = None
        self._in_flight = 0
        self.max_observed_depth = 0
        self.host_blocked_s = 0.0
        self._fetch_s = 0.0
        self._consume_s = 0.0
        self._fetch_bytes = 0
        self._needs_device = any(getattr(c, "needs_device", False)
                                 for c in self.consumers)
        self._stream: Optional[torch.cuda.Stream] = None
        self._drained = False

    # -- error plumbing -------------------------------------------------
    def _record_error(self, year, exc: BaseException,
                      year_idx: Optional[int] = None) -> None:
        """Keep the error of the earliest failed year: the fetch stage
        runs ahead of the io stage, so a later year's fetch error may be
        recorded before an earlier year's write fails, and then the
        earlier one wins. A superseded error is logged."""
        with self._lock:
            if self._error is None or (
                    year_idx is not None and self._error_year_idx is not None
                    and year_idx < self._error_year_idx):
                dropped, dropped_year = self._error, self._error_year
                self._error = exc
                self._error_year = year
                self._error_year_idx = year_idx
            else:
                dropped, dropped_year = exc, year
        if dropped is not None:
            logger.error("host-IO pipeline error for year %s: %r (year %s's error "
                         "wins)", dropped_year, dropped, self._error_year)

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise self._error

    def _should_run(self, item: _Item) -> bool:
        """Years before the failed year still run; the failed year and
        every later one are skipped."""
        with self._lock:
            if self._error is None:
                return True
            if self._error_year_idx is None:
                return False
            return item.year_idx < self._error_year_idx

    # -- submit (main thread) -----------------------------------------
    def submit(self, year: int, year_idx: int, outs, carry=None) -> None:
        """Queue year ``year``'s consumers. Blocks while ``max_in_flight``
        years are queued; raises an earlier worker error instead of
        queueing more work on a dead pipeline."""
        self._raise_if_failed()
        # the slot first: the payloads built below count against the
        # depth budget, and blocking here queues no device work, so they
        # still land right behind this year's step
        t0 = time.perf_counter()
        self._slots.acquire()
        self.host_blocked_s += time.perf_counter() - t0
        payloads = {}
        ready = None
        try:
            for c in self.consumers:
                p = c.device_payload(year, year_idx, outs, carry)
                if p is not None:
                    payloads[c.name] = p
            cuda = [t for t in _tensors(payloads) if t.is_cuda]
            if cuda:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device=cuda[0].device)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(cuda[0].device))
        except BaseException:
            self._slots.release()
            raise
        with self._lock:
            self._in_flight += 1
            self.max_observed_depth = max(self.max_observed_depth, self._in_flight)
        item = _Item(year, year_idx, payloads, ready,
                     outs if self._needs_device else None)
        self._items.append(item)
        try:
            self.pool.fetch.submit(self._fetch_job, item)
        except BaseException as e:  # the pool was torn down
            self._record_error(year, e, year_idx)
            self._finish(item)
            raise

    # -- fetch stage (fetch thread) -------------------------------------
    def _fetch_job(self, item: _Item) -> None:
        host = None
        try:
            # fault site: a fetch worker dying mid-year surfaces through
            # _record_error at submit or drain, never hangs the run loop
            fault_point("hostio_fetch")
            if item.payloads and self._should_run(item):
                t0 = time.perf_counter()
                with timing.timer("d2h_fetch", ctx=self.timing_ctx):
                    host = to_host(item.payloads, ready=item.ready, stream=self._stream)
                item.fetch_s = time.perf_counter() - t0
                item.nbytes = tree_bytes(item.payloads)
                with self._lock:
                    self._fetch_s += item.fetch_s
                    self._fetch_bytes += item.nbytes
        except BaseException as e:  # noqa: BLE001 — surfaced at submit/drain
            self._record_error(item.year, e, item.year_idx)
            host = None
        item.payloads = None   # the device tensors are released here
        item.ready = None
        try:
            self.pool.io.submit(self._io_job, item, host)
        except BaseException as e:
            self._record_error(item.year, e, item.year_idx)
            self._finish(item)

    # -- consume stage (io thread) --------------------------------------
    def _io_job(self, item: _Item, host) -> None:
        try:
            # fault site: the ordered consume worker dying mid-year
            fault_point("hostio_io")
            if self._should_run(item):
                t0 = time.perf_counter()
                for c in self.consumers:
                    payload = None if host is None else host.get(c.name)
                    if payload is None and not c.needs_device:
                        continue
                    with timing.timer(c.timer_name, ctx=self.timing_ctx):
                        c.consume(item.year, item.year_idx, payload, item.outs)
                item.consume_s = time.perf_counter() - t0
                with self._lock:
                    self._consume_s += item.consume_s
        except BaseException as e:  # noqa: BLE001 — surfaced at submit/drain
            self._record_error(item.year, e, item.year_idx)
        finally:
            self._finish(item)

    def _finish(self, item: _Item) -> None:
        item.outs = None
        with self._lock:
            self._in_flight -= 1
        self._slots.release()
        if not item.done.done():
            item.done.set_result(None)

    # -- drain (main thread, from a finally) ---------------------------
    def drain(self, failed: bool = False) -> Dict[str, Any]:
        """Wait for every queued year and finalize the consumers. On the
        success path the earliest failed year's error is raised here; with
        ``failed=True`` (the run loop already raised) it is logged,
        so the loop's own error is not masked. Closes an owned pool.
        Idempotent. Returns :meth:`stats`."""
        if self._drained:
            return self.stats()
        self._drained = True
        t0 = time.perf_counter()
        for item in self._items:
            item.done.result()
        self.host_blocked_s += time.perf_counter() - t0
        if self._own_pool:
            self.pool.close()
        finalize_err: Optional[BaseException] = None
        for c in self.consumers:
            try:
                c.finalize(self.stats(), failed or self._error is not None)
            except BaseException as e:  # noqa: BLE001
                if finalize_err is None:
                    finalize_err = e
        if self._error is not None:
            if failed:
                logger.error("host-IO pipeline failed for year %s: %r (the loop's "
                             "own error wins)", self._error_year, self._error)
            else:
                if finalize_err is not None:
                    logger.error("host-IO finalize failed: %r", finalize_err)
                raise self._error
        if finalize_err is not None:
            if failed:
                logger.error("host-IO finalize failed: %r", finalize_err)
            else:
                raise finalize_err
        return self.stats()

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Per-year host-I/O wall (fetch + consume seconds), stage totals,
        the bytes fetched, the wall the run loop spent blocked on the
        pipeline (full submits and the drain), and ``overlap_efficiency``
        = 1 - blocked / host-I/O wall, the share hidden behind the
        device."""
        years = {int(i.year): round(i.fetch_s + i.consume_s, 4)
                 for i in self._items
                 if i.done.done() and (i.fetch_s or i.consume_s)}
        host_io = self._fetch_s + self._consume_s
        overlap = (1.0 - min(self.host_blocked_s, host_io) / host_io
                   if host_io > 0 else 1.0)
        return {
            "years": years,
            "d2h_fetch_s": round(self._fetch_s, 4),
            "d2h_bytes": int(self._fetch_bytes),
            "consume_s": round(self._consume_s, 4),
            "host_io_s": round(host_io, 4),
            "host_blocked_s": round(self.host_blocked_s, 4),
            "overlap_efficiency": round(overlap, 4),
            "max_depth": self.max_observed_depth,
            "depth_bound": self.max_in_flight,
        }
