"""The self-healing run supervisor: bounded retry, checkpoint resume and
graceful degradation around ``Simulation.run`` on one card (port of
``dgen_tpu/resilience/supervisor.py``, single process).

* **classify**: an escaped exception is sorted into ``oom``, ``hostio``,
  ``health``, ``transient`` or ``fatal`` (:func:`classify_error`). Fatal
  errors re-raise at once: programming bugs (``ValueError``,
  ``TypeError``, assertion failures), because retrying a bug is noise,
  and on the card a sticky CUDA error (an illegal address, a device-side
  assert: ``torch.AcceleratorError``), because it leaves the process's
  CUDA context dead and every retry in the same process fails the same
  way. A ``torch.OutOfMemoryError`` is ``oom`` by its type, as a message
  with the JAX package's ``RESOURCE_EXHAUSTED`` or the allocator's
  ``out of memory`` is.
* **retry**: everything else retries under exponential backoff with
  deterministic jitter, bounded by :attr:`RetryPolicy.max_retries`.
* **resume**: each retry re-enters from the crash-consistent resume
  frontier, the latest valid checkpoint year ``C`` such that every model
  year ``<= C`` is durably exported per the run's
  :class:`~dgen_tpu_torch.resilience.manifest.RunManifest`; later years
  run and are written again (atomically, over any partial leftovers).
* **degrade**: ``oom`` halves ``RunConfig.agent_chunk`` (the streaming
  year step: a smaller chunk, a smaller peak working set) and re-enters;
  repeated ``hostio`` falls back to the serialized host-I/O path
  (``async_host_io=False``), noted in the manifest and meta.json;
  ``health`` quarantines the sentinel's attributed agents
  (``RunConfig.quarantine_ids``) and re-enters, so the breached year runs
  again with the offenders contained. Nothing falls back to the CPU or
  to the plain versions.

Between attempts nothing of the failed one stays alive: its traceback's
frames are cleared, the garbage collector runs and, on a card, the
caching allocator's free blocks go back (``torch.cuda.empty_cache()``),
so the next attempt is built on the card's memory as it was before.

:func:`run_supervised` is the Simulation path; :class:`Supervisor` wraps
anything attempt-shaped.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import random
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from dgen_tpu_torch.resilience import faults as faults_mod
from dgen_tpu_torch.resilience.manifest import RunManifest

logger = logging.getLogger(__name__)

# -- error classification ----------------------------------------------------

OOM = "oom"
HOSTIO = "hostio"
TRANSIENT = "transient"
FATAL = "fatal"
#: a numerical-health sentinel breach (models.health.HealthBreachError):
#: the degradation quarantines the attributed agents
#: (RunConfig.quarantine_ids) and re-enters from the resume frontier
HEALTH = "health"

#: substrings that mark a device allocation failure: the JAX package's
#: (its faults.SimulatedOOM carries RESOURCE_EXHAUSTED, and so does the
#: port's) and the CUDA caching allocator's ("CUDA out of memory")
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory")

#: messages of the sticky CUDA errors: the context is dead after them
_STICKY_MARKERS = (
    "illegal memory access", "device-side assert", "unspecified launch failure",
    "misaligned address", "illegal instruction", "hardware stack error",
    "uncorrectable ECC error",
)

#: fault sites whose injected errors model host-I/O failures
_HOSTIO_SITES = {
    "hostio_fetch", "hostio_io", "ckpt_save", "export_write",
    "export_torn",
}

#: programming errors: retrying cannot help, re-raise at once
#: (AssertionError covers the invariant harness and the STATE_KW_BOUND
#: soundness check)
_FATAL_TYPES = (ValueError, TypeError, KeyError, AttributeError,
                AssertionError, NotImplementedError)


def _sticky_cuda_error(exc: BaseException) -> bool:
    """A CUDA error that poisons the process's context: the
    ``torch.AcceleratorError`` family (where this torch has it) or a
    sticky error's message."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    msg = str(exc)
    return any(m in msg for m in _STICKY_MARKERS)


def classify_error(exc: BaseException) -> str:
    """Sort an escaped exception into OOM / HOSTIO / HEALTH / TRANSIENT /
    FATAL (the module docstring has the policy of each). The JAX
    package's rules, in its order, plus the card's: a
    ``torch.OutOfMemoryError`` is OOM by its type, and a sticky CUDA error
    is FATAL."""
    if isinstance(exc, torch.OutOfMemoryError):
        return OOM
    msg = f"{type(exc).__name__}: {exc}"
    if any(m in msg for m in _OOM_MARKERS):
        return OOM
    if _sticky_cuda_error(exc):
        return FATAL
    # duck-typed (name + breach payload), as in the JAX package
    if type(exc).__name__ == "HealthBreachError" and hasattr(exc, "breaches"):
        return HEALTH
    if isinstance(exc, faults_mod.FaultError):
        if exc.site in _HOSTIO_SITES:
            return HOSTIO
        return TRANSIENT
    # network and timeout flakes are plain-retry transient; checked
    # before OSError (both are OSError subclasses)
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT
    if isinstance(exc, OSError):
        return HOSTIO
    if isinstance(exc, _FATAL_TYPES):
        return FATAL
    return TRANSIENT


def _device_bytes() -> Optional[int]:
    """``torch.cuda.memory_allocated()``, or None without a card."""
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else None


def _release(exc: BaseException) -> None:
    """Drop what a failed attempt's exception keeps alive: the frames of
    its traceback and of those it chains to."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
            exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _release_device() -> Optional[int]:
    """A garbage collection, then the caching allocator's free blocks
    back to the card; returns the bytes still allocated (None without a
    card)."""
    gc.collect()
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


# -- policy ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry and degradation budget. ``min_agent_chunk`` floors the OOM
    halving (128, the JAX package's floor and the port's smallest
    streaming chunk; tests on tiny tables pass a smaller floor)."""

    max_retries: int = 4
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    jitter_frac: float = 0.1
    min_agent_chunk: int = 128
    #: consecutive-or-cumulative host-IO failures before the serialized
    #: oracle fallback engages
    hostio_failures_before_fallback: int = 2

    def backoff_s(self, retry: int, rng: random.Random) -> float:
        """Exponential backoff with deterministic jitter: retry ``k``
        sleeps ``base * factor**k * (1 + U(0, jitter))`` where U comes
        from the supervisor's seeded RNG — reproducible schedules,
        decorrelated fleets."""
        base = self.backoff_base_s * (self.backoff_factor ** retry)
        return base * (1.0 + self.jitter_frac * rng.random())


@dataclasses.dataclass
class AttemptRecord:
    attempt: int
    error_class: str
    error: str
    backoff_s: float
    degradation: Optional[str] = None
    resumed_from_year: Optional[int] = None
    #: wall seconds of the failed attempt
    wall_s: float = 0.0
    #: ``torch.cuda.memory_allocated()`` before the attempt and after the
    #: failed attempt was released (None off a card): equal when nothing
    #: of the attempt stayed alive
    device_bytes_before: Optional[int] = None
    device_bytes_after: Optional[int] = None


@dataclasses.dataclass
class SupervisorReport:
    """What recovery cost: stamped into the exporter's meta.json and the
    drills' records."""

    attempts: List[AttemptRecord] = dataclasses.field(default_factory=list)
    retries: int = 0
    retries_by_class: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    degradations: List[str] = dataclasses.field(default_factory=list)
    #: wall seconds from the first failure to final success (0.0 for a
    #: clean first attempt)
    recovery_wall_s: float = 0.0
    succeeded: bool = False
    final_agent_chunk: Optional[int] = None
    final_async_host_io: Optional[bool] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["recovery_wall_s"] = round(self.recovery_wall_s, 4)
        return d


@dataclasses.dataclass
class AttemptContext:
    """Handed to the attempt function each try.  ``resume`` is False
    only on a fresh first attempt; ``effective_chunk`` may be reported
    back by the attempt (the live ``Simulation._agent_chunk``) so the
    OOM degradation can halve an auto-derived chunk it could not see
    in the config."""

    attempt: int
    run_config: Any
    resume: bool
    effective_chunk: Optional[int] = None


class Supervisor:
    """Generic bounded-retry engine (module docstring). The attempt
    callable gets an :class:`AttemptContext` and returns the run's
    result; escaped exceptions are classified, degraded on, and retried
    under backoff until the policy budget is spent. Between attempts the
    failed attempt is released (its traceback's frames cleared, a garbage
    collection, ``torch.cuda.empty_cache()`` on a card) and the card's
    allocated bytes are recorded beside those before it."""

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.policy = policy or RetryPolicy()
        self._rng = random.Random(seed)
        self._sleep = sleep

    # -- degradation ----------------------------------------------------

    def _degrade(self, rc, cls: str, ctx: AttemptContext,
                 hostio_failures: int,
                 exc: Optional[BaseException] = None,
                 ) -> tuple[Any, Optional[str], bool]:
        """The degraded config for the next attempt, a description of
        what changed (None = plain retry), and a give-up flag: True means
        no degradation can help (an OOM at the chunk floor is
        deterministic: running it again is noise, not resilience), so the
        caller re-raises instead of retrying. The degradations are the
        JAX package's only: halve the chunk, serialize host I/O. No
        attempt moves to the CPU or to the plain versions."""
        if cls == HEALTH:
            ids = tuple(
                int(a) for a in getattr(exc, "agent_ids", ()) or ()
            )
            if ids:
                merged = tuple(sorted(
                    set(rc.quarantine_ids or ()) | set(ids)
                ))
                if merged != (rc.quarantine_ids or ()):
                    rc = dataclasses.replace(rc, quarantine_ids=merged)
                    return rc, (
                        f"health: quarantined {len(ids)} agent(s) "
                        f"after the year-{getattr(exc, 'year', '?')} "
                        "breach"
                    ), False
                # same offenders breached again THROUGH the quarantine:
                # containment is not working, retrying cannot help
                logger.error(
                    "health breach repeats over already-quarantined "
                    "agents — giving up")
                return rc, None, True
            # unattributed breach (no-consumer pipelined run): plain
            # retry — a deterministic corruption will exhaust the
            # budget and surface, a transient one heals
            return rc, None, False
        if cls == OOM:
            chunk = rc.agent_chunk if rc.agent_chunk else None
            if chunk is None:
                chunk = ctx.effective_chunk or 0
            floor = self.policy.min_agent_chunk
            if chunk and chunk > floor:
                halved = max(floor, chunk // 2)
            elif not chunk:
                # whole-table run OOMed and the attempt reported no
                # chunk: engage streaming at the floor — the smallest
                # working set the policy allows
                halved = floor
            else:
                logger.error(
                    "agent_chunk already at the %d-row floor; OOM "
                    "degradation exhausted — giving up", floor,
                )
                return rc, None, True
            rc = dataclasses.replace(rc, agent_chunk=halved)
            return rc, f"oom: agent_chunk -> {halved}", False
        if cls == HOSTIO and (
            hostio_failures >= self.policy.hostio_failures_before_fallback
            and rc.async_io_enabled
        ):
            rc = dataclasses.replace(rc, async_host_io=False)
            return rc, (
                "hostio: repeated host-IO failure — falling back to the "
                "serialized oracle path (async_host_io=False)"
            ), False
        return rc, None, False

    # -- the loop -------------------------------------------------------

    def run(
        self,
        attempt_fn: Callable[[AttemptContext], Any],
        run_config,
        *,
        resume: bool = False,
        on_degrade: Optional[Callable[[str], None]] = None,
    ) -> tuple[Any, SupervisorReport]:
        """Drive ``attempt_fn`` to success or budget exhaustion.
        Returns ``(result, report)``; re-raises the last error when the
        retry budget is spent or the error is fatal, with the partial
        report attached as ``exc.supervisor_report``."""
        report = SupervisorReport()
        rc = run_config
        hostio_failures = 0
        t_first_failure: Optional[float] = None
        attempt = 0
        while True:
            ctx = AttemptContext(
                attempt=attempt, run_config=rc,
                resume=resume or attempt > 0,
            )
            bytes_before = _device_bytes()
            t_attempt = time.perf_counter()
            try:
                result = attempt_fn(ctx)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — classified below
                cls = classify_error(e)
                if t_first_failure is None:
                    t_first_failure = time.perf_counter()
                if cls == HOSTIO:
                    hostio_failures += 1
                rec = AttemptRecord(
                    attempt=attempt, error_class=cls, error=repr(e),
                    backoff_s=0.0,
                    wall_s=time.perf_counter() - t_attempt,
                    device_bytes_before=bytes_before,
                )
                report.attempts.append(rec)
                report.retries_by_class[cls] = (
                    report.retries_by_class.get(cls, 0) + 1
                )
                give_up = cls == FATAL or attempt >= self.policy.max_retries
                degradation = None
                if not give_up:
                    rc, degradation, give_up = self._degrade(
                        rc, cls, ctx, hostio_failures, exc=e)
                if give_up:
                    try:
                        e.supervisor_report = report  # type: ignore[attr-defined]
                    except (AttributeError, TypeError):
                        pass  # exotic exception types without a __dict__
                    logger.error(
                        "supervisor giving up after attempt %d (%s): %r",
                        attempt, cls, e,
                    )
                    raise
                if degradation is not None:
                    rec.degradation = degradation
                    report.degradations.append(degradation)
                    logger.warning("supervisor degradation: %s", degradation)
                    if on_degrade is not None:
                        on_degrade(degradation)
                # nothing of the failed attempt may stay alive before the
                # next one is built: its frames (the Simulation, the
                # exporter, the pipeline's buffers) hang off the traceback
                _release(e)
                del e
                rec.device_bytes_after = _release_device()
                rec.backoff_s = self.policy.backoff_s(attempt, self._rng)
                report.retries += 1
                logger.warning(
                    "supervisor: attempt %d failed (%s: %s); retrying in "
                    "%.3fs", attempt, cls, rec.error, rec.backoff_s,
                )
                self._sleep(rec.backoff_s)
                attempt += 1
                continue
            report.succeeded = True
            if t_first_failure is not None:
                report.recovery_wall_s = (
                    time.perf_counter() - t_first_failure
                )
            report.final_agent_chunk = getattr(rc, "agent_chunk", None)
            report.final_async_host_io = getattr(
                rc, "async_host_io", None)
            return result, report


# -- the Simulation path --------------------------------------------------

def run_supervised(
    make_sim: Callable[[Any], Any],
    run_config=None,
    *,
    run_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    export_kw: Optional[Dict[str, Any]] = None,
    collect: bool = True,
    policy: Optional[RetryPolicy] = None,
    seed: int = 0,
    resume: bool = False,
) -> tuple[Any, SupervisorReport]:
    """Run a Simulation under the supervisor with crash-consistent
    exports and year resume.

    Parameters
    ----------
    make_sim : ``(run_config) -> Simulation``, built anew each attempt so
        that degradations (a halved chunk, serialized host I/O) take
        effect.
    run_dir : export directory; a :class:`RunManifest` ledger and an
        :class:`~dgen_tpu_torch.io.export.RunExporter` are wired when
        given, and ``quarantine.json`` is written beside ``meta.json``.
    checkpoint_dir : checkpoint directory (default
        ``<run_dir>/checkpoints`` when ``run_dir`` is given; a run with
        neither retries from scratch instead of resuming).
    export_kw : extra RunExporter keywords (``state_names``, ...).
    resume : also resume a run directory that exists before the first
        attempt (retries always resume).

    A ``DGEN_TPU_FAULTS`` spec (or ``run_config.faults``) is installed
    before the first attempt unless a registry is already active, and
    removed when the call ends.
    """
    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.io import checkpoint as ckpt

    rc = run_config or RunConfig()
    # supervised runs escalate sentinel breaches by default: the
    # breach -> attribute -> quarantine -> resume loop is exactly what
    # this supervisor exists for (plain Simulation.run only warns)
    if rc.sentinel_escalate is None:
        rc = dataclasses.replace(rc, sentinel_escalate=True)
    installed: Optional[faults_mod.FaultRegistry] = None
    if faults_mod.active() is None:
        spec = getattr(rc, "faults", None) or os.environ.get(
            "DGEN_TPU_FAULTS", "").strip()
        if spec:
            installed = faults_mod.FaultRegistry.parse(spec)
            faults_mod.install(installed)

    if checkpoint_dir is None and run_dir is not None:
        checkpoint_dir = os.path.join(run_dir, "checkpoints")

    def attempt(ctx: AttemptContext):
        sim = make_sim(ctx.run_config)
        ctx.effective_chunk = sim._agent_chunk or None
        manifest = RunManifest(run_dir) if run_dir is not None else None
        callback = None
        if run_dir is not None:
            from dgen_tpu_torch.io.export import RunExporter

            callback = RunExporter(
                run_dir, sim.host_agent_id, sim.host_mask,
                manifest=manifest, device=sim.device, **(export_kw or {}),
            )
        resume_year = None
        do_resume = ctx.resume and checkpoint_dir is not None
        if do_resume:
            # crash-consistent frontier: never resume past a year whose
            # exports are not durably on disk, or the missing years
            # would stay missing forever.  An exporting run with NO
            # durably-complete year (frontier None — killed before the
            # first export landed, or a damaged/absent manifest) must
            # restart from scratch even when checkpoints exist:
            # resuming from an uncapped checkpoint would permanently
            # skip the un-exported early years.
            if manifest is not None and callback is not None:
                frontier = manifest.complete_through(sim.years)
                if frontier is None:
                    do_resume = False
                else:
                    resume_year = ckpt.latest_valid_year(
                        checkpoint_dir, sim.table.n_agents,
                        max_year=frontier, device=sim.device,
                        rows=sim.checkpoint_rows,
                    )
            else:
                # no exporter: checkpoints are the only artifact, so
                # the newest valid one is the frontier
                resume_year = ckpt.latest_valid_year(
                    checkpoint_dir, sim.table.n_agents, device=sim.device,
                    rows=sim.checkpoint_rows,
                )
            if resume_year is None:
                do_resume = False
        if do_resume:
            logger.info(
                "supervised attempt %d: resuming after year %s",
                ctx.attempt, resume_year,
            )
        res = sim.run(
            callback=callback, collect=collect,
            checkpoint_dir=checkpoint_dir,
            resume=do_resume, resume_year=resume_year,
        )
        return res, sim, callback, manifest

    sup = Supervisor(policy=policy, seed=seed)

    # degradation warnings land in the manifest ledger even when the
    # attempt that triggered them failed before flushing anything else
    def on_degrade(msg: str) -> None:
        if run_dir is not None:
            RunManifest(run_dir).note(f"supervisor degradation: {msg}")

    try:
        (res, sim, exporter, manifest), report = sup.run(
            attempt, rc, resume=resume, on_degrade=on_degrade,
        )
    finally:
        # a registry THIS call armed must not outlive the run — a
        # leftover clause would fire on whatever hits the site next
        # (e.g. a serving process in the same interpreter)
        if installed is not None and faults_mod.active() is installed:
            faults_mod.install(None)
    if manifest is not None and checkpoint_dir is not None:
        manifest.record_checkpoints(checkpoint_dir, sim.years)
    # publish the quarantine ledger: the reasoned report lands as an
    # atomic quarantine.json beside meta.json, is content-hash recorded
    # in the manifest, and its summary is stamped into the exporter's
    # quarantine meta block (beside nonfinite_zeroed)
    rep_q = getattr(sim, "quarantine_report", None)
    if rep_q is not None and run_dir is not None:
        rep_q.save(os.path.join(run_dir, "quarantine.json"))
        if manifest is not None:
            manifest.record_run_artifact("quarantine.json")
            manifest.flush()
        if exporter is not None:
            exporter.stamp_quarantine(rep_q.summary())
    if exporter is not None:
        exporter.stamp_meta(supervisor=report.to_json())
    return res, report
