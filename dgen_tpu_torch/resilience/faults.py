"""Deterministic fault injection for the supervisors' recovery drills
(port of ``dgen_tpu/resilience/faults.py``).

Every recovery path (checkpoint resume, host-I/O pipeline error
surfacing, OOM chunk degradation, export re-emission, load-time
quarantine, the health sentinel's escalation) is trustworthy only if it
runs: named **fault sites** sit on the production paths, and a
:class:`FaultRegistry` (installed by the run supervisor from
``RunConfig.faults`` or ``DGEN_TPU_FAULTS``, by
:func:`install_from_env`, or by a test's :func:`injected` context) fires
failures at chosen hit counts, the same way on the CPU and on the card.

Spec grammar (``DGEN_TPU_FAULTS``)::

    spec    := clause (";" clause)*
    clause  := site ["@" nth] ["x" times] [":" kind]
    site    := a registered site name (see SITES)
    nth     := 1-based hit index at which the clause starts firing
               (default 1: the first hit)
    times   := how many consecutive hits fire (default 1)
    kind    := "error" (default) | "oom" | "kill" | "truncate" | "hang"
               | "corrupt"

Examples::

    ckpt_save@2                 fail the 2nd checkpoint save
    year_step@3:oom             simulate a device OOM on the 3rd year step
    hostio_io x2                fail the first two io-thread consumes
    export_torn:truncate        damage the first landed export artifact
    ckpt_save@2;hostio_fetch@1  two independent clauses

Kinds: ``error`` raises :class:`FaultError`; ``oom`` raises
:class:`SimulatedOOM`, whose message carries both the JAX package's
``RESOURCE_EXHAUSTED`` marker and the CUDA caching allocator's
``CUDA out of memory``, so the supervisor classifies a simulated OOM by
the same rule as a real one; ``kill`` ends the process with
:data:`KILL_EXIT_CODE` and no cleanup; ``truncate`` (artifact sites)
halves the landed file, then raises; ``hang`` sleeps
``DGEN_TPU_FAULT_HANG_S`` seconds and carries on; ``corrupt`` returns to
the caller, which damages its data deterministically and carries on.

The sites are the JAX package's: the run path, input reads, the sweep,
the serving stack and fleet, and the rank gang (a rank dying mid-year, a
rank's heartbeat stalling, the per-year stop barrier failing). A name
the JAX package does not know is refused with ``ValueError``, as there.

The uninstalled fast path is one module-global ``None`` check per site.
"""


from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

#: process exit code used by the ``kill`` kind — distinct from common
#: python/pytest codes so a subprocess drill can assert the death was
#: the injected one
KILL_EXIT_CODE = 77

#: registered fault sites -> where they live / what failing there models
SITES: Dict[str, str] = {
    "year_step": (
        "models.simulation.Simulation.step: the year step's dispatch; "
        "``oom`` here raises what a CUDA allocator OOM raises"
    ),
    "ckpt_save": (
        "io.checkpoint.Writer.save: the checkpoint write; ``kill`` "
        "models a process death mid-save"
    ),
    "hostio_fetch": (
        "io.hostio.HostPipeline fetch stage: the device-to-host copy "
        "worker dying mid-year"
    ),
    "hostio_io": (
        "io.hostio.HostPipeline io stage: the ordered consume worker "
        "(collect, export, checkpoint) dying mid-year"
    ),
    "export_write": (
        "utils.atomic.atomic_write, before the rename: a writer failing "
        "or killed before its artifact lands (the previous artifact, if "
        "any, survives intact)"
    ),
    "export_torn": (
        "utils.atomic.atomic_write, after the rename: torn storage "
        "damaging a landed artifact (``truncate``)"
    ),
    "ingest": (
        "io.ingest._read_csv: a transient input-read failure (a network "
        "filesystem flake), retryable by the supervisor"
    ),
    "ingest_corrupt_row": (
        "models.agents.build_agent_table: malformed rows entering the "
        "agent table (``corrupt``: a NaN customer count and an "
        "out-of-range tariff reference on the DGEN_TPU_FAULT_CORRUPT_ROWS "
        "rows); load-time validation (resilience.quarantine) must "
        "quarantine exactly those rows"
    ),
    "sweep_scenario": (
        "sweep.driver loop mode: a scenario run dying between the "
        "scenarios of a group; a retry with resume re-enters at "
        "(scenario, year)"
    ),
    "serve_query": (
        "serve.engine.ServeEngine.query_rows: a device failure on the "
        "serving path (the batcher must fail that batch's futures, never "
        "its worker thread)"
    ),
    "serve_replica_kill": (
        "serve.engine.ServeEngine.query_rows: a serving process dying "
        "mid-query (``kill``: os._exit with requests in flight)"
    ),
    "serve_replica_hang": (
        "serve.engine.ServeEngine.query_rows: a serving process stalling "
        "mid-query (``hang``: the batcher's worker sleeps "
        "DGEN_TPU_FAULT_HANG_S seconds, stalling every queued batch; the "
        "handlers' request deadline answers 504)"
    ),
    "front_route": (
        "serve.front.FleetFront.route_query: a forward attempt to the chosen "
        "replica failing at the routing layer (connection refused or reset); "
        "the front must count it against that replica's breaker and retry on "
        "another replica"
    ),
    "surface_load": (
        "serve.surface.AnswerSurface.load: the precomputed answer surface "
        "failing to load or verify at boot (``error``: an unreadable map; "
        "``truncate``: table.bin halved before the open). The engine must "
        "refuse the surface with a named reason and answer from the "
        "kernels, never from damaged bytes"
    ),
    "bank_corrupt_row": (
        "models.simulation: a profile-bank row going bad (``corrupt``: a "
        "NaN load row, or a NaN scale under int8 banks). Hit #1 is "
        "Simulation construction (caught by validation); later hits fire "
        "before a year step (caught only by the health sentinel's breach "
        "-> attribute -> quarantine escalation)"
    ),
    "gang_worker_kill": (
        "resilience.gangworker per-year export callback: a rank process "
        "dying mid-year (``kill``: preemption or an OOM kill with "
        "collectives in flight); the gang supervisor must tear down and "
        "relaunch the WHOLE gang from the manifest frontier"
    ),
    "gang_heartbeat_stall": (
        "resilience.gang.write_heartbeat: a rank stalling instead of dying "
        "(``hang``: a wedged device, a paging storm); the process stays "
        "alive, so only the supervisor's heartbeat staleness check can "
        "catch it"
    ),
    "gang_barrier": (
        "resilience.gangworker.StopFlag.should_stop: the gang's per-year "
        "stop and emergency-checkpoint barrier failing (a collective error "
        "at the year boundary); the rank dies and the supervisor restarts "
        "the gang"
    ),
}

#: the JAX package's sites the port does not have -> the ROADMAP.md item
#: that ports them (none left)
UNPORTED_SITES: Dict[str, str] = {}

KINDS = ("error", "oom", "kill", "truncate", "hang", "corrupt")

#: which rows the ``corrupt`` kind damages (deterministic; env-tunable
#: so drills can aim at specific rows)
CORRUPT_ROWS_ENV = "DGEN_TPU_FAULT_CORRUPT_ROWS"
CORRUPT_ROWS_DEFAULT = (3, 17)


def corrupt_rows() -> tuple:
    """Deterministic row indices the ``corrupt`` kind damages (callers
    take them modulo their own row count).  A malformed env spec raises
    — same fail-loud rule as the fault-spec grammar: a drill aimed at
    rows that silently became the defaults proves nothing."""
    raw = os.environ.get(CORRUPT_ROWS_ENV, "").strip()
    if not raw:
        return CORRUPT_ROWS_DEFAULT
    try:
        rows = tuple(int(r) for r in raw.split(",") if r.strip())
    except ValueError as e:
        raise ValueError(
            f"malformed {CORRUPT_ROWS_ENV}={raw!r}: expected a comma "
            "list of row indices"
        ) from e
    return rows or CORRUPT_ROWS_DEFAULT

#: how long a ``hang`` fault stalls its site (seconds); env-tunable so a
#: drill can pick a stall that its deadlines must route around
HANG_ENV = "DGEN_TPU_FAULT_HANG_S"
HANG_DEFAULT_S = 20.0


def hang_seconds() -> float:
    raw = os.environ.get(HANG_ENV, "").strip()
    try:
        return float(raw) if raw else HANG_DEFAULT_S
    except ValueError:
        return HANG_DEFAULT_S


class FaultError(RuntimeError):
    """An injected failure.  ``site``/``kind``/``hit`` identify which
    clause fired; the supervisor's classifier keys off them."""

    def __init__(self, site: str, kind: str, hit: int) -> None:
        super().__init__(
            f"injected fault at site '{site}' (kind={kind}, hit #{hit})"
        )
        self.site = site
        self.kind = kind
        self.hit = hit


class SimulatedOOM(FaultError):
    """An injected device OOM. The message carries the JAX package's
    ``RESOURCE_EXHAUSTED`` marker and the CUDA caching allocator's
    ``CUDA out of memory``, so :func:`dgen_tpu_torch.resilience.
    supervisor.classify_error` treats it as it treats a real OOM."""

    def __init__(self, site: str, hit: int) -> None:
        FaultError.__init__(self, site, "oom", hit)
        self.args = (
            f"RESOURCE_EXHAUSTED: CUDA out of memory: simulated device OOM "
            f"injected at site '{site}' (hit #{hit})",
        )


@dataclasses.dataclass(frozen=True)
class FaultClause:
    """One parsed spec clause: fire ``kind`` at hits
    ``nth .. nth+times-1`` of ``site``."""

    site: str
    nth: int = 1
    times: int = 1
    kind: str = "error"

    def __post_init__(self) -> None:
        if self.site in UNPORTED_SITES:
            raise NotImplementedError(
                f"fault site '{self.site}' is not ported: it comes with "
                f"ROADMAP.md {UNPORTED_SITES[self.site]}"
            )
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site '{self.site}' (known: "
                f"{', '.join(sorted(SITES))})"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind '{self.kind}' (known: "
                f"{', '.join(KINDS)})"
            )
        if self.nth < 1 or self.times < 1:
            raise ValueError("nth and times must be >= 1")

    def matches(self, hit: int) -> bool:
        return self.nth <= hit < self.nth + self.times


def parse_spec(spec: str) -> List[FaultClause]:
    """Parse the ``DGEN_TPU_FAULTS`` grammar (module docstring).
    Unknown sites and kinds raise ``ValueError`` (a misspelt site must
    fail loudly, not silently never fire); a site of the JAX package
    that the port does not have raises ``NotImplementedError``."""
    clauses: List[FaultClause] = []
    for raw in spec.split(";"):
        tok = raw.strip()
        if not tok:
            continue
        kind = "error"
        if ":" in tok:
            tok, kind = tok.rsplit(":", 1)
            kind = kind.strip()
        times = 1
        if "x" in tok:
            head, _, tail = tok.rpartition("x")
            if tail.strip().isdigit():
                tok, times = head, int(tail)
        nth = 1
        if "@" in tok:
            tok, n = tok.split("@", 1)
            nth = int(n.strip())
        clauses.append(FaultClause(tok.strip(), nth, times, kind))
    return clauses


class FaultRegistry:
    """Thread-safe hit counting + deterministic firing for a parsed
    fault spec.  ``hits`` counts every visit to a site (fired or not),
    so a spec like ``ckpt_save@2`` fires on exactly the second
    checkpoint save of the process, every run."""

    def __init__(self, clauses: List[FaultClause]) -> None:
        self.clauses = list(clauses)
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultRegistry":
        return cls(parse_spec(spec))

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    def hit(self, site: str, path: Optional[str] = None) -> int:
        """Count a visit to ``site``; raise/kill/truncate when a clause
        matches.  ``path`` is the landed artifact for truncate sites.
        Returns 1 when a ``corrupt``-kind clause fired (the CALLER owns
        the data mutation — see :func:`corrupt_point`), else 0."""
        if site not in SITES:
            raise ValueError(f"unregistered fault site '{site}'")
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            clause = next(
                (c for c in self.clauses
                 if c.site == site and c.matches(n)), None,
            )
            if clause is not None:
                self._fired[site] = self._fired.get(site, 0) + 1
        if clause is None:
            return 0
        if clause.kind == "corrupt":
            # the site's caller applies a deterministic data mutation
            # (NaN rows, garbage references) and continues NORMALLY —
            # the model of bad input data / silent data corruption that
            # only validation or the health sentinel can catch
            return 1
        if clause.kind == "hang":
            # model a stall, not a death: hold the site for the
            # configured wall, then continue NORMALLY — the caller
            # never learns it hung, exactly like a wedged device or a
            # GC/paging stall.  Timeout enforcement is the test.
            time.sleep(hang_seconds())
            return 0
        if clause.kind == "kill":
            # model a preemption/OOM-kill: no cleanup, no finally, no
            # atexit — exactly what the crash-consistent artifact layer
            # must survive
            os._exit(KILL_EXIT_CODE)
        if clause.kind == "oom":
            raise SimulatedOOM(site, n)
        if clause.kind == "truncate":
            if path is not None and os.path.isfile(path):
                size = os.path.getsize(path)
                with open(path, "rb+") as f:
                    f.truncate(max(size // 2, 1))
        raise FaultError(site, clause.kind, n)


#: the process-wide installed registry (None = fault injection off;
#: fault_point is then a single global read)
_active: Optional[FaultRegistry] = None


def install(registry: Optional[FaultRegistry]) -> Optional[FaultRegistry]:
    """Install ``registry`` process-wide; returns the previous one."""
    global _active
    prev, _active = _active, registry
    return prev


def active() -> Optional[FaultRegistry]:
    return _active


def install_from_env(env: str = "DGEN_TPU_FAULTS") -> Optional[FaultRegistry]:
    """Install a registry parsed from ``env`` (no-op when unset/empty).
    Called by the resilience CLI, the supervisor, and the fault-drill
    bench — NOT at import, so library users opt in explicitly."""
    spec = os.environ.get(env, "").strip()
    if not spec:
        return None
    reg = FaultRegistry.parse(spec)
    install(reg)
    return reg


class injected:
    """Context manager installing a registry for the duration of a
    drill/test::

        with faults.injected("ckpt_save@2") as reg:
            ...
        assert reg.fired("ckpt_save") == 1
    """

    def __init__(self, spec: str) -> None:
        self.registry = FaultRegistry.parse(spec)
        self._prev: Optional[FaultRegistry] = None

    def __enter__(self) -> FaultRegistry:
        self._prev = install(self.registry)
        return self.registry

    def __exit__(self, *exc) -> None:
        install(self._prev)


def fault_point(site: str, path: Optional[str] = None) -> None:
    """The per-site hook on the production paths: a no-op (one global
    read) unless a registry is installed."""
    reg = _active
    if reg is not None:
        reg.hit(site, path=path)


def corrupt_point(site: str) -> int:
    """The data-corruption hook: count a visit to ``site`` and return
    1 when a ``corrupt``-kind clause fires there (the caller then
    applies its deterministic mutation and continues), else 0.
    Non-corrupt kinds registered at the site still raise/kill as
    usual.  Uninstalled fast path: one global read."""
    reg = _active
    if reg is None:
        return 0
    return reg.hit(site) or 0
