"""GangSupervisor: a restartable gang of rank processes (port of
``dgen_tpu/resilience/gang.py``).

The multi-rank analogue of the serving fleet's
:class:`~dgen_tpu_torch.serve.fleet.ReplicaSupervisor`, with one decisive
difference: serving replicas are independent, a simulation gang is
**all-or-nothing**. P ranks share one ``torch.distributed`` process
group; one lost rank leaves every peer waiting at its next collective
(gloo's or NCCL's timeout would end them only after minutes). A process
group is not elastic while it runs, so recovery is always:

1. **detect**: each rank's liveness (exit codes) and heartbeat file (a
   rank that is alive but has stopped completing years is stalled: a
   wedged card, a paging storm; only staleness catches it);
2. **tear down**: SIGKILL the whole gang (peers blocked in a dead
   collective cannot drain; the crash-consistent artifact layer makes
   that safe); on a card, wait until the card's free memory is back;
3. **relaunch from the manifest frontier**: the merge of the ranks'
   shard ledgers (:class:`~dgen_tpu_torch.resilience.manifest.
   GangManifest`) names the last year every rank durably exported; the
   relaunched ranks resume from the newest checkpoint at or below it
   (:func:`dgen_tpu_torch.parallel.elastic.resume_year_for`) on a fresh
   rendezvous port, exporting the missing years again;
4. **bounded**: restarts follow the resilience layer's
   :class:`~dgen_tpu_torch.resilience.supervisor.RetryPolicy` backoff
   with a crash-loop breaker; when the breaker trips and
   :attr:`~dgen_tpu_torch.config.GangConfig.shrink_plan` names a smaller
   gang, the run resumes at P' ranks: each rank's checkpoint part carries
   its rows' agent ids, so the P' ranks restore the year by id
   (:mod:`dgen_tpu_torch.parallel.elastic`) instead of the run dying
   with the lost rank.

SIGTERM to the supervisor (a preemption notice) is forwarded to every
rank, whose per-year stop barrier (:class:`~dgen_tpu_torch.resilience.
gangworker.StopFlag`) makes all P ranks agree on the save year: every
rank exports and checkpoints through the same year, then exits cleanly.

This module is process and file work only: it imports no
``torch.distributed`` and touches no card (the card's free memory is
read by ``nvidia-smi``, or by a probe process where that is missing), so
it stays responsive while ranks build or wedge. Ranks are spawned as
local child processes, the one-host shape (CPU gloo drills, ranks
sharing a card, one host of cards); a gang over several hosts plugs a
remote launcher into ``cmd_for`` and keeps the same manifest-frontier
and resharded-resume recovery.

Rank env contract (read by :mod:`dgen_tpu_torch.resilience.gangworker`
through :func:`dgen_tpu_torch.parallel.launch.initialize_multihost`)::

    DGEN_COORDINATOR       host:port of rank 0's rendezvous
    DGEN_NUM_PROCESSES     P
    DGEN_PROCESS_ID        0..P-1
    DGEN_PLATFORM          the rank's device ("cuda" or "cpu")
    DGEN_CPU_DEVICES       ranks per host (the mesh's second axis)
    LOCAL_RANK             the rank's index among this host's ranks (its card)
    LOCAL_WORLD_SIZE       the ranks on this host (all of the gang's)
    DGEN_GANG_DIR          heartbeat / done-file / log directory
    DGEN_RUN_DIR           export and shard-ledger directory
    DGEN_GANG_FRONTIER     manifest frontier year ("" = from scratch)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from dgen_tpu_torch.config import GangConfig
from dgen_tpu_torch.resilience import faults as faults_mod
from dgen_tpu_torch.resilience.manifest import GangManifest
from dgen_tpu_torch.resilience.supervisor import RetryPolicy
from dgen_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

#: gang-level outcomes of an attempt
COMPLETE = "complete"     # every rank exited 0, all years run
PREEMPTED = "preempted"   # a clean synchronized stop before the last year
DIED = "died"             # a rank's death or stall tore the gang down

#: the checkout this package lives in (put on the ranks' PYTHONPATH)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# -- heartbeats / done files (shared with gangworker) ------------------------

def heartbeat_path(gang_dir: str, index: int) -> str:
    return os.path.join(gang_dir, f"worker-{index}.hb.json")


def done_path(gang_dir: str, index: int) -> str:
    return os.path.join(gang_dir, f"worker-{index}.done.json")


def write_heartbeat(path: str, **info) -> None:
    """One atomic heartbeat write (ranks call this after each completed
    year). The supervisor reads freshness off the file's mtime, so the
    content is diagnostics, not protocol."""
    # fault site: a ``hang`` here models a rank that stalls without
    # dying; only the supervisor's staleness check can catch it
    faults_mod.fault_point("gang_heartbeat_stall")
    atomic_write_json(path, {"t": time.time(), **info})


def read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port for the gang's rendezvous. Each attempt draws a
    fresh one: a killed gang's TCP store can still hold its port."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def default_worker_cmd(extra_args: Sequence[str] = ()) -> Callable:
    """The standard rank command (all configuration rides the env)."""

    def cmd_for(index: int, n_processes: int) -> List[str]:
        return [sys.executable, "-m", "dgen_tpu_torch.resilience.gangworker",
                *extra_args]

    return cmd_for


#: a probe process that reads the card's free memory the way a rank
#: would see it (used where ``nvidia-smi`` is missing)
_FREE_PROBE = ("import json, torch\n"
               "print(json.dumps([list(torch.cuda.mem_get_info(i)) "
               "for i in range(torch.cuda.device_count())]))\n")


def card_free_bytes() -> Optional[List[int]]:
    """Free bytes of each of the host's cards, every process's use
    counted (``nvidia-smi``, else a ``torch.cuda.mem_get_info`` probe
    process); None when no card can be read."""
    if shutil.which("nvidia-smi"):
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.free", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
            vals = [int(v) * 2**20 for v in out.stdout.split()]
            if out.returncode == 0 and vals:
                return vals
        except (OSError, subprocess.SubprocessError, ValueError):
            pass
    try:
        out = subprocess.run([sys.executable, "-c", _FREE_PROBE], capture_output=True,
                             text=True, timeout=120)
        return [int(f) for f, _ in json.loads(out.stdout.strip().splitlines()[-1])]
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# -- report ------------------------------------------------------------------

@dataclasses.dataclass
class GangAttempt:
    attempt: int
    processes: int
    frontier: Optional[int]
    outcome: str                   # COMPLETE / PREEMPTED / DIED
    reason: Optional[str] = None   # death or stall detail
    worker: Optional[int] = None
    exit_code: Optional[int] = None
    wall_s: float = 0.0
    #: a death's detection wall: an upper bound on the seconds from the
    #: rank's exit to the supervisor seeing it (the gap since the last
    #: poll that saw it alive); a stall's is its staleness bound
    detect_s: Optional[float] = None
    #: seconds to SIGKILL and reap the whole gang after the detection
    teardown_s: Optional[float] = None
    #: seconds from the spawn to every rank's first year heartbeat
    first_year_s: Optional[float] = None


@dataclasses.dataclass
class GangReport:
    """What a supervised gang run cost (stamped into the coordinator
    ledger's notes and the drills' records)."""

    processes_initial: int = 0
    processes_final: int = 0
    attempts: List[GangAttempt] = dataclasses.field(default_factory=list)
    restarts: int = 0
    shrinks: List[str] = dataclasses.field(default_factory=list)
    #: wall seconds from the first gang death to the final clean exit
    recovery_wall_s: float = 0.0
    #: wall seconds from the first gang death to the relaunched gang's
    #: first completed year on every rank
    relaunch_wall_s: Optional[float] = None
    succeeded: bool = False
    preempted: bool = False
    #: last completed model year (from the ranks' done files)
    completed_through: Optional[int] = None
    #: on a card: its free bytes before the first spawn and, per
    #: relaunch, after the teardown (once back) and the seconds waited
    card_free_before: Optional[List[int]] = None
    card_free_relaunch: List[dict] = dataclasses.field(default_factory=list)
    #: each rank's done file of the final attempt (its peak memory, its
    #: budget, its years)
    done: List[dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["recovery_wall_s"] = round(self.recovery_wall_s, 4)
        for a in d["attempts"]:
            a["wall_s"] = round(a["wall_s"], 4)
        return d


class GangCrashLoop(RuntimeError):
    """The gang died more than ``max_restarts`` times inside the breaker
    window at every rank count the shrink plan allows."""

    def __init__(self, msg: str, report: GangReport) -> None:
        super().__init__(msg)
        self.gang_report = report


# -- the supervisor ----------------------------------------------------------

class GangSupervisor:
    """Launch, watch and restart a P-rank simulation gang (the module
    docstring has the recovery contract).

    Parameters
    ----------
    run_dir : export directory (the ranks' shard ledgers and parts land
        here; the resume frontier is derived from it).
    years : the scenario's model-year grid (the frontier and the post-run
        checkpoint records need it).
    cmd_for : ``(index, n_processes) -> argv``; default
        :func:`default_worker_cmd`. Tests substitute stubs.
    config / policy : :class:`~dgen_tpu_torch.config.GangConfig` and the
        restart backoff schedule.
    env_for : optional ``(index, attempt) -> dict`` of extra rank env
        (drills arm per-rank fault specs on attempt 0 only).
        ``DGEN_TPU_FAULTS`` is stripped from the inherited environment
        either way.
    worker_env : env shared by every rank every attempt (population
        size, end year, ...).
    On a card, a relaunch waits until every card's free memory is back
    within ``CARD_FREE_SLACK_BYTES`` of what it was before the first spawn,
    for at most ``CARD_WAIT_S``.
    """

    #: a rank is stalled when its heartbeat is older than
    #: max(stall_timeout_s, this factor x the slowest year-over-year gap
    #: seen across the gang), so a gang whose years are simply long is not
    #: killed as stalled; before any gap is measured the bound is
    #: boot_timeout_s
    STALL_GRACE_FACTOR = 3.0
    #: how far below its first-spawn free memory a card may stay when a
    #: relaunch goes ahead, and how long a relaunch waits for it
    CARD_FREE_SLACK_BYTES = 2 << 30
    CARD_WAIT_S = 120.0

    def __init__(
        self,
        run_dir: str,
        years: Sequence[int],
        cmd_for: Optional[Callable[[int, int], List[str]]] = None,
        config: Optional[GangConfig] = None,
        policy: Optional[RetryPolicy] = None,
        env_for: Optional[Callable[[int, int], Optional[dict]]] = None,
        worker_env: Optional[Dict[str, str]] = None,
        gang_dir: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        seed: int = 0,
    ) -> None:
        self.run_dir = run_dir
        self.years = [int(y) for y in years]
        self.config = config or GangConfig()
        self.policy = policy or RetryPolicy()
        self._cmd_for = cmd_for or default_worker_cmd()
        self._env_for = env_for
        self.worker_env = dict(worker_env or {})
        self.gang_dir = gang_dir or tempfile.mkdtemp(prefix="dgen-gang-")
        os.makedirs(self.gang_dir, exist_ok=True)
        self.checkpoint_dir = checkpoint_dir or os.path.join(run_dir, "checkpoints")
        self._rng = random.Random(seed)
        self._procs: List[subprocess.Popen] = []
        self._stop_requested = False

    @property
    def on_card(self) -> bool:
        return self.config.platform == "cuda"

    # -- SIGTERM drain --------------------------------------------------

    def request_stop(self) -> None:
        """Forward a preemption notice: SIGTERM every rank (their per-year
        stop barrier synchronizes the emergency checkpoint) and stop
        restarting. Safe from a signal handler."""
        self._stop_requested = True
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass

    def install_sigterm_drain(self) -> None:
        """Route the supervisor process's own SIGTERM to
        :meth:`request_stop` (the CLI arms this)."""
        signal.signal(signal.SIGTERM, lambda *_: self.request_stop())

    # -- spawning -------------------------------------------------------

    def _spawn_gang(self, n_processes: int, attempt: int, frontier: Optional[int]) -> None:
        port = free_port(self.config.coordinator_host)
        per_host = self.config.devices_for(n_processes)
        self._procs = []
        for i in range(n_processes):
            # the last incarnation's liveness files must not satisfy this
            # attempt's checks
            for path in (heartbeat_path(self.gang_dir, i), done_path(self.gang_dir, i)):
                if os.path.exists(path):
                    os.unlink(path)
            env = os.environ.copy()
            # a spec meant for the supervisor must not leak into every
            # rank; drills arm per-rank specs through env_for
            env.pop("DGEN_TPU_FAULTS", None)
            env.update({
                "DGEN_COORDINATOR": f"{self.config.coordinator_host}:{port}",
                "DGEN_NUM_PROCESSES": str(n_processes),
                "DGEN_PROCESS_ID": str(i),
                # every rank is a child on this host: they share its cards
                # whatever the grid (parallel.mesh.init_ranks)
                "LOCAL_RANK": str(i),
                "LOCAL_WORLD_SIZE": str(n_processes),
                "DGEN_GANG_DIR": self.gang_dir,
                "DGEN_RUN_DIR": self.run_dir,
                "DGEN_GANG_FRONTIER": "" if frontier is None else str(frontier),
                "PYTHONUNBUFFERED": "1",
                "PYTHONPATH": os.pathsep.join(
                    p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p),
            })
            if self.config.platform:
                env["DGEN_PLATFORM"] = self.config.platform
                env["DGEN_CPU_DEVICES"] = str(per_host)
            env.update(self.worker_env)
            extra = self._env_for(i, attempt) if self._env_for else None
            if extra:
                env.update({k: str(v) for k, v in extra.items()})
            log_path = os.path.join(self.gang_dir, f"worker-{i}.log")
            # append-only diagnostics, not a run artifact: a torn tail is
            # what a SIGKILLed rank's log should show
            logf = open(log_path, "ab")
            try:
                self._procs.append(subprocess.Popen(
                    self._cmd_for(i, n_processes), stdout=logf,
                    stderr=subprocess.STDOUT, env=env))
            finally:
                logf.close()   # the child holds its own descriptor
        logger.info("gang attempt %d: %d ranks (%d a host), rendezvous :%d, "
                    "frontier=%s", attempt, n_processes, per_host, port, frontier)

    def _teardown(self) -> None:
        """SIGKILL every live rank and reap it. Peers of a dead rank wait
        in a dead collective: there is nothing to drain."""
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in self._procs:
            try:
                p.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                logger.warning("gang: rank pid %d unkillable", p.pid)

    def _await_card(self, baseline: Optional[List[int]]) -> Optional[dict]:
        """On a card, wait until every card's free memory is back within
        the slack of ``baseline`` (a killed CUDA process returns its
        memory late), at most ``CARD_WAIT_S``; returns what was seen."""
        if not self.on_card or baseline is None:
            return None
        t0 = time.monotonic()
        free = card_free_bytes()
        while (free is not None and len(free) == len(baseline)
               and any(f < b - self.CARD_FREE_SLACK_BYTES for f, b in zip(free, baseline))
               and time.monotonic() - t0 < self.CARD_WAIT_S):
            time.sleep(0.5)
            free = card_free_bytes()
        rec = {"free": free, "waited_s": round(time.monotonic() - t0, 3)}
        logger.info("gang: card free memory before the relaunch %s (baseline %s), "
                    "waited %.3f s", free, baseline, rec["waited_s"])
        return rec

    # -- monitoring -----------------------------------------------------

    def _resume_plan(self) -> Optional[int]:
        """One manifest pass a (re)launch: the merged resume frontier
        (deep: a torn frontier artifact must pull the resume back), then
        every part and ledger record beyond it pruned, so that a dead
        epoch's partial parts do not survive into the relaunch. None: a
        fresh directory, start from scratch."""
        try:
            gm = GangManifest(self.run_dir)
        except OSError:
            return None
        if not gm.shards:
            return None
        frontier = gm.frontier(self.years)
        removed = gm.prune_after(frontier)
        if removed:
            logger.info("gang: pruned %d stale artifact(s) beyond frontier %s",
                        len(removed), frontier)
        return frontier

    def _died(self, rec: GangAttempt, t0: float, reason: str, worker: Optional[int],
              exit_code: Optional[int] = None, detect_s: Optional[float] = None
              ) -> GangAttempt:
        t_detect = time.monotonic()
        rec.outcome, rec.reason, rec.worker = DIED, reason, worker
        rec.exit_code, rec.detect_s = exit_code, detect_s
        self._teardown()
        rec.teardown_s = round(time.monotonic() - t_detect, 4)
        rec.wall_s = time.monotonic() - t0
        return rec

    def _monitor(self, n_processes: int, attempt: int,
                 frontier: Optional[int]) -> GangAttempt:
        """Watch one gang incarnation to its outcome."""
        t0 = time.monotonic()
        # rank -> {mtime, has_year, gap}: heartbeat files are parsed only
        # when their mtime changes (staleness itself is a stat)
        hb_state: Dict[int, dict] = {}
        # False even when a stop is pending: this incarnation's ranks
        # still need the SIGTERM forwarded (request_stop is idempotent)
        sigterm_sent = False
        drain_deadline: Optional[float] = None
        last_alive = t0
        rec = GangAttempt(attempt=attempt, processes=n_processes, frontier=frontier,
                          outcome=DIED)
        while True:
            now = time.monotonic()
            if self._stop_requested and not sigterm_sent:
                self.request_stop()
                sigterm_sent = True
            if sigterm_sent and drain_deadline is None:
                drain_deadline = now + self.config.drain_timeout_s

            rcs = [p.poll() for p in self._procs]
            bad = [(i, rc) for i, rc in enumerate(rcs) if rc is not None and rc != 0]
            if bad:
                i, rc = bad[0]
                return self._died(rec, t0, "worker_exit", i, rc,
                                  detect_s=round(time.monotonic() - last_alive, 4))
            if all(rc == 0 for rc in rcs):
                dones = [read_json(done_path(self.gang_dir, i)) for i in range(n_processes)]
                preempted = any(d is not None and d.get("preempted") for d in dones)
                rec.outcome = PREEMPTED if preempted else COMPLETE
                rec.wall_s = time.monotonic() - t0
                rec.exit_code = 0
                if rec.first_year_s is None:
                    # every year came and went between two polls
                    rec.first_year_s = round(rec.wall_s, 4)
                return rec
            last_alive = now

            # liveness by heartbeat: boot grace until the first year
            # heartbeat, then a staleness bound scaled to the gang's own
            # year cadence, stall_timeout_s its floor
            measured = max((s["gap"] for s in hb_state.values() if s.get("gap") is not None),
                           default=None)
            stall_bound = (max(self.config.stall_timeout_s,
                               self.STALL_GRACE_FACTOR * measured)
                           if measured is not None else
                           max(self.config.stall_timeout_s, self.config.boot_timeout_s))
            for i, rc in enumerate(rcs):
                if rc is not None:
                    continue
                hb = heartbeat_path(self.gang_dir, i)
                try:
                    st = os.stat(hb)
                except OSError:
                    st = None
                state = hb_state.setdefault(i, {"mtime": None, "has_year": False,
                                                "gap": None})
                if st is not None and st.st_mtime != state["mtime"]:
                    doc = read_json(hb)
                    has_year = bool(doc and doc.get("year") is not None)
                    if has_year and state["has_year"] and state["mtime"] is not None:
                        gap = st.st_mtime - state["mtime"]
                        state["gap"] = max(state["gap"] or 0.0, gap)
                    state["mtime"] = st.st_mtime
                    state["has_year"] = state["has_year"] or has_year
                if state["has_year"]:
                    if time.time() - state["mtime"] > stall_bound:
                        return self._died(rec, t0, "heartbeat_stall", i,
                                          detect_s=round(stall_bound, 4))
                elif now - t0 > self.config.boot_timeout_s:
                    return self._died(rec, t0, "boot_timeout", i)
            if rec.first_year_s is None and len(hb_state) == n_processes and all(
                    s["has_year"] for s in hb_state.values()):
                rec.first_year_s = round(time.monotonic() - t0, 4)

            if drain_deadline is not None and now > drain_deadline:
                # the ranks did not finish the synchronized stop in time
                return self._died(rec, t0, "drain_timeout", None)
            time.sleep(self.config.poll_interval_s)

    # -- the run loop ---------------------------------------------------

    def run(self) -> GangReport:
        """Drive the gang to completion (or a clean preemption stop),
        restarting from the manifest frontier on every death and shrinking
        per the plan when the crash-loop breaker trips. Raises
        :class:`GangCrashLoop` (report attached) when the budget is spent.
        No exit path leaks ranks: any exception (an interrupt in a backoff
        sleep, a partial spawn, the crash-loop raise) tears the live gang
        down on the way out."""
        try:
            return self._run_loop()
        finally:
            self._teardown()

    def _run_loop(self) -> GangReport:
        cfg = self.config
        report = GangReport(processes_initial=cfg.n_processes,
                            processes_final=cfg.n_processes)
        plan = [cfg.n_processes, *cfg.shrink_plan]
        plan_idx = 0
        deaths: deque = deque(maxlen=256)
        attempt = 0
        t_first_death: Optional[float] = None
        if self.on_card:
            report.card_free_before = card_free_bytes()
        while True:
            n_proc = plan[plan_idx]
            report.processes_final = n_proc
            frontier = self._resume_plan()
            t_spawn = time.monotonic()
            self._spawn_gang(n_proc, attempt, frontier)
            rec = self._monitor(n_proc, attempt, frontier)
            report.attempts.append(rec)
            if (t_first_death is not None and report.relaunch_wall_s is None
                    and rec.first_year_s is not None):
                report.relaunch_wall_s = round(t_spawn + rec.first_year_s - t_first_death, 4)
            if rec.outcome in (COMPLETE, PREEMPTED):
                report.succeeded = True
                report.preempted = rec.outcome == PREEMPTED
                if t_first_death is not None:
                    report.recovery_wall_s = time.monotonic() - t_first_death
                dones = [read_json(done_path(self.gang_dir, i)) for i in range(n_proc)]
                report.done = [d for d in dones if d is not None]
                through = [d.get("completed_through") for d in report.done
                           if d.get("completed_through") is not None]
                report.completed_through = min(through) if through else None
                self._finalize(report)
                return report
            # a death or a stall: the breaker's bookkeeping, then backoff
            # and relaunch
            now = time.monotonic()
            if t_first_death is None:
                t_first_death = now - (rec.teardown_s or 0.0)
            deaths.append(now)
            logger.warning("gang death (attempt %d, %s rank=%s rc=%s); frontier was %s",
                           attempt, rec.reason, rec.worker, rec.exit_code, frontier)
            if self._stop_requested:
                raise GangCrashLoop("gang did not drain cleanly after stop request",
                                    report)
            window = [t for t in deaths if now - t <= cfg.restart_window_s]
            if len(window) > cfg.max_restarts:
                if plan_idx + 1 < len(plan):
                    plan_idx += 1
                    # a fresh slate at P': the shrunk gang relaunches at the
                    # first retry's backoff, not the pre-shrink window's
                    deaths.clear()
                    window = []
                    msg = (f"crash-loop breaker at P={n_proc}: shrinking to "
                           f"P'={plan[plan_idx]} (resharded resume from the "
                           "manifest frontier)")
                    report.shrinks.append(msg)
                    logger.warning("gang: %s", msg)
                else:
                    raise GangCrashLoop(
                        f"gang crash loop: >{cfg.max_restarts} deaths in "
                        f"{cfg.restart_window_s:.0f}s at every process count in {plan}",
                        report)
            backoff = self.policy.backoff_s(min(max(len(window) - 1, 0), 6), self._rng)
            report.restarts += 1
            seen = self._await_card(report.card_free_before)
            if seen is not None:
                report.card_free_relaunch.append(seen)
            time.sleep(backoff)
            attempt += 1

    def _finalize(self, report: GangReport) -> None:
        """After the run, coordinator side: the checkpoint hashes and the
        supervision summary into ``manifest-gang.json``."""
        try:
            gm = GangManifest(self.run_dir)
        except OSError:
            return
        if os.path.isdir(self.checkpoint_dir):
            gm.record_checkpoints(self.checkpoint_dir, self.years)
        gm.note(f"gang supervisor: restarts={report.restarts} "
                f"P={report.processes_initial}->{report.processes_final} "
                f"preempted={report.preempted} "
                f"recovery_wall_s={report.recovery_wall_s:.3f}")
