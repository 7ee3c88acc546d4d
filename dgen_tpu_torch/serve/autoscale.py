"""Occupancy-driven fleet autoscaling (port of
``dgen_tpu/serve/autoscale.py``).

A small control loop between the
:class:`~dgen_tpu_torch.serve.fleet.ReplicaSupervisor` (spawn, warm,
gate, restart, drain) and the front's aggregated ``/metricz`` signal: it
grows the fleet under sustained pressure and drains it back when idle.

* **signal**: :meth:`FleetFront.pressure`, the summed queue depth over the
  summed capacity and the batch-weighted occupancy of fresh READY-replica
  scrapes; no fresh signal, no action.
* **hysteresis**: pressure must last ``scale_up_sustain_s`` before a
  scale-up, idleness ``scale_down_sustain_s`` before a scale-down, and the
  down thresholds sit strictly below the up ones (``FleetConfig``
  enforces it).
* **cooldown**: after any action the controller holds for
  ``scale_cooldown_s``.
* **bounds**: the fleet stays within ``[min_replicas, max_replicas]``.
* **verbs**: ``supervisor.add_replica()`` to grow;
  ``supervisor.retire_replica(i)`` on the highest-index READY replica to
  shrink (it drains on SIGTERM, and its exit is not a death).

Every decision lands in the supervisor's event ledger and in
:attr:`Autoscaler.events`. ``signal_fn`` and ``clock`` are injectable:
tests drive the hysteresis with scripted signals and a fake clock, and
the ``--serve-scale`` drill feeds a synthetic signal to a real fleet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from dgen_tpu_torch.config import FleetConfig
from dgen_tpu_torch.serve.fleet import READY, ReplicaSupervisor

logger = logging.getLogger(__name__)


class Autoscaler:
    """The control loop (module docstring). ``signal_fn``: ``() ->
    Optional[dict]`` with ``queue_frac`` and ``occupancy`` (None: no fresh
    signal, hold)."""

    def __init__(self, supervisor: ReplicaSupervisor,
                 signal_fn: Callable[[], Optional[dict]],
                 config: Optional[FleetConfig] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.sup = supervisor
        self.signal_fn = signal_fn
        self.config = config or supervisor.config
        self._clock = clock
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the ledger and counters: tick() writes on the control thread, a
        # drill or an operator reads on another
        self._lock = threading.Lock()
        self.events: List[dict] = []
        self.n_scale_up = 0
        self.n_scale_down = 0

    # -- the decision (pure given the signal and the clock) --------------

    def _record(self, action: str, **detail) -> None:
        with self._lock:
            self.events.append({"t": round(time.time(), 3), "action": action, **detail})
            if action == "up":
                self.n_scale_up += 1
            else:
                self.n_scale_down += 1
        self.sup._event(-1, f"autoscale_{action}", **detail)

    def _in_cooldown(self, now: float) -> bool:
        return (self._last_action_at is not None
                and now - self._last_action_at < self.config.scale_cooldown_s)

    def tick(self) -> Optional[str]:
        """One decision: "up" or "down" when an action was taken, else None."""
        cfg = self.config
        now = self._clock()
        sig = self.signal_fn()
        if sig is None:
            # a gap in the telemetry proves nothing: both windows restart
            self._pressure_since = self._idle_since = None
            return None
        hot = (sig["queue_frac"] >= cfg.scale_up_queue_frac
               or sig["occupancy"] >= cfg.scale_up_occupancy)
        idle = (sig["queue_frac"] <= cfg.scale_down_queue_frac
                and sig["occupancy"] <= cfg.scale_down_occupancy)
        n = self.sup.live_count()
        shown = dict(queue_frac=round(sig["queue_frac"], 4),
                     occupancy=round(sig["occupancy"], 4))
        if hot:
            self._idle_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            if (now - self._pressure_since >= cfg.scale_up_sustain_s
                    and not self._in_cooldown(now) and n < cfg.max_replicas):
                self.sup.add_replica()
                self._last_action_at = now
                self._pressure_since = None
                self._record("up", n_replicas=n + 1, **shown)
                return "up"
        elif idle:
            self._pressure_since = None
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= cfg.scale_down_sustain_s
                    and not self._in_cooldown(now) and n > cfg.min_replicas):
                victim = self._pick_victim()
                if victim is not None and self.sup.retire_replica(
                        victim, drain_timeout_s=cfg.drain_timeout_s):
                    self._last_action_at = now
                    self._idle_since = None
                    self._record("down", retired=victim, n_replicas=n - 1, **shown)
                    return "down"
        else:
            # between the bands: neither window accumulates
            self._pressure_since = self._idle_since = None
        return None

    def _pick_victim(self) -> Optional[int]:
        """The highest-index READY replica (the last scaled up goes first;
        lower indices keep their identities)."""
        ready = [h.index for h in self.sup.replicas if h.state == READY]
        return max(ready) if ready else None

    # -- the loop --------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, name="dgen-fleet-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the controller outlives a bad tick
                logger.exception("autoscaler: tick failed")
            self._stop.wait(self.config.scale_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
