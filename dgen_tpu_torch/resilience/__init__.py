"""Bad-data quarantine, the run supervisor, the rank gang and the
drills (port of ``dgen_tpu/resilience/``).

* :mod:`~dgen_tpu_torch.resilience.faults`: deterministic fault injection
  at named sites of the run path (``DGEN_TPU_FAULTS`` spec grammar).
* :mod:`~dgen_tpu_torch.resilience.quarantine`: load-time validation of
  the agent table and the banks, and containment of bad rows as inert
  padding, on the device where the data lies.
* :mod:`~dgen_tpu_torch.resilience.manifest`: the content-hashed
  per-year artifact ledger of a run directory, and the merged view over
  a multi-rank run's shard ledgers (``GangManifest``); ``verify`` audits
  them.
* :mod:`~dgen_tpu_torch.resilience.supervisor`: bounded retry, checkpoint
  resume and degradation (halve the chunk, serialize host I/O) around
  ``Simulation.run``.
* :mod:`~dgen_tpu_torch.resilience.gang` and
  :mod:`~dgen_tpu_torch.resilience.gangworker`: the rank gang's
  supervisor (heartbeats, teardown, relaunch from the manifest frontier,
  the crash-loop breaker and its shrink plan) and one rank of it.
* :mod:`~dgen_tpu_torch.resilience.drill`,
  :mod:`~dgen_tpu_torch.resilience.quarantinedrill`,
  :mod:`~dgen_tpu_torch.resilience.fleetdrill` and
  :mod:`~dgen_tpu_torch.resilience.gangdrill`: the fault drill, the
  quarantine drill, the serving fleet's drills and the gang drill.

CLI: ``python -m dgen_tpu_torch.resilience {run,verify,drill}``. The
atomic writes live in :mod:`dgen_tpu_torch.utils.atomic`.
"""
