"""Bad-data quarantine and the single-card run supervisor (port of the
single-process part of ``dgen_tpu/resilience/``).

* :mod:`~dgen_tpu_torch.resilience.faults`: deterministic fault injection
  at named sites of the run path (``DGEN_TPU_FAULTS`` spec grammar).
* :mod:`~dgen_tpu_torch.resilience.quarantine`: load-time validation of
  the agent table and the banks, and containment of bad rows as inert
  padding, on the device where the data lies.
* :mod:`~dgen_tpu_torch.resilience.manifest`: the content-hashed
  per-year artifact ledger of a run directory; ``verify`` audits it.
* :mod:`~dgen_tpu_torch.resilience.supervisor`: bounded retry, checkpoint
  resume and degradation (halve the chunk, serialize host I/O) around
  ``Simulation.run``.
* :mod:`~dgen_tpu_torch.resilience.drill` and
  :mod:`~dgen_tpu_torch.resilience.quarantinedrill`: the fault drill and
  the quarantine drill.

CLI: ``python -m dgen_tpu_torch.resilience {run,verify,drill}``. The
multi-process gang, its manifests and drills, and the serving-fleet drill
are not ported (``ROADMAP.md`` items 7 and 11). The atomic writes live in
:mod:`dgen_tpu_torch.utils.atomic`.
"""
