"""Multi-rank runs (port of ``dgen_tpu/parallel/``): one process per
rank, each holding one state-partitioned shard of the agent table and
launching its kernels on its own card, with the market step's group
reductions combined over ``torch.distributed``.

* :mod:`~dgen_tpu_torch.parallel.partition`: the state-balanced agent
  partition (host numpy, equal to the JAX package's bit for bit).
* :mod:`~dgen_tpu_torch.parallel.mesh`: the rank topology, its device and
  backend, and its collectives.
* :mod:`~dgen_tpu_torch.parallel.launch`: state binning, per-bin launch
  lines, process-group bring-up from ``DGEN_COORDINATOR`` /
  ``DGEN_NUM_PROCESSES`` / ``DGEN_PROCESS_ID``, and the rank entry point
  (``python -m dgen_tpu_torch.parallel.launch``).
* :mod:`~dgen_tpu_torch.parallel.elastic`: resuming a checkpoint written
  by P ranks with P' ranks.

Nothing here imports jax or dgen_tpu; ``import dgen_tpu_torch.parallel``
loads no submodule.
"""
