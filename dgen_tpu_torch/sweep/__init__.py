"""The multi-scenario sweep engine (port of ``dgen_tpu/sweep``): S policy
scenarios in one process against one copy of the agent table and the
profile banks on the card (or, on several ranks, each rank's shard of
them); only the small ``[Y, ...]`` trajectory tensors carry a scenario
axis. :mod:`~dgen_tpu_torch.sweep.driver` has
the execution modes, :mod:`~dgen_tpu_torch.sweep.plan` the grouping and
the memory budget, and ``python -m dgen_tpu_torch.sweep --help`` the
CLI.
"""

from dgen_tpu_torch.sweep.driver import (  # noqa: F401
    SweepSimulation,
    bank_nbytes,
    sweep_year_step,
)
from dgen_tpu_torch.sweep.plan import (  # noqa: F401
    DEFAULT_MAX_VMAP_SCENARIOS,
    MODE_LOOP,
    MODE_VMAP,
    ScenarioGroup,
    SweepBudgetError,
    SweepPlan,
    plan_sweep,
)
from dgen_tpu_torch.sweep.results import SweepResults  # noqa: F401
