"""Monte-Carlo ensembles and dynamic agent populations over one placed
table (port of ``dgen_tpu/ensemble``): E seed-deterministic members
against one table and one copy of the profile banks on the card, or on
each rank's shard of them (``EnsembleSimulation(ranks=)``).

* :mod:`~dgen_tpu_torch.ensemble.draws`: per-member stochastic axes
  (Bass p/q, retail and wholesale price paths, technology costs), pure
  functions of (base inputs, member key), the port's own keyed numpy
  generators;
* :mod:`~dgen_tpu_torch.ensemble.cohorts`: cohort entry on the alive
  mask;
* :mod:`~dgen_tpu_torch.ensemble.stats`: per-member reductions and
  per-year quantiles on the card;
* :mod:`~dgen_tpu_torch.ensemble.driver`: :class:`EnsembleSimulation`,
  on the sweep engine's vmap/loop modes and planner.
"""

from dgen_tpu_torch.ensemble.cohorts import (  # noqa: F401
    COHORT_NEVER,
    CohortSchedule,
    cohort_alive_mask,
)
from dgen_tpu_torch.ensemble.draws import (  # noqa: F401
    DEFAULT_DRAWS,
    DrawSpec,
    draw_members,
    member_key,
)
from dgen_tpu_torch.ensemble.driver import (  # noqa: F401
    EnsembleSimulation,
    ensemble_year_step,
)
from dgen_tpu_torch.ensemble.stats import EnsembleStats  # noqa: F401
