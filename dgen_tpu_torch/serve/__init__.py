"""dgen_tpu_torch.serve: the online what-if query engine on one card (port
of ``dgen_tpu/serve``).

A long-lived process holds a placed Simulation (agent table, profile and
tariff banks) and answers per-agent queries (optimal PV+storage size,
bill savings, NPV and payback, scenario-override deltas) through the
year step's sizing path at fixed power-of-two row counts::

    from dgen_tpu_torch.config import ServeConfig
    from dgen_tpu_torch.serve import ServeEngine, Microbatcher
    engine = ServeEngine(sim)                # a built Simulation
    engine.warmup(ServeConfig().buckets)
    bat = Microbatcher(engine)               # pow2 buckets, deadline flush
    bat.query([17, 203], year=2026, overrides={"scale": {"itc_fraction": 0.0}})

HTTP: ``python -m dgen_tpu_torch.serve`` (:mod:`.server`). The
zero-override question can be answered from a precomputed, provenance
gated, memory-mapped :class:`~.surface.AnswerSurface`
(``--build-surface`` / ``--surface``), and repeated what-ifs from the
exact :class:`~.resultcache.ResultCache` (``--cache-dir``). The fleet
(``--fleet N``): a :class:`~.fleet.ReplicaSupervisor` keeps N replica
processes alive on the card, a :class:`~.front.FleetFront` routes over
them with per-replica :class:`~.front.CircuitBreaker` s, shedding and a
bounded drain, and an :class:`~.autoscale.Autoscaler` sizes the fleet.
"""

from dgen_tpu_torch.serve.autoscale import Autoscaler  # noqa: F401
from dgen_tpu_torch.serve.batcher import Microbatcher, QueueFullError  # noqa: F401
from dgen_tpu_torch.serve.engine import (  # noqa: F401
    QUERY_FIELDS,
    OverrideError,
    QueryOutputs,
    ServeEngine,
    apply_overrides,
    override_key,
    query_program,
)
from dgen_tpu_torch.serve.fleet import (  # noqa: F401
    HTTPPool,
    ReplicaSupervisor,
    default_replica_cmd,
)
from dgen_tpu_torch.serve.front import CircuitBreaker, FleetFront  # noqa: F401
from dgen_tpu_torch.serve.resultcache import ResultCache  # noqa: F401
from dgen_tpu_torch.serve.surface import (  # noqa: F401
    AnswerSurface,
    StaleSurfaceError,
    SurfaceError,
    build_surface,
)
