"""Per-member stochastic axes of a Monte-Carlo ensemble (port of
``dgen_tpu/ensemble/draws.py``).

Member m is a pure function of ``(base ScenarioInputs, member key)``:
no sequential generator state, so member 7 draws the same trajectories
whether it runs first, last, beside 63 siblings or alone after a
restart. Within a member each axis has its own stream, so adding an
axis never reshuffles the draws of the others.

**The bits are the port's own.** The JAX package draws with
``jax.random`` (``fold_in(PRNGKey(seed), m)``, threefry), which the port
cannot reproduce without JAX. Here :func:`member_key` is the pair
``(seed, member)`` and each (seed, member, axis) seeds its own
``numpy.random.Generator`` through ``SeedSequence([seed, member,
axis])``. The axes, their forms and the default standard deviations are
the JAX package's; the draws of a seed are not. An ensemble is held to
the JAX package's engine by feeding both the same member inputs (the
tests carry JAX's ``draw_members`` output across).

Axes (mean-preserving, so the ensemble's median tracks the base case):

* **Bass diffusion**: per-group lognormal factors on ``bass_p`` and
  ``bass_q``;
* **retail price path**: a ``[Y]`` geometric random walk on
  ``elec_price_multiplier``, year 0 pinned at 1, the escalator
  re-derived from the shocked multiplier
  (:func:`~dgen_tpu_torch.models.scenario.escalator_from_multipliers`);
* **wholesale price path**: an independent ``[Y]`` walk on
  ``wholesale_multiplier``, shared across regions;
* **technology cost**: one lognormal scale per technology on every
  coupled capex field (PV standalone and combined; battery $/kWh, $/kW
  and combined).

``nem_cap_kw`` is never drawn: it decides the net-billing flag, which
every member of an ensemble shares. A zero-width spec returns the base
:class:`ScenarioInputs` object itself, the hook of the E = 1
ensemble's byte parity with ``Simulation.run``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from dgen_tpu_torch.models.scenario import ScenarioInputs, escalator_from_multipliers

# axis numbers: the third word of an axis stream's seed. Frozen:
# renumbering changes every draw.
AXIS_BASS = 0
AXIS_RETAIL = 1
AXIS_WHOLESALE = 2
AXIS_TECH = 3


@dataclasses.dataclass(frozen=True)
class DrawSpec:
    """Standard deviations of the per-member axes, all in log space; 0.0
    disables an axis exactly (it perturbs nothing)."""

    bass_p_sd: float = 0.0      # per-group lognormal on bass_p
    bass_q_sd: float = 0.0      # per-group lognormal on bass_q
    retail_sd: float = 0.0      # per-year retail price walk step
    wholesale_sd: float = 0.0   # per-year wholesale price walk step
    pv_capex_sd: float = 0.0    # one lognormal scale per member
    batt_capex_sd: float = 0.0  # one lognormal scale per member

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = float(getattr(self, f.name))
            if not np.isfinite(v) or v < 0.0:
                raise ValueError(f"DrawSpec.{f.name} must be >= 0, got {v}")

    @property
    def is_zero(self) -> bool:
        """True when every axis is off: :func:`draw_member` then returns
        the base inputs object unchanged."""
        return all(float(getattr(self, f.name)) == 0.0 for f in dataclasses.fields(self))

    def to_json(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name)) for f in dataclasses.fields(self)}

    @classmethod
    def from_json(cls, d: Dict[str, float]) -> "DrawSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in known})


#: the JAX package's calibrated magnitudes: ~+-20% Bass p, ~+-15% q,
#: 1%/yr retail and 3%/yr wholesale walk steps, +-5% technology cost
DEFAULT_DRAWS = DrawSpec(
    bass_p_sd=0.20,
    bass_q_sd=0.15,
    retail_sd=0.01,
    wholesale_sd=0.03,
    pv_capex_sd=0.05,
    batt_capex_sd=0.05,
)


class MemberKey(NamedTuple):
    """The port's key of one ensemble member."""

    seed: int
    member: int


def member_key(seed: int, member: int) -> MemberKey:
    """Restart-stable key of ensemble member ``member``."""
    return MemberKey(int(seed), int(member))


def axis_rng(key: MemberKey, axis: int) -> np.random.Generator:
    """The generator of one (seed, member, axis)."""
    return np.random.default_rng(np.random.SeedSequence([key.seed, key.member, int(axis)]))


def _lognormal(z: np.ndarray, sd: float) -> np.ndarray:
    """Mean-preserving lognormal factors of standard normals ``z``:
    E[exp(sd z - sd^2 / 2)] = 1."""
    return np.exp(sd * np.asarray(z, np.float64) - 0.5 * sd * sd).astype(np.float32)


def _walk(z: np.ndarray, sd: float) -> np.ndarray:
    """[Y] geometric random-walk factors of ``Y - 1`` standard normals,
    year 0 pinned at 1.0 (the base year is observed); median-preserving."""
    steps = np.concatenate([[0.0], np.cumsum(sd * np.asarray(z, np.float64))])
    return np.exp(steps).astype(np.float32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def draw_member(base: ScenarioInputs, spec: DrawSpec, key: MemberKey) -> ScenarioInputs:
    """One member's :class:`ScenarioInputs`, drawn from ``key`` on the
    host (the perturbed trajectories are tiny) and put on the base's
    device. A zero-width spec returns ``base`` itself."""
    if spec.is_zero:
        return base
    dev = base.bass_p.device
    years_np = _host(base.years)
    n_years = int(years_np.shape[0])
    repl: Dict[str, torch.Tensor] = {}

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    if spec.bass_p_sd > 0.0 or spec.bass_q_sd > 0.0:
        g = tuple(base.bass_p.shape)
        # both draws always taken, p first: one axis off leaves the
        # other's draw as it is
        z = axis_rng(key, AXIS_BASS).standard_normal((2,) + g)
        if spec.bass_p_sd > 0.0:
            repl["bass_p"] = put(_host(base.bass_p) * _lognormal(z[0], spec.bass_p_sd))
        if spec.bass_q_sd > 0.0:
            repl["bass_q"] = put(_host(base.bass_q) * _lognormal(z[1], spec.bass_q_sd))

    if spec.retail_sd > 0.0 and n_years > 1:
        walk = _walk(axis_rng(key, AXIS_RETAIL).standard_normal(n_years - 1), spec.retail_sd)
        mult = _host(base.elec_price_multiplier) * walk[:, None, None]
        repl["elec_price_multiplier"] = put(mult)
        # the forward-CAGR escalator follows the shocked path, as the
        # reference derives one from the other
        repl["elec_price_escalator"] = put(
            escalator_from_multipliers(mult, years_np.astype(np.int64)))

    if spec.wholesale_sd > 0.0 and n_years > 1:
        walk = _walk(axis_rng(key, AXIS_WHOLESALE).standard_normal(n_years - 1),
                     spec.wholesale_sd)
        repl["wholesale_multiplier"] = put(_host(base.wholesale_multiplier) * walk[:, None])

    if spec.pv_capex_sd > 0.0 or spec.batt_capex_sd > 0.0:
        z = axis_rng(key, AXIS_TECH).standard_normal(2)
        if spec.pv_capex_sd > 0.0:
            s = _lognormal(z[0], spec.pv_capex_sd)
            for f in ("pv_capex_per_kw", "pv_capex_per_kw_combined"):
                repl[f] = put(_host(getattr(base, f)) * s)
        if spec.batt_capex_sd > 0.0:
            s = _lognormal(z[1], spec.batt_capex_sd)
            for f in ("batt_capex_per_kwh", "batt_capex_per_kw",
                      "batt_capex_per_kwh_combined"):
                repl[f] = put(_host(getattr(base, f)) * s)

    return dataclasses.replace(base, **repl)


def draw_members(base: ScenarioInputs, spec: DrawSpec, n_members: int,
                 seed: int) -> List[ScenarioInputs]:
    """All E members' inputs; member m depends only on ``(seed, m)``."""
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    return [draw_member(base, spec, member_key(seed, m)) for m in range(int(n_members))]
