"""Policy search: solve for the capex incentive that hits an adoption
target (port of ``dgen_tpu/grad/policy.py``).

"What capex incentive gives X adopters by the end year?" is a scalar
root-find through the whole simulation. Under the smooth twin the final
adoption is differentiable in the incentive (payback and the market-share
lookup stay smooth through sizing), so a few safeguarded Newton steps
solve it. The incentive is a fractional capex reduction of the PV price
trajectories (standalone and PV+battery), parameterized through a
sigmoid so the search stays inside (0, MAX_INCENTIVE_FRAC).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from dgen_tpu_torch.grad import calibrate
from dgen_tpu_torch.models import scenario as scen

#: incentives above this fraction of capex are outside the model's
#: credible range (and NPV degenerates as cost -> 0)
MAX_INCENTIVE_FRAC = 0.8


def apply_incentive(inputs: scen.ScenarioInputs, frac: torch.Tensor) -> scen.ScenarioInputs:
    """Scenario inputs with a fractional capex incentive applied to the
    PV price trajectories."""
    keep = 1.0 - frac
    return dataclasses.replace(
        inputs,
        pv_capex_per_kw=inputs.pv_capex_per_kw * keep,
        pv_capex_per_kw_combined=inputs.pv_capex_per_kw_combined * keep,
    )


def national_adopters_fn(rollout, base_inputs: scen.ScenarioInputs
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``f(theta) -> final-year national adopters``, the incentive
    fraction being ``MAX_INCENTIVE_FRAC * sigmoid(theta)``."""
    def f(theta: torch.Tensor) -> torch.Tensor:
        frac = MAX_INCENTIVE_FRAC * torch.sigmoid(theta)
        return rollout(apply_incentive(base_inputs, frac))[-1].sum()

    return f


def solve_incentive(n_agents: int = calibrate.CHECK_N_AGENTS, *,
                    target_uplift: float = 1.25, steps: int = 8,
                    soft_tau: float | None = calibrate.DEFAULT_TAU, seed: int = 7,
                    states=calibrate.CHECK_STATES,
                    end_year: int = calibrate.CHECK_END_YEAR, device="cuda") -> dict:
    """The capex-incentive fraction whose end-year national adoption is
    ``target_uplift`` times the no-incentive baseline.

    Safeguarded Newton on ``f(theta) - target`` with the exact derivative
    from reverse mode through the rollout, one value-and-gradient
    evaluation an iteration. Adoption rises with the incentive, so the
    solver keeps a sign-changing bracket and bisects whenever the Newton
    step leaves it; a target beyond saturation is reported with
    ``converged=False``."""
    pop, inputs, step_kw, n_years = calibrate.build_world(
        n_agents, states=states, end_year=end_year, seed=seed, soft_tau=soft_tau,
        device=device)
    dev = pop.table.mask.device
    rollout = calibrate.make_rollout(pop.table, pop.profiles, pop.tariffs,
                                     n_years=n_years, step_kw=step_kw)
    f = national_adopters_fn(rollout, inputs)

    def theta_t(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def value_and_grad(theta: torch.Tensor) -> tuple[float, float]:
        x = theta.detach().requires_grad_(True)
        val = f(x)
        (g,) = torch.autograd.grad(val, x)
        return float(val.detach()), float(g)

    lo, hi = -10.0, 6.0            # sigmoid(-10) ~ no incentive
    with torch.no_grad():
        f_lo = float(f(theta_t(lo)))
        f_hi = float(f(theta_t(hi)))
    baseline = f_lo
    target = baseline * float(target_uplift)

    history = []
    if target >= f_hi:
        # saturated: even the largest incentive cannot reach the target
        theta, final = theta_t(hi), f_hi
    else:
        theta = theta_t(0.5 * (lo + hi))
        for _ in range(steps):
            val, dval = value_and_grad(theta)
            resid = val - target
            if resid > 0.0:
                hi = float(theta)
            else:
                lo = float(theta)
            newton = float(theta) - resid / max(dval, 1e-6)
            # bisect when the Newton step leaves the bracket
            bisected = not (lo < newton < hi)
            if bisected:
                newton = 0.5 * (lo + hi)
            history.append({"theta": float(theta), "adopters": val, "resid": resid,
                            "dadopters_dtheta": dval, "bisected": bisected})
            theta = theta_t(newton)
        with torch.no_grad():
            final = float(f(theta))
    frac = float(MAX_INCENTIVE_FRAC * torch.sigmoid(theta))
    rel_miss = abs(final - target) / max(target, 1.0)
    # at small populations adoption moves in agent-weight quanta, so a
    # bracket collapsed below theta resolution is the solution to the
    # model's granularity
    converged = rel_miss < 0.02 or (target < f_hi and hi - lo < 0.05)
    return {
        "baseline_adopters": baseline,
        "target_adopters": target,
        "target_uplift": target_uplift,
        "incentive_frac": frac,
        "final_adopters": final,
        "rel_miss": rel_miss,
        "converged": converged,
        "theta_bracket_width": hi - lo,
        "history": history,
        "n_agents": n_agents,
        "n_years": n_years,
        "soft_tau": soft_tau,
    }
