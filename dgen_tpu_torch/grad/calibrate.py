"""Calibration as a differentiable workload (port of
``dgen_tpu/grad/calibrate.py``): fit Bass diffusion parameters (and a
market-share elasticity) to observed state-level adoption by
differentiating the whole multi-year rollout.

The rollout is the port's year step, year after year; the sensitivity of
the state adoption trajectory to ``bass_p``, ``bass_q`` and the
elasticity is an exact autograd gradient, and calibration is a few
Gauss-Newton or Adam steps. Reverse mode runs each later year under
``torch.utils.checkpoint``: the backward pass recomputes a year's
forward in place of keeping every year's graph (the JAX package's
``jax.checkpoint`` over ``lax.scan``). The Gauss-Newton Jacobian is
forward mode (``torch.autograd.forward_ad``), one column a parameter, as
JAX's ``jacfwd``; ``torch.func`` is not used, since it cannot enter the
CUDA kernels on the rollout's path.

Under the smooth twin (``soft_tau``) payback stays unrounded and the
max-market-share lookup interpolates, so gradients flow from the
economics into the diffusion; the Bass parameters enter after sizing and
are differentiable on the hard path too. No gradient reaches the kernels'
inputs (sizes, scales and dispatch inputs do not depend on the
parameters), and each kernel wrapper raises if one ever does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from dgen_tpu_torch.config import ScenarioConfig, resolve_device
from dgen_tpu_torch.models import scenario as scen
from dgen_tpu_torch.models.market import segment_sum
from dgen_tpu_torch.models.simulation import SimCarry, table_static_cache, year_step
from dgen_tpu_torch.ops import billkernels as bk

#: default smoothing temperature of the rollout twin
DEFAULT_TAU = 0.1
#: the check scale
CHECK_N_AGENTS = 64
CHECK_STATES = ("DE", "CA")
CHECK_END_YEAR = 2020
CHECK_ECON_YEARS = 8
CHECK_SIZING_ITERS = 4


# ---------------------------------------------------------------------------
# Parameterization
# ---------------------------------------------------------------------------

def init_params(fit_mms: bool = True, device="cuda") -> dict:
    """The parameters at the identity point: log-scale multipliers of the
    Bass innovation (p) and imitation (q) rates and, with ``fit_mms``, a
    log-exponent elasticity of the max-market-share curve (``mms **
    exp(elast)``: 0 leaves it untouched, and [0, 1] stays [0, 1]). With
    few observed years p/q and the elasticity trade off along a ridge, so
    the recovery check leaves the elasticity out."""
    dev = resolve_device(device)
    params = {"log_p": torch.zeros((), device=dev), "log_q": torch.zeros((), device=dev)}
    if fit_mms:
        params["mms_elast"] = torch.zeros((), device=dev)
    return params


def apply_params(inputs: scen.ScenarioInputs, params: dict) -> scen.ScenarioInputs:
    """Scenario inputs with the parameters applied (a missing key leaves
    its input as it is)."""
    mms = inputs.mms_table
    if "mms_elast" in params:
        # a safe power: the table's exact zeros (payback beyond the
        # horizon) must not give 0 ** s -> 0 * log(0) = nan in the gradient
        s = torch.exp(params["mms_elast"])
        mms = torch.where(mms > 0.0, torch.clamp_min(mms, 1e-12) ** s, 0.0)
    return dataclasses.replace(
        inputs,
        bass_p=inputs.bass_p * torch.exp(params["log_p"]),
        bass_q=inputs.bass_q * torch.exp(params["log_q"]),
        mms_table=mms,
    )


# ---------------------------------------------------------------------------
# Differentiable rollout
# ---------------------------------------------------------------------------

def make_rollout(table, profiles, tariffs, *, n_years: int,
                 step_kw: dict) -> Callable[[scen.ScenarioInputs], torch.Tensor]:
    """``rollout(inputs) -> adopters [T, n_states]``: the multi-year run
    reduced to the state adopter trajectory the loss compares with
    observations. ``step_kw``: :func:`year_step`'s keywords but
    ``first_year``. With grad mode on, each year after the first runs
    under ``torch.utils.checkpoint``."""
    kw = {k: v for k, v in step_kw.items() if k != "first_year"}
    n_states = table.n_states

    def state_adopters(outputs) -> torch.Tensor:
        return segment_sum(outputs.number_of_adopters * table.mask,
                           table.state_idx, n_states)

    def rollout(inputs: scen.ScenarioInputs) -> torch.Tensor:
        def body(carry, year_idx):
            c, out = year_step(table, profiles, tariffs, inputs, carry, year_idx,
                               first_year=False, **kw)
            return c, state_adopters(out)

        carry, out0 = year_step(table, profiles, tariffs, inputs,
                                SimCarry.zeros(table.n_agents, table.mask.device), 0,
                                first_year=True, **kw)
        rows = [state_adopters(out0)]
        for yi in range(1, n_years):
            if torch.is_grad_enabled():
                carry, adopters = checkpoint(body, carry, yi, use_reentrant=False)
            else:
                carry, adopters = body(carry, yi)
            rows.append(adopters)
        return torch.stack(rows)

    return rollout


def make_residuals(rollout, base_inputs: scen.ScenarioInputs,
                   targets: torch.Tensor) -> Callable[[dict], torch.Tensor]:
    """Normalized residuals ``r(params)`` ``[T * n_states]`` between the
    rollout's state trajectory and the observations."""
    scale = torch.clamp_min(targets.abs().mean(), 1.0)

    def residuals(params: dict) -> torch.Tensor:
        pred = rollout(apply_params(base_inputs, params))
        return ((pred - targets) / scale).reshape(-1)

    return residuals


def make_loss(rollout, base_inputs: scen.ScenarioInputs,
              targets: torch.Tensor) -> Callable[[dict], torch.Tensor]:
    """Normalized MSE between the rollout's state trajectory under
    ``params`` and the observed ``targets`` ``[T, n_states]``."""
    residuals = make_residuals(rollout, base_inputs, targets)

    def loss(params: dict) -> torch.Tensor:
        return (residuals(params) ** 2).mean()

    return loss


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def fit(loss_fn, params0: dict, *, steps: int = 60, lr: float = 0.1, b1: float = 0.9,
        b2: float = 0.999, eps: float = 1e-8) -> tuple[dict, list]:
    """Minimize ``loss_fn`` with Adam over a small parameter dict:
    ``(params, loss_history)``."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    history: list = []
    for i in range(steps):
        leaves = {k: t.requires_grad_(True) for k, t in params.items()}
        val = loss_fn(leaves)
        grads = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
        t = torch.tensor(i + 1.0, device=val.device)
        new = {}
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                mhat = m[k] / (1.0 - b1 ** t)
                vhat = v[k] / (1.0 - b2 ** t)
                new[k] = p - lr * mhat / (torch.sqrt(vhat) + eps)
        params = new
        history.append(float(val))
    return params, history


def jacobian_fwd(r_vec: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(r(x) ``[M]``, Jacobian ``[M, P]``) of ``r_vec`` at ``x`` ``[P]``: one
    forward-mode pass a column (JAX's ``jacfwd``), no graph kept."""
    cols = []
    r = None
    with torch.no_grad(), fwAD.dual_level():
        for j in range(x.shape[0]):
            tangent = torch.zeros_like(x)
            tangent[j] = 1.0
            primal, col = fwAD.unpack_dual(r_vec(fwAD.make_dual(x, tangent)))
            r = primal.clone() if r is None else r
            cols.append(torch.zeros_like(primal) if col is None else col.clone())
    return r, torch.stack(cols, dim=1)


def fit_gauss_newton(residual_fn: Callable[[dict], torch.Tensor], params0: dict, *,
                     steps: int = 8, damping: float = 1e-3) -> tuple[dict, list]:
    """Levenberg-Marquardt for few-parameter fits: the Jacobian is one
    forward-mode column a parameter through the rollout
    (:func:`jacobian_fwd`), and the normal equations a tiny dense solve,
    so an iteration costs ``n_params`` rollouts and converges
    quadratically near the optimum. Returns ``(params, loss_history)``
    with :func:`fit`'s loss (mean squared normalized residual)."""
    keys = sorted(params0)              # the order jax's ravel_pytree takes

    def unravel(x):
        return {k: x[i] for i, k in enumerate(keys)}

    def r_vec(x):
        return residual_fn(unravel(x))

    x = torch.stack([params0[k].detach().reshape(()) for k in keys])
    history: list = []
    for _ in range(steps):
        r, jac = jacobian_fwd(r_vec, x)
        a = jac.T @ jac + damping * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        dx = torch.linalg.solve(a, jac.T @ r)
        history.append(float((r * r).mean()))
        x = x - dx
    return unravel(x), history


# ---------------------------------------------------------------------------
# The synthetic-recovery workload
# ---------------------------------------------------------------------------

def build_world(n_agents: int = CHECK_N_AGENTS, states=CHECK_STATES,
                end_year: int = CHECK_END_YEAR, seed: int = 7, *,
                econ_years: int = CHECK_ECON_YEARS,
                sizing_iters: int = CHECK_SIZING_ITERS,
                soft_tau: float | None = DEFAULT_TAU, device="cuda"):
    """(population, inputs, step keywords, model years) of a small
    synthetic world for calibration runs, on ``device``: no anchoring
    (it would blend away the Bass signal the fit needs), storage off (the
    integer battery allocation is piecewise constant in the parameters),
    no hourly aggregate; sizing on the plain differentiable sums."""
    from dgen_tpu_torch.io import synth

    dev = resolve_device(device)
    cfg = ScenarioConfig(name="calibrate", start_year=2014, end_year=end_year,
                         anchor_years=())
    pop = synth.generate_population(n_agents, states=list(states), seed=seed,
                                    pad_multiple=32, device=dev)
    inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                 n_regions=pop.n_regions, device=dev)
    cache = table_static_cache(pop.table, pop.tariffs)
    step_kw = dict(
        n_periods=pop.tariffs.max_periods,
        econ_years=econ_years,
        sizing_iters=sizing_iters,
        with_hourly=False,
        storage_enabled=False,
        year_step_len=float(cfg.year_step),
        sizing_impl=bk.PLAIN,
        rate_switch=cache["rate_switch"],
        agent_chunk=0,
        net_billing=cache["any_nb_tariff"],
        daylight=None,
        pack_once=False,
        soft_tau=soft_tau,
        anchor=False,
    )
    return pop, inputs, step_kw, len(cfg.model_years)


def recover_pq(n_agents: int = CHECK_N_AGENTS, *, true_p_scale: float = 1.6,
               true_q_scale: float = 0.7, steps: int = 6, lr: float = 0.15,
               soft_tau: float | None = DEFAULT_TAU, seed: int = 7,
               states=CHECK_STATES, end_year: int = CHECK_END_YEAR,
               fit_mms: bool = False, method: str = "gn", device="cuda") -> dict:
    """Synthetic recovery: an adoption trajectory from known scaled Bass
    parameters, then the scales fitted back from the identity point.
    Returns the truth, the estimates, their relative errors and the loss
    curve. ``method="gn"`` runs Levenberg-Marquardt; ``"adam"`` the
    first-order :func:`fit` (``steps`` and ``lr`` as there)."""
    pop, inputs, step_kw, n_years = build_world(
        n_agents, states=states, end_year=end_year, seed=seed, soft_tau=soft_tau,
        device=device)
    dev = pop.table.mask.device
    rollout = make_rollout(pop.table, pop.profiles, pop.tariffs, n_years=n_years,
                           step_kw=step_kw)
    truth = {"log_p": torch.tensor(math.log(true_p_scale), device=dev),
             "log_q": torch.tensor(math.log(true_q_scale), device=dev)}
    with torch.no_grad():
        targets = rollout(apply_params(inputs, truth))
    params0 = init_params(fit_mms=fit_mms, device=dev)
    if method == "gn":
        fitted, history = fit_gauss_newton(make_residuals(rollout, inputs, targets),
                                           params0, steps=steps)
    else:
        fitted, history = fit(make_loss(rollout, inputs, targets), params0,
                              steps=steps, lr=lr)
    p_hat = float(torch.exp(fitted["log_p"]))
    q_hat = float(torch.exp(fitted["log_q"]))
    return {
        "true_p_scale": true_p_scale,
        "true_q_scale": true_q_scale,
        "p_scale_hat": p_hat,
        "q_scale_hat": q_hat,
        "mms_elast_hat": float(fitted["mms_elast"]) if "mms_elast" in fitted else 0.0,
        "rel_err_p": abs(p_hat - true_p_scale) / true_p_scale,
        "rel_err_q": abs(q_hat - true_q_scale) / true_q_scale,
        "loss_first": history[0],
        "loss_last": history[-1],
        "loss_curve": history,
        "n_agents": n_agents,
        "n_years": n_years,
        "steps": steps,
        "soft_tau": soft_tau,
    }
