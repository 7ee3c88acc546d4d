"""Gradient-based NPV-optimal sizing: damped Newton on the smooth twin
(port of ``dgen_tpu/grad/newton.py``).

The grid search prices two refine rounds of candidates; a Newton step on
the differentiable objective (:func:`sizing.make_npv_objective`) prices
one scale per analysis year and agent, its gradient and its curvature. A
few steps land inside the reference's tolerance ``xatol = max(2 kW,
1e-3 * width)`` wherever the smooth surface is locally concave; agents
whose curvature is degenerate (flat NPV, optima at the bracket edge,
switch-window cliffs) keep the coarse-grid winner, so the result never
leaves the bracket.

The objective is separable per agent, so its Hessian is diagonal: the
gradient of ``sum(g)``, taken through a graph kept by ``create_graph``,
is that diagonal. Per-agent results also make the agent chunking of
:func:`newton_size` exact: a chunk's rows see nothing of the others.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import sizing as sizing_ops
from dgen_tpu_torch.ops.tariff import HOURS
from dgen_tpu_torch.tree import tree_map

#: default smoothing temperature of the sizing objective (kW at the
#: hourly splits)
DEFAULT_TAU = 0.1
#: Newton iterations
DEFAULT_STEPS = 8
#: coarse-grid columns of the initial point (and of the fallback answer)
DEFAULT_INIT_K = 6
#: curvature threshold: |h| below this ($/kW^2) is degenerate, and the
#: agent keeps its grid fallback
CURV_EPS = 1e-4
#: bytes of the ``[rows, Y, 8760]`` float32 tensors that one agent chunk
#: of :func:`newton_size` may keep for its double backward (about
#: NEWTON_TEMPS of them: the relu inputs and their gradient graphs)
NEWTON_BYTES = 1 << 32
NEWTON_TEMPS = 16


@dataclasses.dataclass(frozen=True)
class NewtonSizeResult:
    """Per-agent outcome of :func:`newton_size`, leaves ``[N]``."""

    system_kw: torch.Tensor     #: final (bracket-projected) size
    npv: torch.Tensor           #: smooth-objective NPV at system_kw
    grad: torch.Tensor          #: dNPV/dkw at system_kw
    hess: torch.Tensor          #: diagonal d2NPV/dkw2 at system_kw
    fallback: torch.Tensor      #: bool, True where the grid answer won
    lo: torch.Tensor            #: the sizing bracket
    hi: torch.Tensor


def grad_and_diag_hess(f: Callable[[torch.Tensor], torch.Tensor],
                       kw: torch.Tensor) -> tuple:
    """(value, grad, diagonal Hessian), each ``[N]``, of a separable
    batched objective ``f: [N] -> [N]`` at ``kw``. ``sum(f)`` decouples
    over agents, so its gradient is the per-agent derivative, and the
    gradient of ``sum(grad)`` (through the graph ``create_graph`` keeps)
    is the Hessian's diagonal: the off-diagonal terms are zero."""
    with torch.enable_grad():
        x = kw.detach().requires_grad_(True)
        val = f(x)
        (g,) = torch.autograd.grad(val.sum(), x, create_graph=True)
        if g.requires_grad:
            (h,) = torch.autograd.grad(g.sum(), x)
        else:          # an objective linear in kw
            h = torch.zeros_like(x)
    return val.detach(), g.detach(), h.detach()


def newton_refine(f: Callable[[torch.Tensor], torch.Tensor], kw0: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor, n_steps: int = DEFAULT_STEPS,
                  damping: float = 1.0) -> tuple:
    """Bracket-projected damped Newton ascent from ``kw0``: where the
    surface is locally concave (``h < -CURV_EPS``) the step is
    ``-damping * g / h``, elsewhere a sign-following step of 5% of the
    bracket; no step crosses more than half the bracket, and every
    iterate is projected back into ``[lo, hi]``. Returns ``(kw, g, h)``
    at the final iterate."""
    width = hi - lo
    kw = kw0
    for _ in range(n_steps):
        _, g, h = grad_and_diag_hess(f, kw)
        concave = h < -CURV_EPS
        newton = -damping * g / torch.where(concave, h, -1.0)
        uphill = torch.sign(g) * 0.05 * width
        step = torch.where(concave, newton, uphill)
        # trust region: one step never crosses more than half the bracket
        step = torch.clamp(step, -0.5 * width, 0.5 * width)
        kw = torch.clamp(kw + step, lo, hi)
    _, g, h = grad_and_diag_hess(f, kw)
    return kw, g, h


def newton_chunk_rows(n_years: int) -> int:
    """Agent rows of one chunk of :func:`newton_size`: as many as keep its
    ``[rows, Y, 8760]`` float32 tensors (NEWTON_TEMPS of them) within
    NEWTON_BYTES."""
    return max(1, NEWTON_BYTES // (NEWTON_TEMPS * n_years * HOURS * 4))


def _newton_rows(envs, n_periods: int, n_years: int, soft_tau, n_steps: int,
                 init_k: int, net_billing: bool, impl: str) -> NewtonSizeResult:
    f, lo, hi = sizing_ops.make_npv_objective(
        envs, n_periods, n_years, net_billing=net_billing, soft_tau=soft_tau,
        impl=impl)
    k = max(int(init_k), 2)
    t = sizing_ops._unit_grid(k, lo.device)[None, :]
    grid = lo[:, None] + (hi - lo)[:, None] * t                    # [N, K]
    with torch.no_grad():
        npv_grid = f(grid)                                         # [N, K]
    i0 = torch.argmax(npv_grid, dim=1)
    kw0 = grid.gather(1, i0[:, None])[:, 0]
    npv0 = npv_grid.gather(1, i0[:, None])[:, 0]

    kw_n, g, h = newton_refine(f, kw0, lo, hi, n_steps=n_steps)
    with torch.no_grad():
        npv_n = f(kw_n)

    ok = (h < -CURV_EPS) & (npv_n >= npv0)
    return NewtonSizeResult(
        system_kw=torch.where(ok, kw_n, kw0),
        npv=torch.where(ok, npv_n, npv0),
        grad=g, hess=h, fallback=~ok, lo=lo, hi=hi,
    )


def newton_size(envs: sizing_ops.AgentEconInputs, n_periods: int, n_years: int, *,
                soft_tau: Optional[float] = DEFAULT_TAU, n_steps: int = DEFAULT_STEPS,
                init_k: int = DEFAULT_INIT_K, net_billing: bool = True,
                impl: str = bk.PLAIN) -> NewtonSizeResult:
    """Size the table by gradient ascent on the smooth NPV objective.

    1. One coarse grid of ``init_k`` columns seeds each agent at its best
       candidate (Newton needs a start in the right basin; the grid is
       also the fallback answer).
    2. ``n_steps`` damped Newton steps (:func:`newton_refine`).
    3. The Newton iterate is kept only where it stayed concave and beats
       the seed on the smooth objective; elsewhere the seed stands.

    Runs in agent chunks of :func:`newton_chunk_rows` (exact: the
    objective is per agent). ``impl`` as in
    :func:`sizing.make_npv_objective`: the gradient needs the plain
    differentiable sums (``"plain"``)."""
    n = envs.load.shape[0]
    chunk = newton_chunk_rows(n_years)
    kw = dict(soft_tau=soft_tau, n_steps=n_steps, init_k=init_k,
              net_billing=net_billing, impl=impl)
    if n <= chunk:
        return _newton_rows(envs, n_periods, n_years, **kw)
    parts = [_newton_rows(tree_map(lambda t: t[r0:r0 + chunk], envs), n_periods,
                          n_years, **kw) for r0 in range(0, n, chunk)]
    return tree_map(lambda *ts: torch.cat(ts), *parts)


def reference_xatol(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The reference's sizing tolerance ``max(2 kW, 1e-3 * width)``: the
    budget of Newton against the bracketed oracle."""
    return torch.clamp_min(1e-3 * (hi - lo), 2.0)
