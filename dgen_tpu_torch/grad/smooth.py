"""Smoothing primitives of the differentiable twin (port of
``dgen_tpu/grad/smooth.py``).

Every surrogate takes a temperature ``tau`` in the argument's own units
and tends to its hard counterpart as ``tau -> 0``. The bill, sizing and
market call sites take ``soft_tau=None`` by default and then compute
their hard expressions: the twin is added beside the hard path, never a
rewrite of it.

Two families:

* softplus surrogates (:func:`relu_t`, :func:`clip0_t`, :func:`min0_t`)
  for the import/export splits and the tier-segment clips, where
  smoothing the value inside the smoothing radius is acceptable;
* a straight-through gate (:func:`ste_gate`) where the forward value must
  stay hard (the rate-switch window): the forward is the exact 0/1 gate,
  the derivative a sigmoid bump, so the boundary still gets a gradient.

:func:`lerp_lookup` replaces a round-to-grid table gather with linear
interpolation between the two bracketing entries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def relu_t(x: torch.Tensor, tau: float) -> torch.Tensor:
    """Soft relu ``tau * softplus(x / tau)``: above ``max(x, 0)`` by at
    most ``tau * log 2`` (at 0)."""
    return tau * F.softplus(x / tau)


def min0_t(x: torch.Tensor, tau: float) -> torch.Tensor:
    """Smooth ``min(x, 0) = -relu_t(-x, tau)``."""
    return -relu_t(-x, tau)


def clip0_t(x: torch.Tensor, width, tau: float) -> torch.Tensor:
    """Smooth ``clip(x, 0, width)`` as a difference of soft relus; 0 at
    ``width = 0`` (a degenerate tier), as the hard clip."""
    return relu_t(x, tau) - relu_t(x - width, tau)


def _bump(x: torch.Tensor, tau: float) -> torch.Tensor:
    """``d/dx sigmoid(x / tau) = s (1 - s) / tau``, in differentiable
    operations, so its own derivative is there for a second pass."""
    s = torch.sigmoid(x / tau)
    return s * (1.0 - s) / tau


class _SteGate(torch.autograd.Function):
    """The hard gate ``float(x >= 0)`` whose derivative is the sigmoid
    bump. The JAX package defines it as a ``custom_jvp``, whose rule
    Newton's forward-over-reverse second derivative differentiates; here
    the backward is written in differentiable operations on the saved
    ``x``, so a second backward (``create_graph=True``) gives the same
    ``s (1 - s) (1 - 2 s) / tau**2``, and ``jvp`` serves forward mode."""

    @staticmethod
    def forward(x, tau):
        return (x >= 0.0).to(torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, tau = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.tau = tau

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * _bump(x, ctx.tau), None

    @staticmethod
    def jvp(ctx, x_t, _tau_t):
        (x,) = ctx.saved_tensors
        return x_t * _bump(x, ctx.tau)


def ste_gate(x: torch.Tensor, tau: float | None) -> torch.Tensor:
    """Heaviside step ``float(x >= 0)`` with a straight-through
    derivative. ``tau=None`` is the plain comparison; with a temperature
    the value is still the exact hard gate and only the derivative is the
    bump of width ``tau``."""
    if tau is None:
        return (x >= 0.0).to(torch.float32)
    return _SteGate.apply(x, float(tau))


def lerp_lookup(table: torch.Tensor, idx_float: torch.Tensor) -> torch.Tensor:
    """Linearly interpolated gather along ``table``'s last axis at the
    continuous grid coordinate ``idx_float`` (clamped to the table);
    ``table``'s leading axes broadcast against ``idx_float``'s. Its
    derivative in the coordinate is ``table[hi] - table[lo]``."""
    n = table.shape[-1]
    # minimum(maximum(.)) as jnp.clip is: its derivative at a bound splits
    # evenly, where clamp's passes whole
    x = torch.minimum(torch.maximum(idx_float, idx_float.new_tensor(0.0)),
                      idx_float.new_tensor(n - 1.0))
    lo = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    frac = x - lo.to(x.dtype)
    shape = torch.broadcast_shapes(table.shape[:-1], lo.shape)
    tb = table.expand(*shape, n)
    lo = lo.expand(shape)
    v_lo = tb.gather(-1, lo[..., None])[..., 0]
    v_hi = tb.gather(-1, (lo + 1)[..., None])[..., 0]
    return v_lo + frac * (v_hi - v_lo)
