"""The differentiable twin of the adoption model (port of
``dgen_tpu/grad``), on torch autograd.

What blocks a gradient through sizing and the market step is a handful
of kinks: tier and TOU-bucket edges in the bills, the hard relu
import/export splits, the payback rounding and the payback ->
max-market-share table snap. ``RunConfig.soft_boundaries`` (env
``DGEN_TPU_SOFT``) replaces them:

* :mod:`~dgen_tpu_torch.grad.smooth`: softplus surrogates and the
  straight-through gate; every hard path is unchanged when the
  temperature is ``None``;
* :mod:`~dgen_tpu_torch.grad.newton`: damped Newton sizing on the smooth
  NPV objective, bracket-projected, with a grid fallback;
* :mod:`~dgen_tpu_torch.grad.calibrate`: Bass p/q (and a market-share
  elasticity) fitted by differentiating the multi-year rollout;
* :mod:`~dgen_tpu_torch.grad.policy`: a gradient search for the capex
  incentive that hits an adoption target.

CLI: ``python -m dgen_tpu_torch.grad {size,calibrate,policy,check}``.
"""

from dgen_tpu_torch.grad.smooth import (  # noqa: F401  (public API)
    clip0_t,
    lerp_lookup,
    min0_t,
    relu_t,
    ste_gate,
)

__all__ = ["relu_t", "clip0_t", "min0_t", "ste_gate", "lerp_lookup"]
