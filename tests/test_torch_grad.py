"""The differentiable twin of the PyTorch port against the JAX package's
``dgen_tpu.grad`` on the CPU: the smooth surrogates and their
derivatives (the straight-through gate's second derivative against JAX's
``jvp`` of ``grad``), ``make_npv_objective``'s value, gradient and
Hessian diagonal on the CLI's 8-agent world, the gradcheck, Newton
sizing on 16 agents (against JAX's and against the port's own per-agent
oracle within ``xatol``), the calibration loss and its gradient at the
seeded start on the ``CHECK_*`` world, the forward-mode tangents the
Gauss-Newton Jacobian rides, and (slow) the calibration's recovery of
seeded Bass parameters. The soft bills, payback and market-share lookup
are held in tests/test_torch_sizing_oracle.py; the guards, switches and
a soft run of five years in tests/test_torch_analysis.py.

Tolerances: values of float32 computations near float32 rounding (rtol
1e-5, NPV with atol 1e-2); gradients and Hessian diagonals within 1e-3
relative (plus a small absolute floor where the value is near 0);
Newton sizes within the reference's ``xatol = max(2 kW, 1e-3 x
width)``, as tests/test_grad.py:114 holds them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dgen_tpu.grad import calibrate as jcal
from dgen_tpu.grad import newton as jnewton
from dgen_tpu.grad import smooth as jsmooth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models import simulation as jsim
from dgen_tpu.ops import sizing as jsizing
from dgen_tpu_torch import convert
from dgen_tpu_torch.grad import calibrate as tcal
from dgen_tpu_torch.grad import newton as tnewton
from dgen_tpu_torch.grad import smooth as tsmooth
from dgen_tpu_torch.grad.__main__ import CHECK_GRAD_RTOL, _world_envs, gradcheck
from dgen_tpu_torch.models import market as tmarket
from dgen_tpu_torch.ops import sizing as tsizing

TAU = 0.1


def t(x):
    return torch.from_numpy(np.array(x))


def close(ref, got, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


def tgrad(f, x):
    """d sum(f) / dx at ``x`` (a numpy array) in the port."""
    xt = t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(f(xt).sum(), xt)
    return g.numpy()


# ---------------------------------------------------------------------------
# smooth primitives
# ---------------------------------------------------------------------------

def test_smooth_primitives_and_their_gradients_match_reference():
    x = np.linspace(-5.0, 5.0, 41, dtype=np.float32)
    w = np.float32(2.5)
    for tau in (0.5, 0.1, 0.01):
        for jf, tf in ((lambda v: jsmooth.relu_t(v, tau), lambda v: tsmooth.relu_t(v, tau)),
                       (lambda v: jsmooth.min0_t(v, tau), lambda v: tsmooth.min0_t(v, tau)),
                       (lambda v: jsmooth.clip0_t(v, w, tau),
                        lambda v: tsmooth.clip0_t(v, w, tau))):
            close(jf(jnp.asarray(x)), tf(t(x)), 1e-5, 1e-6)
            close(jax.vmap(jax.grad(jf))(jnp.asarray(x)), tgrad(tf, x), 1e-5, 1e-6)
        # softplus overestimates the relu by at most tau log 2, at the kink
        assert float((tsmooth.relu_t(t(x), tau) - t(x).clamp_min(0)).abs().max()) \
            <= tau * 0.6932
    assert abs(float(tgrad(lambda v: tsmooth.relu_t(v, 0.1), np.float32(0.0))) - 0.5) < 1e-6
    assert abs(float(tsmooth.clip0_t(torch.tensor(2.0), torch.tensor(0.0), 0.05))) < 1e-6


def test_lerp_lookup_matches_reference():
    table = np.asarray([[0.0, 10.0, 40.0, 90.0], [5.0, 1.0, 0.0, 3.0]], np.float32)
    idx = np.asarray([1.5, -3.0, 99.0, 2.25, 0.0, 3.0], np.float32)
    rows = np.asarray([0, 0, 0, 1, 1, 1])
    ref = jax.jit(jsmooth.lerp_lookup)(jnp.asarray(table)[rows], jnp.asarray(idx))
    got = tsmooth.lerp_lookup(t(table)[t(rows)], t(idx))
    close(ref, got, 1e-6, 1e-6)
    assert abs(float(got[0]) - 25.0) < 1e-5
    jg = jax.jit(jax.grad(lambda i: jsmooth.lerp_lookup(jnp.asarray(table)[rows],
                                                        i).sum()))(jnp.asarray(idx))
    close(jg, tgrad(lambda i: tsmooth.lerp_lookup(t(table)[t(rows)], i), idx), 1e-6, 1e-6)
    # a [1, G] table broadcasts against the coordinates
    close(jax.jit(jsmooth.lerp_lookup)(jnp.asarray(table[:1]), jnp.asarray(idx[:3])),
          tsmooth.lerp_lookup(t(table[:1]), t(idx[:3])), 1e-6, 1e-6)


def test_ste_gate_value_derivatives_match_reference():
    """Forward: the exact hard gate; backward: the sigmoid bump; the
    second derivative (what Newton differentiates) against JAX's ``jvp``
    of ``grad`` through the ``custom_jvp``; forward mode too."""
    x = np.asarray([-1.0, -0.3, -1e-4, 0.0, 1e-4, 0.2, 1.0], np.float32)
    hard = (x >= 0).astype(np.float32)
    np.testing.assert_array_equal(tsmooth.ste_gate(t(x), None).numpy(), hard)
    np.testing.assert_array_equal(tsmooth.ste_gate(t(x), TAU).numpy(), hard)
    jf = lambda v: jsmooth.ste_gate(v, TAU)
    close(jax.vmap(jax.grad(jf))(jnp.asarray(x)),
          tgrad(lambda v: tsmooth.ste_gate(v, TAU), x), 1e-5, 1e-6)
    # second derivatives: d/dx of the bump, and of (gate * x)'
    for jg, tg in ((jf, lambda v: tsmooth.ste_gate(v, TAU)),
                   (lambda v: jsmooth.ste_gate(v, TAU) * v,
                    lambda v: tsmooth.ste_gate(v, TAU) * v)):
        ref = jax.vmap(lambda v: jax.jvp(jax.grad(jg), (v,), (jnp.float32(1.0),))[1])(
            jnp.asarray(x))
        xt = t(x).requires_grad_(True)
        (g,) = torch.autograd.grad(tg(xt).sum(), xt, create_graph=True)
        (h,) = torch.autograd.grad(g.sum(), xt)
        close(ref, h, 1e-4, 1e-4)
    with fwAD.dual_level():
        out = tsmooth.ste_gate(fwAD.make_dual(t(x), torch.ones(len(x))), TAU)
        tangent = fwAD.unpack_dual(out).tangent
    close(jax.vmap(lambda v: jax.jvp(jf, (v,), (jnp.float32(1.0),))[1])(jnp.asarray(x)),
          tangent, 1e-5, 1e-6)


# ---------------------------------------------------------------------------
# soft bills, payback, market share
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the differentiable objective and Newton sizing
# ---------------------------------------------------------------------------

def j_world_envs(n: int):
    """``dgen_tpu.grad.__main__._world_envs(n, 7, TAU)``: the same calls,
    under one ``jax.jit`` (eager, each operation compiles on its own)."""
    pop, inputs, step_kw, _ = jcal.build_world(n, seed=7, soft_tau=TAU)

    def envs(table, profiles, tariffs, inputs):
        nem = jsim.compute_nem_allowed(table, inputs, 0,
                                       jsim.starting_state_kw(table, inputs))
        return jsim.build_econ_inputs(table, profiles, tariffs,
                                      jscen.apply_year(table, inputs, 0), nem,
                                      table.incentives,
                                      rate_switch=bool(step_kw["rate_switch"]))

    return jax.jit(envs)(pop.table, pop.profiles, pop.tariffs, inputs), {
        "n_periods": int(step_kw["n_periods"]), "n_years": int(step_kw["econ_years"]),
        "net_billing": bool(step_kw["net_billing"])}


@pytest.fixture(scope="module")
def cli_worlds():
    """The CLI's worlds (calibrate.build_world's synthetic world, first
    model year) at 8 and 16 agents, in both packages."""
    return {n: (j_world_envs(n), _world_envs(n, 7, TAU, "cpu")) for n in (8, 16)}


def _jax_vgh(f, kw):
    """JAX's value, gradient and Hessian diagonal, as jnewton computes
    them."""
    return jnewton.grad_and_diag_hess(f, kw)


def test_npv_objective_value_grad_and_hessian_match_reference(cli_worlds):
    (jenv, jmeta), (tenv, tmeta) = cli_worlds[8]
    assert jmeta == tmeta
    jf, jlo, jhi = jsizing.make_npv_objective(
        jenv, jmeta["n_periods"], jmeta["n_years"], net_billing=jmeta["net_billing"],
        soft_tau=TAU)
    tf, tlo, thi = tsizing.make_npv_objective(
        tenv, tmeta["n_periods"], tmeta["n_years"], net_billing=tmeta["net_billing"],
        soft_tau=TAU)
    close(jlo, tlo, 1e-6, 0.0)
    close(jhi, thi, 1e-6, 0.0)
    fracs = (0.3, 0.6, 0.9)
    grid = np.stack([np.asarray(jlo + f * (jhi - jlo)) for f in fracs], axis=1)
    vgh = jax.jit(functools.partial(_jax_vgh, jf))
    with torch.no_grad():
        t_grid = tf(t(grid))
    for i in range(len(fracs)):
        jv, jg, jh = vgh(jnp.asarray(grid[:, i]))
        val, g, h = tnewton.grad_and_diag_hess(tf, t(grid[:, i]))
        close(jv, val, 1e-5, 1e-2, "value")
        close(jg, g, 1e-3, 1e-3, "gradient")
        close(jh, h, 1e-3, 1e-3 * float(np.abs(np.asarray(jh)).max()), "Hessian")
        # a candidate grid [N, K] prices as K separate evaluations
        close(val, t_grid[:, i], 1e-6, 1e-3, "grid column")


def test_gradcheck_of_the_smooth_objective():
    """tests/test_grad.py's gate on the port: autograd against central
    differences on the 8-agent world."""
    out = gradcheck(n_agents=8, seed=7, tau=TAU, device="cpu")
    assert out["ok"], out
    assert out["max_rel_err"] < CHECK_GRAD_RTOL


def test_newton_size_matches_reference_and_the_oracle(cli_worlds):
    (jenv, meta), (tenv, _) = cli_worlds[16]
    ref = jax.jit(functools.partial(
        jnewton.newton_size, n_periods=meta["n_periods"], n_years=meta["n_years"],
        soft_tau=TAU, net_billing=meta["net_billing"]))(jenv)
    got = tnewton.newton_size(tenv, meta["n_periods"], meta["n_years"], soft_tau=TAU,
                              net_billing=meta["net_billing"])
    oracle = tsizing.size_agents(tenv, n_periods=meta["n_periods"],
                                 n_years=meta["n_years"], fast=False, n_iters=20,
                                 net_billing=meta["net_billing"])
    carried = convert.newton_size_result(convert.to_numpy_dict(ref), device="cpu")
    xatol = tnewton.reference_xatol(got.lo, got.hi).numpy()
    close(carried.lo, got.lo, 1e-6, 0.0)
    close(carried.hi, got.hi, 1e-6, 0.0)
    kw = got.system_kw.numpy()
    assert np.all(np.abs(kw - carried.system_kw.numpy()) <= xatol)
    diff = np.abs(kw - oracle.system_kw.numpy())
    assert np.all(diff <= xatol), (diff.max(), xatol.min())
    assert np.all(kw >= got.lo.numpy() - 1e-5) and np.all(kw <= got.hi.numpy() + 1e-5)
    assert int(got.fallback.sum()) < kw.shape[0]


# ---------------------------------------------------------------------------
# calibration and policy
# ---------------------------------------------------------------------------

def test_calibration_loss_and_gradient_match_reference():
    """The normalized MSE of the CHECK_* world's 4-year rollout against a
    fixed target, and its gradient in (log_p, log_q, mms_elast), at the
    identity start; the rollout's years after the first recomputed under
    torch.utils.checkpoint in the backward pass."""
    pop, inputs, step_kw, n_years = jcal.build_world()
    roll = jcal.make_rollout(pop.table, pop.profiles, pop.tariffs, n_years=n_years,
                             step_kw=step_kw)
    targets = np.ones((n_years, pop.table.n_states), np.float32)
    params0 = jcal.init_params(fit_mms=True)
    jv, jg = jax.jit(jax.value_and_grad(jcal.make_loss(roll, inputs,
                                                       jnp.asarray(targets))))(params0)

    tpop, tin, tkw, tyears = tcal.build_world(device="cpu")
    assert tyears == n_years and tkw["anchor"] is False
    troll = tcal.make_rollout(tpop.table, tpop.profiles, tpop.tariffs, n_years=tyears,
                              step_kw=tkw)
    loss = tcal.make_loss(troll, tin, t(targets))
    params = convert.calibration_params(
        {k: np.asarray(v) for k, v in params0.items()}, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    tv = loss(leaves)
    tg = torch.autograd.grad(tv, list(leaves.values()))
    close(jv, tv.detach(), 1e-5, 1e-6, "loss")
    for k, g in zip(leaves, tg):
        close(jg[k], g, 1e-3, 1e-5, f"d loss / d {k}")


def test_forward_mode_tangents_through_the_market_sums():
    """The Gauss-Newton Jacobian is forward mode through the rollout; its
    tangents cross the market step's segment sums, the card's fixed-order
    form too (plain PyTorch, so it runs here), and agree with reverse
    mode. A small residual function checks ``jacobian_fwd`` itself."""
    rng = np.random.default_rng(6)
    x = t(rng.normal(size=40).astype(np.float32))
    x[::7] = 0.0
    idx = t(rng.integers(0, 5, 40).astype(np.int32))
    tangent = t(rng.normal(size=40).astype(np.float32))
    for seg in (tmarket.segment_sum, tmarket._fixed_order_segment_sum):
        with torch.no_grad(), fwAD.dual_level():
            out = seg(fwAD.make_dual(x, tangent), idx, 5)
            jvp = fwAD.unpack_dual(out).tangent
        want = torch.zeros(5).index_add_(0, idx.long(), tangent * (x != 0))
        if seg is tmarket.segment_sum:
            want = torch.zeros(5).index_add_(0, idx.long(), tangent)
        close(want, jvp, 1e-6, 1e-6, seg.__name__)
    w = t(rng.normal(size=(6, 3)).astype(np.float32))

    def r_vec(v):
        return torch.tanh(w @ v) * v.sum()

    x0 = t(np.asarray([0.3, -0.2, 0.5], np.float32))
    r, jac = tcal.jacobian_fwd(r_vec, x0)
    rev = torch.autograd.functional.jacobian(r_vec, x0)
    close(r_vec(x0), r, 1e-6, 1e-6)
    close(rev, jac, 1e-5, 1e-6)


@pytest.mark.slow
def test_calibration_recovers_seeded_bass_parameters():
    """tests/test_grad.py's recovery gate on the port: Gauss-Newton
    through the rollout recovers the seeded (p, q) within 5%, and the
    loss falls."""
    out = tcal.recover_pq(64, steps=5, method="gn", device="cpu")
    assert out["rel_err_p"] <= 0.05, out
    assert out["rel_err_q"] <= 0.05, out
    assert out["loss_curve"][-1] < out["loss_curve"][0]
    # the forward-mode Jacobian agrees with reverse mode at the start
    pop, inputs, step_kw, n_years = tcal.build_world(device="cpu")
    roll = tcal.make_rollout(pop.table, pop.profiles, pop.tariffs, n_years=n_years,
                             step_kw=step_kw)
    targets = torch.ones((n_years, pop.table.n_states))
    r_vec = tcal.make_residuals(roll, inputs, targets)
    params = tcal.init_params(fit_mms=True, device="cpu")
    keys = sorted(params)
    r, jac = tcal.jacobian_fwd(
        lambda v: r_vec(dict(zip(keys, v))), torch.stack([params[k] for k in keys]))
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    g_rev = torch.autograd.grad(tcal.make_loss(roll, inputs, targets)(leaves),
                                [leaves[k] for k in keys])
    close(torch.stack(g_rev), 2.0 * (jac * r[:, None]).sum(0) / r.shape[0],
          1e-4, 1e-6, "J^T r")
