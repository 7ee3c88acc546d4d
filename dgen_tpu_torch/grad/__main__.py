"""CLI of the differentiable twin: ``python -m dgen_tpu_torch.grad <cmd>``
(port of ``python -m dgen_tpu.grad``), on the card unless ``--device
cpu``. Each subcommand prints one JSON document:

``size``
    Newton sizing against the bracketed per-agent oracle
    (``size_agents(fast=False)``) on a synthetic world: the largest |kW|
    gap and whether it is inside the oracle's ``xatol``.
``calibrate``
    Recover seeded Bass p/q scales from synthetic adoption by
    differentiating the multi-year rollout (Gauss-Newton by default).
``policy``
    Solve the capex-incentive fraction that hits an adoption uplift.
``check``
    The gate: a central-difference gradcheck of the smooth NPV objective
    and a calibration that must recover p/q within 5%; exits 1 on a
    failure.

Flag defaults read ``DGEN_TPU_GRAD_AGENTS`` (--n-agents),
``DGEN_TPU_GRAD_TAU`` (--tau), ``DGEN_TPU_GRAD_SEED`` (--seed) and
``DGEN_TPU_GRAD_STEPS`` (--steps, every subcommand).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from dgen_tpu_torch.grad import calibrate, newton, policy
from dgen_tpu_torch.models import simulation as sim
from dgen_tpu_torch.models.scenario import apply_year
from dgen_tpu_torch.ops import sizing as sizing_ops

#: acceptance bar of the calibration gate (relative error of each of the
#: recovered p/q scales)
CHECK_PQ_RTOL = 0.05
#: acceptance bar of the gradcheck (relative error against central
#: differences, away from the straight-through gates' edges)
CHECK_GRAD_RTOL = 2e-2


def _world_envs(n_agents: int, seed: int, soft_tau: float, device="cuda"):
    """First-year ``AgentEconInputs`` (filled in) and static flags of the
    world the calibration gate runs on."""
    pop, inputs, step_kw, _ = calibrate.build_world(
        n_agents, seed=seed, soft_tau=soft_tau, device=device)
    table, profiles, tariffs = pop.table, pop.profiles, pop.tariffs
    ya = apply_year(table, inputs, 0)
    nem_allowed = sim.compute_nem_allowed(table, inputs, 0,
                                          sim.starting_state_kw(table, inputs))
    envs = sim.build_econ_inputs(table, profiles, tariffs, ya, nem_allowed,
                                 table.incentives,
                                 rate_switch=bool(step_kw["rate_switch"]))
    return sizing_ops._fill_env_defaults(envs), {
        "n_periods": int(step_kw["n_periods"]),
        "n_years": int(step_kw["econ_years"]),
        "net_billing": bool(step_kw["net_billing"]),
    }


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def cmd_size(args) -> dict:
    envs, meta = _world_envs(args.n_agents, args.seed, args.tau, args.device)
    res = newton.newton_size(envs, meta["n_periods"], meta["n_years"],
                             soft_tau=args.tau, n_steps=args.steps,
                             net_billing=meta["net_billing"])
    oracle = sizing_ops.size_agents(envs, n_periods=meta["n_periods"],
                                    n_years=meta["n_years"], fast=False, n_iters=20,
                                    net_billing=meta["net_billing"])
    xatol = _host(newton.reference_xatol(res.lo, res.hi))
    diff = np.abs(_host(res.system_kw) - _host(oracle.system_kw))
    return {
        "n_agents": args.n_agents,
        "newton_steps": args.steps,
        "soft_tau": args.tau,
        "max_abs_diff_kw": float(diff.max()),
        "xatol_kw": float(xatol.min()),
        "within_xatol": bool(np.all(diff <= xatol)),
        "n_fallback": int(_host(res.fallback).sum()),
        "mean_kw_newton": float(_host(res.system_kw).mean()),
        "mean_kw_oracle": float(_host(oracle.system_kw).mean()),
    }


def cmd_calibrate(args) -> dict:
    return calibrate.recover_pq(args.n_agents, steps=args.steps, soft_tau=args.tau,
                                seed=args.seed, method=args.method, device=args.device)


def cmd_policy(args) -> dict:
    return policy.solve_incentive(args.n_agents, target_uplift=args.uplift,
                                  steps=args.steps, soft_tau=args.tau, seed=args.seed,
                                  device=args.device)


def gradcheck(n_agents: int = 8, seed: int = 7, tau: float = 0.1,
              device="cuda") -> dict:
    """Central-difference check of the smooth NPV objective's gradient at
    three points across the sizing bracket. Agents whose point lies
    within ``5 * tau`` of a rate-switch window edge are left out of the
    maximum: the straight-through gates there are hard in the forward
    pass, so differences of the value cannot match their derivative."""
    envs, meta = _world_envs(n_agents, seed, tau, device)
    npv_fn, lo, hi = sizing_ops.make_npv_objective(
        envs, meta["n_periods"], meta["n_years"], net_billing=meta["net_billing"],
        soft_tau=tau)

    def grad_fn(kw):
        x = kw.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(npv_fn(x).sum(), x)
        return g

    h = tau / 4.0
    worst = 0.0
    per_point = []
    for frac in (0.3, 0.6, 0.9):
        kw = lo + frac * (hi - lo)
        g = _host(grad_fn(kw))
        with torch.no_grad():
            fd = _host((npv_fn(kw + h) - npv_fn(kw - h)) / (2.0 * h))
        rel = np.abs(g - fd) / (np.abs(fd) + 1.0)
        near_gate = ((np.abs(_host(kw - envs.switch_min_kw)) < 5 * tau)
                     | (np.abs(_host(kw - envs.switch_max_kw)) < 5 * tau))
        rel_ok = np.where(near_gate, 0.0, rel)
        worst = max(worst, float(rel_ok.max()))
        per_point.append({"frac": frac, "max_rel_err": float(rel_ok.max()),
                          "n_gate_excluded": int(near_gate.sum())})
    return {
        "n_agents": n_agents,
        "fd_step": h,
        "max_rel_err": worst,
        "points": per_point,
        "ok": worst < CHECK_GRAD_RTOL,
    }


def cmd_check(args) -> dict:
    gc = gradcheck(n_agents=8, seed=args.seed, tau=args.tau, device=args.device)
    cal = calibrate.recover_pq(args.n_agents, steps=args.steps, soft_tau=args.tau,
                               seed=args.seed, method="gn", device=args.device)
    cal_ok = cal["rel_err_p"] <= CHECK_PQ_RTOL and cal["rel_err_q"] <= CHECK_PQ_RTOL
    return {
        "gradcheck": gc,
        "calibration": {"rel_err_p": cal["rel_err_p"], "rel_err_q": cal["rel_err_q"],
                        "loss_last": cal["loss_last"], "ok": cal_ok},
        "ok": bool(gc["ok"] and cal_ok),
    }


def _env_num(name: str, default, cast):
    v = os.environ.get(name, "")
    return cast(v) if v else default


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dgen_tpu_torch.grad",
        description="Differentiable-twin workloads: sizing, calibration, "
                    "policy search.")
    p.add_argument("--n-agents", type=int,
                   default=_env_num("DGEN_TPU_GRAD_AGENTS", calibrate.CHECK_N_AGENTS, int))
    p.add_argument("--tau", type=float,
                   default=_env_num("DGEN_TPU_GRAD_TAU", calibrate.DEFAULT_TAU, float),
                   help="smoothing temperature (kW / native units)")
    p.add_argument("--seed", type=int, default=_env_num("DGEN_TPU_GRAD_SEED", 7, int))
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; 'cpu' runs the plain "
                        "versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def steps(sp, default):
        sp.add_argument("--steps", type=int,
                        default=_env_num("DGEN_TPU_GRAD_STEPS", default, int))

    ps = sub.add_parser("size", help="Newton sizing vs bracketed oracle")
    steps(ps, newton.DEFAULT_STEPS)
    ps.set_defaults(fn=cmd_size)

    pc = sub.add_parser("calibrate", help="recover seeded Bass p/q")
    steps(pc, 6)
    pc.add_argument("--method", choices=("gn", "adam"), default="gn")
    pc.set_defaults(fn=cmd_calibrate)

    pp = sub.add_parser("policy", help="solve incentive for a target")
    steps(pp, 6)
    pp.add_argument("--uplift", type=float, default=1.25)
    pp.set_defaults(fn=cmd_policy)

    pk = sub.add_parser("check", help="gate: gradcheck + calibration")
    steps(pk, 5)
    pk.set_defaults(fn=cmd_check)

    args = p.parse_args(argv)
    out = args.fn(args)
    print(json.dumps(out, indent=1, default=float))
    ok = out.get("ok", True)
    if not ok:
        print("dgen_tpu_torch.grad: FAILED", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
