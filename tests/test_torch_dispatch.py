"""Battery dispatch of the PyTorch port against the JAX package on the
CPU: the plain loop (the dispatch kernel's plain version) against the
JAX ``impl="scan"`` and the port's ``impl="pscan"`` against the JAX
``impl="pscan"``, at the tolerances of tests/test_dispatch.py (rtol 1e-5,
atol 1e-4; system_out of the prefix form atol 2e-4: the two prefixes
group the float32 sums differently). Inputs are made from a numpy seed:
per-agent round-trip efficiencies, a zero battery in row 0, odd hour
counts and a single agent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu.ops import dispatch as jdisp
from dgen_tpu_torch.ops import billkernels as tbk
from dgen_tpu_torch.ops import dispatch as tdisp

FIELDS = ("system_out", "soc", "charge", "discharge")
#: (agents, hours)
SHAPES = [(1, 8760), (1, 37), (7, 37), (16, 8760)]


def _inputs(n: int, hours: int, seed: int):
    rng = np.random.default_rng(seed)
    load = rng.uniform(0.1, 4.0, (n, hours)).astype(np.float32)
    gen = (rng.uniform(0.0, 3.0, (n, hours))
           * (rng.random((n, hours)) > 0.4)).astype(np.float32)
    kw = rng.uniform(0.5, 4.0, n).astype(np.float32)
    kw[0] = 0.0                      # no battery: no flows, system_out = gen
    kwh = (kw * 2.0).astype(np.float32)
    eff = rng.uniform(0.80, 0.96, n).astype(np.float32)
    return load, gen, kw, kwh, eff


def _jax(impl, load, gen, kw, kwh, eff):
    return jax.vmap(lambda l, g, p, e, f: jdisp.dispatch_battery(
        l, g, p, e, f, impl=impl))(*map(jnp.asarray, (load, gen, kw, kwh, eff)))


def _torch(fn, load, gen, kw, kwh, eff, **kw_args):
    return fn(*map(torch.from_numpy, (load, gen, kw, kwh, eff)), **kw_args)


def _check(got, ref, out_atol=1e-4):
    for k in FIELDS:
        g = getattr(got, k)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), np.asarray(getattr(ref, k)), rtol=1e-5,
            atol=out_atol if k == "system_out" else 1e-4, err_msg=k)


@pytest.mark.parametrize("n,hours", SHAPES)
def test_plain_loop_matches_jax_scan(n, hours):
    x = _inputs(n, hours, seed=n * 1000 + hours)
    got = _torch(tdisp.dispatch_battery_plain, *x)
    _check(got, _jax("scan", *x))
    # the zero battery moves nothing; the others both charge and discharge
    assert float(got.charge[0].abs().max()) == 0.0
    assert float(got.discharge[0].abs().max()) == 0.0
    np.testing.assert_array_equal(got.system_out[0].numpy(), x[1][0])
    if n > 1:
        assert float(got.charge[1:].sum()) > 0.0
        assert float(got.discharge[1:].sum()) > 0.0


@pytest.mark.parametrize("n,hours", SHAPES)
def test_pscan_matches_jax_pscan(n, hours):
    x = _inputs(n, hours, seed=n * 1000 + hours + 1)
    got = _torch(tdisp.dispatch_battery, *x, impl="pscan")
    _check(got, _jax("pscan", *x), out_atol=2e-4)
    assert float(got.charge[0].abs().max()) == 0.0
    assert float(got.discharge[0].abs().max()) == 0.0
    # and the sequential recursion, as tests/test_dispatch.py holds the two
    _check(got, _torch(tdisp.dispatch_battery_plain, *x), out_atol=2e-4)


def test_cpu_tensors_run_the_plain_loop_and_launch_nothing():
    x = _inputs(5, 37, seed=3)
    tdisp.reset_launches()
    tbk.reset_launches()
    got = _torch(tdisp.dispatch_battery, *x)
    ref = _torch(tdisp.dispatch_battery_plain, *x)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert tdisp.LAUNCHES == {"dispatch": 0}
    assert not any(tbk.LAUNCHES.values())


def test_unknown_impl_raises():
    x = _inputs(2, 37, seed=4)
    with pytest.raises(ValueError, match="unknown dispatch impl"):
        _torch(tdisp.dispatch_battery, *x, impl="scan2")
