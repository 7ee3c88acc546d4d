"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a CUDA device every test skips (the
kernels have no CPU form). Run on a machine with a card with
``python -m pytest tests/test_torch_kernels.py``.

Tolerance: rtol 1e-4, atol 1e-3 x the agent's largest |plain| value in
that output — the kernel sums each bucket hour by hour and the plain
version by matrix product, two float32 orders over up to 744 (bucket)
or 8760 (sell) terms."""

import numpy as np
import pytest
import torch

from dgen_tpu_torch.ops import billkernels as bk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, r, p, seed=0):
    g = torch.Generator().manual_seed(seed)
    load = torch.rand((n, 8760), generator=g) * 3.0
    gen = torch.rand((n, 8760), generator=g) * 0.9
    sell = torch.rand((n, 8760), generator=g) * 0.1
    hp = torch.randint(0, p, (n, 8760), generator=g, dtype=torch.int32)
    scales = torch.rand((n, r), generator=g) * 4.0
    hp_b = torch.randint(0, p, (n, 8760), generator=g, dtype=torch.int32)
    sell_b = torch.rand((n, 8760), generator=g) * 0.1
    out = dict(load=load, gen=gen, sell=sell, bucket=bk.hourly_bucket_ids(hp, p),
               scales=scales, sell_b=sell_b, bucket_b=bk.hourly_bucket_ids(hp_b, p))
    return {k: v.to(dev) for k, v in out.items()}


def _close(got, ref):
    for gt, rf in zip(got, ref):
        assert gt.shape == rf.shape and gt.dtype == torch.float32
        row_max = rf.abs().flatten(1).amax(1).view(-1, *[1] * (rf.ndim - 1))
        tol = 1e-4 * rf.abs() + 1e-3 * row_max
        assert bool(((gt - rf).abs() <= tol).all()), float((gt - rf).abs().max())


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("r", [25, 300])
@pytest.mark.parametrize("signed", [False, True])
def test_month_kernel_matches_plain(cuda, p, r, signed):
    x = _inputs(cuda, 37, r, p)
    args = (x["load"], x["gen"], x["sell"], x["bucket"], x["scales"], p, signed)
    before = dict(bk.LAUNCHES)
    got = bk.month_sums(*args)
    torch.cuda.synchronize()
    key = "month_signed" if signed else "month"
    assert bk.LAUNCHES[key] == before[key] + 1
    _close(got, bk.month_sums_plain(*args))


@pytest.mark.parametrize("p", [1, 2, 4, 10])
def test_pair_kernel_matches_plain(cuda, p):
    x = _inputs(cuda, 29, 300, p, seed=1)
    args = (x["load"], x["gen"], x["sell"], x["bucket"], x["sell_b"],
            x["bucket_b"], x["scales"], p)
    before = bk.LAUNCHES["month_pair"]
    got = bk.month_pair_sums(*args)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["month_pair"] == before + 1
    _close(got, bk.month_pair_sums_plain(*args))


def test_capture_keeps_the_first_launch_operands(cuda):
    x = _inputs(cuda, 8, 16, 2, seed=3)
    first = (x["load"], x["gen"], x["sell"], x["bucket"], x["scales"], 2, False)
    bk.CAPTURE = {}
    try:
        bk.month_sums(*first)
        bk.month_sums(x["load"], x["gen"], x["sell"], x["bucket"], x["scales"] * 2,
                      2, False)
        captured = bk.CAPTURE
    finally:
        bk.CAPTURE = None
    assert list(captured) == ["month"]
    assert all(a is b for a, b in zip(captured["month"], first))


def test_engines_on_the_card_match_the_cpu(cuda):
    x = _inputs(cuda, 16, 50, 2, seed=2)
    cpu = {k: v.cpu() for k, v in x.items()}
    for fn, keys in ((bk.import_sums, ("load", "gen", "sell", "bucket", "scales")),
                     (bk.bucket_sums, ("load", "gen", "sell", "bucket", "scales"))):
        got = fn(*(x[k] for k in keys), 24)
        ref = fn(*(cpu[k] for k in keys), 24)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=1e-4,
                                       atol=1e-3 * float(r.abs().max()))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = _inputs(cuda, 4, 8, 2)
    with pytest.raises(TypeError):
        bk.import_sums(x["load"].half(), x["gen"], x["sell"], x["bucket"],
                       x["scales"], 24)
    with pytest.raises(TypeError):
        bk.import_sums(x["load"], x["gen"], x["sell"], x["bucket"].long(),
                       x["scales"], 24)
    with pytest.raises(ValueError, match="contiguous"):
        bk.import_sums(x["load"], x["gen"], x["sell"], x["bucket"],
                       x["scales"].t().contiguous().t(), 24)
    with pytest.raises(ValueError, match="on"):
        bk.import_sums(x["load"].cpu(), x["gen"], x["sell"], x["bucket"],
                       x["scales"], 24)
