"""The plain-function A/B tool of the PyTorch port
(``dgen_tpu_torch.tools.plain_parent_ab``), on the CPU: the other
checkout's functions are swapped in where the model year looks them up
and restored after; a checkout against itself is equal bit for bit; a
changed function in the other checkout shows in the comparison."""

import os
import shutil

import pytest

from dgen_tpu_torch import presets
from dgen_tpu_torch.config import RunConfig
from dgen_tpu_torch.tools import plain_parent_ab as ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def calls():
    sim, _, _ = presets.build("ercot-all-sector", n_agents=64, end_year=2014,
                              device="cpu", run_config=RunConfig(sizing_iters=4))
    return ab.first_calls(sim)


def test_swapped_puts_the_other_functions_in_place_and_restores():
    functions = ab.other_functions(ROOT)
    assert [(m.__name__, a) for m, a, _ in functions] == [s[:2] for s in ab.SWAPS]
    own = [getattr(m, a) for m, a, _ in functions]
    for (m, a, f), mine in zip(functions, own):
        assert f is not mine and f.__module__.startswith("other_")
    with ab.swapped(functions):
        assert all(getattr(m, a) is f for m, a, f in functions)
    assert [getattr(m, a) for m, a, _ in functions] == own


def test_first_calls_keep_every_piece(calls):
    assert set(calls) == set(ab.PIECES)


@pytest.mark.parametrize("piece", ab.PIECES)
def test_a_checkout_against_itself_is_bit_for_bit(calls, piece):
    args, kw = calls[piece]
    row = ab.compare_and_time(lambda: getattr(ab.bk, piece)(*args, **kw),
                              ab.other_functions(ROOT), 1, "cpu")
    assert row["same_bits"] and row["max_abs_diff"] == 0.0
    assert row["pairs"] == 1 and row["ms"] > 0 and row["other_ms"] > 0


def test_a_changed_function_shows_in_the_comparison(calls, tmp_path):
    ops = tmp_path / "dgen_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    src = os.path.join(ROOT, "dgen_tpu_torch", "ops")
    shutil.copy(os.path.join(src, "billkernels.py"), ops / "billkernels.py")
    (ops / "bill.py").write_text(
        open(os.path.join(src, "bill.py")).read()
        + "\n\n_own_sums = monthly_period_sums\n\n\n"
          "def monthly_period_sums(x, hour_period, n_periods):\n"
          "    return 2.0 * _own_sums(x, hour_period, n_periods)\n")
    args, kw = calls["linear_sums"]
    row = ab.compare_and_time(lambda: ab.bk.linear_sums(*args, **kw),
                              ab.other_functions(str(tmp_path)), 1, "cpu")
    assert not row["same_bits"]
    assert row["max_rel_diff"] == pytest.approx(0.5, rel=1e-6)
