"""Write the port-format copy of the golden package.

    python -m dgen_tpu_torch.tools.make_golden_package [OUT_DIR]

runs the port's converter (:func:`dgen_tpu_torch.io.convert.from_reference_pickle`)
on the golden fixture's reference pickles and CSVs in ``tests/fixtures/``,
with the arguments ``tests/test_golden_e2e.py`` gives the JAX converter,
and writes the package to OUT_DIR (default ``tests/torch_fixtures/golden_pkg``).
The package loads with numpy alone (``io.package.load_population``), so
the golden run needs no pickle and no pandas on the card. Runs on the
CPU side (the converter needs pandas).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
DEFAULT_OUT = os.path.join(ROOT, "tests", "torch_fixtures", "golden_pkg")


def make(out_dir: str = DEFAULT_OUT, fixtures: str = FIXTURES):
    """Convert the golden fixture into a package at ``out_dir``; returns
    the converter's population (on the CPU)."""
    import pandas as pd

    from dgen_tpu_torch.io import convert

    def fixture(name):
        return os.path.join(fixtures, name)

    return convert.from_reference_pickle(
        pd.read_pickle(fixture("golden_agents.pkl")), out_dir,
        pd.read_pickle(fixture("golden_load_profiles.pkl")),
        pd.read_pickle(fixture("golden_solar_profiles.pkl")),
        wholesale_by_region={"SA": np.full(8760, 0.03)},
        state_incentives=pd.read_csv(fixture("golden_incentives.csv")),
        nem_state_by_sector=pd.read_csv(fixture("golden_state_nem.csv")),
        nem_utility_by_sector=pd.read_csv(fixture("golden_util_nem.csv")),
        device="cpu",
    )


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    out = args[0] if args else DEFAULT_OUT
    pop = make(out)
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"wrote {out}: {int(pop.table.mask.sum())} agents, "
          f"{pop.tariffs.n_tariffs} tariffs, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
