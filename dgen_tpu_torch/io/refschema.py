"""Reference-schema results writeback (port of ``dgen_tpu/io/refschema.py``).

CPU side: imports pandas inside its functions (and sqlalchemy only when
a Postgres URL is given), never on the card path.

The reference lands its results in three Postgres tables with a column
contract its analysis notebooks consume directly
(docs/source/overview.rst:28-54; Notebooks/analysis_of_model_results
reads state_abbr/year/system_kw/npv/payback_period/market_share/
number_of_adopters/customers_in_bin/... from ``agent_outputs``):

  * ``agent_outputs``          — wide per-(agent, year) frame
                                 (dgen_model.py:441-463 writes the agent
                                 df minus a drop list)
  * ``agent_finance_series``   — narrow (agent_id, year, scenario_case)
                                 rows with 25-element arrays
                                 (finance_series_export.py:9-66)
  * ``state_hourly_agg``       — (state_abbr, year, n_hours, net_sum MW)
                                 (attachment_rate_functions.py:151-205)

This module maps a port run directory (``io.export``'s ``.npz``
partitions plus the ``agents.npz`` static frame) onto those exact names
and shapes: CSV files (one per table, Postgres COPY-compatible; array
cells are JSON lists, the CSV rendering of the reference's JSONB
columns) and, when sqlalchemy and a URL are given, direct ``to_sql``
appends. The CSVs are byte for byte the JAX package's
``write_reference_tables`` on the run's ``export.to_parquet`` copy: each
frame is built from the same columns in the same dtypes.

    python -m dgen_tpu_torch.io.refschema RUN_DIR OUT_DIR [--postgres-url URL]

Column notes (documented divergences, not silent gaps):
  * ``first_year_elec_bill_savings`` is derived (without - with), the
    same arithmetic the notebooks apply.
  * ``agent_finance_series.cf_energy_value`` carries the real series
    when the run exported it (full-precision runs; compact runs drop
    the energy_value column to halve the device->host transfer, and
    the writeback then zero-fills exactly like the reference's own
    ``_norm25`` does for malformed cells, finance_series_export.py:17).
  * ``utility_bill_w_sys`` / ``utility_bill_wo_sys`` are zero-filled:
    the engine folds bill trajectories into the cash-flow series and
    keeps only first-year bills per agent-year (agent_outputs carries
    both) — zero-fill is the reference exporter's own behavior for
    absent cells, not an invented trajectory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from dgen_tpu_torch.io import export

#: agent_outputs columns (reference names) in write order — the rename
#: map doubles as the roundtrip test's schema contract
AGENT_OUTPUTS_RENAME: Dict[str, str] = {
    # ours -> reference
    "agent_id": "agent_id",
    "year": "year",
    "state_abbr": "state_abbr",
    "sector_abbr": "sector_abbr",
    "customers_in_bin": "customers_in_bin",
    "developable_agent_weight": "developable_agent_weight",
    "system_kw": "system_kw",
    "npv": "npv",
    "payback_period": "payback_period",
    "max_market_share": "max_market_share",
    "market_share": "market_share",
    "new_adopters": "new_adopters",
    "number_of_adopters": "number_of_adopters",
    "new_system_kw": "new_system_kw",
    "system_kw_cum": "system_kw_cum",
    "market_value": "market_value",
    "first_year_bill_with_system": "first_year_elec_bill_with_system",
    "first_year_bill_without_system": "first_year_elec_bill_without_system",
    "batt_kw": "batt_kw",
    "batt_kwh": "batt_kwh",
    "new_batt_adopters": "batt_adopters_added_this_year",
    "batt_adopters_cum": "batt_adopters_cum",
    "batt_kw_cum": "batt_kw_cum",
    "batt_kwh_cum": "batt_kwh_cum",
    "carbon_intensity_t_per_kwh": "lrmer_co2e",
    "avoided_co2_t": "avoided_tons",
}

FINANCE_SERIES_COLUMNS = (
    "agent_id", "year", "scenario_case",
    "cf_energy_value", "utility_bill_w_sys", "utility_bill_wo_sys",
)

STATE_HOURLY_COLUMNS = ("state_abbr", "year", "n_hours", "net_sum")


def _norm25(a: np.ndarray) -> list:
    """25-length float list (pad/truncate, non-finite -> 0) — the
    reference's own normalization (finance_series_export.py:9-20)."""
    a = np.asarray(a, dtype=float).ravel()
    if a.size < 25:
        a = np.pad(a, (0, 25 - a.size))
    elif a.size > 25:
        a = a[:25]
    return [float(v) for v in np.where(np.isfinite(a), a, 0.0)]


def load_surface(run_dir: str, name: str):
    """A surface of a port run directory as a DataFrame (the JAX
    package's ``io.export.load_surface`` frame)."""
    import pandas as pd

    return pd.DataFrame(export.frame_columns(export.load_surface(run_dir, name)))


def reference_agent_outputs(run_dir: str):
    """The reference-named wide agent_outputs frame for a run dir."""
    import pandas as pd

    ao = load_surface(run_dir, "agent_outputs")
    static_path = os.path.join(run_dir, "agents.npz")
    if os.path.exists(static_path):
        with np.load(static_path, allow_pickle=False) as z:
            static = pd.DataFrame(export.frame_columns({k: z[k] for k in z.files}))
        ao = ao.merge(static, on="agent_id", how="left", validate="many_to_one")
    else:
        for col in ("state_abbr", "sector_abbr", "customers_in_bin",
                    "developable_agent_weight"):
            ao[col] = np.nan
    out = pd.DataFrame(
        {ref: ao[ours] for ours, ref in AGENT_OUTPUTS_RENAME.items()
         if ours in ao.columns}
    )
    # derived exactly as the notebooks derive it
    out["first_year_elec_bill_savings"] = (
        out["first_year_elec_bill_without_system"]
        - out["first_year_elec_bill_with_system"]
    )
    return out


def reference_finance_series(run_dir: str):
    import pandas as pd

    fs = load_surface(run_dir, "finance_series")
    n = len(fs)
    zeros = [0.0] * 25
    if "energy_value" in fs.columns:
        cf_ev = [_norm25(v) for v in fs["energy_value"]]
    else:   # compact run: zero-fill, the reference's own absent-cell rule
        cf_ev = [zeros] * n
    return pd.DataFrame({
        "agent_id": fs["agent_id"],
        "year": fs["year"],
        "scenario_case": "pv_only",
        "cf_energy_value": cf_ev,
        "utility_bill_w_sys": [zeros] * n,
        "utility_bill_wo_sys": [zeros] * n,
    })


def reference_state_hourly(run_dir: str):
    import pandas as pd

    sh = load_surface(run_dir, "state_hourly")
    return pd.DataFrame({
        "state_abbr": sh["state"],
        "year": sh["year"],
        "n_hours": [len(v) for v in sh["net_load_mw"]],
        "net_sum": [list(map(float, v)) for v in sh["net_load_mw"]],
    })


def _csv_ready(df):
    """JSON-encode list cells (the CSV rendering of JSONB columns)."""
    out = df.copy()
    for col in out.columns:
        if len(out) and isinstance(out[col].iloc[0], list):
            out[col] = out[col].map(json.dumps)
    return out


def write_reference_tables(
    run_dir: str,
    out_dir: str,
    postgres_url: Optional[str] = None,
    schema: Optional[str] = None,
) -> Dict[str, str]:
    """Emit the three reference tables for a run; returns table->path.

    CSVs always; Postgres additionally when ``postgres_url`` is given
    (requires sqlalchemy, an optional dependency — the reference's
    hard one, data_functions.py)."""
    os.makedirs(out_dir, exist_ok=True)
    tables = {
        "agent_outputs": reference_agent_outputs(run_dir),
        "agent_finance_series": reference_finance_series(run_dir),
        "state_hourly_agg": reference_state_hourly(run_dir),
    }
    from dgen_tpu_torch.utils.atomic import atomic_write

    paths = {}
    for name, df in tables.items():
        path = os.path.join(out_dir, f"{name}.csv")
        ready = _csv_ready(df)
        atomic_write(path, lambda tmp, d=ready: d.to_csv(tmp, index=False))
        paths[name] = path
    if postgres_url:
        import sqlalchemy

        engine = sqlalchemy.create_engine(postgres_url)
        with engine.begin() as conn:
            for name, df in tables.items():
                _csv_ready(df).to_sql(
                    name, conn, schema=schema, if_exists="append",
                    index=False,
                )
    return paths


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Write a run's results in the reference's table "
                    "schema (agent_outputs / agent_finance_series / "
                    "state_hourly_agg)")
    ap.add_argument("run_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--postgres-url", default=None)
    ap.add_argument("--schema", default=None)
    args = ap.parse_args(argv)
    paths = write_reference_tables(
        args.run_dir, args.out_dir, postgres_url=args.postgres_url,
        schema=args.schema,
    )
    for name, path in paths.items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
