"""Host-side I/O of the port: trajectory ingest from a reference-format
input root (``ingest``, ``reference_inputs``, ``workbook``), the
synthetic population, the DGPB1 profile banks (``store``), packages,
run outputs and checkpoints, and the CPU-side converters and writeback
(``convert``, ``refschema``).

Submodules load on first use (``from dgen_tpu_torch.io import ingest``,
or ``dgen_tpu_torch.io.ingest`` after ``import dgen_tpu_torch.io``), so
importing the package loads none of them, and so no pandas.
"""

import importlib

__all__ = (
    "checkpoint", "convert", "export", "hostio", "ingest", "mmaptable", "nem",
    "package", "reference_inputs", "refschema", "store", "synth", "urdb", "workbook",
)


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
