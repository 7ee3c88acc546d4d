"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` at first
use, one ``nvcc`` per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/`` beside the package, one file
per hash of the sources, headers and flags (an edited source is
rebuilt), written to a temporary name and renamed, so a concurrent or
interrupted build never leaves a half-written library behind. Each
function takes another ``csrc`` directory too (another checkout's
kernels, built with this checkout's flags); it defaults to this one.

The first use is locked: two threads that reach a kernel at once (the
serving batcher's worker and a caller's thread) build and load the
library once, and two processes that reach the build at once (the
replicas of a serving fleet, booting together) compile it once: the
check-then-compile holds an exclusive file lock beside the library
(``<library>.lock``), and the second process finds the first one's
library when it gets the lock. :data:`EVENTS` counts the libraries this
process compiled and loaded; a serving process reports both since its
warmup, where they stay 0 (the port's counterpart of the JAX package's
steady-state compile count).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
LINK_FLAGS = ["-shared"]

#: ``builds``: libraries compiled with nvcc in this process; ``loads``:
#: libraries opened with ctypes
EVENTS = {"builds": 0, "loads": 0}
_LOCK = threading.RLock()
_BUILT: dict = {}
_LIBS: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_OFFS = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # load, gen, sell, period, scales, offsets[13], out_imp, out_sell_imp,
    # out_sgn, out_sell_sgn, n, r, n_lanes, n_periods, with_signed, the
    # dtype codes of load, gen and sell, stream
    "bucket_sums_month": [_P] * 5 + [_OFFS] + [_P] * 4 + [_I] * 8 + [_P],
    # ..., scales per thread, stream
    "bucket_sums_month_spt": [_P] * 5 + [_OFFS] + [_P] * 4 + [_I] * 9 + [_P],
    "bucket_sums_stream": [_P] * 5 + [_OFFS] + [_P] * 4 + [_I] * 8 + [_P],
    # load, gen, sell_a, period_a, sell_b, period_b, scales, offsets[13],
    # out_a, out_sell_a, out_b, out_sell_b, n, r, n_lanes, n_periods, the
    # three dtype codes, stream
    "bucket_sums_month_pair": [_P] * 7 + [_OFFS] + [_P] * 4 + [_I] * 7 + [_P],
    # load, gen, sell, bucket, scales, out_imp, out_sell_imp, out_sgn,
    # out_sell_sgn, n, r, hours, n_periods, with_signed, the three dtype
    # codes, stream
    "bucket_sums_dot": [_P] * 9 + [_I] * 8 + [_P],
    # the micro-benchmark's variants: load, gen, sell, bucket, scales,
    # offsets[13], out_imp, out_sell_imp, n, r, n_periods, ..., stream
    "microbench_monthmask": [_P] * 5 + [_OFFS] + [_P] * 2 + [_I] * 3 + [_P],
    # ..., g_block, stream
    "microbench_monthmask_g": [_P] * 5 + [_OFFS] + [_P] * 2 + [_I] * 4 + [_P],
    "microbench_monthdot": [_P] * 5 + [_OFFS] + [_P] * 2 + [_I] * 3 + [_P],
    # ..., b_pad, h_chunk, build, dot, net, m_hbm, stream
    "microbench_variant": [_P] * 5 + [_OFFS] + [_P] * 2 + [_I] * 8 + [_P] * 2,
    # load, gen, m, scales, offsets[13], out_imp, out_sell_imp, n, r,
    # n_periods, c_pad, (hi,) stream
    "microbench_monthdot_pre": [_P] * 4 + [_OFFS] + [_P] * 2 + [_I] * 4 + [_P],
    "microbench_mnet": [_P] * 4 + [_OFFS] + [_P] * 2 + [_I] * 5 + [_P],
    # load, gen, batt_kw, batt_kwh, soc_min, soc_init, eta, system_out,
    # soc, charge, discharge, n, hours, stream
    "battery_dispatch": [_P] * 11 + [_I] * 2 + [_P],
}

#: template arguments of the kernels that have any, in order: the name
#: and, for an integer that selects a form, the forms' names (a bool
#: prints as its name when true; type arguments print as their dtype)
_TEMPLATE_ARGS = {
    "month_kernel": (("signed", ()), ("spt", ())),
    "stream_kernel": (("signed", ()), ("spt", ()), ("drop_zeros", ())),
    "month_pair_kernel": (("spt", ()), ("drop_zeros", ())),
    "dot_kernel": (("signed", ()), ("col_tiles", ())),
    "variant_kernel": (("build", ("onehot", "const", "hbm")),
                       ("dot", ("dot", "none")), ("net", ("fma", "bcast")),
                       ("col_tiles", ())),
    "monthdot_kernel": (("col_tiles", ()),),
    "mask_product_kernel": (("mode", ("monthdot_pre", "mnet", "mnet_hi")),
                            ("col_tiles", ())),
}
#: mangled type arguments -> dtype names (a later bfloat16 argument is a
#: substitution, S<n>_, of the first)
_TYPE_ARGS = {"f": "f32", "a": "i8", "13__nv_bfloat16": "bf16", "i": "i32"}


def sources(csrc: str | None = None) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc or CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(csrc: str | None = None) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(csrc or CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"bucket_sums-{h.hexdigest()[:12]}.so")


_TARG = r"L[a-z]n?\d+E|13__nv_bfloat16|S\w*?_|[fai]"


def _kernel_label(mangled: str) -> str:
    """``name<arg,...>`` of a mangled kernel name: the function's own
    name and its template arguments. Integral ones (``Lb1E`` = true,
    ``Li2E`` = 2, ``Lin1E`` = -1) are named after :data:`_TEMPLATE_ARGS`
    (``variant_kernel<build=hbm,dot=dot,net=fma>``); a bool prints as its
    name when true and as nothing when false (``month_kernel<signed>``,
    ``month_kernel``); a type prints as its dtype
    (``month_kernel<signed,bf16,f32,bf16,f32>``: load, gen, sell, sums)."""
    found = re.search(rf"\d+([a-z_]+_kernel)(?:I((?:{_TARG})+)E)?", mangled)
    if not found:
        return mangled
    name, targs = found.groups()
    if not targs:
        return name
    names = _TEMPLATE_ARGS.get(name, ())
    parts = []
    for i, tok in enumerate(re.findall(_TARG, targs)):
        lit = re.fullmatch(r"L([a-z])(n?)(\d+)E", tok)
        if lit is None:
            parts.append(_TYPE_ARGS.get(tok, "bf16"))
            continue
        kind, neg, num = lit.groups()
        v = -int(num) if neg else int(num)
        arg, forms = names[i] if i < len(names) else (None, ())
        if kind == "b" and arg:
            if v:
                parts.append(arg)
            continue
        shown = forms[v] if 0 <= v < len(forms) else v
        parts.append(f"{arg}={shown}" if arg else str(shown))
    return f"{name}<{','.join(parts)}>" if parts else name


def kernel_resources(log: str) -> list[dict]:
    """Per kernel, from ``ptxas -v`` output: its name (template arguments
    included), registers, spill bytes (stores + loads) and static shared
    memory bytes."""
    rows: list[dict] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            label = _kernel_label(entry.group(1))
            rows.append(dict(kernel=label, registers=None, spill_bytes=0,
                             smem_bytes=0))
            continue
        if not rows:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            rows[-1]["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows[-1]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def _compile(srcs: list[str], path: str) -> str:
    """Compiles ``srcs`` (one nvcc each, all started together), links the
    objects into the library at ``path`` (a temporary name, then a
    rename) and returns the compiler log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", src, "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [src for src, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return log


@contextlib.contextmanager
def _process_lock(path: str):
    """An exclusive lock on the file ``path`` (made if missing), held across
    processes; the system releases it when its holder dies."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(csrc: str | None = None) -> tuple[str, float, str]:
    """(library path, build seconds, compiler log). Compiles only when the
    library for these sources is missing; seconds is 0.0 then. Once per
    process and ``csrc``, under the module lock, and once across processes,
    under the library's file lock."""
    with _LOCK:
        done = _BUILT.get(csrc)
        if done is not None:
            return done
        path = library_path(csrc)
        if os.path.exists(path):
            done = (path, 0.0, "")
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            with _process_lock(path + ".lock"):
                if os.path.exists(path):   # another process built it meanwhile
                    done = (path, 0.0, "")
                else:
                    t0 = time.perf_counter()
                    log = _compile(sources(csrc), path)
                    EVENTS["builds"] += 1
                    for row in kernel_resources(log):
                        logger.info("%s: %s registers, %d bytes spilled, %d bytes "
                                    "static shared memory", row["kernel"],
                                    row["registers"], row["spill_bytes"],
                                    row["smem_bytes"])
                    done = (path, time.perf_counter() - t0, log)
        _BUILT[csrc] = done
        return done


def _open(path: str) -> ctypes.CDLL:
    """The library at ``path``, its C entries typed (those of
    :data:`_SIGNATURES` that it has)."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(csrc: str | None = None) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process
    and ``csrc``: the first use is locked, later calls read a dict)."""
    lib = _LIBS.get(csrc)
    if lib is not None:
        return lib
    with _LOCK:
        if csrc not in _LIBS:
            path, _, _ = build(csrc)
            _LIBS[csrc] = _open(path)
            EVENTS["loads"] += 1
        return _LIBS[csrc]
