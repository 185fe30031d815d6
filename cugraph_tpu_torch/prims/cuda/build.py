"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``build/cugraph_tpu_torch/lib<name>-<hash>.so`` at the
root of the checkout, keyed by a hash of the source and the flags, and
loaded with ``ctypes``. ``build()`` starts one ``nvcc`` per missing library,
all at once, and waits for them. Nothing is built when a module is
imported: the first launch builds what it needs. A first load is a
``cgt/setup.kernel_load.<name>`` set-up span, and each nvcc run a
``cgt/setup.nvcc.<name>`` one, from the start of the build to its end
(``utils/timer.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from ...utils.timer import record_setup_span, span

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cugraph_tpu_torch"
SOURCES = ("spmv", "spmm_row", "scan", "assemble", "probes")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The C interface of each library: every pointer and the stream are
# c_void_p, so ctypes never cuts them to 32 bits.
_VP, _INT, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "spmv": {
        # offsets, minors, weights, x, tile_row, tile_edge, carry, y, tiles,
        # items_per_thread, accumulate, stream (both)
        "cgt_spmv_sum": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
        "cgt_spmv_minplus": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    },
    "spmm_row": {
        # offsets, minors, weights, x, x_bf16, x elements, tile_row,
        # tile_edge, carry, y, tiles, items_per_tile, f, bf16, vec4, stream
        "cgt_spmm_rows": [_VP, _VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP, _VP, _INT, _I64,
                          _INT, _INT, _INT, _VP],
        # offsets, majors, minors, weights, x, tile_row, tile_edge, carry, y,
        # tiles, items_per_tile, f, lanes, vec, bf16, stream
        "cgt_spmm_rows_narrow": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _I64, _INT,
                                 _INT, _INT, _INT, _VP],
    },
    "scan": {
        # x, y, status words, n, stream
        "cgt_cumsum_flat": [_VP, _VP, _VP, _I64, _VP],
    },
    "assemble": {
        # binned, chunk_src, chunk_dst, inv, out, host_flag, indexed event,
        # n_steps, in_chunks, out_chunks, vec_per_chunk, ids64, stream
        "cgt_assemble_chunks": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                                _INT, _VP],
        # out: the new event
        "cgt_assemble_event": [ctypes.POINTER(_VP)],
    },
    "probes": {
        # x, o, n, a, vec, stream
        "cgt_stream_scale": [_VP, _VP, _I64, _F32, _INT, _VP],
        # table, ids, out, n_rows, row_bytes, vec_bytes, stream
        "cgt_gather_rows": [_VP, _VP, _VP, _I64, _INT, _INT, _VP],
        # table, srcs, dstl, out, n_windows, width, edges_per_window, stream
        "cgt_gather_window_sum": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
        # wstart, vals, gdl, out, n_windows, stream
        "cgt_multiwin_reduce": [_VP, _VP, _VP, _VP, _INT, _VP],
        # v, flags, out, rows, width, stream
        "cgt_seg_scan_rows": [_VP, _VP, _VP, _I64, _INT, _VP],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process each, all started together. Returns the seconds it took; the
    compiler's report (registers, spills) goes to ``<library>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        report, _ = proc.communicate()
        record_setup_span(f"cgt/setup.nvcc.{name}", t0, time.perf_counter())
        out.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{report}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with argtypes and restype set on each of its functions."""
    lib = _loaded.get(name)
    if lib is None:
        with span(f"cgt/setup.kernel_load.{name}", setup=True):
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = _INT
        _loaded[name] = lib
    return lib


def compiler_report(name: str) -> str:
    """What nvcc said when it built ``name`` (empty if it was not built
    in this checkout)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
