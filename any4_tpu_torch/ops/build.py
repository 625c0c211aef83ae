"""Build the CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` is compiled on first use into a shared library with
a plain C interface under ``any4_tpu_torch/_build/``, named after the hash of
its source, so an edited source is rebuilt and an unchanged one is loaded as
it is. Nothing is compiled when the package is imported.

The compiler is ``$CUDA_HOME/bin/nvcc`` (``/usr/local/cuda`` by default) or
the first ``nvcc`` on ``PATH``. A missing compiler or a failed build raises:
there is no fallback.

Every build writes a file private to its process and thread and renames it
into place (:func:`compile_into`), so processes that start on a cold
``_build/`` at once (the ranks of a tensor-parallel run) each load a whole
library, whichever finishes first.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# the tensor-core kernels (A, B, C, E, int8_post, int8_fused, D and w8a8):
#     int fn(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size,
#     num_groups, lut_stride, out_dtype, tn, folds_per_split, split_blocks,
#     scratch, counters, stream)
_POST_ARGTYPES = [_P] * 6 + [_I] * 11 + [_P] * 3
# the fused W4A8/W8A8 kernels, on the same bodies: the same, then x_dtype
_A8_FUSED_ARGTYPES = _POST_ARGTYPES + [_I]
# int fn(q, k, ks, v, vs, seq_lens, table, out, b, h, rep, d, tokens, ps,
#        pps, max_ctx, ctx_bucket, scale, pool_dtype, q_dtype, split, scratch,
#        counters, stream)
_FLASH_ARGTYPES = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _I, _I, _I, _P, _P, _P]
KERNELS = {
    "q4_lut_gemv.cu": {
        name: _POST_ARGTYPES for name in (
            "q4_lut_post", "q4_lut_fused", "q4_int4_magic", "q4_lut_select",
            "int8_post", "int8_fused")},
    "w4a8_gemv.cu": {"w4a8": _POST_ARGTYPES, "w8a8": _POST_ARGTYPES,
                     "w4a8_fused": _A8_FUSED_ARGTYPES,
                     "w8a8_fused": _A8_FUSED_ARGTYPES},
    "flash_decode.cu": {**{name: _FLASH_ARGTYPES for name in (
        "flash_paged_decode", "flash_paged_decode_q8",
        "flash_contig_decode", "flash_contig_decode_q8")},
        # int fn(pool_dtype, paged, rep, d, split, ps): shared-memory bytes
        "flash_decode_smem_bytes": [_I] * 6},
}

_libs: Dict[str, ctypes.CDLL] = {}
# source -> nvcc's ``-Xptxas=-v`` report of its last verbose build
PTXAS_REPORTS: Dict[str, str] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def compile_into(out: str, cmd: list) -> subprocess.CompletedProcess:
    """Run the compiler command ``cmd`` with ``-o`` a file private to this
    process and thread, and on success rename it to ``out`` (atomic on one
    file system: a reader sees no library or a whole one). Returns the
    finished process; a failed build leaves ``out`` as it was."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
        return proc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def compile_source(source: str, verbose: bool = False) -> str:
    """Compile ``csrc/<source>`` unless its library exists; returns its
    path. Safe to call from several processes (:func:`compile_into`)."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    cmd = [nvcc_path(), *NVCC_FLAGS, os.path.join(CSRC_DIR, source)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = compile_into(out, cmd)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        PTXAS_REPORTS[source] = proc.stdout + proc.stderr
        print(proc.stdout + proc.stderr)
    return out


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        futures = {src: pool.submit(compile_source, src, verbose)
                   for src in KERNELS}
        return {src: f.result() for src, f in futures.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built if needed, with
    ``argtypes`` and ``restype`` set for each of its entry points."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(compile_source(source))
            for name, argtypes in KERNELS[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib
