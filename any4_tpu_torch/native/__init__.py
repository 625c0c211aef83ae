"""The host-side data plane (C++ with OpenMP, loaded through ctypes): the
port's counterpart of ``any4_tpu/native``, with its own copy of the source.

``any4_native.cpp`` is compiled at first use with the first of ``g++``,
``c++`` and ``clang++`` on ``PATH`` into ``any4_tpu_torch/_build/``, named
after a hash of the source, the compiler and its flags (without OpenMP if
the compiler has none), and renamed into place so that processes starting
together each load a whole library (:func:`..ops.build.compile_into`).
Nothing is built when the module is imported.

:func:`available` is False only when no compiler is found; a compiler that
fails to build raises. Callers (``ops.linear.quantize_tensor`` on numpy
input, ``cli/quantize.py``) take the torch path when it is False.

The functions take and return numpy arrays:

- :func:`pack_int4` / :func:`unpack_int4`: 4-bit codes to and from the
  port's Hopper layout (``ops.packing.pack_codes``: 8 consecutive k a
  word, nibble ``k % 8``), each of ``shards`` k segments padded on its own;
- :func:`group_quantize`: ``ops.quant.group_quantize``'s asymmetric
  quantization, bit for bit;
- :func:`lut_assign`: nearest-entry codes against a per-row 16-entry LUT;
- :func:`bf16_to_f32`: raw bf16 bits widened to float32;
- :func:`num_threads`: OpenMP's thread count (1 without OpenMP).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from typing import Optional

import numpy as np

from ..ops import build, packing

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "any4_native.cpp")
COMPILERS = ("g++", "c++", "clang++")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def compiler() -> Optional[str]:
    """The first C++ compiler on ``PATH``, or None."""
    for cc in COMPILERS:
        path = shutil.which(cc)
        if path is not None:
            return path
    return None


def _library_path(cc: str, flags: list) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join([cc, *flags]).encode())
    return os.path.join(build.BUILD_DIR,
                        f"libany4_native_{digest.hexdigest()[:16]}.so")


def _build(cc: str) -> str:
    """The library's path, compiled if needed: with OpenMP, else without;
    raises if neither builds."""
    errors = []
    for flags in ([*FLAGS, "-fopenmp"], FLAGS):
        out = _library_path(cc, flags)
        if os.path.exists(out):
            return out
        proc = build.compile_into(out, [cc, *flags, SOURCE])
        if proc.returncode == 0:
            return out
        errors.append(proc.stdout + proc.stderr)
    raise RuntimeError(f"{cc} failed to build {SOURCE}:\n" + "\n".join(errors))


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cc = compiler()
        if cc is None:
            return None
        lib = ctypes.CDLL(_build(cc))
        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        for name, args in (
                ("pack_int4_rows", [u8p, i32p, i64, i64, i64]),
                ("unpack_int4_rows", [i32p, u8p, i64, i64, i64]),
                ("group_quantize_f32", [f32p, i64, i64, i64, ctypes.c_int,
                                        u8p, f32p, f32p]),
                ("lut_assign_rows", [f32p, f32p, u8p, i64, i64]),
                ("bf16_to_f32", [u16p, f32p, i64])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        lib.native_num_threads.argtypes = []
        lib.native_num_threads.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Is the data plane usable? False only when no compiler is found."""
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("no C++ compiler found (g++, c++ or clang++); the "
                           "native data plane is unavailable")
    return lib


def num_threads() -> int:
    lib = _load()
    return lib.native_num_threads() if lib is not None else 0


def _shard_len(k: int, shards: int) -> int:
    if shards < 1 or k % shards:
        raise ValueError(f"k={k} is not divisible by shards={shards}")
    return k // shards


def pack_int4(codes: np.ndarray, shards: int = 1) -> np.ndarray:
    """uint8 codes ``[n, k]`` -> int32 ``[n, shards * padded_k(k/shards) /
    8]``, as ``ops.packing.pack_codes(codes, shards)``."""
    lib = _need()
    codes = np.ascontiguousarray(codes, np.uint8)
    n, k = codes.shape
    ks = _shard_len(k, shards)
    out = np.empty((n, shards * packing.padded_k(ks)
                    // packing.CODES_PER_WORD), np.int32)
    lib.pack_int4_rows(codes, out, n, k, shards)
    return out


def unpack_int4(packed: np.ndarray, k: int, shards: int = 1) -> np.ndarray:
    """Inverse of :func:`pack_int4`: uint8 codes ``[n, k]``."""
    lib = _need()
    packed = np.ascontiguousarray(packed, np.int32)
    n = packed.shape[0]
    ks = _shard_len(k, shards)
    if packed.shape[1] != shards * packing.padded_k(ks) \
            // packing.CODES_PER_WORD:
        raise ValueError(f"packed {packed.shape} does not hold k={k} in "
                         f"{shards} shards")
    out = np.empty((n, k), np.uint8)
    lib.unpack_int4_rows(packed, out, n, k, shards)
    return out


def group_quantize(w: np.ndarray, bits: int = 4, group_size: int = 128):
    """f32 ``[n, k]`` -> ``(codes uint8 [n, k], scales f32 [n, k/g], zeros
    f32 [n, k/g])``, as ``ops.quant.group_quantize`` (asymmetric)."""
    lib = _need()
    w = np.ascontiguousarray(w, np.float32)
    n, k = w.shape
    if group_size < 1 or k % group_size:
        raise ValueError(f"k={k} is not a multiple of group_size="
                         f"{group_size}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    codes = np.empty((n, k), np.uint8)
    scales = np.empty((n, k // group_size), np.float32)
    zeros = np.empty((n, k // group_size), np.float32)
    lib.group_quantize_f32(w, n, k, group_size, bits, codes, scales, zeros)
    return codes, scales, zeros


def lut_assign(wg: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Codes ``[n, k]`` of the nearest entry of each row's LUT ``[n, 16]``
    (the lower index among equal distances)."""
    lib = _need()
    wg = np.ascontiguousarray(wg, np.float32)
    lut = np.ascontiguousarray(lut, np.float32)
    n, k = wg.shape
    if lut.shape != (n, 16):
        raise ValueError(f"lut must be [{n}, 16], got {lut.shape}")
    codes = np.empty((n, k), np.uint8)
    lib.lut_assign_rows(wg, lut, codes, n, k)
    return codes


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """Raw bf16 bits (any 2-byte dtype) -> float32, flattened."""
    lib = _need()
    raw = np.ascontiguousarray(raw)
    if raw.dtype.itemsize != 2:
        raise ValueError(f"bf16 bits are 2 bytes, got {raw.dtype}")
    raw = raw.view(np.uint16).reshape(-1)
    out = np.empty(raw.shape, np.float32)
    lib.bf16_to_f32(raw, out, raw.size)
    return out
