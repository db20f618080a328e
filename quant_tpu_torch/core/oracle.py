"""ctypes binding to the C++ codec oracle ``cpp/quantref.cpp``.

The oracle is the bit-exactness contract of the codec (``cpp/quantref.h``).
The port builds its own copy of the library from the repository's sources
with the host's C++ compiler, on first use, into the port's build directory
(``quant_tpu_torch/csrc/build/libquantref-<hash>.so``; the name hashes the
sources and the flags, so an edited source is rebuilt)::

    g++ -O2 -std=c++17 -fPIC -shared -o csrc/build/libquantref-<hash>.so \
        cpp/quantref.cpp

A copy of the JAX package's ``core/oracle.py`` binding (the port imports
nothing of that package), codebook functions (``nf4_table``,
``quantize_lut``, ``quantize_lut_grouped``, ``dequantize_lut``) included.
The checkpoint coder uses
:func:`entropy_encode` / :func:`entropy_decode` when :func:`available`;
foreign calls release the GIL, so blobs decode in parallel threads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

__all__ = ["OracleUnavailable", "build", "available", "quantize",
           "quantize_grouped", "dequantize", "pack_int4", "unpack_int4",
           "mse", "entropy_encode", "entropy_decode", "nf4_table",
           "quantize_lut", "quantize_lut_grouped", "dequantize_lut"]

_CPP_DIR = pathlib.Path(__file__).resolve().parents[2] / "cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "build"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


class OracleUnavailable(RuntimeError):
    pass


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in ("quantref.cpp", "quantref.h"):
        h.update((_CPP_DIR / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libquantref-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``cpp/quantref.cpp`` into the port's build directory unless
    a current library is there; returns its path."""
    try:
        out = _lib_path()
    except OSError as e:
        raise OracleUnavailable(f"no oracle sources: {e}") from e
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OracleUnavailable("no C++ compiler (g++) found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp),
                        str(_CPP_DIR / "quantref.cpp")],
                       check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise OracleUnavailable(f"cannot build libquantref: {e}\n"
                                f"{detail}") from e
    os.replace(tmp, out)    # atomic: parallel builders never see a stub
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    sigs = {
        "qr_quantize": (ctypes.c_int, [f32p, i64, ctypes.c_int, f32p, i8p]),
        "qr_quantize_grouped": (ctypes.c_int, [f32p, i64, i64, ctypes.c_int,
                                               i64, f32p, i8p]),
        "qr_dequantize": (None, [i8p, i64, ctypes.c_float, f32p]),
        "qr_quantize_lut": (ctypes.c_int, [f32p, i64, f32p, f32p, i8p]),
        "qr_quantize_lut_grouped": (ctypes.c_int, [f32p, i64, i64, i64, f32p,
                                                   f32p, i8p]),
        "qr_dequantize_lut": (None, [i8p, i64, f32p, ctypes.c_float, f32p]),
        "qr_pack_int4": (i64, [i8p, i64, u8p]),
        "qr_unpack_int4": (i64, [u8p, i64, i8p]),
        "qr_mse": (ctypes.c_double, [f32p, f32p, i64]),
        "qr_entropy_bound": (i64, [i64]),
        "qr_entropy_encode": (i64, [u8p, i64, u8p, i64]),
        "qr_entropy_decode": (i64, [u8p, i64, u8p, i64]),
        "qr_entropy_decoded_size": (i64, [u8p, i64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        _lib()
        return True
    except (OracleUnavailable, OSError):
        return False


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def quantize(x: np.ndarray, bits: int) -> tuple[np.ndarray, float]:
    """Per-tensor codes (int8, flat) and scale."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    codes = np.empty(x.size, dtype=np.int8)
    scale = ctypes.c_float()
    rc = _lib().qr_quantize(_f32p(x), x.size, bits, ctypes.byref(scale),
                            _i8p(codes))
    if rc:
        raise ValueError(f"qr_quantize failed: rc={rc}")
    return codes, scale.value


def quantize_grouped(x: np.ndarray, bits: int,
                     group_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Codes of ``x``'s shape and one scale per (row, last-axis group)."""
    x2 = np.ascontiguousarray(x, dtype=np.float32)
    rows = int(np.prod(x2.shape[:-1])) if x2.ndim > 1 else 1
    cols = x2.shape[-1]
    codes = np.empty(x2.size, dtype=np.int8)
    scales = np.empty(rows * (cols // group_size), dtype=np.float32)
    rc = _lib().qr_quantize_grouped(_f32p(x2.reshape(-1)), rows, cols, bits,
                                    group_size, _f32p(scales), _i8p(codes))
    if rc:
        raise ValueError(f"qr_quantize_grouped failed: rc={rc}")
    return (codes.reshape(x2.shape),
            scales.reshape(*x2.shape[:-1], cols // group_size))


def dequantize(codes: np.ndarray, scale: float) -> np.ndarray:
    c = np.ascontiguousarray(codes, dtype=np.int8).reshape(-1)
    out = np.empty(c.size, dtype=np.float32)
    _lib().qr_dequantize(_i8p(c), c.size, scale, _f32p(out))
    return out.reshape(np.shape(codes))


def nf4_table() -> np.ndarray:
    """The oracle's normative 16-entry NF4 codebook (``QR_NF4_TABLE``)."""
    tbl = (ctypes.c_float * 16).in_dll(_lib(), "QR_NF4_TABLE")
    return np.array(tbl, dtype=np.float32)


def quantize_lut(x: np.ndarray, lut: np.ndarray) -> tuple[np.ndarray, float]:
    """Per-tensor codebook codes (int8 ``code = index - 8``, flat) and the
    scale (the absmax)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    lut = np.ascontiguousarray(lut, dtype=np.float32)
    codes = np.empty(x.size, dtype=np.int8)
    scale = ctypes.c_float()
    rc = _lib().qr_quantize_lut(_f32p(x), x.size, _f32p(lut),
                                ctypes.byref(scale), _i8p(codes))
    if rc:
        raise ValueError(f"qr_quantize_lut failed: rc={rc}")
    return codes, scale.value


def quantize_lut_grouped(x: np.ndarray, lut: np.ndarray,
                         group_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Codebook codes of ``x``'s shape and one scale per (row, last-axis
    group)."""
    x2 = np.ascontiguousarray(x, dtype=np.float32)
    lut = np.ascontiguousarray(lut, dtype=np.float32)
    rows = int(np.prod(x2.shape[:-1])) if x2.ndim > 1 else 1
    cols = x2.shape[-1]
    codes = np.empty(x2.size, dtype=np.int8)
    scales = np.empty(rows * (cols // group_size), dtype=np.float32)
    rc = _lib().qr_quantize_lut_grouped(_f32p(x2.reshape(-1)), rows, cols,
                                        group_size, _f32p(lut),
                                        _f32p(scales), _i8p(codes))
    if rc:
        raise ValueError(f"qr_quantize_lut_grouped failed: rc={rc}")
    return (codes.reshape(x2.shape),
            scales.reshape(*x2.shape[:-1], cols // group_size))


def dequantize_lut(codes: np.ndarray, lut: np.ndarray,
                   scale: float) -> np.ndarray:
    """``lut[code + 8] * scale`` (float32 multiply), codes' shape."""
    c = np.ascontiguousarray(codes, dtype=np.int8).reshape(-1)
    lut = np.ascontiguousarray(lut, dtype=np.float32)
    out = np.empty(c.size, dtype=np.float32)
    _lib().qr_dequantize_lut(_i8p(c), c.size, _f32p(lut), scale, _f32p(out))
    return out.reshape(np.shape(codes))


def pack_int4(codes: np.ndarray) -> np.ndarray:
    """At-rest nibble pairs: byte j = u(code[2j]) | u(code[2j+1]) << 4."""
    c = np.ascontiguousarray(codes, dtype=np.int8).reshape(-1)
    out = np.empty((c.size + 1) // 2, dtype=np.uint8)
    _lib().qr_pack_int4(_i8p(c), c.size, _u8p(out))
    return out


def unpack_int4(packed: np.ndarray, n: int) -> np.ndarray:
    p = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    out = np.empty(n, dtype=np.int8)
    _lib().qr_unpack_int4(_u8p(p), n, _i8p(out))
    return out


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
    b = np.ascontiguousarray(b, dtype=np.float32).reshape(-1)
    return _lib().qr_mse(_f32p(a), _f32p(b), a.size)


def entropy_encode(data: bytes | np.ndarray) -> bytes:
    """QREF frame of a byte stream (byte-equal to ``core.entropy.encode``)."""
    arr = (np.frombuffer(bytes(data), dtype=np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.ascontiguousarray(data, dtype=np.uint8).reshape(-1))
    lib = _lib()
    cap = lib.qr_entropy_bound(arr.size)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.qr_entropy_encode(_u8p(arr), arr.size, _u8p(out), cap)
    if n < 0:
        raise ValueError("qr_entropy_encode failed")
    return out[:n].tobytes()


def entropy_decode(comp: bytes) -> bytes:
    c = np.frombuffer(comp, dtype=np.uint8)
    lib = _lib()
    size = lib.qr_entropy_decoded_size(_u8p(c), c.size)
    if size < 0:
        raise ValueError("bad QREF frame")
    out = np.empty(max(size, 1), dtype=np.uint8)
    n = lib.qr_entropy_decode(_u8p(c), c.size, _u8p(out), size)
    if n < 0:
        raise ValueError("qr_entropy_decode failed")
    return out[:n].tobytes()
