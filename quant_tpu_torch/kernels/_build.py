"""Build the CUDA sources under ``csrc/`` and bind them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into its own shared library, one ``nvcc`` process per source, all started
together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a finished build is reused. Pointers and the CUDA
stream go to the C functions as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launch and :func:`check` raises on a
non-zero code.

The launch counters live here: each kernel wrapper adds one to its count
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "entry", "check",
           "launches", "reset_launches", "count_launch", "zero_counters"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("dequant_matmul", "dequant_matmul_cc", "cache_insert",
           "flash_decode", "mla_attention", "unpack")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# kernel name -> launches since the last reset_launches(); the matmul
# kernels also count each launch under the tile that served it,
# "<kernel>[<tile>]", the decode-attention kernels under their path
# ("tc": tensor cores for bf16 q, "cuda_core"; the GQA pair's calls with a
# sliding window or a logit softcap also under "[window]" / "[softcap]"),
# and the inserts under
# "[fused]" (RoPE and K/V quantization in the same launch; the MLA latent's
# RMSNorm too); the GQA decode and insert calls over the int4 head-pair
# cache also under "[kv4]"; the MLA pair's calls over the paged latent pool
# also under "[paged]"; the matmuls of a codebook weight under
# "dequant_matmul[lut_word4]" / "[lut_sel15]" and those with int8
# activations under "dequant_matmul[aq]", whose x pre-pass counts as
# "act_quant_int8"; the MoE kernel's grouped launches (the capacity
# dispatch) under "dequant_matmul_moe[grouped]" and its int8-activation ones
# under "dequant_matmul_moe[aq]"
launches: dict[str, int] = {"dequant_matmul": 0, "dequant_matmul_moe": 0,
                            "act_quant_int8": 0,
                            "cache_insert_int8": 0, "flash_decode_int8": 0,
                            "paged_cache_insert_int8": 0,
                            "paged_flash_decode_int8": 0,
                            "mla_cache_insert_int8": 0,
                            "mla_flash_decode_int8": 0,
                            "unpack_int4_device": 0}
launches.update({f"{k}[{tile}]": 0
                 for k in ("dequant_matmul", "dequant_matmul_moe")
                 for tile in ("tc_decode", "tc_prefill", "cuda_core")})
launches.update({f"{k}[{path}]": 0
                 for k in ("flash_decode_int8", "paged_flash_decode_int8",
                           "mla_flash_decode_int8")
                 for path in ("tc", "cuda_core")})
launches.update({f"{k}[{opt}]": 0
                 for k in ("flash_decode_int8", "paged_flash_decode_int8")
                 for opt in ("window", "softcap", "kv4")})
launches.update({f"{k}[fused]": 0
                 for k in ("cache_insert_int8", "paged_cache_insert_int8",
                           "mla_cache_insert_int8")})
launches.update({f"{k}[kv4]": 0
                 for k in ("cache_insert_int8", "paged_cache_insert_int8")})
launches.update({f"{k}[paged]": 0
                 for k in ("mla_cache_insert_int8", "mla_flash_decode_int8")})
launches.update({f"dequant_matmul[{v}]": 0
                 for v in ("lut_word4", "lut_sel15", "aq")})
launches.update({f"dequant_matmul_moe[{v}]": 0 for v in ("grouped", "aq")})

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_counters: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def zero_counters(device, n: int):
    """At least ``n`` int32 zeros on ``device``: the per-output-tile
    counters of the kernels whose last block merges the partial results
    (``dequant_matmul``'s tensor-core tiles, the decode-attention kernels).
    A kernel leaves them zero, so one buffer serves every call on the
    stream."""
    import torch

    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str, extra: tuple[str, ...]) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every source of ``names`` that has no current library, one
    ``nvcc`` each, all at once. Returns {name: {"seconds", "log"}} for the
    sources compiled now (``verbose`` adds ``-Xptxas -v`` and keeps its
    register / shared-memory report in "log"). Raises on a failed build."""
    extra = ("-Xptxas", "-v") if verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name, ())
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"{name}.cu (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use, with
    the argument types of its ``error_string`` declared."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name, ())
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with ``argtypes``
    declared (``c_void_p`` for pointers and the stream: undeclared, ctypes
    would pass a Python int as a 32-bit C int and cut the pointer) and an
    ``int`` (cudaError_t) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str, name: str) -> None:
    """Raise with the CUDA error's name when an entry point of
    ``csrc/<name>.cu`` returned one."""
    if rc != 0:
        msg = load(name).error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc}: "
                           f"{msg})")
