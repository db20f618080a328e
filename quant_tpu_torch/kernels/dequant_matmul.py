"""Fused dequantize + matmul: ``y = x @ dequantize(W)`` for a QTensor ``W``.

The port of the JAX package's ``kernels/dequant_matmul.py``
(``dequant_matmul``). The codes stay packed in device memory (int4: half a
byte per weight) and are unpacked and scaled inside the CUDA kernel
``csrc/dequant_matmul.cu``, whose header note gives its design.

:func:`dequant_matmul` launches that kernel for tensors on the card and
takes the plain version :func:`dequant_matmul_reference` only for tensors on
the CPU: on a CUDA tensor it launches or raises, it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.kernels import _build

__all__ = ["dequant_matmul", "dequant_matmul_reference"]

_BN = 256          # columns per block (csrc/dequant_matmul.cu BN)
_BKP = 64          # packed rows per staged tile (BKP)
_SMS = 132         # streaming multiprocessors of an H100


def dequant_matmul_reference(x: torch.Tensor, qt: QTensor,
                             out_dtype=None) -> torch.Tensor:
    """Plain version: weights dequantized to ``x.dtype`` (bf16 in serving),
    product accumulated in float32, cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    w = qt.dequantize(x.dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y.to(out_dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_plan(m: int, k: int, n: int, bits: int) -> tuple[int, int]:
    """(splits, packed rows per split) of the kernel's split-K: enough
    blocks to cover the card twice at decode M, once at prefill M."""
    kp = k // 2 if bits == 4 else k
    m_tiles = 1 if m <= 8 else _cdiv(m, 64)
    tiles = _cdiv(n, _BN) * m_tiles
    target = 2 * _SMS if m <= 8 else _SMS
    splits = max(1, min(_cdiv(target, tiles), _cdiv(kp, _BKP)))
    per = _cdiv(_cdiv(kp, splits), _BKP) * _BKP
    return _cdiv(kp, per), per


_P, _I = ctypes.c_void_p, ctypes.c_int
# x, x_bf16, codes, scales, out, out_f32, partial, M, K, N, G, bits, splits,
# kp_per_split, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def _launch(x: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    m, k = x.shape
    n = qt.n
    if qt.lut is not None:
        raise NotImplementedError("codebook (lut) QTensors are not ported")
    if qt.bits == 4 and qt.kshards != 1:
        raise NotImplementedError("kshards > 1 (tensor parallel) is not "
                                  "ported")
    if qt.bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {qt.bits}")
    kp = k // 2 if qt.bits == 4 else k
    want = torch.uint8 if qt.bits == 4 else torch.int8
    if qt.codes.dtype != want or tuple(qt.codes.shape) != (kp, n):
        raise ValueError(f"codes must be {want} [{kp}, {n}], got "
                         f"{qt.codes.dtype} {tuple(qt.codes.shape)}")
    if (qt.scales.dtype != torch.float32
            or tuple(qt.scales.shape) != (k // qt.group_size, n)):
        raise ValueError("scales must be float32 [K/G, N]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    for t, what in ((x, "x"), (qt.codes, "codes"), (qt.scales, "scales")):
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if n % 4 or qt.codes.data_ptr() % 4 or qt.scales.data_ptr() % 16:
        raise ValueError("N must be a multiple of 4 and codes / scales "
                         "4 / 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    splits, per = _split_plan(m, k, n, qt.bits)
    partial = None
    if splits > 1 and out_dtype != torch.float32:
        partial = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _build.entry("dequant_matmul", "dequant_matmul_launch", _ARGTYPES)
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
            qt.codes.data_ptr(), qt.scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32),
            None if partial is None else partial.data_ptr(),
            m, k, n, qt.group_size, qt.bits, splits, per, stream)
    _build.check(rc, "dequant_matmul", "dequant_matmul")
    _build.count_launch("dequant_matmul")
    return out


def dequant_matmul(x: torch.Tensor, qt: QTensor, layer: int | None = None,
                   *, out_dtype=None) -> torch.Tensor:
    """``x [.., K] @ QTensor [K, N] -> [.., N]`` in ``out_dtype`` (default
    ``x.dtype``). ``layer`` selects one layer of a stacked ``[L, ...]``
    QTensor as a view of the stack (no copy)."""
    out_dtype = out_dtype or x.dtype
    if qt.stacked:
        if layer is None:
            raise ValueError("stacked QTensor requires a layer index")
        qt = qt.layer(layer)
    elif layer is not None:
        raise ValueError("layer given for an unstacked QTensor")
    k, n = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != K {k}")
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        y = dequant_matmul_reference(x.reshape(-1, k), qt, out_dtype)
        return y.reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return _launch(x.view(-1, k), qt, out_dtype).view(*lead, n)
