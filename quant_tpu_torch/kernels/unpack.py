"""On-device unpack of split-K int4 codes (a verification utility).

The port of the JAX package's ``kernels/unpack.py``. As there, the load
path does not use it: the checkpoint loader keeps int4 codes packed on the
card and ``dequant_matmul`` unpacks nibbles in its own tiles, so unpacked
codes never exist densely in device memory. This kernel proves the split-K
layout of packed weights on the card independently of the matmul
(:func:`check_int4_layout`): a loaded checkpoint's codes, unpacked here,
must equal the host codec's unpack of the same bytes.

Layout contract (``core/codec.py`` ``pack_int4_matmul``): ``packed[i, n]``
holds code ``(i, n)`` in the low nibble and ``(i + K/2, n)`` in the high
nibble, biased by +8. The CUDA kernel is in ``csrc/unpack.cu``; the wrapper
launches it for tensors on the card and takes the plain version
(:func:`unpack_int4_reference`) only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quant_tpu_torch.kernels import _build

__all__ = ["unpack_int4_device", "unpack_int4_reference",
           "unpack_int4_host", "check_int4_layout"]


def unpack_int4_reference(packed: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[K/2, N]`` uint8 -> ``[K, N]`` int8 codes, with the
    kernel's bit operations (low nibble - 8, then high nibble - 8)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=0)


# packed, out, packed bytes, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p]


def unpack_int4_device(packed: torch.Tensor) -> torch.Tensor:
    """``[K/2, N]`` uint8 split-K packed -> ``[K, N]`` int8 codes on the
    tensor's device (a new tensor)."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"expected uint8 [K/2, N], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return unpack_int4_reference(packed)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("packed codes must be contiguous")
    k2, n = packed.shape
    out = torch.empty((2 * k2, n), dtype=torch.int8, device=packed.device)
    if packed.numel() == 0:
        return out
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    fn = _build.entry("unpack", "unpack_int4_launch", _ARGTYPES)
    rc = fn(packed.data_ptr(), out.data_ptr(), packed.numel(), stream)
    _build.check(rc, "unpack_int4_device", "unpack")
    _build.count_launch("unpack_int4_device")
    return out


def unpack_int4_host(packed: np.ndarray) -> np.ndarray:
    """The host codec's unpack of split-K ``[K/2, N]`` bytes: the C++
    oracle's at-rest ``unpack_int4`` (flat nibble pairs: byte j's low and
    high nibbles are codes 2j and 2j+1) read as the split-K layout when the
    oracle builds, else the numpy ``codec.unpack_int4_matmul``."""
    from quant_tpu_torch.core import codec, oracle

    if not oracle.available():
        return codec.unpack_int4_matmul(packed)
    k2, n = packed.shape
    pairs = oracle.unpack_int4(packed, 2 * packed.size).reshape(k2, n, 2)
    return np.concatenate([pairs[..., 0], pairs[..., 1]], axis=0)


def check_int4_layout(codes: torch.Tensor) -> None:
    """Raise unless the split-K packed ``codes`` ``[K/2, N]``, unpacked by
    :func:`unpack_int4_device` where they lie, equal
    :func:`unpack_int4_host` of the same bytes."""
    got = unpack_int4_device(codes).cpu().numpy()
    want = unpack_int4_host(codes.cpu().numpy())
    if not np.array_equal(got, want):
        bad = int(np.count_nonzero(got != want))
        raise AssertionError(f"int4 layout: {bad} of {got.size} codes "
                             "unpacked on the device differ from the host "
                             "codec's")
