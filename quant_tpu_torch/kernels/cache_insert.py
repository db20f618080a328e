"""In-place KV-cache insert of the decode step's new rows.

The port of the JAX package's ``kernels/cache_insert.py``
(``cache_insert_int8``). The JAX kernel aliases its outputs to the cache
buffers; here the cache tensors are written in place and returned.
The CUDA kernel is ``csrc/cache_insert.cu``; :func:`cache_insert_int8`
launches it for tensors on the card and takes the plain version
:func:`cache_insert_int8_reference` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from quant_tpu_torch.kernels import _build

__all__ = ["cache_insert_int8", "cache_insert_int8_reference"]


def cache_insert_int8_reference(kc, ks, vc, vs, k_new, k_s, v_new, v_s,
                                lengths, layer: int, s0: int = 0):
    """Plain version: write row ``lengths[b] - s0`` of every slot at
    ``layer``; positions outside ``[0, S)`` are dropped. In place."""
    if k_new.shape[1] != 1:
        raise ValueError("cache_insert_int8 is the decode (T=1) path")
    pos = lengths.to(torch.int64) - s0
    ok = (pos >= 0) & (pos < kc.shape[3])
    bi = torch.nonzero(ok).flatten()
    p = pos[bi]
    kc[layer, bi, :, p] = k_new[bi, 0]
    vc[layer, bi, :, p] = v_new[bi, 0]
    ks[layer, bi, :, p] = k_s[bi, 0]
    vs[layer, bi, :, p] = v_s[bi, 0]
    return kc, ks, vc, vs


_P, _I = ctypes.c_void_p, ctypes.c_int
# k_codes, k_scale, v_codes, v_scale, k_new, k_new_scale, v_new, v_new_scale,
# lengths, layer, s0, B, H, S, D, stream
_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]


def cache_insert_int8(kc, ks, vc, vs, k_new, k_s, v_new, v_s, lengths,
                      layer: int, s0: int = 0):
    """Write the new K/V code rows ``[B, 1, H, D]`` int8 and scales
    ``[B, 1, H]`` f32 into the stacked caches ``[L, B, H, S, D]`` /
    ``[L, B, H, S]`` at row ``lengths[b] - s0`` of ``layer``, in place.
    Returns the four cache tensors."""
    if kc.device.type == "cpu":
        return cache_insert_int8_reference(kc, ks, vc, vs, k_new, k_s,
                                           v_new, v_s, lengths, layer, s0)
    if kc.device.type != "cuda":
        raise ValueError(f"unsupported device {kc.device}")
    if kc.dim() != 5:
        raise ValueError("expected stacked caches [L, B, H, S, D]")
    l, b, h, s, d = kc.shape
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    checks = ((kc, torch.int8, (l, b, h, s, d)),
              (vc, torch.int8, (l, b, h, s, d)),
              (ks, torch.float32, (l, b, h, s)),
              (vs, torch.float32, (l, b, h, s)),
              (k_new, torch.int8, (b, 1, h, d)),
              (v_new, torch.int8, (b, 1, h, d)),
              (k_s, torch.float32, (b, 1, h)),
              (v_s, torch.float32, (b, 1, h)),
              (lengths, torch.int32, (b,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != kc.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    stream = torch.cuda.current_stream(kc.device).cuda_stream
    fn = _build.entry("cache_insert", "cache_insert_int8_launch", _ARGTYPES)
    rc = fn(kc.data_ptr(), ks.data_ptr(), vc.data_ptr(), vs.data_ptr(),
            k_new.data_ptr(), k_s.data_ptr(), v_new.data_ptr(),
            v_s.data_ptr(), lengths.data_ptr(), layer, s0, b, h, s, d, stream)
    _build.check(rc, "cache_insert_int8", "cache_insert")
    _build.count_launch("cache_insert_int8")
    return kc, ks, vc, vs
