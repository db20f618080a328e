"""INT8-KV flash-decode attention (decode step, T=1).

The port of the JAX package's ``kernels/attention.py``
(``flash_decode_int8``): GQA attention over the int8 cache with
per-(token, head) scales, the key scale applied to the logits and the value
scale to the probabilities, masked by per-slot ``lengths``. The CUDA kernel
is ``csrc/flash_decode.cu``; :func:`flash_decode_int8` launches it for
tensors on the card and takes the plain version
:func:`flash_decode_int8_reference` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from quant_tpu_torch.kernels import _build

__all__ = ["flash_decode_int8", "flash_decode_int8_reference"]

_MAX_REP = 8     # csrc/flash_decode.cu MAX_REP
_MAX_D = 256     # MAX_D
_CHUNK = 256     # CH: tokens per block (split-S)


def _layer_view(a, layer):
    if layer is None:
        return a
    return a[layer]


def flash_decode_int8_reference(q, k_codes, k_scale, v_codes, v_scale,
                                lengths, layer=None, *, scale=None):
    """Plain version, in float32: q ``[B, Hq, Dh]`` against caches
    ``[B, Hkv, S, Dh]`` (or stacked ``[L, ...]`` with ``layer``). Keys at
    positions ``>= lengths[b]`` are masked; the output is
    ``sum(p * v_scale * v) / max(sum(p), 1e-20)``, so a slot of length 0
    gives zeros like the kernel."""
    kc, ks = _layer_view(k_codes, layer), _layer_view(k_scale, layer)
    vc, vs = _layer_view(v_codes, layer), _layer_view(v_scale, layer)
    b, hq, dh = q.shape
    hkv, s = ks.shape[1], ks.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / dh ** 0.5
    qg = q.to(torch.float32).reshape(b, hkv, rep, dh) * scale
    logits = torch.einsum("bhrd,bhsd->bhrs", qg, kc.to(torch.float32))
    logits = logits * ks[:, :, None, :]
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhrs,bhsd->bhrd", p * vs[:, :, None, :],
                       vc.to(torch.float32)) / denom
    return out.reshape(b, hq, dh).to(q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, q_bf16, k_codes, k_scale, v_codes, v_scale, lengths, out, part_o,
# part_ml, layer, B, Hkv, S, Dh, rep, scale, stream
_ARGTYPES = [_P, _I] + [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P]


def flash_decode_int8(q, k_codes, k_scale, v_codes, v_scale, lengths,
                      layer=None, window=None, *, softcap: float = 0.0,
                      scale: float | None = None):
    """Attention output ``[B, Hq, Dh]`` in ``q.dtype``.

    ``k_codes``/``v_codes`` int8 ``[B, Hkv, S, Dh]``, or stacked
    ``[L, B, Hkv, S, Dh]`` with ``layer``; scales f32 ``[.., Hkv, S]``;
    ``lengths`` int32 ``[B]``; ``scale`` defaults to ``1/sqrt(Dh)``."""
    if window is not None or softcap:
        raise NotImplementedError("sliding windows and softcaps are not "
                                  "ported")
    if k_codes.dtype != torch.int8:
        raise NotImplementedError("only the int8 cache is ported (kv_bits 8)")
    if q.device.type == "cpu":
        return flash_decode_int8_reference(q, k_codes, k_scale, v_codes,
                                           v_scale, lengths, layer,
                                           scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    stacked = k_codes.dim() == 5
    if stacked and layer is None:
        raise ValueError("stacked caches require a layer index")
    if not stacked:
        k_codes, v_codes = k_codes[None], v_codes[None]
        k_scale, v_scale = k_scale[None], v_scale[None]
        layer = 0
    l, b, hkv, s, dh = k_codes.shape
    hq = q.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    rep = hq // hkv
    if rep > _MAX_REP or dh > _MAX_D or dh % 16:
        raise ValueError(f"kernel takes rep <= {_MAX_REP} and Dh a multiple "
                         f"of 16 up to {_MAX_D}, got rep {rep}, Dh {dh}")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    checks = ((q, q.dtype, (b, hq, dh)),
              (v_codes, torch.int8, (l, b, hkv, s, dh)),
              (k_scale, torch.float32, (l, b, hkv, s)),
              (v_scale, torch.float32, (l, b, hkv, s)),
              (lengths, torch.int32, (b,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (q, k_codes, k_scale, v_codes, v_scale, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if k_codes.data_ptr() % 16 or v_codes.data_ptr() % 16:
        raise ValueError("the code caches must be 16-byte aligned")
    out = torch.empty_like(q)
    # per (slot, kv head, S chunk, query row): the chunk's unnormalised
    # output and its (max, sum) for the kernel's merge pass
    chunks = -(-s // _CHUNK)
    part_o = torch.empty((b * hkv * chunks * rep * dh,), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b * hkv * chunks * rep * 2,), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("flash_decode", "flash_decode_int8_launch", _ARGTYPES)
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16),
            k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), layer, b, hkv, s, dh, rep,
            float(scale if scale is not None else 1.0 / dh ** 0.5), stream)
    _build.check(rc, "flash_decode_int8", "flash_decode")
    _build.count_launch("flash_decode_int8")
    return out
