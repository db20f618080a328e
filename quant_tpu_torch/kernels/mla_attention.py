"""MLA (DeepSeek) flash-decode attention over the int8 latent cache (T=1).

The port of the JAX package's ``kernels/mla_attention.py``
(``mla_flash_decode_int8``). In the absorbed form, decode attention is MQA
with one shared latent row per token: queries ``q_eff [B, H, Dq]`` against
cache rows ``[c_kv | k_rope | zero pad]`` (``Dq`` int8 codes and one f32
scale per row), and the value read is the row's first ``r`` lanes:
``out = softmax(scale * q_eff . k * ks) @ (ks * k[:, :r])``. The CUDA kernel
is ``csrc/mla_attention.cu``; :func:`mla_flash_decode_int8` launches it for
tensors on the card and takes the plain version
:func:`mla_flash_decode_int8_reference` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quant_tpu_torch.kernels import _build

__all__ = ["mla_flash_decode_int8", "mla_flash_decode_int8_reference"]

_HT = 16          # csrc/mla_attention.cu HT: heads per block
_TT = 64          # TT: tokens per staged tile
_NT = 256         # NT: threads per block (2 value lanes each)
_MAX_DQ = 1024    # MAX_DQ


def mla_flash_decode_int8_reference(q, k_codes, k_scale, lengths, layer=None,
                                    *, r: int, scale: float):
    """Plain version, in float32: ``q [B, H, Dq]`` against the latent cache
    ``[B, 1, S, Dq]`` / ``[B, 1, S]`` (or stacked ``[L, ...]`` with
    ``layer``). Rows at positions ``>= lengths[b]`` are masked; the output
    ``[B, H, r]`` is ``sum(p * ks * k[:, :r]) / max(sum(p), 1e-20)`` in
    ``q.dtype``, so a slot of length 0 gives zeros."""
    kc = k_codes if layer is None else k_codes[layer]
    ks = k_scale if layer is None else k_scale[layer]
    kf = kc[:, 0].to(torch.float32)                        # [B, S, Dq]
    ksc = ks[:, 0]                                         # [B, S]
    s = kf.shape[1]
    logits = torch.einsum("bhd,bsd->bhs", q.to(torch.float32) * scale, kf)
    logits = logits * ksc[:, None, :]
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhs,bsr->bhr", p * ksc[:, None, :],
                       kf[..., :r]) / denom
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_tiles(b: int, h: int, s: int, sms: int) -> int:
    """Tiles of ``_TT`` tokens per block (the split-S chunk): one tile when
    the grid at full lengths already holds about two blocks per SM of the
    card's ``sms``, more (up to 8) when it would hold many more, so fewer
    chunk partials are written and merged (H=128 has 8 head tiles per
    slot)."""
    units = b * -(-h // _HT) * -(-s // _TT)
    return max(1, min(8, units // (2 * sms)))


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, q_bf16, k_codes, k_scale, lengths, out, part_o, part_ml, layer, B, H, S,
# Dq, r, chunk_tiles, scale, stream
_ARGTYPES = [_P, _I] + [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]


def mla_flash_decode_int8(q, k_codes, k_scale, lengths, layer=None, *,
                          r: int, scale: float):
    """Latent attention output ``[B, H, r]`` in ``q.dtype``.

    ``q`` ``[B, H, Dq]`` float32 or bfloat16; ``k_codes`` int8
    ``[B, 1, S, Dq]``, or stacked ``[L, B, 1, S, Dq]`` with ``layer``;
    ``k_scale`` f32 ``[.., 1, S]``, one scale per latent row; ``lengths``
    int32 ``[B]``; ``r`` the value width (``kv_lora_rank``); ``scale`` the
    score scale."""
    if k_codes.dtype != torch.int8:
        raise NotImplementedError("only the int8 latent cache is ported "
                                  "(kv_bits 8)")
    if q.device.type == "cpu":
        return mla_flash_decode_int8_reference(q, k_codes, k_scale, lengths,
                                               layer, r=r, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    stacked = k_codes.dim() == 5
    if stacked and layer is None:
        raise ValueError("stacked caches require a layer index")
    if not stacked:
        k_codes, k_scale, layer = k_codes[None], k_scale[None], 0
    l, b, one, s, dq = k_codes.shape
    h = q.shape[1]
    if one != 1:
        raise ValueError(f"an MLA cache holds one latent row per token, got "
                         f"{one} heads")
    if dq % 16 or dq > _MAX_DQ or r % 2 or not 0 < r <= min(dq, 2 * _NT):
        raise ValueError(f"kernel takes Dq a multiple of 16 up to {_MAX_DQ} "
                         f"and an even r up to min(Dq, {2 * _NT}), got Dq "
                         f"{dq}, r {r}")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    checks = ((q, q.dtype, (b, h, dq)),
              (k_scale, torch.float32, (l, b, 1, s)),
              (lengths, torch.int32, (b,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (q, k_codes, k_scale, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if k_codes.data_ptr() % 16:
        raise ValueError("the latent cache must be 16-byte aligned")
    tiles = chunk_tiles(b, h, s, _sm_count(q.device))
    chunks = -(-s // (_TT * tiles))
    out = torch.empty((b, h, r), dtype=q.dtype, device=q.device)
    # per (slot, head, S chunk): the chunk's unnormalised output and its
    # (max, sum) for the kernel's merge pass
    part_o = torch.empty((b * h * chunks * r,), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b * h * chunks * 2,), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("mla_attention", "mla_flash_decode_int8_launch",
                      _ARGTYPES)
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
            k_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), layer, b, h, s, dq, r,
            tiles, float(scale), stream)
    _build.check(rc, "mla_flash_decode_int8", "mla_attention")
    _build.count_launch("mla_flash_decode_int8")
    return out
