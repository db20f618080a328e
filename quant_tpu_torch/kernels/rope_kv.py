"""RMSNorm, rotate-half RoPE and per-(token, head) KV quantization (int8,
the int4 head-pair cache, or the unquantized cache at 16 bits), in plain
PyTorch.

The model's unfused chain (``models/llama.py``: prefill, the plain paths)
and the plain versions of the fused inserts (``kernels/cache_insert.py``:
the GQA pair, and the MLA latent with its RMSNorm) both run these, so each
fused kernel is held to the very arithmetic the model runs without it. They
sit here and not in ``models/llama.py`` because that module imports the
kernels.
"""

from __future__ import annotations

import torch

__all__ = ["deinterleave", "rmsnorm", "rope_apply", "quantize_kv",
           "dequant_kv4"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            offset: float = 0.0) -> torch.Tensor:
    """RMSNorm over the last axis in float32 (square, mean, ``rsqrt(var +
    eps)``, then the two products), times the gain ``offset + w``, returned
    in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (offset + w)).to(x.dtype)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d] with interleaved rotary pairs -> [evens | odds]: DeepSeek
    rotates (x[2i], x[2i+1]) pairs; rotate-half RoPE on the de-interleaved
    vector rotates the same pairs, in a fixed permutation of the lanes that
    q and k share, as in the JAX package."""
    *s, d = x.shape
    return x.reshape(*s, d // 2, 2).transpose(-1, -2).reshape(*s, d)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               interleaved: bool = False,
               attn_factor: float | None = None) -> torch.Tensor:
    """Rotate-half RoPE of ``x`` [..., Dh] with precomputed tables [...,
    Dh/2] (broadcast): ``[x1 cos - x2 sin, x2 cos + x1 sin]`` in float32,
    each product and sum rounded on its own, then times ``attn_factor``
    (yarn's, which multiplies the rotated output as the JAX package applies
    it), returned in ``x``'s dtype. ``interleaved`` de-interleaves the
    rotary pairs first."""
    if interleaved:
        x = deinterleave(x)
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if attn_factor is not None:
        out = out * attn_factor
    return out.to(x.dtype)


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """Per-(token, head) symmetric quantization: x [B, T, H, Dh] ->
    (codes, scales f32 [B, T, H]), as the JAX package's ``quantize_kv``.

    ``bits=8``: int8 codes ``round(x / scale)``, ``scale = absmax / 127``
    (1 where absmax is 0). ``bits=4``: ``scale = absmax / 7`` and the codes
    ``round(x / scale) + 8`` packed two to a byte across HEAD PAIRS: packed
    head j holds real head 2j in the low nibble and 2j+1 in the high one,
    at the same token and dim, so the codes are uint8 [B, T, H/2, Dh] while
    the scales stay per real head. (Not the split-K layout of the int4
    weights, whose high nibble is another row.) ``bits=16`` keeps the cache
    unquantized: the codes are ``x`` itself and the scales ones, so every
    reader's ``codes * scale`` is unchanged."""
    if bits == 16:
        return x, torch.ones(x.shape[:-1], dtype=torch.float32,
                             device=x.device)
    if bits not in (4, 8):
        raise NotImplementedError(f"kv_bits {bits} is not ported")
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    qmax = 7.0 if bits == 4 else 127.0
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / qmax)
    codes = torch.round(xf / scale[..., None])
    if bits == 4:
        u = (codes + 8).to(torch.uint8)
        return u[..., 0::2, :] | (u[..., 1::2, :] << 4), scale
    return codes.to(torch.int8), scale


def dequant_kv4(codes: torch.Tensor, head_axis: int = -3) -> torch.Tensor:
    """Head-pair int4 codes (:func:`quantize_kv` at 4 bits) -> float32
    codes minus 8 of the real heads: each byte's low nibble is real head
    2j and its high nibble 2j+1, interleaved back along ``head_axis``, the
    packed head axis (-3 in the cache layouts ``[.., H/2, S, D]``, -2 in
    the per-token ``[B, T, H/2, D]``)."""
    lo = (codes & 0xF).to(torch.float32) - 8.0
    hi = (codes >> 4).to(torch.float32) - 8.0
    ax = head_axis % codes.dim()
    st = torch.stack([lo, hi], dim=ax + 1)
    return st.reshape(*codes.shape[:ax], 2 * codes.shape[ax],
                      *codes.shape[ax + 1:])
