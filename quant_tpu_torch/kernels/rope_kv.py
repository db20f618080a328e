"""RMSNorm, rotate-half RoPE and per-(token, head) int8 KV quantization
(or the unquantized cache at 16 bits), in plain PyTorch.

The model's unfused chain (``models/llama.py``: prefill, the plain paths)
and the plain versions of the fused inserts (``kernels/cache_insert.py``:
the GQA pair, and the MLA latent with its RMSNorm) both run these, so each
fused kernel is held to the very arithmetic the model runs without it. They
sit here and not in ``models/llama.py`` because that module imports the
kernels.
"""

from __future__ import annotations

import torch

__all__ = ["deinterleave", "rmsnorm", "rope_apply", "quantize_kv"]


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
    """Per-(token, head) symmetric int8: x [B, T, H, Dh] -> (codes int8
    [B, T, H, Dh], scales f32 [B, T, H]). ``bits=16`` keeps the cache
    unquantized, as the JAX package does: the codes are ``x`` itself and
    the scales ones, so every reader's ``codes * scale`` is unchanged."""
    if bits == 16:
        return x, torch.ones(x.shape[:-1], dtype=torch.float32,
                             device=x.device)
    if bits != 8:
        raise NotImplementedError(f"kv_bits {bits} is not ported")
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    codes = torch.round(xf / scale[..., None])
    return codes.to(torch.int8), scale
