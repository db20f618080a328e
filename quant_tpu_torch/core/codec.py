"""Quantization codec — NumPy host path, bit-exact vs the C++ oracle.

Implements the normative codec spec from ``cpp/quantref.h`` (the in-repo
stand-in for the coodie/quant C++ reference — BASELINE.json:7 requires codes
to be bit-exact vs the C++ reference at the same bit-width):

  qmax  = 2^(b-1) - 1
  scale = absmax / qmax          (float32; 1.0 when absmax == 0)
  code  = clip(round_half_even(x / scale), -qmax, qmax)
  value = code * scale

Bit-exactness vs C++ holds because ``np.round`` and C ``nearbyintf`` under
FE_TONEAREST both round half-to-even, and the scale/div/mul arithmetic is
plain IEEE float32 on both sides.

Two INT4 packing layouts exist on purpose:

* ``pack_int4`` / ``unpack_int4`` — the AT-REST layout (oracle contract):
  flat little-endian nibble pairs, byte j = code[2j] | code[2j+1]<<4, biased
  by +8. This is what the entropy stage and checkpoint files see.
* ``pack_int4_matmul`` / ``unpack_int4_matmul`` — the DEVICE layout for the
  fused dequant+matmul kernel: a [K, N] code matrix packs along K as
  byte[i, n] = code[i, n] | code[i + K/2, n]<<4 ("split-K"), so on-device
  unpack is two cheap nibble ops + concat along the contraction axis with NO
  lane/sublane interleave (SURVEY.md §7 "INT4 layout for the MXU").

A copy of the JAX package's ``core/codec.py``: the port imports nothing of
that package, so it keeps its own numpy codec.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "qmax_for_bits",
    "quantize",
    "dequantize",
    "pack_int4",
    "unpack_int4",
    "pack_int4_matmul",
    "unpack_int4_matmul",
    "NF4_TABLE",
    "quantize_lut",
    "dequantize_lut",
    "lloyd_max_fit",
]

# The normative 16-entry NF4 codebook (cpp/quantref.h QR_NF4_TABLE —
# QLoRA §3 constants: N(0,1) quantiles renormalized to [-1, 1] with an
# exact 0 entry). Sorted strictly ascending; codes index it as code + 8.
NF4_TABLE = np.array([
    -1.0,
    -0.6961928009986877,
    -0.5250730514526367,
    -0.39491748809814453,
    -0.28444138169288635,
    -0.18477343022823334,
    -0.09105003625154495,
    0.0,
    0.07958029955625534,
    0.16093020141124725,
    0.24611230194568634,
    0.33791524171829224,
    0.44070982933044434,
    0.5626170039176941,
    0.7229568362236023,
    1.0,
], dtype=np.float32)


def qmax_for_bits(bits: int) -> int:
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    return (1 << (bits - 1)) - 1


def _quantize_last_axis(x: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """Quantize over the last axis: one scale per leading index."""
    qmax = np.float32(qmax_for_bits(bits))
    absmax = np.max(np.abs(x), axis=-1, keepdims=True).astype(np.float32)
    scale = np.where(absmax == 0.0, np.float32(1.0), absmax / qmax)
    q = np.round(x / scale)
    q = np.clip(q, -qmax, qmax)
    return q.astype(np.int8), scale.squeeze(-1).astype(np.float32)


def quantize(
    x: np.ndarray,
    bits: int,
    group_size: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Quantize float32 ``x`` to b-bit signed codes.

    Args:
      x: float32 array. 1-D for per-tensor; N-D with ``group_size`` for
        grouped quantization along the last axis.
      bits: bit-width in [2, 8].
      group_size: if None, a single scale over the whole array (per-tensor).
        Otherwise the last axis is split into groups of this size, one scale
        per group (last-axis length must be divisible).

    Returns:
      (codes int8 with x's shape, scales float32). Per-tensor: scales is a
      scalar. Grouped: scales has shape x.shape[:-1] + (last/group_size,).
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    if group_size is None:
        codes, scale = _quantize_last_axis(x.reshape(1, -1), bits)
        return codes.reshape(x.shape), scale.reshape(())
    last = x.shape[-1]
    if group_size <= 0 or last % group_size != 0:
        raise ValueError(f"group_size {group_size} must divide last axis {last}")
    g = x.reshape(*x.shape[:-1], last // group_size, group_size)
    codes, scales = _quantize_last_axis(g, bits)
    return codes.reshape(x.shape), scales


def dequantize(
    codes: np.ndarray,
    scales: np.ndarray,
    group_size: int | None = None,
) -> np.ndarray:
    """Inverse of :func:`quantize`: value = code * scale (float32)."""
    codes = np.asarray(codes, dtype=np.int8)
    scales = np.asarray(scales, dtype=np.float32)
    if group_size is None:
        return codes.astype(np.float32) * scales
    last = codes.shape[-1]
    g = codes.reshape(*codes.shape[:-1], last // group_size, group_size)
    out = g.astype(np.float32) * scales[..., None]
    return out.reshape(codes.shape)


# ── Codebook ("bin-lookup") variant ────────────────────────────────────
#
# The general non-uniform case of the codec (cpp/quantref.h "Codebook
# variant"; BASELINE.json:5 "fused dequant(bin-lookup + scale)+matmul" —
# the linear codec above is the uniform special case). 4-bit only: a
# 16-entry sorted codebook spanning [-1, 1], per-group scale = absmax,
# code = nearest entry (ties at a midpoint take the lower index),
# stored as int8 code-8 so packing/entropy/checkpoints are shared.


def _lut_midpoints(lut: np.ndarray) -> np.ndarray:
    lut = np.asarray(lut, dtype=np.float32)
    if lut.shape != (16,):
        raise ValueError(f"codebook must have 16 entries, got {lut.shape}")
    if not np.all(lut[:-1] < lut[1:]):
        raise ValueError("codebook must be strictly ascending")
    return ((lut[:-1] + lut[1:]) / np.float32(2.0)).astype(np.float32)


def quantize_lut(
    x: np.ndarray,
    lut: np.ndarray = NF4_TABLE,
    group_size: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Codebook-quantize float32 ``x`` (bit-exact vs qr_quantize_lut*).

    Returns (codes int8 in [-8, 7] with x's shape, scales float32 = the
    per-group absmax). Grouping semantics match :func:`quantize`.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    mid = _lut_midpoints(lut)
    if group_size is None:
        g = x.reshape(1, -1)
    else:
        last = x.shape[-1]
        if group_size <= 0 or last % group_size != 0:
            raise ValueError(
                f"group_size {group_size} must divide last axis {last}")
        g = x.reshape(*x.shape[:-1], last // group_size, group_size)
    absmax = np.max(np.abs(g), axis=-1, keepdims=True).astype(np.float32)
    scale = np.where(absmax == 0.0, np.float32(1.0), absmax)
    xn = g / scale
    # bin = #{ midpoints strictly below xn }: nearest entry, ties down
    codes = (xn[..., None] > mid).sum(axis=-1).astype(np.int8) - 8
    if group_size is None:
        return codes.reshape(x.shape), scale.reshape(()).astype(np.float32)
    return codes.reshape(x.shape), scale.squeeze(-1).astype(np.float32)


def dequantize_lut(
    codes: np.ndarray,
    scales: np.ndarray,
    lut: np.ndarray = NF4_TABLE,
    group_size: int | None = None,
) -> np.ndarray:
    """Inverse of :func:`quantize_lut`: value = lut[code + 8] * scale."""
    lut = np.asarray(lut, dtype=np.float32)
    c = np.asarray(codes, dtype=np.int8).astype(np.int32) + 8
    v = lut[c]
    scales = np.asarray(scales, dtype=np.float32)
    if group_size is None:
        return (v * scales).astype(np.float32)
    last = v.shape[-1]
    g = v.reshape(*v.shape[:-1], last // group_size, group_size)
    return (g * scales[..., None]).reshape(codes.shape).astype(np.float32)


def lloyd_max_fit(
    x: np.ndarray,
    iters: int = 25,
    init: np.ndarray = NF4_TABLE,
) -> np.ndarray:
    """Fit a 16-entry codebook to ``x`` by Lloyd-Max on absmax-normalized
    values (calibration, not codec: the returned table feeds the shared
    bit-exact encode/decode above). Deterministic: fixed iteration count,
    float64 accumulation, NF4 init. Endpoints stay pinned at ±1 so the
    table always spans the normalized range (and stays strictly
    ascending for any input)."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    absmax = np.max(np.abs(x)) if x.size else 0.0
    if absmax == 0.0:
        return np.asarray(init, dtype=np.float32).copy()
    xn = (x / np.float32(absmax)).astype(np.float64)
    lut = np.asarray(init, dtype=np.float64).copy()
    for _ in range(iters):
        mid = (lut[:-1] + lut[1:]) / 2.0
        bins = np.searchsorted(mid, xn, side="left")
        sums = np.bincount(bins, weights=xn, minlength=16)
        cnts = np.bincount(bins, minlength=16)
        cent = np.where(cnts > 0, sums / np.maximum(cnts, 1), lut)
        cent[0], cent[15] = -1.0, 1.0
        lut = np.sort(cent)
    # strict ascent for the codec contract (degenerate clusters can tie)
    for i in range(1, 16):
        if lut[i] <= lut[i - 1]:
            lut[i] = np.nextafter(lut[i - 1], np.inf)
    return lut.astype(np.float32)


# ── INT4 at-rest layout (oracle contract) ──────────────────────────────


def pack_int4(codes: np.ndarray) -> np.ndarray:
    """Pack flat int4 codes ([-8, 7]) into bytes, little-endian nibbles.

    byte[j] = (codes[2j+1]+8) << 4 | (codes[2j]+8); odd length pads with
    code 0 (stored nibble 8). Matches ``qr_pack_int4``.
    """
    c = np.asarray(codes, dtype=np.int8).reshape(-1)
    u = (c.astype(np.int16) + 8).astype(np.uint8)
    if u.size % 2:
        u = np.concatenate([u, np.array([8], dtype=np.uint8)])
    pairs = u.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_int4`, returning n int8 codes."""
    p = np.asarray(packed, dtype=np.uint8).reshape(-1)
    lo = (p & 0xF).astype(np.int16) - 8
    hi = (p >> 4).astype(np.int16) - 8
    out = np.empty(p.size * 2, dtype=np.int8)
    out[0::2] = lo.astype(np.int8)
    out[1::2] = hi.astype(np.int8)
    return out[:n]


# ── INT4 device layout (split-K for the fused matmul kernel) ───────────


def pack_int4_matmul(codes: np.ndarray) -> np.ndarray:
    """Pack a [K, N] int4 code matrix along K in the split-K device layout.

    byte[i, n] = (codes[i + K/2, n]+8) << 4 | (codes[i, n]+8), K even.
    On-device unpack is concat(lo_nibbles, hi_nibbles, axis=0) — no
    interleave, so Mosaic needs no sublane shuffles.
    """
    c = np.asarray(codes, dtype=np.int8)
    if c.ndim != 2 or c.shape[0] % 2:
        raise ValueError(f"expected [K, N] with even K, got {c.shape}")
    half = c.shape[0] // 2
    u = (c.astype(np.int16) + 8).astype(np.uint8)
    return (u[:half] | (u[half:] << 4)).astype(np.uint8)


def unpack_int4_matmul(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4_matmul` (host/NumPy reference)."""
    p = np.asarray(packed, dtype=np.uint8)
    lo = (p & 0xF).astype(np.int16) - 8
    hi = (p >> 4).astype(np.int16) - 8
    return np.concatenate([lo, hi], axis=0).astype(np.int8)
