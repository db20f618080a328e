"""In-place KV-cache insert of the decode step's new rows.

The port of the JAX package's ``kernels/cache_insert.py``
(``cache_insert_int8`` into the contiguous cache, ``paged_cache_insert_int8``
into the page pool, ``mla_cache_insert_int8`` into the contiguous MLA latent
cache). The JAX kernels alias their outputs to the cache buffers; here the
cache tensors are written in place. The CUDA kernels are in
``csrc/cache_insert.cu``.

The GQA pair is fused with its producers: :func:`cache_insert_int8_fused`
and :func:`paged_cache_insert_int8_fused` take q, k and v as the projection
left them, apply RoPE to q and k, quantize k and v to int8 with one scale
per (slot, head), write the K/V rows and return the rotated q, in one
launch, where the model's unfused chain takes about 40 (XLA fuses the same
chain on the TPU before its Pallas insert). Their plain versions compose
the unchanged pieces: :func:`~quant_tpu_torch.kernels.rope_kv.rope_apply`,
:func:`~quant_tpu_torch.kernels.rope_kv.quantize_kv` and the codes-in
inserts :func:`cache_insert_int8_reference` /
:func:`paged_cache_insert_int8_reference` (which the unfused prefill and
plain paths also run). Each wrapper launches its kernel for tensors on the
card and takes its plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels.rope_kv import quantize_kv, rope_apply

__all__ = ["cache_insert_int8_fused", "cache_insert_int8_fused_reference",
           "cache_insert_int8_reference", "paged_cache_insert_int8_fused",
           "paged_cache_insert_int8_fused_reference",
           "paged_cache_insert_int8_reference", "paged_insert_rows",
           "mla_cache_insert_int8", "mla_cache_insert_int8_reference"]


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


def paged_insert_rows(cc, cs, codes, scale, lengths, layer: int, page_tbl):
    """Write T entries per slot into layer ``layer`` of a page pool, in
    place: entry t of slot b (position ``p = lengths[b] + t``) goes to
    ``cc[layer, page_tbl[b, p // page], :, p % page]``; positions outside
    ``[0, max_pages * page)`` are dropped. ``cc`` ``[L, P, H, page, D]``,
    ``cs`` ``[L, P, H, page]``; ``codes`` ``[B, T, H, D]``, ``scale``
    ``[B, T, H]``. Returns (cc, cs)."""
    page, max_pages = cc.shape[3], page_tbl.shape[1]
    t = codes.shape[1]
    pos = (lengths.to(torch.int64)[:, None]
           + torch.arange(t, device=codes.device)[None, :])          # [B, T]
    ok = (pos >= 0) & (pos < max_pages * page)
    col = (pos // page).clamp(0, max_pages - 1)
    pg = torch.gather(page_tbl.to(torch.int64), 1, col)[ok]
    row = pos[ok] % page
    cc[layer, pg, :, row] = codes[ok]
    cs[layer, pg, :, row] = scale[ok]
    return cc, cs


def paged_cache_insert_int8_reference(kc, ks, vc, vs, k_new, k_s, v_new,
                                      v_s, lengths, layer: int, page_tbl):
    """Plain version: write row ``lengths[b]`` of every slot through the
    page table at ``layer``; positions outside the table's capacity are
    dropped. In place."""
    if k_new.shape[1] != 1:
        raise ValueError("paged_cache_insert_int8 is the decode (T=1) path")
    paged_insert_rows(kc, ks, k_new, k_s, lengths, layer, page_tbl)
    paged_insert_rows(vc, vs, v_new, v_s, lengths, layer, page_tbl)
    return kc, ks, vc, vs


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def cache_insert_int8_fused_reference(q, k, v, cos, sin, kc, ks, vc, vs,
                                      lengths, layer: int, s0: int = 0, *,
                                      attn_factor: float | None = None):
    """Plain version of :func:`cache_insert_int8_fused`: the chain the model
    runs without the kernel, unchanged (:func:`rope_apply` of q and k,
    :func:`quantize_kv` of k and v, :func:`cache_insert_int8_reference`).
    Returns the rotated q ``[B, Hq, Dh]``."""
    q, k = (rope_apply(x, cos, sin, attn_factor=attn_factor) for x in (q, k))
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    cache_insert_int8_reference(kc, ks, vc, vs, k_q, k_s, v_q, v_s, lengths,
                                layer, s0)
    return q[:, 0]


def paged_cache_insert_int8_fused_reference(q, k, v, cos, sin, kc, ks, vc,
                                            vs, lengths, layer: int,
                                            page_tbl, *,
                                            attn_factor: float | None = None):
    """Plain version of :func:`paged_cache_insert_int8_fused`: RoPE and
    quantization as :func:`cache_insert_int8_fused_reference`, then
    :func:`paged_cache_insert_int8_reference`. Returns the rotated q."""
    q, k = (rope_apply(x, cos, sin, attn_factor=attn_factor) for x in (q, k))
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    paged_cache_insert_int8_reference(kc, ks, vc, vs, k_q, k_s, v_q, v_s,
                                      lengths, layer, page_tbl)
    return q[:, 0]


def _fused_checks(q, interleaved: bool, kv_bits: int) -> None:
    """What the fused kernel does not take, refused on every device."""
    if interleaved:
        raise NotImplementedError("the fused insert rotates halves; "
                                  "interleaved rotary pairs (MLA) are not "
                                  "fused")
    if kv_bits != 8:
        raise NotImplementedError(f"kv_bits {kv_bits} is not ported")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError("the fused insert is the decode (T=1) path: q "
                         f"[B, 1, Hq, Dh], got {tuple(q.shape)}")


def _fused_launch(symbol: str, argtypes: list, name: str, q, k, v, cos, sin,
                  caches, cache_shape, lengths, extra: tuple, tail: tuple,
                  attn_factor):
    """Check the activations, tables and caches of a fused insert on the
    card, launch ``symbol`` and count it. ``extra``: (tensor, dtype, shape)
    checks beside the common ones; ``tail``: the entry point's integer
    arguments after the pointers (``layer`` first)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, _, hq, dh = q.shape
    hkv = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"activations must be bf16 or f32, got {q.dtype}")
    if dh % 2 or not 2 <= dh <= 256:
        raise ValueError(f"head_dim {dh}: the kernel takes an even Dh up to "
                         "256")
    for t, shape in ((q, (b, 1, hq, dh)), (k, (b, 1, hkv, dh)),
                     (v, (b, 1, hkv, dh))):
        # q, k and v may be views into the projection's output row: any
        # slot stride, heads packed
        if (t.dtype != q.dtype or tuple(t.shape) != shape
                or t.device != dev or t.stride(3) != 1 or t.stride(2) != dh):
            raise ValueError(f"expected {q.dtype} {shape} with packed heads "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()}")
    checks = ((caches[0], torch.int8, cache_shape),
              (caches[2], torch.int8, cache_shape),
              (caches[1], torch.float32, cache_shape[:4]),
              (caches[3], torch.float32, cache_shape[:4]),
              (cos, torch.float32, (b, 1, 1, dh // 2)),
              (sin, torch.float32, (b, 1, 1, dh // 2)),
              (lengths, torch.int32, (b,))) + extra
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("caches, tables and lengths must be contiguous "
                             "on the activations' device")
    if not 0 <= tail[0] < cache_shape[0]:
        raise ValueError(f"layer {tail[0]} outside [0, {cache_shape[0]})")
    out = torch.empty((b, hq, dh), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _build.entry("cache_insert", symbol, argtypes)
    rc = fn(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), cos.data_ptr(),
            sin.data_ptr(), *[c.data_ptr() for c in caches],
            *[t.data_ptr() for t, _, _ in extra], lengths.data_ptr(), *tail,
            b, hq, hkv, dh, 1.0 if attn_factor is None else attn_factor,
            int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, name, "cache_insert")
    _build.count_launch(name)
    _build.count_launch(f"{name}[fused]")
    return out


# q_out, q, k, v, slot strides of q, k, v, cos, sin, k_codes, k_scale,
# v_codes, v_scale, lengths, layer, s0, S, B, Hq, Hkv, Dh, attn_factor,
# bf16, stream
_FUSED_ARGTYPES = ([_P] * 4 + [_L] * 3 + [_P] * 7 + [_I] * 7 + [_F, _I]
                   + [_P])


def cache_insert_int8_fused(q, k, v, cos, sin, kc, ks, vc, vs, lengths,
                            layer: int, s0: int = 0, *,
                            attn_factor: float | None = None,
                            interleaved: bool = False, kv_bits: int = 8):
    """One decode step's attention inputs of one layer into the contiguous
    cache, in one launch: RoPE of q ``[B, 1, Hq, Dh]`` and k ``[B, 1, Hkv,
    Dh]`` with the tables ``cos`` / ``sin`` ``[B, 1, 1, Dh/2]`` f32 (times
    ``attn_factor``), then k and v ``[B, 1, Hkv, Dh]`` quantized per (slot,
    head) to int8 codes and an f32 scale, written in place into the stacked
    caches ``[L, B, Hkv, S, Dh]`` / ``[L, B, Hkv, S]`` at row ``lengths[b]
    - s0`` of ``layer`` (positions outside ``[0, S)`` write nothing). q, k
    and v are bf16 or f32 and may be strided views of one projection row.
    Returns the rotated q ``[B, Hq, Dh]`` in their dtype. Interleaved rotary
    pairs, ``kv_bits`` other than 8 and T > 1 raise."""
    _fused_checks(q, interleaved, kv_bits)
    if q.device.type == "cpu":
        return cache_insert_int8_fused_reference(
            q, k, v, cos, sin, kc, ks, vc, vs, lengths, layer, s0,
            attn_factor=attn_factor)
    if kc.dim() != 5:
        raise ValueError("expected stacked caches [L, B, H, S, D]")
    shape = (kc.shape[0], q.shape[0], k.shape[2], kc.shape[3], q.shape[3])
    return _fused_launch("cache_insert_int8_fused_launch", _FUSED_ARGTYPES,
                         "cache_insert_int8", q, k, v, cos, sin,
                         (kc, ks, vc, vs), shape, lengths, (),
                         (layer, s0, kc.shape[3]), attn_factor)


# q_out, q, k, v, slot strides of q, k, v, cos, sin, k_codes, k_scale,
# v_codes, v_scale, page_tbl, lengths, layer, P, page, max_pages, B, Hq,
# Hkv, Dh, attn_factor, bf16, stream
_PAGED_FUSED_ARGTYPES = ([_P] * 4 + [_L] * 3 + [_P] * 8 + [_I] * 8
                         + [_F, _I] + [_P])


def paged_cache_insert_int8_fused(q, k, v, cos, sin, kc, ks, vc, vs, lengths,
                                  layer: int, page_tbl, *,
                                  attn_factor: float | None = None,
                                  interleaved: bool = False,
                                  kv_bits: int = 8):
    """:func:`cache_insert_int8_fused` into the page pools ``[L, P, Hkv,
    page, Dh]`` / ``[L, P, Hkv, page]``: the K/V rows go to
    ``(page_tbl[b, pos // page], pos % page)`` of ``layer`` with ``pos =
    lengths[b]``; positions outside ``[0, max_pages * page)`` write nothing,
    a parked slot (length 0, table row 0) writes into the scratch page 0.
    Returns the rotated q ``[B, Hq, Dh]``."""
    _fused_checks(q, interleaved, kv_bits)
    if q.device.type == "cpu":
        return paged_cache_insert_int8_fused_reference(
            q, k, v, cos, sin, kc, ks, vc, vs, lengths, layer, page_tbl,
            attn_factor=attn_factor)
    if kc.dim() != 5:
        raise ValueError("expected page pools [L, P, H, page, D]")
    l, n_pool, _, page, _ = kc.shape
    b, max_pages = q.shape[0], page_tbl.shape[-1]
    shape = (l, n_pool, k.shape[2], page, q.shape[3])
    return _fused_launch("paged_cache_insert_int8_fused_launch",
                         _PAGED_FUSED_ARGTYPES, "paged_cache_insert_int8", q,
                         k, v, cos, sin, (kc, ks, vc, vs), shape, lengths,
                         ((page_tbl, torch.int32, (b, max_pages)),),
                         (layer, n_pool, page, max_pages), attn_factor)


def mla_cache_insert_int8_reference(kc, ks, k_new, k_s, lengths, layer: int,
                                    s0: int = 0):
    """Plain version: write each slot's latent row at row ``lengths[b] - s0``
    of ``layer``; positions outside ``[0, S)`` are dropped. In place."""
    if k_new.shape[1] != 1:
        raise ValueError("mla_cache_insert_int8 is the decode (T=1) path")
    pos = lengths.to(torch.int64) - s0
    ok = (pos >= 0) & (pos < kc.shape[3])
    bi = torch.nonzero(ok).flatten()
    p = pos[bi]
    kc[layer, bi, :, p] = k_new[bi, 0]
    ks[layer, bi, :, p] = k_s[bi, 0]
    return kc, ks


# k_codes, k_scale, k_new, k_new_scale, lengths, layer, s0, B, S, D, stream
_MLA_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]


def mla_cache_insert_int8(kc, ks, k_new, k_s, lengths, layer: int,
                          s0: int = 0):
    """Write each slot's new latent row ``[B, 1, 1, Dq]`` int8 and scale
    ``[B, 1, 1]`` f32 into the stacked latent cache ``[L, B, 1, S, Dq]`` /
    ``[L, B, 1, S]`` at row ``lengths[b] - s0`` of ``layer``, in place (the
    V side of an MLA cache is zero-width: nothing to insert). Returns the
    two cache tensors."""
    if kc.device.type == "cpu":
        return mla_cache_insert_int8_reference(kc, ks, k_new, k_s, lengths,
                                               layer, s0)
    if kc.device.type != "cuda":
        raise ValueError(f"unsupported device {kc.device}")
    if kc.dim() != 5 or kc.shape[2] != 1:
        raise ValueError("expected a stacked latent cache [L, B, 1, S, Dq]")
    l, b, _, s, d = kc.shape
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    checks = ((kc, torch.int8, (l, b, 1, s, d)),
              (ks, torch.float32, (l, b, 1, s)),
              (k_new, torch.int8, (b, 1, 1, d)),
              (k_s, torch.float32, (b, 1, 1)),
              (lengths, torch.int32, (b,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != kc.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    stream = torch.cuda.current_stream(kc.device).cuda_stream
    fn = _build.entry("cache_insert", "mla_cache_insert_int8_launch",
                      _MLA_ARGTYPES)
    rc = fn(kc.data_ptr(), ks.data_ptr(), k_new.data_ptr(), k_s.data_ptr(),
            lengths.data_ptr(), layer, s0, b, s, d, stream)
    _build.check(rc, "mla_cache_insert_int8", "cache_insert")
    _build.count_launch("mla_cache_insert_int8")
    return kc, ks
