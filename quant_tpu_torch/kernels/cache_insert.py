"""In-place KV-cache insert of the decode step's new rows.

The port of the JAX package's ``kernels/cache_insert.py``
(``cache_insert_int8`` into the contiguous cache, ``paged_cache_insert_int8``
into the page pool, ``mla_cache_insert_int8`` into the contiguous MLA latent
cache; the JAX package writes its paged latent pool with the plain
``_paged_insert_at_layer``, which the port's MLA insert also takes through a
page table). The JAX kernels alias their outputs to the cache buffers; here the
cache tensors are written in place. The CUDA kernels are in
``csrc/cache_insert.cu``.

The GQA pair is fused with its producers: :func:`cache_insert_int8_fused`
and :func:`paged_cache_insert_int8_fused` take q, k and v as the projection
left them, apply RoPE to q and k, quantize k and v to int8 (or to the
int4 head-pair codes at ``kv_bits=4``) with one scale per (slot, real
head), write the K/V rows and return the rotated q, in one launch, where
the model's unfused chain takes about 40 (XLA fuses the same chain on the
TPU before its Pallas insert). Their plain versions compose
the unchanged pieces: :func:`~quant_tpu_torch.kernels.rope_kv.rope_apply`,
:func:`~quant_tpu_torch.kernels.rope_kv.quantize_kv` and the codes-in
inserts :func:`cache_insert_int8_reference` /
:func:`paged_cache_insert_int8_reference` (which the unfused prefill and
plain paths also run). The MLA latent insert is fused likewise:
:func:`mla_cache_insert_int8_fused` takes the latent's ``ckv`` and the
query's ``q_pe`` as the projections left them and ``q_abs``, applies the
latent's RMSNorm and RoPE to k_pe and q_pe, quantizes the latent row, writes
it and returns the decode kernel's query ``q_eff``, in one launch where the
chain takes about 45, into the contiguous latent cache or, given a page
table, the paged latent pool; its plain version is :func:`mla_latent_rows`
(which the model's unfused path runs), ``quantize_kv`` and
:func:`mla_cache_insert_int8_reference` or :func:`paged_insert_rows`. Each
wrapper launches its kernel
for tensors on the card and takes its plain version only for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels.rope_kv import quantize_kv, rmsnorm, rope_apply

__all__ = ["cache_insert_int8_fused", "cache_insert_int8_fused_reference",
           "cache_insert_int8_reference", "paged_cache_insert_int8_fused",
           "paged_cache_insert_int8_fused_reference",
           "paged_cache_insert_int8_reference", "paged_insert_rows",
           "mla_cache_insert_int8_fused",
           "mla_cache_insert_int8_fused_reference",
           "mla_cache_insert_int8_reference", "mla_latent_rows"]


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
    ``[0, max_pages * page)`` are dropped. ``cc`` ``[L, P, Hc, page, D]``,
    ``cs`` ``[L, P, H, page]``; ``codes`` ``[B, T, Hc, D]``, ``scale``
    ``[B, T, H]`` (``Hc = H / 2`` packed heads for the int4 cache).
    Returns (cc, cs)."""
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
                                      attn_factor: float | None = None,
                                      kv_bits: int = 8):
    """Plain version of :func:`cache_insert_int8_fused`: the chain the model
    runs without the kernel, unchanged (:func:`rope_apply` of q and k,
    :func:`quantize_kv` of k and v at ``kv_bits``,
    :func:`cache_insert_int8_reference`). Returns the rotated q
    ``[B, Hq, Dh]``."""
    q, k = (rope_apply(x, cos, sin, attn_factor=attn_factor) for x in (q, k))
    k_q, k_s = quantize_kv(k, kv_bits)
    v_q, v_s = quantize_kv(v, kv_bits)
    cache_insert_int8_reference(kc, ks, vc, vs, k_q, k_s, v_q, v_s, lengths,
                                layer, s0)
    return q[:, 0]


def paged_cache_insert_int8_fused_reference(q, k, v, cos, sin, kc, ks, vc,
                                            vs, lengths, layer: int,
                                            page_tbl, *,
                                            attn_factor: float | None = None,
                                            kv_bits: int = 8):
    """Plain version of :func:`paged_cache_insert_int8_fused`: RoPE and
    quantization as :func:`cache_insert_int8_fused_reference`, then
    :func:`paged_cache_insert_int8_reference`. Returns the rotated q."""
    q, k = (rope_apply(x, cos, sin, attn_factor=attn_factor) for x in (q, k))
    k_q, k_s = quantize_kv(k, kv_bits)
    v_q, v_s = quantize_kv(v, kv_bits)
    paged_cache_insert_int8_reference(kc, ks, vc, vs, k_q, k_s, v_q, v_s,
                                      lengths, layer, page_tbl)
    return q[:, 0]


def _fused_checks(q, interleaved: bool, kv_bits: int) -> None:
    """What the fused kernel does not take, refused on every device."""
    if interleaved:
        raise NotImplementedError("the fused insert rotates halves; "
                                  "interleaved rotary pairs (MLA) are not "
                                  "fused")
    if kv_bits not in (8, 4):
        raise NotImplementedError(f"the fused insert writes the int8 or the "
                                  f"int4 cache, not kv_bits {kv_bits}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError("the fused insert is the decode (T=1) path: q "
                         f"[B, 1, Hq, Dh], got {tuple(q.shape)}")


def _fused_launch(symbol: str, argtypes: list, name: str, q, k, v, cos, sin,
                  caches, cache_shape, lengths, extra: tuple, tail: tuple,
                  attn_factor, kv_bits: int):
    """Check the activations, tables and caches of a fused insert on the
    card, launch ``symbol`` and count it. ``cache_shape``: the code
    tensors' shape at ``Hkv`` heads (halved for the int4 cache's packed
    heads); ``extra``: (tensor, dtype, shape) checks beside the common
    ones; ``tail``: the entry point's integer arguments after the pointers
    (``layer`` first)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, _, hq, dh = q.shape
    hkv = k.shape[2]
    kv4 = kv_bits == 4
    if kv4 and hkv % 2:
        raise ValueError(f"the int4 cache packs head pairs: Hkv {hkv} is odd")
    cdt = torch.uint8 if kv4 else torch.int8
    code_shape = (cache_shape[:2] + (hkv // 2,) + cache_shape[3:] if kv4
                  else cache_shape)
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
    checks = ((caches[0], cdt, code_shape),
              (caches[2], cdt, code_shape),
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
            int(q.dtype == torch.bfloat16), int(kv4), stream)
    _build.check(rc, name, "cache_insert")
    _build.count_launch(name)
    _build.count_launch(f"{name}[fused]")
    if kv4:
        _build.count_launch(f"{name}[kv4]")
    return out


# q_out, q, k, v, slot strides of q, k, v, cos, sin, k_codes, k_scale,
# v_codes, v_scale, lengths, layer, s0, S, B, Hq, Hkv, Dh, attn_factor,
# bf16, kv4, stream
_FUSED_ARGTYPES = ([_P] * 4 + [_L] * 3 + [_P] * 7 + [_I] * 7 + [_F, _I, _I]
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
    - s0`` of ``layer`` (positions outside ``[0, S)`` write nothing); at
    ``kv_bits=4`` into the int4 cache, uint8 codes ``[L, B, Hkv/2, S, Dh]``
    packed across head pairs (:func:`~quant_tpu_torch.kernels.rope_kv.
    quantize_kv`) beside the same scales. q, k and v are bf16 or f32 and
    may be strided views of one projection row. Returns the rotated q
    ``[B, Hq, Dh]`` in their dtype. Interleaved rotary pairs, ``kv_bits``
    other than 8 or 4 and T > 1 raise."""
    _fused_checks(q, interleaved, kv_bits)
    if q.device.type == "cpu":
        return cache_insert_int8_fused_reference(
            q, k, v, cos, sin, kc, ks, vc, vs, lengths, layer, s0,
            attn_factor=attn_factor, kv_bits=kv_bits)
    if kc.dim() != 5:
        raise ValueError("expected stacked caches [L, B, H, S, D]")
    shape = (kc.shape[0], q.shape[0], k.shape[2], kc.shape[3], q.shape[3])
    return _fused_launch("cache_insert_int8_fused_launch", _FUSED_ARGTYPES,
                         "cache_insert_int8", q, k, v, cos, sin,
                         (kc, ks, vc, vs), shape, lengths, (),
                         (layer, s0, kc.shape[3]), attn_factor, kv_bits)


# q_out, q, k, v, slot strides of q, k, v, cos, sin, k_codes, k_scale,
# v_codes, v_scale, page_tbl, lengths, layer, P, page, max_pages, B, Hq,
# Hkv, Dh, attn_factor, bf16, kv4, stream
_PAGED_FUSED_ARGTYPES = ([_P] * 4 + [_L] * 3 + [_P] * 8 + [_I] * 8
                         + [_F, _I, _I] + [_P])


def paged_cache_insert_int8_fused(q, k, v, cos, sin, kc, ks, vc, vs, lengths,
                                  layer: int, page_tbl, *,
                                  attn_factor: float | None = None,
                                  interleaved: bool = False,
                                  kv_bits: int = 8):
    """:func:`cache_insert_int8_fused` into the page pools ``[L, P, Hkv,
    page, Dh]`` / ``[L, P, Hkv, page]``: the K/V rows go to
    ``(page_tbl[b, pos // page], pos % page)`` of ``layer`` with ``pos =
    lengths[b]``; positions outside ``[0, max_pages * page)`` write nothing,
    a parked slot (length 0, table row 0) writes into the scratch page 0;
    ``kv_bits=4`` writes the int4 pool (codes ``[L, P, Hkv/2, page, Dh]``).
    Returns the rotated q ``[B, Hq, Dh]``."""
    _fused_checks(q, interleaved, kv_bits)
    if q.device.type == "cpu":
        return paged_cache_insert_int8_fused_reference(
            q, k, v, cos, sin, kc, ks, vc, vs, lengths, layer, page_tbl,
            attn_factor=attn_factor, kv_bits=kv_bits)
    if kc.dim() != 5:
        raise ValueError("expected page pools [L, P, H, page, D]")
    l, n_pool, _, page, _ = kc.shape
    b, max_pages = q.shape[0], page_tbl.shape[-1]
    shape = (l, n_pool, k.shape[2], page, q.shape[3])
    return _fused_launch("paged_cache_insert_int8_fused_launch",
                         _PAGED_FUSED_ARGTYPES, "paged_cache_insert_int8", q,
                         k, v, cos, sin, (kc, ks, vc, vs), shape, lengths,
                         ((page_tbl, torch.int32, (b, max_pages)),),
                         (layer, n_pool, page, max_pages), attn_factor,
                         kv_bits)


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


def mla_latent_rows(ckv, q_pe, q_abs, norm_w, cos, sin, dq: int, *,
                    eps: float, attn_factor: float | None = None,
                    interleaved: bool = False):
    """The MLA step's query and latent rows before quantization, in plain
    PyTorch (the model's unfused path and the fused insert's plain version
    both run this): ``c = rmsnorm(ckv[..., :r], norm_w, eps)``, RoPE of
    ``q_pe`` ``[B, T, H, dr]`` and of ``k_pe = ckv[..., r:]`` with the
    tables ``cos`` / ``sin`` ``[B, T, 1, dr/2]`` (``interleaved`` pairs
    de-interleaved first, times ``attn_factor``), then ``q_eff = [q_abs |
    q_pe | 0]`` ``[B, T, H, dq]`` and ``lat = [c | k_pe | 0]`` ``[B, T, 1,
    dq]``, both in ``q_abs``'s dtype. ``ckv`` ``[B, T, r + dr]``."""
    dt = q_abs.dtype
    r = norm_w.shape[-1]
    opts = {"interleaved": interleaved, "attn_factor": attn_factor}
    c = rmsnorm(ckv[..., :r], norm_w, eps)
    q_pe = rope_apply(q_pe, cos, sin, **opts)
    k_pe = rope_apply(ckv[..., r:][:, :, None, :], cos, sin, **opts)
    q_eff = torch.cat([q_abs, q_pe.to(dt)], dim=-1)
    lat = torch.cat([c, k_pe[:, :, 0].to(c.dtype)], dim=-1)[:, :, None, :]
    pad = dq - lat.shape[-1]
    if pad:
        # zero lanes up to the cache row width, in the query too: scores
        # and the value prefix are exact
        q_eff = torch.nn.functional.pad(q_eff, (0, pad))
        lat = torch.nn.functional.pad(lat, (0, pad))
    return q_eff, lat.to(dt)


def mla_cache_insert_int8_fused_reference(ckv, q_pe, q_abs, norm_w, cos,
                                          sin, kc, ks, lengths, layer: int,
                                          s0: int = 0, *, eps: float,
                                          attn_factor: float | None = None,
                                          interleaved: bool = False,
                                          page_tbl=None):
    """Plain version of :func:`mla_cache_insert_int8_fused`: the chain the
    model runs without the kernel, unchanged (:func:`mla_latent_rows`, i.e.
    :func:`rmsnorm`, :func:`rope_apply`, ``torch.cat`` and the pad; then
    :func:`quantize_kv` and :func:`mla_cache_insert_int8_reference`, or
    :func:`paged_insert_rows` into the latent pool under ``page_tbl``).
    Returns q_eff ``[B, H, Dq]``."""
    if page_tbl is not None and s0:
        raise ValueError("the latent pool takes no sequence offset s0")
    q_eff, lat = mla_latent_rows(ckv, q_pe, q_abs, norm_w, cos, sin,
                                 kc.shape[-1], eps=eps,
                                 attn_factor=attn_factor,
                                 interleaved=interleaved)
    k_q, k_s = quantize_kv(lat)
    if page_tbl is None:
        mla_cache_insert_int8_reference(kc, ks, k_q, k_s, lengths, layer, s0)
    else:
        paged_insert_rows(kc, ks, k_q, k_s, lengths, layer, page_tbl)
    return q_eff[:, 0]


# q_out, q_abs, q_pe, ckv, slot and head strides of q_abs and q_pe, slot
# stride of ckv, norm_w, cos, sin, k_codes, k_scale, lengths, layer, s0, S,
# B, H, r, dr, Dq, eps, attn_factor, interleaved, vec, bf16, stream
_MLA_FUSED_ARGTYPES = ([_P] * 4 + [_L] * 5 + [_P] * 6 + [_I] * 8 + [_F] * 2
                       + [_I] * 3 + [_P])
# the same with page_tbl before lengths and P, page, max_pages in place of
# s0, S
_PAGED_MLA_FUSED_ARGTYPES = ([_P] * 4 + [_L] * 5 + [_P] * 7 + [_I] * 9
                             + [_F] * 2 + [_I] * 3 + [_P])


def mla_cache_insert_int8_fused(ckv, q_pe, q_abs, norm_w, cos, sin, kc, ks,
                                lengths, layer: int, s0: int = 0, *,
                                eps: float, attn_factor: float | None = None,
                                interleaved: bool = False, kv_bits: int = 8,
                                page_tbl=None):
    """One decode step's MLA latent row and query of one layer, in one
    launch: ``c = rmsnorm(ckv[:, 0, :r], norm_w, eps)``; RoPE of ``k_pe =
    ckv[:, 0, r:]`` and of ``q_pe`` ``[B, 1, H, dr]`` with the tables
    ``cos`` / ``sin`` ``[B, 1, 1, dr/2]`` f32 (``interleaved`` rotary pairs,
    times ``attn_factor``); the latent row ``[c | k_pe | 0]`` of the cache's
    ``Dq`` lanes quantized to int8 with one f32 scale and written in place
    into the stacked latent cache ``[L, B, 1, S, Dq]`` / ``[L, B, 1, S]`` at
    row ``lengths[b] - s0`` of ``layer`` (positions outside ``[0, S)``
    write nothing), or, given ``page_tbl`` int32 ``[B, max_pages]``, into
    the latent pool ``[L, P, 1, page, Dq]`` / ``[L, P, 1, page]`` at
    ``(page_tbl[b, pos // page], pos % page)`` with ``pos = lengths[b]``
    (positions outside ``[0, max_pages * page)`` write nothing; a parked
    slot, length 0 and table row 0, writes into the scratch page 0; each
    launch counts under ``[paged]`` too). ``ckv`` ``[B, 1, r + dr]``, ``q_pe`` and ``q_abs``
    (``[B, 1, H, r]``, the ``w_uk`` product) are bf16 or f32 and may be
    strided views (unit lane stride); ``norm_w`` is the f32 gain ``[r]``.
    The kernel takes r up to 512 and an even dr up to 256. Returns ``q_eff =
    [q_abs | RoPE(q_pe) | 0]`` ``[B, H, Dq]`` in their dtype, for every
    slot. ``kv_bits`` other than 8 and T > 1 raise."""
    if kv_bits != 8:
        raise NotImplementedError(f"kv_bits {kv_bits} is not ported for the "
                                  "MLA latent")
    paged = page_tbl is not None
    if paged and s0:
        raise ValueError("the latent pool takes no sequence offset s0")
    if q_abs.dim() != 4 or q_abs.shape[1] != 1:
        raise ValueError("the fused MLA insert is the decode (T=1) path: "
                         f"q_abs [B, 1, H, r], got {tuple(q_abs.shape)}")
    opts = {"eps": eps, "attn_factor": attn_factor,
            "interleaved": interleaved}
    if q_abs.device.type == "cpu":
        return mla_cache_insert_int8_fused_reference(
            ckv, q_pe, q_abs, norm_w, cos, sin, kc, ks, lengths, layer, s0,
            page_tbl=page_tbl, **opts)
    dev = q_abs.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if kc.dim() != 5 or kc.shape[2] != 1:
        raise ValueError("expected a stacked latent cache [L, B, 1, S, Dq] "
                         "or a latent pool [L, P, 1, page, Dq]")
    b, _, h, r = q_abs.shape
    dr = q_pe.shape[-1]
    l, n_rows, _, s, dq = kc.shape      # s: the page size in a pool
    if not paged and n_rows != b:
        raise ValueError(f"a cache of {n_rows} slots for {b} rows")
    if q_abs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"activations must be bf16 or f32, got "
                         f"{q_abs.dtype}")
    if not (r <= 512 and dr % 2 == 0 and 2 <= dr <= 256 and r + dr <= dq):
        raise ValueError(f"the kernel takes r <= 512 and an even dr up to "
                         f"256 with r + dr <= Dq, got r {r}, dr {dr}, Dq "
                         f"{dq}")
    for t, shape in ((ckv, (b, 1, r + dr)), (q_pe, (b, 1, h, dr)),
                     (q_abs, (b, 1, h, r))):
        # views into the projections' outputs: any slot and head stride
        if (t.dtype != q_abs.dtype or tuple(t.shape) != shape
                or t.device != dev or t.stride(-1) != 1):
            raise ValueError(f"expected {q_abs.dtype} {shape} with unit "
                             f"lane stride on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    checks = ((kc, torch.int8, (l, n_rows, 1, s, dq)),
              (ks, torch.float32, (l, n_rows, 1, s)),
              (norm_w, torch.float32, (r,)),
              (cos, torch.float32, (b, 1, 1, dr // 2)),
              (sin, torch.float32, (b, 1, 1, dr // 2)),
              (lengths, torch.int32, (b,)))
    if paged:
        checks += ((page_tbl, torch.int32, (b, page_tbl.shape[-1])),)
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("caches, gain, tables and lengths must be "
                             "contiguous on the activations' device")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    esz = q_abs.element_size()
    # q_abs rows copied with 16-byte accesses where every row is aligned
    vec = all((n * esz) % 16 == 0 for n in (r, dq, q_abs.stride(0),
                                              q_abs.stride(2)))
    vec = vec and q_abs.data_ptr() % 16 == 0
    out = torch.empty((b, h, dq), dtype=q_abs.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (out.data_ptr(), q_abs.data_ptr(), q_pe.data_ptr(),
            ckv.data_ptr(), q_abs.stride(0), q_abs.stride(2), q_pe.stride(0),
            q_pe.stride(2), ckv.stride(0), norm_w.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), kc.data_ptr(), ks.data_ptr())
    tail = (b, h, r, dr, dq, eps, 1.0 if attn_factor is None else attn_factor,
            int(interleaved), int(vec), int(q_abs.dtype == torch.bfloat16),
            stream)
    if paged:
        fn = _build.entry("cache_insert",
                          "paged_mla_cache_insert_int8_fused_launch",
                          _PAGED_MLA_FUSED_ARGTYPES)
        rc = fn(*head, page_tbl.data_ptr(), lengths.data_ptr(), layer,
                n_rows, s, page_tbl.shape[-1], *tail)
    else:
        fn = _build.entry("cache_insert",
                          "mla_cache_insert_int8_fused_launch",
                          _MLA_FUSED_ARGTYPES)
        rc = fn(*head, lengths.data_ptr(), layer, s0, s, *tail)
    _build.check(rc, "mla_cache_insert_int8", "cache_insert")
    _build.count_launch("mla_cache_insert_int8")
    _build.count_launch("mla_cache_insert_int8[fused]")
    if paged:
        _build.count_launch("mla_cache_insert_int8[paged]")
    return out
