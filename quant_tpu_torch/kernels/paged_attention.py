"""Paged INT8- and INT4-KV flash-decode attention (decode step, T=1).

The port of the JAX package's ``kernels/paged_attention.py``. The KV cache
lives in a page pool shared by all slots::

    pool codes  int8 [L, P, Hkv, page, Dh]   (kv4: uint8 [L, P, Hkv/2,
                                               page, Dh], head pairs)
    pool scales f32  [L, P, Hkv, page]

and each slot owns an ordered list of page ids ``page_tbl int32
[B, max_pages]`` that the engine's allocator fills. Entries past a slot's
allocated pages may hold any valid id (often the scratch page 0); they are
never read by the kernel and masked in the plain version.

The CUDA kernel is ``paged_flash_decode`` in ``csrc/flash_decode.cu`` (the
contiguous kernel's body, addressing rows through the page table; each
block loads the page ids of its own chunk on the card);
:func:`paged_flash_decode_int8` launches it for tensors on the card, on the
path and under the plan of the contiguous kernel
(:func:`~quant_tpu_torch.kernels.attention.decode_path`, ``decode_plan`` at
``S = max_pages * page``), counted as ``paged_flash_decode_int8[tc]`` or
``[cuda_core]`` (and ``[window]`` / ``[softcap]`` / ``[kv4]``), and takes the
plain version
:func:`paged_attention_reference` only for tensors on the CPU.
:func:`paged_gather` builds a slot-contiguous copy of one layer's pages for
the plain versions and for prefill.
"""

from __future__ import annotations

import ctypes

import torch

from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels.attention import (
    _check_q, _count_call, _sm_count, _window, _workspace, decode_path,
    decode_plan, flash_decode_int8_reference, kv_layout)

__all__ = ["paged_flash_decode_int8", "paged_attention_reference",
           "paged_gather"]


def paged_gather(pool, page_tbl, layer):
    """A slot-contiguous ``[B, Hkv, max_pages * page, ...]`` copy of layer
    ``layer`` of ``pool`` (codes ``[L, P, Hkv, page, Dh]`` or scales
    ``[L, P, Hkv, page]``) through ``page_tbl [B, max_pages]``."""
    g = pool[layer][page_tbl.to(torch.int64)]   # [B, n_pages, Hkv, page, ...]
    g = g.movedim(2, 1)                         # [B, Hkv, n_pages, page, ...]
    b, hkv, n_pages, page = g.shape[:4]
    return g.reshape(b, hkv, n_pages * page, *g.shape[4:])


def paged_attention_reference(q, pool_kc, pool_ks, pool_vc, pool_vs,
                              page_tbl, lengths, layer, window=None, *,
                              softcap: float = 0.0, scale=None):
    """Plain version, in float32: gathers each slot's pages into a
    contiguous view and attends over it like
    :func:`~quant_tpu_torch.kernels.attention.flash_decode_int8_reference`
    (window and softcap included; a slot of length 0 gives zeros, as the
    kernel does)."""
    return flash_decode_int8_reference(
        q, paged_gather(pool_kc, page_tbl, layer),
        paged_gather(pool_ks, page_tbl, layer),
        paged_gather(pool_vc, page_tbl, layer),
        paged_gather(pool_vs, page_tbl, layer), lengths, None, window,
        softcap=softcap, scale=scale)


_MAX_IDS = 4096 // 8 + 2  # csrc/flash_decode.cu MAX_IDS: page ids per block

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, q_bf16, tc, k_codes, k_scale, v_codes, v_scale, page_tbl, lengths, out,
# part_o, part_ml, counters, layer, B, Hkv (code heads), P, page, max_pages,
# Dh, rep, kv4, scale, window, softcap, chunk, n_chunks, stream
_ARGTYPES = ([_P, _I, _I] + [_P] * 10 + [_I] * 9 + [ctypes.c_float, _I,
                                                    ctypes.c_float]
             + [_I] * 2 + [_P])


def paged_flash_decode_int8(q, pool_kc, pool_ks, pool_vc, pool_vs, page_tbl,
                            lengths, layer, window=None, *,
                            softcap: float = 0.0,
                            scale: float | None = None):
    """Attention output ``[B, Hq, Dh]`` in ``q.dtype`` over the page pool.

    ``q`` ``[B, Hq, Dh]`` float32 or bfloat16; pools as in the module
    docstring; ``page_tbl`` int32 ``[B, max_pages]``; ``lengths`` int32
    ``[B]`` (keys at positions ``>= lengths[b]`` are masked); ``window`` and
    ``softcap`` as :func:`~quant_tpu_torch.kernels.attention.flash_decode_int8`
    takes them (no page before the window is read); ``scale`` defaults to
    ``1/sqrt(Dh)``."""
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    kv4, hc = kv_layout(pool_kc, pool_ks)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_kc, pool_ks, pool_vc,
                                         pool_vs, page_tbl, lengths, layer,
                                         window, softcap=softcap,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    l, n_pool, _, page, dh = pool_kc.shape
    hkv = pool_ks.shape[2]
    b = q.shape[0]
    max_pages = page_tbl.shape[1]
    rep = _check_q(q, hkv, dh)
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    checks = ((q, q.dtype, (b, hkv * rep, dh)),
              (pool_vc, pool_kc.dtype, (l, n_pool, hc, page, dh)),
              (pool_ks, torch.float32, (l, n_pool, hkv, page)),
              (pool_vs, torch.float32, (l, n_pool, hkv, page)),
              (page_tbl, torch.int32, (b, max_pages)),
              (lengths, torch.int32, (b,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (q, pool_kc, pool_ks, pool_vc, pool_vs, page_tbl, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if pool_kc.data_ptr() % 16 or pool_vc.data_ptr() % 16:
        raise ValueError("the code pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    w = _window(window)
    plan = decode_plan(b, hkv, max_pages * page, rep, dh, _sm_count(q.device),
                       w, kv4)
    if plan.chunk // page + 2 > _MAX_IDS:
        raise ValueError(f"pages of {page} tokens are too small for chunks "
                         f"of {plan.chunk}")
    path = decode_path(q, dh)
    part_o, part_ml, counters = _workspace(plan, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("flash_decode", "paged_flash_decode_int8_launch",
                      _ARGTYPES)
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), int(path == "tc"),
            pool_kc.data_ptr(), pool_ks.data_ptr(), pool_vc.data_ptr(),
            pool_vs.data_ptr(), page_tbl.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if counters is None else counters.data_ptr(), layer, b, hc,
            n_pool, page, max_pages, dh, rep, int(kv4),
            float(scale if scale is not None else 1.0 / dh ** 0.5), w,
            float(softcap), plan.chunk, plan.n_chunks, stream)
    _build.check(rc, "paged_flash_decode_int8", "flash_decode")
    _count_call("paged_flash_decode_int8", path, w, softcap, kv4)
    return out
