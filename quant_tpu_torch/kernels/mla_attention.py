"""MLA (DeepSeek) flash-decode attention over the int8 latent cache or
latent pool (T=1).

The port of the JAX package's ``kernels/mla_attention.py``
(``mla_flash_decode_int8``). In the absorbed form, decode attention is MQA
with one shared latent row per token: queries ``q_eff [B, H, Dq]`` against
cache rows ``[c_kv | k_rope | zero pad]`` (``Dq`` int8 codes and one f32
scale per row), and the value read is the row's first ``r`` lanes:
``out = softmax(scale * q_eff . k * ks) @ (ks * k[:, :r])``. The CUDA kernel
is ``csrc/mla_attention.cu``, whose header note gives its design;
:func:`mla_flash_decode_int8` launches it for tensors on the card and takes
the plain version :func:`mla_flash_decode_int8_reference` only for tensors
on the CPU: on a CUDA tensor it launches or raises, it never falls back.

The latent rows lie in the contiguous stacked cache ``[L, B, 1, S, Dq]``
or, given ``page_tbl``, in the paged latent pool ``[L, P, 1, page, Dq]``
that the engine's allocator shares between slots (the GQA pool's layout of
``kernels/paged_attention.py`` with one head): slot b's token t lies on
page ``page_tbl[b, t // page]``. The kernel reads the pool through the
table, so decode copies nothing; the JAX package gathers each slot's pages
per layer instead (``paged_gather``, then ``attention``), and that is the
plain version here.

Each call runs one of two paths, chosen from q's dtype and the widths
(:func:`mla_decode_path`) and counted under its name beside the kernel's
total (``mla_flash_decode_int8[tc]``, ``[cuda_core]``; a call over the pool
also under ``[paged]``): the tensor cores for bf16 q (the serving path),
CUDA-core dots otherwise. :func:`mla_decode_plan` sizes the call's grid and
workspace from static ints alone (B, H, S, Dq, r and the SM count; S =
``max_pages * page`` over the pool), so the wrapper never reads ``lengths``
or the table on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels.dequant_matmul import _count, _sm_count
from quant_tpu_torch.kernels.paged_attention import paged_gather

__all__ = ["mla_flash_decode_int8", "mla_flash_decode_int8_reference",
           "mla_decode_plan", "mla_decode_path", "MlaDecodePlan"]

_TILE = 64         # csrc/mla_attention.cu TT: tokens per ring stage
_HT = 16           # HT: heads per mma row tile
_MAX_DQ = 1024     # MAX_DQ
_MAX_R = 512       # MAX_R
_SMEM_MAX = 232448  # SMEM_MAX: the dynamic shared memory a block may use
_MAX_CHUNK = 4096  # MAX_CHUNK: the largest chunk
# MAX_IDS: page ids a block of the paged pool holds, chunk / page + 2 of
# them: every chunk fits at pages of 8 tokens or more
_MAX_IDS = _MAX_CHUNK // 8 + 2
_WIDE_HEADS = 32   # heads per block of the tensor-core path at many heads


def _ring_bytes(dq: int) -> int:
    """``ring_bytes``: two stages of 64 rows of Dq rounded up to 128 bytes
    and 64 scales."""
    return 2 * (_TILE * -(-dq // 128) * 128 + _TILE * 4)


def _tc_smem(dq: int, heads: int) -> int:
    """``tc_smem``: the ring, then per row tile of 16 heads the q fragments,
    the probabilities and the (max, sum) per token group, then the partial
    scores of the Dq parts past the first."""
    groups, rt = -(-(dq // 16) // 4), heads // _HT
    return (_ring_bytes(dq) + rt * (groups * 2048 + 4096 + 512)
            + (4 // rt - 1) * rt * 4096)


@dataclasses.dataclass(frozen=True)
class MlaDecodePlan:
    """A latent-attention call's split, from static ints only.

    Block ``(bg, c)`` of the ``blocks = B * groups * n_chunks`` blocks owns
    heads ``[g * heads, (g + 1) * heads)`` (``g = bg % groups``) of slot
    ``bg // groups`` and tokens ``[c * chunk, min(length, (c + 1) *
    chunk))``, walked in ``_TILE``-token tiles; a block whose chunk starts
    at or past the length exits, except chunk 0 of an empty slot, which
    writes its zeros. The workspace holds, per (slot, head group, chunk,
    head of the block), the chunk's unnormalised output (``part_o`` floats
    in all) and its (max, sum) (``part_ml``); ``counters`` int32 zeros, one
    per (slot, head group), elect the block that merges them."""
    heads: int
    groups: int
    chunk: int
    n_chunks: int
    blocks: int
    part_o: int
    part_ml: int
    counters: int


def mla_decode_plan(b: int, h: int, s: int, dq: int, r: int,
                    sms: int = 132, path: str = "tc") -> MlaDecodePlan:
    """The split of a call on ``path`` (:func:`mla_decode_path`) over ``b``
    slots of ``s`` tokens, ``h`` heads, rows of ``dq`` lanes and values of
    ``r``, on a card of ``sms`` SMs. Heads per block: 16 on the CUDA cores;
    on the tensor cores up to ``_WIDE_HEADS`` (each staged row read once
    for all of a block's heads) where the shared memory fits. Chunks are the
    shortest that keep a full batch's grid within two blocks per SM (one
    for the tensor cores' 16-head blocks: their 64-token tile takes about
    3.7 us and merging each chunk's partial about 0.36 us, so fewer, longer
    chunks win there) and the merge's weights within the ring (a multiple
    of the tile, at most ``_MAX_CHUNK``; ``tools/attn_probe.py mla
    plan``)."""
    heads = _HT
    while (path == "tc" and heads < min(h, _WIDE_HEADS)
           and _tc_smem(dq, 2 * heads) <= _SMEM_MAX):
        heads *= 2
    per_sm = 1 if path == "tc" and heads == _HT else 2
    groups = -(-h // heads)

    def n(c: int) -> int:
        return max(1, -(-s // c))
    chunk = _TILE
    while chunk < _MAX_CHUNK and (
            b * groups * n(chunk) > per_sm * sms
            or n(chunk) * heads * 4 > _ring_bytes(dq)):
        chunk *= 2
    nc = n(chunk)
    if b * groups * nc >= 2 ** 31:
        raise ValueError(f"{b * groups * nc} blocks exceed CUDA's grid")
    parts = b * groups * nc * heads if nc > 1 else 0
    return MlaDecodePlan(heads=heads, groups=groups, chunk=chunk, n_chunks=nc,
                         blocks=b * groups * nc, part_o=parts * r,
                         part_ml=parts * 2, counters=b * groups)


def mla_decode_path(q: torch.Tensor, dq: int, r: int) -> str:
    """The path a call takes: the tensor cores for bf16 q with Dq and r
    multiples of 32 and 16-byte aligned rows, CUDA-core dots otherwise."""
    if (q.dtype == torch.bfloat16 and dq % 32 == 0 and r % 32 == 0
            and q.data_ptr() % 16 == 0):
        return "tc"
    return "cuda_core"


def mla_flash_decode_int8_reference(q, k_codes, k_scale, lengths, layer=None,
                                    *, r: int, scale: float, page_tbl=None):
    """Plain version, in float32: ``q [B, H, Dq]`` against the latent cache
    ``[B, 1, S, Dq]`` / ``[B, 1, S]`` (or stacked ``[L, ...]`` with
    ``layer``), or against layer ``layer`` of the latent pool ``[L, P, 1,
    page, Dq]`` / ``[L, P, 1, page]`` gathered through ``page_tbl``
    (:func:`~quant_tpu_torch.kernels.paged_attention.paged_gather`). Rows
    at positions ``>= lengths[b]`` are masked; the output ``[B, H, r]`` is
    ``sum(p * ks * k[:, :r]) / max(sum(p), 1e-20)`` in ``q.dtype``, so a
    slot of length 0 gives zeros."""
    if page_tbl is not None:
        kc = paged_gather(k_codes, page_tbl, layer)
        ks = paged_gather(k_scale, page_tbl, layer)
    else:
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


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, q_bf16, tc, k_codes, k_scale, lengths, out, part_o, part_ml, counters,
# layer, B, H, S, Dq, r, heads_per_block, chunk, n_chunks, scale, stream
_ARGTYPES = [_P, _I, _I] + [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P]
# q, q_bf16, tc, k_codes, k_scale, page_tbl, lengths, out, part_o, part_ml,
# counters, layer, B, H, P, page, max_pages, Dq, r, heads_per_block, chunk,
# n_chunks, scale, stream
_PAGED_ARGTYPES = [_P, _I, _I] + [_P] * 8 + [_I] * 11 + [ctypes.c_float, _P]


def mla_flash_decode_int8(q, k_codes, k_scale, lengths, layer=None, *,
                          r: int, scale: float, page_tbl=None):
    """Latent attention output ``[B, H, r]`` in ``q.dtype``.

    ``q`` ``[B, H, Dq]`` float32 or bfloat16; ``k_codes`` int8
    ``[B, 1, S, Dq]``, or stacked ``[L, B, 1, S, Dq]`` with ``layer``;
    ``k_scale`` f32 ``[.., 1, S]``, one scale per latent row; ``lengths``
    int32 ``[B]``; ``r`` the value width (``kv_lora_rank``); ``scale`` the
    score scale. With ``page_tbl`` int32 ``[B, max_pages]`` the codes and
    scales are the latent pool ``[L, P, 1, page, Dq]`` / ``[L, P, 1,
    page]`` and ``layer`` is required; slot b's token t lies on page
    ``page_tbl[b, t // page]``, table entries past a slot's length are never
    read. Pages of fewer than 8 tokens are refused where a chunk of the
    plan would need more page ids than a block holds (``_MAX_IDS``)."""
    if k_codes.dtype != torch.int8:
        raise NotImplementedError("only the int8 latent cache is ported "
                                  "(kv_bits 8)")
    paged = page_tbl is not None
    if paged and (layer is None or k_codes.dim() != 5):
        raise ValueError("the latent pool [L, P, 1, page, Dq] needs a layer "
                         "index")
    if q.device.type == "cpu":
        return mla_flash_decode_int8_reference(q, k_codes, k_scale, lengths,
                                               layer, r=r, scale=scale,
                                               page_tbl=page_tbl)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    stacked = k_codes.dim() == 5
    if stacked and layer is None:
        raise ValueError("stacked caches require a layer index")
    if not stacked:
        k_codes, k_scale, layer = k_codes[None], k_scale[None], 0
    h = q.shape[1]
    if paged:
        l, n_pool, one, page, dq = k_codes.shape
        b, max_pages = page_tbl.shape
        s = max_pages * page
        rows = (l, n_pool, 1, page)
    else:
        l, b, one, s, dq = k_codes.shape
        rows = (l, b, 1, s)
    if one != 1:
        raise ValueError(f"an MLA cache holds one latent row per token, got "
                         f"{one} heads")
    if dq % 16 or dq > _MAX_DQ or r % 2 or not 0 < r <= min(dq, _MAX_R):
        raise ValueError(f"kernel takes Dq a multiple of 16 up to {_MAX_DQ} "
                         f"and an even r up to min(Dq, {_MAX_R}), got Dq "
                         f"{dq}, r {r}")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    checks = ((q, q.dtype, (b, h, dq)),
              (k_scale, torch.float32, rows),
              (lengths, torch.int32, (b,)))
    if paged:
        checks += ((page_tbl, torch.int32, (b, max_pages)),)
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (q, k_codes, k_scale, lengths) + ((page_tbl,) if paged else ()):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if k_codes.data_ptr() % 16:
        raise ValueError("the latent cache must be 16-byte aligned")
    out = torch.empty((b, h, r), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0:
        return out
    path = mla_decode_path(q, dq, r)
    plan = mla_decode_plan(b, h, s, dq, r, _sm_count(q.device), path)
    if paged and plan.chunk // page + 2 > _MAX_IDS:
        raise ValueError(f"pages of {page} tokens are too small for chunks "
                         f"of {plan.chunk}")
    part_o = part_ml = counters = None
    if plan.n_chunks > 1:
        part_o = torch.empty(plan.part_o, dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(plan.part_ml, dtype=torch.float32,
                              device=q.device)
        counters = _build.zero_counters(q.device, plan.counters)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), int(q.dtype == torch.bfloat16), int(path == "tc"),
            k_codes.data_ptr(), k_scale.data_ptr())
    work = (out.data_ptr(), None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if counters is None else counters.data_ptr(), layer, b, h)
    tail = (dq, r, plan.heads, plan.chunk, plan.n_chunks, float(scale),
            stream)
    if paged:
        fn = _build.entry("mla_attention",
                          "paged_mla_flash_decode_int8_launch",
                          _PAGED_ARGTYPES)
        rc = fn(*head, page_tbl.data_ptr(), lengths.data_ptr(), *work,
                n_pool, page, max_pages, *tail)
    else:
        fn = _build.entry("mla_attention", "mla_flash_decode_int8_launch",
                          _ARGTYPES)
        rc = fn(*head, lengths.data_ptr(), *work, s, *tail)
    _build.check(rc, "mla_flash_decode_int8", "mla_attention")
    _count("mla_flash_decode_int8", path, *(("paged",) if paged else ()))
    return out
