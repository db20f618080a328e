"""Llama-family models in PyTorch: INT4/INT8 weights, INT8, INT4 or
unquantized KV cache.

The port of the JAX package's ``models/llama.py`` for the dense families
(Llama-3, Qwen2, Mistral, Gemma, Gemma-2, Gemma-3 and the test configs),
the sparse-MoE family (Mixtral, Qwen3-MoE) and DeepSeek-V2/V3: RMSNorm
(with Gemma's ``offset + w`` gain and Gemma-2's post-block norms),
optional per-head QK-RMSNorm (Qwen3, Gemma-3), rotate-half RoPE with
``none``, ``linear``, ``llama3`` or ``yarn`` scaling (interleaved pairs
de-interleaved first; Gemma-3's local layers on their own base), GQA
attention with an optional q/k/v bias (Qwen2) over an int8 cache with one
f32 scale per (token, head), an int4 one packed across head pairs
(``kv_bits=4``: packed head j holds real heads 2j and 2j+1 in its low and
high nibbles, the scales stay per real head), or an unquantized one
(``kv_bits=16``), under per-layer sliding windows and a tanh logit softcap
(Mistral, Gemma-2/3), or DeepSeek's multi-head latent attention (MLA)
over an int8 (or unquantized) latent cache with one scale per token, and
a GLU MLP (SwiGLU, or Gemma's tanh GeLU), dense or a top-k routed
mixture of experts (with DeepSeek's shared experts, selection bias,
group-limited routing and dense-prefix layers), then Gemma-2's final logit
softcap. Every projection is a
:class:`QTensor` consumed by
:func:`quant_tpu_torch.kernels.dequant_matmul`; the experts by
:func:`quant_tpu_torch.kernels.dequant_matmul.dequant_matmul_moe`. A model
without experts also takes codebook weights (``codebook`` "nf4" or
"lloyd": the table in the kernel at ``lut_runtime`` "word4" or "sel15";
"int8" transcodes at load); every model takes int8 activations
(``act_quant``: W8A8, W4A8, the experts' matmuls too), as the JAX
package's ``_mm`` and ``_moe`` pass them to its kernels. Multi-LoRA
adapters (``params.lora``, ``forward(adapter_ids=)``) add their per-slot
deltas beside the fused projections (``models/lora.py``).

PyTorch idiom in place of JAX's:

* layers are stacked along a leading ``L`` axis like the JAX package, and a
  Python loop over layers replaces ``lax.scan``; ``QTensor.layer(i)`` and
  ``cache[i]`` are views of the stacks, never copies;
* the KV cache is updated IN PLACE (the JAX package threads donated
  buffers); :func:`forward` returns a :class:`KVCache` holding the same
  code/scale tensors and new ``lengths``;
* randomness comes from explicit ``torch.Generator`` objects, and every
  entry point takes an explicit ``device`` (the card unless ``"cpu"``).

The cache is either contiguous (:class:`KVCache`, ``[L, B, Hkv, S, Dh]``)
or a page pool shared by all slots (:class:`PagedKVCache`,
``[L, P, Hkv, page, Dh]`` addressed through per-slot page tables); at
``kv_bits=4`` the code tensors hold ``Hkv/2`` packed heads
(:func:`_kv_code_dims`).

Kernel selection mirrors the JAX ``make_layer_step``: decode (T=1) with an
int8 or int4 cache (``kv_bits`` 8 or 4) takes ``cache_insert_int8_fused``
(RoPE of q and k, K/V quantization and the insert in one launch) then
``flash_decode_int8``
(their paged counterparts over a pool; over an MLA latent cache or latent
pool ``mla_cache_insert_int8_fused``, the latent's RMSNorm, RoPE,
quantization and insert and the query ``q_eff`` in one launch, then
``mla_flash_decode_int8``, both given the pool's page table), each layer's window and the softcap passed to
the decode kernel; ``kv_bits=16`` decodes on the plain path, as the JAX
package does; prefill (T>1) writes the cache with the
plain scatter and runs the plain blockwise attention (over
``paged_gather`` of the slot's pages for a pool). ``kernel_mode="xla"``
selects the plain versions throughout; ``"auto"``/``"pallas"`` select the
CUDA kernels (whose wrappers take the plain versions only for tensors on the
CPU). The MoE dispatch is :func:`mlp_block`'s. Everything outside the ported
slices raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from quant_tpu_torch.core.qtensor import (QTensor, quantize_tensor_device,
                                          resolve_codebook)
from quant_tpu_torch.kernels.attention import flash_decode_int8
from quant_tpu_torch.kernels.cache_insert import (
    cache_insert_int8_fused, mla_cache_insert_int8_fused, mla_latent_rows,
    paged_cache_insert_int8_fused, paged_insert_rows)
from quant_tpu_torch.kernels.dequant_matmul import (dequant_matmul,
                                                    dequant_matmul_moe,
                                                    dequant_matmul_reference)
from quant_tpu_torch.kernels.mla_attention import mla_flash_decode_int8
from quant_tpu_torch.kernels.paged_attention import (paged_flash_decode_int8,
                                                     paged_gather)
from quant_tpu_torch.kernels.rope_kv import (dequant_kv4, quantize_kv, rmsnorm,
                                             rope_apply)
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.models.lora import LoraBatch, LoraStack
from quant_tpu_torch.utils.device import check_on, resolve_device

__all__ = ["LayerParams", "QEmbed", "LlamaParams", "KVCache", "PagedKVCache",
           "init_params", "init_cache", "init_paged_cache", "forward",
           "check_supported", "moe_route", "mlp_block", "dense_prefix_cfg",
           "layer_windows"]


# ── params ──────────────────────────────────────────────────────────────


@dataclasses.dataclass
class LayerParams:
    """All layers, stacked along axis 0 (``QTensor`` leaves ``[L, ...]``).
    Fused columns: ``wqkv`` packs q|k|v, ``w_gate_up`` packs gate|up.

    A MoE model (``cfg.n_experts > 0``) has no dense MLP: ``router`` scores
    the experts and the expert projections are expert-major ``[E, L, ...]``
    stacks (:func:`_merge_experts` views them as the ``[E*L, ...]`` stack the
    MoE kernel addresses, entry ``e * L + layer``). The down projection's
    contraction dim is zero-padded to a 1024 multiple
    (:func:`_pad_moe_down_k`), as in the JAX package.

    MLA (``cfg.is_mla``): ``wqkv`` is the fused down projection
    ``[D, qpart + r + dr]`` with qpart ``H * (dn + dr)`` (direct q) or
    ``q_lora_rank``, kv_a in the last ``r + dr`` columns; ``w_uk`` / ``w_uv``
    are the per-head key / value up-projections folded into the query and
    output sides (the absorbed form), dense. DeepSeek MoE adds the shared
    experts' GLU (``ws_gate_up`` / ``ws_down``) and the selection bias."""
    wqkv: QTensor        # [L] x [D, (Hq + 2*Hkv) * Dh]
    wo: QTensor          # [L] x [Hq*Dh, D]
    w_gate_up: QTensor | None   # [L] x [D, 2*I]; None for MoE
    w_down: QTensor | None      # [L] x [I, D]; None for MoE
    attn_norm: torch.Tensor   # f32 [L, D]
    mlp_norm: torch.Tensor    # f32 [L, D]
    qkv_bias: torch.Tensor    # f32 [L, (Hq + 2*Hkv) * Dh]; zeros for Llama
    q_norm: torch.Tensor      # f32 [L, Dh]; ones unless cfg.qk_norm
    k_norm: torch.Tensor      # f32 [L, Dh]
    router: torch.Tensor | None = None    # f32 [L, D, E]
    we_gate_up: QTensor | None = None     # [E, L] x [D, 2*I]
    we_down: QTensor | None = None        # [E, L] x [I padded, D]
    w_q_b: QTensor | None = None          # [L] x [q_lora_rank, H*(dn+dr)]
    w_uk: torch.Tensor | None = None      # [L, H, dn, r]
    w_uv: torch.Tensor | None = None      # [L, H, r, dv]
    q_a_norm: torch.Tensor | None = None  # f32 [L, q_lora_rank]
    kv_a_norm: torch.Tensor | None = None  # f32 [L, r]
    ws_gate_up: QTensor | None = None     # [L] x [D, 2 * shared I]
    ws_down: QTensor | None = None        # [L] x [shared I, D]
    router_bias: torch.Tensor | None = None  # f32 [L, E]
    # Gemma-2/3 post-block norms on the attention and MLP outputs;
    # None unless cfg.post_norms
    post_attn_norm: torch.Tensor | None = None  # f32 [L, D]
    post_mlp_norm: torch.Tensor | None = None   # f32 [L, D]


@dataclasses.dataclass
class QEmbed:
    """INT8 per-row quantized embedding table (``embed_bits=8``)."""
    codes: torch.Tensor   # int8 [V, D]
    scales: torch.Tensor  # f32 [V]


@dataclasses.dataclass
class LlamaParams:
    embed: QEmbed | torch.Tensor   # QEmbed, or [V, D] in cfg.dtype
    layers: LayerParams
    final_norm: torch.Tensor       # f32 [D]
    lm_head: QTensor               # [D, V padded]
    # DeepSeek ``first_k_dense``: the dense-prefix stack (MLA attention, a
    # dense MLP of width ``dense_intermediate``), run before ``layers``;
    # None unless the config has one
    layers0: LayerParams | None = None
    # multi-LoRA adapters (``models/lora.py``), rows by global layer; None
    # without adapters
    lora: LoraStack | None = None

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


@dataclasses.dataclass
class KVCache:
    """INT8 KV cache at static ``max_seq``, per-(token, head) f32 scales
    (at ``kv_bits=4`` uint8 codes of ``Hkv/2`` packed heads beside scales
    of ``Hkv``; at ``kv_bits=16`` the codes are the activations and the
    scales ones).
    ``lengths[b]`` = valid tokens of slot b (the next write position).
    An MLA cache holds one latent row per token on the K side
    (``[L, B, 1, S, mla_cache_dim]``, one scale per row) and zero-width V
    tensors, so slot copies treat both kinds alike."""
    k_codes: torch.Tensor   # int8 [L, B, Hkv, S, Dh] (kv4: uint8, Hkv/2)
    k_scale: torch.Tensor   # f32  [L, B, Hkv, S]
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    lengths: torch.Tensor   # int32 [B]

    @property
    def max_seq(self) -> int:
        return self.k_codes.shape[3]


@dataclasses.dataclass
class PagedKVCache:
    """Paged INT8 KV cache: a page pool shared by all slots plus per-slot
    page tables, so device memory is bounded by the pages in use, not by
    slots x max_seq. The engine's allocator owns the tables; entries past a
    slot's length may hold any valid page id (the kernels never read them,
    the plain path masks them). An MLA pool holds one latent row per token
    (``[L, P, 1, page, mla_cache_dim]``) and zero-width V tensors."""
    k_codes: torch.Tensor   # int8 [L, P, Hkv, page, Dh] (kv4: uint8, Hkv/2)
    k_scale: torch.Tensor   # f32  [L, P, Hkv, page]
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    page_tbl: torch.Tensor  # int32 [B, max_pages]
    lengths: torch.Tensor   # int32 [B]

    @property
    def page_size(self) -> int:
        return self.k_codes.shape[3]

    @property
    def max_seq(self) -> int:
        return self.page_tbl.shape[1] * self.page_size


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for anything outside the ported dense,
    sparse-MoE and DeepSeek (MLA) slices."""
    unsupported = {
        f"act_fn={cfg.act_fn!r}": cfg.act_fn not in ("silu", "gelu_tanh"),
        f"rope_scaling={cfg.rope_scaling!r}":
            cfg.rope_scaling not in ("none", "linear", "llama3", "yarn"),
        f"kv_bits={cfg.kv_bits}": cfg.kv_bits not in (4, 8, 16),
        # the JAX reference fails on these (its _merge_experts leaves the
        # [E, L, 16] tables unmerged; ROADMAP.md queue 3)
        "codebook (lut) weights with experts":
            cfg.n_experts and cfg.codebook is not None,
        f"kernel_mode={cfg.kernel_mode!r}":
            cfg.kernel_mode not in ("auto", "pallas", "xla"),
        f"embed_bits={cfg.embed_bits}": cfg.embed_bits not in (8, 16),
        f"dtype={cfg.dtype!r}": cfg.dtype not in ("bfloat16", "float32"),
        f"bits={cfg.bits}": cfg.bits not in (4, 8),
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError("not in the port yet: " + ", ".join(bad))


def _pad_vocab(n: int) -> int:
    """lm_head column padding to a 4096 multiple (same as the JAX package);
    forward slices logits back to vocab_size."""
    return (n + 4095) // 4096 * 4096 if n >= 4096 else n


def _make_embed(table: torch.Tensor, cfg: ModelConfig):
    if cfg.embed_bits == 8:
        t = table.to(torch.float32)
        absmax = t.abs().amax(dim=1)
        scales = torch.where(absmax == 0, torch.ones_like(absmax),
                             absmax / 127.0)
        codes = torch.round(t / scales[:, None]).to(torch.int8)
        return QEmbed(codes=codes, scales=scales)
    return table.to(_dtype(cfg))


def _kv_dtype(cfg: ModelConfig) -> torch.dtype:
    """The cache codes' dtype: int8, uint8 (two head-pair nibbles a byte)
    at ``kv_bits=4``, or the activation type at ``kv_bits=16``."""
    if cfg.kv_bits == 8:
        return torch.int8
    if cfg.kv_bits == 4:
        return torch.uint8
    return _dtype(cfg)


def _kv_code_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, width) of the cache CODE tensors, as the JAX package's
    ``_kv_code_dims``: ``kv_bits=4`` packs nibbles across head pairs
    (packed head j = real heads 2j low | 2j+1 high), so the codes have
    ``Hkv/2`` heads of ``Dh`` bytes; the scales keep ``Hkv``. An MLA
    cache's row is the latent, ``mla_cache_dim`` wide."""
    h = cfg.n_kv_heads // 2 if cfg.kv_bits == 4 else cfg.n_kv_heads
    return h, cfg.mla_cache_dim if cfg.is_mla else cfg.head_dim


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> KVCache:
    check_supported(cfg)
    dev = resolve_device(device)
    # MLA: one latent row [c_kv | k_rope] per token, padded to a 128
    # multiple (the layout contract of the JAX package); V is zero-width
    l, h = cfg.n_layers, cfg.n_kv_heads
    hc, d = _kv_code_dims(cfg)
    cdt = _kv_dtype(cfg)

    def codes(width):
        return torch.zeros((l, batch, hc, max_seq, width), dtype=cdt,
                           device=dev)

    def scales(heads):
        return torch.zeros((l, batch, heads, max_seq), dtype=torch.float32,
                           device=dev)
    return KVCache(
        k_codes=codes(d), k_scale=scales(h),
        v_codes=codes(0 if cfg.is_mla else d),
        v_scale=scales(0 if cfg.is_mla else h),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     n_pages: int, page: int = 128, pipe: int = 1,
                     device=None) -> PagedKVCache:
    """Pool of ``n_pages`` pages (page 0 is the engine's scratch page);
    per-slot tables sized for ``max_seq``. ``n_pages`` below
    ``batch * max_seq / page`` oversubscribes device memory (the point).
    An MLA model's pool holds one latent row per token, ``[L, P, 1, page,
    mla_cache_dim]`` beside ``[L, P, 1, page]`` scales, with zero-width V
    (``[L, P, 1, page, 0]`` / ``[L, P, 0, page]``), as the JAX package
    lays it out. Pipeline stages (``pipe``) are not ported."""
    if pipe != 1:
        raise NotImplementedError("pipeline parallelism is not ported")
    check_supported(cfg)
    dev = resolve_device(device)
    if max_seq % page:
        raise ValueError(f"max_seq {max_seq} must divide by page {page}")
    l, h = cfg.n_layers, cfg.n_kv_heads
    hc, d = _kv_code_dims(cfg)
    dv, hv = (0, 0) if cfg.is_mla else (d, h)
    cdt = _kv_dtype(cfg)
    return PagedKVCache(
        k_codes=torch.zeros((l, n_pages, hc, page, d), dtype=cdt,
                            device=dev),
        k_scale=torch.zeros((l, n_pages, h, page), dtype=torch.float32,
                            device=dev),
        v_codes=torch.zeros((l, n_pages, hc, page, dv), dtype=cdt,
                            device=dev),
        v_scale=torch.zeros((l, n_pages, hv, page), dtype=torch.float32,
                            device=dev),
        page_tbl=torch.zeros((batch, max_seq // page), dtype=torch.int32,
                             device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def dense_prefix_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of the ``first_k_dense`` prefix stack: the same attention,
    a plain dense MLP (no MoE knobs), as in the JAX package."""
    return dataclasses.replace(
        cfg, n_experts=0, first_k_dense=0, n_shared_experts=0,
        router_bias=False, n_expert_groups=0, topk_groups=0)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LlamaParams:
    """Random quantized params made layer by layer on ``device`` from
    ``seed`` (a ``torch.Generator`` there) and quantized where they lie, so
    a full-size model never passes through the host. The weights differ
    from the JAX package's ``init_params`` (another generator); the
    structure is the same, but every norm has a gain of about 1: a Gemma
    norm's weights are stored as deltas from its offset, as its checkpoints
    store them (the JAX init's ones give Gemma's pre-norms a gain of 2,
    which leaves a deep random Gemma chaotic under rounding). For a
    ``first_k_dense`` model, ``layers`` holds
    the ``n_layers - first_k_dense`` MoE layers and ``layers0`` the dense
    prefix; MLA's dense ``w_uk`` / ``w_uv`` are made in the activation
    type."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, it = cfg.dim, cfg.head_dim, cfg.intermediate
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(k, n):
        return torch.randn((k, n), generator=gen, device=dev,
                           dtype=torch.float32) / float(np.sqrt(k))

    def quant(w):
        # a lloyd table is fitted on the host, one per weight, as the JAX
        # package's host init fits it; nf4 quantizes on the device
        cb = cfg.codebook
        if cb == "lloyd":
            cb = resolve_codebook(cb, w)
        return quantize_tensor_device(w, cfg.bits, cfg.group_size,
                                      codebook=cb)

    def stacked(k, n, make, lead):
        """Fill a preallocated ``lead + [...]`` stack (``[L]``, or
        ``[E, L]`` for experts) one weight at a time: the stack is never
        assembled from a list, which would double its peak memory. A
        codebook model's tables stack to ``lead + [16]``."""
        kp = k // 2 if cfg.bits == 4 else k
        codes = torch.empty(lead + (kp, n), device=dev,
                            dtype=torch.uint8 if cfg.bits == 4 else torch.int8)
        scales = torch.empty(lead + (k // cfg.group_size, n),
                             dtype=torch.float32, device=dev)
        lut = (None if cfg.codebook is None
               else torch.empty(lead + (16,), device=dev))
        for idx in np.ndindex(*lead):
            qt = quant(make())
            codes[idx], scales[idx] = qt.codes, qt.scales
            if lut is not None:
                lut[idx] = qt.lut
            del qt
        return QTensor(codes=codes, scales=scales, bits=cfg.bits,
                       group_size=cfg.group_size, shape=(k, n), lut=lut)

    def glu(n_l, width):
        """(gate|up, down) stacks of a dense GLU of ``width``."""
        return (stacked(d, 2 * width, lambda: torch.cat(
            [dense(d, width), dense(d, width)], dim=1), (n_l,)),
            stacked(width, d, lambda: dense(width, d), (n_l,)))

    def gains(shape, drawn: bool, offset: float = 0.0):
        """Norm weights of gain 1 (drawn: 1 + 0.1 N(0, 1)), stored less
        ``offset`` (a Gemma norm's ``offset + w``)."""
        if not drawn:
            return torch.full(shape, 1.0 - offset, dtype=torch.float32,
                              device=dev)
        return (1.0 - offset) + 0.1 * torch.randn(shape, generator=gen,
                                                  device=dev)

    def make_stack(n_l: int, moe_l: bool, inter: int) -> LayerParams:
        if cfg.is_mla:
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            dn, dv, h = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.n_heads
            qw = cfg.q_lora_rank or h * (dn + dr)
            dt = _dtype(cfg)
            attn = dict(
                wqkv=stacked(d, qw + r + dr, lambda: torch.cat(
                    [dense(d, qw), dense(d, r + dr)], dim=1), (n_l,)),
                wo=stacked(h * dv, d, lambda: dense(h * dv, d), (n_l,)),
                qkv_bias=torch.zeros((n_l, qw + r + dr), device=dev),
                w_uk=(torch.randn((n_l, h, dn, r), generator=gen, device=dev)
                      / float(np.sqrt(dn))).to(dt),
                w_uv=(torch.randn((n_l, h, r, dv), generator=gen, device=dev)
                      / float(np.sqrt(r))).to(dt),
                kv_a_norm=gains((n_l, r), True))
            if cfg.q_lora_rank:
                attn["w_q_b"] = stacked(cfg.q_lora_rank, h * (dn + dr),
                                        lambda: dense(cfg.q_lora_rank,
                                                      h * (dn + dr)), (n_l,))
                attn["q_a_norm"] = gains((n_l, cfg.q_lora_rank), True)
        else:
            bias = (0.02 * torch.randn((n_l, qd + 2 * kvd), generator=gen,
                                       device=dev) if cfg.qkv_bias
                    else torch.zeros((n_l, qd + 2 * kvd), device=dev))
            attn = dict(
                wqkv=stacked(d, qd + 2 * kvd, lambda: torch.cat(
                    [dense(d, qd), dense(d, kvd), dense(d, kvd)], dim=1),
                    (n_l,)),
                wo=stacked(qd, d, lambda: dense(qd, d), (n_l,)),
                qkv_bias=bias)
        off = cfg.norm_offset
        lay = LayerParams(
            w_gate_up=None, w_down=None,
            attn_norm=gains((n_l, d), False, off),
            mlp_norm=gains((n_l, d), False, off),
            q_norm=gains((n_l, hd), cfg.qk_norm, off),
            k_norm=gains((n_l, hd), cfg.qk_norm, off), **attn)
        if cfg.post_norms:
            lay.post_attn_norm = gains((n_l, d), True, off)
            lay.post_mlp_norm = gains((n_l, d), True, off)
        if not moe_l:
            lay.w_gate_up, lay.w_down = glu(n_l, inter)
            return lay
        e = cfg.n_experts
        lay.router = torch.randn((n_l, d, e), generator=gen, device=dev) * 0.5
        lay.we_gate_up = stacked(d, 2 * it, lambda: torch.cat(
            [dense(d, it), dense(d, it)], dim=1), (e, n_l))
        lay.we_down = stacked(_padded_k(it), d,
                              lambda: _pad_moe_down_k(dense(it, d)), (e, n_l))
        if cfg.n_shared_experts:
            lay.ws_gate_up, lay.ws_down = glu(n_l,
                                              cfg.n_shared_experts * it)
        if cfg.router_bias:
            lay.router_bias = torch.randn((n_l, e), generator=gen,
                                          device=dev) * 0.5
        return lay

    moe = cfg.n_experts > 0
    k0 = cfg.first_k_dense
    layers0 = (make_stack(k0, False, cfg.dense_intermediate or it)
               if k0 else None)
    layers = make_stack(cfg.n_layers - k0, moe, it)
    embed = _make_embed(
        torch.randn((cfg.vocab_size, d), generator=gen, device=dev) * 0.02,
        cfg)
    head = dense(d, cfg.vocab_size)
    v_pad = _pad_vocab(cfg.vocab_size)
    if v_pad != cfg.vocab_size:
        head = torch.nn.functional.pad(head, (0, v_pad - cfg.vocab_size))
    lm_head = quant(head)
    del head
    return LlamaParams(embed=embed, layers=layers,
                       final_norm=gains((d,), False, cfg.norm_offset),
                       lm_head=lm_head, layers0=layers0)


# ── math blocks ─────────────────────────────────────────────────────────


def _embed_lookup(embed, tokens: torch.Tensor, dt: torch.dtype,
                  cfg: ModelConfig | None = None):
    """Embedding rows in ``dt``; Gemma's (``embed_scale``) times
    ``sqrt(dim)`` rounded to ``dt``, as the JAX package scales them."""
    if isinstance(embed, QEmbed):
        rows = embed.codes[tokens].to(torch.float32)
        h = (rows * embed.scales[tokens][..., None]).to(dt)
    else:
        h = embed[tokens].to(dt)
    if cfg is not None and cfg.embed_scale:
        h = h * torch.tensor(float(np.sqrt(cfg.dim)), dtype=dt)
    return h


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def _act(cfg: ModelConfig):
    """Gate activation of the GLU MLP (computed in f32): SiLU, or Gemma's
    tanh-approximated GeLU."""
    if cfg.act_fn == "gelu_tanh":
        return _gelu_tanh
    if cfg.act_fn != "silu":
        raise NotImplementedError(f"act_fn {cfg.act_fn!r} is not ported")
    return torch.nn.functional.silu


def _padded_k(k: int) -> int:
    """Rows of a MoE down projection after :func:`_pad_moe_down_k`."""
    return -(-k // 1024) * 1024


def _pad_moe_down_k(w):
    """Zero-pad the MoE down projection's [K, N] contraction dim (the
    per-expert intermediate I) to a 1024 multiple before quantization, as
    the JAX package does at tp=1 (Qwen3-30B-A3B: 768 -> 1024; Mixtral's
    14336 needs none). Zero rows quantize to zero codes and
    :func:`_pad_x_to_k` zero-pads x to match, so the product is exact.
    Takes a numpy array or a tensor."""
    pad = _padded_k(w.shape[0]) - w.shape[0]
    if not pad:
        return w
    if isinstance(w, np.ndarray):
        return np.pad(w, ((0, pad), (0, 0)))
    return torch.nn.functional.pad(w, (0, 0, 0, pad))


def _pad_x_to_k(a: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad the last dim of ``a`` to ``k``: the x side of a
    :func:`_pad_moe_down_k`-padded weight."""
    if a.shape[-1] == k:
        return a
    return torch.nn.functional.pad(a, (0, k - a.shape[-1]))


def _merge_experts(qt: QTensor) -> QTensor:
    """[E, L, ...] expert-major stack -> the [E*L, ...] view the MoE kernel
    addresses (entry e * L + layer); a leading-dims reshape, no copy."""
    return dataclasses.replace(
        qt, codes=qt.codes.reshape((-1,) + tuple(qt.codes.shape[2:])),
        scales=qt.scales.reshape((-1,) + tuple(qt.scales.shape[2:])))


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """Routing weights [.., E] in float32: score every expert, keep the top
    ``experts_per_token``, zero the rest, renormalize if ``norm_topk``
    (Mixtral / Qwen3-MoE), times ``routed_scaling``. As the JAX package:
    ``score_fn`` "softmax" or "sigmoid"; ``bias`` is added to the scores
    for the selection only; group-limited routing (``n_expert_groups``)
    keeps the experts of the best ``topk_groups`` groups by group score
    ("max", or "top2sum" of member scores) and zeroes the others' selection
    scores."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    if cfg.score_fn == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    sel = probs if bias is None else probs + bias
    if cfg.n_expert_groups:
        g = cfg.n_expert_groups
        gsel = sel.reshape(sel.shape[:-1] + (g, cfg.n_experts // g))
        if cfg.group_score == "top2sum":
            gscore = gsel.topk(2, dim=-1).values.sum(dim=-1)
        else:
            gscore = gsel.amax(dim=-1)
        gi = gscore.topk(cfg.topk_groups, dim=-1).indices
        gmask = torch.zeros_like(gscore).scatter_(-1, gi, 1.0)
        sel = torch.where(gmask[..., None] > 0, gsel,
                          torch.zeros_like(gsel)).reshape(sel.shape)
    top_i = sel.topk(cfg.experts_per_token, dim=-1).indices
    w = probs * torch.zeros_like(probs).scatter_(-1, top_i, 1.0)
    if cfg.norm_topk:
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return w * cfg.routed_scaling


def _hot_list(w: torch.Tensor):
    """The routed experts of a step, built on the device: ``hot`` int32
    [1 + E] = [n_hot, ids of the experts some token routed to (ascending),
    the last id repeated], and the routing weights [.., E] in hot-slot
    order, zero past n_hot."""
    e = w.shape[-1]
    any_e = (w > 0).reshape(-1, e).any(dim=0)
    n_hot = any_e.sum(dtype=torch.int32)
    order = torch.argsort((~any_e).to(torch.int32), stable=True)
    slots = torch.arange(e, device=w.device)
    hotc = order[torch.minimum(slots, (n_hot - 1).clamp_min(0))]
    hot = torch.cat([n_hot.reshape(1), hotc.to(torch.int32)])
    return hot, w.index_select(-1, hotc) * (slots < n_hot)


def mlp_block(x: torch.Tensor, lay: LayerParams, i: int, cfg: ModelConfig,
              mm, dt: torch.dtype, lora: LoraBatch | None = None,
              gi: int = 0) -> torch.Tensor:
    """The MLP's residual delta, float32 [B, T, D], for layer ``i``.

    Dense (``n_experts`` 0): fused gate|up, SwiGLU, down, with the LoRA
    deltas of global layer ``gi`` on gate|up and down when ``lora`` is
    given (dense models and the dense prefix; the MoE layers and DeepSeek's
    shared experts take none, as in the JAX package). Sparse MoE, with
    the JAX package's dispatch (plus DeepSeek's shared experts, a dense GLU
    added to the routed combination, and its selection bias):

    * kernels (``kernel_mode`` other than "xla"): every expert slot's
      gate|up in ONE ``dequant_matmul_moe`` launch (``concat``), the
      activation times the routing weights, and ONE launch that sums the
      slots' down projections (``psum``). At decode (T=1) with an expected
      share of hot experts ``1 - (1 - k/E)^(B*T)`` below 7/8
      (``moe_routed`` "auto"), or "on", or whenever ``B*T*k*2 <= E``, the
      slots are the routed experts only: the hot list is built on the device
      and the kernel streams no cold expert. ``moe_routed="off"`` keeps all
      E slots.
    * ``moe_prefill="capacity"`` at ``B*T*k >= 2E`` (prefill and high-batch
      decode): the GShard capacity dispatch (:func:`_moe_capacity`).
    * ``moe_fused=False``: a loop over all E experts through
      ``dequant_matmul`` (each expert's output times its routing weights,
      zero where no token routed to it), no host sync.
    * plain (``kernel_mode="xla"``): a loop over the experts some token
      routed to, through the plain matmul.

    Every expert matmul carries ``act_quant`` (W8A8 / W4A8).
    """
    if not cfg.n_experts:
        gu = mm(x, lay.w_gate_up, i)
        if lora is not None:
            gu = gu + lora.delta("gu", x, gi).to(gu.dtype)
        a_in = _glu_act(gu, cfg, dt)
        out = mm(a_in, lay.w_down, i, out_dtype=torch.float32)
        return out if lora is None else lora.delta("down", a_in, gi, out=out)
    routed = _moe(x, lay, i, cfg, mm, dt)
    if cfg.n_shared_experts:
        # DeepSeek: the always-on shared experts' GLU, added in f32
        routed = routed + _glu(x, lay.ws_gate_up, lay.ws_down, i, cfg, mm,
                               dt)
    return routed


def _glu_act(gu: torch.Tensor, cfg: ModelConfig,
             dt: torch.dtype) -> torch.Tensor:
    """The GLU's activation of the fused gate|up output, times up."""
    gate, up = gu.chunk(2, dim=-1)
    return _act(cfg)(gate.to(torch.float32)).to(dt) * up


def _glu(x, w_gate_up: QTensor, w_down: QTensor, i: int, cfg: ModelConfig,
         mm, dt: torch.dtype) -> torch.Tensor:
    """Dense SwiGLU of layer ``i``: fused gate|up, activation, down (f32)."""
    a_in = _glu_act(mm(x, w_gate_up, i), cfg, dt)
    return mm(a_in, w_down, i, out_dtype=torch.float32)


def _moe(x: torch.Tensor, lay: LayerParams, i: int, cfg: ModelConfig, mm,
         dt: torch.dtype) -> torch.Tensor:
    """The routed experts' combination, float32 [B, T, D] (see
    :func:`mlp_block`). The expert stacks are addressed at entry
    ``e * L + i`` with L the depth of this (MoE) stack."""
    bias = lay.router_bias[i] if cfg.router_bias else None
    w = moe_route(x, lay.router[i], cfg, bias)            # [B, T, E]
    wgu = _merge_experts(lay.we_gate_up)
    wdn = _merge_experts(lay.we_down)
    e, n_l = cfg.n_experts, lay.attn_norm.shape[0]
    b, t = x.shape[0], x.shape[1]
    n_tok = b * t
    k = cfg.experts_per_token
    if cfg.moe_prefill == "capacity" and n_tok * k >= 2 * e:
        return _moe_capacity(x, w, wgu, wdn, i, n_l, cfg, mm, dt)
    if cfg.kernel_mode != "xla" and not cfg.moe_fused:
        # the per-expert loop through the kernel, every expert weighted (no
        # host sync; an unrouted expert's weights are zero)
        out = torch.zeros((b, t, wdn.n), dtype=torch.float32,
                          device=x.device)
        for j in range(e):
            out = out + _expert(x, wgu, wdn, j * n_l + i, cfg, mm,
                                dt) * w[..., j:j + 1]
        return out
    if cfg.kernel_mode == "xla":
        out = torch.zeros((b, t, wdn.n), dtype=torch.float32,
                          device=x.device)
        routed = (w > 0).reshape(-1, e).any(dim=0).tolist()
        for j in (j for j in range(e) if routed[j]):
            out = out + _expert(x, wgu, wdn, j * n_l + i, cfg, mm,
                                dt) * w[..., j:j + 1]
        return out
    exp_hot = 1.0 - (1.0 - k / e) ** n_tok
    routed = cfg.moe_routed != "off" and (
        n_tok * k * 2 <= e
        or (t == 1 and (cfg.moe_routed == "on" or exp_hot < 0.875)))
    hot = None
    if routed:
        hot, w = _hot_list(w)
    gu = dequant_matmul_moe(x, wgu, i, n_experts=e, stride=n_l,
                            mode="concat", hot=hot,
                            act_quant=cfg.act_quant)     # [B, T, E * 2I]
    gate, up = gu.reshape(b, t, e, -1).chunk(2, dim=-1)
    a = _act(cfg)(gate.to(torch.float32)).to(dt) * up
    a = _pad_x_to_k(a * w.to(dt)[..., None], wdn.k)
    return dequant_matmul_moe(a.permute(2, 0, 1, 3).contiguous(), wdn, i,
                              n_experts=e, stride=n_l, mode="psum",
                              out_dtype=torch.float32, hot=hot,
                              act_quant=cfg.act_quant)


def _expert(x, wgu: QTensor, wdn: QTensor, entry: int, cfg: ModelConfig, mm,
            dt: torch.dtype) -> torch.Tensor:
    """One expert's GLU on x through ``mm`` at stack entry ``entry`` (gate|up,
    activation, the down projection's K padding, down in f32)."""
    gate, up = mm(x, wgu, entry).chunk(2, dim=-1)
    a_e = _act(cfg)(gate.to(torch.float32)).to(dt) * up
    return mm(_pad_x_to_k(a_e, wdn.k), wdn, entry, out_dtype=torch.float32)


def capacity_slots(w2: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The capacity dispatch's slots, on the device: routing weights [N, E]
    -> (token of each slot, int64 [E, C]; its routing weight, f32 [E, C]).
    Each token's rank among its expert's routed tokens comes from a cumsum;
    a rank at or past C (a dropped token) and every unrouted pair land in a
    spare column C that is sliced away. Unused slots hold token 0 with
    weight 0."""
    n, e = w2.shape
    sel = w2 > 0
    pos = torch.cumsum(sel.to(torch.int32), dim=0) - 1
    slot = torch.where(sel & (pos < cap), pos,
                       torch.full_like(pos, cap)).T.to(torch.int64)
    toks = torch.arange(n, device=w2.device).expand(e, n)
    st = torch.zeros((e, cap + 1), dtype=torch.int64,
                     device=w2.device).scatter_(1, slot, toks)[:, :cap]
    sw = torch.zeros((e, cap + 1), dtype=torch.float32,
                     device=w2.device).scatter_(
        1, slot, w2.T.to(torch.float32))[:, :cap]
    return st, sw


def _moe_capacity(x: torch.Tensor, w: torch.Tensor, wgu: QTensor,
                  wdn: QTensor, i: int, n_l: int, cfg: ModelConfig, mm,
                  dt: torch.dtype) -> torch.Tensor:
    """The GShard fixed-capacity dispatch (``moe_prefill="capacity"``, past
    ``B*T*k >= 2E``), the JAX package's ``_moe_capacity``: each expert takes
    its first C routed tokens, ``C = min(max(8, round_up(ceil(N*k/E * cf),
    8)), N)``; a token past an expert's capacity loses that expert's
    contribution. Kernels (``moe_fused``): the tokens gathered into
    ``[E, C, D]``, gate|up and down each ONE grouped ``dequant_matmul_moe``
    launch, the rows scatter-added back weighted by their routing weights.
    Plain (``kernel_mode="xla"``) or ``moe_fused=False``: a loop over the
    experts through ``mm`` on each expert's C rows. No host sync."""
    b, t, d = x.shape
    n, e = b * t, cfg.n_experts
    cap = math.ceil(n * cfg.experts_per_token / e * cfg.moe_capacity_factor)
    cap = min(max(8, -(-cap // 8) * 8), n)
    x2 = x.reshape(n, d)
    st, sw = capacity_slots(w.reshape(n, e), cap)
    out = torch.zeros((n, wdn.n), dtype=torch.float32, device=x.device)
    if cfg.kernel_mode == "xla" or not cfg.moe_fused:
        for j in range(e):
            ye = _expert(x2.index_select(0, st[j]), wgu, wdn, j * n_l + i,
                         cfg, mm, dt)
            out.index_add_(0, st[j], ye * sw[j, :, None])
        return out.reshape(b, t, -1)
    xs = x2.index_select(0, st.reshape(-1)).reshape(e, cap, d)
    gu = dequant_matmul_moe(xs, wgu, i, n_experts=e, stride=n_l,
                            mode="grouped",
                            act_quant=cfg.act_quant)     # [E, C, 2I]
    gate, up = gu.chunk(2, dim=-1)
    a = _pad_x_to_k(_act(cfg)(gate.to(torch.float32)).to(dt) * up, wdn.k)
    y = dequant_matmul_moe(a, wdn, i, n_experts=e, stride=n_l,
                           mode="grouped", out_dtype=torch.float32,
                           act_quant=cfg.act_quant)      # [E, C, D]
    out.index_add_(0, st.reshape(-1), y.reshape(e * cap, -1)
                   * sw.reshape(-1, 1))
    return out.reshape(b, t, -1)


def _q_scale(cfg: ModelConfig, dh: int) -> float:
    """Attention score scale: 1/sqrt(query_pre_attn_scalar or head_dim),
    times ``yarn_mscale(factor, mscale_all_dim)^2`` when ``score_mscale``
    (DeepSeek's yarn), as in the JAX package."""
    s = cfg.query_pre_attn_scalar or dh
    scale = 1.0 / np.sqrt(s)
    if cfg.score_mscale:
        m = _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim or 1.0)
        scale *= m * m
    return float(scale)


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * float(np.log(scale)) + 1.0


def yarn_attention_factor(cfg: ModelConfig) -> float:
    """The cos/sin multiplier of yarn rope: an explicit
    ``rope_attn_factor``, or the mscale ratio, or mscale(factor)."""
    if cfg.rope_attn_factor:
        return cfg.rope_attn_factor
    if cfg.rope_mscale and cfg.rope_mscale_all_dim:
        return (_yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
                / _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return _yarn_mscale(cfg.rope_factor)


def _yarn_freqs(theta: float, half: int, cfg: ModelConfig) -> np.ndarray:
    """Yarn NTK-by-parts inverse frequencies: interpolated (freq/factor)
    below ``rope_beta_slow`` rotations at the original context,
    extrapolated above ``rope_beta_fast``, a linear ramp between."""
    dim = 2 * half
    pos_freqs = theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (cfg.rope_factor * pos_freqs)

    def corr_dim(n_rot):
        return (dim * np.log(cfg.rope_orig_max_pos
                             / (n_rot * 2 * np.pi))) / (2 * np.log(theta))

    low = max(np.floor(corr_dim(cfg.rope_beta_fast)), 0)
    high = min(np.ceil(corr_dim(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(half, dtype=np.float32) - low)
                   / (high - low), 0, 1)
    extra_w = 1.0 - ramp
    return (inv_inter * (1.0 - extra_w)
            + inv_extra * extra_w).astype(np.float32)


def _rope_freqs(theta: float, half: int, cfg: ModelConfig | None) -> np.ndarray:
    """Inverse frequencies [half] with the config's rope scaling (``none``,
    ``linear``, ``llama3`` NTK-by-parts or ``yarn``), in float32 numpy like
    the JAX package."""
    freqs = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    if cfg is None or cfg.rope_scaling == "none":
        return freqs
    if cfg.rope_scaling == "linear":
        return freqs / cfg.rope_factor
    if cfg.rope_scaling == "yarn":
        return _yarn_freqs(theta, half, cfg)
    if cfg.rope_scaling != "llama3":
        raise NotImplementedError(
            f"rope_scaling {cfg.rope_scaling!r} is not ported")
    factor = cfg.rope_factor
    low_wl = cfg.rope_orig_max_pos / cfg.rope_low_freq_factor
    high_wl = cfg.rope_orig_max_pos / cfg.rope_high_freq_factor
    wavelen = 2.0 * np.pi / freqs
    scaled = np.where(wavelen > low_wl, freqs / factor, freqs)
    smooth = ((cfg.rope_orig_max_pos / wavelen - cfg.rope_low_freq_factor)
              / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor))
    smoothed = (1.0 - smooth) / factor * freqs + smooth * freqs
    medium = (wavelen >= high_wl) & (wavelen <= low_wl)
    return np.where(medium, smoothed, scaled).astype(np.float32)


def _rope_tables(positions: torch.Tensor, theta: float, dh: int,
                 cfg: ModelConfig | None = None):
    """(cos, sin) ``[B, T, 1, Dh/2]`` f32 for ``positions`` [B, T]: the
    same for every layer and for q and k, so :func:`forward` makes them
    once per step (one host-to-device copy of the frequencies)."""
    freqs = torch.from_numpy(_rope_freqs(theta, dh // 2, cfg)).to(
        positions.device)
    ang = positions[:, :, None].to(torch.float32) * freqs     # [B, T, half]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cfg: ModelConfig | None = None) -> torch.Tensor:
    """Rotate-half RoPE with precomputed tables; ``cfg`` adds its
    ``rope_interleaved`` pair layout and yarn's attention factor."""
    return rope_apply(x, cos, sin, **_rope_options(cfg))


def _rope_options(cfg: ModelConfig | None) -> dict:
    """``cfg``'s rotary pair layout and yarn's attention factor, as
    :func:`quant_tpu_torch.kernels.rope_kv.rope_apply` takes them."""
    if cfg is None:
        return {}
    return {"interleaved": cfg.rope_interleaved,
            "attn_factor": (yarn_attention_factor(cfg)
                            if cfg.rope_scaling == "yarn" else None)}


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          cfg: ModelConfig | None = None) -> torch.Tensor:
    """Rotate-half RoPE. x [B, T, H, Dh], positions [B, T] int."""
    return _rope_apply(x, *_rope_tables(positions, theta, x.shape[-1], cfg),
                       cfg)


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Each layer's attention window as a Python int (0 = full causal), as
    the JAX package's ``layer_windows``: with ``sliding_pattern`` p, layer
    i is global iff (i + 1) % p == 0 (Gemma-2/3), else every layer takes
    ``sliding_window`` (Mistral)."""
    p = cfg.sliding_pattern
    return [0 if (p and (i + 1) % p == 0) else cfg.sliding_window
            for i in range(cfg.n_layers)]


def _rope_sets(positions: torch.Tensor, cfg: ModelConfig, dh: int) -> dict:
    """The step's rope tables by layer kind: ``{"global": (cos, sin)}``,
    and for a ``rope_local_theta`` model (Gemma-3) ``"local"``, the sliding
    layers' tables on the local base, unscaled, as the JAX package's
    ``_layer_theta`` gives them (its global layers keep only a linear
    factor)."""
    if not cfg.rope_local_theta:
        return {"global": _rope_tables(positions, cfg.rope_theta, dh, cfg)}
    return {"global": _rope_tables(positions, cfg.rope_theta, dh, cfg),
            "local": _rope_tables(positions, cfg.rope_local_theta, dh)}


def dequant_kv(codes: torch.Tensor, bits: int = 8,
               head_axis: int = -3) -> torch.Tensor:
    """Cache codes -> float32 values with the real head order restored
    (codes*scale is the caller's job); at 16 bits the codes are the values.
    At 4 bits each byte's low nibble is real head 2j and its high nibble
    2j+1, each minus 8, interleaved back along ``head_axis``, the packed
    head axis: -3 in the cache layouts (``[.., H/2, S, D]``), -2 in the
    per-token one (``[B, T, H/2, D]``)."""
    if bits not in (4, 8, 16):
        raise NotImplementedError(f"kv_bits {bits} is not ported")
    return dequant_kv4(codes, head_axis) if bits == 4 else codes.to(
        torch.float32)


def _cache_insert_at_layer(cc: torch.Tensor, cs: torch.Tensor,
                           codes: torch.Tensor, scale: torch.Tensor,
                           lengths: torch.Tensor, layer: int, s0: int = 0):
    """Write T entries per slot into layer ``layer`` of the full
    ``[L, B, H, S, D]`` cache at positions ``lengths[b] + t - s0``, in
    place; positions outside ``[0, S)`` are dropped."""
    b, t = codes.shape[0], codes.shape[1]
    pos = (lengths.to(torch.int64)[:, None] - s0
           + torch.arange(t, device=codes.device)[None, :])        # [B, T]
    ok = (pos >= 0) & (pos < cc.shape[3])
    b_ix = torch.arange(b, device=codes.device)[:, None].expand(b, t)
    bi, pi = b_ix[ok], pos[ok]
    cc[layer, bi, :, pi] = codes[ok]
    cs[layer, bi, :, pi] = scale[ok]
    return cc, cs


# Write T entries per slot into the page pool through the page table, in
# place (the plain scatter; positions past the table's capacity drop).
_paged_insert_at_layer = paged_insert_rows


def _softcap_scores(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gemma-2's tanh softcap of the attention logits, before the mask."""
    if cfg.attn_softcap:
        cap = cfg.attn_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _visible(key_pos, qpos, lim, window: int):
    """Key ``key_pos`` is visible to query ``qpos`` iff it is at or before
    it, below the length, and (window above 0) within the last ``window``
    positions."""
    valid = (key_pos <= qpos) & (key_pos < lim)
    if window > 0:
        valid = valid & (key_pos > qpos - window)
    return valid


def attention(q, k_codes, k_scale, v_codes, v_scale, positions, lengths,
              cfg: ModelConfig, window: int = 0):
    """GQA attention over one layer's cache (plain torch; prefill and the
    plain decode path). q [B, T, Hq, Dh]; caches [B, Hkv, S, Dh] /
    [B, Hkv, S]; positions [B, T]; lengths [B] after insertion. Key s is
    visible to a query iff s <= position and s < length, and with a
    ``window`` above 0 iff s > position - window; the logits take
    ``cfg.attn_softcap`` before the mask. MLA passes the latent's first
    ``r`` lanes as V: the output width is V's."""
    b, t, hq, dh = q.shape
    hkv, s, dv = k_scale.shape[1], k_codes.shape[2], v_codes.shape[-1]
    rep = hq // hkv
    qg = (q.to(torch.float32) * _q_scale(cfg, dh)).reshape(b, t, hkv, rep, dh)
    logits = torch.einsum("bthrd,bhsd->bhrts", qg,
                          dequant_kv(k_codes, cfg.kv_bits))
    logits = logits * k_scale[:, :, None, None, :]
    logits = _softcap_scores(logits, cfg)
    key_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    qpos = positions[:, None, None, :, None]
    valid = _visible(key_pos, qpos, lengths[:, None, None, None, None],
                     window)
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    pv = probs * v_scale[:, :, None, None, :]
    out = torch.einsum("bhrts,bhsd->bthrd", pv,
                       dequant_kv(v_codes, cfg.kv_bits))
    return out.reshape(b, t, hq, dv).to(q.dtype)


def attention_blockwise(q, k_codes, k_scale, v_codes, v_scale, positions,
                        lengths, cfg: ModelConfig, block: int = 1024,
                        window: int = 0):
    """Prefill attention with an online softmax over KV blocks (a Python
    loop where the JAX package scans), bounding memory at O(T * block);
    masks and softcap as :func:`attention`."""
    b, t, hq, dh = q.shape
    hkv, s, dv = k_scale.shape[1], k_codes.shape[2], v_codes.shape[-1]
    if s <= block:
        return attention(q, k_codes, k_scale, v_codes, v_scale, positions,
                         lengths, cfg, window)
    if s % block:
        block = s
    rep = hq // hkv
    qg = (q.to(torch.float32) * _q_scale(cfg, dh)).reshape(b, t, hkv, rep, dh)
    qpos = positions[:, None, None, :, None]
    lim = lengths[:, None, None, None, None]
    m = torch.full((b, hkv, rep, t, 1), -1e30, device=q.device)
    l_sum = torch.zeros((b, hkv, rep, t, 1), device=q.device)
    o = torch.zeros((b, hkv, rep, t, dv), device=q.device)
    for j in range(s // block):
        sl = slice(j * block, (j + 1) * block)
        logits = torch.einsum("bthrd,bhsd->bhrts", qg,
                              dequant_kv(k_codes[:, :, sl], cfg.kv_bits))
        logits = logits * k_scale[:, :, None, None, sl]
        logits = _softcap_scores(logits, cfg)
        key_pos = j * block + torch.arange(block, device=q.device)[
            None, None, None, None, :]
        valid = _visible(key_pos, qpos, lim, window)
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(logits - m_new),
                        torch.zeros_like(logits))
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        pv = p * v_scale[:, :, None, None, sl]
        o = o * alpha + torch.einsum("bhrts,bhsd->bhrtd", pv,
                                     dequant_kv(v_codes[:, :, sl],
                                                cfg.kv_bits))
        m = m_new
    out = o / l_sum.clamp_min(1e-20)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, dv)
    return out.to(q.dtype)


# ── forward ─────────────────────────────────────────────────────────────


def _mm(cfg: ModelConfig):
    """The projection for ``cfg.kernel_mode``: the plain version by name
    ("xla"; a codebook weight through its float32 table, as the JAX
    reference), else the dispatcher (the CUDA kernel for card tensors).
    Both carry ``act_quant``; the dispatcher runs a codebook weight's
    float32 table at ``lut_runtime="sel15"`` and the word4 table otherwise
    (a weight that no load transcoded, as ``init_params`` makes them)."""
    aq = cfg.act_quant
    if cfg.kernel_mode == "xla":
        def mm(x, qt, layer=None, out_dtype=None):
            if layer is not None:
                qt = qt.layer(layer)
            k = qt.shape[0]
            y = dequant_matmul_reference(x.reshape(-1, k), qt, out_dtype,
                                         act_quant=aq)
            return y.reshape(*x.shape[:-1], qt.shape[1])
        return mm

    exact = cfg.lut_runtime == "sel15"

    def mm(x, qt, layer=None, out_dtype=None):
        return dequant_matmul(x, qt, layer, out_dtype=out_dtype,
                              act_quant=aq, lut_exact=exact)
    return mm


def _use_kernels(cfg: ModelConfig, t: int, paged: bool) -> bool:
    """The decode kernel pair (in-place insert + flash decode) for T=1 over
    an int8 or int4 cache, as ``make_layer_step`` selects it:
    ``attn_kernel`` "auto" or "flash", and "paged" over a page pool; the
    plain path otherwise (``kv_bits=16`` too, as in the JAX package). An
    MLA cache (int8), contiguous or paged, takes its own pair unless
    ``attn_kernel`` is "xla" (the port does not carry over the TPU kernel's
    r and S alignment conditions); over the latent pool both kernels
    address rows through the page table, where the JAX package gathers
    each slot's pages per layer on its plain path."""
    if cfg.kernel_mode == "xla" or t != 1 or cfg.kv_bits not in (8, 4):
        return False
    if cfg.is_mla:
        return cfg.attn_kernel != "xla"
    return cfg.attn_kernel in (("auto", "flash", "paged") if paged
                               else ("auto", "flash"))


def _mla_attn(x, lay: LayerParams, i: int, gi: int, cfg: ModelConfig, mm,
              dt: torch.dtype, rope, positions, lengths, new_lengths,
              cache, kernels: bool,
              lora: LoraBatch | None = None) -> torch.Tensor:
    """DeepSeek multi-head latent attention in the absorbed form (the JAX
    package's ``_mla_attn``): one matmul over the fused down projection
    gives [q part | c_kv | k_pe]; the per-head key up-projection folds
    into the query (``q_abs``), so attention is MQA over one quantized
    latent row [c_kv | k_pe] per token (one joint scale, zero lanes up to
    ``mla_cache_dim``), and the value read is the row's first ``r`` lanes.
    Weights index with the stack position ``i``, the cache and the LoRA
    rows (``lora``: the q(-a) | kv_a delta on the fused down projection,
    before the fused insert reads it) with the global layer ``gi``. Over a
    latent pool (``PagedKVCache``) the plain path inserts through the page
    table and attends over ``paged_gather`` of the layer, as the JAX
    package does; the kernel pair reads and writes the pool in place. Returns the heads' outputs [B, T, H, dv] after the
    value up-projection."""
    b, t = x.shape[0], x.shape[1]
    kc, ks = cache.k_codes, cache.k_scale
    tbl = cache.page_tbl if isinstance(cache, PagedKVCache) else None
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn = cfg.qk_nope_head_dim
    akv = mm(x, lay.wqkv, i)                     # [B, T, qpart + r + dr]
    if lora is not None:
        akv = akv + lora.delta("qkv", x, gi).to(akv.dtype)
    qp, ckv = akv[..., :-(r + dr)], akv[..., -(r + dr):]
    if cfg.q_lora_rank:
        qp = rmsnorm(qp, lay.q_a_norm[i], cfg.norm_eps)
        qp = mm(qp.contiguous(), lay.w_q_b, i)
    qh = qp.reshape(b, t, -1, dn + dr)
    q_nope, q_pe = qh[..., :dn], qh[..., dn:]
    # the absorbed up-projections run in the activation type, as in the
    # JAX package
    q_abs = torch.einsum("bthn,hnr->bthr", q_nope, lay.w_uk[i].to(dt))
    opts = dict(_rope_options(cfg), eps=cfg.norm_eps)
    if kernels:
        # one launch: the latent's RMSNorm, RoPE of k_pe and q_pe, the
        # latent row quantized and inserted, q_eff written, reading ckv and
        # q_pe where the projections left them
        q_eff = mla_cache_insert_int8_fused(
            ckv, q_pe, q_abs, lay.kv_a_norm[i], *rope, kc, ks, lengths, gi,
            kv_bits=cfg.kv_bits, page_tbl=tbl, **opts)
        o_lat = mla_flash_decode_int8(
            q_eff, kc, ks, new_lengths, gi, r=r,
            scale=_q_scale(cfg, cfg.head_dim), page_tbl=tbl)[:, None]
    else:
        q_eff, lat = mla_latent_rows(ckv, q_pe, q_abs, lay.kv_a_norm[i],
                                     *rope, cfg.mla_cache_dim, **opts)
        k_q, k_s = quantize_kv(lat, cfg.kv_bits)
        if tbl is None:
            _cache_insert_at_layer(kc, ks, k_q, k_s, lengths, gi)
            kcl, ksl = kc[gi], ks[gi]
        else:
            _paged_insert_at_layer(kc, ks, k_q, k_s, lengths, gi, tbl)
            kcl, ksl = paged_gather(kc, tbl, gi), paged_gather(ks, tbl, gi)
        att = attention_blockwise if t > 1 else attention
        o_lat = att(q_eff, kcl, ksl, kcl[..., :r], ksl, positions,
                    new_lengths, cfg)
    return torch.einsum("bthr,hrv->bthv", o_lat.to(dt), lay.w_uv[i].to(dt))


def _gqa_attn(x, lay: LayerParams, i: int, gi: int, cfg: ModelConfig, mm,
              rope, positions, lengths, new_lengths, cache, kernels: bool,
              window: int = 0, lora: LoraBatch | None = None):
    """GQA attention of stack position ``i`` (cache layer ``gi``) over the
    contiguous cache or the page pool, [B, T, Hq, Dh], under the layer's
    ``window`` (0: full causal) and ``cfg.attn_softcap``. ``lora`` adds the
    q|k|v delta of layer ``gi`` after the bias, as the JAX package does,
    before RoPE or the fused insert reads the row."""
    b, t = x.shape[0], x.shape[1]
    kc, ks, vc, vs = cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale
    paged = isinstance(cache, PagedKVCache)
    tbl = cache.page_tbl if paged else None
    units = cfg.n_heads + 2 * cfg.n_kv_heads
    qkv = mm(x, lay.wqkv, i)
    if cfg.qkv_bias:
        # Qwen2; a Llama bias is all zeros, and adding it is left out
        qkv = qkv + lay.qkv_bias[i].to(qkv.dtype)
    if lora is not None:
        qkv = qkv + lora.delta("qkv", x, gi).to(qkv.dtype)
    nq = (qkv.shape[-1] * cfg.n_heads) // units
    nkv = (qkv.shape[-1] * cfg.n_kv_heads) // units
    q = qkv[..., :nq].reshape(b, t, -1, cfg.head_dim)
    k = qkv[..., nq:nq + nkv].reshape(b, t, -1, cfg.head_dim)
    v = qkv[..., nq + nkv:].reshape(b, t, -1, cfg.head_dim)
    if cfg.qk_norm:
        # Qwen3, Gemma-3 (zero-centred gains): per-head RMSNorm over Dh
        # before RoPE
        q = rmsnorm(q, lay.q_norm[i], cfg.norm_eps, cfg.norm_offset)
        k = rmsnorm(k, lay.k_norm[i], cfg.norm_eps, cfg.norm_offset)
    scale = _q_scale(cfg, cfg.head_dim)
    if kernels:
        # one launch: RoPE of q and k, K/V quantization and the insert,
        # reading q, k and v where the projection left them; the window
        # and the softcap go into the decode kernel
        opts = dict(_rope_options(cfg), kv_bits=cfg.kv_bits)
        att = dict(softcap=cfg.attn_softcap, scale=scale)
        if paged:
            q = paged_cache_insert_int8_fused(q, k, v, *rope, kc, ks, vc, vs,
                                              lengths, gi, tbl, **opts)
            return paged_flash_decode_int8(q, kc, ks, vc, vs, tbl,
                                           new_lengths, gi, window,
                                           **att)[:, None]
        q = cache_insert_int8_fused(q, k, v, *rope, kc, ks, vc, vs, lengths,
                                    gi, **opts)
        return flash_decode_int8(q, kc, ks, vc, vs, new_lengths, gi, window,
                                 **att)[:, None]
    q = _rope_apply(q, *rope, cfg)
    k = _rope_apply(k, *rope, cfg)
    k_q, k_s = quantize_kv(k, cfg.kv_bits)
    v_q, v_s = quantize_kv(v, cfg.kv_bits)
    att = attention_blockwise if t > 1 else attention
    if paged:
        _paged_insert_at_layer(kc, ks, k_q, k_s, lengths, gi, tbl)
        _paged_insert_at_layer(vc, vs, v_q, v_s, lengths, gi, tbl)
        return att(q, paged_gather(kc, tbl, gi), paged_gather(ks, tbl, gi),
                   paged_gather(vc, tbl, gi), paged_gather(vs, tbl, gi),
                   positions, new_lengths, cfg, window=window)
    _cache_insert_at_layer(kc, ks, k_q, k_s, lengths, gi)
    _cache_insert_at_layer(vc, vs, v_q, v_s, lengths, gi)
    return att(q, kc[gi], ks[gi], vc[gi], vs[gi], positions, new_lengths, cfg,
               window=window)


def forward(params: LlamaParams, tokens, cache: KVCache | PagedKVCache,
            cfg: ModelConfig, axis=None, seq_axis=None, expert_axis=None,
            adapter_ids=None, return_hidden: bool = False, *,
            device=None) -> tuple[torch.Tensor, KVCache | PagedKVCache]:
    """One model step (prefill if T>1, decode if T==1).

    Token t of slot b gets position ``cache.lengths[b] + t``. The cache's
    code/scale tensors (a page pool's too) are written IN PLACE; the
    returned cache holds them (and the same page table) with
    ``lengths + T``. Returns (logits f32 ``[B, T, vocab_size]``,
    cache). ``return_hidden`` returns the f32 final-norm hidden states
    ``[B, T, dim]`` in place of the logits (the embeddings API); the cache
    is updated all the same. ``device`` is where the step runs (the card
    unless "cpu"); params and cache must already lie there, ``tokens``
    ([B, T] ids) are moved there. A ``first_k_dense`` model runs its
    dense-prefix stack ``layers0`` (config :func:`dense_prefix_cfg`) and
    then ``layers``, whose cache rows start at ``first_k_dense``.

    ``adapter_ids`` ``[B]`` (on the device; 0 = the base) picks each slot's
    LoRA adapter of ``params.lora``: the deltas on the fused qkv (or MLA's
    q(-a) | kv_a), on ``wo`` and on a dense MLP, each at its GLOBAL layer.
    With ``params.lora`` and no ids every slot is the base, and no delta
    runs; without ``params.lora`` the ids are ignored, as in the JAX
    package. The JAX package's mesh axes (``axis``, ``seq_axis``,
    ``expert_axis``) are not ported and raise ``NotImplementedError``.
    """
    asked = {"axis (tensor parallel)": axis, "seq_axis": seq_axis,
             "expert_axis": expert_axis}
    bad = [name for name, v in asked.items() if v is not None]
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))
    check_supported(cfg)
    dev = resolve_device(device)
    check_on(params.final_norm, dev, "params")
    check_on(cache.k_codes, dev, "cache")
    paged = isinstance(cache, PagedKVCache)
    k0 = cfg.first_k_dense
    if k0 and params.layers0 is None:
        raise ValueError("a first_k_dense model needs params.layers0")
    tokens = torch.as_tensor(tokens, device=dev)
    mm = _mm(cfg)
    dt = _dtype(cfg)
    b, t = tokens.shape
    lengths = cache.lengths
    new_lengths = lengths + t
    positions = lengths[:, None] + torch.arange(t, device=dev,
                                                dtype=lengths.dtype)[None]
    kernels = _use_kernels(cfg, t, paged)
    rope_dim = cfg.qk_rope_head_dim if cfg.is_mla else cfg.head_dim
    ropes = _rope_sets(positions, cfg, rope_dim)
    windows = layer_windows(cfg)
    off_n = cfg.norm_offset
    h = _embed_lookup(params.embed, tokens.to(torch.int64), dt, cfg)
    lora = (LoraBatch.of(params.lora, adapter_ids)
            if params.lora is not None and adapter_ids is not None else None)
    stacks = [(params.layers0, dense_prefix_cfg(cfg), 0)] if k0 else []
    stacks.append((params.layers, cfg, k0))
    for lay, c, off in stacks:
        for i in range(lay.attn_norm.shape[0]):
            gi = i + off
            x = rmsnorm(h, lay.attn_norm[i], c.norm_eps, off_n)
            if c.is_mla:
                attn = _mla_attn(x, lay, i, gi, c, mm, dt, ropes["global"],
                                 positions, lengths, new_lengths, cache,
                                 kernels, lora)
            else:
                w = windows[gi]
                rope = ropes["local" if w and "local" in ropes else "global"]
                attn = _gqa_attn(x, lay, i, gi, c, mm, rope, positions,
                                 lengths, new_lengths, cache, kernels, w,
                                 lora)
            attn = attn.reshape(b, t, -1).contiguous()
            o = mm(attn, lay.wo, i, out_dtype=torch.float32)
            if lora is not None:
                o = lora.delta("o", attn, gi, out=o)
            if c.post_norms:
                # Gemma-2/3: the block's output normed before the residual
                o = rmsnorm(o, lay.post_attn_norm[i], c.norm_eps, off_n)
            h = h + o.to(dt)
            x = rmsnorm(h, lay.mlp_norm[i], c.norm_eps, off_n)
            m = mlp_block(x, lay, i, c, mm, dt, lora, gi)
            if c.post_norms:
                m = rmsnorm(m, lay.post_mlp_norm[i], c.norm_eps, off_n)
            h = h + m.to(dt)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps, off_n)
    if return_hidden:
        return (h.to(torch.float32),
                dataclasses.replace(cache, lengths=new_lengths))
    logits = mm(h, params.lm_head, out_dtype=torch.float32)
    logits = logits[..., :cfg.vocab_size]
    if cfg.final_softcap:
        # Gemma-2's final logit softcap, after the vocab slice
        cap = cfg.final_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits, dataclasses.replace(cache, lengths=new_lengths)
