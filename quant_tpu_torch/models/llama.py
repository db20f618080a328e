"""Llama-family models in PyTorch: INT4/INT8 weights, INT8 KV cache.

The port of the JAX package's ``models/llama.py`` for the dense family
(Llama-3 and its test configs) and the sparse-MoE family (Mixtral,
Qwen3-MoE): RMSNorm, optional per-head QK-RMSNorm (Qwen3), rotate-half RoPE
with ``none`` or ``llama3`` scaling, GQA attention over an int8 cache with
one f32 scale per (token, head), and a SwiGLU MLP, dense or a top-k routed
mixture of experts. Every projection is a :class:`QTensor` consumed by
:func:`quant_tpu_torch.kernels.dequant_matmul`; the experts by
:func:`quant_tpu_torch.kernels.dequant_matmul.dequant_matmul_moe`.

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
``[L, P, Hkv, page, Dh]`` addressed through per-slot page tables).

Kernel selection mirrors the JAX ``make_layer_step``: decode (T=1) with an
int8 cache takes ``cache_insert_int8`` then ``flash_decode_int8`` (their
paged counterparts over a pool); prefill (T>1) writes the cache with the
plain scatter and runs the plain blockwise attention (over
``paged_gather`` of the slot's pages for a pool). ``kernel_mode="xla"``
selects the plain versions throughout; ``"auto"``/``"pallas"`` select the
CUDA kernels (whose wrappers take the plain versions only for tensors on the
CPU). The MoE dispatch is :func:`mlp_block`'s. Everything outside the ported
slices raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quant_tpu_torch.core.qtensor import QTensor, quantize_tensor_device
from quant_tpu_torch.kernels.attention import flash_decode_int8
from quant_tpu_torch.kernels.cache_insert import (cache_insert_int8,
                                                  paged_cache_insert_int8,
                                                  paged_insert_rows)
from quant_tpu_torch.kernels.dequant_matmul import (dequant_matmul,
                                                    dequant_matmul_moe,
                                                    dequant_matmul_reference)
from quant_tpu_torch.kernels.paged_attention import (paged_flash_decode_int8,
                                                     paged_gather)
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.utils.device import check_on, resolve_device

__all__ = ["LayerParams", "QEmbed", "LlamaParams", "KVCache", "PagedKVCache",
           "init_params", "init_cache", "init_paged_cache", "forward",
           "check_supported", "moe_route", "mlp_block"]


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
    (:func:`_pad_moe_down_k`), as in the JAX package."""
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

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


@dataclasses.dataclass
class KVCache:
    """INT8 KV cache at static ``max_seq``, per-(token, head) f32 scales.
    ``lengths[b]`` = valid tokens of slot b (the next write position)."""
    k_codes: torch.Tensor   # int8 [L, B, Hkv, S, Dh]
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
    the plain path masks them)."""
    k_codes: torch.Tensor   # int8 [L, P, Hkv, page, Dh]
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
    """Raise ``NotImplementedError`` for anything outside the ported dense
    and sparse-MoE slices."""
    unsupported = {
        "shared experts (n_shared_experts)": cfg.n_shared_experts,
        "dense-prefix layers (first_k_dense)": cfg.first_k_dense,
        "router selection bias (router_bias)": cfg.router_bias,
        "moe_prefill='capacity'": cfg.moe_prefill == "capacity",
        "moe_fused=False (the per-expert loop is only the plain path)":
            cfg.n_experts and not cfg.moe_fused,
        "MLA (kv_lora_rank)": cfg.is_mla,
        "sliding windows": cfg.sliding_window,
        "attention softcaps": cfg.attn_softcap,
        "final logit softcaps": cfg.final_softcap,
        "post-block norms": cfg.post_norms,
        "qkv_bias": cfg.qkv_bias,
        "norm_offset": cfg.norm_offset,
        "embed_scale": cfg.embed_scale,
        "act_fn other than silu": cfg.act_fn != "silu",
        "query_pre_attn_scalar": cfg.query_pre_attn_scalar,
        "rope_local_theta": cfg.rope_local_theta,
        "rope_interleaved": cfg.rope_interleaved,
        f"rope_scaling={cfg.rope_scaling!r}":
            cfg.rope_scaling not in ("none", "llama3"),
        f"kv_bits={cfg.kv_bits}": cfg.kv_bits != 8,
        "act_quant (W8A8)": cfg.act_quant,
        "codebook (lut) weights": cfg.codebook is not None,
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


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> KVCache:
    check_supported(cfg)
    dev = resolve_device(device)
    l, h, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k_codes=torch.zeros((l, batch, h, max_seq, d), dtype=torch.int8,
                            device=dev),
        k_scale=torch.zeros((l, batch, h, max_seq), dtype=torch.float32,
                            device=dev),
        v_codes=torch.zeros((l, batch, h, max_seq, d), dtype=torch.int8,
                            device=dev),
        v_scale=torch.zeros((l, batch, h, max_seq), dtype=torch.float32,
                            device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     n_pages: int, page: int = 128, pipe: int = 1,
                     device=None) -> PagedKVCache:
    """Pool of ``n_pages`` pages (page 0 is the engine's scratch page);
    per-slot tables sized for ``max_seq``. ``n_pages`` below
    ``batch * max_seq / page`` oversubscribes device memory (the point).
    Pipeline stages (``pipe``) are not ported."""
    if pipe != 1:
        raise NotImplementedError("pipeline parallelism is not ported")
    check_supported(cfg)
    dev = resolve_device(device)
    if max_seq % page:
        raise ValueError(f"max_seq {max_seq} must divide by page {page}")
    l, h, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return PagedKVCache(
        k_codes=torch.zeros((l, n_pages, h, page, d), dtype=torch.int8,
                            device=dev),
        k_scale=torch.zeros((l, n_pages, h, page), dtype=torch.float32,
                            device=dev),
        v_codes=torch.zeros((l, n_pages, h, page, d), dtype=torch.int8,
                            device=dev),
        v_scale=torch.zeros((l, n_pages, h, page), dtype=torch.float32,
                            device=dev),
        page_tbl=torch.zeros((batch, max_seq // page), dtype=torch.int32,
                             device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LlamaParams:
    """Random quantized params made layer by layer on ``device`` from
    ``seed`` (a ``torch.Generator`` there) and quantized where they lie, so
    a full-size model never passes through the host. The weights differ
    from the JAX package's ``init_params`` (another generator); the
    structure is the same."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, it, n_l = cfg.dim, cfg.head_dim, cfg.intermediate, cfg.n_layers
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(k, n):
        return torch.randn((k, n), generator=gen, device=dev,
                           dtype=torch.float32) / float(np.sqrt(k))

    def quant(w):
        return quantize_tensor_device(w, cfg.bits, cfg.group_size)

    def stacked(k, n, make, lead=(n_l,)):
        """Fill a preallocated ``lead + [...]`` stack (``[L]``, or
        ``[E, L]`` for experts) one weight at a time: the stack is never
        assembled from a list, which would double its peak memory."""
        kp = k // 2 if cfg.bits == 4 else k
        codes = torch.empty(lead + (kp, n), device=dev,
                            dtype=torch.uint8 if cfg.bits == 4 else torch.int8)
        scales = torch.empty(lead + (k // cfg.group_size, n),
                             dtype=torch.float32, device=dev)
        for idx in np.ndindex(*lead):
            qt = quant(make())
            codes[idx], scales[idx] = qt.codes, qt.scales
            del qt
        return QTensor(codes=codes, scales=scales, bits=cfg.bits,
                       group_size=cfg.group_size, shape=(k, n))

    def gate_up():
        return torch.cat([dense(d, it), dense(d, it)], dim=1)

    def norm_gains():
        if not cfg.qk_norm:
            return torch.ones((n_l, hd), dtype=torch.float32, device=dev)
        return 1.0 + 0.1 * torch.randn((n_l, hd), generator=gen, device=dev)

    moe = cfg.n_experts > 0
    layers = LayerParams(
        wqkv=stacked(d, qd + 2 * kvd, lambda: torch.cat(
            [dense(d, qd), dense(d, kvd), dense(d, kvd)], dim=1)),
        wo=stacked(qd, d, lambda: dense(qd, d)),
        w_gate_up=None if moe else stacked(d, 2 * it, gate_up),
        w_down=None if moe else stacked(it, d, lambda: dense(it, d)),
        attn_norm=torch.ones((n_l, d), dtype=torch.float32, device=dev),
        mlp_norm=torch.ones((n_l, d), dtype=torch.float32, device=dev),
        qkv_bias=torch.zeros((n_l, qd + 2 * kvd), dtype=torch.float32,
                             device=dev),
        q_norm=norm_gains(),
        k_norm=norm_gains(),
    )
    if moe:
        e = cfg.n_experts
        layers.router = torch.randn((n_l, d, e), generator=gen,
                                    device=dev) * 0.5
        layers.we_gate_up = stacked(d, 2 * it, gate_up, (e, n_l))
        layers.we_down = stacked(
            _padded_k(it), d, lambda: _pad_moe_down_k(dense(it, d)), (e, n_l))
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
                       final_norm=torch.ones((d,), dtype=torch.float32,
                                             device=dev),
                       lm_head=lm_head)


# ── math blocks ─────────────────────────────────────────────────────────


def _embed_lookup(embed, tokens: torch.Tensor, dt: torch.dtype):
    if isinstance(embed, QEmbed):
        rows = embed.codes[tokens].to(torch.float32)
        return (rows * embed.scales[tokens][..., None]).to(dt)
    return embed[tokens].to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            offset: float = 0.0) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (offset + w)).to(x.dtype)


def _act(cfg: ModelConfig):
    """Gate activation of the GLU MLP (computed in f32)."""
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
              mm, dt: torch.dtype) -> torch.Tensor:
    """The MLP's residual delta, float32 [B, T, D], for layer ``i``.

    Dense (``n_experts`` 0): fused gate|up, SwiGLU, down. Sparse MoE, with
    the JAX package's dispatch:

    * kernels (``kernel_mode`` other than "xla"): every expert slot's
      gate|up in ONE ``dequant_matmul_moe`` launch (``concat``), the
      activation times the routing weights, and ONE launch that sums the
      slots' down projections (``psum``). At decode (T=1) with an expected
      share of hot experts ``1 - (1 - k/E)^(B*T)`` below 7/8
      (``moe_routed`` "auto"), or "on", or whenever ``B*T*k*2 <= E``, the
      slots are the routed experts only: the hot list is built on the device
      and the kernel streams no cold expert. ``moe_routed="off"`` keeps all
      E slots.
    * plain (``kernel_mode="xla"``): a loop over the experts some token
      routed to, through the plain matmul.
    """
    if not cfg.n_experts:
        gu = mm(x, lay.w_gate_up, i)
        gate, up = gu.chunk(2, dim=-1)
        a_in = _act(cfg)(gate.to(torch.float32)).to(dt) * up
        return mm(a_in, lay.w_down, i, out_dtype=torch.float32)
    w = moe_route(x, lay.router[i], cfg)                  # [B, T, E]
    wgu = _merge_experts(lay.we_gate_up)
    wdn = _merge_experts(lay.we_down)
    e, n_l = cfg.n_experts, lay.attn_norm.shape[0]
    b, t = x.shape[0], x.shape[1]
    if cfg.kernel_mode == "xla":
        out = torch.zeros((b, t, wdn.n), dtype=torch.float32,
                          device=x.device)
        routed = (w > 0).reshape(-1, e).any(dim=0).tolist()
        for j in (j for j in range(e) if routed[j]):
            gate, up = mm(x, wgu, j * n_l + i).chunk(2, dim=-1)
            a_e = _act(cfg)(gate.to(torch.float32)).to(dt) * up
            y = mm(_pad_x_to_k(a_e, wdn.k), wdn, j * n_l + i,
                   out_dtype=torch.float32)
            out = out + y * w[..., j:j + 1]
        return out
    n_tok = b * t
    k = cfg.experts_per_token
    exp_hot = 1.0 - (1.0 - k / e) ** n_tok
    routed = cfg.moe_routed != "off" and (
        n_tok * k * 2 <= e
        or (t == 1 and (cfg.moe_routed == "on" or exp_hot < 0.875)))
    hot = None
    if routed:
        hot, w = _hot_list(w)
    gu = dequant_matmul_moe(x, wgu, i, n_experts=e, stride=n_l,
                            mode="concat", hot=hot)      # [B, T, E * 2I]
    gate, up = gu.reshape(b, t, e, -1).chunk(2, dim=-1)
    a = _act(cfg)(gate.to(torch.float32)).to(dt) * up
    a = _pad_x_to_k(a * w.to(dt)[..., None], wdn.k)
    return dequant_matmul_moe(a.permute(2, 0, 1, 3).contiguous(), wdn, i,
                              n_experts=e, stride=n_l, mode="psum",
                              out_dtype=torch.float32, hot=hot)


def _q_scale(cfg: ModelConfig, dh: int) -> float:
    """Attention score scale 1/sqrt(head_dim)."""
    s = cfg.query_pre_attn_scalar or dh
    return float(1.0 / np.sqrt(s))


def _rope_freqs(theta: float, half: int, cfg: ModelConfig | None) -> np.ndarray:
    """Inverse frequencies [half] with the config's rope scaling (``none``
    or ``llama3`` NTK-by-parts), in float32 numpy like the JAX package."""
    freqs = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    if cfg is None or cfg.rope_scaling == "none":
        return freqs
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


def _rope_apply(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          cfg: ModelConfig | None = None) -> torch.Tensor:
    """Rotate-half RoPE. x [B, T, H, Dh], positions [B, T] int."""
    return _rope_apply(x, *_rope_tables(positions, theta, x.shape[-1], cfg))


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """Per-(token, head) symmetric int8: x [B, T, H, Dh] -> (codes int8
    [B, T, H, Dh], scales f32 [B, T, H])."""
    if bits != 8:
        raise NotImplementedError(f"kv_bits {bits} is not ported")
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    codes = torch.round(xf / scale[..., None])
    return codes.to(torch.int8), scale


def dequant_kv(codes: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Cache codes -> float32 values (codes*scale is the caller's job)."""
    if bits != 8:
        raise NotImplementedError(f"kv_bits {bits} is not ported")
    return codes.to(torch.float32)


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


def attention(q, k_codes, k_scale, v_codes, v_scale, positions, lengths,
              cfg: ModelConfig):
    """GQA attention over one layer's int8 cache (plain torch; prefill and
    the plain decode path). q [B, T, Hq, Dh]; caches [B, Hkv, S, Dh] /
    [B, Hkv, S]; positions [B, T]; lengths [B] after insertion. Key s is
    visible to a query iff s <= position and s < length."""
    b, t, hq, dh = q.shape
    hkv, s = k_scale.shape[1], k_codes.shape[2]
    rep = hq // hkv
    qg = (q.to(torch.float32) * _q_scale(cfg, dh)).reshape(b, t, hkv, rep, dh)
    logits = torch.einsum("bthrd,bhsd->bhrts", qg, dequant_kv(k_codes))
    logits = logits * k_scale[:, :, None, None, :]
    key_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    qpos = positions[:, None, None, :, None]
    valid = (key_pos <= qpos) & (key_pos < lengths[:, None, None, None, None])
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    pv = probs * v_scale[:, :, None, None, :]
    out = torch.einsum("bhrts,bhsd->bthrd", pv, dequant_kv(v_codes))
    return out.reshape(b, t, hq, dh).to(q.dtype)


def attention_blockwise(q, k_codes, k_scale, v_codes, v_scale, positions,
                        lengths, cfg: ModelConfig, block: int = 1024):
    """Prefill attention with an online softmax over KV blocks (a Python
    loop where the JAX package scans), bounding memory at O(T * block)."""
    b, t, hq, dh = q.shape
    hkv, s = k_scale.shape[1], k_codes.shape[2]
    if s <= block:
        return attention(q, k_codes, k_scale, v_codes, v_scale, positions,
                         lengths, cfg)
    if s % block:
        block = s
    rep = hq // hkv
    qg = (q.to(torch.float32) * _q_scale(cfg, dh)).reshape(b, t, hkv, rep, dh)
    qpos = positions[:, None, None, :, None]
    lim = lengths[:, None, None, None, None]
    m = torch.full((b, hkv, rep, t, 1), -1e30, device=q.device)
    l_sum = torch.zeros((b, hkv, rep, t, 1), device=q.device)
    o = torch.zeros((b, hkv, rep, t, dh), device=q.device)
    for j in range(s // block):
        sl = slice(j * block, (j + 1) * block)
        logits = torch.einsum("bthrd,bhsd->bhrts", qg,
                              dequant_kv(k_codes[:, :, sl]))
        logits = logits * k_scale[:, :, None, None, sl]
        key_pos = j * block + torch.arange(block, device=q.device)[
            None, None, None, None, :]
        valid = (key_pos <= qpos) & (key_pos < lim)
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(logits - m_new),
                        torch.zeros_like(logits))
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        pv = p * v_scale[:, :, None, None, sl]
        o = o * alpha + torch.einsum("bhrts,bhsd->bhrtd", pv,
                                     dequant_kv(v_codes[:, :, sl]))
        m = m_new
    out = o / l_sum.clamp_min(1e-20)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, dh)
    return out.to(q.dtype)


# ── forward ─────────────────────────────────────────────────────────────


def _mm(cfg: ModelConfig):
    """The projection for ``cfg.kernel_mode``: the plain version by name
    ("xla"), else the dispatcher (the CUDA kernel for card tensors)."""
    if cfg.kernel_mode == "xla":
        def mm(x, qt, layer=None, out_dtype=None):
            if layer is not None:
                qt = qt.layer(layer)
            k = qt.shape[0]
            y = dequant_matmul_reference(x.reshape(-1, k), qt, out_dtype)
            return y.reshape(*x.shape[:-1], qt.shape[1])
        return mm

    def mm(x, qt, layer=None, out_dtype=None):
        return dequant_matmul(x, qt, layer, out_dtype=out_dtype)
    return mm


def _use_kernels(cfg: ModelConfig, t: int, paged: bool) -> bool:
    """The decode kernel pair (in-place insert + flash decode) for T=1, as
    ``make_layer_step`` selects it: ``attn_kernel`` "auto" or "flash", and
    "paged" over a page pool; the plain path otherwise."""
    if cfg.kernel_mode == "xla" or t != 1:
        return False
    return cfg.attn_kernel in (("auto", "flash", "paged") if paged
                               else ("auto", "flash"))


def forward(params: LlamaParams, tokens, cache: KVCache | PagedKVCache,
            cfg: ModelConfig, axis=None, seq_axis=None, expert_axis=None,
            adapter_ids=None, return_hidden: bool = False, *,
            device=None) -> tuple[torch.Tensor, KVCache | PagedKVCache]:
    """One model step (prefill if T>1, decode if T==1).

    Token t of slot b gets position ``cache.lengths[b] + t``. The cache's
    code/scale tensors (a page pool's too) are written IN PLACE; the
    returned cache holds them (and the same page table) with
    ``lengths + T``. Returns (logits f32 ``[B, T, vocab_size]``,
    cache). ``device`` is where the step runs (the card unless "cpu");
    params and cache must already lie there, ``tokens`` ([B, T] ids) are
    moved there. The JAX package's mesh axes (``axis``, ``seq_axis``,
    ``expert_axis``), LoRA ``adapter_ids`` and ``return_hidden`` are not
    ported and raise ``NotImplementedError`` when given.
    """
    asked = {"axis (tensor parallel)": axis, "seq_axis": seq_axis,
             "expert_axis": expert_axis, "adapter_ids (LoRA)": adapter_ids,
             "return_hidden": return_hidden}
    bad = [name for name, v in asked.items()
           if v is not None and v is not False]
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))
    check_supported(cfg)
    dev = resolve_device(device)
    check_on(params.final_norm, dev, "params")
    check_on(cache.k_codes, dev, "cache")
    tokens = torch.as_tensor(tokens, device=dev)
    mm = _mm(cfg)
    dt = _dtype(cfg)
    b, t = tokens.shape
    lay = params.layers
    lengths = cache.lengths
    new_lengths = lengths + t
    positions = lengths[:, None] + torch.arange(t, device=dev,
                                                dtype=lengths.dtype)[None]
    paged = isinstance(cache, PagedKVCache)
    tbl = cache.page_tbl if paged else None
    kernels = _use_kernels(cfg, t, paged)
    kc, ks, vc, vs = cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim, cfg)
    units = cfg.n_heads + 2 * cfg.n_kv_heads
    h = _embed_lookup(params.embed, tokens.to(torch.int64), dt)
    for i in range(cfg.n_layers):
        x = rmsnorm(h, lay.attn_norm[i], cfg.norm_eps)
        # no "+ qkv_bias": it is all zeros here (qkv_bias configs raise)
        qkv = mm(x, lay.wqkv, i)
        nq = (qkv.shape[-1] * cfg.n_heads) // units
        nkv = (qkv.shape[-1] * cfg.n_kv_heads) // units
        q = qkv[..., :nq].reshape(b, t, -1, cfg.head_dim)
        k = qkv[..., nq:nq + nkv].reshape(b, t, -1, cfg.head_dim)
        v = qkv[..., nq + nkv:].reshape(b, t, -1, cfg.head_dim)
        if cfg.qk_norm:
            # Qwen3: per-head RMSNorm over Dh before RoPE
            q = rmsnorm(q, lay.q_norm[i], cfg.norm_eps)
            k = rmsnorm(k, lay.k_norm[i], cfg.norm_eps)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        k_q, k_s = quantize_kv(k, cfg.kv_bits)
        v_q, v_s = quantize_kv(v, cfg.kv_bits)
        if paged and kernels:
            paged_cache_insert_int8(kc, ks, vc, vs, k_q, k_s, v_q, v_s,
                                    lengths, i, tbl)
            attn = paged_flash_decode_int8(
                q[:, 0], kc, ks, vc, vs, tbl, new_lengths, i,
                scale=_q_scale(cfg, cfg.head_dim))[:, None]
        elif paged:
            _paged_insert_at_layer(kc, ks, k_q, k_s, lengths, i, tbl)
            _paged_insert_at_layer(vc, vs, v_q, v_s, lengths, i, tbl)
            att = attention_blockwise if t > 1 else attention
            attn = att(q, paged_gather(kc, tbl, i), paged_gather(ks, tbl, i),
                       paged_gather(vc, tbl, i), paged_gather(vs, tbl, i),
                       positions, new_lengths, cfg)
        elif kernels:
            cache_insert_int8(kc, ks, vc, vs, k_q, k_s, v_q, v_s, lengths, i)
            attn = flash_decode_int8(
                q[:, 0], kc, ks, vc, vs, new_lengths, i,
                scale=_q_scale(cfg, cfg.head_dim))[:, None]
        else:
            _cache_insert_at_layer(kc, ks, k_q, k_s, lengths, i)
            _cache_insert_at_layer(vc, vs, v_q, v_s, lengths, i)
            att = attention_blockwise if t > 1 else attention
            attn = att(q, kc[i], ks[i], vc[i], vs[i], positions, new_lengths,
                       cfg)
        o = mm(attn.reshape(b, t, -1).contiguous(), lay.wo, i,
               out_dtype=torch.float32)
        h = h + o.to(dt)
        x = rmsnorm(h, lay.mlp_norm[i], cfg.norm_eps)
        h = h + mlp_block(x, lay, i, cfg, mm, dt).to(dt)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    logits = mm(h, params.lm_head, out_dtype=torch.float32)
    logits = logits[..., :cfg.vocab_size]
    if paged:
        return logits, PagedKVCache(k_codes=kc, k_scale=ks, v_codes=vc,
                                    v_scale=vs, page_tbl=tbl,
                                    lengths=new_lengths)
    return logits, KVCache(k_codes=kc, k_scale=ks, v_codes=vc, v_scale=vs,
                           lengths=new_lengths)
