"""Dense Llama in PyTorch: INT4/INT8 weights, INT8 KV cache.

The port of the JAX package's ``models/llama.py`` for the dense family
(Llama-3 and its test configs): RMSNorm, rotate-half RoPE with ``none`` or
``llama3`` scaling, GQA attention over an int8 cache with one f32 scale per
(token, head), SwiGLU MLP. Every projection is a :class:`QTensor` consumed by
:func:`quant_tpu_torch.kernels.dequant_matmul`.

PyTorch idiom in place of JAX's:

* layers are stacked along a leading ``L`` axis like the JAX package, and a
  Python loop over layers replaces ``lax.scan``; ``QTensor.layer(i)`` and
  ``cache[i]`` are views of the stacks, never copies;
* the KV cache is updated IN PLACE (the JAX package threads donated
  buffers); :func:`forward` returns a :class:`KVCache` holding the same
  code/scale tensors and new ``lengths``;
* randomness comes from explicit ``torch.Generator`` objects, and every
  entry point takes an explicit ``device`` (the card unless ``"cpu"``).

Kernel selection mirrors the JAX ``make_layer_step``: decode (T=1) with an
int8 cache takes ``cache_insert_int8`` then ``flash_decode_int8``; prefill
(T>1) writes the cache with the plain scatter and runs the plain blockwise
attention. ``kernel_mode="xla"`` selects the plain versions throughout;
``"auto"``/``"pallas"`` select the CUDA kernels (whose wrappers take the
plain versions only for tensors on the CPU). Everything outside the dense
slice raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quant_tpu_torch.core.qtensor import QTensor, quantize_tensor_device
from quant_tpu_torch.kernels.attention import flash_decode_int8
from quant_tpu_torch.kernels.cache_insert import cache_insert_int8
from quant_tpu_torch.kernels.dequant_matmul import (dequant_matmul,
                                                    dequant_matmul_reference)
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.utils.device import check_on, resolve_device

__all__ = ["LayerParams", "QEmbed", "LlamaParams", "KVCache", "init_params",
           "init_cache", "forward", "check_supported"]


# ── params ──────────────────────────────────────────────────────────────


@dataclasses.dataclass
class LayerParams:
    """All layers, stacked along axis 0 (``QTensor`` leaves ``[L, ...]``).
    Fused columns: ``wqkv`` packs q|k|v, ``w_gate_up`` packs gate|up."""
    wqkv: QTensor        # [L] x [D, (Hq + 2*Hkv) * Dh]
    wo: QTensor          # [L] x [Hq*Dh, D]
    w_gate_up: QTensor   # [L] x [D, 2*I]
    w_down: QTensor      # [L] x [I, D]
    attn_norm: torch.Tensor   # f32 [L, D]
    mlp_norm: torch.Tensor    # f32 [L, D]
    qkv_bias: torch.Tensor    # f32 [L, (Hq + 2*Hkv) * Dh]; zeros for Llama
    q_norm: torch.Tensor      # f32 [L, Dh]; ones unless cfg.qk_norm
    k_norm: torch.Tensor      # f32 [L, Dh]


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


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for anything outside the dense slice."""
    unsupported = {
        "MoE (n_experts)": cfg.n_experts,
        "MLA (kv_lora_rank)": cfg.is_mla,
        "sliding windows": cfg.sliding_window,
        "attention softcaps": cfg.attn_softcap,
        "final logit softcaps": cfg.final_softcap,
        "post-block norms": cfg.post_norms,
        "qk_norm": cfg.qk_norm,
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
        "paged attention": cfg.attn_kernel == "paged",
        f"embed_bits={cfg.embed_bits}": cfg.embed_bits not in (8, 16),
        f"dtype={cfg.dtype!r}": cfg.dtype not in ("bfloat16", "float32"),
        f"bits={cfg.bits}": cfg.bits not in (4, 8),
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            "not in the port's dense Llama slice yet: " + ", ".join(bad))


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

    def stacked(k, n, make):
        """Fill a preallocated [L, ...] stack one layer at a time."""
        first = quant(make())
        codes = torch.empty((n_l,) + tuple(first.codes.shape),
                            dtype=first.codes.dtype, device=dev)
        scales = torch.empty((n_l,) + tuple(first.scales.shape),
                             dtype=torch.float32, device=dev)
        codes[0], scales[0] = first.codes, first.scales
        del first
        for i in range(1, n_l):
            qt = quant(make())
            codes[i], scales[i] = qt.codes, qt.scales
            del qt
        return QTensor(codes=codes, scales=scales, bits=cfg.bits,
                       group_size=cfg.group_size, shape=(k, n))

    layers = LayerParams(
        wqkv=stacked(d, qd + 2 * kvd, lambda: torch.cat(
            [dense(d, qd), dense(d, kvd), dense(d, kvd)], dim=1)),
        wo=stacked(qd, d, lambda: dense(qd, d)),
        w_gate_up=stacked(d, 2 * it, lambda: torch.cat(
            [dense(d, it), dense(d, it)], dim=1)),
        w_down=stacked(it, d, lambda: dense(it, d)),
        attn_norm=torch.ones((n_l, d), dtype=torch.float32, device=dev),
        mlp_norm=torch.ones((n_l, d), dtype=torch.float32, device=dev),
        qkv_bias=torch.zeros((n_l, qd + 2 * kvd), dtype=torch.float32,
                             device=dev),
        q_norm=torch.ones((n_l, hd), dtype=torch.float32, device=dev),
        k_norm=torch.ones((n_l, hd), dtype=torch.float32, device=dev),
    )
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


def _use_flash(cfg: ModelConfig, t: int) -> bool:
    """The decode kernel pair (in-place insert + flash decode) for T=1, as
    ``make_layer_step`` selects it; the plain path otherwise."""
    if cfg.kernel_mode == "xla" or cfg.attn_kernel == "xla":
        return False
    return t == 1


def forward(params: LlamaParams, tokens, cache: KVCache, cfg: ModelConfig,
            axis=None, seq_axis=None, expert_axis=None, adapter_ids=None,
            return_hidden: bool = False, *,
            device=None) -> tuple[torch.Tensor, KVCache]:
    """One model step (prefill if T>1, decode if T==1).

    Token t of slot b gets position ``cache.lengths[b] + t``. The cache's
    code/scale tensors are written IN PLACE; the returned cache holds them
    with ``lengths + T``. Returns (logits f32 ``[B, T, vocab_size]``,
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
    flash = _use_flash(cfg, t)
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
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        k_q, k_s = quantize_kv(k, cfg.kv_bits)
        v_q, v_s = quantize_kv(v, cfg.kv_bits)
        if flash:
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
        gu = mm(x, lay.w_gate_up, i)
        gate, up = gu.chunk(2, dim=-1)
        a_in = _act(cfg)(gate.to(torch.float32)).to(dt) * up
        h = h + mm(a_in, lay.w_down, i, out_dtype=torch.float32).to(dt)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    logits = mm(h, params.lm_head, out_dtype=torch.float32)
    logits = logits[..., :cfg.vocab_size]
    return logits, KVCache(k_codes=kc, k_scale=ks, v_codes=vc, v_scale=vs,
                           lengths=new_lengths)
