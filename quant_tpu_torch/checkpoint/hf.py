"""Hugging Face checkpoint -> packed quantized checkpoint (``convert``).

The port of the JAX package's ``checkpoint/hf.py`` for round-to-nearest
quantization (``algo="rtn"``), tp=1 and no codebook. It streams: the
``*.safetensors`` tensors are read lazily, one at a time
(:class:`~quant_tpu_torch.checkpoint.safetensors.SafetensorsDir`, no
``safetensors`` package), moved to ``device`` (the card unless "cpu"),
transposed from torch's ``[out, in]`` to the ``[K, N]`` (``y = x @ W``)
layout, quantized there (:func:`quantize_tensor_device`, bit-exact with the
numpy codec) and appended to the checkpoint by :class:`CheckpointWriter`,
so the host holds about one tensor whatever the model's size. The
checkpoint is byte-equal to the JAX converter's on the same input (F32,
F16 or BF16 files: the weights are upcast to float32 first, exactly).

Families: the dense Llama family (tied embeddings; llama3, linear and yarn
rope; Qwen2 q/k/v biases; Qwen3 ``qk_norm``; Gemma-2's four norms; Phi-3's
fused ``qkv_proj`` / ``gate_up_proj``), the Mixtral and Qwen3-MoE experts,
and DeepSeek-V2/V3 (MLA, shared experts, selection bias, dense prefix).
The port's forward serves all of them (Gemma, Gemma-2 and Gemma-3 too). A
config outside it still converts; ``load_checkpoint`` refuses it
(``llama.check_supported``) before it decodes a blob. GPTQ/AWQ calibration, codebooks and tp>1 packing raise
``NotImplementedError`` naming the feature.
"""

from __future__ import annotations

import json
import pathlib

import torch

from quant_tpu_torch.checkpoint.format import CheckpointWriter
from quant_tpu_torch.checkpoint.safetensors import SafetensorsDir
from quant_tpu_torch.core.qtensor import quantize_tensor_device
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.models.llama import (_make_embed, _pad_moe_down_k,
                                          _pad_vocab)
from quant_tpu_torch.utils.device import resolve_device

__all__ = ["config_from_hf", "convert_hf_llama"]

# our dense projection -> its HF module under ``model.layers.{i}.``
_LAYER_MAP = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def _rope_scaling_kw(rs) -> dict:
    """HF ``config.rope_scaling`` -> ModelConfig rope fields (llama3
    NTK-by-parts, linear, yarn)."""
    if not rs:
        return {}
    rtype = rs.get("rope_type") or rs.get("type")
    if rtype == "llama3":
        return dict(
            rope_scaling="llama3",
            rope_factor=float(rs.get("factor", 8.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_orig_max_pos=int(
                rs.get("original_max_position_embeddings", 8192)),
        )
    if rtype == "linear":
        return dict(rope_scaling="linear",
                    rope_factor=float(rs.get("factor", 1.0)))
    if rtype == "yarn":
        return dict(
            rope_scaling="yarn",
            rope_factor=float(rs.get("factor", 1.0)),
            rope_orig_max_pos=int(
                rs.get("original_max_position_embeddings", 4096)),
            rope_mscale=float(rs.get("mscale") or 0.0),
            rope_mscale_all_dim=float(rs.get("mscale_all_dim") or 0.0),
            rope_beta_fast=float(rs.get("beta_fast") or 32.0),
            rope_beta_slow=float(rs.get("beta_slow") or 1.0),
            rope_attn_factor=float(rs.get("attention_factor") or 0.0),
        )
    if rtype in (None, "default"):
        return {}
    raise ValueError(f"unsupported rope_scaling type {rtype!r} "
                     "(supported: llama3, linear, yarn)")


def config_from_hf(model_dir, **overrides) -> ModelConfig:
    """The ModelConfig of a HF ``config.json`` (the JAX package's mapping,
    field for field); ``overrides`` replace fields (bits, group_size)."""
    hf = json.loads((pathlib.Path(model_dir) / "config.json").read_text())
    mtype = hf.get("model_type", "llama")
    if mtype == "gemma3":
        raise ValueError(
            "multimodal gemma3 checkpoints (nested text_config + vision "
            "tower) are not supported; convert a gemma3_text checkpoint")
    if mtype == "gemma3_text":
        pat = hf.get("sliding_window_pattern")
        if pat is not None and int(pat) != 6:
            raise ValueError(
                f"gemma3_text sliding_window_pattern {pat} != 6 is not "
                "supported")
        lts = hf.get("layer_types")
        if lts is not None and any(
                (t == "full_attention") != ((i + 1) % 6 == 0)
                for i, t in enumerate(lts)):
            raise ValueError("gemma3_text layer_types deviate from the "
                             "5:1 local/global pattern")
    act = (hf.get("hidden_activation") or hf.get("hidden_act") or "silu")
    kw = dict(
        qkv_bias=bool(hf.get("attention_bias", False) or mtype == "qwen2"),
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        intermediate=hf["intermediate_size"],
        head_dim=int(hf.get("head_dim") or 0),
        rope_theta=hf.get("rope_theta", 10000.0),
        **_rope_scaling_kw(hf.get("rope_scaling")),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        # Mistral v0.1 sets sliding_window=4096; v0.2+ stores null
        sliding_window=int(hf.get("sliding_window") or 0)
        if hf.get("use_sliding_window", True) else 0,
        norm_offset=1.0 if mtype.startswith("gemma") else 0.0,
        act_fn="gelu_tanh" if "gelu" in act else "silu",
        embed_scale=mtype.startswith("gemma"),
        sliding_pattern=(2 if mtype == "gemma2"
                         else 6 if mtype == "gemma3_text" else 0),
        attn_softcap=float(hf.get("attn_logit_softcapping") or 0.0),
        final_softcap=float(hf.get("final_logit_softcapping") or 0.0),
        post_norms=mtype in ("gemma2", "gemma3_text"),
        query_pre_attn_scalar=float(
            hf.get("query_pre_attn_scalar") or 0.0),
        rope_local_theta=(
            float(hf.get("rope_local_base_freq", 10000.0) or 10000.0)
            if mtype == "gemma3_text" else 0.0),
        qk_norm=mtype in ("qwen3", "qwen3_moe", "gemma3_text"),
        # sparse MoE: Mixtral (num_local_experts) / Qwen3-MoE (num_experts)
        n_experts=(int(hf.get("num_local_experts", 0))
                   if mtype == "mixtral"
                   else int(hf.get("num_experts", 0))
                   if mtype == "qwen3_moe" else 0),
        experts_per_token=int(hf.get("num_experts_per_tok", 2) or 2),
        norm_topk=bool(hf.get("norm_topk_prob", True)),
    )
    if mtype == "qwen3_moe":
        # the MoE stack is uniformly sparse: no interleaved dense layers
        if hf.get("mlp_only_layers") or hf.get("decoder_sparse_step", 1) != 1:
            raise ValueError("qwen3_moe with dense/interleaved MLP layers "
                             "(mlp_only_layers / decoder_sparse_step != 1) "
                             "is not supported")
        kw["intermediate"] = hf["moe_intermediate_size"]
    if mtype in ("deepseek_v2", "deepseek_v3"):
        v3 = mtype == "deepseek_v3"
        n_exp = int(hf.get("n_routed_experts") or 0)
        if not v3 and hf.get("topk_method") not in (
                None, "greedy", "group_limited_greedy") and n_exp:
            raise ValueError(
                f"deepseek_v2 topk_method {hf.get('topk_method')!r} is "
                "not supported (greedy | group_limited_greedy)")
        grouped = (v3 or hf.get("topk_method") == "group_limited_greedy")
        kw.update(
            n_kv_heads=1,           # MLA: one shared latent per token
            head_dim=0,             # derived: qk_nope + qk_rope
            kv_lora_rank=int(hf["kv_lora_rank"]),
            q_lora_rank=int(hf.get("q_lora_rank") or 0),
            qk_nope_head_dim=int(hf["qk_nope_head_dim"]),
            qk_rope_head_dim=int(hf["qk_rope_head_dim"]),
            v_head_dim=int(hf["v_head_dim"]),
            # V2 always rotates interleaved pairs; V3 stores the choice
            rope_interleaved=bool(hf.get("rope_interleave", True))
            if v3 else True,
            n_experts=n_exp,
            experts_per_token=int(hf.get("num_experts_per_tok") or 2),
            # the HF V2 gate ignores norm_topk_prob; V3 honours it
            norm_topk=bool(hf.get("norm_topk_prob", v3)) if v3 else False,
            n_shared_experts=int(hf.get("n_shared_experts") or 0),
            first_k_dense=(int(hf.get("first_k_dense_replace") or 0)
                           if n_exp else 0),
            dense_intermediate=hf["intermediate_size"] if n_exp else 0,
            intermediate=(hf["moe_intermediate_size"] if n_exp
                          else hf["intermediate_size"]),
            routed_scaling=float(hf.get("routed_scaling_factor") or 1.0),
            score_fn="sigmoid" if v3 else "softmax",
            router_bias=v3,
            n_expert_groups=int(hf.get("n_group") or 0) if grouped else 0,
            topk_groups=int(hf.get("topk_group") or 0) if grouped else 0,
            group_score="top2sum" if v3 else "max",
            qkv_bias=False,
        )
        if bool(hf.get("attention_bias", False)):
            raise ValueError("deepseek attention_bias is not supported")
        rs = hf.get("rope_scaling") or {}
        if (rs.get("rope_type") or rs.get("type")) == "yarn" and \
                rs.get("mscale_all_dim"):
            # both DeepSeek generations were released with the yarn
            # mscale^2 softmax scale (the original modeling code)
            kw["score_mscale"] = True
    if float(hf.get("partial_rotary_factor") or 1.0) != 1.0:
        raise ValueError("partial_rotary_factor != 1 is not supported")
    kw.update(overrides)
    return ModelConfig(**kw)


def concat_columns(parts: list[torch.Tensor]) -> torch.Tensor:
    """Fuse dense ``[K, Ni]`` weights along N (tp=1: part after part)."""
    return torch.cat(parts, dim=1)


def _pad_cols(w: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = w.shape[1]
    return w if n == n_pad else torch.nn.functional.pad(w, (0, n_pad - n))


def _qkv_parts(hf, cfg, pre: str, t) -> list[torch.Tensor]:
    """[wq, wk, wv] as [K, N] parts, from separate projections or Phi-3's
    fused ``qkv_proj`` ([q | k | v] rows of the HF weight)."""
    if pre + "self_attn.qkv_proj.weight" in hf:
        fused = t(pre + "self_attn.qkv_proj.weight")
        nq = cfg.n_heads * cfg.head_dim
        nkv = cfg.n_kv_heads * cfg.head_dim
        return [fused[:, :nq], fused[:, nq:nq + nkv], fused[:, nq + nkv:]]
    return [t(pre + _LAYER_MAP[f] + ".weight") for f in ("wq", "wk", "wv")]


def _gu_parts(hf, cfg, pre: str, t) -> list[torch.Tensor]:
    """[w_gate, w_up], separate or Phi-3's fused ``gate_up_proj``."""
    if pre + "mlp.gate_up_proj.weight" in hf:
        fused = t(pre + "mlp.gate_up_proj.weight")
        half = fused.shape[1] // 2
        return [fused[:, :half], fused[:, half:]]
    return [t(pre + _LAYER_MAP[f] + ".weight") for f in ("w_gate", "w_up")]


def _refuse_unported(algo: str, codebook, tp: int) -> None:
    if algo not in ("rtn", "gptq", "awq", "awq+gptq"):
        raise ValueError(f"algo must be rtn|gptq|awq|awq+gptq, got {algo!r}")
    if algo != "rtn":
        raise NotImplementedError(
            f"algo={algo!r} (GPTQ/AWQ calibration) is not ported; convert "
            "with algo='rtn'")
    if codebook is not None:
        raise NotImplementedError(
            f"codebook={codebook!r} quantization is not ported")
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp} packing (interleaved columns, split-K shards, blobs "
            "per rank) is not ported")


def convert_hf_llama(model_dir, out_dir, bits: int = 4,
                     group_size: int = 128, tp: int = 1,
                     cfg: ModelConfig | None = None, algo: str = "rtn",
                     calib_tokens=None, codebook: str | None = None,
                     device=None) -> ModelConfig:
    """Convert a HF Llama-family / MoE / DeepSeek directory into a packed
    quantized checkpoint at ``out_dir``, tensor by tensor, quantizing on
    ``device`` (the card unless "cpu"). The JAX converter's signature:
    ``algo`` other than "rtn" (``calib_tokens`` is its input), ``codebook``
    and ``tp`` > 1 raise ``NotImplementedError``. Returns the config."""
    _refuse_unported(algo, codebook, tp)
    dev = resolve_device(device)
    model_dir = pathlib.Path(model_dir)
    if cfg is None:
        cfg = config_from_hf(model_dir, bits=bits, group_size=group_size)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    hf = SafetensorsDir(model_dir)
    try:
        _convert(hf, hf_cfg, cfg, CheckpointWriter(out_dir, cfg), dev)
    finally:
        hf.close()
    return cfg


def _convert(hf, hf_cfg: dict, cfg: ModelConfig, w: CheckpointWriter,
             dev: torch.device) -> None:
    """Every leaf of the checkpoint, in the JAX converter's order."""

    def f32(name):          # norms, biases: float32 on the host
        return hf.get(name).to(torch.float32)

    def t(name):            # [out, in] -> [K, N] float32 on the device
        return hf.get(name).to(dev).to(torch.float32).T

    def qz(arr):
        return quantize_tensor_device(arr, cfg.bits, cfg.group_size)

    # int8 rows with per-row scales (embed_bits=8) or the table in
    # cfg.dtype: the JAX converter's numpy arithmetic, in torch
    w.add("embed", _make_embed(hf.get("model.embed_tokens.weight").to(dev),
                               cfg))
    w.add("final_norm", f32("model.norm.weight"))
    head = ("model.embed_tokens.weight"
            if hf_cfg.get("tie_word_embeddings") or "lm_head.weight" not in hf
            else "lm_head.weight")
    w.add("lm_head", qz(_pad_cols(t(head), _pad_vocab(cfg.vocab_size))))
    for i in range(cfg.n_layers):
        if cfg.is_mla:
            _convert_layer_deepseek(w, hf, cfg, i, t, f32, qz)
        else:
            _convert_layer(w, hf, cfg, i, t, f32, qz)
    w.finish()


def _convert_layer(w, hf, cfg, i, t, f32, qz):
    """One dense or sparse-MoE layer, in the JAX converter's blob order."""
    pre = f"model.layers.{i}."
    dst = f"layers.{i}"
    w.add(f"{dst}.wqkv", qz(concat_columns(_qkv_parts(hf, cfg, pre, t))))
    w.add(f"{dst}.wo", qz(t(pre + _LAYER_MAP["wo"] + ".weight")))
    if cfg.n_experts:
        # router [D, E] raw; one blob per (layer, expert). Two HF namings:
        # Mixtral block_sparse_moe (gate / experts.N.{w1,w3,w2}) and
        # Qwen3-MoE mlp (gate / experts.N.{gate,up,down}_proj)
        mixtral = pre + "block_sparse_moe.gate.weight" in hf
        moe_pre = pre + ("block_sparse_moe." if mixtral else "mlp.")
        names = (("w1", "w3", "w2") if mixtral
                 else ("gate_proj", "up_proj", "down_proj"))
        w.add(f"{dst}.router", t(moe_pre + "gate.weight"))
        for e in range(cfg.n_experts):
            epre = moe_pre + f"experts.{e}."
            w.add(f"{dst}.we_gate_up.{e}", qz(concat_columns(
                [t(f"{epre}{names[0]}.weight"),
                 t(f"{epre}{names[1]}.weight")])))
            w.add(f"{dst}.we_down.{e}",
                  qz(_pad_moe_down_k(t(f"{epre}{names[2]}.weight"))))
    else:
        w.add(f"{dst}.w_gate_up",
              qz(concat_columns(_gu_parts(hf, cfg, pre, t))))
        w.add(f"{dst}.w_down", qz(t(pre + _LAYER_MAP["w_down"] + ".weight")))
    w.add(f"{dst}.attn_norm", f32(pre + "input_layernorm.weight"))
    if cfg.post_norms:
        # Gemma-2's four norms: HF's post_attention_layernorm is the norm
        # after attention; the pre-MLP norm is pre_feedforward_layernorm
        w.add(f"{dst}.mlp_norm", f32(pre + "pre_feedforward_layernorm.weight"))
        w.add(f"{dst}.post_attn_norm",
              f32(pre + "post_attention_layernorm.weight"))
        w.add(f"{dst}.post_mlp_norm",
              f32(pre + "post_feedforward_layernorm.weight"))
    else:
        w.add(f"{dst}.mlp_norm", f32(pre + "post_attention_layernorm.weight"))
    if pre + "self_attn.q_proj.bias" in hf:  # Qwen2 family
        bias = torch.cat([f32(pre + f"self_attn.{p}_proj.bias")
                          for p in ("q", "k", "v")])
    else:
        bias = torch.zeros(((cfg.n_heads + 2 * cfg.n_kv_heads)
                            * cfg.head_dim,), dtype=torch.float32)
    w.add(f"{dst}.qkv_bias", bias)
    for field in ("q_norm", "k_norm"):
        name = pre + f"self_attn.{field}.weight"   # Qwen3 QK-RMSNorm
        w.add(f"{dst}.{field}", f32(name) if name in hf
              else torch.ones((cfg.head_dim,), dtype=torch.float32))


def _convert_layer_deepseek(w, hf, cfg, i, t, f32, qz):
    """One DeepSeek-V2/V3 layer: into ``layers0.{i}`` (dense prefix) when
    i < first_k_dense, else ``layers.{i - first_k_dense}``. HF's per-head
    ``kv_b_proj`` [H*(dn+dv), r] splits into the absorbed ``w_uk``
    [H, dn, r] and ``w_uv`` [H, r, dv], stored raw in float32."""
    pre = f"model.layers.{i}."
    k0 = cfg.first_k_dense
    dst = f"layers0.{i}" if i < k0 else f"layers.{i - k0}"
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        qpart = t(pre + "self_attn.q_a_proj.weight")
        w.add(f"{dst}.q_a_norm", f32(pre + "self_attn.q_a_layernorm.weight"))
        w.add(f"{dst}.w_q_b", qz(t(pre + "self_attn.q_b_proj.weight")))
    else:
        qpart = t(pre + "self_attn.q_proj.weight")
    kv_a = t(pre + "self_attn.kv_a_proj_with_mqa.weight")
    w.add(f"{dst}.wqkv", qz(concat_columns([qpart, kv_a])))
    w.add(f"{dst}.qkv_bias",
          torch.zeros((qpart.shape[1] + r + dr,), dtype=torch.float32))
    w.add(f"{dst}.kv_a_norm", f32(pre + "self_attn.kv_a_layernorm.weight"))
    kvb = f32(pre + "self_attn.kv_b_proj.weight").reshape(cfg.n_heads,
                                                          dn + dv, r)
    w.add(f"{dst}.w_uk", kvb[:, :dn, :].contiguous())
    w.add(f"{dst}.w_uv", kvb[:, dn:, :].transpose(1, 2).contiguous())
    w.add(f"{dst}.wo", qz(t(pre + "self_attn.o_proj.weight")))
    w.add(f"{dst}.attn_norm", f32(pre + "input_layernorm.weight"))
    w.add(f"{dst}.mlp_norm", f32(pre + "post_attention_layernorm.weight"))
    w.add(f"{dst}.q_norm", torch.ones((cfg.head_dim,), dtype=torch.float32))
    w.add(f"{dst}.k_norm", torch.ones((cfg.head_dim,), dtype=torch.float32))
    if i < k0 or not cfg.n_experts:
        w.add(f"{dst}.w_gate_up", qz(concat_columns(
            [t(pre + "mlp.gate_proj.weight"), t(pre + "mlp.up_proj.weight")])))
        w.add(f"{dst}.w_down", qz(t(pre + "mlp.down_proj.weight")))
        return
    w.add(f"{dst}.router", t(pre + "mlp.gate.weight"))
    if cfg.router_bias:
        w.add(f"{dst}.router_bias",
              f32(pre + "mlp.gate.e_score_correction_bias"))
    if cfg.n_shared_experts:
        spre = pre + "mlp.shared_experts."
        w.add(f"{dst}.ws_gate_up", qz(concat_columns(
            [t(spre + "gate_proj.weight"), t(spre + "up_proj.weight")])))
        w.add(f"{dst}.ws_down", qz(t(spre + "down_proj.weight")))
    for e in range(cfg.n_experts):
        epre = pre + f"mlp.experts.{e}."
        w.add(f"{dst}.we_gate_up.{e}", qz(concat_columns(
            [t(epre + "gate_proj.weight"), t(epre + "up_proj.weight")])))
        w.add(f"{dst}.we_down.{e}",
              qz(_pad_moe_down_k(t(epre + "down_proj.weight"))))

