"""Model / quantization configs (frozen dataclasses).

Field for field the same as the JAX package's ``models/config.py``, with
the same defaults and presets, so a checkpoint manifest parses identically
in both packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate: int
    # 0 → derive dim // n_heads; models with a decoupled head_dim (some
    # newer Qwen/Llama variants) set it explicitly (ADVICE r1).
    head_dim: int = 0
    rope_theta: float = 10000.0
    # RoPE frequency scaling for long-context models:
    # * "none": plain RoPE.
    # * "linear": positions effectively divided by rope_factor.
    # * "llama3" (Llama-3.1/3.2): NTK-by-parts — low-frequency bands
    #   scale by 1/factor, high-frequency bands stay, with a smooth
    #   ramp between rope_low_freq_factor and rope_high_freq_factor
    #   wavelength thresholds of rope_orig_max_pos.
    # * "yarn" (DeepSeek-V2/V3 long context, Qwen >32k): NTK-by-parts
    #   interpolation with beta_fast/beta_slow rotation bounds and an
    #   attention_factor multiplying the rotated output (HF yarn
    #   semantics; attention_factor inferred from factor/mscale/
    #   mscale_all_dim when rope_attn_factor is 0). ``score_mscale``
    #   additionally multiplies the ATTENTION SCORE scale by
    #   yarn_mscale(factor, mscale_all_dim)^2 — the DeepseekV3 behavior
    #   (HF DeepseekV2 does NOT apply it; conversions mirror each).
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_orig_max_pos: int = 8192
    rope_mscale: float = 0.0          # yarn; 0 = unset
    rope_mscale_all_dim: float = 0.0  # yarn; 0 = unset
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_attn_factor: float = 0.0     # yarn; 0 = infer from factor/mscale
    score_mscale: bool = False
    norm_eps: float = 1e-5
    qkv_bias: bool = False  # Qwen2 family
    # Mistral-v0.1-style sliding-window attention: key s is visible to
    # query position p iff p - window < s <= p (0 = full causal). Mask-only
    # (cache layout unchanged); forces the XLA attention path.
    sliding_window: int = 0
    # Gemma family: RMSNorm multiplies by (1 + w), the MLP gate is
    # tanh-approx GeLU, and embeddings are scaled by sqrt(dim).
    norm_offset: float = 0.0
    act_fn: str = "silu"          # "silu" | "gelu_tanh"
    embed_scale: bool = False
    # Qwen3 family: per-head RMSNorm on q and k (over head_dim, learned
    # [Dh] weights shared across heads) after projection, before RoPE.
    qk_norm: bool = False
    # Gemma-2 family:
    # * sliding_pattern p alternates local/global attention: layer i is
    #   GLOBAL iff (i + 1) % p == 0, else it uses sliding_window
    #   (p=2 → Gemma-2's local/global alternation; p=0 → every layer
    #   sliding, the Mistral default).
    # * attn_softcap / final_softcap: tanh softcapping c·tanh(x/c) on
    #   attention scores (before masking) / LM logits (0 = off).
    # * post_norms: extra RMSNorms on the attention and MLP block
    #   OUTPUTS (before the residual add), on top of the pre-norms.
    # * query_pre_attn_scalar s: attention scores scale by s^-0.5
    #   instead of head_dim^-0.5 (0 = head_dim).
    sliding_pattern: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_norms: bool = False
    query_pre_attn_scalar: float = 0.0
    # Gemma-3: sliding layers use a DIFFERENT rope base (local theta);
    # global layers keep rope_theta. 0 = off (uniform theta). With
    # rope_scaling="linear", the factor applies to GLOBAL layers only
    # (the HF Gemma-3 semantics); other scaling types are rejected.
    rope_local_theta: float = 0.0
    # Mixtral-style sparse MoE MLP: n_experts > 0 replaces the dense MLP
    # with a top-k routed mixture (router = linear [D, E], softmax over
    # ALL experts, top ``experts_per_token`` kept; ``norm_topk`` renorms
    # the kept weights to sum to 1 — Mixtral semantics). Inference
    # computes every expert densely and combines with the (mostly-zero)
    # routing weights: static shapes, no token dropping, and at decode
    # batch sizes it is HBM-optimal — each expert's packed weights are
    # read once per step, exactly like routed dispatch once B >= E.
    n_experts: int = 0
    experts_per_token: int = 2
    norm_topk: bool = True
    # MoE high-load dispatch: "dense" (every expert on every token, exact)
    # or "capacity" (GShard-style fixed-capacity dispatch past
    # tokens*k >= 2E; overflow tokens lose that expert's contribution).
    moe_prefill: str = "dense"
    moe_capacity_factor: float = 1.5
    # Fused all-experts MoE matmuls (one launch per projection).
    moe_fused: bool = True
    # Routed-hot MoE decode: "auto" streams only the experts some token
    # routed to when the expected hot coverage is below 7/8; "on"/"off"
    # force it.
    moe_routed: str = "auto"
    # DeepSeek-V2/V3 multi-head latent attention (MLA): kv_lora_rank > 0
    # enables it. Projections: (optionally low-rank) q → per-head
    # [qk_nope | qk_rope]; kv_a → a shared compressed latent
    # [kv_lora_rank | qk_rope] where only the rope slice is positional
    # (RoPE'd, shared across heads like MQA). The TPU-first decode uses
    # the ABSORBED form: per-head up-projections W_UK/W_UV fold into the
    # query/output sides, attention runs as MQA over the quantized
    # latent, and the cache stores kv_lora_rank + qk_rope floats per
    # token TOTAL (DeepSeek-V3: 576 vs Llama-8B GQA's 2048 int8 bytes).
    kv_lora_rank: int = 0
    q_lora_rank: int = 0          # 0 = direct q projection (V2-Lite)
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # DeepSeek RoPE applies rotation over INTERLEAVED (even, odd) pairs
    # (HF DeepseekV2 complex rope / DeepseekV3 rope_interleave=True)
    # instead of the rotate-half split; scores are equal under any fixed
    # pair layout so ours de-interleaves then rotates half.
    rope_interleaved: bool = False
    # DeepSeek MoE (composes with n_experts/experts_per_token/norm_topk):
    # * n_shared_experts: always-on shared expert(s), one dense GLU with
    #   intermediate = n_shared_experts * cfg.intermediate, added to the
    #   routed combination (cfg.intermediate = per-expert width).
    # * first_k_dense: the first k layers use a plain dense MLP of width
    #   ``dense_intermediate`` instead of the MoE block.
    # * routed_scaling: multiplies the kept routing weights.
    # * score_fn: "softmax" (V2) | "sigmoid" (V3).
    # * router_bias: V3 e_score_correction_bias — added to scores for
    #   expert SELECTION only (gathered weights stay unbiased).
    # * n_expert_groups/topk_groups: group-limited routing — experts
    #   split into G groups, only the best topk_groups groups are
    #   routable per token. Group score: "max" of member scores (V2
    #   group_limited_greedy) | "top2sum" (V3 noaux_tc).
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_intermediate: int = 0   # 0 → cfg.intermediate
    routed_scaling: float = 1.0
    score_fn: str = "softmax"
    router_bias: bool = False
    n_expert_groups: int = 0
    topk_groups: int = 0
    group_score: str = "max"
    # quantization
    bits: int = 4
    group_size: int = 128
    # codebook ("bin-lookup") weight quantization: None = linear RTN;
    # "nf4" = the oracle's normative 16-entry NF4 table; "lloyd" =
    # per-tensor Lloyd-Max fit (host converters only). int4-only.
    codebook: str | None = None
    # How codebook checkpoints execute: "int8" transcodes them once at
    # load into linear int8; "word4" / "sel15" gather the table in-kernel.
    lut_runtime: str = "int8"
    # 8 → int8 KV cache; 4 → int4 (head-pair nibble-packed, halves KV
    # HBM traffic/footprint — llama._kv_code_dims); 16 → unquantized
    # (quality ablation; XLA attn only)
    kv_bits: int = 8
    embed_bits: int = 16  # 8 → int8 per-row quantized embedding table
    # execution
    kernel_mode: str = "auto"  # auto | pallas | pallas_interpret | xla
    # W8A8/W4A8: quantize activations to int8 inside the matmul kernels.
    act_quant: bool = False
    # decode attention: "xla" = the plain cache scatter + attention path;
    # "flash" = the decode kernel pair (in-place insert + flash decode);
    # "paged" = the page-table pair; "auto" picks per shape.
    attn_kernel: str = "auto"
    dtype: str = "bfloat16"

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def mla_kv_dim(self) -> int:
        """Logical per-token latent width: [c_kv | k_rope]."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def mla_cache_dim(self) -> int:
        """Physical latent cache row width: mla_kv_dim padded up to a
        128 multiple (DeepSeek's 576 -> 640); queries pad to match, so
        scores and the prefix-slice value read are exact."""
        return -(-self.mla_kv_dim // 128) * 128

    def __post_init__(self):
        if self.is_mla:
            if not (self.qk_nope_head_dim and self.qk_rope_head_dim
                    and self.v_head_dim):
                raise ValueError(
                    "MLA (kv_lora_rank > 0) needs qk_nope_head_dim, "
                    "qk_rope_head_dim and v_head_dim")
            if self.n_kv_heads != 1:
                raise ValueError(
                    "MLA caches ONE shared latent per token — set "
                    "n_kv_heads=1")
            if self.head_dim == 0:
                # q head dim (scores run at qk_nope + qk_rope width)
                object.__setattr__(
                    self, "head_dim",
                    self.qk_nope_head_dim + self.qk_rope_head_dim)
            if self.query_pre_attn_scalar == 0:
                object.__setattr__(
                    self, "query_pre_attn_scalar",
                    float(self.qk_nope_head_dim + self.qk_rope_head_dim))
            if self.kv_bits == 4:
                raise ValueError("MLA supports kv_bits 8|16 (the latent "
                                 "has no head pairs to nibble-pack)")
            if (self.sliding_window or self.attn_softcap or self.qk_norm
                    or self.post_norms):
                raise ValueError("MLA does not compose with sliding "
                                 "windows, softcaps, qk_norm or "
                                 "post_norms (no DeepSeek model uses "
                                 "them)")
        if self.first_k_dense:
            if not self.n_experts:
                raise ValueError("first_k_dense needs n_experts > 0")
            if self.first_k_dense >= self.n_layers:
                raise ValueError("first_k_dense must leave MoE layers")
        if self.n_expert_groups:
            if self.n_experts % self.n_expert_groups:
                raise ValueError("n_expert_groups must divide n_experts")
            if not (0 < self.topk_groups <= self.n_expert_groups):
                raise ValueError("topk_groups must be in "
                                 "[1, n_expert_groups]")
            if self.group_score not in ("max", "top2sum"):
                raise ValueError("group_score must be max|top2sum")
        if self.score_fn not in ("softmax", "sigmoid"):
            raise ValueError(f"score_fn must be softmax|sigmoid, "
                             f"got {self.score_fn!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.dim // self.n_heads)
        if self.act_fn not in ("silu", "gelu_tanh"):
            raise ValueError(f"act_fn must be silu|gelu_tanh, "
                             f"got {self.act_fn!r}")
        if self.codebook is not None:
            if self.codebook not in ("nf4", "lloyd"):
                raise ValueError(f"codebook must be nf4|lloyd|None, "
                                 f"got {self.codebook!r}")
            if self.bits != 4:
                raise ValueError("codebook quantization is int4-only")
        if self.lut_runtime not in ("int8", "word4", "sel15"):
            raise ValueError(f"lut_runtime must be int8|word4|sel15, "
                             f"got {self.lut_runtime!r}")
        if self.kv_bits not in (4, 8, 16):
            raise ValueError(
                f"kv_bits must be 4, 8 or 16, got {self.kv_bits}")
        if self.kv_bits == 4 and self.n_kv_heads % 2:
            raise ValueError(
                "kv_bits=4 packs nibbles across head pairs and needs an "
                "even n_kv_heads")
        if self.attn_kernel not in ("auto", "xla", "flash", "paged"):
            raise ValueError(f"attn_kernel must be auto|xla|flash|paged, "
                             f"got {self.attn_kernel!r}")
        if self.n_experts and not (
                0 < self.experts_per_token <= self.n_experts):
            raise ValueError(
                f"experts_per_token {self.experts_per_token} must be in "
                f"[1, n_experts={self.n_experts}]")
        if self.moe_prefill not in ("dense", "capacity"):
            raise ValueError(f"moe_prefill must be dense|capacity, "
                             f"got {self.moe_prefill!r}")
        if self.moe_routed not in ("auto", "on", "off"):
            raise ValueError(f"moe_routed must be auto|on|off, "
                             f"got {self.moe_routed!r}")
        if self.sliding_pattern and not self.sliding_window:
            raise ValueError("sliding_pattern needs sliding_window > 0")
        if self.rope_scaling not in ("none", "linear", "llama3", "yarn"):
            raise ValueError(
                f"rope_scaling must be none|linear|llama3|yarn, "
                f"got {self.rope_scaling!r}")
        if self.score_mscale and self.rope_scaling != "yarn":
            raise ValueError("score_mscale is a yarn-mode knob")
        if self.rope_local_theta:
            if not self.sliding_window:
                raise ValueError("rope_local_theta needs sliding_window")
            if self.rope_scaling not in ("none", "linear"):
                raise ValueError("rope_local_theta composes only with "
                                 "none/linear rope_scaling")


PRESETS: dict[str, ModelConfig] = {
    # 2-layer toy for unit tests (dims aligned to 128 lanes).
    "test-tiny": ModelConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        intermediate=512, group_size=64, kernel_mode="xla",
    ),
    "tinyllama-1.1b": ModelConfig(
        vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
        intermediate=5632, rope_theta=10000.0, embed_bits=8,
    ),
    # Llama-3.2 small models: natural DRAFT models for speculative
    # decoding against the 8B/70B targets (same tokenizer/vocab).
    # 128k-context via the llama3 NTK-by-parts rope scaling (factor 32).
    "llama-3.2-1b": ModelConfig(
        vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        intermediate=8192, head_dim=64, rope_theta=500000.0, embed_bits=8,
        rope_scaling="llama3", rope_factor=32.0,
        rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_orig_max_pos=8192,
    ),
    "llama-3.2-3b": ModelConfig(
        vocab_size=128256, dim=3072, n_layers=28, n_heads=24, n_kv_heads=8,
        intermediate=8192, head_dim=128, rope_theta=500000.0, embed_bits=8,
        rope_scaling="llama3", rope_factor=32.0,
        rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_orig_max_pos=8192,
    ),
    "llama-3-8b": ModelConfig(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        intermediate=14336, rope_theta=500000.0, embed_bits=8,
    ),
    "qwen2-7b": ModelConfig(
        vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
        intermediate=18944, rope_theta=1000000.0, norm_eps=1e-6,
        qkv_bias=True, embed_bits=8,
    ),
    "llama-3-70b": ModelConfig(
        vocab_size=128256, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        intermediate=28672, rope_theta=500000.0, embed_bits=8,
    ),
    # Phi-3-mini-4k (fused qkv/gate_up in the HF checkpoint — split by
    # the converter; MHA, silu, plain RoPE).
    "phi-3-mini-4k": ModelConfig(
        vocab_size=32064, dim=3072, n_layers=32, n_heads=32,
        n_kv_heads=32, intermediate=8192, rope_theta=10000.0,
        embed_bits=8,
    ),
    # Mistral-7B-v0.1 (sliding-window attention, window 4096).
    "mistral-7b": ModelConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        intermediate=14336, rope_theta=10000.0, sliding_window=4096,
        embed_bits=8,
    ),
    # Gemma-7B (GeGLU, (1+w) RMSNorm, sqrt(dim)-scaled embeddings, tied
    # lm_head, decoupled head_dim=256).
    "gemma-7b": ModelConfig(
        vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
        intermediate=24576, head_dim=256, rope_theta=10000.0,
        norm_eps=1e-6, norm_offset=1.0, act_fn="gelu_tanh",
        embed_scale=True, embed_bits=8,
    ),
    # Gemma-2 (alternating local/global attention, attn+final logit
    # softcapping, post-block norms, query_pre_attn_scalar, tied head).
    "gemma-2-2b": ModelConfig(
        vocab_size=256000, dim=2304, n_layers=26, n_heads=8, n_kv_heads=4,
        intermediate=9216, head_dim=256, rope_theta=10000.0,
        norm_eps=1e-6, norm_offset=1.0, act_fn="gelu_tanh",
        embed_scale=True, embed_bits=8, sliding_window=4096,
        sliding_pattern=2, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, query_pre_attn_scalar=256.0,
    ),
    "gemma-2-9b": ModelConfig(
        vocab_size=256000, dim=3584, n_layers=42, n_heads=16, n_kv_heads=8,
        intermediate=14336, head_dim=256, rope_theta=10000.0,
        norm_eps=1e-6, norm_offset=1.0, act_fn="gelu_tanh",
        embed_scale=True, embed_bits=8, sliding_window=4096,
        sliding_pattern=2, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, query_pre_attn_scalar=256.0,
    ),
    # Gemma-3-1B (5:1 local/global alternation with per-type rope bases,
    # zero-centered QK-RMSNorm, post-norms, no softcaps, tied head).
    "gemma-3-1b": ModelConfig(
        vocab_size=262144, dim=1152, n_layers=26, n_heads=4, n_kv_heads=1,
        intermediate=6912, head_dim=256, rope_theta=1000000.0,
        rope_local_theta=10000.0, norm_eps=1e-6, norm_offset=1.0,
        act_fn="gelu_tanh", embed_scale=True, embed_bits=8,
        sliding_window=512, sliding_pattern=6, post_norms=True,
        qk_norm=True, query_pre_attn_scalar=256.0,
    ),
    # Qwen3-8B (QK-RMSNorm, no qkv bias, decoupled head_dim=128).
    "qwen3-8b": ModelConfig(
        vocab_size=151936, dim=4096, n_layers=36, n_heads=32, n_kv_heads=8,
        intermediate=12288, head_dim=128, rope_theta=1000000.0,
        norm_eps=1e-6, qk_norm=True, embed_bits=8,
    ),
    # 2-layer 4-expert toy for MoE unit tests.
    "test-tiny-moe": ModelConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        intermediate=512, group_size=64, kernel_mode="xla",
        n_experts=4, experts_per_token=2,
    ),
    # Mixtral-8x7B-v0.1 (8-expert top-2 sparse MLP; full causal attention
    # — the HF config's sliding_window was dropped in v0.1 updates).
    "mixtral-8x7b": ModelConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        intermediate=14336, rope_theta=1000000.0, embed_bits=8,
        n_experts=8, experts_per_token=2,
    ),
    # Qwen3-30B-A3B (128-expert top-8, per-expert intermediate 768,
    # QK-RMSNorm, renormed top-k probs).
    "qwen3-30b-a3b": ModelConfig(
        vocab_size=151936, dim=2048, n_layers=48, n_heads=32, n_kv_heads=4,
        intermediate=768, head_dim=128, rope_theta=1000000.0,
        norm_eps=1e-6, qk_norm=True, embed_bits=8,
        n_experts=128, experts_per_token=8, norm_topk=True,
    ),
    # 2-layer MLA toy (DeepSeek-V2-Lite flavor: direct q, interleaved
    # rope, dense MLP) for unit tests.
    "test-tiny-mla": ModelConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=1,
        intermediate=512, group_size=64, kernel_mode="xla",
        kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, rope_interleaved=True, norm_eps=1e-6,
    ),
    # 3-layer MLA + DeepSeek-V3-flavor MoE toy: low-rank q, sigmoid
    # scores + selection bias, group-limited top-2-sum routing, 2 shared
    # experts, 1 dense-prefix layer.
    "test-tiny-dsv3": ModelConfig(
        vocab_size=512, dim=256, n_layers=3, n_heads=4, n_kv_heads=1,
        intermediate=128, group_size=64, kernel_mode="xla",
        kv_lora_rank=64, q_lora_rank=64, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32, rope_interleaved=True,
        norm_eps=1e-6, n_experts=8, experts_per_token=2, norm_topk=True,
        n_shared_experts=2, first_k_dense=1, dense_intermediate=512,
        routed_scaling=2.5, score_fn="sigmoid", router_bias=True,
        n_expert_groups=4, topk_groups=2, group_score="top2sum",
    ),
    # DeepSeek-V2-Lite (27 layers; MLA r=512/dn=128/dr=64/dv=128 with a
    # DIRECT q projection; 64-expert top-6 greedy softmax routing with 2
    # shared experts, first layer dense; interleaved rope; yarn to 160k
    # with the released checkpoint's mscale 0.707. score_mscale ON: the
    # checkpoint was trained with the original modeling code's
    # yarn_mscale(40, 0.707)^2 = 1.59x softmax scale (vLLM/sglang
    # apply it too; transformers' integrated DeepseekV2 omits it).
    "deepseek-v2-lite": ModelConfig(
        vocab_size=102400, dim=2048, n_layers=27, n_heads=16,
        n_kv_heads=1, intermediate=1408, rope_theta=10000.0,
        norm_eps=1e-6, embed_bits=8, group_size=64,
        # gs=64: the dense-prefix MLP width 10944 = 2^6 * 171 only
        # admits 64-sized K groups (1408 and 2048 divide either way)
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rope_interleaved=True,
        n_experts=64, experts_per_token=6, norm_topk=False,
        n_shared_experts=2, first_k_dense=1, dense_intermediate=10944,
        rope_scaling="yarn", rope_factor=40.0, rope_orig_max_pos=4096,
        rope_mscale=0.707, rope_mscale_all_dim=0.707, score_mscale=True,
    ),
    # DeepSeek-V3/R1 (671B total / 37B active): MLA with low-rank q
    # (1536), 256-expert top-8 sigmoid routing with selection bias,
    # 8-group top-4 group-limited (top-2-sum group scores), renormed,
    # routed_scaling 2.5, 1 shared expert, 3 dense-prefix layers.
    # Latent cache: 576 B/token/layer int8 vs 2048 for Llama-8B GQA.
    # Yarn to 160k; V3 folds yarn mscale^2 into the score scale.
    "deepseek-v3": ModelConfig(
        vocab_size=129280, dim=7168, n_layers=61, n_heads=128,
        n_kv_heads=1, intermediate=2048, rope_theta=10000.0,
        norm_eps=1e-6, embed_bits=8,
        kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, rope_interleaved=True,
        n_experts=256, experts_per_token=8, norm_topk=True,
        n_shared_experts=1, first_k_dense=3, dense_intermediate=18432,
        routed_scaling=2.5, score_fn="sigmoid", router_bias=True,
        n_expert_groups=8, topk_groups=4, group_score="top2sum",
        rope_scaling="yarn", rope_factor=40.0, rope_orig_max_pos=4096,
        rope_mscale=1.0, rope_mscale_all_dim=1.0, score_mscale=True,
    ),
}
