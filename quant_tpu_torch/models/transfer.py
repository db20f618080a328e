"""Turn a flat dict of parameters into the port's :class:`LlamaParams`.

The input uses the checkpoint naming of the JAX package's
``checkpoint/format.py`` ``_flatten_params``: ``"embed"``, ``"final_norm"``,
``"lm_head"``, ``"layers.{i}.{field}"`` and, for a MoE model's experts,
``"layers.{i}.we_gate_up.{e}"`` / ``"layers.{i}.we_down.{e}"``. A DeepSeek
model's ``first_k_dense`` prefix stack is ``"layers0.{i}.{field}"``, and its
MoE stack ``"layers.{i}..."`` holds the ``n_layers - first_k_dense`` other
layers. Leaves are numpy arrays, or
objects with numpy ``codes``/``scales`` (and, for a quantized weight,
``bits``/``group_size``/``shape``/``kshards``/``lut``): the port's own
:class:`QTensor`/:class:`QEmbed` from the checkpoint reader, or the JAX
package's classes mapped through ``np.asarray`` in the tests. Per-layer
leaves are stacked along a new leading ``L`` axis on ``device``, expert
leaves into expert-major ``[E, L, ...]`` stacks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.models.llama import (LayerParams, LlamaParams, QEmbed,
                                          check_supported)
from quant_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_flat", "to_torch", "flat_from_params"]

# per-layer fields in the JAX package's LayerParams order (its checkpoint
# writer's order); the expert fields hold one leaf per (layer, expert)
_LAYER_FIELDS = ("wqkv", "wo", "w_gate_up", "w_down", "attn_norm",
                 "mlp_norm", "qkv_bias", "q_norm", "k_norm", "router",
                 "we_gate_up", "we_down", "post_attn_norm", "post_mlp_norm",
                 "w_q_b", "w_uk", "w_uv", "q_a_norm", "kv_a_norm",
                 "ws_gate_up", "ws_down", "router_bias")
_EXPERT_FIELDS = ("we_gate_up", "we_down")
_QTENSOR_FIELDS = ("wqkv", "wo", "w_gate_up", "w_down", "w_q_b",
                   "ws_gate_up", "ws_down")
# dense MLA up-projections keep the dtype they were stored in (the forward
# casts them to the activation type), so a checkpoint round-trips exactly
_KEEP_DTYPE = ("w_uk", "w_uv")


def to_torch(a, device=None) -> torch.Tensor:
    """numpy (including a bfloat16 array of the ``ml_dtypes`` kind) or a
    tensor -> tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.require(a, requirements=["C", "W"])   # copies only if needed
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _stack_q(leaves, device) -> QTensor:
    first = leaves[0]
    if getattr(first, "lut", None) is not None:
        raise NotImplementedError("codebook (lut) weights are not ported")
    if first.kshards != 1:
        raise NotImplementedError("kshards > 1 (tensor parallel packing) is "
                                  "not ported")
    # stacked where they go: no second host copy of a whole stack
    codes = torch.stack([to_torch(q.codes, device) for q in leaves])
    scales = torch.stack([to_torch(q.scales, device) for q in leaves])
    return QTensor(codes=codes, scales=scales, bits=int(first.bits),
                   group_size=int(first.group_size),
                   shape=tuple(int(v) for v in first.shape))


def _qtensor(leaf, device) -> QTensor:
    if getattr(leaf, "lut", None) is not None:
        raise NotImplementedError("codebook (lut) weights are not ported")
    if leaf.kshards != 1:
        raise NotImplementedError("kshards > 1 is not ported")
    return QTensor(codes=to_torch(leaf.codes, device),
                   scales=to_torch(leaf.scales, device), bits=int(leaf.bits),
                   group_size=int(leaf.group_size),
                   shape=tuple(int(v) for v in leaf.shape))


def params_from_flat(flat: dict, cfg: ModelConfig, device=None) -> LlamaParams:
    """Build :class:`LlamaParams` on ``device`` (the card unless "cpu")
    from a flat dict in checkpoint naming."""
    check_supported(cfg)
    dev = resolve_device(device)
    k0 = cfg.first_k_dense
    prefixes = ("layers", "layers0") if k0 else ("layers",)
    extra = sorted(k for k in flat if k.startswith("layers")
                   and (k.split(".")[0] not in prefixes
                        or k.split(".")[2] not in _LAYER_FIELDS))
    if extra:
        raise NotImplementedError(
            f"parameters outside the ported slices: {extra[:4]}")
    layers = _stack_from_flat(flat, cfg, "layers", cfg.n_layers - k0,
                              cfg.n_experts > 0, dev)
    layers0 = _stack_from_flat(flat, cfg, "layers0", k0, False,
                               dev) if k0 else None
    emb = flat["embed"]
    if hasattr(emb, "codes"):
        embed = QEmbed(codes=to_torch(emb.codes, dev),
                       scales=to_torch(emb.scales, dev))
    else:
        embed = to_torch(emb, dev)
    return LlamaParams(embed=embed, layers=layers,
                       final_norm=to_torch(flat["final_norm"], dev).to(
                           torch.float32),
                       lm_head=_qtensor(flat["lm_head"], dev),
                       layers0=layers0)


def _stack_from_flat(flat: dict, cfg: ModelConfig, prefix: str, n: int,
                     moe: bool, dev) -> LayerParams:
    """The ``[n, ...]`` stack of ``{prefix}.{i}.*`` leaves (experts
    ``[E, n, ...]``); fields absent from ``flat`` stay None, or take the
    JAX package's defaults for the norms and the bias."""
    def rows(field):
        return [flat[f"{prefix}.{i}.{field}"] for i in range(n)]

    def has(field):
        return f"{prefix}.0.{field}" in flat

    def expert_stack(field):
        """[E, n, ...] from the per-(layer, expert) leaves."""
        qt = _stack_q([flat[f"{prefix}.{i}.{field}.{e}"]
                       for e in range(cfg.n_experts) for i in range(n)], dev)
        return dataclasses.replace(
            qt, codes=qt.codes.reshape((cfg.n_experts, n)
                                       + tuple(qt.codes.shape[1:])),
            scales=qt.scales.reshape((cfg.n_experts, n)
                                     + tuple(qt.scales.shape[1:])))

    def dense_stack(field, default=None):
        if not has(field):
            return None if default is None else default.to(dev)
        t = torch.stack([to_torch(a, dev) for a in rows(field)])
        return t if field in _KEEP_DTYPE else t.to(torch.float32)

    d, hd = cfg.dim, cfg.head_dim
    qkv_n = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    lay = LayerParams(
        wqkv=None, wo=None, w_gate_up=None, w_down=None,
        attn_norm=dense_stack("attn_norm", torch.ones((n, d))),
        mlp_norm=dense_stack("mlp_norm", torch.ones((n, d))),
        qkv_bias=dense_stack("qkv_bias", torch.zeros((n, qkv_n))),
        q_norm=dense_stack("q_norm", torch.ones((n, hd))),
        k_norm=dense_stack("k_norm", torch.ones((n, hd))),
    )
    for f in _QTENSOR_FIELDS:
        if has(f):
            setattr(lay, f, _stack_q(rows(f), dev))
    for f in ("w_uk", "w_uv", "q_a_norm", "kv_a_norm", "router_bias",
              "post_attn_norm", "post_mlp_norm"):
        setattr(lay, f, dense_stack(f))
    if moe:
        lay.router = dense_stack("router")
        lay.we_gate_up = expert_stack("we_gate_up")
        lay.we_down = expert_stack("we_down")
    return lay


def flat_from_params(params: LlamaParams) -> dict:
    """The inverse: per-layer (and per-expert) slices in checkpoint naming
    and order (tensors), the ``layers`` stack before ``layers0``; absent
    (None) fields are left out."""
    out = {"embed": params.embed, "final_norm": params.final_norm,
           "lm_head": params.lm_head}
    for prefix, lay in (("layers", params.layers),
                        ("layers0", params.layers0)):
        if lay is None:
            continue
        for i in range(lay.attn_norm.shape[0]):
            for f in _LAYER_FIELDS:
                leaf = getattr(lay, f)
                if leaf is None:
                    continue
                if f in _EXPERT_FIELDS:
                    for e in range(leaf.codes.shape[0]):
                        out[f"{prefix}.{i}.{f}.{e}"] = dataclasses.replace(
                            leaf, codes=leaf.codes[e, i],
                            scales=leaf.scales[e, i])
                else:
                    out[f"{prefix}.{i}.{f}"] = (leaf.layer(i)
                                                if isinstance(leaf, QTensor)
                                                else leaf[i])
    return out
