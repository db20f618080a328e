"""Turn a flat dict of parameters into the port's :class:`LlamaParams`.

The input uses the checkpoint naming of the JAX package's
``checkpoint/format.py`` ``_flatten_params``: ``"embed"``, ``"final_norm"``,
``"lm_head"``, ``"layers.{i}.{field}"`` and, for a MoE model's experts,
``"layers.{i}.we_gate_up.{e}"`` / ``"layers.{i}.we_down.{e}"``. Leaves are numpy arrays, or
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
                 "we_gate_up", "we_down")
_EXPERT_FIELDS = ("we_gate_up", "we_down")


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
    codes = torch.stack([to_torch(q.codes) for q in leaves]).to(device)
    scales = torch.stack([to_torch(q.scales) for q in leaves]).to(device)
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
    n = cfg.n_layers
    extra = sorted(k for k in flat if k.startswith("layers0.")
                   or (k.startswith("layers.")
                       and k.split(".")[2] not in _LAYER_FIELDS))
    if extra:
        raise NotImplementedError(
            f"parameters outside the ported slices: {extra[:4]}")

    def rows(field):
        return [flat[f"layers.{i}.{field}"] for i in range(n)]

    def expert_stack(field):
        """[E, L, ...] from the per-(layer, expert) leaves."""
        qt = _stack_q([flat[f"layers.{i}.{field}.{e}"]
                       for e in range(cfg.n_experts) for i in range(n)], dev)
        return dataclasses.replace(
            qt, codes=qt.codes.reshape((cfg.n_experts, n)
                                       + tuple(qt.codes.shape[1:])),
            scales=qt.scales.reshape((cfg.n_experts, n)
                                     + tuple(qt.scales.shape[1:])))

    def dense_stack(field, default):
        if f"layers.0.{field}" not in flat:
            return default.to(dev)
        return torch.stack([to_torch(a) for a in rows(field)]).to(
            dev, torch.float32)

    d, hd = cfg.dim, cfg.head_dim
    qkv_n = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    moe = cfg.n_experts > 0
    layers = LayerParams(
        wqkv=_stack_q(rows("wqkv"), dev),
        wo=_stack_q(rows("wo"), dev),
        w_gate_up=None if moe else _stack_q(rows("w_gate_up"), dev),
        w_down=None if moe else _stack_q(rows("w_down"), dev),
        attn_norm=dense_stack("attn_norm", torch.ones((n, d))),
        mlp_norm=dense_stack("mlp_norm", torch.ones((n, d))),
        qkv_bias=dense_stack("qkv_bias", torch.zeros((n, qkv_n))),
        q_norm=dense_stack("q_norm", torch.ones((n, hd))),
        k_norm=dense_stack("k_norm", torch.ones((n, hd))),
    )
    if moe:
        layers.router = torch.stack(
            [to_torch(a) for a in rows("router")]).to(dev, torch.float32)
        layers.we_gate_up = expert_stack("we_gate_up")
        layers.we_down = expert_stack("we_down")
    emb = flat["embed"]
    if hasattr(emb, "codes"):
        embed = QEmbed(codes=to_torch(emb.codes, dev),
                       scales=to_torch(emb.scales, dev))
    else:
        embed = to_torch(emb, dev)
    return LlamaParams(embed=embed, layers=layers,
                       final_norm=to_torch(flat["final_norm"], dev).to(
                           torch.float32),
                       lm_head=_qtensor(flat["lm_head"], dev))


def flat_from_params(params: LlamaParams) -> dict:
    """The inverse: per-layer (and per-expert) slices in checkpoint naming
    and order (tensors); absent (None) fields are left out."""
    out = {"embed": params.embed, "final_norm": params.final_norm,
           "lm_head": params.lm_head}
    lay = params.layers
    for i in range(lay.attn_norm.shape[0]):
        for f in _LAYER_FIELDS:
            leaf = getattr(lay, f)
            if leaf is None:
                continue
            if f in _EXPERT_FIELDS:
                for e in range(leaf.codes.shape[0]):
                    out[f"layers.{i}.{f}.{e}"] = dataclasses.replace(
                        leaf, codes=leaf.codes[e, i],
                        scales=leaf.scales[e, i])
            else:
                out[f"layers.{i}.{f}"] = (leaf.layer(i)
                                          if isinstance(leaf, QTensor)
                                          else leaf[i])
    return out
