"""Multi-LoRA serving: stacked low-rank adapters over the quantized base.

The port of the JAX package's ``models/lora.py``. An adapter adds
``y += (x @ A) @ B`` beside a frozen packed projection (the QTensors are
never touched), so one engine serves many fine-tunes: each request picks an
adapter and slots with different adapters decode in the same forward.

* **Stacked adapters.** All registered adapters stack along a leading axis
  (``a_*`` f32 ``[A, L, K, r]``, ``b_*`` f32 ``[A, L, r, N]``, index 0 the
  all-zero base), byte for byte the JAX package's arrays: the fused groups
  (q|k|v with a block-diagonal B, gate|up, o, down; for MLA the fused
  down-projection ``[q(-a) | kv_a]``), alpha/r folded into B, every group
  padded to its largest rank over adapters and layers. Rows are indexed by
  the model's GLOBAL layer, dense-prefix layers first.
* **One delta, two products.** :func:`lora_delta` computes the JAX
  package's masked sum over adapters (f32; id 0 contributes nothing; each
  adapter's weights are read once) as two matmuls over the adapters
  concatenated along r: ``x @ A_cat`` ``[B*T, n*r]``, times a per-slot 0/1
  mask (:class:`LoraBatch`, built once per forward from the adapter ids),
  then ``@ B_cat`` (``addmm`` into an f32 output). The exact zeros of the
  mask make this the JAX sum in another order, and the launches do not grow
  with the number of adapters. The stacks are kept in memory as ``[L, K,
  A, r]`` and ``[L, A, r, N]``, so ``A_cat`` and ``B_cat`` of a layer are
  views; ``a_*`` / ``b_*`` are views of them in the JAX index order.
* **MLA.** Adapters target the projections that keep their dense shape in
  the absorbed decode path: the fused down-projection's q(-a) / kv_a
  columns and o_proj; dense-prefix (``first_k_dense``) layers also take the
  MLP hooks. ``q_b`` / ``kv_b`` adapters are refused (kv_b folds into the
  per-head ``w_uk`` / ``w_uv``), and so are MLP adapters on MoE layers.

The products run as ``torch`` matmuls: the JAX package computes them in
XLA, outside any Pallas kernel. Tensor parallelism (``tp > 1``) is not
ported.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from quant_tpu_torch.utils.device import resolve_device

__all__ = ["LoraStack", "LoraBatch", "make_lora_stack", "stack_from_arrays",
           "lora_delta", "load_hf_adapter"]

# projections an adapter may target, in the fused grouping
_QKV = ("wq", "wk", "wv")
_GU = ("w_gate", "w_up")
GROUPS = ("qkv", "o", "gu", "down")


@dataclasses.dataclass(frozen=True)
class LoraStack:
    """Stacked adapters, f32: ``a_*`` ``[A, L, K, r]``, ``b_*`` ``[A, L, r,
    N]`` (fused layouts for qkv and gate|up), index 0 the all-zero base.
    Each leaf is a view of a layer-major tensor (see the module
    docstring)."""
    a_qkv: torch.Tensor
    b_qkv: torch.Tensor
    a_o: torch.Tensor
    b_o: torch.Tensor
    a_gu: torch.Tensor
    b_gu: torch.Tensor
    a_down: torch.Tensor
    b_down: torch.Tensor

    @property
    def n_adapters(self) -> int:
        return self.a_qkv.shape[0]


def _groups(cfg) -> dict:
    """group -> (projections, K, output widths), as the JAX package's
    ``make_lora_stack`` lays them out."""
    d, hd, it = cfg.dim, cfg.head_dim, cfg.intermediate
    if cfg.n_experts:
        # the only dense MLP of a MoE model is the first_k_dense prefix
        it = cfg.dense_intermediate or cfg.intermediate
    if cfg.is_mla:
        r_lat, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        qw = cfg.q_lora_rank or cfg.n_heads * (cfg.qk_nope_head_dim + dr)
        return {"qkv": (("wq", "wkv_a"), d, (qw, r_lat + dr)),
                "o": (("wo",), cfg.n_heads * cfg.v_head_dim, (d,)),
                "gu": (_GU, d, (it, it)),
                "down": (("w_down",), it, (d,))}
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return {"qkv": (_QKV, d, (nq, nkv, nkv)),
            "o": (("wo",), nq, (d,)),
            "gu": (_GU, d, (it, it)),
            "down": (("w_down",), it, (d,))}


def _check(adapters: list[dict], cfg) -> None:
    """The JAX package's refusals, with its messages."""
    mlp_projs = ("w_gate", "w_up", "w_down")
    if cfg.n_experts:
        k0 = cfg.first_k_dense or 0
        bad = [k for ad in adapters for k in ad
               if any(f".{p}." in k for p in mlp_projs)
               and int(k.split(".")[1]) >= k0]
        if bad:
            raise ValueError(
                "LoRA on MoE-layer MLP projections is not supported — "
                "attention projections (and dense-prefix-layer MLPs) "
                f"only (got {bad[:3]})")
    if cfg.is_mla:
        bad = [k for ad in adapters for k in ad
               if ".wq_b." in k or ".wkv_b." in k]
        if bad:
            raise ValueError(
                "LoRA on q_b_proj/kv_b_proj is not supported: the MLA "
                "decode path runs the absorbed form (kv_b folds into "
                "w_uk/w_uv). Target q(_a)_proj, kv_a_proj_with_mqa "
                f"and o_proj instead (got {bad[:3]})")


def _adapter_group(ad: dict, projs, k_in: int, widths, i: int):
    """(A [k_in, r_tot], B [r_tot, sum(widths)] block-diagonal) of one
    adapter's group at layer ``i``, alpha/r folded into B; a missing
    projection contributes a rank-1 zero block."""
    alpha = float(ad.get("alpha", 1.0))
    a_parts, b_parts = [], []
    for p, w in zip(projs, widths):
        a = ad.get(f"layers.{i}.{p}.a")
        b = ad.get(f"layers.{i}.{p}.b")
        if a is None or b is None:
            a = np.zeros((k_in, 1), np.float32)
            b = np.zeros((1, w), np.float32)
        else:
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32) * (alpha / a.shape[1])
            if a.shape != (k_in, b.shape[0]) or b.shape[1] != w:
                raise ValueError(
                    f"layers.{i}.{p}: A{a.shape}/B{b.shape} don't "
                    f"match [{k_in}, r] x [r, {w}]")
        a_parts.append(a)
        b_parts.append(b)
    r_tot = sum(b.shape[0] for b in b_parts)
    blocks, row0 = [], 0
    for b in b_parts:
        full = np.zeros((r_tot, b.shape[1]), np.float32)
        full[row0:row0 + b.shape[0]] = b
        blocks.append(full)
        row0 += b.shape[0]
    # the tp=1 column order of the fused weights: the parts side by side
    return np.concatenate(a_parts, axis=1), np.concatenate(blocks, axis=1)


def make_lora_stack(adapters: list[dict], cfg, tp: int = 1,
                    device=None) -> LoraStack:
    """The stacked :class:`LoraStack` of per-adapter dicts on ``device``
    (the card unless "cpu").

    Each adapter: ``{"alpha": float, "layers.<i>.<proj>.a": [K, r],
    "layers.<i>.<proj>.b": [r, N], ...}``, ``i`` the global layer, proj in
    wq / wk / wv / wo / w_gate / w_up / w_down, or for an MLA model wq (the
    q or q_a projection), wkv_a (kv_a_proj_with_mqa), wo and the
    dense-prefix MLP. Missing projections contribute zeros; ranks may differ
    per projection, adapter and layer (each group pads to its maximum). A
    leading all-zero base adapter (id 0) is prepended."""
    if tp != 1:
        raise NotImplementedError(
            "LoRA under tensor parallelism (tp > 1) is not ported: the port "
            "has only the tp=1 column order of the fused weights (ROADMAP.md "
            "queue 1 #8)")
    _check(adapters, cfg)
    groups = _groups(cfg)
    r_max = {g: 1 for g in groups}
    per_adapter = []
    for ad in adapters:
        layers = {}
        for g, (projs, k_in, widths) in groups.items():
            ab = [_adapter_group(ad, projs, k_in, widths, i)
                  for i in range(cfg.n_layers)]
            layers[g] = ab
            # the maximum over every layer: PEFT layers_to_transform and
            # rank_pattern adapters vary the rank (or presence) by layer
            r_max[g] = max(r_max[g], max(a.shape[1] for a, _ in ab))
        per_adapter.append(layers)
    arrays = {}
    for g, (projs, k_in, widths) in groups.items():
        r, n_cols = r_max[g], sum(widths)
        stacks_a = [np.zeros((cfg.n_layers, k_in, r), np.float32)]
        stacks_b = [np.zeros((cfg.n_layers, r, n_cols), np.float32)]
        for layers in per_adapter:
            stacks_a.append(np.stack([np.pad(a, ((0, 0), (0, r - a.shape[1])))
                                      for a, _ in layers[g]]))
            stacks_b.append(np.stack([np.pad(b, ((0, r - b.shape[0]), (0, 0)))
                                      for _, b in layers[g]]))
        arrays[f"a_{g}"] = np.stack(stacks_a)
        arrays[f"b_{g}"] = np.stack(stacks_b)
    return stack_from_arrays(arrays, device)


def stack_from_arrays(arrays: dict, device=None) -> LoraStack:
    """A :class:`LoraStack` on ``device`` from ``{"a_qkv": [A, L, K, r],
    "b_qkv": [A, L, r, N], ...}`` (numpy or tensors), held layer-major."""
    dev = resolve_device(device)
    leaves = {}
    for g in GROUPS:
        a = torch.as_tensor(np.array(arrays[f"a_{g}"], np.float32))
        b = torch.as_tensor(np.array(arrays[f"b_{g}"], np.float32))
        # [A, L, K, r] held as [L, K, A, r]; [A, L, r, N] as [L, A, r, N]
        leaves[f"a_{g}"] = a.permute(1, 2, 0, 3).contiguous().to(
            dev).permute(2, 0, 1, 3)
        leaves[f"b_{g}"] = b.permute(1, 0, 2, 3).contiguous().to(
            dev).permute(1, 0, 2, 3)
    return LoraStack(**leaves)


def _hot(adapter_ids: torch.Tensor, n: int) -> torch.Tensor:
    """f32 ``[B, n]``: 1 where a slot's id is j + 1 (id 0, the base,
    selects nothing)."""
    ids = adapter_ids.to(torch.int64)
    return (ids[:, None] == torch.arange(1, n + 1, device=ids.device)).to(
        torch.float32)


def _expand(hot: torch.Tensor, r: int) -> torch.Tensor:
    """The ``[B, n]`` selection repeated over each adapter's r columns of
    ``x @ A_cat``: ``[B, n*r]``."""
    b, n = hot.shape
    return hot[:, :, None].expand(b, n, r).reshape(b, n * r)


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, idx: int,
               adapter_ids: torch.Tensor | None = None, *,
               mask: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The masked multi-adapter delta of layer ``idx``, f32 ``[B, T, N]``.

    ``x`` ``[B, T, K]``; ``a`` ``[A, L, K, r]``; ``b`` ``[A, L, r, N]``;
    ``adapter_ids`` ``[B]`` (0 = base, contributes nothing), or the
    group's ``mask`` ``[B, (A-1)*r]`` built once per forward
    (:class:`LoraBatch`). Two products over the adapters concatenated along
    r, whatever the number of adapters. ``out`` (f32 ``[B, T, N]``) returns
    ``out`` plus the delta through one ``addmm``."""
    n = a.shape[0] - 1
    k, r, n_out = a.shape[2], a.shape[3], b.shape[-1]
    if mask is None:
        mask = _expand(_hot(adapter_ids, n), r)
    a_cat = a[1:, idx].transpose(0, 1).reshape(k, n * r)
    b_cat = b[1:, idx].reshape(n * r, n_out)
    lead = x.shape[:-1]
    u = x.reshape(-1, k).to(torch.float32) @ a_cat          # [B*T, n*r]
    u = (u.view(lead[0], -1, n * r) * mask[:, None]).view(-1, n * r)
    if out is None:
        return (u @ b_cat).view(*lead, n_out)
    return torch.addmm(out.reshape(-1, n_out), u, b_cat).view(*lead, n_out)


@dataclasses.dataclass(frozen=True)
class LoraBatch:
    """The adapters of one forward: the stack and the slots' masks, one
    per group rank, built once from the adapter ids."""
    stack: LoraStack
    masks: dict

    @classmethod
    def of(cls, stack: LoraStack, adapter_ids) -> "LoraBatch":
        ids = torch.as_tensor(adapter_ids, device=stack.a_qkv.device)
        hot = _hot(ids, stack.n_adapters - 1)
        ranks = {getattr(stack, f"a_{g}").shape[3] for g in GROUPS}
        return cls(stack, {r: _expand(hot, r) for r in ranks})

    def delta(self, group: str, x: torch.Tensor, gi: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
        """The ``group`` delta of global layer ``gi`` (see
        :func:`lora_delta`)."""
        a = getattr(self.stack, f"a_{group}")
        return lora_delta(x, a, getattr(self.stack, f"b_{group}"), gi,
                          mask=self.masks[a.shape[3]], out=out)


_HF_PROJ = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
    # DeepSeek MLA names: q(-a) and the shared latent projection map to the
    # fused wqkv slots; q_b / kv_b pass through so make_lora_stack refuses
    # them by name (absorbed projections)
    "q_a_proj": "wq", "kv_a_proj_with_mqa": "wkv_a",
    "q_b_proj": "wq_b", "kv_b_proj": "wkv_b",
}


def load_hf_adapter(path) -> dict:
    """A Hugging Face PEFT LoRA directory (``adapter_config.json`` and
    ``*.safetensors``) in the :func:`make_lora_stack` dict format, read with
    the port's own safetensors reader. PEFT stores lora_A as ``[r, K]`` and
    lora_B as ``[N, r]``: transposed here to ``[K, r]`` / ``[r, N]``, f32
    numpy."""
    # imported here: the checkpoint package imports the model module
    from quant_tpu_torch.checkpoint.safetensors import SafetensorsDir

    path = pathlib.Path(path)
    hf_cfg = json.loads((path / "adapter_config.json").read_text())
    out: dict = {"alpha": float(hf_cfg.get("lora_alpha", 1.0))}
    st = SafetensorsDir(path)
    try:
        for key in st.keys():
            parts = key.split(".")
            if "lora_A" in parts:
                kind, tpos = "a", parts.index("lora_A")
            elif "lora_B" in parts:
                kind, tpos = "b", parts.index("lora_B")
            else:
                continue
            proj = _HF_PROJ.get(parts[tpos - 1])
            li = next((p for p in parts if p.isdigit()), None)
            if proj is None or li is None:
                continue
            t = st.get(key).to(torch.float32).numpy()
            out[f"layers.{li}.{proj}.{kind}"] = np.ascontiguousarray(t.T)
    finally:
        st.close()
    return out
