"""Read and write the packed checkpoint format ``quant-tpu-ckpt-v2`` (tp=1).

The port of the JAX package's ``checkpoint/format.py``; the two packages
read each other's checkpoints::

    <dir>/manifest.json   format version, ModelConfig, tensor index
    <dir>/data.bin        concatenated blobs addressed by (offset, size)

Tensors are stored per layer (``layers.{i}.wqkv`` ...), a MoE model's
experts per layer and expert (``layers.{i}.we_gate_up.{e}``). Quantized codes
(QTensor and QEmbed) are entropy-coded (canonical Huffman QREF frames,
:mod:`quant_tpu_torch.core.entropy`); scales and float arrays are raw bytes.
Checkpoints packed for tensor parallelism (tp>1, blobs split per rank) and
the older v1 format raise ``NotImplementedError`` in this port.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from quant_tpu_torch.core import entropy
from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.models.llama import LlamaParams, QEmbed, check_supported
from quant_tpu_torch.models.transfer import flat_from_params, params_from_flat
from quant_tpu_torch.utils.device import resolve_device

FORMAT = "quant-tpu-ckpt-v2"
_FORMAT_V1 = "quant-tpu-ckpt-v1"

__all__ = ["FORMAT", "save_checkpoint", "load_checkpoint", "read_flat"]


def _to_numpy(t) -> np.ndarray:
    """Tensor -> numpy; bfloat16 travels as its raw 16-bit words."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(_to_numpy(t).dtype)


class _Writer:
    """Appends blobs to an open ``data.bin`` and indexes them."""

    def __init__(self, f):
        self.tensors: dict = {}
        self._f = f
        self._off = 0

    def _put(self, t, codec: str) -> dict:
        raw = np.ascontiguousarray(_to_numpy(t))
        payload = (entropy.encode(raw.view(np.uint8).reshape(-1))
                   if codec == "qref-huffman" else raw.tobytes())
        blob = {"offset": self._off, "size": len(payload)}
        self._f.write(payload)
        self._off += len(payload)
        return {"codec": codec, "dtype": _dtype_name(t),
                "shape": list(raw.shape), "axis": None, "shards": [blob]}

    def add(self, name: str, leaf) -> None:
        if isinstance(leaf, QEmbed):
            self.tensors[name] = {
                "kind": "qembed",
                "codes": self._put(leaf.codes, "qref-huffman"),
                "scales": self._put(leaf.scales, "raw"),
            }
        elif isinstance(leaf, QTensor):
            if leaf.lut is not None:
                raise NotImplementedError("codebook (lut) weights are not "
                                          "ported")
            self.tensors[name] = {
                "kind": "qtensor", "bits": leaf.bits,
                "group_size": leaf.group_size, "kshards": leaf.kshards,
                "shape": list(leaf.shape),
                "codes": self._put(leaf.codes, "qref-huffman"),
                "scales": self._put(leaf.scales, "raw"),
            }
        else:
            self.tensors[name] = {"kind": "array",
                                  "data": self._put(leaf, "raw")}


def save_checkpoint(path, params: LlamaParams, cfg: ModelConfig) -> dict:
    """Write the packed checkpoint (tp=1) of in-memory params; returns the
    manifest."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "data.bin", "wb") as f:
        w = _Writer(f)
        for name, leaf in flat_from_params(params).items():
            w.add(name, leaf)
    manifest = {"format": FORMAT, "config": dataclasses.asdict(cfg),
                "tp": 1, "tensors": w.tensors}
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


def _read_array(f, meta: dict) -> np.ndarray:
    if len(meta["shards"]) != 1:
        raise NotImplementedError("blobs split for tp>1 are not ported")
    blob = meta["shards"][0]
    f.seek(blob["offset"])
    payload = f.read(blob["size"])
    if meta["codec"] == "qref-huffman":
        payload = entropy.decode(payload)
    dt = meta["dtype"]
    arr = np.frombuffer(payload, np.int16 if dt == "bfloat16" else
                        np.dtype(dt)).reshape(meta["shape"])
    return arr


def _np_to_leaf(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def read_flat(path) -> tuple[dict, ModelConfig]:
    """(flat dict of host leaves in checkpoint naming, ModelConfig)."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["format"] == _FORMAT_V1:
        raise NotImplementedError("v1 checkpoints are not ported")
    if manifest["format"] != FORMAT:
        raise ValueError(f"unknown checkpoint format {manifest['format']}")
    if manifest.get("tp", 1) != 1:
        raise NotImplementedError("checkpoints packed for tp>1 are not "
                                  "ported")
    cfg = ModelConfig(**manifest["config"])
    flat = {}
    with open(path / "data.bin", "rb") as f:
        def get(meta):
            return _np_to_leaf(_read_array(f, meta), meta["dtype"])

        for name, meta in manifest["tensors"].items():
            if meta["kind"] == "qembed":
                flat[name] = QEmbed(codes=get(meta["codes"]),
                                    scales=get(meta["scales"]))
            elif meta["kind"] == "qtensor":
                if "lut" in meta:
                    raise NotImplementedError("codebook (lut) weights are "
                                              "not ported")
                flat[name] = QTensor(
                    codes=get(meta["codes"]), scales=get(meta["scales"]),
                    bits=meta["bits"], group_size=meta["group_size"],
                    shape=tuple(meta["shape"]), kshards=meta["kshards"])
            else:
                flat[name] = get(meta["data"])
    return flat, cfg


def load_checkpoint(path, device=None) -> tuple[LlamaParams, ModelConfig]:
    """Read a packed checkpoint -> (LlamaParams on ``device``, ModelConfig).
    ``device`` is the card unless "cpu"; codes stay packed."""
    device = resolve_device(device)
    flat, cfg = read_flat(path)
    check_supported(cfg)
    return params_from_flat(flat, cfg, device), cfg
