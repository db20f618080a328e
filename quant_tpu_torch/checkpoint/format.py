"""Read and write the packed checkpoint format ``quant-tpu-ckpt-v2`` (tp=1).

The port of the JAX package's ``checkpoint/format.py``; the two packages
read each other's checkpoints::

    <dir>/manifest.json   format version, ModelConfig, tensor index
    <dir>/data.bin        concatenated blobs addressed by (offset, size)

Tensors are stored per layer (``layers.{i}.wqkv`` ...), a MoE model's
experts per layer and expert (``layers.{i}.we_gate_up.{e}``), a DeepSeek
model's dense-prefix stack as ``layers0.{i}.*`` after the MoE stack, with
the MLA fields (``w_q_b``, ``w_uk``, ``w_uv``, ``q_a_norm``, ``kv_a_norm``)
and the shared experts and selection bias (``ws_gate_up``, ``ws_down``,
``router_bias``) where the model has them. Quantized codes
(QTensor and QEmbed) are entropy-coded (canonical Huffman QREF frames);
scales and float arrays are raw bytes. The coder is the C++ oracle
(:mod:`quant_tpu_torch.core.oracle`) where it builds, else its Python
mirror (:mod:`quant_tpu_torch.core.entropy`): byte-exact either way
(:func:`coder` says which). A codebook weight's table (16 floats) is
inline in the manifest entry of its tensor (``"lut"``), as the JAX writer
puts it; ``load_checkpoint(lut_runtime=)`` picks how such weights run
(``"int8"``, the default, transcodes them to linear int8 at load).
:class:`CheckpointWriter` streams one tensor
at a time (the HF converter's path); the reader decodes blobs in a thread
pool. Checkpoints packed for tensor parallelism (tp>1, blobs split per
rank) and the older v1 format raise ``NotImplementedError`` in this port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from quant_tpu_torch.core import entropy, oracle
from quant_tpu_torch.core.qtensor import QTensor, transcode_lut_int8
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.models.llama import LlamaParams, QEmbed, check_supported
from quant_tpu_torch.models.transfer import flat_from_params, params_from_flat
from quant_tpu_torch.utils.device import resolve_device

FORMAT = "quant-tpu-ckpt-v2"
_FORMAT_V1 = "quant-tpu-ckpt-v1"

__all__ = ["FORMAT", "CheckpointWriter", "coder", "entropy_encode",
           "entropy_decode", "save_checkpoint", "load_checkpoint",
           "read_flat", "read_manifest"]


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


def coder() -> str:
    """The entropy coder this process uses: "c++" (the oracle library,
    :mod:`quant_tpu_torch.core.oracle`) when it builds and loads, else
    "python" (:mod:`quant_tpu_torch.core.entropy`). Both are byte-exact."""
    return "c++" if oracle.available() else "python"


def entropy_encode(data: np.ndarray) -> bytes:
    """QREF frame of a byte stream, by :func:`coder`'s coder."""
    if oracle.available():
        return oracle.entropy_encode(data)
    return entropy.encode(data)


def entropy_decode(comp: bytes) -> bytes:
    """The bytes of a QREF frame, by :func:`coder`'s coder."""
    if oracle.available():
        return oracle.entropy_decode(comp)
    return entropy.decode(comp)


# The tensor-parallel shard axis a manifest records for each quantized
# leaf, (codes axis, scales axis), as the JAX writer records it (at tp=1
# too): column tensors along N, row tensors along packed K and their scales
# along the groups when there are several; None for the other leaves.
_COL = {"wqkv", "w_gate_up", "we_gate_up", "ws_gate_up", "w_q_b",
        "lm_head"}
_ROW = {"wo", "w_down", "we_down", "ws_down"}


def _shard_axes(name: str, qt: QTensor) -> tuple[int | None, int | None]:
    parts = name.split(".")
    # experts are stored per (layer, expert): "layers.{i}.we_down.{e}"
    owner = parts[-2] if parts[-1].isdigit() and len(parts) > 1 else parts[-1]
    if owner in _COL:
        return 1, 1
    if owner in _ROW:
        return 0, (0 if qt.scales.shape[0] > 1 else None)
    return None, None


class CheckpointWriter:
    """Streaming checkpoint writer: :meth:`add` tensors one at a time, in
    any order, then :meth:`finish`. Each leaf's blobs go to ``data.bin`` as
    it is added, so at most one tensor (and its encoded payload) is held.
    Blobs split for tensor parallelism (``tp > 1``) are not ported."""

    def __init__(self, path, cfg: ModelConfig, tp: int = 1):
        if tp != 1:
            raise NotImplementedError(
                "checkpoints packed for tp>1 (blobs split per rank) are not "
                "ported")
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.tensors: dict = {}
        self._f = open(self.path / "data.bin", "wb")
        self._off = 0

    def _put(self, t, codec: str, axis: int | None = None) -> dict:
        raw = np.ascontiguousarray(_to_numpy(t))
        payload = (entropy_encode(raw.view(np.uint8).reshape(-1))
                   if codec == "qref-huffman" else raw.tobytes())
        blob = {"offset": self._off, "size": len(payload)}
        self._f.write(payload)
        self._off += len(payload)
        return {"codec": codec, "dtype": _dtype_name(t),
                "shape": list(raw.shape), "axis": axis, "shards": [blob]}

    def add(self, name: str, leaf) -> None:
        if isinstance(leaf, QEmbed):
            self.tensors[name] = {
                "kind": "qembed",
                "codes": self._put(leaf.codes, "qref-huffman"),
                "scales": self._put(leaf.scales, "raw"),
            }
        elif isinstance(leaf, QTensor):
            ca, sa = _shard_axes(name, leaf)
            self.tensors[name] = {
                "kind": "qtensor", "bits": leaf.bits,
                "group_size": leaf.group_size, "kshards": leaf.kshards,
                "shape": list(leaf.shape),
                "codes": self._put(leaf.codes, "qref-huffman", ca),
                "scales": self._put(leaf.scales, "raw", sa),
            }
            if leaf.lut is not None:
                # 16 floats inline; float32 -> JSON float64 round-trips
                self.tensors[name]["lut"] = _to_numpy(leaf.lut).astype(
                    np.float32).tolist()
        else:
            self.tensors[name] = {"kind": "array",
                                  "data": self._put(leaf, "raw")}

    def finish(self) -> dict:
        """Close ``data.bin`` and write ``manifest.json``; returns the
        manifest."""
        self._f.close()
        manifest = {"format": FORMAT, "config": dataclasses.asdict(self.cfg),
                    "tp": 1, "tensors": self.tensors}
        (self.path / "manifest.json").write_text(json.dumps(manifest,
                                                            indent=1))
        return manifest


def save_checkpoint(path, params: LlamaParams, cfg: ModelConfig) -> dict:
    """Write the packed checkpoint (tp=1) of in-memory params through
    :class:`CheckpointWriter`; returns the manifest."""
    w = CheckpointWriter(path, cfg)
    for name, leaf in flat_from_params(params).items():
        w.add(name, leaf)
    return w.finish()


def _read_leaf(fd: int, meta: dict) -> torch.Tensor:
    """One blob from ``data.bin`` (open as ``fd``), decoded, as a tensor.
    ``os.pread`` takes no file position, so threads read side by side."""
    if len(meta["shards"]) != 1:
        raise NotImplementedError("blobs split for tp>1 are not ported")
    blob = meta["shards"][0]
    payload = os.pread(fd, blob["size"], blob["offset"])
    if len(payload) != blob["size"]:
        raise ValueError(f"data.bin ends inside a blob at {blob['offset']}")
    if meta["codec"] == "qref-huffman":
        payload = entropy_decode(payload)
    dt = meta["dtype"]
    arr = np.frombuffer(payload, np.int16 if dt == "bfloat16" else
                        np.dtype(dt)).reshape(meta["shape"])
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dt == "bfloat16" else t


def read_manifest(path) -> tuple[dict, ModelConfig]:
    """(manifest, ModelConfig) of a packed checkpoint; raises on a format
    or packing the port does not read, before any blob is decoded."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["format"] == _FORMAT_V1:
        raise NotImplementedError("v1 checkpoints are not ported")
    if manifest["format"] != FORMAT:
        raise ValueError(f"unknown checkpoint format {manifest['format']}")
    if manifest.get("tp", 1) != 1:
        raise NotImplementedError("checkpoints packed for tp>1 are not "
                                  "ported")
    return manifest, ModelConfig(**manifest["config"])


def read_flat(path) -> tuple[dict, ModelConfig]:
    """(flat dict of host leaves in checkpoint naming, ModelConfig). The
    blobs decode in a pool of up to 8 threads, as the JAX loader's do: the
    C++ decoder releases the GIL."""
    path = pathlib.Path(path)
    manifest, cfg = read_manifest(path)
    fd = os.open(path / "data.bin", os.O_RDONLY)
    try:
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
                as ex:
            def get(meta):
                return ex.submit(_read_leaf, fd, meta)

            futs = {}
            for name, meta in manifest["tensors"].items():
                if meta["kind"] == "array":
                    futs[name] = get(meta["data"])
                else:
                    futs[name] = (get(meta["codes"]), get(meta["scales"]))
            flat = {}
            for name, meta in manifest["tensors"].items():
                if meta["kind"] == "array":
                    flat[name] = futs[name].result()
                    continue
                codes, scales = (f.result() for f in futs[name])
                if meta["kind"] == "qembed":
                    flat[name] = QEmbed(codes=codes, scales=scales)
                else:
                    lut = meta.get("lut")
                    flat[name] = QTensor(
                        codes=codes, scales=scales, bits=meta["bits"],
                        group_size=meta["group_size"],
                        shape=tuple(meta["shape"]), kshards=meta["kshards"],
                        lut=None if lut is None else torch.tensor(
                            lut, dtype=torch.float32))
    finally:
        os.close(fd)
    return flat, cfg


def _transcode_luts(flat: dict, cfg: ModelConfig) -> dict:
    """``lut_runtime="int8"`` (the default): every codebook QTensor becomes
    linear int8 once, here (:func:`transcode_lut_int8`), and runs on the
    int8 kernels; "word4" and "sel15" keep the tables for the matmul."""
    if cfg.lut_runtime != "int8":
        return flat
    return {k: transcode_lut_int8(v) if isinstance(v, QTensor) else v
            for k, v in flat.items()}


def load_checkpoint(path, device=None, lut_runtime: str | None = None
                    ) -> tuple[LlamaParams, ModelConfig]:
    """Read a packed checkpoint -> (LlamaParams on ``device``, ModelConfig).
    ``device`` is the card unless "cpu"; codes stay packed. A config the
    port does not serve raises before any blob is decoded. ``lut_runtime``
    overrides the manifest's codebook execution mode (``ModelConfig.
    lut_runtime``: "int8" transcode at load, "word4" or "sel15")."""
    device = resolve_device(device)
    cfg = read_manifest(path)[1]
    if lut_runtime is not None:
        cfg = dataclasses.replace(cfg, lut_runtime=lut_runtime)
    check_supported(cfg)
    flat, _ = read_flat(path)
    return params_from_flat(_transcode_luts(flat, cfg), cfg, device), cfg
