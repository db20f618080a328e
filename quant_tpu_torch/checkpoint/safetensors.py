"""Lazy reader of a directory of ``*.safetensors`` files (no package needed).

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(offsets relative to the end of the header; an optional ``__metadata__``
entry), then the tensors' raw little-endian bytes. Each tensor is mapped
with ``mmap`` one tensor at a time, when asked for, and unmapped once the
tensor is copied out, so a converter holds about one tensor at a time
whatever the model's size.

Replaces the JAX package's ``_HFReader`` (``checkpoint/hf.py``), which needs
the ``safetensors`` package; this one needs only ``torch``. ``get`` returns
the stored dtype as a CPU tensor (BF16, which numpy lacks, included).
"""

from __future__ import annotations

import json
import mmap
import pathlib
import struct

import torch

__all__ = ["SafetensorsDir"]

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _read_header(path) -> tuple[dict, int]:
    """(tensor index without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsDir:
    """Every tensor of the ``*.safetensors`` files under ``model_dir``,
    by name. ``name in d`` tests presence; ``d.get(name)`` reads one."""

    def __init__(self, model_dir):
        files = sorted(pathlib.Path(model_dir).glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors under {model_dir}")
        self._files = []
        self._index: dict[str, tuple[int, dict, int]] = {}
        for path in files:
            header, base = _read_header(path)
            self._files.append(open(path, "rb"))
            for name, meta in header.items():
                if meta["dtype"] not in _DTYPES:
                    raise NotImplementedError(
                        f"{path.name}: {name} has dtype {meta['dtype']}")
                self._index[name] = (len(self._files) - 1, meta, base)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def keys(self):
        return self._index.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the CPU in its stored dtype: a copy out
        of a map of its own bytes, unmapped at once (dropping the pages
        from the process: ``madvise`` does not on every kernel)."""
        i, meta, base = self._index[name]
        begin, end = meta["data_offsets"]
        dt = _DTYPES[meta["dtype"]]
        shape = tuple(meta["shape"])
        if end == begin:
            return torch.empty(shape, dtype=dt)
        lo = (base + begin) // mmap.ALLOCATIONGRANULARITY * \
            mmap.ALLOCATIONGRANULARITY
        # a private copy-on-write map: torch wants a writable buffer;
        # nothing is written back to the file
        with mmap.mmap(self._files[i].fileno(), base + end - lo, offset=lo,
                       access=mmap.ACCESS_COPY) as m:
            flat = torch.frombuffer(m, dtype=dt,
                                    count=(end - begin) // dt.itemsize,
                                    offset=base + begin - lo)
            out = flat.reshape(shape).clone()
            del flat        # release the buffer before the map closes
        return out

    def close(self) -> None:
        for f in self._files:
            f.close()
        self._files = []
