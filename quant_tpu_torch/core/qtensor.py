"""QTensor — the packed quantized weight used across the port.

Same fields and layouts as the JAX package's ``core/qtensor.py`` so the
tests compare like with like. A linear layer ``y = x @ W`` with
``x: [..., K]`` stores ``W`` of logical shape ``[K, N]``:

* INT8: ``codes`` int8 ``[K, N]``.
* INT4: ``codes`` uint8 ``[K//2, N]`` in the split-K layout
  (:func:`quant_tpu_torch.core.codec.pack_int4_matmul`): byte[i, n] holds
  code (i, n) in the low nibble and (i + K/2, n) in the high nibble,
  biased by +8.

``scales`` is float32 ``[G, N]`` with ``G = K // group_size``. Stacked
layers carry a leading ``[L, ...]`` axis on ``codes`` and ``scales``;
:meth:`QTensor.layer` returns one layer as a view (no copy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quant_tpu_torch.core import codec

__all__ = ["QTensor", "quantize_tensor", "quantize_tensor_device"]


@dataclasses.dataclass(frozen=True)
class QTensor:
    codes: torch.Tensor   # int8 [(L,) K, N] | uint8 [(L,) K//2, N]
    scales: torch.Tensor  # f32 [(L,) G, N]
    bits: int
    group_size: int
    shape: tuple[int, int]
    # int4 nibble pairing happens within ``kshards`` K-blocks (tensor
    # parallel row shards); 1 = plain split-K over the whole K.
    kshards: int = 1
    # codebook table f32 [16] (value = lut[code + 8] * scale); None = linear
    lut: torch.Tensor | None = None

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def num_groups(self) -> int:
        return self.shape[0] // self.group_size

    @property
    def stacked(self) -> bool:
        return self.codes.dim() == 3

    def layer(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked QTensor: contiguous views of the stack."""
        if not self.stacked:
            raise ValueError("layer() needs a stacked [L, ...] QTensor")
        lut = self.lut
        if lut is not None and lut.dim() == 2:
            lut = lut[i]
        return dataclasses.replace(self, codes=self.codes[i],
                                   scales=self.scales[i], lut=lut)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Reference dequantization to a dense ``[K, N]`` tensor."""
        k, n = self.shape
        if self.bits == 4:
            p = self.codes
            lo = (p & 0xF).to(torch.int8) - 8
            hi = (p >> 4).to(torch.int8) - 8
            kb = k // self.kshards // 2      # packed rows per shard block
            parts = [x for s in range(self.kshards)
                     for x in (lo[s * kb:(s + 1) * kb],
                               hi[s * kb:(s + 1) * kb])]
            c = torch.cat(parts, dim=0)
        else:
            c = self.codes
        if self.lut is not None:
            cf = self.lut.to(torch.float32)[c.to(torch.int64) + 8]
        else:
            cf = c.to(torch.float32)
        g = cf.reshape(self.num_groups, self.group_size, n)
        w = g * self.scales[:, None, :]
        return w.reshape(k, n).to(dtype)

    def local_view(self) -> "QTensor":
        """Rebuild the metadata from the array shapes (a shard-local view
        has kshards 1 and its own group size)."""
        n = self.codes.shape[-1]
        k = self.codes.shape[-2] * (2 if self.bits == 4 else 1)
        if (k, n) == self.shape:
            return self
        gs = k // self.scales.shape[-2]
        return QTensor(codes=self.codes, scales=self.scales, bits=self.bits,
                       group_size=gs, shape=(k, n), kshards=1, lut=self.lut)


def _check_shape(k: int, group_size: int | None, bits: int,
                 kshards: int) -> int:
    gs = k if group_size is None else group_size
    if k % gs != 0:
        raise ValueError(f"group_size {gs} must divide K={k}")
    if bits == 4 and k % (2 * kshards):
        raise ValueError("int4 requires even K per shard block")
    return gs


def quantize_tensor(w: np.ndarray, bits: int, group_size: int | None = None,
                    kshards: int = 1, codebook=None) -> QTensor:
    """Quantize a dense ``[K, N]`` weight on the host (numpy codec, bit-exact
    vs the C++ oracle). Returns a QTensor of CPU tensors."""
    if codebook is not None:
        raise NotImplementedError("codebook quantization is not ported yet")
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"expected [K, N] weight, got shape {w.shape}")
    k, n = w.shape
    gs = _check_shape(k, group_size, bits, kshards)
    # the codec quantizes over the LAST axis: work in [N, K], transpose back
    codes_nk, scales_ng = codec.quantize(w.T, bits, group_size=gs)
    codes = np.ascontiguousarray(codes_nk.T)
    scales = np.ascontiguousarray(scales_ng.T).astype(np.float32)
    if bits == 4:
        kb = k // kshards
        codes = np.concatenate(
            [codec.pack_int4_matmul(codes[s * kb:(s + 1) * kb])
             for s in range(kshards)], axis=0)
    return QTensor(codes=torch.from_numpy(codes),
                   scales=torch.from_numpy(scales), bits=bits,
                   group_size=gs, shape=(k, n), kshards=kshards)


def quantize_tensor_device(w: torch.Tensor, bits: int,
                           group_size: int | None = None, kshards: int = 1,
                           codebook=None) -> QTensor:
    """Quantize a dense ``[K, N]`` tensor where it lies (torch ops): the
    same codec as :func:`quantize_tensor` (symmetric absmax, round half to
    even), bit-identical codes and scales."""
    if codebook is not None:
        raise NotImplementedError("codebook quantization is not ported yet")
    if w.dim() != 2:
        raise ValueError(f"expected [K, N] weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    gs = _check_shape(k, group_size, bits, kshards)
    g = w.to(torch.float32).reshape(k // gs, gs, n)
    absmax = g.abs().amax(dim=1)                                  # [G, N]
    qmax = float(codec.qmax_for_bits(bits))
    scales = torch.where(absmax == 0.0, torch.ones_like(absmax),
                         absmax / qmax)
    q = torch.round(g / scales[:, None, :])
    codes = q.clamp_(-qmax, qmax).to(torch.int8).reshape(k, n)
    del g, q
    if bits == 4:
        u = codes.to(torch.int16) + 8
        kb = k // kshards
        codes = torch.cat([
            u[s * kb: s * kb + kb // 2] | (u[s * kb + kb // 2:(s + 1) * kb]
                                           << 4)
            for s in range(kshards)], dim=0).to(torch.uint8)
    return QTensor(codes=codes, scales=scales, bits=bits, group_size=gs,
                   shape=(k, n), kshards=kshards)
