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

Codebook ("bin-lookup") weights (int4 only) carry ``lut``, a float32
``[16]`` table (``[L, 16]`` for a stack with one table per layer): the
nibble is the table index and the group scale is the absmax, so
``value = lut[code + 8] * scale``. :func:`transcode_lut_int8` turns such a
tensor into linear int8 once (``lut_runtime="int8"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quant_tpu_torch.core import codec

__all__ = ["QTensor", "quantize_tensor", "quantize_tensor_device",
           "resolve_codebook", "transcode_lut_int8"]


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
    # codebook table f32 [16], or [L, 16] per layer of a stack
    # (value = lut[code + 8] * scale); None = linear
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


def resolve_codebook(codebook, w=None) -> np.ndarray:
    """A codebook spec as its 16-entry float32 table: ``"nf4"`` the
    normative constants, ``"lloyd"`` a Lloyd-Max fit to ``w`` (one table
    per tensor, fitted on the host), an array used as it is (16 strictly
    ascending floats)."""
    if isinstance(codebook, str):
        if codebook == "nf4":
            return codec.NF4_TABLE
        if codebook == "lloyd":
            if w is None:
                raise ValueError("codebook='lloyd' needs the weight data")
            if isinstance(w, torch.Tensor):
                w = w.detach().to("cpu", torch.float32).numpy()
            return codec.lloyd_max_fit(np.asarray(w, np.float32))
        raise ValueError(f"unknown codebook {codebook!r}")
    lut = np.asarray(codebook, dtype=np.float32)
    if lut.shape != (16,) or not np.all(lut[:-1] < lut[1:]):
        raise ValueError("codebook must be 16 strictly-ascending floats")
    return lut


def _pack_host(codes: np.ndarray, k: int, kshards: int) -> np.ndarray:
    kb = k // kshards
    return np.concatenate(
        [codec.pack_int4_matmul(codes[s * kb:(s + 1) * kb])
         for s in range(kshards)], axis=0)


def quantize_tensor(w: np.ndarray, bits: int, group_size: int | None = None,
                    kshards: int = 1, codebook=None) -> QTensor:
    """Quantize a dense ``[K, N]`` weight on the host (numpy codec, bit-exact
    vs the C++ oracle). Returns a QTensor of CPU tensors. ``codebook``
    (int4 only): "nf4", "lloyd" or an explicit table (:func:`resolve_codebook`)
    gives codebook codes, absmax scales and the table as ``lut``."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"expected [K, N] weight, got shape {w.shape}")
    k, n = w.shape
    gs = _check_shape(k, group_size, bits, kshards)
    if codebook is not None:
        if bits != 4:
            raise ValueError("codebook mode is int4-only")
        lut = resolve_codebook(codebook, w)
        codes_nk, scales_ng = codec.quantize_lut(w.T, lut, group_size=gs)
        codes = _pack_host(np.ascontiguousarray(codes_nk.T), k, kshards)
        scales = np.ascontiguousarray(scales_ng.T).astype(np.float32)
        return QTensor(codes=torch.from_numpy(codes),
                       scales=torch.from_numpy(scales), bits=4,
                       group_size=gs, shape=(k, n), kshards=kshards,
                       lut=torch.from_numpy(lut.copy()))
    # the codec quantizes over the LAST axis: work in [N, K], transpose back
    codes_nk, scales_ng = codec.quantize(w.T, bits, group_size=gs)
    codes = np.ascontiguousarray(codes_nk.T)
    scales = np.ascontiguousarray(scales_ng.T).astype(np.float32)
    if bits == 4:
        codes = _pack_host(codes, k, kshards)
    return QTensor(codes=torch.from_numpy(codes),
                   scales=torch.from_numpy(scales), bits=bits,
                   group_size=gs, shape=(k, n), kshards=kshards)


def quantize_tensor_device(w: torch.Tensor, bits: int,
                           group_size: int | None = None, kshards: int = 1,
                           codebook=None) -> QTensor:
    """Quantize a dense ``[K, N]`` tensor where it lies (torch ops): the
    same codec as :func:`quantize_tensor` (symmetric absmax, round half to
    even), bit-identical codes and scales. ``codebook``: a fixed table
    ("nf4" or 16 floats): the code counts the table's float32 midpoints
    strictly below ``w / absmax``, as the host codec does; "lloyd" is
    host-only (its fit needs the data on the host: pass the fitted table)."""
    if w.dim() != 2:
        raise ValueError(f"expected [K, N] weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    gs = _check_shape(k, group_size, bits, kshards)
    g = w.to(torch.float32).reshape(k // gs, gs, n)
    absmax = g.abs().amax(dim=1)                                  # [G, N]
    lut = None
    if codebook is not None:
        if bits != 4:
            raise ValueError("codebook mode is int4-only")
        if isinstance(codebook, str) and codebook == "lloyd":
            raise ValueError("codebook='lloyd' is host-only (needs data)")
        table = resolve_codebook(codebook)
        scales = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax)
        mid = torch.from_numpy((table[:-1] + table[1:]) / np.float32(2.0)
                               ).to(w.device)
        xn = g / scales[:, None, :]
        codes = torch.zeros(xn.shape, dtype=torch.int8, device=w.device)
        for t in mid:           # 15 passes: no [K, N, 15] temporary
            codes += xn > t
        codes = (codes - 8).reshape(k, n)
        lut = torch.from_numpy(table.copy()).to(w.device)
        del xn
    else:
        qmax = float(codec.qmax_for_bits(bits))
        scales = torch.where(absmax == 0.0, torch.ones_like(absmax),
                             absmax / qmax)
        q = torch.round(g / scales[:, None, :])
        codes = q.clamp_(-qmax, qmax).to(torch.int8).reshape(k, n)
        del q
    del g
    if bits == 4:
        u = codes.to(torch.int16) + 8
        kb = k // kshards
        codes = torch.cat([
            u[s * kb: s * kb + kb // 2] | (u[s * kb + kb // 2:(s + 1) * kb]
                                           << 4)
            for s in range(kshards)], dim=0).to(torch.uint8)
    return QTensor(codes=codes, scales=scales, bits=bits, group_size=gs,
                   shape=(k, n), kshards=kshards, lut=lut)


_INV127 = np.float32(1 / 127.0)


def transcode_lut_int8(qt: QTensor) -> QTensor:
    """A codebook QTensor as a LINEAR int8 one, once (``lut_runtime="int8"``):
    each nibble becomes ``round(lut[idx] * 127)`` as int8 and each scale is
    multiplied by float32(1/127) (a multiply, as the JAX package's
    ``transcode_lut_int8``), so the linear dequant ``round(lut*127)[idx] *
    (scale * fl(1/127))`` is the word4 kernel's weight. A stacked tensor's
    ``[L, 16]`` tables index by layer. The codes come out in natural K order
    (kshards 1). Linear tensors come back unchanged."""
    if qt.lut is None or qt.bits != 4:
        return qt
    p = qt.codes
    lq = torch.round(qt.lut.to(torch.float32) * 127.0).to(torch.int8)
    lo, hi = (p & 0xF).long(), (p >> 4).long()
    if lq.dim() == 1:
        vlo, vhi = lq[lo], lq[hi]
    else:
        lead = lq.shape[:-1].numel()
        flat = lq.reshape(lead, 16)

        def pick(idx):
            return torch.gather(flat, 1, idx.reshape(lead, -1)).reshape(
                idx.shape)
        vlo, vhi = pick(lo), pick(hi)
    kb = p.shape[-2] // qt.kshards            # packed rows per shard block
    parts = []
    for s in range(qt.kshards):
        parts += [vlo[..., s * kb:(s + 1) * kb, :],
                  vhi[..., s * kb:(s + 1) * kb, :]]
    codes8 = torch.cat(parts, dim=-2).contiguous()
    scales8 = qt.scales.to(torch.float32) * torch.tensor(
        _INV127, device=qt.scales.device)
    return QTensor(codes=codes8, scales=scales8, bits=8,
                   group_size=qt.group_size, shape=qt.shape, kshards=1)
