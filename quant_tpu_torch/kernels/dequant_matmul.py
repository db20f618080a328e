"""Fused dequantize + matmul: ``y = x @ dequantize(W)`` for a QTensor ``W``.

The port of the JAX package's ``kernels/dequant_matmul.py``
(``dequant_matmul`` and ``dequant_matmul_moe``). The codes stay packed in
device memory (int4: half a byte per weight) and are unpacked and scaled
inside the CUDA kernels of ``csrc/dequant_matmul.cu``, whose header note
gives their design.

Each call runs one of three tiles, chosen here from x's dtype, M and the
shape (:func:`_tile`) and counted under its name beside the kernel's total
(``dequant_matmul[tc_decode]``, ``[tc_prefill]``, ``[cuda_core]``): the
tensor-core tiles take bf16 x (decode at M <= 16, prefill above), the
CUDA-core tile f32 x and the bf16 shapes the tensor-core tiles do not take.

:func:`dequant_matmul` and :func:`dequant_matmul_moe` launch those kernels
for tensors on the card and take their plain versions
(:func:`dequant_matmul_reference`, :func:`dequant_matmul_moe_reference`)
only for tensors on the CPU: on a CUDA tensor they launch or raise, they
never fall back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.kernels import _build

__all__ = ["dequant_matmul", "dequant_matmul_reference", "dequant_matmul_moe",
           "dequant_matmul_moe_reference"]

# csrc/dequant_matmul.cu: the CUDA-core tile's columns per block and packed
# rows per staged tile (cc::BN, cc::BKP); the decode tile's packed rows per
# stage, columns per block and largest M (Decode::BKP, BN, NT = 2); the
# prefill tile's packed rows per stage and output tile (Prefill::BKP, BM, BN)
_BN = 256
_BKP = 64
_TC_BKP = {"tc_decode": 64, "tc_prefill": 32}
_TC_DECODE_BN = 256
_TC_DECODE_M = 16
_TC_PREFILL_BM = _TC_PREFILL_BN = 128
TILES = ("tc_decode", "tc_prefill", "cuda_core")


def dequant_matmul_reference(x: torch.Tensor, qt: QTensor,
                             out_dtype=None) -> torch.Tensor:
    """Plain version: weights dequantized to ``x.dtype`` (bf16 in serving),
    product accumulated in float32, cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    w = qt.dequantize(x.dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y.to(out_dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_plan(m: int, k: int, n: int, bits: int, slots: int = 1,
                sms: int = 132) -> tuple[int, int]:
    """CUDA-core tile: (splits, packed rows per split) of its split-K,
    enough blocks to cover the card's ``sms`` twice at decode M, once at
    prefill M. The expert slots of the MoE kernel count as more tiles."""
    kp = k // 2 if bits == 4 else k
    m_tiles = 1 if m <= 8 else _cdiv(m, 64)
    tiles = _cdiv(n, _BN) * m_tiles * slots
    target = 2 * sms if m <= 8 else sms
    splits = max(1, min(_cdiv(target, tiles), _cdiv(kp, _BKP)))
    per = _cdiv(_cdiv(kp, splits), _BKP) * _BKP
    return _cdiv(kp, per), per


def _tile(x: torch.Tensor, qt: QTensor, m: int) -> str:
    """The tile a call runs: the tensor-core tiles take bf16 x with packed
    K rows, G and N multiples of 16 and 16-byte aligned x and codes (decode
    at M <= 16, prefill above); the CUDA-core tile takes the rest."""
    k, n = qt.shape
    kp = k // 2 if qt.bits == 4 else k
    if (x.dtype != torch.bfloat16 or kp % 16 or qt.group_size % 16
            or n % 16 or x.data_ptr() % 16 or qt.codes.data_ptr() % 16):
        return "cuda_core"
    return "tc_decode" if m <= _TC_DECODE_M else "tc_prefill"


def _out_tiles(tile: str, m: int, n: int) -> int:
    """Output tiles of one slot: the blocks of the grid's x and y."""
    if tile == "tc_decode":
        return _cdiv(n, _TC_DECODE_BN)
    return _cdiv(n, _TC_PREFILL_BN) * _cdiv(m, _TC_PREFILL_BM)


def _tc_plan(tile: str, m: int, k: int, n: int, bits: int, slots: int = 1,
             sum_mode: bool = False, sms: int = 132) -> tuple[int, int]:
    """Tensor-core tiles: (partitions, packed rows each) of the contraction
    (a slot's K/2 or K rows padded to the tile's stage; in sum mode the
    slots' rows end to end). Decode: enough blocks to cover the card's
    ``sms`` twice, so enough bytes stream; prefill: split only where the
    output tiles would not fill the SMs. Every partition is a whole number
    of stages and none is empty."""
    kp = k // 2 if bits == 4 else k
    bkp = _TC_BKP[tile]
    kp_pad = _cdiv(kp, bkp) * bkp
    total = kp_pad * (slots if sum_mode else 1)
    tiles = _out_tiles(tile, m, n)
    target = 2 * sms if tile == "tc_decode" else sms
    if not sum_mode:
        tiles *= slots
    splits = max(1, min(_cdiv(target, tiles), total // bkp))
    per = _cdiv(_cdiv(total, splits), bkp) * bkp
    return _cdiv(total, per), per


def _count(name: str, tile: str) -> None:
    _build.count_launch(name)
    _build.count_launch(f"{name}[{tile}]")


_P, _I = ctypes.c_void_p, ctypes.c_int
# x, x_bf16, codes, scales, out, out_f32, partial, M, K, N, G, bits, splits,
# kp_per_split, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# x, x_bf16, codes, scales, out, out_f32, partial, atomic, M, K, N, G, bits,
# splits, slots, sum, layer, stride, experts, hot, stream
_MOE_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P] + [_I] * 12 + [_P, _P]
# x, codes, scales, out, out_f32, ws, counters, M, K, N, G, bits, tile,
# splits, per, stream
_TC_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P] + [_I] * 8 + [_P]
# x, codes, scales, out, out_f32, ws, counters, M, K, N, G, bits, tile,
# splits, per, cap, slots, sum, layer, stride, experts, hot, stream
_MOE_TC_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P] + [_I] * 14 + [_P, _P]


def _check_operands(x: torch.Tensor, qt: QTensor, out_dtype, lead: tuple):
    """Raise on what the kernels do not take; ``lead`` is the codes' and
    scales' leading (stack) shape."""
    k, n = qt.shape
    if qt.lut is not None:
        raise NotImplementedError("codebook (lut) QTensors are not ported")
    if qt.bits == 4 and qt.kshards != 1:
        raise NotImplementedError("kshards > 1 (tensor parallel) is not "
                                  "ported")
    if qt.bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {qt.bits}")
    kp = k // 2 if qt.bits == 4 else k
    want = torch.uint8 if qt.bits == 4 else torch.int8
    if qt.codes.dtype != want or tuple(qt.codes.shape) != lead + (kp, n):
        raise ValueError(f"codes must be {want} {list(lead + (kp, n))}, got "
                         f"{qt.codes.dtype} {tuple(qt.codes.shape)}")
    if (qt.scales.dtype != torch.float32 or tuple(qt.scales.shape)
            != lead + (k // qt.group_size, n)):
        raise ValueError("scales must be float32 [.., K/G, N]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    for t, what in ((x, "x"), (qt.codes, "codes"), (qt.scales, "scales")):
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if n % 4 or qt.codes.data_ptr() % 4 or qt.scales.data_ptr() % 16:
        raise ValueError("N must be a multiple of 4 and codes / scales "
                         "4 / 16-byte aligned")


def _launch(x: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    m, k = x.shape
    n = qt.n
    _check_operands(x, qt, out_dtype, ())
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    tile = _tile(x, qt, m)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = _sm_count(x.device)
    if tile == "cuda_core":
        splits, per = _split_plan(m, k, n, qt.bits, sms=sms)
        partial = None
        if splits > 1 and out_dtype != torch.float32:
            partial = torch.empty((m, n), dtype=torch.float32,
                                  device=x.device)
        fn = _build.entry("dequant_matmul", "dequant_matmul_launch",
                          _ARGTYPES)
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                qt.codes.data_ptr(), qt.scales.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.float32),
                None if partial is None else partial.data_ptr(),
                m, k, n, qt.group_size, qt.bits, splits, per, stream)
    else:
        splits, per = _tc_plan(tile, m, k, n, qt.bits, sms=sms)
        ws = counters = None
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=x.device)
            counters = _build.zero_counters(x.device, _out_tiles(tile, m, n))
        fn = _build.entry("dequant_matmul", "dequant_matmul_tc_launch",
                          _TC_ARGTYPES)
        rc = fn(x.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.float32),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(),
                m, k, n, qt.group_size, qt.bits, TILES.index(tile), splits,
                per, stream)
    _build.check(rc, "dequant_matmul", "dequant_matmul")
    _count("dequant_matmul", tile)
    return out


def dequant_matmul(x: torch.Tensor, qt: QTensor, layer: int | None = None,
                   *, out_dtype=None) -> torch.Tensor:
    """``x [.., K] @ QTensor [K, N] -> [.., N]`` in ``out_dtype`` (default
    ``x.dtype``). ``layer`` selects one layer of a stacked ``[L, ...]``
    QTensor as a view of the stack (no copy)."""
    out_dtype = out_dtype or x.dtype
    if qt.stacked:
        if layer is None:
            raise ValueError("stacked QTensor requires a layer index")
        qt = qt.layer(layer)
    elif layer is not None:
        raise ValueError("layer given for an unstacked QTensor")
    k, n = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != K {k}")
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        y = dequant_matmul_reference(x.reshape(-1, k), qt, out_dtype)
        return y.reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return _launch(x.view(-1, k), qt, out_dtype).view(*lead, n)


# ── mixture of experts ──────────────────────────────────────────────────


def _moe_checks(x: torch.Tensor, qt: QTensor, layer: int, n_experts: int,
                stride: int, mode: str, hot) -> int:
    """Validate a MoE call; returns the experts the stack holds."""
    if mode == "grouped":
        raise NotImplementedError(
            "mode='grouped' (the capacity dispatch's grouped GEMM) is not "
            "ported")
    if mode not in ("concat", "sum", "psum"):
        raise ValueError(f"mode must be concat|sum|psum, got {mode!r}")
    if not qt.stacked:
        raise ValueError("dequant_matmul_moe needs the merged [E*L, ...] "
                         "expert stack")
    entries = qt.codes.shape[0]
    if stride < 1 or entries % stride or not 0 <= layer < stride:
        raise ValueError(f"layer {layer} / stride {stride} do not address a "
                         f"stack of {entries}")
    experts = entries // stride
    if hot is None and not 1 <= n_experts <= experts:
        raise ValueError(f"n_experts {n_experts} outside the stack's "
                         f"{experts} experts")
    if hot is not None and (hot.dtype != torch.int32
                            or tuple(hot.shape) != (1 + n_experts,)
                            or hot.device != x.device):
        raise ValueError(f"hot must be int32 [{1 + n_experts}] on "
                         f"{x.device}")
    k = qt.shape[0]
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != K {k}")
    if mode != "concat" and (x.dim() < 2 or x.shape[0] != n_experts):
        raise ValueError(f"{mode} mode takes x [n_experts={n_experts}, .., "
                         f"K], got {tuple(x.shape)}")
    return experts


def dequant_matmul_moe_reference(x: torch.Tensor, qt: QTensor, layer: int,
                                 *, n_experts: int, stride: int,
                                 mode: str = "concat", out_dtype=None,
                                 hot: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain version of :func:`dequant_matmul_moe`: a loop over the expert
    slots through :func:`dequant_matmul_reference`. Slots at or past
    ``n_hot`` give exact zeros (concat) or nothing (sum)."""
    out_dtype = out_dtype or x.dtype
    _moe_checks(x, qt, layer, n_experts, stride, mode, hot)
    k, n = qt.shape
    if hot is None:
        n_hot, ids = n_experts, list(range(n_experts))
    else:
        h = hot.tolist()
        n_hot, ids = min(max(h[0], 0), n_experts), h[1:]

    def weight(j):
        return qt.layer(ids[j] * stride + layer)

    if mode == "concat":
        # each slot's columns written in place (a torch.cat of the slots
        # launches a varying set of copy kernels, which device timing of
        # this version cannot count)
        x2 = x.reshape(-1, k)
        y = torch.zeros((x2.shape[0], n_experts * n), dtype=out_dtype,
                        device=x.device)
        for j in range(n_hot):
            y[:, j * n:(j + 1) * n] = dequant_matmul_reference(
                x2, weight(j), out_dtype)
        return y.reshape(*x.shape[:-1], n_experts * n)
    lead = x.shape[1:-1]
    acc = torch.zeros((x[0].numel() // k, n), dtype=torch.float32,
                      device=x.device)
    for j in range(n_hot):
        acc += dequant_matmul_reference(x[j].reshape(-1, k), weight(j),
                                        torch.float32)
    return acc.to(out_dtype).reshape(*lead, n)


def dequant_matmul_moe(x: torch.Tensor, qt: QTensor, layer: int, *,
                       n_experts: int, stride: int, mode: str = "concat",
                       out_dtype=None, hot: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Every expert slot's matmul in ONE kernel launch, over the merged
    expert-major stack ``qt`` [E*L, ...] (expert e of layer ``layer`` is
    entry ``e * stride + layer``).

    * ``mode="concat"``: x [.., K] -> [.., n_experts * N], every slot's
      columns side by side.
    * ``mode="sum"`` / ``"psum"``: x [n_experts, .., K] -> [.., N], the sum
      over slots of x[j] @ W_j (fold the routing weights into x first). The
      two names are one function here: the slots meet in the kernel's f32
      accumulation buffer.
    * ``hot``: int32 [1 + n_experts] on the device, ``[n_hot, ids...]``:
      slot j uses expert ``hot[1 + j]``; slots at or past ``n_hot`` stream
      no weights and give exact zeros (concat) or add nothing (sum). The
      kernel reads the list on the device, so the call needs no host sync.
    * ``mode="grouped"`` (the capacity dispatch) raises
      ``NotImplementedError``.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return dequant_matmul_moe_reference(
            x, qt, layer, n_experts=n_experts, stride=stride, mode=mode,
            out_dtype=out_dtype, hot=hot)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    experts = _moe_checks(x, qt, layer, n_experts, stride, mode, hot)
    _check_operands(x, qt, out_dtype, (qt.codes.shape[0],))
    k, n = qt.shape
    total = 1 if mode == "concat" else n_experts
    m = x.numel() // (k * total)
    sum_mode = mode != "concat"
    width = n if sum_mode else n_experts * n
    lead = x.shape[1:-1] if sum_mode else x.shape[:-1]
    out = torch.empty((m, width), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.view(*lead, width)
    tile = _tile(x, qt, m)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = _sm_count(x.device)
    hot_ptr = None if hot is None else hot.data_ptr()
    if tile == "cuda_core":
        splits, _ = _split_plan(m, k, n, qt.bits, n_experts, sms)
        # with a hot list the kernel shares the grid out among the hot
        # slots only, so the cold slots' zeros come from the cleared buffer
        atomic = splits > 1 or (sum_mode and n_experts > 1) or hot is not None
        partial = None
        if atomic and out_dtype != torch.float32:
            partial = torch.empty((m, width), dtype=torch.float32,
                                  device=x.device)
        fn = _build.entry("dequant_matmul", "dequant_matmul_moe_launch",
                          _MOE_ARGTYPES)
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                qt.codes.data_ptr(), qt.scales.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.float32),
                None if partial is None else partial.data_ptr(), int(atomic),
                m, k, n, qt.group_size, qt.bits, splits, n_experts,
                int(sum_mode), layer, stride, experts, hot_ptr, stream)
    else:
        splits, per = _tc_plan(tile, m, k, n, qt.bits, n_experts, sum_mode,
                               sms)
        grid_z = splits if sum_mode else n_experts * splits
        # under a hot list a concat slot takes up to grid_z / n_hot
        # partitions at decode M (the grid streams the hot experts' bytes),
        # at most the planned ones at prefill M
        cap = grid_z if tile == "tc_decode" else splits
        multi = splits > 1 or (hot is not None and not sum_mode and cap > 1)
        ws = counters = None
        if multi:
            ws = torch.empty((grid_z, m, n), dtype=torch.float32,
                             device=x.device)
            counters = _build.zero_counters(x.device, _out_tiles(tile, m, n)
                                      * (1 if sum_mode else n_experts))
        fn = _build.entry("dequant_matmul", "dequant_matmul_moe_tc_launch",
                          _MOE_TC_ARGTYPES)
        rc = fn(x.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.float32),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(),
                m, k, n, qt.group_size, qt.bits, TILES.index(tile), splits,
                per, cap, n_experts, int(sum_mode), layer, stride, experts,
                hot_ptr, stream)
    _build.check(rc, "dequant_matmul_moe", "dequant_matmul")
    _count("dequant_matmul_moe", tile)
    return out.view(*lead, width)
