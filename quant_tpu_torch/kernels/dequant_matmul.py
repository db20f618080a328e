"""Fused dequantize + matmul: ``y = x @ dequantize(W)`` for a QTensor ``W``.

The port of the JAX package's ``kernels/dequant_matmul.py``
(``dequant_matmul`` and ``dequant_matmul_moe``). The codes stay packed in
device memory (int4: half a byte per weight) and are unpacked and scaled
inside the CUDA kernels of ``csrc/dequant_matmul.cu`` (the tensor-core
tiles, the aq tile) and ``csrc/dequant_matmul_cc.cu`` (the CUDA-core tile),
whose header notes give their design.

Each call runs one of three tiles, chosen here from x's dtype, M and the
shape (:func:`_tile`) and counted under its name beside the kernel's total
(``dequant_matmul[tc_decode]``, ``[tc_prefill]``, ``[cuda_core]``): the
tensor-core tiles take bf16 x (decode at M <= 16, prefill above), the
CUDA-core tile f32 x and the bf16 shapes the tensor-core tiles do not take.

Two variants of ``dequant_matmul`` (the JAX kernel's ``lut_mode`` and
``aq``), each counted beside its tile:

* a codebook QTensor (``qt.lut``, int4) runs every tile with the nibble as
  a table index: ``lut_exact=False`` the int8-requantized table
  (``[lut_word4]``: ``round(lut * 127)`` with ``fl(1/127)`` folded into the
  group scales), ``lut_exact=True`` the float32 table (``[lut_sel15]``);
* ``act_quant=True`` (W8A8 at 8 bits, W4A8 at 4) quantizes x to int8 per
  (row, K-group) in a pre-pass kernel (:func:`act_quant_int8`, counted as
  ``act_quant_int8``) and multiplies int8 by int8 on the tensor cores
  (``[aq]``, under ``tc_decode`` at M <= 16, ``tc_prefill`` above).

A codebook weight with ``act_quant`` raises on the card (the JAX package
sends that pair to its XLA reference); its plain version computes it.

``dequant_matmul_moe`` runs every expert slot in one launch of the same
tiles, counted under ``dequant_matmul_moe`` and its tile: ``concat``,
``sum`` / ``psum`` and ``grouped`` (the capacity dispatch's grouped GEMM,
also counted as ``dequant_matmul_moe[grouped]``), with or without a hot
list, and each with ``act_quant`` (the x pre-pass, then the aq tile under
the slot plan: ``dequant_matmul_moe[aq]``).

:func:`dequant_matmul` and :func:`dequant_matmul_moe` launch those kernels
for tensors on the card and take their plain versions
(:func:`dequant_matmul_reference`, :func:`dequant_matmul_moe_reference`)
only for tensors on the CPU: on a CUDA tensor they launch or raise, they
never fall back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from quant_tpu_torch.core.qtensor import QTensor, transcode_lut_int8
from quant_tpu_torch.kernels import _build

__all__ = ["dequant_matmul", "dequant_matmul_reference", "dequant_matmul_moe",
           "dequant_matmul_moe_reference", "act_quant_int8",
           "act_quant_int8_reference"]

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
# the aq tile: K rows per tensor-core step and the groups it takes
_AQ_K = 32
_LUT_MODES = {None: 0, "word4": 1, "sel15": 2}


def act_quant_int8_reference(x: torch.Tensor, group_size: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`act_quant_int8`: x [M, K] -> (int8 codes
    [M, K], float32 scales [M, K/G]) per (row, K-group): ``sx = absmax /
    127`` (1 where absmax is 0), codes ``round_half_even(x / sx)``. On the
    card torch computes ``absmax / 127.0`` as absmax times fl(1/127); the
    kernel does the same."""
    m, k = x.shape
    xg = x.to(torch.float32).reshape(m, k // group_size, group_size)
    sx = xg.abs().amax(dim=-1, keepdim=True) / 127.0
    sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    q = torch.round(xg / sx).to(torch.int8)
    return q.reshape(m, k), sx.reshape(m, k // group_size)


def dequant_matmul_reference(x: torch.Tensor, qt: QTensor, out_dtype=None,
                             act_quant: bool = False,
                             lut_word4: bool = False) -> torch.Tensor:
    """Plain version: weights dequantized to ``x.dtype`` (bf16 in serving),
    product accumulated in float32, cast to ``out_dtype``. ``lut_word4``: a
    codebook weight through the word4 kernel's table, ``round(lut * 127)``
    with the scales times fl(1/127), which is its int8 transcode
    (:func:`transcode_lut_int8`); else its float32 table. ``act_quant``: the
    W8A8 form of the JAX package's reference: x rounded to its per-(row,
    group) int8 grid (:func:`act_quant_int8_reference`), weights exact in
    float32 (a codebook weight through its float32 table)."""
    out_dtype = out_dtype or x.dtype
    k = qt.shape[0]
    if act_quant:
        q, sx = act_quant_int8_reference(x.reshape(-1, k), qt.group_size)
        g = qt.group_size
        xhat = (q.to(torch.float32).reshape(-1, k // g, g)
                * sx[..., None]).reshape(x.shape)
        y = torch.matmul(xhat, qt.dequantize(torch.float32))
        return y.to(out_dtype)
    if lut_word4:
        qt = transcode_lut_int8(qt)
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


def _aq_whole_groups(kp: int, g: int, sum_mode: bool) -> bool:
    """Whether partitions of whole lcm(64, G) runs of packed rows hold whole
    K groups of both halves: the K rows end on a group, and in sum mode each
    slot's stage-padded rows end on a run too."""
    bkp = _TC_BKP["tc_decode"]
    unit = bkp * g // math.gcd(bkp, g)
    return kp % g == 0 and (not sum_mode or _cdiv(kp, bkp) * bkp % unit == 0)


def _aq_plan(m: int, k: int, n: int, bits: int, g: int, slots: int = 1,
             sum_mode: bool = False, sms: int = 132
             ) -> tuple[int, int, int]:
    """The aq tile: (token rows a block, partitions, packed rows each).
    Blocks of 8 token rows at M <= 8, else 16; split-K only at decode M,
    enough blocks to cover the card's ``sms`` twice, every partition a whole
    number of stages and of both halves' K groups (so each group's int32
    dot is whole before its scales apply, as in the JAX kernel). The expert
    slots count as more tiles, or, in sum mode, as one contraction of the
    slots' rows end to end (each slot's rows padded to a whole stage)."""
    kp = k // 2 if bits == 4 else k
    rows = 8 if m <= 8 else 16
    bkp = _TC_BKP["tc_decode"]
    unit = bkp * g // math.gcd(bkp, g)
    kp_pad = _cdiv(kp, bkp) * bkp
    total = kp_pad * (slots if sum_mode else 1)
    tiles = _cdiv(n, _TC_DECODE_BN) * _cdiv(m, rows)
    if not sum_mode:
        tiles *= slots
    splits = 1
    if m <= _TC_DECODE_M and _aq_whole_groups(kp, g, sum_mode):
        splits = max(1, min(_cdiv(2 * sms, tiles), total // unit))
    per = _cdiv(_cdiv(total, splits), unit) * unit
    return rows, _cdiv(total, per), per


def _count(name: str, tile: str, *variants: str) -> None:
    _build.count_launch(name)
    _build.count_launch(f"{name}[{tile}]")
    for v in variants:
        _build.count_launch(f"{name}[{v}]")


_P, _I = ctypes.c_void_p, ctypes.c_int
# x, x_bf16, codes, scales, out, out_f32, partial, M, K, N, G, bits, splits,
# kp_per_split, lut, lut_mode, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
             _P]
# x, x_bf16, codes, scales, out, out_f32, partial, atomic, M, K, N, G, bits,
# splits, slots, sum, layer, stride, experts, hot, stream
_MOE_ARGTYPES = [_P, _I, _P, _P, _P, _I, _P] + [_I] * 12 + [_P, _P]
# x, codes, scales, out, out_f32, ws, counters, M, K, N, G, bits, tile,
# splits, per, lut, lut_mode, stream
_TC_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P] + [_I] * 8 + [_P, _I, _P]
# xq, sx, codes, scales, out, out_f32, ws, counters, M, K, N, G, bits, rows,
# splits, per, stream
_AQ_ARGTYPES = [_P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 8 + [_P]
# x, x_bf16, xq, sx, M, K, G, stream
_ACT_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _P]
# x, codes, scales, out, out_f32, ws, counters, M, K, N, G, bits, tile,
# splits, per, cap, slots, mode, layer, stride, experts, hot, stream
_MOE_TC_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P] + [_I] * 14 + [_P, _P]
# xq, sx, codes, scales, out, out_f32, ws, counters, M, K, N, G, bits, rows,
# splits, per, cap, slots, mode, layer, stride, experts, hot, stream
_AQ_MOE_ARGTYPES = [_P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 14 + [_P, _P]
# the MoE launches' mode argument
_MOE_MODES = {"concat": 0, "sum": 1, "psum": 1, "grouped": 2}


def _check_operands(x: torch.Tensor, qt: QTensor, out_dtype, lead: tuple):
    """Raise on what the kernels do not take; ``lead`` is the codes' and
    scales' leading (stack) shape."""
    k, n = qt.shape
    if qt.lut is not None and (qt.bits != 4 or qt.lut.dtype != torch.float32
                               or tuple(qt.lut.shape) != (16,)
                               or qt.lut.device != x.device
                               or not qt.lut.is_contiguous()):
        raise ValueError("lut must be a contiguous float32 [16] table of an "
                         "int4 QTensor on x's device")
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


def act_quant_int8(x: torch.Tensor, group_size: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (float32 or bfloat16) -> (int8 codes [M, K], float32 scales
    [M, K/G]) per (row, K-group), the activation side of the JAX kernel's
    ``_scaled_dots_aq``, as one pre-pass launch. Plain version on the CPU:
    :func:`act_quant_int8_reference`."""
    m, k = x.shape
    if x.device.type == "cpu":
        return act_quant_int8_reference(x, group_size)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if (not x.is_contiguous() or k % group_size or group_size % 16
            or x.data_ptr() % 16):
        raise ValueError("act_quant_int8 takes a contiguous, 16-byte aligned "
                         "x [M, K] and groups of a multiple of 16 dividing K")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, k // group_size), dtype=torch.float32,
                     device=x.device)
    if m == 0:
        return xq, sx
    fn = _build.entry("dequant_matmul", "act_quant_launch", _ACT_ARGTYPES)
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(),
            sx.data_ptr(), m, k, group_size,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "act_quant_int8", "dequant_matmul")
    _build.count_launch("act_quant_int8")
    return xq, sx


def _launch_aq(x: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """W8A8 / W4A8: the x pre-pass, then the int8 x int8 tensor-core tile."""
    m, k = x.shape
    n = qt.n
    _check_operands(x, qt, out_dtype, ())
    if qt.lut is not None:
        raise NotImplementedError(
            "a codebook (lut) weight with act_quant at lut_runtime word4 or "
            "sel15 is not ported (the JAX package runs that pair on its XLA "
            "reference; lut_runtime='int8' transcodes it to int8)")
    _check_aq(qt)
    g = qt.group_size
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    xq, sx = act_quant_int8(x, g)
    rows, splits, per = _aq_plan(m, k, n, qt.bits, g,
                                 sms=_sm_count(x.device))
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=x.device)
        counters = _build.zero_counters(x.device, _cdiv(n, _TC_DECODE_BN)
                                        * _cdiv(m, rows))
    fn = _build.entry("dequant_matmul", "dequant_matmul_aq_launch",
                      _AQ_ARGTYPES)
    rc = fn(xq.data_ptr(), sx.data_ptr(), qt.codes.data_ptr(),
            qt.scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, k, n, g, qt.bits, rows, splits, per,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "dequant_matmul", "dequant_matmul")
    _count("dequant_matmul", "tc_decode" if m <= _TC_DECODE_M
           else "tc_prefill", "aq")
    return out


def _check_aq(qt: QTensor) -> None:
    """What the aq tile takes: K rows (packed) and groups in multiples of
    32, N a multiple of 16, 16-byte aligned codes."""
    k, n = qt.shape
    kp = k // 2 if qt.bits == 4 else k
    g = qt.group_size
    if kp % _AQ_K or g % _AQ_K or n % 16 or qt.codes.data_ptr() % 16:
        raise NotImplementedError(
            f"act_quant needs K rows and groups in multiples of {_AQ_K} and N "
            f"a multiple of 16 (K={k}, G={g}, N={n})")


def _launch(x: torch.Tensor, qt: QTensor, out_dtype,
            lut_exact: bool = False) -> torch.Tensor:
    m, k = x.shape
    n = qt.n
    _check_operands(x, qt, out_dtype, ())
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    tile = _tile(x, qt, m)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = _sm_count(x.device)
    mode = None if qt.lut is None else ("sel15" if lut_exact else "word4")
    lut = None if qt.lut is None else qt.lut.data_ptr()
    if tile == "cuda_core":
        splits, per = _split_plan(m, k, n, qt.bits, sms=sms)
        partial = None
        if splits > 1 and out_dtype != torch.float32:
            partial = torch.empty((m, n), dtype=torch.float32,
                                  device=x.device)
        fn = _build.entry("dequant_matmul_cc", "dequant_matmul_launch",
                          _ARGTYPES)
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                qt.codes.data_ptr(), qt.scales.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.float32),
                None if partial is None else partial.data_ptr(),
                m, k, n, qt.group_size, qt.bits, splits, per, lut,
                _LUT_MODES[mode], stream)
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
                per, lut, _LUT_MODES[mode], stream)
    _build.check(rc, "dequant_matmul", "dequant_matmul_cc"
                 if tile == "cuda_core" else "dequant_matmul")
    _count("dequant_matmul", tile,
           *(() if mode is None else (f"lut_{mode}",)))
    return out


def dequant_matmul(x: torch.Tensor, qt: QTensor, layer: int | None = None,
                   *, out_dtype=None, act_quant: bool = False,
                   lut_exact: bool = False) -> torch.Tensor:
    """``x [.., K] @ QTensor [K, N] -> [.., N]`` in ``out_dtype`` (default
    ``x.dtype``). ``layer`` selects one layer of a stacked ``[L, ...]``
    QTensor as a view of the stack (no copy), its table too where the
    stack has one per layer. A codebook weight runs its float32 table with
    ``lut_exact`` (sel15), else the int8-requantized one (word4);
    ``act_quant`` quantizes x to int8 per (row, K-group) and multiplies
    int8 by int8 (W8A8 / W4A8)."""
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
        y = dequant_matmul_reference(
            x.reshape(-1, k), qt, out_dtype, act_quant=act_quant,
            lut_word4=qt.lut is not None and not lut_exact)
        return y.reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if act_quant:
        return _launch_aq(x.view(-1, k), qt, out_dtype).view(*lead, n)
    return _launch(x.view(-1, k), qt, out_dtype, lut_exact).view(*lead, n)


# ── mixture of experts ──────────────────────────────────────────────────


def _moe_checks(x: torch.Tensor, qt: QTensor, layer: int, n_experts: int,
                stride: int, mode: str, hot) -> int:
    """Validate a MoE call; returns the experts the stack holds."""
    if mode not in _MOE_MODES:
        raise ValueError(f"mode must be concat|sum|psum|grouped, got {mode!r}")
    if qt.lut is not None:
        raise NotImplementedError(
            "codebook (lut) expert stacks are not ported: the JAX reference "
            "fails on them (its _merge_experts leaves the [E, L, 16] table "
            "unmerged; see ROADMAP.md queue 3)")
    if qt.bits == 4 and qt.kshards != 1:
        raise NotImplementedError("kshards > 1 (tensor parallel) expert "
                                  "stacks are not ported")
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
                                 hot: torch.Tensor | None = None,
                                 act_quant: bool = False) -> torch.Tensor:
    """Plain version of :func:`dequant_matmul_moe`: a loop over the expert
    slots through :func:`dequant_matmul_reference` (``act_quant`` its W8A8
    form, each slot's x rows on their own int8 grid). Slots at or past
    ``n_hot`` give exact zeros (concat, grouped) or nothing (sum), and their
    x rows are not read."""
    out_dtype = out_dtype or x.dtype
    _moe_checks(x, qt, layer, n_experts, stride, mode, hot)
    k, n = qt.shape
    if hot is None:
        n_hot, ids = n_experts, list(range(n_experts))
    else:
        h = hot.tolist()
        n_hot, ids = min(max(h[0], 0), n_experts), h[1:]

    def slot(j, x_j, dt):
        return dequant_matmul_reference(x_j.reshape(-1, k),
                                        qt.layer(ids[j] * stride + layer),
                                        dt, act_quant=act_quant)

    if mode == "concat":
        # each slot's columns written in place (a torch.cat of the slots
        # launches a varying set of copy kernels, which device timing of
        # this version cannot count)
        x2 = x.reshape(-1, k)
        y = torch.zeros((x2.shape[0], n_experts * n), dtype=out_dtype,
                        device=x.device)
        for j in range(n_hot):
            y[:, j * n:(j + 1) * n] = slot(j, x2, out_dtype)
        return y.reshape(*x.shape[:-1], n_experts * n)
    lead = x.shape[1:-1]
    if mode == "grouped":
        y = torch.zeros((n_experts, x[0].numel() // k, n), dtype=out_dtype,
                        device=x.device)
        for j in range(n_hot):
            y[j] = slot(j, x[j], out_dtype)
        return y.reshape(n_experts, *lead, n)
    acc = torch.zeros((x[0].numel() // k, n), dtype=torch.float32,
                      device=x.device)
    for j in range(n_hot):
        acc += slot(j, x[j], torch.float32)
    return acc.to(out_dtype).reshape(*lead, n)


def _moe_out(x: torch.Tensor, n: int, n_experts: int, mode: str,
             out_dtype) -> tuple[torch.Tensor, tuple]:
    """The output buffer of a MoE call, [M, width] or [n_experts * M, N]
    (grouped), and the shape the caller gets."""
    if mode == "concat":
        lead, m = x.shape[:-1], x.numel() // x.shape[-1]
        return (torch.empty((m, n_experts * n), dtype=out_dtype,
                            device=x.device), (*lead, n_experts * n))
    lead = x.shape[1:-1]
    m = x[0].numel() // x.shape[-1]
    rows = n_experts * m if mode == "grouped" else m
    shape = (n_experts, *lead, n) if mode == "grouped" else (*lead, n)
    return torch.empty((rows, n), dtype=out_dtype, device=x.device), shape


def _launch_moe_aq(x: torch.Tensor, qt: QTensor, layer: int, n_experts: int,
                   stride: int, experts: int, mode: str, out_dtype,
                   hot) -> torch.Tensor:
    """W8A8 / W4A8 expert slots: the x pre-pass over x's rows (a cold
    slot's rows are quantized and never read), then the aq tile under the
    slot plan."""
    _check_aq(qt)
    k, n = qt.shape
    g = qt.group_size
    out, shape = _moe_out(x, n, n_experts, mode, out_dtype)
    per_slot = mode != "concat"
    m = x.numel() // (k * (n_experts if per_slot else 1))
    if m == 0:
        return out.view(shape)
    sum_mode = _MOE_MODES[mode] == 1
    xq, sx = act_quant_int8(x.reshape(-1, k), g)
    kp = k // 2 if qt.bits == 4 else k
    rows, splits, per = _aq_plan(m, k, n, qt.bits, g, n_experts, sum_mode,
                                 _sm_count(x.device))
    grid_z = splits if sum_mode else n_experts * splits
    # under a hot list a slot takes up to grid_z / n_hot partitions at
    # decode M where its partitions can hold whole groups
    cap = (grid_z if m <= _TC_DECODE_M
           and _aq_whole_groups(kp, g, sum_mode) else splits)
    multi = splits > 1 or (hot is not None and not sum_mode and cap > 1)
    ws = counters = None
    if multi:
        ws = torch.empty((grid_z, m, n), dtype=torch.float32,
                         device=x.device)
        counters = _build.zero_counters(
            x.device, _cdiv(n, _TC_DECODE_BN) * _cdiv(m, rows)
            * (1 if sum_mode else n_experts))
    fn = _build.entry("dequant_matmul", "dequant_matmul_aq_moe_launch",
                      _AQ_MOE_ARGTYPES)
    rc = fn(xq.data_ptr(), sx.data_ptr(), qt.codes.data_ptr(),
            qt.scales.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, k, n, g, qt.bits, rows, splits, per, cap, n_experts,
            _MOE_MODES[mode], layer, stride, experts,
            None if hot is None else hot.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "dequant_matmul_moe", "dequant_matmul")
    _count("dequant_matmul_moe", "tc_decode" if m <= _TC_DECODE_M
           else "tc_prefill", "aq", *(("grouped",) if mode == "grouped"
                                      else ()))
    return out.view(shape)


def dequant_matmul_moe(x: torch.Tensor, qt: QTensor, layer: int, *,
                       n_experts: int, stride: int, mode: str = "concat",
                       out_dtype=None, hot: torch.Tensor | None = None,
                       act_quant: bool = False) -> torch.Tensor:
    """Every expert slot's matmul in ONE kernel launch, over the merged
    expert-major stack ``qt`` [E*L, ...] (expert e of layer ``layer`` is
    entry ``e * stride + layer``).

    * ``mode="concat"``: x [.., K] -> [.., n_experts * N], every slot's
      columns side by side.
    * ``mode="sum"`` / ``"psum"``: x [n_experts, .., K] -> [.., N], the sum
      over slots of x[j] @ W_j (fold the routing weights into x first). The
      two names are one function here: the slots meet in the kernel's f32
      accumulation buffer.
    * ``mode="grouped"``: x [n_experts, .., K] -> [n_experts, .., N], slot
      j's own x[j] @ W_j (the capacity dispatch's grouped GEMM).
    * ``hot``: int32 [1 + n_experts] on the device, ``[n_hot, ids...]``:
      slot j uses expert ``hot[1 + j]``; slots at or past ``n_hot`` stream
      no weights, read no x rows and give exact zeros (concat, grouped) or
      add nothing (sum). The kernel reads the list on the device, so the
      call needs no host sync.
    * ``act_quant``: x quantized to int8 per (row, K-group) in a pre-pass
      (``[M, K]`` for concat, ``[n_experts * M, K]`` for the per-slot
      modes), then int8 x int8 products (W8A8 / W4A8), in every mode.

    Each launch counts under ``dequant_matmul_moe`` and its tile, and under
    ``dequant_matmul_moe[grouped]`` / ``[aq]`` for those. A codebook (lut)
    expert stack and ``kshards > 1`` raise ``NotImplementedError``.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return dequant_matmul_moe_reference(
            x, qt, layer, n_experts=n_experts, stride=stride, mode=mode,
            out_dtype=out_dtype, hot=hot, act_quant=act_quant)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    experts = _moe_checks(x, qt, layer, n_experts, stride, mode, hot)
    _check_operands(x, qt, out_dtype, (qt.codes.shape[0],))
    if act_quant:
        return _launch_moe_aq(x, qt, layer, n_experts, stride, experts, mode,
                              out_dtype, hot)
    k, n = qt.shape
    per_slot = mode != "concat"
    m = x.numel() // (k * (n_experts if per_slot else 1))
    sum_mode = _MOE_MODES[mode] == 1
    out, shape = _moe_out(x, n, n_experts, mode, out_dtype)
    if m == 0:
        return out.view(shape)
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
            partial = torch.empty(out.shape, dtype=torch.float32,
                                  device=x.device)
        fn = _build.entry("dequant_matmul_cc", "dequant_matmul_moe_launch",
                          _MOE_ARGTYPES)
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                qt.codes.data_ptr(), qt.scales.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.float32),
                None if partial is None else partial.data_ptr(), int(atomic),
                m, k, n, qt.group_size, qt.bits, splits, n_experts,
                _MOE_MODES[mode], layer, stride, experts, hot_ptr, stream)
    else:
        splits, per = _tc_plan(tile, m, k, n, qt.bits, n_experts, sum_mode,
                               sms)
        grid_z = splits if sum_mode else n_experts * splits
        # under a hot list a concat or grouped slot takes up to
        # grid_z / n_hot partitions at decode M (the grid streams the hot
        # experts' bytes), at most the planned ones at prefill M
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
                per, cap, n_experts, _MOE_MODES[mode], layer, stride,
                experts, hot_ptr, stream)
    _build.check(rc, "dequant_matmul_moe", "dequant_matmul_cc"
                 if tile == "cuda_core" else "dequant_matmul")
    _count("dequant_matmul_moe", tile,
           *(("grouped",) if mode == "grouped" else ()))
    return out.view(shape)
