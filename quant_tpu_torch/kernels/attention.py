"""INT8- and INT4-KV flash-decode attention (decode step, T=1).

The port of the JAX package's ``kernels/attention.py``
(``flash_decode_int8``): GQA attention over the int8 cache, or the int4
cache packed across head pairs (``kv_bits=4``: uint8 codes of ``Hkv/2``
packed heads, packed head j holding real heads 2j and 2j+1 in its low and
high nibbles, biased by 8), with per-(token, real head) scales, the key
scale applied to the logits and the value scale to the probabilities,
masked by per-slot ``lengths`` and, per call, a sliding ``window`` (the
last ``window`` keys of each slot; Mistral, the local layers of Gemma-2/3)
with an optional tanh logit ``softcap`` (Gemma-2) before the mask, as the
JAX kernel computes them. The CUDA kernel
is ``csrc/flash_decode.cu``, whose header note gives its design;
:func:`flash_decode_int8` launches it for tensors on the card and takes the
plain version :func:`flash_decode_int8_reference` only for tensors on the
CPU: on a CUDA tensor it launches or raises, it never falls back.

Each call runs one of two paths, chosen from q's dtype and Dh
(:func:`decode_path`) and counted under its name beside the kernel's total
(``flash_decode_int8[tc]``, ``[cuda_core]``; a call with a window or a
softcap also under ``[window]`` / ``[softcap]``, one over the int4 cache
under ``[kv4]``): the tensor cores for bf16 q (the serving path), CUDA-core
dots for f32 q. :func:`decode_plan` sizes the call's grid and workspace
from static ints alone (B, Hkv, S, rep, Dh, the cache's width and the SM
count; a window caps S at its width), so the wrapper
reads neither ``lengths`` nor a page table on the host. Over the int4
cache a block serves one packed head: both of its real heads and their
``2 * rep`` query heads.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels.dequant_matmul import _count, _sm_count
from quant_tpu_torch.kernels.rope_kv import dequant_kv4

__all__ = ["flash_decode_int8", "flash_decode_int8_reference", "decode_plan",
           "decode_path", "DecodePlan", "kv_layout"]

_MAX_REP = 8       # csrc/flash_decode.cu MAX_REP
_MAX_D = 256       # the largest Dh (DMAX)
_TILE = 64         # TT: tokens per ring stage
_MAX_CHUNK = 4096  # the largest chunk (MAX_IDS: its page ids)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """A decode-attention call's split, from static ints only.

    Block ``(bh, c)`` of the ``blocks = B * Hkv * n_chunks`` blocks (``Hkv``
    the code heads: the packed heads of an int4 cache) owns tokens
    ``[w0 + c * chunk, min(length, w0 + (c + 1) * chunk))`` of slot
    ``bh // Hkv`` and code head ``bh % Hkv`` (``w0`` the window's first key,
    0 without a window), walked in ``_TILE``-token tiles; a block whose
    chunk starts at or past the length exits, except
    chunk 0 of an empty slot, which writes its zeros. The
    workspace holds, per (slot, code head, chunk, query row), the chunk's
    unnormalised output (``part_o`` floats in all) and its (max, sum)
    (``part_ml``); ``counters`` int32 zeros, one per (slot, code head),
    elect the block that merges them."""
    chunk: int
    n_chunks: int
    blocks: int
    part_o: int
    part_ml: int
    counters: int


def decode_plan(b: int, hkv: int, s: int, rep: int, dh: int,
                sms: int = 132, window: int = 0,
                kv4: bool = False) -> DecodePlan:
    """The split of a call over ``b`` slots of ``s`` tokens (contiguous S,
    or ``max_pages * page``), ``hkv`` kv heads of ``rep`` query rows each
    and ``dh`` lanes, on a card of ``sms`` SMs; a ``window`` above 0 reads
    at most that many keys a slot, so it takes the place of ``s`` when it
    is the smaller. Chunks are the shortest that keep a full batch within
    about 8 blocks per SM: short enough that a skewed batch spreads over
    all SMs, long enough that a full one does not spend its time writing
    and merging partials (a multiple of the tile, at most ``_MAX_CHUNK``).
    Over the int4 cache (``kv4``) a block serves a packed head, both real
    heads of a pair and their ``2 * rep`` rows, so the budget counts query
    rows, 32 an SM (the int8 plan's at rep 4): the shortest chunks timed
    slower there (``tools/attn_probe.py plan --kv-bits 4``)."""
    if window > 0:
        s = min(s, window)
    hc, rows = (hkv // 2, 2 * rep) if kv4 else (hkv, rep)
    units, budget = (b * hc * rows, 32 * sms) if kv4 else (b * hkv, 8 * sms)
    chunk = _TILE
    while chunk < _MAX_CHUNK and units * -(-s // chunk) > budget:
        chunk *= 2
    n = max(1, -(-s // chunk))
    if b * hc * n >= 2 ** 31:
        raise ValueError(f"{b * hc * n} blocks exceed CUDA's grid")
    parts = b * hc * n * rows if n > 1 else 0
    return DecodePlan(chunk=chunk, n_chunks=n, blocks=b * hc * n,
                      part_o=parts * dh, part_ml=parts * 2, counters=b * hc)


def decode_path(q: torch.Tensor, dh: int) -> str:
    """The path a call takes: the tensor cores for bf16 q with Dh a
    multiple of 32 and 16-byte aligned rows, CUDA-core dots otherwise."""
    if q.dtype == torch.bfloat16 and dh % 32 == 0 and q.data_ptr() % 16 == 0:
        return "tc"
    return "cuda_core"


def _workspace(plan: DecodePlan, device):
    """(part_o, part_ml, counters) pointers of a call under ``plan``."""
    if plan.n_chunks == 1:
        return None, None, None
    part_o = torch.empty(plan.part_o, dtype=torch.float32, device=device)
    part_ml = torch.empty(plan.part_ml, dtype=torch.float32, device=device)
    counters = _build.zero_counters(device, plan.counters)
    return part_o, part_ml, counters


def _check_q(q, hkv: int, dh: int) -> int:
    """``rep`` of q ``[B, Hq, Dh]``; raises on what the kernel does not
    take."""
    hq = q.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    rep = hq // hkv
    if rep > _MAX_REP or dh > _MAX_D or dh % 16:
        raise ValueError(f"kernel takes rep <= {_MAX_REP} and Dh a multiple "
                         f"of 16 up to {_MAX_D}, got rep {rep}, Dh {dh}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    return rep


def _count_call(name: str, path: str, window: int, softcap: float,
                kv4: bool = False) -> None:
    """One launch of ``name`` on ``path``, and its window, softcap and
    int4 cache."""
    _count(name, path)
    for opt, on in (("window", window), ("softcap", softcap), ("kv4", kv4)):
        if on:
            _build.count_launch(f"{name}[{opt}]")


def kv_layout(k_codes, k_scale) -> tuple[bool, int]:
    """(int4 head-pair cache?, code heads) of a code tensor ``[.., Hc, S,
    Dh]`` beside its scales ``[.., Hkv, S]``: uint8 codes with ``Hc = Hkv
    / 2`` are the int4 cache, int8 codes with ``Hc = Hkv`` the int8 one;
    anything else raises."""
    hc, hkv = k_codes.shape[-3], k_scale.shape[-2]
    if k_codes.dtype == torch.uint8 and 2 * hc == hkv:
        return True, hc
    if k_codes.dtype == torch.int8 and hc == hkv:
        return False, hc
    raise ValueError(f"expected int8 codes of Hkv heads or uint8 codes of "
                     f"Hkv/2 packed heads beside scales of Hkv = {hkv}, got "
                     f"{k_codes.dtype} codes of {hc} heads")


def _layer_view(a, layer):
    if layer is None:
        return a
    return a[layer]


def _window(window) -> int:
    """A call's window as a Python int (None or <= 0: full causal)."""
    return max(0, int(window)) if window is not None else 0


def flash_decode_int8_reference(q, k_codes, k_scale, v_codes, v_scale,
                                lengths, layer=None, window=None, *,
                                softcap: float = 0.0, scale=None):
    """Plain version, in float32: q ``[B, Hq, Dh]`` against caches
    ``[B, Hkv, S, Dh]`` (or stacked ``[L, ...]`` with ``layer``; uint8
    head-pair codes of ``Hkv/2`` heads are unpacked first). The
    logits (after the key scale) go through ``softcap * tanh(x / softcap)``
    when ``softcap`` is set; then keys at positions ``>= lengths[b]``, and
    with a ``window`` above 0 those before ``lengths[b] - window``, are
    masked; the output is ``sum(p * v_scale * v) / max(sum(p), 1e-20)``,
    so a slot of length 0 gives zeros like the kernel."""
    kc, ks = _layer_view(k_codes, layer), _layer_view(k_scale, layer)
    vc, vs = _layer_view(v_codes, layer), _layer_view(v_scale, layer)
    b, hq, dh = q.shape
    hkv, s = ks.shape[1], ks.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / dh ** 0.5
    if kv_layout(kc, ks)[0]:
        kc, vc = dequant_kv4(kc), dequant_kv4(vc)
    qg = q.to(torch.float32).reshape(b, hkv, rep, dh) * scale
    logits = torch.einsum("bhrd,bhsd->bhrs", qg, kc.to(torch.float32))
    logits = logits * ks[:, :, None, :]
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.to(q.device)[:, None]
    valid = pos < lens
    w = _window(window)
    if w:
        valid = valid & (pos >= lens - w)
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhrs,bhsd->bhrd", p * vs[:, :, None, :],
                       vc.to(torch.float32)) / denom
    return out.reshape(b, hq, dh).to(q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, q_bf16, tc, k_codes, k_scale, v_codes, v_scale, lengths, out, part_o,
# part_ml, counters, layer, B, Hkv (code heads), S, Dh, rep, kv4, scale,
# window, softcap, chunk, n_chunks, stream
_ARGTYPES = ([_P, _I, _I] + [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I,
                                                   ctypes.c_float]
             + [_I] * 2 + [_P])


def flash_decode_int8(q, k_codes, k_scale, v_codes, v_scale, lengths,
                      layer=None, window=None, *, softcap: float = 0.0,
                      scale: float | None = None):
    """Attention output ``[B, Hq, Dh]`` in ``q.dtype``.

    ``k_codes``/``v_codes`` int8 ``[B, Hkv, S, Dh]``, or stacked
    ``[L, B, Hkv, S, Dh]`` with ``layer``, or the int4 cache's uint8
    head-pair codes ``[.., Hkv/2, S, Dh]``; scales f32 ``[.., Hkv, S]``;
    ``lengths`` int32 ``[B]``; ``window`` a Python int (None or 0: full
    causal), ``softcap`` a float (0: off), both read on the host only;
    ``scale`` defaults to ``1/sqrt(Dh)``."""
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    kv4, hc = kv_layout(k_codes, k_scale)
    if q.device.type == "cpu":
        return flash_decode_int8_reference(q, k_codes, k_scale, v_codes,
                                           v_scale, lengths, layer, window,
                                           softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    stacked = k_codes.dim() == 5
    if stacked and layer is None:
        raise ValueError("stacked caches require a layer index")
    if not stacked:
        k_codes, v_codes = k_codes[None], v_codes[None]
        k_scale, v_scale = k_scale[None], v_scale[None]
        layer = 0
    l, b, _, s, dh = k_codes.shape
    hkv = k_scale.shape[2]
    rep = _check_q(q, hkv, dh)
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} outside [0, {l})")
    checks = ((q, q.dtype, (b, hkv * rep, dh)),
              (v_codes, k_codes.dtype, (l, b, hc, s, dh)),
              (k_scale, torch.float32, (l, b, hkv, s)),
              (v_scale, torch.float32, (l, b, hkv, s)),
              (lengths, torch.int32, (b,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (q, k_codes, k_scale, v_codes, v_scale, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if k_codes.data_ptr() % 16 or v_codes.data_ptr() % 16:
        raise ValueError("the code caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    w = _window(window)
    plan = decode_plan(b, hkv, s, rep, dh, _sm_count(q.device), w, kv4)
    path = decode_path(q, dh)
    part_o, part_ml, counters = _workspace(plan, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("flash_decode", "flash_decode_int8_launch", _ARGTYPES)
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), int(path == "tc"),
            k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if counters is None else counters.data_ptr(), layer, b,
            hc, s, dh, rep, int(kv4),
            float(scale if scale is not None else 1.0 / dh ** 0.5), w,
            float(softcap), plan.chunk, plan.n_chunks, stream)
    _build.check(rc, "flash_decode_int8", "flash_decode")
    _count_call("flash_decode_int8", path, w, softcap, kv4)
    return out
